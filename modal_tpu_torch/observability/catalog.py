"""The metric families the port emits: serving (the engine and its ASGI
app), device telemetry (step times, device memory), compile telemetry
(kernel builds, CUDA-graph captures, the fleet compile cache), the SDK
core (client RPCs, payload bytes), the App layer's dispatch, the control
plane, its journal and local fast path, and the metrics plane (the
time-series store, SLO alerts, the sampling profiler).

Names and help texts are those of the JAX package's catalog, so a scrape of
either implementation reads the same way. Importing this module registers
every family on the process-wide REGISTRY.
"""

from __future__ import annotations

from .metrics import REGISTRY

SERVING_TTFT = REGISTRY.histogram(
    "modal_tpu_serving_ttft_seconds",
    "Time to first generated token per request (submit → first token in the "
    "buffer); observations carry the request's trace id as an exemplar.",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 15, 60),
)
SERVING_TTFT_P95 = REGISTRY.gauge(
    "modal_tpu_serving_ttft_p95_seconds",
    "p95 TTFT over the engine's recent-request window.",
)
SERVING_TOKENS_PER_S = REGISTRY.gauge(
    "modal_tpu_serving_tokens_per_second",
    "Generated tokens/s over the engine's trailing 10s window.",
)
SERVING_TOKENS = REGISTRY.counter(
    "modal_tpu_serving_tokens_total",
    "Generated tokens, cumulative.",
)
SERVING_BATCH_OCCUPANCY = REGISTRY.histogram(
    "modal_tpu_serving_batch_occupancy",
    "Active decode slots per continuous-batching step (how full the running "
    "batch actually is).",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
SERVING_QUEUE_DEPTH = REGISTRY.gauge(
    "modal_tpu_serving_queue_depth",
    "Requests admitted to the engine but not yet holding a decode slot.",
)
SERVING_REQUESTS = REGISTRY.counter(
    "modal_tpu_serving_requests_total",
    "Serving requests finished, by outcome (ok | error | stopped).",
    ("outcome",),
)
SERVING_PREEMPTIONS = REGISTRY.counter(
    "modal_tpu_serving_preemptions_total",
    "Requests preempted out of their decode slot by KV-pool pressure "
    "(requeued with their generated prefix; no tokens lost).",
)
SERVING_STREAM_EVENTS = REGISTRY.counter(
    "modal_tpu_serving_stream_events_total",
    "SSE delivery lifecycle (open | token | done | reset | buffered_fallback).",
    ("event",),
)
KV_PAGES_ALLOCATED = REGISTRY.gauge(
    "modal_tpu_kv_pages_allocated",
    "KV-cache pages currently allocated out of the shared pool.",
)
KV_PAGES_FREE = REGISTRY.gauge(
    "modal_tpu_kv_pages_free",
    "KV-cache pages free in the shared pool.",
)
SERVING_PREFIX_HITS = REGISTRY.counter(
    "modal_tpu_serving_prefix_cache_hits_total",
    "Admissions that reused cached prefix KV pages (the follower prefills "
    "only its suffix).",
)
SERVING_PREFIX_MISSES = REGISTRY.counter(
    "modal_tpu_serving_prefix_cache_misses_total",
    "Admissions with no cached prefix.",
)
KV_PAGES_COW = REGISTRY.counter(
    "modal_tpu_kv_pages_cow_copies_total",
    "Copy-on-write page copies: a write aimed at a refcount-shared KV page "
    "copied it first — shared prefix bytes are never mutated.",
)
SERVING_SAMPLED_TOKENS = REGISTRY.counter(
    "modal_tpu_serving_sampled_tokens_total",
    "Tokens emitted via temperature/top-k/top-p sampling (temperature > 0).",
)
SERVING_SPEC_ACCEPT_RATIO = REGISTRY.gauge(
    "modal_tpu_serving_spec_accept_ratio",
    "Draft-token acceptance ratio over the engine's trailing speculative "
    "window (accepted / proposed; higher = more target steps skipped).",
)
SERVING_ROLE = REGISTRY.gauge(
    "modal_tpu_serving_role",
    "This replica's serving role as a numeric code (0 = both, 1 = prefill, "
    "2 = decode — engine.ROLE_GAUGE_VALUES); rides the heartbeat so "
    "`modal_tpu top` and the autoscaler can tell fleet tiers apart.",
)
SERVING_ROUTER_ROUTED = REGISTRY.counter(
    "modal_tpu_serving_router_routed_total",
    "Requests the fleet router dispatched, by reason (prefix = prefix-map "
    "hit, affinity = pinned session, cold = consistent-hash fallback, "
    "random = router disabled).",
    ("reason",),
)
KV_PAGES_SHIPPED = REGISTRY.counter(
    "modal_tpu_kv_pages_shipped_total",
    "KV pages exported off-device for prefill→decode shipment (blob-plane "
    "page bundles; counted on the exporting replica).",
)
KV_SHIP_SECONDS = REGISTRY.histogram(
    "modal_tpu_kv_ship_seconds",
    "Device→host export time of one KV-page shipment bundle (the prefill "
    "side of a disaggregated handoff).",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5),
)

# -- device telemetry (observability/device_telemetry.py) ----------------------

KERNEL_LAUNCHES = REGISTRY.gauge(
    "modal_tpu_kernel_launches",
    "Launches of each hand-written CUDA kernel in this process so far "
    "(ops/_build.LAUNCHES, graph replays counted), read at each heartbeat push.",
    ("kernel",),
)
DEVICE_MEMORY_BYTES = REGISTRY.gauge(
    "modal_tpu_device_memory_bytes",
    "Live per-device memory from torch.cuda.memory_stats() (bytes_in_use | "
    "bytes_limit | peak_bytes_in_use); the CPU falls back to host RSS.",
    ("device", "kind"),
)
COMPILE_EVENTS = REGISTRY.counter(
    "modal_tpu_compile_events_total",
    "Kernel-build and graph-capture events (compile = an nvcc run | cache_hit "
    "= library found in the local build directory | cache_miss | "
    "graph_capture), attributed to runtime vs Image.prewarm bake; fleet hits "
    "and misses land here with source=fleet.",
    ("event", "source"),
)
COMPILE_SECONDS = REGISTRY.histogram(
    "modal_tpu_compile_seconds",
    "Kernel library build/fetch and CUDA-graph capture durations, by phase "
    "(nvcc | local | fleet | graph_capture).",
    ("phase",),
    buckets=(0.001, 0.01, 0.05, 0.1, 0.5, 1, 2.5, 5, 15, 30, 60, 120, 300, 600),
)
COMPILE_CACHE_HITS = REGISTRY.counter(
    "modal_tpu_compile_cache_hits_total",
    "Fleet compile-cache lookups served, by transport (local_dir = co-located "
    "fast path, http = blob-plane GET /compile/<key>). Each hit also lands a "
    "compile_events cache_hit with source=fleet.",
    ("source",),
)
COMPILE_CACHE_MISSES = REGISTRY.counter(
    "modal_tpu_compile_cache_misses_total",
    "Fleet compile-cache lookups that fell through to a local nvcc build, by "
    "transport consulted.",
    ("source",),
)
COMPILE_CACHE_PUTS = REGISTRY.counter(
    "modal_tpu_compile_cache_puts_total",
    "Freshly built kernel libraries pushed into the fleet store, by transport.",
    ("source",),
)
COMPILE_CACHE_ERRORS = REGISTRY.counter(
    "modal_tpu_compile_cache_errors_total",
    "Fleet compile-cache degradations, by kind (unreachable = transport "
    "failure entering/holding the cooldown window, corrupt = integrity "
    "mismatch → entry evicted). Degradations are silent: the build falls "
    "back to a local nvcc run, these counters are the only trace.",
    ("kind",),
)
STEP_SECONDS = REGISTRY.histogram(
    "modal_tpu_step_seconds",
    "Train/decode step wall time (post-compile steady state), by loop kind.",
    ("kind",),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 15, 60),
)

# -- weights loader (models/weights.py) ----------------------------------------

WEIGHTS_LOADED_BYTES = REGISTRY.counter(
    "modal_tpu_weights_loaded_bytes_total",
    "Checkpoint bytes streamed source→host→device by the weights loader.",
)
WEIGHTS_LOAD_GBPS = REGISTRY.gauge(
    "modal_tpu_weights_load_gbps",
    "Most recent checkpoint-load throughput (GB/s, ranged source reads overlapped with device placement).",
)
PEAK_RSS_BYTES = REGISTRY.gauge(
    "modal_tpu_peak_rss_bytes",
    "Process peak RSS (ru_maxrss), sampled at data-plane checkpoints (weights-load finish, bench roll-up).",
)


# -- SDK client and payloads (_utils/grpc_utils.py, serialization.py) ----------

CLIENT_RPC_LATENCY = REGISTRY.histogram(
    "modal_tpu_client_rpc_latency_seconds",
    "Client-observed unary RPC latency (includes transport + server).",
    ("method",),
)
CLIENT_RPC_RETRIES = REGISTRY.counter(
    "modal_tpu_client_rpc_retries_total",
    "Transient-error retries performed by retry_transient_errors.",
    ("method",),
)
CIRCUIT_BREAKER_OPENS = REGISTRY.counter(
    "modal_tpu_circuit_breaker_opens_total",
    "Times a per-method client circuit breaker opened.",
    ("method",),
)
SERIALIZED_BYTES = REGISTRY.counter(
    "modal_tpu_serialized_bytes_total",
    "Payload bytes produced by serialize(), by placement (oob=zero-copy raw segment, inband=pickle stream).",
    ("placement",),
)
DATAPLANE_COPY_BYTES = REGISTRY.counter(
    "modal_tpu_dataplane_copy_bytes_total",
    "Full-size memcpys the payload path could not avoid, by site (join=inline proto field, legacy=non-framed fallback).",
    ("site",),
)


def observe_peak_rss() -> float:
    """Sample ru_maxrss into the PEAK_RSS_BYTES gauge; returns bytes."""
    import resource
    import sys

    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rss *= 1 if sys.platform == "darwin" else 1024  # linux reports KiB
    PEAK_RSS_BYTES.set(rss)
    return float(rss)


# -- control plane, scheduler, worker and blob store (server/) ------------------

RPC_LATENCY = REGISTRY.histogram(
    "modal_tpu_rpc_latency_seconds",
    "Server-side RPC handler latency (unary methods; every gRPC plane).",
    ("method",),
)
RPC_TOTAL = REGISTRY.counter(
    "modal_tpu_rpc_total",
    "Server-side RPC calls by method and outcome (ok|error); streams included.",
    ("method", "code"),
)
SCHED_QUEUE_DEPTH = REGISTRY.gauge(
    "modal_tpu_scheduler_queue_depth",
    "Pending (unclaimed) inputs across all functions, sampled per tick.",
)
SCHED_PLACEMENT_LATENCY = REGISTRY.histogram(
    "modal_tpu_scheduler_placement_latency_seconds",
    "Wall time to place one task/gang (worker pick + chip pin + assignment).",
    ("kind",),
)
SCHED_TASKS_LAUNCHED = REGISTRY.counter(
    "modal_tpu_scheduler_tasks_launched_total",
    "Tasks handed to workers, by kind (task|gang_member|sandbox).",
    ("kind",),
)
# -- the warm pool (server/warm_pool.py) --------------------------------------

WARM_POOL_SIZE = REGISTRY.gauge(
    "modal_tpu_warm_pool_size",
    "Pre-forked pool interpreters in this worker process, by state (booting|parked|serving).",
    ("state",),
)
WARM_POOL_PLACEMENTS = REGISTRY.counter(
    "modal_tpu_warm_pool_placements_total",
    "Task placements by warm-pool outcome (hit | miss_empty | miss_key | handoff_failed).",
    ("outcome",),
)
WARM_POOL_EVICTIONS = REGISTRY.counter(
    "modal_tpu_warm_pool_evictions_total",
    "Parked interpreters evicted, by reason (image_change | target_shrunk | drain | died).",
    ("reason",),
)
WARM_POOL_HANDOFF_SECONDS = REGISTRY.histogram(
    "modal_tpu_warm_pool_handoff_seconds",
    "Adoption latency: handoff enqueued to interpreter ack (the warm 'boot').",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10),
)
SCHED_TASKS_REAPED = REGISTRY.counter(
    "modal_tpu_scheduler_tasks_reaped_total",
    "Dead/stuck tasks force-reaped, by reason.",
    ("reason",),
)
INPUT_QUEUE_WAIT = REGISTRY.histogram(
    "modal_tpu_input_queue_wait_seconds",
    "Enqueue-to-claim wait per input (the queue segment of E2E latency).",
)
WORKER_HEARTBEATS = REGISTRY.counter(
    "modal_tpu_worker_heartbeats_total",
    "Worker heartbeats received by the control plane.",
)
TASK_RESULTS = REGISTRY.counter(
    "modal_tpu_task_results_total",
    "Container final results, by GenericResult status name.",
    ("status",),
)
IMAGE_BUILD_SECONDS = REGISTRY.histogram(
    "modal_tpu_image_build_seconds",
    "Image materialization wall time on the worker (cache hits are fast).",
    buckets=(0.01, 0.1, 0.5, 1, 5, 15, 30, 60, 120, 300, 600),
)
BLOB_BYTES = REGISTRY.counter(
    "modal_tpu_blob_bytes_total",
    "Blob HTTP payload bytes by direction (in=uploads, out=downloads).",
    ("direction",),
)
BLOB_REQUESTS = REGISTRY.counter(
    "modal_tpu_blob_requests_total",
    "Blob HTTP requests by route and status class.",
    ("route", "code"),
)
BLOB_SPILLS = REGISTRY.counter(
    "modal_tpu_blob_spills_total",
    "Blob downloads spilled to disk and returned as mmap-backed views instead of bytes.",
)
DISPATCH_EXCHANGES = REGISTRY.counter(
    "modal_tpu_dispatch_exchange_total",
    "Container turnarounds on the merged FunctionExchange RPC, by payload "
    "(with_outputs = PutOutputs piggybacked on the claim, claim_only).",
    ("carried",),
)


# -- the durable control plane (server/journal.py) and the local fast path -----
# (_utils/local_transport.py, _utils/blob_utils.py)

JOURNAL_APPENDS = REGISTRY.counter(
    "modal_tpu_journal_appends_total",
    "Write-ahead journal records appended, by record type.",
    ("type",),
)
JOURNAL_APPEND_SECONDS = REGISTRY.histogram(
    "modal_tpu_journal_append_seconds",
    "Wall time of one journal append (serialize + buffered write + flush); sampled 1-in-32.",
    buckets=(0.000005, 0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.005, 0.025),
)
JOURNAL_BYTES = REGISTRY.counter(
    "modal_tpu_journal_bytes_total",
    "Bytes appended to the write-ahead journal.",
)
JOURNAL_COMPACTIONS = REGISTRY.counter(
    "modal_tpu_journal_compactions_total",
    "Journal compactions (snapshot written, covered segments pruned).",
)
RECOVERIES = REGISTRY.counter(
    "modal_tpu_recoveries_total",
    "Control-plane recoveries from the journal, by outcome.",
    ("outcome",),
)
RECOVERY_SECONDS = REGISTRY.gauge(
    "modal_tpu_recovery_seconds",
    "Duration of the most recent journal replay (snapshot + tail).",
)
RECOVERY_REPLAYED = REGISTRY.counter(
    "modal_tpu_recovery_replayed_records_total",
    "Journal records applied during recovery, by record type.",
    ("type",),
)
RECOVERY_REQUEUED_INPUTS = REGISTRY.counter(
    "modal_tpu_recovery_requeued_inputs_total",
    "Orphaned (claimed-at-crash) inputs requeued for free during recovery.",
)
WORKERS_READOPTED = REGISTRY.counter(
    "modal_tpu_workers_readopted_total",
    "Journal-recovered workers re-adopted via their first post-restart heartbeat.",
)
IDEMPOTENT_REPLAYS = REGISTRY.counter(
    "modal_tpu_idempotent_replays_total",
    "Mutating RPCs answered from the journal-backed idempotency seen-set.",
    ("method",),
)
FASTPATH_CALLS = REGISTRY.counter(
    "modal_tpu_fastpath_calls_total",
    "RPCs by the transport rung that served them (inproc | uds | tcp).",
    ("transport",),
)
FASTPATH_FALLBACKS = REGISTRY.counter(
    "modal_tpu_fastpath_fallbacks_total",
    "Fast-path rungs abandoned mid-flight, by rung and reason "
    "(e.g. uds/socket_gone, stream/reset, batch/unimplemented).",
    ("rung", "reason"),
)

# -- the App layer's dispatch (functions.py, parallel_map.py) ------------------

DISPATCH_BATCH_OCCUPANCY = REGISTRY.histogram(
    "modal_tpu_dispatch_batch_occupancy",
    "Items per coalesced scheduling RPC flush (submit/claim/publish planes).",
    ("rpc",),
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)
OUTPUT_STREAM_EVENTS = REGISTRY.counter(
    "modal_tpu_output_stream_events_total",
    "Push-streamed output delivery lifecycle (open | batch | keepalive | "
    "reconnect | reset | fallback).",
    ("event",),
)
DISPATCH_LATENCY = REGISTRY.histogram(
    "modal_tpu_dispatch_latency_seconds",
    "Client-observed end-to-end `.remote()` wall time (the function.call root span); "
    "observations carry the trace_id as an OpenMetrics exemplar, so a p99 bucket "
    "links to `modal_tpu app trace <trace_id>`.",
)

# -- the metrics plane: the time-series store, SLO alerts and the sampling
# profiler (observability/timeseries.py, slo.py, profiler.py) ----------------

PROFILER_SAMPLES = REGISTRY.counter(
    "modal_tpu_profiler_samples_total",
    "Stack samples taken by the in-process sampling profiler.",
)
PROFILER_RUNNING = REGISTRY.gauge(
    "modal_tpu_profiler_running",
    "1 while the process's sampling profiler is active.",
)
TIMESERIES_SAMPLES = REGISTRY.counter(
    "modal_tpu_timeseries_samples_total",
    "Samples taken by the supervisor-resident time-series store.",
)
TIMESERIES_POINTS = REGISTRY.gauge(
    "modal_tpu_timeseries_points",
    "Points currently held per rollup tier of the time-series store "
    "(bounded by construction: tiers × series cap × ring length).",
    ("tier",),
)
TIMESERIES_SAMPLE_SECONDS = REGISTRY.histogram(
    "modal_tpu_timeseries_sample_seconds",
    "Wall time of one full store sample (every tracked family snapshotted, "
    "deltas computed, rollups folded).",
    buckets=(0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.05, 0.25),
)
SLO_BURN_RATE = REGISTRY.gauge(
    "modal_tpu_slo_burn_rate",
    "Current burn rate per SLO rule and window (fast|slow): observed/objective, "
    "1.0 = exactly on budget (observability/slo.py).",
    ("rule", "window"),
)
SLO_ALERTS_FIRING = REGISTRY.gauge(
    "modal_tpu_slo_alerts_firing",
    "1 while the named SLO rule's burn-rate alert is firing.",
    ("rule",),
)
SLO_ALERT_TRANSITIONS = REGISTRY.counter(
    "modal_tpu_slo_alert_transitions_total",
    "SLO alert state transitions (firing | resolved); each is also a "
    "journaled event, so firing alerts survive a supervisor crash_restart.",
    ("rule", "transition"),
)
