"""The metric families the port emits: serving (the engine and its ASGI
app), device telemetry (step times, device memory), compile telemetry
(kernel builds, CUDA-graph captures, the fleet compile cache), the SDK
core (client RPCs, payload bytes), the App layer's dispatch, the control
plane, its journal and local fast path, the metrics plane (the
time-series store, SLO alerts, the sampling profiler), chaos and the
flight recorder; and every span name the port emits (`SPAN_CATALOG`).

Names and help texts are those of the JAX package's catalog, so a scrape of
either implementation reads the same way, but where a family counts the
port's own machinery: the compile families count kernel builds and graph
captures, not XLA's compiles; device memory is torch's; three label sets
lack values the port never emits (tests/test_torch_api_parity.py lists
those families). The port adds one
family, the kernel-launch gauge. Importing this module registers every
family on the process-wide REGISTRY; `METRIC_CATALOG` maps each
registered name to its help text.

`instrumented_rpc_names()` backs the instrumentation-parity check
(tests/test_torch_api_parity.py): `proto/rpc.py` wraps every registered
handler with the RPC latency and count instruments, so an RPC that a
servicer implements but the registry lacks would be unreachable and
uninstrumented, and the check fails it.
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
    "p95 TTFT over the engine's recent-request window — the SLO signal "
    "the scheduler scales serving replicas on "
    "(AutoscalerSettings.target_ttft_ms).",
)
SERVING_TOKENS_PER_S = REGISTRY.gauge(
    "modal_tpu_serving_tokens_per_second",
    "Generated tokens/s over the engine's trailing 10s window "
    "(continuous-batching throughput; the capacity signal for SLO "
    "scale-down).",
)
SERVING_TOKENS = REGISTRY.counter(
    "modal_tpu_serving_tokens_total",
    "Generated tokens, cumulative. The throughput-floor SLO rule reads "
    "this as a rate-over-window — unlike the tokens/s gauge, a wedged "
    "engine's zero deltas read as zero throughput instead of a frozen "
    "healthy value.",
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
    "KV-cache pages currently allocated out of the shared pool "
    "(models/paged_kv.py block allocator).",
)
KV_PAGES_FREE = REGISTRY.gauge(
    "modal_tpu_kv_pages_free",
    "KV-cache pages free in the shared pool (total HBM is bounded by the "
    "pool, never by num_requests × max_len).",
)
SERVING_PREFIX_HITS = REGISTRY.counter(
    "modal_tpu_serving_prefix_cache_hits_total",
    "Admissions that reused cached prefix KV pages (content-keyed lookup; "
    "the follower prefills only its suffix).",
)
SERVING_PREFIX_MISSES = REGISTRY.counter(
    "modal_tpu_serving_prefix_cache_misses_total",
    "Admissions with no cached prefix (prefix cache enabled but cold for "
    "this prompt content).",
)
KV_PAGES_COW = REGISTRY.counter(
    "modal_tpu_kv_pages_cow_copies_total",
    "Copy-on-write page copies: a write aimed at a refcount-shared KV page "
    "copied it first — shared prefix bytes are never mutated.",
)
SERVING_SAMPLED_TOKENS = REGISTRY.counter(
    "modal_tpu_serving_sampled_tokens_total",
    "Tokens emitted via temperature/top-k/top-p sampling (temperature > "
    "0), as opposed to greedy argmax.",
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
WORKER_PREEMPTIONS = REGISTRY.counter(
    "modal_tpu_worker_preemptions_total",
    "Worker drains entered (preemption notices honored by the scheduler).",
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
# -- quorum journal replication (server/replication.py)

JOURNAL_REPLICA_APPENDS = REGISTRY.counter(
    "modal_tpu_journal_replica_appends_total",
    "Replicated journal records this follower accepted (result=ok/snapshot) "
    "or refused (stale_epoch/gap/disk_full/corrupt), per writer shard.",
    ("writer", "result"),
)
JOURNAL_FENCE_REJECTIONS = REGISTRY.counter(
    "modal_tpu_journal_fence_rejections_total",
    "Stale-epoch journal replication messages rejected by this follower "
    "(fencing tokens): a sustained storm means an undead writer.",
    ("writer",),
)
JOURNAL_REPLICATION_LAG = REGISTRY.gauge(
    "modal_tpu_journal_replication_lag_seconds",
    "Age of the oldest journal record not yet acked by this follower "
    "(0 = fully caught up).",
    ("follower",),
)
JOURNAL_QUORUM_COMMIT_SECONDS = REGISTRY.histogram(
    "modal_tpu_journal_quorum_commit_seconds",
    "Wall time a mutating RPC waited at the quorum-commit barrier for "
    "follower acks (server/replication.py).",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.5, 2.5),
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

# -- chaos and the flight recorder (chaos.py, observability/flight_recorder.py)

CHAOS_SEED = REGISTRY.gauge(
    "modal_tpu_chaos_seed",
    "Active chaos policy seed (soak failures attribute to the exact run).",
)
CHAOS_INJECTIONS = REGISTRY.counter(
    "modal_tpu_chaos_injections_total",
    "Chaos faults injected, by RPC/route and kind (error|latency).",
    ("rpc", "kind"),
)
CHAOS_EVENTS = REGISTRY.counter(
    "modal_tpu_chaos_events_total",
    "Scheduled chaos lifecycle events fired (worker_kill|worker_preempt|heartbeat_blackhole).",
    ("kind",),
)
FLIGHT_RECORDER_DUMPS = REGISTRY.counter(
    "modal_tpu_flight_recorder_dumps_total",
    "Postmortem bundles frozen + dumped by the flight recorder, by trigger event "
    "(crash_restart|takeover|fence|alert).",
    ("event",),
)

# -- the sharded control plane and federation (server/shards.py,
# observability/federation.py)

CONTROL_SHARDS_ACTIVE = REGISTRY.gauge(
    "modal_tpu_control_shards_active",
    "Supervisor shards currently serving their partitions (dead/fenced shards excluded).",
)
SHARD_TAKEOVER_SECONDS = REGISTRY.gauge(
    "modal_tpu_shard_takeover_seconds",
    "Duration of the last journal-fed partition takeover (dead shard's segments replayed "
    "into a surviving shard), by adopted partition.",
    ("partition",),
)
SHARD_PLACEMENT_LATENCY = REGISTRY.histogram(
    "modal_tpu_shard_placement_latency_seconds",
    "Director-observed latency of routing one app-scoped RPC to its owning shard.",
)
DIRECTOR_REROUTES = REGISTRY.counter(
    "modal_tpu_director_reroutes_total",
    "RPCs the director re-routed away from their home shard (takeover reassignment or "
    "shard-death retarget), by reason.",
    ("reason",),
)
FEDERATION_QUERY_SECONDS = REGISTRY.histogram(
    "modal_tpu_federation_query_seconds",
    "Director-observed latency of one federated history query (fan-out to every live "
    "shard's /metrics/history + merge), by query kind.",
    ("query",),
)
FEDERATION_PARTIAL_ANSWERS = REGISTRY.counter(
    "modal_tpu_federation_partial_answers_total",
    "Federated queries answered from a strict subset of shards (a dead or timed-out "
    "shard degraded the answer; the payload is labeled, never silently truncated).",
)


METRIC_CATALOG: dict[str, str] = {m: REGISTRY.get(m).help for m in REGISTRY.names()}


# Every span name the port emits; entries ending in ".*" cover a dynamic
# family (one rpc.client.<Method> span per RPC). The parity check
# (tests/test_torch_api_parity.py) extracts the literal first argument of
# every tracing.span/open_span/record_span call under modal_tpu_torch/ and
# fails a name not declared here, or an entry that nothing emits. The JAX
# package's entries keep its names and text; the port's own say what they
# time. The attribution rules (critical_path.SEGMENT_RULES) are JAX's, so a
# port span they do not name counts as the segment of the span that covers
# it: container.import_torch, .cluster_init and .snapshot_state as
# container.boot, image.build_part as image.build, container.blob_upload as
# whatever covers the client's wait (output_deliver or gap, as JAX's
# unspanned upload). The rest are marks or roots outside a call's trace.
SPAN_CATALOG: dict[str, str] = {
    "function.call": "client root of one .remote(): everything stitches under it",
    "client.serialize": "client-side argument serialization (+ blob offload)",
    "client.deserialize": "client-side result decode (+ blob fetch for spilled results)",
    "client.prepare": "SDK prep around invocation create: stub/token setup, retry wrapper",
    "client.await_output": "SDK output-wait loop around the GetOutputs/AttemptAwait polls",
    "client.stream_outputs": "push-streamed output wait (FunctionStreamOutputs keep-alive rung)",
    "dispatch.coalesce": "coalescing window: enqueue→flush wait inside a MicroBatcher",
    "rpc.client.*": "client-observed unary RPC (interceptor, _utils/grpc_utils.py)",
    "rpc.server.*": "server handler span for a traced caller (proto/rpc.py)",
    "scheduler.queue_wait": "enqueue→claim wait, recorded retroactively at claim",
    "scheduler.place": "worker pick + chip pin + assignment",
    "worker.launch_task": "image prep + container spawn/handoff on the worker",
    "image.build": "image materialization (cache hits are fast)",
    "image.build_part": "the port's: one part of an image build (the venv, a pip layer, the #PREWARM kernel builds)",
    "container.boot": "spawn decision → ready for inputs (MODAL_TPU_TRACE_T0)",
    "container.import_torch": (
        "the port's: `import torch` on the container's main thread after its hello, for a function "
        "that asks for a card; JAX imports jax inside the user's import (container.imports), so "
        "the attribution counts this as container.boot where JAX counts container.imports"
    ),
    "container.cluster_init": (
        "the port's: a gang member's rendezvous and torch.distributed process group before the "
        "user's import (JAX's initialize_clustered, unspanned: container.boot in both)"
    ),
    "container.imports": "user-code import inside the container",
    "container.snapshot_state": (
        "the port's: the memory snapshot's restore, or the @enter(snap=True) hooks and the save, "
        "and the ContainerCheckpoint notice (unspanned in JAX: container.boot in both)"
    ),
    "container.enter_hooks": "@enter lifecycle hooks",
    "container.aot_lower": "@enter-path AOT lowering of MODAL_TPU_AOT_LOWER entry points",
    "container.input_deliver": "input delivery hop: fetch response → user.execute (deserialize + spawn)",
    "container.blob_upload": "the port's: one output's upload from the container to the blob store, by path or HTTP",
    "container.fastpath": "the port's: a zero-length mark at exit with the container's RPCs by transport rung",
    "user.execute": "one input's user-code execution (cold_call marks jit)",
    "coldstart.handoff": "warm-pool adoption: handoff enqueue → interpreter ack",
    "coldstart.preimport": "warm-pool parked pre-import of a configured module",
    "coldstart.preinit": (
        "warm-pool opt-in backend pre-initialization (the port primes torch's CPU side, never "
        "CUDA, where JAX initializes its jax backend)"
    ),
    "coldstart.aot_lower": "warm-pool parked AOT lowering of MODAL_TPU_AOT_LOWER entry points",
    "coldstart.park": "the port's: a warm-pool interpreter parked, with its torch and CUDA state",
    "coldstart.exit_after_cuda": (
        "the port's: a pooled interpreter whose placement made a CUDA context exits instead of "
        "parking again"
    ),
    "recovery.replay": "journal replay into a fresh ServerState",
    "recovery.crash_restart": "chaos supervisor crash + same-port rebuild",
    "control.takeover": "journal-fed partition takeover: dead shard's segments replayed into a survivor",
    "journal.replicate": "one replicated journal append/catch-up batch shipped to a follower shard",
    "control.seal": "quorum takeover seal: survivor's replica stream fenced at the takeover epoch and materialized",
    "director.route": "placement director routing one app-scoped RPC to its owning shard",
    "federation.query": "director-resident federated history query: fan-out to live shards + merge",
    "debug.bundle": "crash-forensics collection: postmortem rings gathered + merged timeline rendered",
    "import_cost.remote": "the port's: tools/import_cost.py's measured call, `import torch` in a function's body",
    "serving.admit": "serving-tier admission: queue wait → decode-slot + KV pages",
    "serving.prefill": "serving-tier prompt prefill (chunked; ends at the first token)",
    "serving.prefill_chunk": (
        "one prefill chunk's host enqueue (per-request timeline detail; its device time is the trace's)"
    ),
    "serving.decode": "periodic decode progress mark (every N tokens; batch occupancy + KV pages attrs)",
    "serving.preempt": "KV-pool-pressure preemption: slot freed, request requeued with its prefix",
    "serving.spec_verify": "one speculative round: draft proposals → target verify → acceptance",
    "serving.request": "root of one serving request's lifecycle: submit → done",
    "serving.stream": "one SSE token stream: open → done/reset (serving/api.py)",
    "serving.route": "fleet router dispatch: prefix-map/affinity/cold pick → replica call",
    "serving.kv_ship": "KV-page shipment leg: export off the prefill replica / import on the decode replica",
    "serving.step": (
        "the port's: one serving-loop iteration, a root of its own: the host's contiguous phases "
        "in ms (admit, prefill with its prefill_sync, grow, launch, sync, emit), batch, "
        "prefill_tokens, finished and replay_at_ms (the decode step's launch); every tap sees "
        "each one, the file sink at most one a second"
    ),
}


def declared_span_name(name: str) -> bool:
    """Is `name` (an exact span name or an f-string prefix like
    'rpc.server.') covered by the span catalog?"""
    if name in SPAN_CATALOG:
        return True
    for entry in SPAN_CATALOG:
        if entry.endswith(".*") and name.startswith(entry[:-1]):
            return True
    return False


def instrumented_rpc_names() -> frozenset:
    """Every RPC name covered by the server-side latency/count instruments:
    proto/rpc.py wraps each registered handler, so coverage == the registry
    (the control and input planes' ModalTPU service and the worker's
    TaskCommandRouter)."""
    from ..proto.rpc import ROUTER_RPCS, RPCS

    return frozenset(RPCS) | frozenset(ROUTER_RPCS)
