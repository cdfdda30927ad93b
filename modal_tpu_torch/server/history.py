"""The history, alert and dashboard query plane.

One payload builder shared by the ``MetricsHistory`` RPC (services.py) and
``GET /metrics/history`` (blob_server.py): both answer the same queries
against the supervisor's time-series store and SLO evaluator. Payloads are
JSON: their shapes are the library's and evolve faster than the wire. This
is the JAX package's plane (modal_tpu/server/history.py).

Queries:

- ``describe``: tracked families, tiers, point counts.
- ``series``: one family's windowed points (with p50/p95/p99 for histograms).
- ``quantile``: one histogram quantile over a window.
- ``alerts``: burn rates per rule and alert states (journal-backed).
- ``top``: the dashboard: fleet roll-ups, per-replica serving telemetry
  (from each task's raw heartbeat push), device memory, burn rates.
- ``snapshot``: every tracked family's window, the replicas and alerts.
"""


from __future__ import annotations

import json
import time
from typing import Any, Optional

from ..proto import api_pb2

# windows the top dashboard summarizes over (seconds)
TOP_FAST_WINDOW_S = 60.0
TOP_SLOW_WINDOW_S = 600.0


def history_payload(
    state: Any,
    query: str,
    family: str = "",
    window_s: float = 0.0,
    q: float = 0.0,
) -> dict:
    """Answer one history query against `state` (a ServerState). Unknown
    queries and a missing store degrade to explanatory payloads, never
    exceptions — this feeds CLIs and dashboards."""
    store = state.timeseries
    evaluator = state.slo
    query = query or "describe"
    if query == "alerts":
        if evaluator is not None:
            return evaluator.payload()
        # no evaluator (e.g. sampler disabled): the journal-backed
        # projection still answers — a recovered firing alert is visible
        # even before the first post-restart evaluation
        return {"time": time.time(), "rules": [], "alerts": dict(state.alerts)}
    if store is None:
        return {"error": "time-series store not running (MODAL_TPU_TS_INTERVAL=0?)"}
    if query == "describe":
        return store.describe()
    if query == "series":
        return store.series_payload(family, window_s or TOP_FAST_WINDOW_S)
    if query == "quantile":
        return {
            "family": family,
            "q": q or 0.5,
            "window_s": window_s or TOP_FAST_WINDOW_S,
            "value": store.hist_quantile(family, q or 0.5, window_s or TOP_FAST_WINDOW_S),
        }
    if query == "top":
        return top_payload(state)
    if query == "snapshot":
        return snapshot_payload(state, window_s or TOP_SLOW_WINDOW_S)
    return {"error": f"unknown history query {query!r}"}


# the one per-task heartbeat-report parser, shared with the SLO autoscaler
# (scheduler._serving_report): `top` must show exactly what scaling sees
from ..observability.device_telemetry import pushed_gauge as _push_gauge  # noqa: E402


def _replica_rows(state: Any) -> list[dict]:
    """Per-replica serving telemetry from each live task's RAW heartbeat
    push (TaskState_.telemetry_prev_json) — the same per-replica source the
    SLO autoscaler reads, so `top` shows exactly what scaling decisions see."""
    rows = []
    now = time.time()
    for task in state.tasks.values():
        raw = getattr(task, "telemetry_prev_json", "")
        if not raw:
            continue
        try:
            report = json.loads(raw)
        except ValueError:
            continue
        ttft_p95 = _push_gauge(report, "modal_tpu_serving_ttft_p95_seconds")
        tokens_per_s = _push_gauge(report, "modal_tpu_serving_tokens_per_second")
        queue_depth = _push_gauge(report, "modal_tpu_serving_queue_depth")
        pages_free = _push_gauge(report, "modal_tpu_kv_pages_free")
        pages_alloc = _push_gauge(report, "modal_tpu_kv_pages_allocated")
        # prefix-cache effectiveness and speculative acceptance per
        # replica (cumulative counters in the raw push → lifetime hit rate)
        prefix_hits = _push_gauge(report, "modal_tpu_serving_prefix_cache_hits_total")
        prefix_misses = _push_gauge(report, "modal_tpu_serving_prefix_cache_misses_total")
        prefix_hit_pct = None
        if prefix_hits is not None or prefix_misses is not None:
            lookups = (prefix_hits or 0.0) + (prefix_misses or 0.0)
            if lookups > 0:
                prefix_hit_pct = 100.0 * (prefix_hits or 0.0) / lookups
        spec_accept = _push_gauge(report, "modal_tpu_serving_spec_accept_ratio")
        # the disaggregation role (gauge value per engine's
        # ROLE_GAUGE_VALUES — mapping inlined so the supervisor never
        # imports the serving tier)
        role_code = _push_gauge(report, "modal_tpu_serving_role")
        role = None
        if role_code is not None:
            role = {0: "both", 1: "prefill", 2: "decode"}.get(int(role_code))
        # batch occupancy rides as a cumulative histogram: report its mean
        occ = (report.get("modal_tpu_serving_batch_occupancy") or {}).get("series") or {}
        occ_mean = None
        tot_sum = tot_count = 0.0
        for s in occ.values():
            if isinstance(s, dict):
                tot_sum += float(s.get("sum", 0.0))
                tot_count += float(s.get("count", 0))
        if tot_count:
            occ_mean = tot_sum / tot_count
        hbm = 0.0
        dev = (report.get("modal_tpu_device_memory_bytes") or {}).get("series") or {}
        for key, v in dev.items():
            if key.endswith(",bytes_in_use") or key.endswith(",rss"):
                try:
                    hbm += float(v)
                except (TypeError, ValueError):
                    pass
        if all(v is None for v in (ttft_p95, tokens_per_s, queue_depth, pages_free)):
            continue  # pushed telemetry, but nothing serving-shaped
        fn = state.functions.get(task.function_id)
        rows.append(
            {
                "task_id": task.task_id,
                "function": fn.tag if fn is not None else task.function_id,
                "state": api_pb2.TaskState.Name(task.state) if task.state else "",
                "age_s": round(now - task.started_at, 1) if task.started_at else None,
                "ttft_p95_s": ttft_p95,
                "tokens_per_s": tokens_per_s,
                "queue_depth": queue_depth,
                "batch_occupancy_mean": occ_mean,
                "kv_pages_free": pages_free,
                "kv_pages_allocated": pages_alloc,
                "prefix_hit_pct": prefix_hit_pct,
                "spec_accept_ratio": spec_accept,
                "role": role,
                "memory_bytes": hbm or None,
            }
        )
    return rows


def fleet_summary(store: Any) -> tuple[dict, list]:
    """The `top` dashboard's fleet roll-up + tokens/s sparkline against any
    object exposing the TimeSeriesStore query surface — the supervisor's own
    store here, or a federation's merged snapshot."""
    w = TOP_FAST_WINDOW_S
    fleet = {
        "ttft_p50_s": store.hist_quantile("modal_tpu_serving_ttft_seconds", 0.5, w),
        "ttft_p95_s": store.hist_quantile("modal_tpu_serving_ttft_seconds", 0.95, w),
        "dispatch_p50_s": store.hist_quantile("modal_tpu_dispatch_latency_seconds", 0.5, w),
        "batch_occupancy_p50": store.hist_quantile("modal_tpu_serving_batch_occupancy", 0.5, w),
        "requests_per_s": store.counter_rate("modal_tpu_serving_requests_total", w),
        # call outcomes from the bounded task-results family (the
        # rpc_total label space overflows the store's series cap)
        "calls_per_s": store.counter_rate("modal_tpu_task_results_total", w),
        "call_errors_per_s": store.counter_rate(
            "modal_tpu_task_results_total", w, label_filter="FAILURE"
        ),
        "preemptions_per_s": store.counter_rate("modal_tpu_serving_preemptions_total", w),
        # sharded control plane (server/shards.py): zero/absent = monolith
        "placement_p95_s": store.hist_quantile(
            "modal_tpu_shard_placement_latency_seconds", 0.95, w
        ),
        "director_reroutes_per_s": store.counter_rate("modal_tpu_director_reroutes_total", w),
    }
    for name, key in (
        ("modal_tpu_serving_tokens_per_second", "tokens_per_s"),
        ("modal_tpu_serving_queue_depth", "queue_depth"),
        ("modal_tpu_kv_pages_free", "kv_pages_free"),
        ("modal_tpu_kv_pages_allocated", "kv_pages_allocated"),
        ("modal_tpu_scheduler_queue_depth", "scheduler_queue_depth"),
        ("modal_tpu_device_memory_bytes", "device_memory_bytes"),
        ("modal_tpu_control_shards_active", "control_shards_active"),
        ("modal_tpu_shard_takeover_seconds", "shard_takeover_s"),
    ):
        stats = store.gauge_stats(name, w)
        fleet[key] = stats["last"] if stats else None
    # tokens/s sparkline over the slow window (merged across series)
    pts = store.window_points("modal_tpu_serving_tokens_per_second", TOP_SLOW_WINDOW_S)
    merged: dict[float, float] = {}
    for series in pts.values():
        for p in series:
            merged[p[0]] = merged.get(p[0], 0.0) + p[1]
    sparkline = [[round(t, 1), round(v, 2)] for t, v in sorted(merged.items())]
    return fleet, sparkline


def snapshot_payload(state: Any, window_s: float) -> dict:
    """One shard's whole windowed store in a single payload — every tracked
    family's series (wire-shaped, with kind + bounds), the per-replica rows,
    and the alert view. The federation layer (observability/federation.py)
    fetches exactly one of these per shard per federated query."""
    store = state.timeseries
    evaluator = state.slo
    families: dict[str, dict] = {}
    if store is not None:
        for family in store.families:
            payload = store.series_payload(family, window_s)
            if payload.get("series") or payload.get("kind"):
                families[family] = payload
    alerts = (
        evaluator.payload()
        if evaluator is not None
        else {"time": time.time(), "rules": [], "alerts": dict(state.alerts)}
    )
    return {
        "time": time.time(),
        "window_s": window_s,
        "shard_index": getattr(state, "shard_index", 0),
        "families": families,
        "replicas": _replica_rows(state),
        "alerts": alerts,
    }


def top_payload(state: Any) -> dict:
    """The `top` dashboard payload."""
    store = state.timeseries
    evaluator = state.slo
    now = time.time()
    fleet: dict = {}
    sparkline: list = []
    if store is not None:
        fleet, sparkline = fleet_summary(store)
    alerts = evaluator.payload() if evaluator is not None else {"rules": [], "alerts": dict(state.alerts)}
    return {
        "time": now,
        "store": store.describe() if store is not None else None,
        "fleet": fleet,
        "tokens_sparkline": sparkline,
        "replicas": _replica_rows(state),
        "alerts": alerts,
    }
