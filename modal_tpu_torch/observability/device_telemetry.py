"""Device and compile telemetry (port of
modal_tpu/observability/device_telemetry.py).

Importing this module never imports torch: each hook is a no-op until the
process has imported it, so a container that never touches the card pays
no torch import for its heartbeat.

- `observe_step_time(seconds, kind)` and `StepTimer(kind).mark()`: one
  `modal_tpu_step_seconds{kind}` sample per step. CUDA launches return
  before the work is done, so the caller synchronizes the device before
  `mark()`, as the JAX loop blocks on the step's outputs.
- `sample_device_memory()`: `modal_tpu_device_memory_bytes{device,kind}`
  from `torch.cuda.memory_stats()` for every card; with no CUDA context, the
  process's live RSS as device="host", kind="rss", as in JAX.
- `install_compile_hooks()`: in place of jax.monitoring's listeners, the
  kernel build (`ops/_build.report_compile`) and the CUDA-graph captures
  (`models/paged_kv.DecodeGraph`) feed `modal_tpu_compile_events_total
  {event,source}` (compile = an nvcc run, cache_hit = the library was in the
  build directory, cache_miss, graph_capture; source is `_compile_source()`,
  and the fleet tier counts its own hits and misses with source=fleet) and
  `modal_tpu_compile_seconds{phase}` (nvcc | local | fleet | graph_capture).
- `maybe_install_fleet_cache()`: the fleet compile-cache tier under the
  kernel build (`runtime/compile_client.py`).
- `container_report()` / `merge_container_report()`: the heartbeat push, in
  the JAX package's JSON schema (`metrics.export_families`), so either
  package's worker merges either package's report; the port's report also
  carries `modal_tpu_kernel_launches{kernel}`, the process's
  `ops/_build.LAUNCHES` at the push; `pushed_gauge` reads one
  gauge out of a report, `telemetry_summary` rolls the compile counters up.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

_install_lock = threading.Lock()
_installed = False

# ops/_build.report_compile events -> (compile-event label or None, seconds phase)
_EVENT_MAP = {
    "nvcc": ("compile", "nvcc"),
    "local": ("cache_hit", "local"),
    "fleet": (None, "fleet"),  # the fleet tier counts its own hit (source=fleet)
    "cache_miss": ("cache_miss", None),
    "graph_capture": ("graph_capture", "graph_capture"),
}


def _compile_source() -> str:
    """Attribution label: builds during an `Image.prewarm` build are the
    warm-pool bake, not serving-path cost (MODAL_TPU_PREWARM_BUILD is set by
    the image build's prewarm step)."""
    return "prewarm" if os.environ.get("MODAL_TPU_PREWARM_BUILD") else "runtime"


def _on_compile(event: str, seconds: float) -> None:
    from .catalog import COMPILE_EVENTS, COMPILE_SECONDS

    label, phase = _EVENT_MAP.get(event, ("other", None))
    if label is not None:
        COMPILE_EVENTS.inc(event=label, source=_compile_source())
    if phase is not None:
        COMPILE_SECONDS.observe(max(0.0, float(seconds)), phase=phase)


def install_compile_hooks() -> bool:
    """Register the compile listener with the kernel build. Idempotent;
    False until the process has imported torch (this must never be the call
    that pays for it: callers retry from the heartbeat path)."""
    global _installed
    with _install_lock:
        if _installed:
            return True
        from ..config import torch_imported

        if not torch_imported():
            return False
        from ..ops import _build

        _build.add_compile_listener(_on_compile)
        _installed = True
        return True


def maybe_install_fleet_cache() -> bool:
    """Attach the fleet compile-cache tier under the kernel build
    (runtime/compile_client.py). A no-op until torch is imported, when the
    MODAL_TPU_COMPILE_CACHE gate is off or no fleet coordinates are set, and
    silent on every failure: caching must never be the reason a container
    errors."""
    try:
        from ..runtime.compile_client import install_fleet_cache

        return install_fleet_cache()
    except Exception:  # noqa: BLE001 — degrade to local-only builds
        return False


_last_sample_t = 0.0


def sample_device_memory(min_interval_s: float = 0.0) -> int:
    """Refresh the per-device memory gauges; returns the number of devices
    sampled. Safe to call from hot paths with `min_interval_s` throttling.
    Never the call that imports torch or creates a CUDA context."""
    global _last_sample_t
    now = time.monotonic()
    if min_interval_s and now - _last_sample_t < min_interval_s:
        return 0
    _last_sample_t = now
    from .catalog import DEVICE_MEMORY_BYTES

    from ..config import torch_imported

    torch = sys.modules.get("torch") if torch_imported() else None
    if torch is not None and torch.cuda.is_available() and torch.cuda.is_initialized():
        n = torch.cuda.device_count()
        for i in range(n):
            stats = torch.cuda.memory_stats(i)
            label = f"cuda:{i}"
            DEVICE_MEMORY_BYTES.set(float(stats.get("allocated_bytes.all.current", 0)), device=label, kind="bytes_in_use")
            DEVICE_MEMORY_BYTES.set(float(stats.get("allocated_bytes.all.peak", 0)), device=label, kind="peak_bytes_in_use")
            DEVICE_MEMORY_BYTES.set(float(torch.cuda.get_device_properties(i).total_memory), device=label, kind="bytes_limit")
        return n
    rss = _live_rss_bytes()
    if not rss:
        return 0
    DEVICE_MEMORY_BYTES.set(float(rss), device="host", kind="rss")
    return 1


def _live_rss_bytes() -> int:
    """Current (not peak) resident set size; 0 when unreadable (non-Linux)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
    except (OSError, ValueError, IndexError):
        return 0


def observe_step_time(seconds: float, kind: str) -> None:
    """Step-time histogram sample (kind: train | decode | prefill)."""
    from .catalog import STEP_SECONDS

    STEP_SECONDS.observe(max(0.0, float(seconds)), kind=kind)


class StepTimer:
    """Stamps one step-time sample per `mark()`.

    >>> timer = StepTimer("train")
    >>> for _ in range(steps): run_step(); torch.cuda.synchronize(); timer.mark()
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._t = time.perf_counter()

    def mark(self) -> float:
        now = time.perf_counter()
        dt = now - self._t
        self._t = now
        observe_step_time(dt, self.kind)
        return dt


# the families a container pushes over its heartbeat: the JAX package's list
# (device_telemetry.PUSH_FAMILIES), so one worker reads both packages'
# reports the same way (families the port does not register are skipped),
# and the port's own kernel launch counts
PUSH_FAMILIES = (
    "modal_tpu_kernel_launches",
    "modal_tpu_device_memory_bytes",
    "modal_tpu_compile_events_total",
    "modal_tpu_compile_seconds",
    "modal_tpu_compile_cache_hits_total",
    "modal_tpu_compile_cache_misses_total",
    "modal_tpu_compile_cache_puts_total",
    "modal_tpu_compile_cache_errors_total",
    "modal_tpu_step_seconds",
    "modal_tpu_profiler_samples_total",
    "modal_tpu_serving_ttft_seconds",
    "modal_tpu_serving_ttft_p95_seconds",
    "modal_tpu_serving_tokens_per_second",
    "modal_tpu_serving_tokens_total",
    "modal_tpu_serving_queue_depth",
    "modal_tpu_serving_batch_occupancy",
    "modal_tpu_serving_requests_total",
    "modal_tpu_kv_pages_allocated",
    "modal_tpu_kv_pages_free",
    "modal_tpu_serving_prefix_cache_hits_total",
    "modal_tpu_serving_prefix_cache_misses_total",
    "modal_tpu_serving_spec_accept_ratio",
    "modal_tpu_serving_sampled_tokens_total",
    "modal_tpu_kv_pages_cow_copies_total",
    "modal_tpu_serving_role",
    "modal_tpu_kv_pages_shipped_total",
    "modal_tpu_kv_ship_seconds",
    "modal_tpu_serving_router_routed_total",
)


def pushed_gauge(report: dict, name: str) -> Optional[float]:
    """One gauge family out of a pushed heartbeat report (the
    export_families JSON shape): the sum across its series, None when the
    family is absent or carries nothing numeric."""
    series = (report.get(name) or {}).get("series")
    if not isinstance(series, dict):
        return None
    vals = []
    for v in series.values():
        try:
            vals.append(float(v))
        except (TypeError, ValueError):
            continue
    return sum(vals) if vals else None


def container_report() -> str:
    """The heartbeat payload: attach the hooks (lazily, once torch is in),
    sample device memory, then export the push list as compact JSON ('' when
    there is nothing to report)."""
    import json

    install_compile_hooks()
    maybe_install_fleet_cache()
    sample_device_memory(min_interval_s=5.0)
    from .catalog import KERNEL_LAUNCHES

    build = sys.modules.get("modal_tpu_torch.ops._build")
    if build is not None:  # the kernels' launch counts, once a kernel module loaded
        for name, n in build.LAUNCHES.items():
            KERNEL_LAUNCHES.set(float(n), kernel=name)
    from .metrics import export_families

    report = export_families(PUSH_FAMILIES)
    if not report:
        return ""
    try:
        return json.dumps(report, separators=(",", ":"))
    except (TypeError, ValueError):
        return ""


def _scope_device_series(report: dict, task_id: str) -> dict:
    """Prefix the device label with the pushing task's id: every container
    reports its own view of the same physical devices (or the 'host' RSS
    fallback), so unscoped gauges from two live containers would overwrite
    each other latest-wins."""
    if not task_id or not isinstance(report, dict):
        return report
    family = report.get("modal_tpu_device_memory_bytes")
    if not isinstance(family, dict) or not isinstance(family.get("series"), dict):
        return report
    scoped = dict(report)
    scoped["modal_tpu_device_memory_bytes"] = {
        **family,
        "series": {f"{task_id}/{key}": v for key, v in family["series"].items()},
    }
    return scoped


def drop_task_device_series(task_id: str) -> int:
    """Forget a finished task's device-memory gauge series (the task-scoped
    keys `_scope_device_series` created), so a long-lived worker does not
    keep dead tasks' values. Returns the series dropped."""
    if not task_id:
        return 0
    from .catalog import DEVICE_MEMORY_BYTES

    prefix = f"{task_id}/"
    m = DEVICE_MEMORY_BYTES
    with m._lock:
        victims = [k for k in m._series if k and str(k[0]).startswith(prefix)]
        for k in victims:
            del m._series[k]
    return len(victims)


def merge_container_report(telemetry_json: str, prev_json: str = "", task_id: str = "") -> str:
    """Control-plane side: merge one container's pushed report (deltas vs the
    task's previous push; device gauges scoped per task). Returns the raw
    report to store as the new `prev`. Malformed payloads merge nothing and
    clear the stored prev."""
    import json

    if not telemetry_json:
        return prev_json
    try:
        report = json.loads(telemetry_json)
        prev = json.loads(prev_json) if prev_json else None
    except ValueError:
        return ""
    from .catalog import DEVICE_MEMORY_BYTES  # noqa: F401 — registers the families
    from .metrics import merge_families

    merge_families(_scope_device_series(report, task_id), prev)
    return telemetry_json


def telemetry_summary() -> dict:
    """Compact roll-up: compile counts, fleet hits/misses/puts and the p50s
    of compile and step times, when any."""
    from .catalog import (
        COMPILE_CACHE_HITS,
        COMPILE_CACHE_MISSES,
        COMPILE_CACHE_PUTS,
        COMPILE_EVENTS,
        COMPILE_SECONDS,
        STEP_SECONDS,
    )

    out: dict = {}
    if COMPILE_EVENTS.total():
        out["compile_events"] = dict(COMPILE_EVENTS.snapshot())
    fleet = {
        "hits": COMPILE_CACHE_HITS.total(),
        "misses": COMPILE_CACHE_MISSES.total(),
        "puts": COMPILE_CACHE_PUTS.total(),
    }
    if any(fleet.values()):
        out["compile_cache"] = fleet
    if COMPILE_SECONDS.count_total():
        out["compile_p50_s"] = COMPILE_SECONDS.quantile(0.5)
    if STEP_SECONDS.count_total():
        out["step_p50_s"] = STEP_SECONDS.quantile(0.5)
    return out
