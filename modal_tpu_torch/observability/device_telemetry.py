"""Step times and device memory (port of the subset of
modal_tpu/observability/device_telemetry.py that the training loop uses,
:128-216).

- `observe_step_time(seconds, kind)` and `StepTimer(kind).mark()`: one
  `modal_tpu_step_seconds{kind}` sample per step. CUDA launches return
  before the work is done, so the caller synchronizes the device before
  `mark()`, as the JAX loop blocks on the step's outputs.
- `sample_device_memory()`: `modal_tpu_device_memory_bytes{device,kind}`
  from `torch.cuda.memory_stats()` for every card; with no CUDA context, the
  process's live RSS as device="host", kind="rss", as in JAX.
"""

from __future__ import annotations

import os
import time

import torch


def sample_device_memory() -> int:
    """Refresh the per-device memory gauges; returns the number of devices
    sampled. Never the call that creates a CUDA context."""
    from .catalog import DEVICE_MEMORY_BYTES

    if torch.cuda.is_available() and torch.cuda.is_initialized():
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
