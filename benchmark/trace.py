"""The device trace of a `--trace 1` run: `torch.profiler` over the last
seconds of the window, reduced to what the per-layer readers need.

- `ops`: every operation that ran on the device (kernels, copies, sets),
  as (name, start, end) in seconds on the profiler's clock; host-side
  ranges that the profiler also draws on the device are left out, as
  `modal_tpu_torch/tools/profile_train.py` leaves them out;
- `busy_s`: the length of the union of those intervals, `window_s` the
  traced window's length on the host clock;
- `breakdown`: the ten operations that took most device time, and the
  ten longest idle gaps summed by what the host was doing during each
  (the innermost host range open at the gap's middle)."""

from __future__ import annotations

import dataclasses
import time

# Kernel names of the program's hand-written kernels, as the trace shows them
K1, K2, K3, K4 = "flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "paged_decode_kernel"
ADAM = "adam"  # the fused AdamW kernels (torch's `FusedAdamW` / `fused_adam`)


@dataclasses.dataclass
class Trace:
    ops: list  # (name, start_s, end_s) on the device
    host: list  # (name, start_s, end_s) on the host, the same clock
    t0: float  # host perf_counter when the trace started
    t1: float  # ... and ended
    window_s: float

    def kernels(self, needle: str) -> list:
        return [op for op in self.ops if needle in op[0]]

    @property
    def busy_s(self) -> float:
        total, end = 0.0, float("-inf")
        for _n, s, e in sorted(self.ops, key=lambda op: op[1]):
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total

    def idle_gaps(self) -> list:
        """(start, end) of every stretch between device operations."""
        gaps, end = [], None
        for _n, s, e in sorted(self.ops, key=lambda op: op[1]):
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        by_op: dict = {}
        for name, s, e in self.ops:
            by_op[name] = by_op.get(name, 0.0) + (e - s)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        host = sorted(self.host, key=lambda r: r[1])
        by_host: dict = {}
        i, stack = 0, []
        for gs, ge in self.idle_gaps():
            mid = 0.5 * (gs + ge)
            while i < len(host) and host[i][1] <= mid:
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            doing = stack[-1][0] if stack else "host outside any traced range"
            by_host[doing] = by_host.get(doing, 0.0) + (ge - gs)
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in ops], "idle_gaps": [[n[:120], v] for n, v in gaps]}


def _activities() -> list:
    """Host and device activity; host only where there is no card (the
    CPU tests)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Tracer:
    """`start()` and `stop()` around the traced stretch; `stop` returns the
    `Trace`. Device and host activity are both recorded."""

    def __init__(self):
        self.prof = None
        self.t0 = 0.0

    @staticmethod
    def warm() -> None:
        """One empty profile in set-up, so the window's `start` finds the
        profiler's device tracing already initialised."""
        import torch

        with torch.profiler.profile(activities=_activities()):
            _sync()

    def start(self) -> None:
        import torch

        self.prof = torch.profiler.profile(activities=_activities())
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> Trace:
        import torch

        _sync()
        t1 = time.perf_counter()
        self.prof.stop()
        events = self.prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        host_names = {e.name for e in events if e.device_type != cuda}
        ops, host = [], []
        for e in events:
            rng = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            if e.device_type == cuda:
                if e.name not in host_names:
                    ops.append(rng)
            else:
                host.append(rng)
        self.prof = None
        return Trace(ops=ops, host=host, t0=self.t0, t1=t1, window_s=t1 - self.t0)

