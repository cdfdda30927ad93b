"""The serving loop's `serving.step` span: one `ServingEngine.run_once`
iteration, a root of its own, built only while `tracing.active()`.

`StepPhases` splits the iteration's host time into contiguous phases on the
`perf_counter` clock, in the fixed order of `PHASES`, so a reader rebuilds
each phase's interval from the span's start; the attrs hold each phase's
`<phase>_ms`, the last prefill chunk's wait for its token
(`prefill_sync_ms`, inside `prefill_ms`), `batch`, `prefill_tokens`,
`finished`, and `replay_at_ms`, when the decode step was launched, which a
reader pairs with the device trace's graph launch to put the span on the
trace's clock. Device time is the trace's to give: the span adds no call
on the device and no profiler range.

Every tap sees each step span; the file sink takes at most one a second
(`SINK_EVERY_S`), so a long-lived replica's rotation keeps its request
timelines.
"""

from __future__ import annotations

import time
from typing import Optional

from ..observability import tracing

PHASES = ("admit", "prefill", "grow", "launch", "sync", "emit")
SINK_EVERY_S = 1.0

_clock = time.monotonic
_sunk_at = float("-inf")  # when the file sink last took a step span


class StepPhases:
    """One iteration's phases: `enter(phase)` ends the current phase and
    starts the next; `close()` ends the last and writes the span, whose
    length the phases sum to."""

    __slots__ = ("wall", "t0", "t", "cur", "ms", "prefill_sync_ms", "replay_at", "batch", "prefill_tokens")

    def __init__(self):
        self.wall = time.time()
        self.t0 = self.t = time.perf_counter()
        self.cur: Optional[str] = None
        self.ms = dict.fromkeys(PHASES, 0.0)
        self.prefill_sync_ms = 0.0
        self.replay_at: Optional[float] = None  # perf_counter when the decode step was launched
        self.batch = self.prefill_tokens = 0

    def enter(self, phase: str) -> None:
        now = time.perf_counter()
        if self.cur is not None:
            self.ms[self.cur] += (now - self.t) * 1e3
        self.cur, self.t = phase, now

    def prefill_sync(self, t0: float) -> None:
        """The host waited for the last chunk's token from `t0` to now."""
        self.prefill_sync_ms += (time.perf_counter() - t0) * 1e3

    def mark_replay(self) -> None:
        self.replay_at = time.perf_counter()

    def close(self, finished: int) -> None:
        global _sunk_at
        self.enter("")
        length_ms = (self.t - self.t0) * 1e3
        attrs = {f"{name}_ms": ms for name, ms in self.ms.items()}
        attrs.update(
            prefill_sync_ms=self.prefill_sync_ms,
            batch=self.batch,
            prefill_tokens=self.prefill_tokens,
            finished=finished,
            replay_at_ms=None if self.replay_at is None else (self.replay_at - self.t0) * 1e3,
        )
        sp = tracing.open_span("serving.step", start=self.wall, attrs=attrs)
        end = self.wall + length_ms * 1e-3
        now = _clock()
        if now - _sunk_at >= SINK_EVERY_S:
            _sunk_at = now
            tracing.close_span(sp, end=end)
        else:
            sp.end = end
            tracing.notify_taps(sp)
