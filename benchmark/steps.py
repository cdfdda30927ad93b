"""What the engine-step readers share: the run's `serving.step` spans (one a
serving-loop iteration, `modal_tpu_torch/serving/step_trace.py`), read
through the span tap, and their place on the device trace's clock.

A step span's host phases run in the order of `PHASES` from its start,
each `<phase>_ms` long; `replay_at_ms` is when, from the start, the decode
step's device work was launched. Spans stamp the wall clock. The trace's
times are offsets from the profiler's start, which `Trace` does not keep:
`offset` recovers it from events both timelines hold, the decode graph's
launch (`cudaGraphLaunch` in the trace's host events). The device work
of decode steps and prefill chunks is told apart on the device alone
(`device_parts`). A run without step spans (a program that has none)
gives None everywhere."""

from __future__ import annotations

import bisect
import statistics
from typing import Optional

from benchmark.trace import K4

STEP = "serving.step"
PHASES = ("admit", "prefill", "grow", "launch", "sync", "emit")
GRAPH_LAUNCH = "cudaGraphLaunch"
READBACK = "Memcpy DtoH"  # a device-to-host copy: the host reads a result back
INPUT = "Memcpy HtoD"  # a host-to-device copy
SEARCH_S = 0.25  # how far the profiler's start may lie from the window's clocks
INLIER_S = 0.001  # a step's launch call follows its mark by tens of microseconds


def steps(serve) -> list:
    """(start, end, attrs) of every step span, wall clock, by start."""
    return sorted(((start, end, attrs) for name, start, end, attrs in serve.spans if name == STEP),
                  key=lambda st: st[0])


def trace_start_wall(run) -> Optional[float]:
    """The profiler's start on the wall clock, from the two clocks the
    window stamped at its opening."""
    s, tr = run.serve, run.trace
    if s is None or tr is None:
        return None
    return s.wall0 + (tr.t0 - s.t0)


def window_steps(run) -> list:
    """The steps that began between the window's opening and the
    profiler's start (the untraced part of the window)."""
    s = run.serve
    if s is None:
        return []
    end = trace_start_wall(run)
    end = s.wall1 if end is None else end
    return [st for st in steps(s) if s.wall0 <= st[0] < end]


def mean(values: list) -> Optional[float]:
    return sum(values) / len(values) if values else None


def _nearest(sorted_values: list, x: float) -> float:
    i = bisect.bisect_left(sorted_values, x)
    near = sorted_values[max(0, i - 1): i + 1]
    return min(near, key=lambda v: abs(v - x))


def offset(run) -> Optional[float]:
    """`off` with trace time = wall time - off. Each traced step's decode
    launch (its start + `replay_at_ms`) is paired with the nearest
    `cudaGraphLaunch`, the pairs shifted by an anchor: each launch within
    `SEARCH_S` of the middle step, paired with it, in turn. The anchor that
    puts the most pairs within `INLIER_S` of itself wins (a shift by one
    step matches the steps whose neighbours are as far apart as they are,
    never all of them), and the median of those pairs' differences sets
    the offset."""
    tr = run.trace
    base = trace_start_wall(run)
    if base is None:
        return None
    marks = sorted(start + a["replay_at_ms"] * 1e-3 - base for start, _end, a in steps(run.serve)
                   if a.get("replay_at_ms") is not None)
    marks = [m for m in marks if 0.0 <= m <= tr.window_s]
    launches = sorted(start for name, start, _end in tr.host if name == GRAPH_LAUNCH)
    if not marks or not launches:
        return None
    mid = marks[len(marks) // 2]
    best: list = []
    for anchor in (t - mid for t in launches if abs(t - mid) <= SEARCH_S):
        diffs = [_nearest(launches, m + anchor) - m for m in marks]
        inliers = [d for d in diffs if abs(d - anchor) <= INLIER_S]
        if len(inliers) > len(best):
            best = inliers
    return base - statistics.median(best) if best else None


def phase_at(start: float, attrs: dict, t: float) -> str:
    """The phase of a step span (starting at `start`) that holds `t`."""
    edge = start
    for p in PHASES:
        edge += attrs.get(f"{p}_ms", 0.0) * 1e-3
        if t < edge:
            return p
    return PHASES[-1]


def idle_by_phase(run) -> Optional[dict]:
    """Seconds of the traced stretch's device-idle gaps by what the engine
    was doing at each gap's midpoint: a phase of the step span that holds
    it, or "outside" any step span. The trace's device times drift from
    its host times by milliseconds over a stretch, so a gap near a phase's
    edge may count in its neighbour."""
    tr = run.trace
    off = offset(run)
    if off is None:
        return None
    spans = [(start - off, end - off, attrs) for start, end, attrs in steps(run.serve)]
    starts = [sp[0] for sp in spans]
    out = dict.fromkeys(PHASES + ("outside",), 0.0)
    for gs, ge in tr.idle_gaps():
        mid = 0.5 * (gs + ge)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid < spans[i][1]:
            out[phase_at(spans[i][0], spans[i][2], mid)] += ge - gs
        else:
            out["outside"] += ge - gs
    return out


def device_parts(run) -> Optional[tuple]:
    """(decode_s, prefill_s, chunks) of the traced stretch, split on the
    device alone: the trace's device times drift from its host times by
    milliseconds over a stretch, more than a phase lasts, while their
    order and lengths hold.

    The stream runs in order, so each read-back (`Memcpy DtoH`) closes one
    piece of the loop's device work; the piece before the first is
    partial and dropped. A piece with the decode kernel (K4) is a decode
    step: from the host-to-device copies of its inputs just before its
    first K4 to the read-back (`decode_s`, one entry a step). The rest of
    that piece, and every piece without K4 (a last chunk's read-back),
    is prefill (`prefill_s`, with the grow and launch phases' few small
    copies), shared by the `chunks` that the step spans (placed by
    `offset`) start between the first read-back and the last."""
    off = offset(run)
    if off is None:
        return None
    pieces, cur = [], []
    for op in sorted(run.trace.ops, key=lambda op: op[1]):
        cur.append(op)
        if READBACK in op[0]:
            pieces.append(cur)
            cur = []
    if len(pieces) < 2:
        return None
    decode, prefill = [], 0.0
    for piece in pieces[1:]:
        first = next((i for i, op in enumerate(piece) if K4 in op[0]), None)
        if first is None:
            prefill += sum(e - s for _n, s, e in piece)
            continue
        start = max((i for i in range(first) if INPUT in piece[i][0]), default=first)
        while start > 0 and INPUT in piece[start - 1][0]:
            start -= 1
        decode.append(sum(e - s for _n, s, e in piece[start:]))
        prefill += sum(e - s for _n, s, e in piece[:start])
    t0, t1 = pieces[0][-1][2], pieces[-1][-1][2]
    chunks = sum(1 for start, _end, a in steps(run.serve)
                 if a.get("prefill_tokens") and t0 <= start - off < t1)
    return decode, prefill, chunks

