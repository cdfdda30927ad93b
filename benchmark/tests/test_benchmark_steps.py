"""The engine-step readers (`benchmark/steps.py` and the four
`benchmark/metrics/*.serve.py` that read `serving.step` spans) on a
synthetic serving run and trace whose answers are known by construction.

The run: 60 steps of 30 ms from the window's opening to the profiler's
start, then 30 traced steps with a 20 ms pause (no step span) before
every fifth. Each step: admit 2, prefill 3, grow 1, launch 4, sync 15 and
emit 5 ms; its decode launch 6.9 ms in; its decode's device work from 7 to
25 ms (a copy of its inputs, K4, a read-back); on every even step a prefill
chunk's kernels from 2.5 ms on, 1.6 or 2.2 ms long in turn, the shorter
ones last chunks that end with a read-back.
The trace's clock runs 21.7 ms from where the window's clocks put the
profiler's start, more than half a step, so the nearest launch to each
guess is the wrong one."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import spec, steps
from benchmark.run import Run
from benchmark.serve import ServeRun
from benchmark.tests.tiny import REPO
from benchmark.trace import Trace

PHASE_MS = {"admit": 2.0, "prefill": 3.0, "grow": 1.0, "launch": 4.0, "sync": 15.0, "emit": 5.0}
SKEW_S = 0.0217  # trace time = wall - (profiler's start on the wall clock) + SKEW_S
LAUNCH_LAG_S = 20e-6  # the graph launch call after the step's mark
REPLAY_AT_MS = 6.9
DTOH = "Memcpy DtoH (Device -> Pageable)"
WALL0, PERF0 = 1.7e9, 50.0
UNTRACED = 60


def _attrs(k: int) -> dict:
    a = {f"{p}_ms": ms for p, ms in PHASE_MS.items()}
    a.update(prefill_sync_ms=1.0 if k % 3 == 0 else 0.0, batch=8, finished=0, replay_at_ms=REPLAY_AT_MS,
             prefill_tokens=64 if k % 2 == 0 else 0)
    return a


def _prefill_s(k: int) -> float:
    return 0.0016 + 0.0003 * (k % 4)


def synthetic(with_steps: bool = True) -> Run:
    rng = np.random.default_rng(7)
    s = ServeRun()
    s.t0, s.wall0 = PERF0, WALL0
    s.t1, s.wall1 = PERF0 + 45.0, WALL0 + 45.0
    base = WALL0 + UNTRACED * 0.030 + 0.0005  # the profiler's start, wall clock
    starts = [WALL0 + 0.001 + 0.030 * k for k in range(UNTRACED)]
    t = base + 0.010
    traced = []
    for j in range(30):
        if j and j % 5 == 0:
            t += 0.020
        traced.append(t)
        t += 0.030
    ops, host = [], []
    for k, st in enumerate(starts + traced):
        if with_steps:
            s.spans.append(("serving.step", st, st + 0.030, _attrs(k)))
        s.spans.append(("serving.prefill_chunk", st, st + 0.004, {"request_id": "r", "offset": 0, "chunk_tokens": 64}))
        if st >= base:
            tau = st - base + SKEW_S
            launch = tau + REPLAY_AT_MS * 1e-3 + LAUNCH_LAG_S + rng.uniform(-1e-5, 1e-5)
            host.append(("cudaGraphLaunch", launch, launch + 0.0002))
            host.append(("cudaLaunchKernel", tau + 0.0075, tau + 0.0076))
            if k % 2 == 0:
                end = tau + 0.0025 + _prefill_s(k)
                if k % 4 == 0:
                    ops += [("gemm", tau + 0.0025, end - 1e-5), (DTOH, end - 1e-5, end)]
                else:
                    ops.append(("gemm", tau + 0.0025, end))
            ops += [("Memcpy HtoD (Pinned -> Device)", tau + 0.007, tau + 0.00701),
                    ("void paged_decode_kernel<128>", tau + 0.00701, tau + 0.02499),
                    (DTOH, tau + 0.02499, tau + 0.025)]
    tr = Trace(ops=ops, host=host, t0=PERF0 + (base - WALL0), t1=PERF0 + (base - WALL0) + 1.1, window_s=1.1)
    s.trace = tr
    run = Run(model=None, mix={}, cell={}, seconds=45.0)
    run.serve, run.trace = s, tr
    return run


def read(name: str, run: Run):
    return spec.reader(REPO, name)(run)


def test_the_alignment_recovers_a_known_offset():
    run = synthetic()
    base = steps.trace_start_wall(run)
    assert base == pytest.approx(WALL0 + UNTRACED * 0.030 + 0.0005)
    assert steps.offset(run) == pytest.approx(base - SKEW_S - LAUNCH_LAG_S, abs=1e-4)


# Idle time by phase, by hand. Back to back, 25 ms of one step to 7 ms of
# an odd next one: 12 ms, midpoint 1 ms into its admit (12 such); to 2.5 ms
# of an even next one: 7.5 ms, midpoint in this one's emit (12 such). Across
# a pause, midpoint in it: 32 ms before steps 5, 15 and 25, 27.5 ms before
# 10 and 20. Inside an even step, the chunk's end to 7 ms, midpoint in grow:
# 2.9 ms (8 steps, 1.6 ms chunks) or 2.3 ms (7 steps, 2.2 ms chunks).
IDLE = {"admit": 12 * 0.012, "emit": 12 * 0.0075, "outside": 3 * 0.032 + 2 * 0.0275,
        "grow": 8 * 0.0029 + 7 * 0.0023}


def test_idle_time_is_split_by_the_phase_at_each_gaps_midpoint():
    by_phase = steps.idle_by_phase(synthetic())
    for phase, s in IDLE.items():
        assert by_phase[phase] == pytest.approx(s, abs=1e-6), phase
    assert sum(by_phase.values()) == pytest.approx(sum(IDLE.values()), abs=1e-6)


def test_each_reader_returns_its_value_by_hand():
    run = synthetic()
    # 60 untraced steps: 30 - 15 (sync) - 1 on every third (prefill sync)
    assert read("step_host_ms.serve", run) == pytest.approx(15.0 - 20 / 60, abs=1e-3)
    # the 30 traced steps: 18 ms from the copy of the inputs through the
    # read-back
    assert read("decode_device_ms.serve", run) == pytest.approx(18.0)
    # the traced stretch's first piece of device work, up to the first
    # read-back, is partial: the first chunk's; 14 chunks follow, 7 of 1.6
    # and 7 of 2.2 ms
    assert read("prefill_device_ms.serve", run) == pytest.approx(1.9)
    assert read("idle_unattributed_share.serve", run) == pytest.approx(
        100 * IDLE["outside"] / sum(IDLE.values()), abs=1e-4)
    decode, prefill, chunks = steps.device_parts(run)
    assert sum(decode) == pytest.approx(30 * 0.018, abs=1e-9)
    assert (prefill, chunks) == (pytest.approx(7 * 0.0016 + 7 * 0.0022, abs=1e-9), 14)


def test_the_device_split_holds_when_the_device_clock_drifts():
    """The trace's device times drift from its host times by milliseconds
    over a stretch; the split reads the device alone."""
    run = synthetic()
    want = [read(n, run) for n in ("decode_device_ms.serve", "prefill_device_ms.serve")]
    run.trace.ops = [(n, s + 0.004 * s, e + 0.004 * e) for n, s, e in run.trace.ops]
    drifted = [read(n, run) for n in ("decode_device_ms.serve", "prefill_device_ms.serve")]
    assert drifted == pytest.approx([w * 1.004 for w in want])


@pytest.mark.parametrize("name", ["step_host_ms.serve", "decode_device_ms.serve", "prefill_device_ms.serve",
                                  "idle_unattributed_share.serve"])
def test_a_run_without_step_spans_reads_none(name):
    assert read(name, synthetic(with_steps=False)) is None
    train = Run(model=None, mix={}, cell={}, seconds=45.0)
    assert read(name, train) is None
