"""Host time of a serving-loop iteration: the mean, over the `serving.step`
spans that began between the window's opening and the profiler's start,
of the span's length less the host's waits on the card (`sync_ms`, the
decode step's read-back, and `prefill_sync_ms`, the last prefill chunk's)."""

from benchmark.steps import mean, window_steps


def read(run):
    return mean([(end - start) * 1e3 - a["sync_ms"] - a["prefill_sync_ms"]
                 for start, end, a in window_steps(run)])
