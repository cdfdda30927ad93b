"""The 95th percentile of the inter-token gaps the clients saw, as the
end-to-end `itl_p95_ms` of `benchmark/stats.py` defines it: every gap
between consecutive tokens of a request whose later token arrived in the
window, and each in-flight request's gap still open at its end. The
window here ends where the profiler starts, so the traced stretch's host
overhead stays out of the tail."""

from benchmark import stats


def read(run):
    s = run.serve
    if s is None:
        return None
    t1 = run.trace.t0 if run.trace is not None else s.t1
    gaps = stats.itls(s.records, s.t0, t1)
    if not gaps:
        return None
    return stats.percentile(gaps, 95) * 1e3
