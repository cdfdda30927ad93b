"""The window arithmetic: rates and tails over all the window's work, with a
stall inside it and requests still in flight at its end."""

from __future__ import annotations

import pytest

from benchmark import stats
from benchmark.stats import Record


def rec(submitted, arrivals, max_new, index=0):
    return Record(index=index, prompt_tokens=10, max_new_tokens=max_new, greedy=True, submitted=submitted,
                  arrivals=list(arrivals), tokens=[0] * len(arrivals))


def test_percentile_is_nearest_rank():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1, 2, 3, 4], 50) == 2
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_window_with_a_stall_and_requests_in_flight():
    t0, t1 = 10.0, 20.0
    records = [
        # finished before the window: counts nowhere
        rec(1.0, [2.0, 3.0], 2),
        # straddles the start: its tokens inside count, its first gap ends inside
        rec(8.0, [9.0, 11.0, 12.0], 3),
        # a stall of 5 s inside the window, then still in flight at t1
        rec(12.0, [12.5, 13.0, 18.0], 10),
        # submitted inside, no first token by t1: TTFT is its wait so far
        rec(19.0, [], 5),
        # submitted inside, first token after t1: also cut at t1
        rec(15.0, [21.0], 5),
    ]
    assert stats.tokens_in(records, t0, t1) == 2 + 3
    assert stats.output_tok_s(records, t0, t1) == pytest.approx(0.5)
    assert sorted(stats.ttfts(records, t0, t1)) == pytest.approx([0.5, 1.0, 5.0])
    gaps = sorted(stats.itls(records, t0, t1))
    # 9→11, 11→12, 12.5→13, 13→18 (the stall), and 18→20 open at t1
    assert gaps == pytest.approx([0.5, 1.0, 2.0, 2.0, 5.0])
    m = stats.serving_metrics(records, t0, t1)
    assert m["ttft_p95_ms"] == pytest.approx(5000.0) and m["itl_p95_ms"] == pytest.approx(5000.0)


def test_a_stall_moves_every_serving_metric():
    """8 requests stream a token every 0.1 s; a 3 s stall at 11 s delays
    every token after it, and the requests sent during it."""

    def tokens(start, stall):
        out, t = [], start
        for _ in range(20):
            t += 0.1
            if stall and out and out[-1] < 11.0 <= t:
                t += 3.0
            out.append(t)
        return out

    for stall in (False, True):
        records = [rec(10.0, tokens(10.0, stall), 20, i) for i in range(8)]
        records += [rec(11.2, tokens(14.0 if stall else 11.2, False), 20, 8 + i) for i in range(2)]
        m = stats.serving_metrics(records, 10.0, 14.5)
        if not stall:
            steady = m
    assert m["output_tok_s"] < steady["output_tok_s"]
    assert m["ttft_p95_ms"] > steady["ttft_p95_ms"] and m["itl_p95_ms"] > steady["itl_p95_ms"]


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([90.0, 100.0, 100.0, 110.0, 100.0, 100.0]) == pytest.approx(0.05)


def test_itl_reader_takes_the_end_to_end_tail_up_to_the_trace():
    """The per-layer `itl_p95_ms.serve` is the end-to-end tail over the
    window, cut where the profiler starts in a traced run."""
    import types
    from pathlib import Path

    from benchmark import spec

    read = spec.reader(Path(__file__).resolve().parents[2], "itl_p95_ms.serve")
    records = [rec(10.0, [10.5 + 0.1 * k for k in range(40)], 40, 0),  # 10.5 .. 14.4
               *[rec(10.0, [11.0, 16.0, 16.1], 3, i) for i in (1, 2, 3)]]  # 5 s gaps ending after 15
    serve = types.SimpleNamespace(records=records, t0=10.0, t1=20.0)
    untraced = types.SimpleNamespace(serve=serve, trace=None)
    assert read(untraced) == pytest.approx(stats.serving_metrics(records, 10.0, 20.0)["itl_p95_ms"])
    traced = types.SimpleNamespace(serve=serve, trace=types.SimpleNamespace(t0=15.0))
    assert read(traced) == pytest.approx(stats.percentile(stats.itls(records, 10.0, 15.0), 95) * 1e3)
    assert read(traced) < read(untraced)
    assert read(types.SimpleNamespace(serve=None, trace=None)) is None
