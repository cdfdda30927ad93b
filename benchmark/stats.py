"""Window arithmetic of the serving metrics, on the client's clock.

A client keeps one `Record` per request: when it was submitted and when
each token reached it. The end-to-end metrics read every record against
the window [t0, t1):

- output tokens per second: every token that reached a client inside the
  window, requests still in flight included, over the window's length;
- time to first token: every request submitted inside the window; one
  with no first token by t1 counts the wait it had so far;
- inter-token latency: every gap between consecutive tokens of a request
  whose later token arrived inside the window, and, for a request still
  waiting for its next token at t1, the gap open since its last token.

Percentiles are nearest-rank: the smallest value with at least p% of the
values at or below it."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class Record:
    index: int
    prompt_tokens: int
    max_new_tokens: int
    greedy: bool
    submitted: float
    prompt: list = dataclasses.field(default_factory=list)
    shared_prefix: int = -1  # the mix's document the prompt starts with, -1 for none
    arrivals: list = dataclasses.field(default_factory=list)  # client time of each token
    tokens: list = dataclasses.field(default_factory=list)
    finished: Optional[float] = None  # client time the stream said done
    error: Optional[str] = None


def percentile(values: list, p: float) -> float:
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(p / 100.0 * len(ordered)))
    return ordered[rank - 1]


def tokens_in(records: list, t0: float, t1: float) -> int:
    return sum(1 for r in records for t in r.arrivals if t0 <= t < t1)


def output_tok_s(records: list, t0: float, t1: float) -> float:
    return tokens_in(records, t0, t1) / (t1 - t0)


def ttfts(records: list, t0: float, t1: float) -> list:
    out = []
    for r in records:
        if t0 <= r.submitted < t1:
            first = r.arrivals[0] if r.arrivals and r.arrivals[0] < t1 else t1
            out.append(first - r.submitted)
    return out


def itls(records: list, t0: float, t1: float) -> list:
    out = []
    for r in records:
        seen = [t for t in r.arrivals if t < t1]
        out.extend(b - a for a, b in zip(seen, seen[1:]) if b >= t0)
        if seen and len(seen) < r.max_new_tokens and r.error is None:
            out.append(t1 - seen[-1])  # still waiting for its next token
    return out


def serving_metrics(records: list, t0: float, t1: float) -> dict:
    return {
        "output_tok_s": output_tok_s(records, t0, t1),
        "ttft_p95_ms": percentile(ttfts(records, t0, t1), 95) * 1e3,
        "itl_p95_ms": percentile(itls(records, t0, t1), 95) * 1e3,
    }


def spread(values: list) -> float:
    """Distance between the first and third quartiles over the median, as
    `statistics.quantiles(values, n=4)` gives them."""
    import statistics

    q1, q2, q3 = statistics.quantiles(values, n=4)
    if q3 == q1:
        return 0.0
    return (q3 - q1) / q2 if q2 else float("inf")
