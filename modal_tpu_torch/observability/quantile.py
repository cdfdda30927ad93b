"""The one quantile contract of the port's metrics: nearest rank over raw
samples, and the bucket quantile of histograms.

Both are the JAX package's (modal_tpu/observability/quantile.py), so a p50
read from the registry, the time-series store or a bench table means the
same thing in either package.

- ``quantile(sorted_vals, q)``: nearest rank over raw samples. The input
  must already be sorted.
- ``bucket_quantile(bounds, counts, q)``: the quantile of per-bucket (not
  cumulative) counts; the upper bound of the bucket the q-th observation
  lands in, as Prometheus' `histogram_quantile` answers at bucket
  resolution. The registry's histograms and the store's windowed
  quantiles use it.
"""

from __future__ import annotations

from typing import Optional, Sequence


def quantile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank quantile of an already sorted sample list; 0.0 when
    empty."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def bucket_quantile(
    bounds: Sequence[float], counts: Sequence[int], q: float, total: Optional[int] = None
) -> Optional[float]:
    """Quantile from per-bucket (NON-cumulative) counts against `bounds`
    (ascending upper bounds). `total` is the observation count INCLUDING any
    +Inf-bucket overflow not present in `counts` (defaults to sum(counts));
    a quantile landing past the last finite bound collapses to it, as the
    registry's `Histogram.quantile` always did. None when empty."""
    if total is None:
        total = int(sum(counts))
    if total <= 0 or not bounds:
        return None
    target = q * total
    seen = 0.0
    for i, c in enumerate(counts):
        seen += c
        if seen >= target:
            return bounds[min(i, len(bounds) - 1)]
    return bounds[-1]
