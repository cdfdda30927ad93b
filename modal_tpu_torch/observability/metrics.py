"""Process-wide metrics registry: counters, gauges, histograms.

Dependency-free. Every metric declares its label names up front and the
number of label-value combinations per metric is capped (MAX_SERIES): past
the cap, samples collapse into one ``__overflow__`` series.

`export_families` / `merge_families` are the cross-process push of the JAX
package's metrics.py (:405-458), in its JSON shape: a container exports the
families it pushes, the control plane merges them (gauges latest-wins,
counters and histogram buckets by delta against the previous push), so
either package's worker merges either package's report.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Optional

MAX_SERIES = 256
OVERFLOW = "__overflow__"

DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._lock = threading.Lock()
        self._series: dict[tuple[str, ...], object] = {}

    def _key(self, labels: dict) -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} expects labels {self.labelnames}, got {sorted(labels)}"
            )
        key = tuple(str(labels[n]) for n in self.labelnames)
        if key not in self._series and len(self._series) >= MAX_SERIES:
            return tuple(OVERFLOW for _ in self.labelnames)
        return key

    def clear(self) -> None:
        with self._lock:
            self._series.clear()


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._series.get(tuple(str(labels[n]) for n in self.labelnames), 0.0))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._series.values()))

    def snapshot(self) -> dict:
        with self._lock:
            return {",".join(k) if k else "": v for k, v in self._series.items()}


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._series.get(tuple(str(labels[n]) for n in self.labelnames), 0.0))

    total = Counter.total
    snapshot = Counter.snapshot


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.count = 0
        # bucket index (len(buckets) = +Inf) -> (trace_id, value, unix_ts)
        self.exemplars: dict[int, tuple[str, float, float]] = {}


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: tuple[str, ...],
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))

    def observe(self, value: float, exemplar: Optional[str] = None, **labels: str) -> None:
        """Record one observation; `exemplar` (a trace id) is kept per bucket."""
        key = self._key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistSeries(len(self.buckets))
            idx = len(self.buckets)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    series.counts[i] += 1
                    idx = i
                    break
            series.sum += value
            series.count += 1
            if exemplar:
                series.exemplars[idx] = (str(exemplar), float(value), time.time())

    def totals(self, **labels: str) -> tuple[float, int]:
        """(sum, count) of the observations in one series; (0.0, 0) if none."""
        with self._lock:
            series = self._series.get(tuple(str(labels[n]) for n in self.labelnames))
            return (series.sum, series.count) if series is not None else (0.0, 0)

    def count_total(self) -> int:
        with self._lock:
            return sum(s.count for s in self._series.values())

    def quantile(self, q: float) -> Optional[float]:
        """Bucket quantile across all series: the upper bound of the bucket
        the q-th observation lands in (the last finite bound past it), None
        when empty; modal_tpu/observability/quantile.py's contract."""
        with self._lock:
            total = sum(s.count for s in self._series.values())
            merged = [0] * len(self.buckets)
            for s in self._series.values():
                for i, c in enumerate(s.counts):
                    merged[i] += c
        if total <= 0:
            return None
        seen = 0
        for i, c in enumerate(merged):
            seen += c
            if seen >= q * total:
                return self.buckets[i]
        return self.buckets[-1]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                ",".join(k) if k else "": {"count": s.count, "sum": round(s.sum, 6)}
                for k, s in self._series.items()
            }

    def _merge_series(self, key: tuple[str, ...], state: dict, prev_state: Optional[dict]) -> None:
        """Apply a pushed series' delta against its previous push. Bucket
        lists of another length are dropped: the pusher used other bounds."""
        counts = state.get("counts")
        if not isinstance(counts, list) or len(counts) != len(self.buckets):
            return
        prev_counts = (prev_state or {}).get("counts") or [0] * len(self.buckets)
        if len(prev_counts) != len(self.buckets):
            prev_counts = [0] * len(self.buckets)
        d_count = int(state.get("count", 0)) - int((prev_state or {}).get("count", 0))
        d_sum = float(state.get("sum", 0.0)) - float((prev_state or {}).get("sum", 0.0))
        if d_count <= 0:
            return
        with self._lock:
            series = self._series.get(key)
            if series is None:
                if len(self._series) >= MAX_SERIES:
                    key = tuple(OVERFLOW for _ in self.labelnames)
                series = self._series.setdefault(key, _HistSeries(len(self.buckets)))
            for i, (c, p) in enumerate(zip(counts, prev_counts)):
                delta = int(c) - int(p)
                if delta > 0:
                    series.counts[i] += delta
            series.count += d_count
            series.sum += d_sum


class MetricsRegistry:
    """Homes every metric family; definition is idempotent by name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _define(self, cls, name: str, help: str, labelnames: tuple[str, ...], **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(labelnames):
                    raise ValueError(f"metric {name} redefined with a different shape")
                return existing
            metric = cls(name, help, tuple(labelnames), **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labelnames: tuple[str, ...] = ()) -> Counter:
        return self._define(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: tuple[str, ...] = ()) -> Gauge:
        return self._define(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: tuple[str, ...] = (),
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._define(Histogram, name, help, labelnames, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)


REGISTRY = MetricsRegistry()


def export_families(names: Iterable[str], registry: MetricsRegistry = REGISTRY) -> dict:
    """JSON-ready snapshot of the named families (full bucket state for
    histograms, so quantiles survive the merge); unregistered or empty
    families are left out."""
    out: dict = {}
    for name in names:
        m = registry.get(name)
        if m is None:
            continue
        if isinstance(m, Histogram):
            with m._lock:
                series = {
                    ",".join(k): {"counts": list(s.counts), "sum": s.sum, "count": s.count}
                    for k, s in m._series.items()
                }
            if series:
                out[name] = {"kind": "histogram", "series": series}
        elif isinstance(m, (Counter, Gauge)):
            series = m.snapshot()
            if series:
                out[name] = {"kind": m.kind, "series": series}
    return out


def merge_families(report: dict, prev: Optional[dict] = None, registry: MetricsRegistry = REGISTRY) -> None:
    """Merge one pushed report into `registry`. `prev` is the same source's
    previous report (for counter and histogram deltas); malformed entries
    are skipped, so a telemetry bug never breaks the heartbeat path."""
    prev = prev or {}
    for name, family in (report or {}).items():
        m = registry.get(name)
        if m is None or not isinstance(family, dict):
            continue
        series = family.get("series")
        if family.get("kind") != m.kind or not isinstance(series, dict):
            continue
        prev_series = (prev.get(name) or {}).get("series") or {}
        for key_s, value in series.items():
            key = tuple(str(key_s).split(",")) if key_s else ()
            if len(key) != len(m.labelnames):
                continue
            try:
                if isinstance(m, Gauge):
                    m.set(float(value), **dict(zip(m.labelnames, key)))
                elif isinstance(m, Counter):
                    delta = float(value) - float(prev_series.get(key_s, 0.0))
                    if delta > 0:
                        m.inc(delta, **dict(zip(m.labelnames, key)))
                elif isinstance(m, Histogram):
                    m._merge_series(key, value, prev_series.get(key_s))
            except (TypeError, ValueError, AttributeError):
                continue
