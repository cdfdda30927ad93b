"""Process-wide metrics registry: counters, gauges, histograms.

Dependency-free. Every metric declares its label names up front and the
number of label-value combinations per metric is capped (MAX_SERIES): past
the cap, samples collapse into one ``__overflow__`` series.
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


class Counter(_Metric):
    def inc(self, value: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._series.get(tuple(str(labels[n]) for n in self.labelnames), 0.0))


class Gauge(_Metric):
    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._series.get(tuple(str(labels[n]) for n in self.labelnames), 0.0))


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.count = 0
        # bucket index (len(buckets) = +Inf) -> (trace_id, value, unix_ts)
        self.exemplars: dict[int, tuple[str, float, float]] = {}


class Histogram(_Metric):
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


REGISTRY = MetricsRegistry()
