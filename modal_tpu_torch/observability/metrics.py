"""Process-wide metrics registry: counters, gauges, histograms.

Dependency-free. Every metric declares its label names up front and the
number of label-value combinations per metric is capped (MAX_SERIES): past
the cap, samples collapse into one ``__overflow__`` series.

`render_prometheus` / `render_openmetrics` are the text expositions the
plane's blob server answers ``GET /metrics`` with (histogram buckets carry
their latest trace-id exemplar in the OpenMetrics flavor); both are
byte-equal to the JAX package's for the same families and observations.

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

    def _fmt_labels(self, key: tuple[str, ...], extra: str = "") -> str:
        parts = [f'{n}="{_escape(v)}"' for n, v in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self) -> list[str]:
        raise NotImplementedError

    def snapshot(self) -> dict:
        raise NotImplementedError


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    # HELP text escapes backslash and newline only (quotes are legal there)
    return v.replace("\\", "\\\\").replace("\n", "\\n")


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

    def render(self) -> list[str]:
        with self._lock:
            return [
                f"{self.name}{self._fmt_labels(key)} {value}"
                for key, value in sorted(self._series.items())
            ]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, value: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._series.get(tuple(str(labels[n]) for n in self.labelnames), 0.0))

    total = Counter.total
    snapshot = Counter.snapshot
    render = Counter.render


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
        """Bucket quantile across all series (quantile.bucket_quantile)."""
        from .quantile import bucket_quantile

        with self._lock:
            total = sum(s.count for s in self._series.values())
            merged = [0] * len(self.buckets)
            for s in self._series.values():
                for i, c in enumerate(s.counts):
                    merged[i] += c
        return bucket_quantile(self.buckets, merged, q, total=total)

    def render(self, exemplars: bool = False) -> list[str]:
        """Exposition lines; with ``exemplars=True`` bucket samples carry the
        OpenMetrics exemplar suffix (`... # {trace_id="…"} value timestamp`)."""
        lines = []
        with self._lock:
            for key, series in sorted(self._series.items()):
                cumulative = 0
                for i, (bound, c) in enumerate(zip(self.buckets, series.counts)):
                    cumulative += c
                    le = 'le="%s"' % bound
                    line = f"{self.name}_bucket{self._fmt_labels(key, le)} {cumulative}"
                    lines.append(line + self._exemplar_suffix(series, i, exemplars))
                inf = 'le="+Inf"'
                line = f"{self.name}_bucket{self._fmt_labels(key, inf)} {series.count}"
                lines.append(line + self._exemplar_suffix(series, len(self.buckets), exemplars))
                lines.append(f"{self.name}_sum{self._fmt_labels(key)} {round(series.sum, 6)}")
                lines.append(f"{self.name}_count{self._fmt_labels(key)} {series.count}")
        return lines

    @staticmethod
    def _exemplar_suffix(series: _HistSeries, idx: int, enabled: bool) -> str:
        if not enabled:
            return ""
        ex = series.exemplars.get(idx)
        if ex is None:
            return ""
        trace_id, value, ts = ex
        return f' # {{trace_id="{_escape(trace_id)}"}} {round(value, 9)} {round(ts, 3)}'

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
        self.started_at = time.time()

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

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Zero every series (tests); families stay registered."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.clear()

    def render_prometheus(self) -> str:
        """The Prometheus text exposition: every registered family renders
        its HELP/TYPE header even before its first sample."""
        with self._lock:
            metrics = [self._metrics[name] for name in sorted(self._metrics)]
        out: list[str] = []
        for m in metrics:
            out.append(f"# HELP {m.name} {_escape_help(m.help)}")
            out.append(f"# TYPE {m.name} {m.kind}")
            out.extend(m.render())
        return "\n".join(out) + "\n"

    def render_openmetrics(self) -> str:
        """The OpenMetrics exposition: the same families, histogram buckets
        with their exemplars, counter families named without `_total` (their
        samples keep it, as a strict OpenMetrics parser requires), and the
        body closed by `# EOF`."""
        with self._lock:
            metrics = [self._metrics[name] for name in sorted(self._metrics)]
        out: list[str] = []
        for m in metrics:
            family = m.name
            if m.kind == "counter" and family.endswith("_total"):
                family = family[: -len("_total")]
            out.append(f"# HELP {family} {_escape_help(m.help)}")
            out.append(f"# TYPE {family} {m.kind}")
            if isinstance(m, Histogram):
                out.extend(m.render(exemplars=True))
            else:
                out.extend(m.render())
        out.append("# EOF")
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        with self._lock:
            metrics = dict(self._metrics)
        return {
            name: {"type": m.kind, "help": m.help, "series": m.snapshot()}
            for name, m in sorted(metrics.items())
        }

    def bench_summary(self) -> dict:
        """Compact roll-up of the registry for a bench's one-line result."""
        summary: dict = {}

        def _tot(name: str, key: str) -> None:
            m = self.get(name)
            if isinstance(m, (Counter, Gauge)) and m.total():
                summary[key] = round(m.total(), 2)

        lat = self.get("modal_tpu_rpc_latency_seconds")
        if isinstance(lat, Histogram) and lat.count_total():
            summary["rpc_count"] = lat.count_total()
            summary["rpc_latency_p50_s"] = lat.quantile(0.5)
            summary["rpc_latency_p99_s"] = lat.quantile(0.99)
        disp = self.get("modal_tpu_dispatch_latency_seconds")
        if isinstance(disp, Histogram) and disp.count_total():
            summary["dispatch_count"] = disp.count_total()
            summary["dispatch_latency_p50_s"] = disp.quantile(0.5)
        steps = self.get("modal_tpu_step_seconds")
        if isinstance(steps, Histogram) and steps.count_total():
            summary["step_p50_s"] = steps.quantile(0.5)
        _tot("modal_tpu_compile_events_total", "compile_events")
        _tot("modal_tpu_scheduler_tasks_launched_total", "tasks_launched")
        _tot("modal_tpu_blob_bytes_total", "blob_bytes")
        _tot("modal_tpu_client_rpc_retries_total", "client_rpc_retries")
        _tot("modal_tpu_chaos_injections_total", "chaos_injections")
        _tot("modal_tpu_worker_preemptions_total", "worker_preemptions")
        _tot("modal_tpu_serialized_bytes_total", "serialized_bytes")
        _tot("modal_tpu_dataplane_copy_bytes_total", "dataplane_copy_bytes")
        _tot("modal_tpu_blob_spills_total", "blob_spills")
        _tot("modal_tpu_weights_loaded_bytes_total", "weights_loaded_bytes")
        gbps = self.get("modal_tpu_weights_load_gbps")
        if isinstance(gbps, Gauge):
            v = gbps.value()
            if v:
                summary["weights_load_gbps"] = round(v, 3)
        return summary


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
