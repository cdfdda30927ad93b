"""Embedded time-series store over the metrics registry.

`GET /metrics` renders latest-wins values with no history. This module is
the supervisor-resident history: a bounded ring-buffer store that samples
the merged registry (the plane's own families and the ones containers push
on their heartbeats) on a fixed cadence into tiered rollups. It is the JAX
package's store (modal_tpu/observability/timeseries.py), line for line in
its logic, so both answer the same windows with the same numbers.

- **Tiers**: raw (one point per sample, default 10 s cadence), 1-minute and
  10-minute rollups, each a per-series ``deque(maxlen=...)``: memory is
  bounded by tiers × series cap × point size, never by uptime (~1 h raw,
  ~6 h at 1 min, ~2 days at 10 min at the defaults).
- **Counters are stored as deltas** per interval (clamped ≥ 0): a rate over
  a window is a sum over points.
- **Histograms store bucket-count deltas** (and sum/count deltas): a
  quantile over any window merges that window's deltas, so a TTFT spike an
  hour ago cannot pollute the last minute's p95, which the burn-rate
  alerting in slo.py needs.
- **Gauges store (last, min, max)** per point; rollups merge min/max.

The store is pull-only: the supervisor's sampler calls ``sample()`` on
cadence and drives the SLO evaluator off the same tick. It is read by the
``MetricsHistory`` RPC (not journaled: history is rebuilt by sampling) and
``GET /metrics/history``.
"""


from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Iterable, Optional

from .metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from .quantile import bucket_quantile

BASE_INTERVAL_ENV = "MODAL_TPU_TS_INTERVAL"
EXTRA_FAMILIES_ENV = "MODAL_TPU_TS_FAMILIES"
DEFAULT_BASE_INTERVAL_S = 10.0

# (interval multiplier vs base, points kept). Defaults at a 10 s base:
# raw 10 s × 360 = 1 h; 1 min × 360 = 6 h; 10 min × 288 = 2 days.
TIER_SPECS: tuple[tuple[int, int], ...] = ((1, 360), (6, 360), (60, 288))

# per-family label-series cap INSIDE the store (the registry's own cap is
# 256; tracking every input_id-shaped series would multiply that by tiers) —
# past it, samples collapse into one overflow series per family
MAX_TRACKED_SERIES = 32
OVERFLOW_KEY = "__overflow__"

# families tracked by default: the SLO signals (slo.py), the dispatch floor,
# and the `top` payload (server/history.py). Extend via MODAL_TPU_TS_FAMILIES.
DEFAULT_FAMILIES: tuple[str, ...] = (
    "modal_tpu_serving_ttft_seconds",
    "modal_tpu_serving_ttft_p95_seconds",
    "modal_tpu_serving_tokens_per_second",
    "modal_tpu_serving_tokens_total",
    "modal_tpu_serving_queue_depth",
    "modal_tpu_serving_batch_occupancy",
    "modal_tpu_serving_requests_total",
    "modal_tpu_serving_preemptions_total",
    "modal_tpu_serving_stream_events_total",
    "modal_tpu_kv_pages_allocated",
    "modal_tpu_kv_pages_free",
    "modal_tpu_dispatch_latency_seconds",
    "modal_tpu_rpc_latency_seconds",
    # NOT modal_tpu_rpc_total: its (method, code) label space (60+ RPC
    # names) blows the per-family series cap — the ok-series would fill the
    # cap at boot and error series would land in __overflow__, where a
    # label_filter="error" query can't see them and many series sharing one
    # ring quietly shrink retention. Call outcomes track the bounded
    # modal_tpu_task_results_total instead.
    "modal_tpu_task_results_total",
    "modal_tpu_scheduler_queue_depth",
    "modal_tpu_input_queue_wait_seconds",
    "modal_tpu_device_memory_bytes",
    "modal_tpu_step_seconds",
)


def sampling_enabled() -> bool:
    """MODAL_TPU_TS_INTERVAL=0 (or off/false) disables the supervisor's
    sampler entirely — the store and evaluator are then never constructed."""
    return os.environ.get(BASE_INTERVAL_ENV, "").strip().lower() not in ("0", "off", "false", "no")


def base_interval_s() -> float:
    try:
        v = float(os.environ.get(BASE_INTERVAL_ENV, DEFAULT_BASE_INTERVAL_S))
        return v if v > 0 else DEFAULT_BASE_INTERVAL_S
    except ValueError:
        return DEFAULT_BASE_INTERVAL_S


def tracked_families() -> tuple[str, ...]:
    extra = tuple(
        f.strip() for f in os.environ.get(EXTRA_FAMILIES_ENV, "").split(",") if f.strip()
    )
    return DEFAULT_FAMILIES + tuple(f for f in extra if f not in DEFAULT_FAMILIES)


class _Tier:
    __slots__ = ("interval_s", "maxlen", "data", "acc", "acc_start")

    def __init__(self, interval_s: float, maxlen: int):
        self.interval_s = interval_s
        self.maxlen = maxlen
        # (family, label_key) -> deque of points (shape depends on kind)
        self.data: dict[tuple[str, str], deque] = {}
        # rollup accumulators for non-raw tiers: (family, key) -> partial
        self.acc: dict[tuple[str, str], Any] = {}
        self.acc_start: float = 0.0

    def append(self, family: str, key: str, point: tuple) -> None:
        dq = self.data.get((family, key))
        if dq is None:
            dq = self.data[(family, key)] = deque(maxlen=self.maxlen)
        dq.append(point)

    def span_s(self) -> float:
        return self.interval_s * self.maxlen


class TimeSeriesStore:
    """Tiered ring-buffer history of the tracked metric families."""

    def __init__(
        self,
        registry: MetricsRegistry = REGISTRY,
        families: Optional[Iterable[str]] = None,
        interval_s: Optional[float] = None,
        tier_specs: tuple[tuple[int, int], ...] = TIER_SPECS,
        max_series: int = MAX_TRACKED_SERIES,
    ):
        self.registry = registry
        self.families = tuple(families) if families is not None else tracked_families()
        self.interval_s = interval_s if interval_s is not None else base_interval_s()
        self.max_series = max_series
        self.tiers = [_Tier(self.interval_s * mult, maxlen) for mult, maxlen in tier_specs]
        self.created_at = time.time()
        self.samples_taken = 0
        self._lock = threading.Lock()
        # previous cumulative snapshot per family for delta computation:
        # family -> {key: value | (counts, sum, count)}
        self._prev: dict[str, dict[str, Any]] = {}
        # histogram bucket bounds per family (captured at first sample)
        self._bounds: dict[str, tuple[float, ...]] = {}
        self._kinds: dict[str, str] = {}

    # -- sampling ------------------------------------------------------------

    def _snap_family(self, name: str) -> Optional[tuple[str, dict[str, Any]]]:
        m = self.registry.get(name)
        if m is None:
            return None
        if isinstance(m, Histogram):
            self._bounds[name] = m.buckets
            with m._lock:
                return "histogram", {
                    ",".join(k): (tuple(s.counts), s.sum, s.count)
                    for k, s in m._series.items()
                }
        if isinstance(m, (Counter, Gauge)):
            kind = "counter" if isinstance(m, Counter) else "gauge"
            with m._lock:
                return kind, {",".join(k): float(v) for k, v in m._series.items()}
        return None

    def _series_key(self, family: str, key: str, seen: set) -> str:
        """Bound the store's per-family label cardinality."""
        if key in seen or len(seen) < self.max_series:
            seen.add(key)
            return key
        return OVERFLOW_KEY

    def sample(self, now: Optional[float] = None) -> int:
        """Take one sample of every tracked family; returns points appended.
        Called by the supervisor's Sampler on cadence (thread-safe)."""
        now = now if now is not None else time.time()
        appended = 0
        with self._lock:
            raw = self.tiers[0]
            for family in self.families:
                snapped = self._snap_family(family)
                if snapped is None:
                    continue
                kind, series = snapped
                self._kinds[family] = kind
                first = family not in self._prev
                prev = self._prev.get(family) or {}
                seen = {k for (f, k) in raw.data if f == family}
                for key_s, value in series.items():
                    key = self._series_key(family, key_s, seen)
                    if first and kind != "gauge":
                        # first sample is the BASELINE: pre-store cumulative
                        # history must not land in any window as a spike
                        continue
                    if kind == "gauge":
                        point = (now, value, value, value)
                    elif kind == "counter":
                        delta = max(0.0, value - float(prev.get(key_s, 0.0)))
                        point = (now, delta)
                    else:  # histogram
                        counts, hsum, hcount = value
                        pcounts, psum, pcount = prev.get(key_s) or ((), 0.0, 0)
                        if len(pcounts) != len(counts):
                            pcounts = (0,) * len(counts)
                        d_counts = tuple(max(0, c - p) for c, p in zip(counts, pcounts))
                        point = (
                            now,
                            d_counts,
                            max(0.0, hsum - psum),
                            max(0, hcount - pcount),
                        )
                    raw.append(family, key, point)
                    self._rollup(family, key, kind, point, now)
                    appended += 1
                self._prev[family] = series
            self.samples_taken += 1
        return appended

    def _rollup(self, family: str, key: str, kind: str, point: tuple, now: float) -> None:
        """Fold a raw point into each higher tier's accumulator; flush the
        accumulated point when the tier's bucket boundary passes."""
        for tier in self.tiers[1:]:
            acc_key = (family, key)
            acc = tier.acc.get(acc_key)
            if acc is None:
                acc = tier.acc[acc_key] = {"start": now, "kind": kind, "v": None}
            if kind == "gauge":
                _, last, mn, mx = point
                if acc["v"] is None:
                    acc["v"] = [last, mn, mx]
                else:
                    acc["v"][0] = last
                    acc["v"][1] = min(acc["v"][1], mn)
                    acc["v"][2] = max(acc["v"][2], mx)
            elif kind == "counter":
                acc["v"] = (acc["v"] or 0.0) + point[1]
            else:
                _, d_counts, d_sum, d_count = point
                if acc["v"] is None:
                    acc["v"] = [list(d_counts), d_sum, d_count]
                else:
                    counts = acc["v"][0]
                    if len(counts) != len(d_counts):
                        counts = acc["v"][0] = list(d_counts)
                    else:
                        for i, c in enumerate(d_counts):
                            counts[i] += c
                    acc["v"][1] += d_sum
                    acc["v"][2] += d_count
            if now - acc["start"] >= tier.interval_s:
                v = acc["v"]
                if kind == "gauge" and v is not None:
                    tier.append(family, key, (now, v[0], v[1], v[2]))
                elif kind == "counter":
                    tier.append(family, key, (now, float(v or 0.0)))
                elif v is not None:
                    tier.append(family, key, (now, tuple(v[0]), v[1], v[2]))
                tier.acc[acc_key] = {"start": now, "kind": kind, "v": None}

    # -- queries -------------------------------------------------------------

    def _pick_tier(self, window_s: float) -> _Tier:
        """Finest tier whose retention covers the window."""
        for tier in self.tiers:
            if tier.span_s() >= window_s:
                return tier
        return self.tiers[-1]

    def window_points(
        self, family: str, window_s: float, now: Optional[float] = None
    ) -> dict[str, list[tuple]]:
        now = now if now is not None else time.time()
        cutoff = now - window_s

        def _slice(tier: _Tier) -> dict[str, list[tuple]]:
            return {
                key: [p for p in dq if p[0] > cutoff]
                for (fam, key), dq in tier.data.items()
                if fam == family
            }

        with self._lock:
            out = _slice(self._pick_tier(window_s))
            if not any(out.values()):
                # the chosen rollup tier hasn't flushed its first bucket yet
                # (young store / sub-interval window): the raw tier's recent
                # points are strictly better than an empty answer
                out = _slice(self.tiers[0])
            return out

    def counter_rate(
        self, family: str, window_s: float, now: Optional[float] = None,
        label_filter: Optional[str] = None,
    ) -> Optional[float]:
        """Summed delta over the window / window seconds, across series (or
        only series whose label key contains `label_filter`). None when the
        window holds no points (no data ≠ rate 0)."""
        points = self.window_points(family, window_s, now)
        total, n = 0.0, 0
        for key, pts in points.items():
            if label_filter is not None and label_filter not in key:
                continue
            for p in pts:
                total += p[1]
                n += 1
        if n == 0:
            return None
        return total / max(1e-9, window_s)

    def counter_sum(
        self, family: str, window_s: float, now: Optional[float] = None,
        label_filter: Optional[str] = None,
    ) -> Optional[float]:
        points = self.window_points(family, window_s, now)
        total, n = 0.0, 0
        for key, pts in points.items():
            if label_filter is not None and label_filter not in key:
                continue
            for p in pts:
                total += p[1]
                n += 1
        return total if n else None

    def hist_quantile(
        self, family: str, q: float, window_s: float, now: Optional[float] = None
    ) -> Optional[float]:
        """Bucket quantile over exactly the window's observations (delta
        vectors merged across series and points). None when the window saw
        no observations — stale history can neither fire nor resolve."""
        bounds = self._bounds.get(family)
        if not bounds:
            return None
        points = self.window_points(family, window_s, now)
        merged = [0] * len(bounds)
        total = 0
        for pts in points.values():
            for _t, d_counts, _d_sum, d_count in pts:
                if len(d_counts) != len(merged):
                    continue
                for i, c in enumerate(d_counts):
                    merged[i] += c
                total += d_count
        if total == 0:
            return None
        return bucket_quantile(bounds, merged, q, total=total)

    def hist_stats(
        self, family: str, window_s: float, now: Optional[float] = None
    ) -> Optional[dict]:
        points = self.window_points(family, window_s, now)
        total_count, total_sum = 0, 0.0
        for pts in points.values():
            for _t, _d_counts, d_sum, d_count in pts:
                total_count += d_count
                total_sum += d_sum
        if total_count == 0:
            return None
        return {"count": total_count, "sum": total_sum, "mean": total_sum / total_count}

    def gauge_stats(
        self, family: str, window_s: float, now: Optional[float] = None,
        label_filter: Optional[str] = None,
    ) -> Optional[dict]:
        points = self.window_points(family, window_s, now)
        lasts, mns, mxs = [], [], []
        for key, pts in points.items():
            if label_filter is not None and label_filter not in key:
                continue
            if pts:
                lasts.append(pts[-1][1])
                mns.append(min(p[2] for p in pts))
                mxs.append(max(p[3] for p in pts))
        if not lasts:
            return None
        return {
            "last": sum(lasts),  # summed across series (e.g. per-device HBM)
            "min": min(mns),
            "max": max(mxs),
            "series": len(lasts),
        }

    # -- introspection / wire ------------------------------------------------

    def point_counts(self) -> dict[str, int]:
        with self._lock:
            return {
                f"tier{idx}": sum(len(dq) for dq in tier.data.values())
                for idx, tier in enumerate(self.tiers)
            }

    def describe(self) -> dict:
        with self._lock:
            fams: dict[str, dict] = {}
            for tier_idx, tier in enumerate(self.tiers):
                for (family, key), dq in tier.data.items():
                    f = fams.setdefault(
                        family, {"kind": self._kinds.get(family, "?"), "series": set(), "points": 0}
                    )
                    f["series"].add(key)
                    f["points"] += len(dq)
        return {
            "interval_s": self.interval_s,
            "tiers": [
                {"interval_s": t.interval_s, "maxlen": t.maxlen, "span_s": t.span_s()}
                for t in self.tiers
            ],
            "samples": self.samples_taken,
            "families": {
                name: {"kind": f["kind"], "series": sorted(f["series"]), "points": f["points"]}
                for name, f in sorted(fams.items())
            },
        }

    def series_payload(
        self, family: str, window_s: float, now: Optional[float] = None
    ) -> dict:
        """JSON-ready window dump for the MetricsHistory RPC / HTTP plane."""
        kind = self._kinds.get(family, "")
        points = self.window_points(family, window_s, now)
        out: dict = {"family": family, "kind": kind, "window_s": window_s, "series": {}}
        for key, pts in points.items():
            if kind == "gauge":
                out["series"][key] = [[round(p[0], 3), p[1], p[2], p[3]] for p in pts]
            elif kind == "counter":
                out["series"][key] = [[round(p[0], 3), p[1]] for p in pts]
            else:
                out["series"][key] = [
                    [round(p[0], 3), list(p[1]), round(p[2], 6), p[3]] for p in pts
                ]
        if kind == "histogram":
            out["bounds"] = list(self._bounds.get(family, ()))
            for q in (0.5, 0.95, 0.99):
                v = self.hist_quantile(family, q, window_s, now)
                if v is not None:
                    out[f"p{int(q * 100)}"] = v
        return out
