"""The director's metrics federation and the fleet's SLO evaluation (port of
modal_tpu/observability/federation.py).

Each shard of the sharded control plane (server/shards.py) samples its own
registry into its own TimeSeriesStore and answers its own ``GET
/metrics/history``; a fleet question ("is the fleet burning its TTFT
budget?") needs the merged view. ``FederatedHistory`` fans one ``snapshot``
query out to every live shard's history endpoint (the topology from
``shards.json``, each endpoint from the ``observability/shards/shard-<i>``
breadcrumb its blob server writes) and answers the
``describe|series|quantile|alerts|top`` contract of server/history.py over
the merged series:

- delta-counter and histogram-bucket points merge by summation: each
  shard's series lands under a ``shard<i>|<labels>`` key, and the store's
  window-pooling math does the rest;
- gauges stay per shard under the ``shard<i>|`` prefix (gauge_stats sums
  ``last`` across series, e.g. the fleet's queue depth);
- every answer carries a ``federation`` block naming the shards that
  answered and those that did not: a dead or slow shard makes the answer a
  labeled partial, never a silent truncation.

The fleet's SLO: slo.py's multi-window burn-rate evaluator runs at the
director over the merged series, so a fleet-wide violation fires when no
single shard crosses its threshold. Transitions append to
``observability/fleet_alerts.jsonl`` and are replayed at construction, so a
firing fleet alert survives a director restart and a takeover.

MODAL_TPU_FEDERATION turns it off (default on, sharded plane only);
MODAL_TPU_FEDERATION_TIMEOUT bounds a shard's answer (default 2.0 s).

A shard's answer is fetched with urllib on a worker thread, and the
director's HTTP surface (`FederationServer`) lives with the director in
server/shards.py: the observability modules import no network package
(ROADMAP Queue C 46).
"""

from __future__ import annotations

import asyncio
import json
import os
import time
import urllib.parse
import urllib.request
from typing import Any, Callable, Optional

from .catalog import FEDERATION_PARTIAL_ANSWERS, FEDERATION_QUERY_SECONDS
from .quantile import bucket_quantile
from .slo import SLOEvaluator, default_rules
from . import tracing

ENABLE_ENV = "MODAL_TPU_FEDERATION"
TIMEOUT_ENV = "MODAL_TPU_FEDERATION_TIMEOUT"
DEFAULT_TIMEOUT_S = 2.0
FAST_WINDOW_S = 60.0
SLOW_WINDOW_S = 600.0


def enabled() -> bool:
    return os.environ.get(ENABLE_ENV, "1").strip().lower() not in ("0", "off", "false", "no")


def fanout_timeout_s() -> float:
    try:
        v = float(os.environ.get(TIMEOUT_ENV, str(DEFAULT_TIMEOUT_S)))
        return v if v > 0 else DEFAULT_TIMEOUT_S
    except ValueError:
        return DEFAULT_TIMEOUT_S


class MergedSnapshot:
    """TimeSeriesStore-query-API adapter over already-fetched per-shard
    ``snapshot`` payloads. Series keys are namespaced ``shard<i>|<labels>``
    so the store's window-pooling query math (counter_rate/hist_quantile/
    gauge_stats sum across series with no timestamp alignment) merges the
    fleet correctly with no new math. slo.SLOEvaluator runs against this
    unchanged — it only touches the query surface."""

    def __init__(
        self,
        snapshots: dict[int, Optional[dict]],
        series_shards: Optional[set[int]] = None,
    ):
        self.snapshots = {i: s for i, s in snapshots.items() if s is not None}
        # in-process shard fleets share one registry, so every shard's store
        # holds the same (process-wide) series: summing would N-count. The
        # caller restricts which shards contribute SERIES; replicas/alerts
        # still merge from all.
        self.series_shards = (
            set(series_shards) if series_shards is not None else set(self.snapshots)
        )
        fams: dict[str, dict[str, list]] = {}
        self._kinds: dict[str, str] = {}
        self._bounds: dict[str, tuple[float, ...]] = {}
        for idx in sorted(self.snapshots):
            if idx not in self.series_shards:
                continue
            for family, fp in (self.snapshots[idx].get("families") or {}).items():
                if not isinstance(fp, dict):
                    continue
                if fp.get("kind"):
                    self._kinds.setdefault(family, fp["kind"])
                if fp.get("bounds"):
                    self._bounds.setdefault(family, tuple(fp["bounds"]))
                dst = fams.setdefault(family, {})
                for key, pts in (fp.get("series") or {}).items():
                    dst[f"shard{idx}|{key}"] = pts
        self._families = fams
        self.families = tuple(sorted(fams))

    # -- the store query surface --------------------------------------------

    def window_points(
        self, family: str, window_s: float, now: Optional[float] = None
    ) -> dict[str, list]:
        now = now if now is not None else time.time()
        cutoff = now - window_s
        return {
            key: [p for p in pts if p[0] > cutoff]
            for key, pts in self._families.get(family, {}).items()
        }

    def counter_rate(
        self, family: str, window_s: float, now: Optional[float] = None,
        label_filter: Optional[str] = None,
    ) -> Optional[float]:
        total = self.counter_sum(family, window_s, now, label_filter)
        if total is None:
            return None
        return total / max(1e-9, window_s)

    def counter_sum(
        self, family: str, window_s: float, now: Optional[float] = None,
        label_filter: Optional[str] = None,
    ) -> Optional[float]:
        total, n = 0.0, 0
        for key, pts in self.window_points(family, window_s, now).items():
            if label_filter is not None and label_filter not in key:
                continue
            for p in pts:
                total += p[1]
                n += 1
        return total if n else None

    def hist_quantile(
        self, family: str, q: float, window_s: float, now: Optional[float] = None
    ) -> Optional[float]:
        bounds = self._bounds.get(family)
        if not bounds:
            return None
        merged = [0] * len(bounds)
        total = 0
        for pts in self.window_points(family, window_s, now).values():
            for _t, d_counts, _d_sum, d_count in pts:
                if len(d_counts) != len(merged):
                    continue  # a shard on a different bucket layout
                for i, c in enumerate(d_counts):
                    merged[i] += c
                total += d_count
        if total == 0:
            return None
        return bucket_quantile(bounds, merged, q, total=total)

    def hist_stats(
        self, family: str, window_s: float, now: Optional[float] = None
    ) -> Optional[dict]:
        total_count, total_sum = 0, 0.0
        for pts in self.window_points(family, window_s, now).values():
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
        lasts, mns, mxs = [], [], []
        for key, pts in self.window_points(family, window_s, now).items():
            if label_filter is not None and label_filter not in key:
                continue
            if pts:
                lasts.append(pts[-1][1])
                mns.append(min(p[2] for p in pts))
                mxs.append(max(p[3] for p in pts))
        if not lasts:
            return None
        return {"last": sum(lasts), "min": min(mns), "max": max(mxs), "series": len(lasts)}

    def describe(self) -> dict:
        return {
            "federated": True,
            "shards": sorted(self.snapshots),
            "series_shards": sorted(self.series_shards & set(self.snapshots)),
            "families": {
                family: {
                    "kind": self._kinds.get(family, "?"),
                    "series": sorted(series),
                    "points": sum(len(pts) for pts in series.values()),
                }
                for family, series in sorted(self._families.items())
            },
        }

    def series_payload(
        self, family: str, window_s: float, now: Optional[float] = None
    ) -> dict:
        kind = self._kinds.get(family, "")
        out: dict = {
            "family": family,
            "kind": kind,
            "window_s": window_s,
            "series": self.window_points(family, window_s, now),
        }
        if kind == "histogram":
            out["bounds"] = list(self._bounds.get(family, ()))
            for q in (0.5, 0.95, 0.99):
                v = self.hist_quantile(family, q, window_s, now)
                if v is not None:
                    out[f"p{int(q * 100)}"] = v
        return out

    def replica_rows(self) -> list[dict]:
        rows = []
        for idx in sorted(self.snapshots):
            for row in self.snapshots[idx].get("replicas") or []:
                rows.append(dict(row, shard=idx))
        return rows


class FleetAlertJournal:
    """Append-only JSONL journal for fleet-scope alert transitions, with the
    same ``append(type, **payload)`` surface slo.SLOEvaluator expects of the
    supervisor journal. Replay projects the last state per rule, so a firing
    fleet alert survives director restart and shard takeover."""

    def __init__(self, path: str):
        self.path = path
        self.seq = 0

    def append(self, t: str, **payload: Any) -> int:
        self.seq += 1
        rec = dict(payload)
        rec["seq"] = self.seq
        rec["type"] = t
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        return self.seq

    def replay(self) -> dict[str, dict]:
        alerts: dict[str, dict] = {}
        try:
            with open(self.path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    self.seq = max(self.seq, int(rec.get("seq") or 0))
                    if rec.get("type") != "alert" or not rec.get("rule"):
                        continue
                    alerts[rec["rule"]] = {
                        k: v for k, v in rec.items() if k not in ("seq", "type")
                    }
        except OSError:
            pass
        return alerts


class FederatedHistory:
    """Fan-out + merge engine answering the /metrics/history contract for
    the whole fleet. `fetch(shard, query, window_s)` is injectable for tests
    and benches; the default does one HTTP GET per live shard (off-loop)."""

    def __init__(
        self,
        state_dir: str,
        *,
        topology: Optional[Callable[[], list[dict]]] = None,
        fetch: Optional[Callable] = None,
        timeout_s: Optional[float] = None,
        shared_registry: bool = False,
        rules: Optional[list] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.state_dir = state_dir
        self._topology_fn = topology
        self._fetch = fetch or self._http_fetch
        self.timeout_s = timeout_s if timeout_s is not None else fanout_timeout_s()
        self.shared_registry = shared_registry
        self.clock = clock
        self.journal = FleetAlertJournal(
            os.path.join(state_dir, "observability", "fleet_alerts.jsonl")
        )
        self.alerts = self.journal.replay()
        self.evaluator = SLOEvaluator(
            store=MergedSnapshot({}),
            rules=rules if rules is not None else default_rules(),
            alerts=self.alerts,
            journal=self.journal,
        )

    # -- topology + transport ------------------------------------------------

    def topology(self) -> list[dict]:
        if self._topology_fn is not None:
            return list(self._topology_fn())
        try:
            with open(os.path.join(self.state_dir, "shards.json")) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return []
        return list(data.get("shards") or [])

    def shard_metrics_base(self, shard: dict) -> Optional[str]:
        """Base URL from the shard's discovery breadcrumb (blob_server.py
        writes observability/shards/shard-<i> under the fleet root)."""
        crumb = os.path.join(
            self.state_dir, "observability", "shards", f"shard-{shard.get('index')}"
        )
        try:
            with open(crumb) as f:
                url = f.read().strip()
        except OSError:
            return None
        return url[: -len("/metrics")] if url.endswith("/metrics") else url

    async def _http_fetch(self, shard: dict, query: str, window_s: float) -> dict:
        base = self.shard_metrics_base(shard)
        if not base:
            raise RuntimeError(f"no metrics breadcrumb for shard {shard.get('index')}")
        qs = urllib.parse.urlencode({"query": query, "window_s": window_s})
        url = f"{base}/metrics/history?{qs}"
        timeout = self.timeout_s

        def _get() -> dict:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                return json.loads(resp.read().decode("utf-8"))

        return await asyncio.to_thread(_get)

    async def _gather(
        self, window_s: float
    ) -> tuple[dict[int, dict], list[int], list[int]]:
        """(answered snapshots, missing-but-live shard indexes, dead ones)."""
        shards = self.topology()
        dead = sorted(int(s.get("index", -1)) for s in shards if s.get("dead"))
        live = [s for s in shards if not s.get("dead")]

        async def one(sh: dict) -> tuple[int, Optional[dict]]:
            idx = int(sh.get("index", -1))
            try:
                payload = await asyncio.wait_for(
                    self._fetch(sh, "snapshot", window_s), self.timeout_s + 0.5
                )
                return idx, payload if isinstance(payload, dict) else None
            except Exception:
                return idx, None

        results = await asyncio.gather(*(one(s) for s in live)) if live else []
        snaps = {idx: p for idx, p in results if p is not None}
        missing = sorted(idx for idx, p in results if p is None)
        return snaps, missing, dead

    def merged(self, snaps: dict[int, dict]) -> MergedSnapshot:
        series_shards = {min(snaps)} if (self.shared_registry and snaps) else None
        return MergedSnapshot(snaps, series_shards=series_shards)

    def _fed_meta(self, snaps: dict, missing: list[int], dead: list[int]) -> dict:
        return {
            "shards": sorted(snaps),
            "missing": missing,
            "dead": dead,
            "partial": bool(missing or dead),
            "mode": "shared-registry" if self.shared_registry else "fanout",
            "timeout_s": self.timeout_s,
        }

    def _alert_window(self) -> float:
        return max(
            [r.slow_window_s for r in self.evaluator.rules if r.enabled] or [SLOW_WINDOW_S]
        )

    # -- the query surface ---------------------------------------------------

    async def payload(
        self, query: str, family: str = "", window_s: float = 0.0, q: float = 0.0
    ) -> dict:
        """Answer one federated history query; same contract as
        server/history.py's history_payload, plus the `federation` block."""
        query = query or "describe"
        t0 = self.clock()
        with tracing.span("federation.query", attrs={"query": query}):
            out = await self._payload_inner(query, family, window_s, q)
        FEDERATION_QUERY_SECONDS.observe(max(0.0, self.clock() - t0), query=query)
        if isinstance(out, dict) and (out.get("federation") or {}).get("partial"):
            FEDERATION_PARTIAL_ANSWERS.inc()
        return out

    async def _payload_inner(
        self, query: str, family: str, window_s: float, q: float
    ) -> dict:
        gather_window = self._alert_window() if query in ("alerts", "top") else max(
            window_s or FAST_WINDOW_S, SLOW_WINDOW_S
        )
        snaps, missing, dead = await self._gather(gather_window)
        meta = self._fed_meta(snaps, missing, dead)
        merged = self.merged(snaps)
        if query == "describe":
            out = merged.describe()
            out["federation"] = meta
            return out
        if query == "series":
            out = merged.series_payload(family, window_s or FAST_WINDOW_S)
            out["federation"] = meta
            return out
        if query == "quantile":
            return {
                "family": family,
                "q": q or 0.5,
                "window_s": window_s or FAST_WINDOW_S,
                "value": merged.hist_quantile(family, q or 0.5, window_s or FAST_WINDOW_S),
                "federation": meta,
            }
        if query == "alerts":
            self.evaluator.store = merged
            out = self.evaluator.payload()
            shard_alerts: dict[str, dict] = {}
            for idx in sorted(snaps):
                per_shard = (snaps[idx].get("alerts") or {}).get("alerts") or {}
                for rule, alert in per_shard.items():
                    shard_alerts[f"shard{idx}/{rule}"] = alert
            out["shard_alerts"] = shard_alerts
            out["federation"] = meta
            return out
        if query == "top":
            return self._top_payload(snaps, missing, dead, merged, meta)
        if query == "snapshot":
            w = window_s or SLOW_WINDOW_S
            return {
                "time": self.clock(),
                "window_s": w,
                "families": {f: merged.series_payload(f, w) for f in merged.families},
                "federation": meta,
            }
        return {"error": f"unknown history query {query!r}", "federation": meta}

    def _top_payload(
        self,
        snaps: dict[int, dict],
        missing: list[int],
        dead: list[int],
        merged: MergedSnapshot,
        meta: dict,
    ) -> dict:
        from ..server.history import fleet_summary  # late: server -> observability cycle

        fleet, sparkline = fleet_summary(merged)
        self.evaluator.store = merged
        alerts = self.evaluator.payload()
        w = FAST_WINDOW_S
        shard_rows: list[dict] = []
        for idx in sorted(snaps):
            single = MergedSnapshot({idx: snaps[idx]})
            shard_rows.append(
                {
                    "shard": idx,
                    "state": "live",
                    "calls_per_s": single.counter_rate("modal_tpu_task_results_total", w),
                    "requests_per_s": single.counter_rate(
                        "modal_tpu_serving_requests_total", w
                    ),
                    "ttft_p95_s": single.hist_quantile(
                        "modal_tpu_serving_ttft_seconds", 0.95, w
                    ),
                    "tokens_per_s": (
                        single.gauge_stats("modal_tpu_serving_tokens_per_second", w) or {}
                    ).get("last"),
                    "queue_depth": (
                        single.gauge_stats("modal_tpu_scheduler_queue_depth", w) or {}
                    ).get("last"),
                    "replicas": len(snaps[idx].get("replicas") or []),
                }
            )
        for idx in missing:
            shard_rows.append({"shard": idx, "state": "missing"})
        for idx in dead:
            shard_rows.append({"shard": idx, "state": "dead"})
        return {
            "time": self.clock(),
            "store": merged.describe(),
            "fleet": fleet,
            "tokens_sparkline": sparkline,
            "replicas": merged.replica_rows(),
            "alerts": alerts,
            "shards": sorted(shard_rows, key=lambda r: r["shard"]),
            "federation": meta,
        }

    # -- fleet-scope SLO loop ------------------------------------------------

    async def evaluate_fleet(self) -> list[dict]:
        """One fleet evaluation pass over the merged series; returns the
        alert transitions (the director dumps a postmortem on each firing)."""
        snaps, _missing, _dead = await self._gather(self._alert_window())
        if not snaps:
            return []
        self.evaluator.store = self.merged(snaps)
        return self.evaluator.evaluate()
