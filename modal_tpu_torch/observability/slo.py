"""Declarative SLO rules and multi-window burn-rate alerting.

Rules describe an objective over a signal the time-series store answers
from its windows (a histogram quantile, a counter rate, a gauge level, an
error ratio). An alert fires only when both the fast window (is it
happening now?) and the slow window (is it sustained?) burn the budget
faster than the rule's threshold, and resolves when the fast window shows
the signal back under the objective. No data in a window keeps the current
state: silence is not recovery. That is why a firing alert survives a
supervisor ``crash_restart``: the transition is journaled (record type
``alert``), replay rebuilds ``state.alerts``, and the fresh store cannot
resolve it until post-restart samples prove recovery.

Burn rate is "how many times over the objective": ``observed / threshold``
for latency rules (``op=">"``), ``threshold / observed`` for throughput
rules (``op="<"``), ``bad_fraction / allowed_fraction`` for ratios; 1.0 is
exactly on budget. The scheduler reads the serving-TTFT rule's fast burn as
an urgency signal (`scheduler._slo_desired`). This is the JAX package's
evaluator (modal_tpu/observability/slo.py), with its rules and math.

Surfaces: the alert section of ``MetricsHistory`` / ``GET
/metrics/history``, the ``modal_tpu_slo_*`` metric families, and the
journal.
"""


from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ..config import logger
from .catalog import SLO_ALERT_TRANSITIONS, SLO_ALERTS_FIRING, SLO_BURN_RATE
from .timeseries import TimeSeriesStore


@dataclass
class SLORule:
    name: str
    description: str
    family: str
    kind: str  # "hist_quantile" | "gauge" | "error_ratio"
    threshold: float
    op: str = ">"  # breach when observed OP threshold (">" above, "<" below)
    q: float = 0.95  # for hist_quantile
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    burn_threshold: float = 1.0  # burn rate both windows must exceed to fire
    resolve_burn: float = 1.0  # fast burn must drop below this to resolve
    # error_ratio only: label substring marking the "bad" sub-series
    bad_label: str = "error"
    enabled: bool = True
    extra: dict = field(default_factory=dict)


# -- default rule set ---------------------------------------------------------
#
# Thresholds are env-tunable so a deployment (or a test) can pin its own
# objectives without code. Serving rules default to generous local-CPU
# objectives; the scheduler additionally applies each function's declared
# AutoscalerSettings targets — these rules are the FLEET-level alert floor.


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def default_rules() -> list[SLORule]:
    fast = _env_f("MODAL_TPU_SLO_FAST_WINDOW_S", 60.0)
    slow = _env_f("MODAL_TPU_SLO_SLOW_WINDOW_S", 600.0)
    return [
        SLORule(
            name="serving_ttft_p95",
            description="serving p95 time-to-first-token over the window",
            family="modal_tpu_serving_ttft_seconds",
            kind="hist_quantile",
            q=0.95,
            threshold=_env_f("MODAL_TPU_SLO_TTFT_P95_S", 2.5),
            op=">",
            fast_window_s=fast,
            slow_window_s=slow,
        ),
        SLORule(
            name="serving_tokens_per_replica",
            description="fleet tokens/s per serving replica (throughput floor)",
            # a RATE over the cumulative token counter, not the tokens/s
            # gauge: a wedged engine freezes the gauge at its last healthy
            # value (gauges are latest-wins and re-sampled every tick, so
            # staleness is invisible), while the counter's zero deltas read
            # honestly as zero throughput — exactly what a floor must catch
            family="modal_tpu_serving_tokens_total",
            kind="counter_rate",
            threshold=_env_f("MODAL_TPU_SLO_TOKENS_PER_REPLICA", 0.0),  # 0 = disabled
            op="<",
            fast_window_s=fast,
            slow_window_s=slow,
            enabled=_env_f("MODAL_TPU_SLO_TOKENS_PER_REPLICA", 0.0) > 0,
        ),
        SLORule(
            name="dispatch_p50",
            description="p50 end-to-end .remote() dispatch latency",
            family="modal_tpu_dispatch_latency_seconds",
            kind="hist_quantile",
            q=0.5,
            threshold=_env_f("MODAL_TPU_SLO_DISPATCH_P50_S", 0.25),
            op=">",
            fast_window_s=fast,
            slow_window_s=slow,
        ),
        SLORule(
            name="call_error_rate",
            description="fraction of container results that are failures",
            family="modal_tpu_task_results_total",
            kind="error_ratio",
            threshold=_env_f("MODAL_TPU_SLO_CALL_ERROR_RATE", 0.05),
            op=">",
            bad_label="FAILURE",
            fast_window_s=fast,
            slow_window_s=slow,
        ),
    ]


class SLOEvaluator:
    """Evaluates rules against a TimeSeriesStore and owns the alert state
    machine. `state.alerts` (the supervisor's journal-backed dict) is the
    durable projection; this object is rebuilt fresh on every (re)boot and
    ADOPTS whatever the journal recovered."""

    def __init__(
        self,
        store: TimeSeriesStore,
        rules: Optional[list[SLORule]] = None,
        alerts: Optional[dict[str, dict]] = None,
        journal: Any = None,
    ):
        self.store = store
        self.rules = rules if rules is not None else default_rules()
        # rule name -> {"state": "firing"|"resolved", "since": ts, ...}
        self.alerts: dict[str, dict] = alerts if alerts is not None else {}
        self.journal = journal
        self.last_eval_at = 0.0

    def rule(self, name: str) -> Optional[SLORule]:
        for r in self.rules:
            if r.name == name:
                return r
        return None

    # -- signal + burn math --------------------------------------------------

    def _observe(self, rule: SLORule, window_s: float, now: float) -> Optional[float]:
        if rule.kind == "hist_quantile":
            return self.store.hist_quantile(rule.family, rule.q, window_s, now)
        if rule.kind == "counter_rate":
            # deltas/second over the window; zero deltas are real data (a
            # stalled producer IS zero throughput), absent points are not
            return self.store.counter_rate(rule.family, window_s, now)
        if rule.kind == "gauge":
            stats = self.store.gauge_stats(rule.family, window_s, now)
            return None if stats is None else float(stats["last"])
        if rule.kind == "error_ratio":
            bad = self.store.counter_sum(rule.family, window_s, now, label_filter=rule.bad_label)
            total = self.store.counter_sum(rule.family, window_s, now)
            if total is None or total <= 0:
                return None
            return (bad or 0.0) / total
        return None

    @staticmethod
    def _burn(rule: SLORule, observed: Optional[float]) -> Optional[float]:
        """Dimensionless burn rate: 1.0 = exactly on objective."""
        if observed is None or rule.threshold <= 0:
            return None
        if rule.op == "<":
            return rule.threshold / max(1e-9, observed)
        return observed / rule.threshold

    def burn_rate(self, rule_name: str, now: Optional[float] = None) -> Optional[float]:
        """The named rule's FAST-window burn rate (the scheduler's urgency
        signal); None when the window has no data or the rule is unknown."""
        rule = self.rule(rule_name)
        if rule is None or not rule.enabled:
            return None
        now = now if now is not None else time.time()
        return self._burn(rule, self._observe(rule, rule.fast_window_s, now))

    # -- the state machine ---------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> list[dict]:
        """Evaluate every rule once; journal + count transitions. Returns the
        transitions that happened this pass."""
        now = now if now is not None else time.time()
        self.last_eval_at = now
        transitions: list[dict] = []
        for rule in self.rules:
            if not rule.enabled:
                continue
            fast_obs = self._observe(rule, rule.fast_window_s, now)
            slow_obs = self._observe(rule, rule.slow_window_s, now)
            burn_fast = self._burn(rule, fast_obs)
            burn_slow = self._burn(rule, slow_obs)
            if burn_fast is not None:
                SLO_BURN_RATE.set(burn_fast, rule=rule.name, window="fast")
            if burn_slow is not None:
                SLO_BURN_RATE.set(burn_slow, rule=rule.name, window="slow")
            cur = self.alerts.get(rule.name)
            firing = cur is not None and cur.get("state") == "firing"
            if not firing:
                # FIRE: both windows over the burn threshold (fast = it is
                # happening now, slow = it is sustained, the classic
                # multi-window shape) — no data in either window holds state
                if (
                    burn_fast is not None
                    and burn_slow is not None
                    and burn_fast >= rule.burn_threshold
                    and burn_slow >= rule.burn_threshold
                ):
                    transitions.append(
                        self._transition(rule, "firing", now, fast_obs, burn_fast)
                    )
            else:
                # RESOLVE: the fast window has data and shows recovery.
                # A no-data fast window keeps firing: silence ≠ healthy.
                if burn_fast is not None and burn_fast < rule.resolve_burn:
                    transitions.append(
                        self._transition(rule, "resolved", now, fast_obs, burn_fast)
                    )
                elif burn_fast is not None:
                    cur["burn_rate"] = burn_fast
                    cur["value"] = fast_obs
            SLO_ALERTS_FIRING.set(
                1.0 if self.alerts.get(rule.name, {}).get("state") == "firing" else 0.0,
                rule=rule.name,
            )
        return transitions

    def _transition(
        self, rule: SLORule, state: str, now: float, value: Optional[float], burn: float
    ) -> dict:
        alert = {
            "rule": rule.name,
            "state": state,
            "since": now,
            "value": value,
            "burn_rate": round(burn, 3),
            "threshold": rule.threshold,
            "description": rule.description,
            "fast_window_s": rule.fast_window_s,
            "slow_window_s": rule.slow_window_s,
        }
        self.alerts[rule.name] = alert
        SLO_ALERT_TRANSITIONS.inc(rule=rule.name, transition=state)
        log = logger.warning if state == "firing" else logger.info
        log(
            f"SLO alert {rule.name} {state}: {rule.description} "
            f"(value={value}, burn={burn:.2f}x, threshold={rule.threshold})"
        )
        if self.journal is not None:
            try:
                self.journal.append("alert", **alert)
            except Exception:  # noqa: BLE001 — alerting must not kill sampling
                logger.exception("alert journal append failed")
        return alert

    # -- wire ----------------------------------------------------------------

    def payload(self, now: Optional[float] = None) -> dict:
        """JSON-ready alert + burn-rate view for the CLI / history plane."""
        now = now if now is not None else time.time()
        rules_out = []
        for rule in self.rules:
            if not rule.enabled:
                continue
            fast_obs = self._observe(rule, rule.fast_window_s, now)
            slow_obs = self._observe(rule, rule.slow_window_s, now)
            rules_out.append(
                {
                    "rule": rule.name,
                    "description": rule.description,
                    "threshold": rule.threshold,
                    "op": rule.op,
                    "fast_window_s": rule.fast_window_s,
                    "slow_window_s": rule.slow_window_s,
                    "fast_value": fast_obs,
                    "slow_value": slow_obs,
                    "fast_burn": self._burn(rule, fast_obs),
                    "slow_burn": self._burn(rule, slow_obs),
                    "state": self.alerts.get(rule.name, {}).get("state", "ok"),
                    "since": self.alerts.get(rule.name, {}).get("since"),
                }
            )
        return {
            "time": now,
            "last_eval_at": self.last_eval_at,
            "rules": rules_out,
            "alerts": {name: dict(a) for name, a in self.alerts.items()},
        }
