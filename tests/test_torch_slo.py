"""The port's time-series store, SLO evaluator and SLO autoscaler against the
JAX package's (modal_tpu/observability/timeseries.py, slo.py and
modal_tpu/server/scheduler.py `_slo_desired`), after the JAX package's
tests/test_slo.py.

Each scenario runs once per package on the same inputs, with injected
`now`s, and returns what it observed; the port's answers equal the JAX
package's (window rates, quantiles, gauge min/max to 1e-9; transitions,
journaled alerts and scheduler decisions exactly), and the JAX test's own
expectations hold on the port's answers."""

import importlib
import json
import math
import types

import numpy as np
import pytest

PKGS = ("modal_tpu", "modal_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _registry(pkg: str):
    """A private registry carrying the families the store and rules read."""
    reg = _mod(pkg, "observability.metrics").MetricsRegistry()
    reg.histogram("modal_tpu_serving_ttft_seconds", "ttft", buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0))
    reg.histogram("modal_tpu_dispatch_latency_seconds", "disp", buckets=(0.01, 0.1, 1.0))
    reg.counter("modal_tpu_task_results_total", "results", ("status",))
    reg.counter("modal_tpu_serving_tokens_total", "tok")
    reg.gauge("modal_tpu_serving_tokens_per_second", "tps")
    reg.gauge("modal_tpu_serving_queue_depth", "queue")
    return reg


def _store(pkg: str, reg, interval_s: float = 0.05):
    return _mod(pkg, "observability.timeseries").TimeSeriesStore(registry=reg, interval_s=interval_s)


def _both(scenario):
    """scenario(pkg) for each package: (jax result, port result)."""
    return scenario(PKGS[0]), scenario(PKGS[1])


def _close(a, b, tol=1e-9):
    """a equals b, floats within `tol`, through lists and dicts."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_close(a[k], b[k], tol) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(_close(x, y, tol) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return a is not None and b is not None and math.isclose(a, b, rel_tol=tol, abs_tol=tol)
    return a == b


# -- the shared quantile contract ---------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantile_and_bucket_quantile_equal_the_jax_helpers(seed):
    jq, tq = _mod("modal_tpu", "observability.quantile"), _mod("modal_tpu_torch", "observability.quantile")
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 7, 101):
        vals = sorted(float(v) for v in rng.lognormal(size=n))
        for q in (0.0, 0.05, 0.5, 0.95, 0.99, 1.0):
            assert tq.quantile(vals, q) == jq.quantile(vals, q)
    bounds = tuple(sorted(float(b) for b in rng.uniform(0.001, 10.0, size=8)))
    for _ in range(50):
        counts = [int(c) for c in rng.integers(0, 5, size=len(bounds))]
        total = sum(counts) + int(rng.integers(0, 3))  # some +Inf overflow
        for q in (0.0, 0.5, 0.95, 1.0):
            assert tq.bucket_quantile(bounds, counts, q) == jq.bucket_quantile(bounds, counts, q)
            assert tq.bucket_quantile(bounds, counts, q, total=total) == jq.bucket_quantile(
                bounds, counts, q, total=total)
    # the JAX test's fixed points
    assert tq.quantile([], 0.5) == 0.0 and tq.quantile(sorted(float(i) for i in range(1, 102)), 0.5) == 51.0
    assert tq.bucket_quantile((1.0, 2.0), [0, 0], 0.5) is None
    assert tq.bucket_quantile((1.0, 2.0), [0, 0], 0.5, total=5) == 2.0
    # the registry's Histogram.quantile is the helper
    h = _mod("modal_tpu_torch", "observability.metrics").Histogram("x", "", (), buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.05, 0.5, 0.5, 0.5, 5.0):
        h.observe(v)
    assert h.quantile(0.5) == tq.bucket_quantile(h.buckets, [2, 3, 1], 0.5, total=6) == 1.0


# -- the time-series store ----------------------------------------------------


def test_store_counter_deltas_and_window_rates():
    def scenario(pkg):
        reg = _registry(pkg)
        c = reg.get("modal_tpu_task_results_total")
        store = _store(pkg, reg)
        c.inc(100, status="SUCCESS")  # history before the store: the baseline
        store.sample(now=0.0)
        out = [store.counter_sum("modal_tpu_task_results_total", 100, now=0.1)]
        for i in range(5):
            c.inc(2, status="SUCCESS")
            c.inc(1, status="FAILURE")
            store.sample(now=1.0 + i)
        out += [
            store.counter_sum("modal_tpu_task_results_total", 100, now=5.5),
            store.counter_sum("modal_tpu_task_results_total", 100, now=5.5, label_filter="FAILURE"),
            store.counter_rate("modal_tpu_task_results_total", 10, now=5.5),
            store.counter_rate("modal_tpu_task_results_total", 1.0, now=100.0),
        ]
        return out

    jax_out, port_out = _both(scenario)
    assert _close(port_out, jax_out)
    assert port_out[0] is None and port_out[1:3] == [15, 5] and port_out[3] == pytest.approx(1.5)
    assert port_out[4] is None


def test_store_hist_window_quantile_excludes_old_spikes():
    def scenario(pkg):
        reg = _registry(pkg)
        h = reg.get("modal_tpu_serving_ttft_seconds")
        store = _store(pkg, reg)
        store.sample(now=0.0)
        for _ in range(20):
            h.observe(4.0)
        store.sample(now=1.0)
        out = [store.hist_quantile("modal_tpu_serving_ttft_seconds", 0.95, 10, now=1.1)]
        for _ in range(20):
            h.observe(0.03)
        store.sample(now=20.0)
        out.append(store.hist_quantile("modal_tpu_serving_ttft_seconds", 0.95, 5.0, now=20.1))
        out.append(store.hist_quantile("modal_tpu_serving_ttft_seconds", 0.95, 5.0, now=60.0))
        out.append(store.hist_stats("modal_tpu_serving_ttft_seconds", 100.0, now=20.1))
        return out

    jax_out, port_out = _both(scenario)
    assert _close(port_out, jax_out)
    assert port_out[:3] == [5.0, 0.05, None]


def test_store_gauge_minmax_rollup_and_bounded_memory():
    def scenario(pkg):
        reg = _registry(pkg)
        g = reg.get("modal_tpu_serving_tokens_per_second")
        store = _store(pkg, reg, interval_s=1.0)  # tiers: 1 s raw, 6 s, 60 s
        for i in range(400):  # past the raw ring's 360
            g.set(float(i))
            store.sample(now=float(i))
        raw = store.tiers[0].data[("modal_tpu_serving_tokens_per_second", "")]
        mid = store.tiers[1].data[("modal_tpu_serving_tokens_per_second", "")]
        return {
            "raw_len": len(raw),
            "mid_last": list(mid[-1]),
            "stats": store.gauge_stats("modal_tpu_serving_tokens_per_second", 395.0, now=399.0),
            "points": store.point_counts(),
        }

    jax_out, port_out = _both(scenario)
    assert _close(port_out, jax_out)
    assert port_out["raw_len"] == 360
    _t, last, mn, mx = port_out["mid_last"]
    assert mn < mx and last == mx and port_out["stats"]["max"] >= 390


def test_store_series_cap_overflow():
    def scenario(pkg):
        ts = _mod(pkg, "observability.timeseries")
        reg = _registry(pkg)
        c = reg.get("modal_tpu_task_results_total")
        store = _store(pkg, reg)
        store.sample(now=0.0)
        for i in range(50):  # past MAX_TRACKED_SERIES distinct label values
            c.inc(1, status=f"s{i}")
        store.sample(now=1.0)
        keys = sorted(k for (f, k) in store.tiers[0].data if f == "modal_tpu_task_results_total")
        return {"keys": keys, "cap": ts.MAX_TRACKED_SERIES, "overflow": ts.OVERFLOW_KEY,
                "sum": store.counter_sum("modal_tpu_task_results_total", 10, now=1.1)}

    jax_out, port_out = _both(scenario)
    assert port_out == jax_out
    assert len(port_out["keys"]) == port_out["cap"] + 1 and port_out["overflow"] in port_out["keys"]
    assert port_out["sum"] == 50


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_samples_give_equal_windows(seed):
    """Random observations at random `now`s: both stores answer every
    window (rates, sums, quantiles, gauge min/max, series payloads and
    describe) with the same numbers."""
    rng = np.random.default_rng(seed)
    n = 120
    times = np.cumsum(rng.uniform(0.01, 3.0, size=n))
    ttfts = rng.lognormal(-2.0, 1.5, size=(n, 4))
    tokens = rng.integers(0, 200, size=n)
    gauge = rng.uniform(0.0, 500.0, size=n)
    statuses = rng.choice(["SUCCESS", "FAILURE", "TERMINATED"], size=(n, 3))

    def scenario(pkg):
        reg = _registry(pkg)
        h, tok = reg.get("modal_tpu_serving_ttft_seconds"), reg.get("modal_tpu_serving_tokens_total")
        g, res = reg.get("modal_tpu_serving_tokens_per_second"), reg.get("modal_tpu_task_results_total")
        store = _store(pkg, reg, interval_s=1.0)
        out = []
        for i in range(n):
            for v in ttfts[i]:
                h.observe(float(v))
            tok.inc(float(tokens[i]))
            g.set(float(gauge[i]))
            for s in statuses[i]:
                res.inc(1, status=str(s))
            store.sample(now=float(times[i]))
            if i % 10 == 9:
                now = float(times[i]) + 0.5
                for w in (5.0, 30.0, 120.0, 1000.0):
                    out.append([
                        store.counter_rate("modal_tpu_serving_tokens_total", w, now=now),
                        store.counter_sum("modal_tpu_task_results_total", w, now=now, label_filter="FAILURE"),
                        store.hist_quantile("modal_tpu_serving_ttft_seconds", 0.5, w, now=now),
                        store.hist_quantile("modal_tpu_serving_ttft_seconds", 0.95, w, now=now),
                        store.hist_stats("modal_tpu_serving_ttft_seconds", w, now=now),
                        store.gauge_stats("modal_tpu_serving_tokens_per_second", w, now=now),
                    ])
        end = float(times[-1]) + 0.5
        out.append(store.series_payload("modal_tpu_serving_ttft_seconds", 60.0, now=end))
        out.append(store.series_payload("modal_tpu_serving_tokens_per_second", 600.0, now=end))
        desc = store.describe()
        desc.pop("interval_s")
        out.append(desc)
        return out

    jax_out, port_out = _both(scenario)
    assert _close(port_out, jax_out)


def test_sampling_switch_and_families_from_the_env(monkeypatch):
    jts, tts = _mod("modal_tpu", "observability.timeseries"), _mod("modal_tpu_torch", "observability.timeseries")
    assert tts.DEFAULT_FAMILIES == jts.DEFAULT_FAMILIES
    assert "modal_tpu_kernel_launches" not in tts.DEFAULT_FAMILIES
    for value in ("", "0", "off", "false", "no", "2.5", "junk"):
        monkeypatch.setenv("MODAL_TPU_TS_INTERVAL", value)
        assert (tts.sampling_enabled(), tts.base_interval_s()) == (jts.sampling_enabled(), jts.base_interval_s())
    monkeypatch.setenv("MODAL_TPU_TS_FAMILIES", "modal_tpu_kernel_launches, modal_tpu_step_seconds")
    assert tts.tracked_families() == jts.tracked_families()
    assert tts.tracked_families()[-1] == "modal_tpu_kernel_launches"


# -- burn rates and the alert state machine -------------------------------------


def _ttft_rule(pkg, threshold=0.5, fast=1.0, slow=3.0):
    return _mod(pkg, "observability.slo").SLORule(
        name="ttft", description="test ttft", family="modal_tpu_serving_ttft_seconds",
        kind="hist_quantile", q=0.95, threshold=threshold, fast_window_s=fast, slow_window_s=slow,
    )


def _strip(transitions):
    return [{k: v for k, v in t.items() if k != "since"} for t in transitions]


def test_multiwindow_burn_fire_and_resolve():
    def scenario(pkg):
        slo = _mod(pkg, "observability.slo")
        reg = _registry(pkg)
        h = reg.get("modal_tpu_serving_ttft_seconds")
        store = _store(pkg, reg)
        ev = slo.SLOEvaluator(store, rules=[_ttft_rule(pkg)])
        store.sample(now=0.0)
        for _ in range(30):
            h.observe(0.03)
        store.sample(now=1.0)
        h.observe(4.0)
        store.sample(now=3.5)
        out = [_strip(ev.evaluate(now=3.5))]  # fast burns, slow does not: holds
        for i in range(10):
            h.observe(4.0)
            store.sample(now=4.0 + i * 0.3)
        out.append(_strip(ev.evaluate(now=7.0)))
        out.append(ev.burn_rate("ttft", now=7.0))
        out.append(_strip(ev.evaluate(now=100.0)))  # silence holds the alert
        for i in range(10):
            h.observe(0.03)
            store.sample(now=200.0 + i * 0.05)
        out.append(_strip(ev.evaluate(now=200.6)))
        payload = ev.payload(now=200.6)
        out.append([{k: v for k, v in r.items() if k != "since"} for r in payload["rules"]])
        return out

    jax_out, port_out = _both(scenario)
    assert _close(port_out, jax_out)
    assert port_out[0] == [] and [t["state"] for t in port_out[1]] == ["firing"] and port_out[2] > 1.0
    assert port_out[3] == [] and [t["state"] for t in port_out[4]] == ["resolved"]


def test_throughput_rules_burn_inverted_and_catch_a_wedged_producer():
    def scenario(pkg):
        slo = _mod(pkg, "observability.slo")
        reg = _registry(pkg)
        g, tokens = reg.get("modal_tpu_serving_tokens_per_second"), reg.get("modal_tpu_serving_tokens_total")
        store = _store(pkg, reg)
        gauge_rule = slo.SLORule(name="tps", description="floor", family="modal_tpu_serving_tokens_per_second",
                                 kind="gauge", threshold=100.0, op="<", fast_window_s=1.0, slow_window_s=3.0)
        rate_rule = slo.SLORule(name="tps_floor", description="floor", family="modal_tpu_serving_tokens_total",
                                kind="counter_rate", threshold=100.0, op="<", fast_window_s=2.0, slow_window_s=5.0)
        ev = slo.SLOEvaluator(store, rules=[gauge_rule, rate_rule])
        out = []
        g.set(25.0)
        for i in range(8):
            tokens.inc(100)
            store.sample(now=i * 0.5)
        out.append(_strip(ev.evaluate(now=4.0)))
        out.append(ev.burn_rate("tps", now=4.0))
        g.set(400.0)  # the gauge recovers; the counter stops moving
        for i in range(12):
            store.sample(now=5.0 + i * 0.5)
        out.append(_strip(ev.evaluate(now=11.0)))
        out.append(dict(ev.alerts["tps_floor"], since=None))
        return out

    jax_out, port_out = _both(scenario)
    assert _close(port_out, jax_out)
    assert [t["state"] for t in port_out[0]] == ["firing"] and port_out[1] == pytest.approx(4.0)
    assert sorted((t["rule"], t["state"]) for t in port_out[2]) == [("tps", "resolved"), ("tps_floor", "firing")]
    assert port_out[3]["value"] == 0.0


def test_default_rules_follow_the_env(monkeypatch):
    monkeypatch.setenv("MODAL_TPU_SLO_TTFT_P95_S", "0.75")
    monkeypatch.setenv("MODAL_TPU_SLO_FAST_WINDOW_S", "15")
    monkeypatch.setenv("MODAL_TPU_SLO_TOKENS_PER_REPLICA", "40")
    j = [vars(r) for r in _mod("modal_tpu", "observability.slo").default_rules()]
    t = [vars(r) for r in _mod("modal_tpu_torch", "observability.slo").default_rules()]
    assert t == j
    assert [r["name"] for r in t] == ["serving_ttft_p95", "serving_tokens_per_replica", "dispatch_p50",
                                      "call_error_rate"]
    assert t[0]["threshold"] == 0.75 and t[0]["fast_window_s"] == 15.0 and t[1]["enabled"]


def test_alert_transitions_are_journaled_and_replayable(tmp_path):
    """A firing alert goes to each package's journal, replay rebuilds it,
    a fresh evaluator adopts it, and an empty store cannot resolve it."""

    def scenario(pkg):
        slo = _mod(pkg, "observability.slo")
        journal_mod, state_mod = _mod(pkg, "server.journal"), _mod(pkg, "server.state")
        root = tmp_path / pkg
        reg = _registry(pkg)
        h = reg.get("modal_tpu_serving_ttft_seconds")
        store = _store(pkg, reg)
        journal = journal_mod.Journal(str(root / "state"))
        ev = slo.SLOEvaluator(store, rules=[_ttft_rule(pkg)], journal=journal)
        store.sample(now=0.0)
        for i in range(12):
            h.observe(4.0)
            store.sample(now=0.5 + i * 0.3)
        fired = _strip(ev.evaluate(now=4.0))
        journal.close()
        state = state_mod.ServerState(str(root / "state2"))
        report = journal_mod.recover_state(state, journal_mod.Journal(str(root / "state")))
        rebuilt = dict(state.alerts)
        ev2 = slo.SLOEvaluator(_store(pkg, _registry(pkg)), rules=[_ttft_rule(pkg)], alerts=state.alerts)
        return {"fired": fired, "alerts": rebuilt, "after": ev2.evaluate(now=10.0),
                "state": state.alerts["ttft"]["state"], "skipped": report["records_skipped"],
                "snapshot": [r for r in journal_mod.synthesize_records(state) if r["t"] == "alert"]}

    jax_out, port_out = _both(scenario)
    assert _close(port_out, jax_out)
    assert [t["state"] for t in port_out["fired"]] == ["firing"] and port_out["alerts"]["ttft"]["burn_rate"] > 1.0
    assert port_out["after"] == [] and port_out["state"] == "firing" and port_out["skipped"] == 0
    assert [r["rule"] for r in port_out["snapshot"]] == ["ttft"]


def test_a_jax_alert_record_replays_into_the_port(tmp_path):
    """The record the JAX evaluator journals is the one the port's replay
    applies (`alert` left the port's waiting record types)."""
    jjournal, tjournal = _mod("modal_tpu", "server.journal"), _mod("modal_tpu_torch", "server.journal")
    tstate = _mod("modal_tpu_torch", "server.state")
    assert "alert" not in tjournal.WAITING_RECORD_TYPES and "alert" in tjournal._APPLIERS
    reg = _registry("modal_tpu")
    h = reg.get("modal_tpu_serving_ttft_seconds")
    store = _store("modal_tpu", reg)
    journal = jjournal.Journal(str(tmp_path / "jax"))
    ev = _mod("modal_tpu", "observability.slo").SLOEvaluator(store, rules=[_ttft_rule("modal_tpu")], journal=journal)
    store.sample(now=0.0)
    for i in range(12):
        h.observe(4.0)
        store.sample(now=0.5 + i * 0.3)
    assert ev.evaluate(now=4.0)
    journal.close()
    state = tstate.ServerState(str(tmp_path / "port"))
    report = tjournal.recover_state(state, tjournal.Journal(str(tmp_path / "jax")))
    assert report["records_skipped"] == 0
    assert state.alerts == ev.alerts


# -- the SLO autoscaler -------------------------------------------------------


def _sched_pair(pkg, tmp_path):
    api = _mod(pkg, "proto.api_pb2")
    state_mod, sched_mod = _mod(pkg, "server.state"), _mod(pkg, "server.scheduler")
    state = state_mod.ServerState(str(tmp_path / pkg))
    definition = api.Function(function_name="svc", webhook_type=api.WEB_ENDPOINT_TYPE_ASGI_APP)
    definition.autoscaler_settings.min_containers = 1
    definition.autoscaler_settings.max_containers = 8
    definition.autoscaler_settings.target_ttft_ms = 100.0
    definition.autoscaler_settings.target_tokens_per_replica = 1000.0
    fn = state_mod.FunctionState(function_id="fu-burn", app_id="ap-1", tag="svc", definition=definition)
    state.functions["fu-burn"] = fn
    return api, state_mod, state, fn, sched_mod.Scheduler(state)


def _burn_store(pkg, value):
    reg = _registry(pkg)
    store = _store(pkg, reg)
    store.sample()
    for _ in range(20):
        reg.get("modal_tpu_serving_ttft_seconds").observe(value)
    store.sample()
    return store


def test_scheduler_consumes_burn_rate_urgency(tmp_path):
    """Both schedulers step by the same amount for the same windowed burn
    (3 at ~50×, 2 at 5×, none when healthy), and both drop the burn when
    another function serves."""

    def scenario(pkg):
        api, state_mod, state, fn, sched = _sched_pair(pkg, tmp_path)
        out = []
        for value in (4.0, 0.3, 0.005):
            fn.slo_last_scale_at = 0.0
            state.timeseries = _burn_store(pkg, value)
            out.append((sched._ttft_burn_rate(fn, 0.1), sched._slo_desired(fn, ["ta-1"])))
        state.timeseries = None
        out.append(sched._ttft_burn_rate(fn, 0.1))
        state.timeseries = _burn_store(pkg, 0.005)
        defn2 = api.Function(function_name="svc2", webhook_type=api.WEB_ENDPOINT_TYPE_ASGI_APP)
        fn2 = state_mod.FunctionState(function_id="fu-other", app_id="ap-1", tag="svc2", definition=defn2)
        state.functions["fu-other"] = fn2
        other = state_mod.TaskState_(task_id="ta-other", function_id="fu-other", app_id="ap-1",
                                     state=api.TASK_STATE_ACTIVE)
        other.telemetry_prev_json = json.dumps(
            {"modal_tpu_serving_ttft_p95_seconds": {"kind": "gauge", "series": {"": 5.0}}})
        state.tasks["ta-other"] = other
        fn2.task_ids.add("ta-other")
        out.append(sched._ttft_burn_rate(fn, 0.1))
        other.telemetry_prev_json = ""
        out.append(sched._ttft_burn_rate(fn, 0.1) is not None)
        return out

    jax_out, port_out = _both(scenario)
    assert _close(port_out, jax_out)
    assert [d for _b, d in port_out[:3]] == [4, 3, 1]
    assert port_out[3] is None and port_out[4] is None and port_out[5] is True


@pytest.mark.parametrize("seed", range(6))
def test_slo_decisions_from_pushed_heartbeat_telemetry(tmp_path, seed):
    """With no store, both schedulers size on each replica's raw heartbeat
    push (the same reports, as ContainerHeartbeat keeps them) and make the
    same decision through the cooldown: up on a queue or an active TTFT
    breach, down when idle, held inside the cooldown."""
    rng = np.random.default_rng(seed)
    rounds = []
    for _ in range(8):
        n_live = int(rng.integers(1, 5))
        rounds.append([{
            "modal_tpu_serving_ttft_p95_seconds": {"kind": "gauge", "series": {"": float(rng.choice([0.01, 0.04, 0.3]))}},
            "modal_tpu_serving_tokens_per_second": {"kind": "gauge", "series": {"": float(rng.choice([0.0, 50.0, 900.0]))}},
            "modal_tpu_serving_queue_depth": {"kind": "gauge", "series": {"": float(rng.choice([0.0, 0.0, 3.0]))}},
            "modal_tpu_serving_role": {"kind": "gauge", "series": {"": float(rng.choice([0, 1, 2]))}},
        } for _ in range(n_live)])
    stamps = [float(t) for t in np.cumsum(rng.choice([0.0, 4.0, 11.0], size=len(rounds)))]

    def scenario(pkg):
        api, state_mod, state, fn, sched = _sched_pair(pkg, tmp_path)
        sched_mod = _mod(pkg, "server.scheduler")
        decisions = []
        for r, (reports, stamp) in enumerate(zip(rounds, stamps)):
            live = []
            for i, report in enumerate(reports):
                tid = f"ta-{r}-{i}"
                task = state_mod.TaskState_(task_id=tid, function_id="fu-burn", app_id="ap-1",
                                            state=api.TASK_STATE_ACTIVE)
                task.telemetry_prev_json = json.dumps(report)
                state.tasks[tid] = task
                live.append(tid)
            # the cooldown reads the module's clock: a stand-in with this
            # round's stamp
            real_time = sched_mod.time
            sched_mod.time = types.SimpleNamespace(time=lambda: 1000.0 + stamp)
            try:
                decisions.append((sched._slo_desired(fn, live), fn.slo_last_scale_at))
            finally:
                sched_mod.time = real_time
        return decisions

    jax_out, port_out = _both(scenario)
    assert port_out == jax_out
