"""The port's chaos policy (chaos.py) against the JAX package's: the same
seed and the same sequence of RPC calls give the same decisions and the
same `fault_log` in both, and each `from_env` variable parses to the same
policy, the shard and replication knobs included, which fire in both. Then
on the port's plane: a `supervisor_crash` mid-map delivers every index
exactly once, the counterparts of tests/test_chaos_soak.py's
single-supervisor cases (a 50-input map under 5% faults and a worker
preemption; a seed-reproducible fault sequence), `stream_reset` degrades to
the poll rung with each call completed once, `warm_kill_handoff` falls back
to a fresh spawn, and every injection is counted on /metrics."""

import contextlib
import os
import tempfile
import urllib.request

import pytest

import modal_tpu.chaos as jchaos
import modal_tpu_torch
import modal_tpu_torch.chaos as tchaos
from modal_tpu_torch._utils.async_utils import synchronizer
from modal_tpu_torch.client import _Client
from modal_tpu_torch.exception import InvalidError
from modal_tpu_torch.server.supervisor import LocalSupervisor

# the RPCs of the port's plane that carry the data path
PORT_RPCS = ["FunctionGetInputs", "FunctionPutOutputs", "FunctionPutInputs", "FunctionGetOutputs", "FunctionMap",
             "FunctionExchange", "FunctionStreamOutputs", "ContainerHeartbeat", "WorkerHeartbeat", "BlobPut",
             "BlobGet", "VolumeFileGet", "AppCreate"]
# tests/test_chaos_soak.py's policy
SOAK_SEED = 42
DATA_PLANE_RPCS = ["FunctionGetInputs", "FunctionPutOutputs", "FunctionPutInputs", "FunctionGetOutputs",
                   "FunctionMap", "MapStartOrContinue", "MapAwait", "AttemptStart", "AttemptAwait", "BlobPut",
                   "BlobGet"]


def _soak_policy(mod):
    return mod.ChaosPolicy(seed=SOAK_SEED, error_rates={rpc: 0.05 for rpc in DATA_PLANE_RPCS}, events=[
        mod.ChaosEvent(kind="worker_preempt", after_outputs=10, worker_index=0, grace_s=5.0)])


def _pattern(seed: int) -> list:
    """A seeded call sequence over the port's RPCs, interleaved."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [PORT_RPCS[int(i)] for i in rng.integers(0, len(PORT_RPCS), size=600)]


CONFIGS = {
    "rates": dict(default_error_rate=0.1),
    "named": dict(error_rates={"FunctionMap": 0.3, "FunctionExchange": 0.2, "BlobGet": 0.5}),
    "latency": dict(default_error_rate=0.05, latency_ms=2.0, latency_jitter_ms=1.0, latency_rate=0.5),
    "capped": dict(default_error_rate=0.5, max_faults=7),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 7, SOAK_SEED])
def test_same_seed_same_calls_same_decisions_and_fault_log(config, seed):
    policies = [mod.ChaosPolicy(seed, **CONFIGS[config]) for mod in (jchaos, tchaos)]
    for p in policies:
        p.fail_counts["fail_put_outputs"] = 2
    decisions = [[], []]
    for i, rpc in enumerate(_pattern(seed)):
        if i == 300:
            for p in policies:
                p.start_heartbeat_blackhole(3600.0)
        for k, p in enumerate(policies):
            decisions[k].append(p.decide(rpc))
    jp, tp = policies
    assert decisions[1] == decisions[0]
    assert tp.fault_log == jp.fault_log and tp.fault_log
    assert tp.injected == jp.injected and tp.call_counts == jp.call_counts
    assert any(e.startswith(("ContainerHeartbeat#", "WorkerHeartbeat#")) for e in tp.fault_log[-50:])


def test_the_soak_policys_fault_sequence_is_seed_reproducible():
    """tests/test_chaos_soak.py's reproducibility case on the port, and the
    JAX package's policy on the same calls."""
    pattern = ([("FunctionGetInputs", 120), ("FunctionPutOutputs", 60), ("MapStartOrContinue", 9)]
               + [("MapAwait", 75), ("BlobPut", 12), ("BlobGet", 12), ("WorkerHeartbeat", 40)])
    a, b, j = _soak_policy(tchaos), _soak_policy(tchaos), _soak_policy(jchaos)
    for policy in (a, b, j):
        for rpc, n in pattern:
            for _ in range(n):
                policy.decide(rpc)
    assert a.fault_log == b.fault_log == j.fault_log and a.fault_log
    assert a.injected == b.injected == j.injected


def _policy_fields(p) -> dict:
    return {"seed": p.seed, "error_rates": p.error_rates, "default_error_rate": p.default_error_rate,
            "latency_ms": p.latency_ms, "latency_jitter_ms": p.latency_jitter_ms, "latency_rate": p.latency_rate,
            "events": [(e.kind, e.after_outputs) for e in p.events], "fail_counts": p.fail_counts}


ENVS = {
    "off": {},
    "on": {"MODAL_TPU_CHAOS": "1"},
    "seed_rate": {"MODAL_TPU_CHAOS": "true", "MODAL_TPU_CHAOS_SEED": "9", "MODAL_TPU_CHAOS_ERROR_RATE": "0.2"},
    "rpcs": {"MODAL_TPU_CHAOS": "1", "MODAL_TPU_CHAOS_ERROR_RATE": "0.1",
             "MODAL_TPU_CHAOS_RPCS": "FunctionMap=0.3, BlobGet,FunctionExchange=0.05"},
    "latency": {"MODAL_TPU_CHAOS": "yes", "MODAL_TPU_CHAOS_LATENCY_MS": "5", "MODAL_TPU_CHAOS_LATENCY_JITTER_MS": "2",
                "MODAL_TPU_CHAOS_LATENCY_RATE": "0.25"},
    "crashes": {"MODAL_TPU_CHAOS": "1", "MODAL_TPU_CHAOS_SUPERVISOR_CRASH_AFTER": "10, 30,x"},
    "lifecycle": {"MODAL_TPU_CHAOS": "1", "MODAL_TPU_CHAOS_WARM_KILL_HANDOFF": "2",
                  "MODAL_TPU_CHAOS_STREAM_RESETS": "3"},
    "malformed": {"MODAL_TPU_CHAOS": "1", "MODAL_TPU_CHAOS_WARM_KILL_HANDOFF": "two",
                  "MODAL_TPU_CHAOS_STREAM_RESETS": "-1"},
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_from_env_parses_each_variable_as_the_jax_package(name, monkeypatch):
    for k in list(os.environ):
        if k.startswith("MODAL_TPU_CHAOS"):
            monkeypatch.delenv(k)
    for k, v in ENVS[name].items():
        monkeypatch.setenv(k, v)
    jp, tp = jchaos.ChaosPolicy.from_env(), tchaos.ChaosPolicy.from_env()
    assert (tp is None) == (jp is None) == (name == "off")
    if tp is not None:
        assert _policy_fields(tp) == _policy_fields(jp)


# the fleet's knobs: each variable, the value it gets, and what it sets
FLEET_ENVS = {
    "MODAL_TPU_CHAOS_SHARD_KILL_AFTER": ("1:5,2:9", lambda p: [(e.kind, e.shard_index, e.after_outputs) for e in p.events]),
    "MODAL_TPU_CHAOS_SHARD_PARTITION": ("2:3:4.5", lambda p: [(e.kind, e.shard_index, e.duration_s) for e in p.events]),
    "MODAL_TPU_CHAOS_REPL_TORN_TAIL": ("2", lambda p: p.fail_counts),
    "MODAL_TPU_CHAOS_REPL_DISK_FULL": ("1", lambda p: p.fail_counts),
    "MODAL_TPU_CHAOS_REPL_ACK_DROP": ("3", lambda p: p.fail_counts),
    "MODAL_TPU_CHAOS_REPL_LAG_MS": ("7.5", lambda p: p.repl_lag_ms),
}


@pytest.mark.parametrize("env_name", sorted(FLEET_ENVS))
def test_a_fleet_knob_parses_as_the_jax_package_and_the_plane_boots(env_name, monkeypatch):
    """Each shard and replication variable sets what the JAX package's sets,
    and a plane with it constructs."""
    for k in list(os.environ):
        if k.startswith("MODAL_TPU_CHAOS"):
            monkeypatch.delenv(k)
    value, read = FLEET_ENVS[env_name]
    monkeypatch.setenv("MODAL_TPU_CHAOS", "1")
    monkeypatch.setenv(env_name, value)
    jp, tp = jchaos.ChaosPolicy.from_env(), tchaos.ChaosPolicy.from_env()
    assert _policy_fields(tp) == _policy_fields(jp) and read(tp) == read(jp)
    assert read(tp)  # the knob took effect
    sup = LocalSupervisor(num_workers=0, state_dir=tempfile.mkdtemp(prefix="chaos-", dir="/tmp"))
    assert read(sup.chaos) == read(tp)


def test_fleet_knobs_and_events_fire_in_code():
    """The follower's replication knobs drain as the JAX package's do, and
    the shard and director events pop once their output count passes."""
    p, jp = tchaos.ChaosPolicy(), jchaos.ChaosPolicy()
    for knob in ("repl_torn_tail", "repl_disk_full", "repl_ack_drop"):
        p.set_knob(knob, 1)
        jp.set_knob(knob, 1)
        assert p.consume_knob(knob) and jp.consume_knob(knob) and not p.consume_knob(knob)
    assert p.fault_log == jp.fault_log == ["repl_torn_tail#0", "repl_disk_full#0", "repl_ack_drop#0"]
    kinds = ("shard_kill", "shard_partition", "director_blackhole")
    ev = tchaos.ChaosPolicy(events=[tchaos.ChaosEvent(kind=k, after_outputs=i + 1) for i, k in enumerate(kinds)])
    ev.note_outputs(2)
    assert [e.kind for e in ev.pop_due_events()] == ["shard_kill", "shard_partition"]
    ev.note_outputs(1)
    assert [e.kind for e in ev.pop_due_events()] == ["director_blackhole"] and not ev.pop_due_events()
    with pytest.raises(InvalidError, match="unknown chaos event kind"):
        tchaos.ChaosPolicy(events=[tchaos.ChaosEvent(kind="no_such_event")])
    with pytest.raises(KeyError):
        p.set_knob("no_such_knob", 1)
    p.set_knob("stream_reset", 2)
    assert p.get_knob("stream_reset") == 2 and p.consume_knob("stream_reset") and p.fault_log[-1] == "stream_reset#0"


async def _http_injection():
    p = tchaos.ChaosPolicy(error_rates={"BlobGet": 1.0})
    resp = await p.inject_http("BlobGet")
    return resp.status, await p.inject_http("BlobPut"), p.fault_log


def test_inject_http_answers_503():
    import asyncio

    assert asyncio.run(_http_injection()) == (503, None, ["BlobGet#0"])


# -- on the port's plane ------------------------------------------------------------


@contextlib.contextmanager
def _plane(policy, **kw):
    state = tempfile.mkdtemp(prefix="chaos-", dir="/tmp")
    kw = {"num_workers": 1, "worker_gpus": 8, "worker_gpu_type": "local-sim", **kw}
    sup = LocalSupervisor(state_dir=state, chaos=policy, **kw)
    synchronizer.run(sup.start())
    client = _Client(sup.server_url)
    client._open()
    _Client.set_env_client(client)
    try:
        yield sup, client
    finally:
        _Client.set_env_client(None)
        client._close()
        synchronizer.run(sup.stop())


def _square_app(name: str, sleep_s: float):
    app = modal_tpu_torch.App(name)

    def square(x):
        import time as _t

        _t.sleep(sleep_s)
        return x * x

    return app, app.function(serialized=True)(square)


def test_a_supervisor_crash_mid_map_delivers_every_index_once():
    policy = tchaos.ChaosPolicy(seed=0, events=[tchaos.ChaosEvent(kind="supervisor_crash", after_outputs=3)])
    with _plane(policy) as (sup, client):
        app, f = _square_app("chaos-crash-map", 0.2)
        with app.run(client=client):
            got = list(f.map(range(12)))
        assert got == [x * x for x in range(12)]
        assert policy.events[0].fired and sup.recovery_report is not None
        assert os.listdir(os.path.join(sup.state_dir, "observability"))


def test_soak_map_survives_faults_and_preemption():
    """tests/test_chaos_soak.py's soak on the port: a 50-input map under 5%
    UNAVAILABLE on the data path and a worker preemption after 10 outputs.
    The port's containers claim and publish through FunctionExchange and
    its client reads outputs from FunctionStreamOutputs, so those carry the
    rate too (the input plane's RPCs never reach this plane)."""
    policy = _soak_policy(tchaos)
    policy.error_rates.update({"FunctionExchange": 0.05, "FunctionStreamOutputs": 0.05})
    with _plane(policy, num_workers=2) as (sup, client):
        app, f = _square_app("chaos-soak", 0.05)
        with app.run(client=client):
            results = sorted(f.map(range(50)))
    assert results == [x * x for x in range(50)]
    assert sum(policy.injected.values()) > 0 and all(ev.fired for ev in policy.events)


def test_stream_reset_degrades_to_poll_with_each_call_once():
    from modal_tpu_torch.observability.catalog import OUTPUT_STREAM_EVENTS

    policy = tchaos.ChaosPolicy(seed=0)
    with _plane(policy) as (sup, client):
        policy.set_knob("stream_reset", 3)
        before = OUTPUT_STREAM_EVENTS.value(event="reset")
        app, f = _square_app("chaos-stream", 0.0)
        with app.run(client=client):
            assert [f.remote(i) for i in range(3)] == [0, 1, 4]
            assert sorted(f.map(range(6))) == [x * x for x in range(6)]
        assert policy.get_knob("stream_reset") == 0
        assert OUTPUT_STREAM_EVENTS.value(event="reset") > before
        calls = [c for c in sup.state.function_calls.values() if c.function_id == f.object_id]
        assert all(len(c.outputs) == c.num_inputs for c in calls) and len(calls) == 4


def test_warm_kill_handoff_falls_back_to_a_fresh_spawn(monkeypatch):
    from modal_tpu_torch.observability.catalog import WARM_POOL_PLACEMENTS

    monkeypatch.setenv("MODAL_TPU_WARM_POOL", "1")
    monkeypatch.setenv("MODAL_TPU_WARM_POOL_PREIMPORT", "json")
    policy = tchaos.ChaosPolicy(seed=0)
    with _plane(policy) as (sup, client):
        assert synchronizer.run(sup.workers[0].pool.wait_parked(1, 60.0)), "no interpreter parked"
        policy.set_knob("warm_kill_handoff", 1)
        failed = WARM_POOL_PLACEMENTS.value(outcome="handoff_failed")
        app = modal_tpu_torch.App("chaos-warm-kill")

        def double(x):
            import os as _os

            return _os.getpid(), x * 2

        f = app.function(serialized=True)(double)
        with app.run(client=client):
            _pid, v = f.remote(5)
        assert v == 10 and policy.get_knob("warm_kill_handoff") == 0
        assert not any(t.warm_pool_hit for t in sup.state.tasks.values())
        assert WARM_POOL_PLACEMENTS.value(outcome="handoff_failed") > failed
        assert "warm_kill_handoff#0" in policy.fault_log


def test_chaos_injections_are_counted_and_the_seed_echoed():
    from modal_tpu_torch.observability.catalog import CHAOS_INJECTIONS, CHAOS_SEED

    policy = tchaos.ChaosPolicy(seed=5)
    with _plane(policy) as (sup, client):
        assert CHAOS_SEED.value() == 5.0
        before = CHAOS_INJECTIONS.total()
        policy.set_knob("fail_put_inputs", 1)
        app, f = _square_app("chaos-count", 0.0)
        with app.run(client=client):
            assert f.remote(7) == 49  # the client retries through the fault
        assert policy.fault_log and CHAOS_INJECTIONS.total() > before
        text = urllib.request.urlopen(f"http://127.0.0.1:{sup.blob_server.port}/metrics", timeout=10).read().decode()
    assert "modal_tpu_chaos_injections_total{" in text and 'kind="error"' in text
    assert "modal_tpu_chaos_seed 5.0" in text
