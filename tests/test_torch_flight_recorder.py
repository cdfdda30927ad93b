"""The port's flight recorder (observability/flight_recorder.py) against the
JAX package's: the cases of tests/test_federation.py (the ring's bounds and
the dump, the journal tail and chained taps, the off switch, the ring knob)
run on both, and the bundles must agree. Then a `crash_restart` of each
package's plane writes `postmortem-crash_restart-<t>.json` with the same
keys, `debug bundle --json` over each state dir gives the same event
kinds, and the port's plane dumps `alert` when an SLO alert fires."""

import json
import os
import tempfile
import time

import pytest
from click.testing import CliRunner

import modal_tpu
import modal_tpu_torch
from modal_tpu._utils.async_utils import synchronizer as jsync
from modal_tpu.cli.entry_point import cli as jcli
from modal_tpu.client import _Client as JaxClient
from modal_tpu.observability import flight_recorder as jfr
from modal_tpu.observability import tracing as jtracing
from modal_tpu.server.journal import Journal as JaxJournal
from modal_tpu.server.supervisor import LocalSupervisor as JaxSupervisor
from modal_tpu_torch._utils.async_utils import synchronizer as tsync
from modal_tpu_torch.cli.entry_point import cli as tcli
from modal_tpu_torch.client import _Client
from modal_tpu_torch.observability import flight_recorder as tfr
from modal_tpu_torch.observability import tracing as ttracing
from modal_tpu_torch.server.journal import Journal
from modal_tpu_torch.server.supervisor import LocalSupervisor

# the package-specific fields of a bundle; the rest must agree
VARYING = ("pid", "state_dir", "spans", "samples")


def _ring_and_dump(fr_mod, tracing, root: str) -> dict:
    """tests/test_federation.py's ring-bounds case on one package: returns
    the first bundle and the rate limiter's answers."""
    clock = [1000.0]
    fr = fr_mod.FlightRecorder(root, scope="shard", shard_index=2, ring=5, interval_s=0.0, clock=lambda: clock[0])
    fr.start()
    try:
        for _ in range(20):
            clock[0] += 1.0
            fr.record_sample()
        assert len(fr.samples) == 5, "ring must stay bounded"
        with tracing.span("unit.work", attrs={"k": "v"}):
            pass
        assert any(s["name"] == "unit.work" for s in fr.spans)
        fr.record_chaos({"kind": "supervisor_crash", "after_outputs": 3})
        path = fr.dump("crash_restart", extra={"why": "test"})
        with open(path) as f:
            pm = json.load(f)
        clock[0] += 1.0
        limited = [fr.dump("crash_restart") is None, fr.dump("alert") is not None]
        clock[0] += 10.0
        limited.append(fr.dump("crash_restart") is not None)
    finally:
        fr.stop()
    return {"pm": pm, "limited": limited, "found": len(fr_mod.find_postmortems(root))}


def test_ring_bounds_and_dump_match_the_jax_package(tmp_path):
    got = _ring_and_dump(tfr, ttracing, str(tmp_path / "port"))
    want = _ring_and_dump(jfr, jtracing, str(tmp_path / "jax"))
    pm, jpm = got["pm"], want["pm"]
    assert sorted(pm) == sorted(jpm)
    assert {k: v for k, v in pm.items() if k not in VARYING} == {k: v for k, v in jpm.items() if k not in VARYING}
    assert pm["event"] == "crash_restart" and pm["shard_index"] == 2 and len(pm["samples"]) == 5
    assert [s["t"] for s in pm["samples"]] == [s["t"] for s in jpm["samples"]]
    assert any(s["name"] == "unit.work" for s in pm["spans"])
    assert pm["chaos_events"] == [{"kind": "supervisor_crash", "after_outputs": 3}]
    assert got["limited"] == want["limited"] == [True, True, True]
    assert got["found"] == want["found"] == 3


@pytest.mark.parametrize("package", ["jax", "port"])
def test_the_journal_tail_and_chained_taps(tmp_path, package):
    fr_mod, journal_cls = (jfr, JaxJournal) if package == "jax" else (tfr, Journal)
    journal = journal_cls(str(tmp_path))
    seen = []
    journal.tap = seen.append  # a tap set before the recorder keeps firing
    fr = fr_mod.FlightRecorder(str(tmp_path), journal=journal, ring=4, interval_s=0.0)
    fr.start()
    try:
        journal.append("call_created", call_id="fc-1")
        journal.append("input_added", call_id="fc-1", idx=0)
        assert [r.get("t") for r in fr.journal_tail] == ["call_created", "input_added"]
        assert len(seen) == 2
        fr.record_sample()
        assert fr.samples[-1]["journal_seq"] == 2
    finally:
        fr.stop()
        journal.close()
    if package == "port":
        # stop gives the earlier tap back; the JAX package's stop compares the
        # bound method with `is`, never true, and leaves its own tap in place
        assert journal.tap == seen.append


@pytest.mark.parametrize("value,on", [("0", False), ("off", False), ("no", False), ("1", True), ("", True)])
def test_the_off_switch(monkeypatch, value, on):
    monkeypatch.setenv("MODAL_TPU_FLIGHT_RECORDER", value)
    assert tfr.enabled() is jfr.enabled() is on


@pytest.mark.parametrize("value,size", [("7", 7), ("not-a-number", 60), ("-3", 60)])
def test_the_ring_knob(monkeypatch, value, size):
    monkeypatch.setenv("MODAL_TPU_FLIGHT_RECORDER_RING", value)
    assert tfr.ring_size() == jfr.ring_size() == size


def _crash(m, state: str, recorder_on: bool = True) -> dict:
    """Boot a plane of package `m`, journal a secret, crash_restart it, and
    return its postmortems and `debug bundle --json` over its state dir."""
    sync, sup_cls, client_cls = (jsync, JaxSupervisor, JaxClient) if m is modal_tpu else (tsync, LocalSupervisor,
                                                                                          _Client)
    sup = sup_cls(num_workers=0, state_dir=state)
    sync.run(sup.start())
    client = client_cls(sup.server_url)
    client._open()
    try:
        assert (sup.flight_recorder is not None) is recorder_on
        m.Secret.create_deployed("fr-secret", {"A": "b"}, client=client)
        report = sync.run(sup.crash_restart())
        assert report is not None
    finally:
        client._close()
        sync.run(sup.stop())
    obs = os.path.join(state, "observability")
    names = sorted(n for n in os.listdir(obs) if n.startswith("postmortem-")) if os.path.isdir(obs) else []
    pms = []
    for n in names:
        with open(os.path.join(obs, n)) as f:
            pms.append(json.load(f))
    result = CliRunner().invoke(jcli if m is modal_tpu else tcli, ["debug", "bundle", "--state-dir", state, "--json"])
    assert result.exit_code == 0, result.output
    return {"names": names, "pms": pms, "bundle": json.loads(result.output)}


def test_a_crash_restart_of_each_plane_writes_the_same_postmortem():
    root = tempfile.mkdtemp(prefix="fr-", dir="/tmp")
    got = {name: _crash(m, os.path.join(root, name)) for name, m in (("jax", modal_tpu), ("port", modal_tpu_torch))}
    for name in ("jax", "port"):
        assert len(got[name]["names"]) == 1 and got[name]["names"][0].startswith("postmortem-crash_restart-")
    pm, jpm = got["port"]["pms"][0], got["jax"]["pms"][0]
    assert sorted(pm) == sorted(jpm)
    assert (pm["event"], pm["scope"], pm["shard_index"], pm["version"]) == (jpm["event"], jpm["scope"],
                                                                            jpm["shard_index"], jpm["version"])
    assert pm["samples"] and pm["journal_tail"] and jpm["samples"] and jpm["journal_tail"]
    assert {r["t"] for r in pm["journal_tail"]} >= {"secret"} and {r["t"] for r in jpm["journal_tail"]} >= {"secret"}
    kinds = {name: [pm["event"] for pm in got[name]["bundle"]["postmortems"]] for name in got}
    assert kinds["port"] == kinds["jax"] == ["crash_restart"]
    assert sorted(got["port"]["bundle"]) == sorted(got["jax"]["bundle"])
    timeline = {name: [e["what"].split(" (")[0] for e in got[name]["bundle"]["timeline"]] for name in got}
    assert timeline["port"] == timeline["jax"] == ["postmortem crash_restart"]


def test_the_recorder_off_writes_no_postmortem(monkeypatch):
    monkeypatch.setenv("MODAL_TPU_FLIGHT_RECORDER", "0")
    got = _crash(modal_tpu_torch, tempfile.mkdtemp(prefix="fr-off-", dir="/tmp"), recorder_on=False)
    assert got["names"] == [] and got["bundle"]["postmortems"] == []


def test_an_slo_alert_firing_dumps_a_postmortem(monkeypatch):
    """The sampler loop dumps `alert` for each transition to firing."""
    monkeypatch.setenv("MODAL_TPU_TS_INTERVAL", "0.05")
    state = tempfile.mkdtemp(prefix="fr-alert-", dir="/tmp")
    sup = LocalSupervisor(num_workers=0, state_dir=state)
    tsync.run(sup.start())
    try:
        transition = {"rule": "serving_ttft_p95", "state": "firing", "value": 9.0}
        evaluate = sup.state.slo.evaluate
        fired = []

        def evaluate_once():
            evaluate()
            if fired:
                return []
            fired.append(1)
            return [transition]

        sup.state.slo.evaluate = evaluate_once
        obs = os.path.join(state, "observability")
        deadline = time.monotonic() + 10
        while not any(n.startswith("postmortem-alert-") for n in os.listdir(obs)) and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        tsync.run(sup.stop())
    (name,) = [n for n in os.listdir(obs) if n.startswith("postmortem-")]
    with open(os.path.join(obs, name)) as f:
        pm = json.load(f)
    assert pm["event"] == "alert" and pm["extra"] == {"alert": transition}
