"""The port's sharded control plane (server/shards.py): three in-process
shards behind the placement director, with `worker_gpu_type="local-sim"`
and a 0.2 s health loop, as the JAX package's tests/test_shards.py runs
its own. A map routes through the shard map; the kill of its home shard,
between maps or mid-map (chaos `shard_kill`), is fenced, taken over from
the survivors' replica streams and completes exactly once; a false death
is fenced before its partition is adopted; a director restart is ridden
out; the journal CLI and the topology files see every shard; with
MODAL_TPU_JOURNAL_REPLICAS=0 the takeover replays the dead shard's own
journal; and `python -m modal_tpu_torch.server --shards 2` boots one."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import pytest

import modal_tpu_torch
from modal_tpu_torch._utils.async_utils import synchronizer
from modal_tpu_torch._utils.shard_routing import partition_for_name
from modal_tpu_torch.client import _Client
from modal_tpu_torch.server.shards import ShardedSupervisor

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _boot(chaos=None):
    state = os.path.join(tempfile.mkdtemp(prefix="shards-", dir="/tmp"), "state")
    sup = ShardedSupervisor(num_shards=3, num_workers=3, state_dir=state, worker_gpus=8,
                            worker_gpu_type="local-sim", health_interval_s=0.2, chaos=chaos)
    synchronizer.run(sup.start())
    client = _Client(sup.server_url)
    client._open()
    client.hello()
    _Client.set_env_client(client)
    return sup, client


@pytest.fixture
def sharded(monkeypatch):
    monkeypatch.delenv("MODAL_TPU_JOURNAL_REPLICAS", raising=False)
    sup, client = _boot()
    sup.test_client = client
    try:
        yield sup
    finally:
        _Client.set_env_client(None)
        client._close()
        synchronizer.run(sup.stop())


def _wait_for(predicate, timeout_s: float = 30.0, what: str = "condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _takeover_of(sup, index: int) -> dict:
    _wait_for(lambda: any(e["dead_shard"] == index for e in sup.takeover_log), what=f"takeover of shard {index}")
    (entry,) = [e for e in sup.takeover_log if e["dead_shard"] == index]
    return entry


def _double_app(name: str, sleep_s: float = 0.0, **kw):
    app = modal_tpu_torch.App(name)

    def double(x):
        import time as _t

        _t.sleep(sleep_s)
        return x * 2

    return app, app.function(serialized=True, **kw)(double)


def test_sharded_map_kill_takeover_exactly_once(sharded):
    """Maps route through the shard map; a kill of the app's home shard is
    fenced and its partition adopted by a sibling from the replica streams;
    a later map completes exactly once on the successor, on the rehomed
    worker."""
    client = sharded.test_client
    app, f = _double_app("shard-e2e")
    with app.run(client=client):
        assert sorted(f.map(range(24))) == [x * 2 for x in range(24)]
    assert type(client._stub).__name__ == "ShardRouterStub" and len(client._stub.shard_urls) == 3
    home = partition_for_name("shard-e2e", 3)
    dead_worker = sharded.shards[home].workers[0]
    synchronizer.run(sharded.kill_shard(home))
    entry = _takeover_of(sharded, home)
    assert sharded.epoch == entry["epoch"] == 2 and entry["mode"] == "replica"
    assert entry["report"]["records_applied"] > 0 and sharded.shards[home].fenced
    assert list(entry["phases"]) == ["start", "fence", "seal", "adopt", "remap", "rehome"]
    successor = sharded.shards[entry["successor"]]
    assert dead_worker.server_url == successor.server_url
    with app.run(client=client):
        assert sorted(f.map(range(10))) == [x * 2 for x in range(10)]


def test_a_kill_mid_map_delivers_every_index_once(monkeypatch):
    """chaos `shard_kill` lands on the home shard between a map's outputs
    (one container at a time): the map's output stream, forwarded by the
    director, is severed with the shard, and the client finishes the map on
    the successor with every index once."""
    from modal_tpu_torch.chaos import ChaosEvent, ChaosPolicy

    monkeypatch.delenv("MODAL_TPU_JOURNAL_REPLICAS", raising=False)
    home = partition_for_name("shard-mid", 3)
    policy = ChaosPolicy(events=[ChaosEvent(kind="shard_kill", after_outputs=3, shard_index=home)])
    sup, client = _boot(policy)
    try:
        app, f = _double_app("shard-mid", sleep_s=0.4, max_containers=1)
        with app.run(client=client):
            got = list(f.map(range(8)))
        assert got == [x * 2 for x in range(8)]
        entry = _takeover_of(sup, home)
        assert entry["mode"] == "replica" and policy.events[0].fired
        calls = [c for c in sup.shards[entry["successor"]].state.function_calls.values()
                 if c.function_id == f.object_id]
        (call,) = calls
        assert call.num_done == call.num_inputs == 8 and sorted(o.idx for o in call.outputs) == list(range(8))
    finally:
        _Client.set_env_client(None)
        client._close()
        synchronizer.run(sup.stop())


def test_false_death_fences_before_adopt(sharded):
    """A live shard cut off the director's probes (the shape of
    `shard_partition`) is fenced before its partition is adopted, and stays
    out of the map when the cut heals."""
    victim = 2
    sharded.partitioned_until[victim] = time.monotonic() + 60.0
    entry = _takeover_of(sharded, victim)
    sup = sharded.shards[victim]
    assert sup.fenced and sup.fenced_at_epoch == sharded.epoch == entry["epoch"]
    sharded.partitioned_until[victim] = 0.0
    time.sleep(3 * sharded.health_interval_s)
    assert sharded.assignments[victim] != victim


def test_director_restart_rides_client_redial(sharded):
    client = sharded.test_client
    app, f = _double_app("director-bounce")
    with app.run(client=client):
        assert sorted(f.map(range(6))) == [x * 2 for x in range(6)]
    synchronizer.run(sharded.restart_director())
    with app.run(client=client):
        assert sorted(f.map(range(6))) == [x * 2 for x in range(6)]


def test_journal_cli_shard_aware(sharded):
    """`journal status` sums up every shard journal and its replica streams;
    `journal compact` refuses while a shard is live."""
    from click.testing import CliRunner

    from modal_tpu_torch.cli.entry_point import journal_compact, journal_status

    app, f = _double_app("cli-shards")
    with app.run(client=sharded.test_client):
        assert sorted(f.map(range(4))) == [0, 2, 4, 6]
    runner = CliRunner()
    res = runner.invoke(journal_status, ["--state-dir", sharded.state_dir, "--json"])
    assert res.exit_code == 0, res.output
    payload = json.loads(res.output)
    assert len(payload["shards"]) == 3 and payload["replication"] == {"replicas": 2, "quorum_acks_needed": 1}
    home = partition_for_name("cli-shards", 3)
    writers = {s["writer"] for st in payload["shards"] for s in st["replica_streams"]}
    assert home in writers
    human = runner.invoke(journal_status, ["--state-dir", sharded.state_dir])
    assert human.exit_code == 0 and "3 shard journal(s)" in human.output and "replica of shard-" in human.output
    res = runner.invoke(journal_compact, ["--state-dir", sharded.state_dir])
    assert res.exit_code != 0 and "shard" in res.output


def test_shard_topology_persisted(sharded):
    with open(os.path.join(sharded.state_dir, "shards.json")) as fh:
        shards = json.load(fh)["shards"]
    assert len(shards) == 3 and all(s["url"].startswith("grpc://") and s["state_dir"] for s in shards)
    with open(os.path.join(sharded.state_dir, "director.json")) as fh:
        director = json.load(fh)
    assert director["director"] == sharded.server_url
    assert (director["epoch"], director["assignments"]) == (sharded.epoch, sharded.assignments)


def test_shard_control_status_through_the_director(sharded):
    """The director answers ShardControl status with the topology; a
    sharded hello blanks the input plane and the control socket."""
    from modal_tpu_torch.proto import api_pb2

    client = sharded.test_client
    resp = synchronizer.run(client._stub.ShardControl(api_pb2.ShardControlRequest(action="status")))
    topo = json.loads(resp.payload_json)
    assert topo["num_shards"] == 3 and topo["assignments"] == [0, 1, 2] and topo["epoch"] == 1
    hello = synchronizer.run(client._stub.director.ClientHello(api_pb2.ClientHelloRequest()))
    assert (hello.input_plane_url, hello.uds_path, hello.input_plane_uds_path) == ("", "", "")
    assert json.loads(hello.shard_map_json)["urls"] == sharded.shard_urls
    assert client.input_plane_url is None


def test_replicas_zero_takes_over_from_the_dead_shards_journal(monkeypatch):
    """With MODAL_TPU_JOURNAL_REPLICAS=0 no shard holds a replica stream, and
    the takeover replays the dead shard's own journal (mode "journal")."""
    monkeypatch.setenv("MODAL_TPU_JOURNAL_REPLICAS", "0")
    sup, client = _boot()
    try:
        assert all(s.replica_store is None and s.state.replicator is None for s in sup.shards)
        app, f = _double_app("shard-journal")
        with app.run(client=client):
            assert sorted(f.map(range(6))) == [x * 2 for x in range(6)]
        home = partition_for_name("shard-journal", 3)
        synchronizer.run(sup.kill_shard(home))
        entry = _takeover_of(sup, home)
        assert entry["mode"] == "journal" and entry["report"]["records_applied"] > 0
        assert "seal" not in entry["phases"]
        with app.run(client=client):
            assert sorted(f.map(range(6))) == [x * 2 for x in range(6)]
    finally:
        _Client.set_env_client(None)
        client._close()
        synchronizer.run(sup.stop())


def test_the_server_module_boots_a_sharded_plane(tmp_path):
    """`python -m modal_tpu_torch.server --shards 2` serves a director whose
    hello carries a two-owner shard map."""
    from modal_tpu_torch._utils.grpc_utils import find_free_port

    port = find_free_port()
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, MODAL_TPU_WORKER_GPU_TYPE="local-sim",
               MODAL_TPU_WORKER_NUM_GPUS="1")
    state = tempfile.mkdtemp(prefix="shards-main-", dir="/tmp")
    proc = subprocess.Popen([sys.executable, "-m", "modal_tpu_torch.server", "--port", str(port), "--shards", "2",
                             "--workers", "2", "--state-dir", state], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        deadline = time.monotonic() + 60
        while "listening" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "the server exited"
        client = _Client(f"grpc://127.0.0.1:{port}")
        client._open()
        try:
            client.hello()
            assert type(client._stub).__name__ == "ShardRouterStub" and len(client._stub.shard_urls) == 2
        finally:
            client._close()
        with open(os.path.join(state, "shards.json")) as fh:
            assert [s["index"] for s in json.load(fh)["shards"]] == [0, 1]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
