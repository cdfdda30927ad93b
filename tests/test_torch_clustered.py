"""The port's gangs (`@clustered`, the plane's placement, TaskClusterHello
and ClusterList, `runtime/clustered.py`) against the JAX package's, on the
CPU.

Counterparts of tests/test_clustered.py, on the module's two planes
(`tests/test_torch_app.Planes`: each one worker, the port's with 8
simulated cards): the definition's gang fields, the rendezvous (distinct
ranks, the world size, every peer, one coordinator), and, in place of the
JAX gang's psum over `jax.distributed`, a two-rank gloo `all_reduce`
inside the port's containers. The port's own cases: each rank of a
`gpu="H100"` gang pinned to a card of its own, ClusterList, and a gang
that no worker could hold refused with the unsatisfiable-placement text.
The elastic recovery (a rank dies, the gang is torn down, a new gang
resumes from a Volume checkpoint) is marked slow, as JAX's is."""

import os
import tempfile
import time

import pytest

import modal_tpu
import modal_tpu_torch
from tests.test_torch_app import CONTAINER_ENV, Planes

SKIP_ENV = {modal_tpu: "MODAL_TPU_SKIP_JAX_DISTRIBUTED", modal_tpu_torch: "MODAL_TPU_SKIP_TORCH_DISTRIBUTED"}


@pytest.fixture(scope="module")
def planes():
    saved = {k: os.environ.get(k) for k in CONTAINER_ENV}
    os.environ.update(CONTAINER_ENV)
    p = Planes(tempfile.mkdtemp(prefix="gang-", dir="/tmp"))
    try:
        yield p
    finally:
        p.close()
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)


def test_the_gang_fields_land_on_the_definition(planes):
    def scenario(m, client, sup):
        app = m.App("gang-contract")

        def train():
            return "ok"

        ask = {"tpu": "v5p-8"} if m is modal_tpu else {"gpu": "H100"}
        f = app.function(serialized=True, **ask)(m.clustered(size=2, fabric_size=8)(train))
        with app.run(client=client):
            d = sup.state.functions[f.object_id].definition
            return (d.group_size, d.broadcast_inputs, d.fabric_size, f.cluster_size)

    got = planes.both(scenario)
    assert got["port"] == got["jax"] == (2, True, 8, 2)


def test_a_two_rank_gang_meets_at_the_rendezvous(planes, monkeypatch):
    """Both ranks run the input; rank 0's result is the call's; the ranks
    are 0 and 1 of 2, each sees both peers and one coordinator."""
    for name in SKIP_ENV.values():
        monkeypatch.setenv(name, "1")

    def scenario(m, client, sup):
        app = m.App("gang-e2e")

        def rank_report(tag):
            import importlib
            import os

            info = importlib.import_module(tag).get_cluster_info()
            return {"tag": tag, "rank": info.rank, "world": info.world_size, "peers": len(info.container_ips),
                    "coordinator": info.coordinator_address.count(":"), "pid": os.getpid() > 0}

        f = app.function(serialized=True)(m.clustered(size=2)(rank_report))
        with app.run(client=client):
            out = f.remote(m.__name__)
            cluster = list(sup.state.clusters.values())[-1]
            ranks = sorted(sup.state.tasks[t].rank for t in cluster.task_ids)
            reported = len(cluster.reported)
        return {**out, "tag": "", "ranks": ranks, "reported": reported}

    got = planes.both(scenario)
    assert got["port"] == got["jax"] == {"tag": "", "rank": 0, "world": 2, "peers": 2, "coordinator": 1, "pid": True,
                                         "ranks": [0, 1], "reported": 2}


def test_a_gloo_gang_all_reduces_in_its_containers(planes):
    """The port's counterpart of JAX's psum gang: each rank joins the
    gang's process group (gloo: its containers hold no card) and
    all-reduces (rank + 1) x base; rank 0 answers."""
    client, sup = planes.of(modal_tpu_torch)
    app = modal_tpu_torch.App("gang-gloo")

    def allreduce(base):
        import torch
        import torch.distributed as dist

        from modal_tpu_torch import get_cluster_info

        info = get_cluster_info()
        x = torch.full((4,), float(base) * (info.rank + 1))
        dist.all_reduce(x)
        return {"rank": info.rank, "world": dist.get_world_size(), "backend": dist.get_backend(),
                "info_backend": info.backend, "sum": x.tolist()}

    f = app.function(serialized=True, timeout=120)(modal_tpu_torch.clustered(size=2)(allreduce))
    with app.run(client=client):
        out = f.remote(3.0)
    assert out == {"rank": 0, "world": 2, "backend": "gloo", "info_backend": "gloo", "sum": [9.0] * 4}


def test_each_rank_of_a_card_gang_holds_its_own_card(planes, monkeypatch):
    """gpu="H100" per rank: the ranks are pinned to two distinct cards of
    the worker (TaskList), and ClusterList shows the gang."""
    monkeypatch.setenv("MODAL_TPU_SKIP_TORCH_DISTRIBUTED", "1")
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch._utils.grpc_utils import retry_transient_errors
    from modal_tpu_torch.proto import api_pb2

    client, sup = planes.of(modal_tpu_torch)
    app = modal_tpu_torch.App("gang-cards")

    def visible():
        import os

        return os.environ.get("CUDA_VISIBLE_DEVICES", "<unset>")

    f = app.function(serialized=True, gpu="H100")(modal_tpu_torch.clustered(size=2)(visible))
    with app.run(client=client):
        assert f.remote() == ""  # simulated cards: the container sees none
        tasks = synchronizer.run(retry_transient_errors(client.stub.TaskList, api_pb2.TaskListRequest()))
        listed = synchronizer.run(retry_transient_errors(client.stub.ClusterList, api_pb2.ClusterListRequest()))
        mine = [t for t in tasks.tasks if t.app_id == app.app_id]
    assert sorted(t.rank for t in mine) == [0, 1] and len({t.cluster_id for t in mine}) == 1
    cards = [tuple(t.gpu_ids) for t in mine]
    assert all(len(c) == 1 for c in cards) and len(set(cards)) == 2, cards
    gang = next(c for c in listed.clusters if c.cluster_id == mine[0].cluster_id)
    assert (gang.size, gang.ranks_reported, gang.function_tag) == (2, 2, sup.state.functions[f.object_id].tag)
    assert sorted(gang.task_ids) == sorted(t.task_id for t in mine)


def test_a_gang_no_worker_can_hold_is_refused(planes):
    """Two ranks of gpu="H100:8" on a worker of 8 cards: the gang's call
    fails with the unsatisfiable-placement text after the grace window,
    and no rank is launched (JAX queues such an ask forever, Queue C 16)."""
    client, sup = planes.of(modal_tpu_torch)
    app = modal_tpu_torch.App("gang-unsat")

    def never():
        return "ran"

    f = app.function(serialized=True, gpu="H100:8")(modal_tpu_torch.clustered(size=2)(never))
    t0 = time.monotonic()
    with app.run(client=client):
        with pytest.raises(Exception) as exc:
            f.remote()
        tasks = [t for t in sup.state.tasks.values() if t.function_id == f.object_id]
    assert (f"unsatisfiable placement for {sup.state.functions[f.object_id].tag}: gpu=H100:8 for each of 2 ranks "
            "matches no registered worker") in str(exc.value)
    assert not tasks and time.monotonic() - t0 < 60


@pytest.mark.slow  # as JAX's test_gang_elastic_recovery: two gangs of containers, ~20 s
def test_gang_elastic_recovery(planes, tmp_path):
    """Rank 1 dies mid-run: the gang is torn down (its peer PREEMPTED), the
    input requeues, a new gang meets at a fresh rendezvous, restores the
    step from the Volume checkpoint rank 0 wrote, and finishes."""
    from modal_tpu_torch.proto import api_pb2

    client, sup = planes.of(modal_tpu_torch)
    app = modal_tpu_torch.App("gang-elastic")
    crash_marker = str(tmp_path / "crashed-once")

    def train(total_steps):
        import os
        import time as _t

        import torch

        import modal_tpu_torch as mt
        from modal_tpu_torch.checkpoint import VolumeCheckpointer

        info = mt.get_cluster_info()
        vol = mt.Volume.from_name("gang-elastic-ckpt", create_if_missing=True)
        vol.hydrate()
        ckpt = VolumeCheckpointer(vol)
        start = int(ckpt.restore("train/state", device="cpu")["step"]) if ckpt.exists("train/state") else 0
        step = start
        while step < total_steps:
            _t.sleep(0.2)  # a train step
            step += 1
            if info.rank == 0:
                ckpt.save("train/state", {"step": torch.tensor(step)})
            if step == 1 and info.rank == 1 and not os.path.exists(crash_marker):
                while not os.path.exists(crash_marker + ".seen"):  # rank 0 has saved step 1
                    _t.sleep(0.05)
                open(crash_marker, "w").write("x")
                os._exit(1)  # the rank dies mid-run
            if step == 1 and info.rank == 0 and not os.path.exists(crash_marker + ".seen"):
                open(crash_marker + ".seen", "w").write("x")
                _t.sleep(60)  # the teardown, not a SUCCESS, ends this attempt
        return {"rank": info.rank, "start_step": start, "end_step": step}

    f = app.function(serialized=True, retries=1, timeout=180)(modal_tpu_torch.clustered(size=2)(train))
    with app.run(client=client):
        out = f.remote(3)
        gangs = [c for c in sup.state.clusters.values() if c.function_id == f.object_id]
        states = [t.state for t in sup.state.tasks.values() if t.function_id == f.object_id]
    assert out == {"rank": 0, "start_step": 1, "end_step": 3}
    assert os.path.exists(crash_marker)
    assert len(gangs) == 2 and gangs[0].coordinator_port != gangs[1].coordinator_port
    assert api_pb2.TASK_STATE_PREEMPTED in states, states
