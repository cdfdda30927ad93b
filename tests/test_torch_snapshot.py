"""The port's warm-state snapshots (`runtime/snapshot.py`) against the JAX
package's (`modal_tpu/runtime/snapshot.py`), on the CPU.

The same `tiny` params (PRNGKey(0), carried across with `params_from_jax`)
go through JAX's `save_snapshot` as jax arrays and the port's as tensors,
in fp32 and bf16, beside a numpy leaf and pickled leaves: every leaf file
must be byte-equal, the manifests' leaf entries equal (the treedef and the
pickle bytes aside: both packages pickle with cloudpickle, each through its
own serialization module and tree types), and the snapshot keys equal. Then
the port's own contract: a CPU restore is bit-equal and keeps each leaf's
kind, a lambda, a closure and a local class are kept as under JAX, state
that cloudpickle refuses (a lock) abandons the snapshot without a trace, a DTensor leaf recorded on a larger mesh than
the process group keeps the snapshot, a restore never applies partially.
The `cuda` case streams leaves through the pinned staging buffers."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modal_tpu.models import llama as jllama
from modal_tpu.proto import api_pb2
from modal_tpu.runtime import snapshot as jsnap
from modal_tpu_torch.models.convert import params_from_jax
from modal_tpu_torch.parallel import mesh as tmesh
from modal_tpu_torch.runtime import snapshot as tsnap

DTYPES = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
FUNCTION = api_pb2.Function(function_name="Model", module_name="app", enable_memory_snapshot=True)


class Instance:
    """A service instance: what the snap-enter hooks set lives on it."""


def _jax_params(dtype):
    cfg = jllama.get_config("tiny", dtype=DTYPES[dtype])
    return jllama.init_params(cfg, jax.random.PRNGKey(0))


def _instances(dtype):
    jparams = _jax_params(dtype)
    table = np.arange(12, dtype=np.int32).reshape(3, 4)
    extra = {"name": "m", "n": 8, "pair": (1.5, None, "x")}
    j, t = Instance(), Instance()
    j.params, j.table, j.meta = jparams, table, extra
    t.params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    t.table, t.meta = table.copy(), extra
    return j, t


def _save_both(tmp_path, monkeypatch, dtype):
    j, t = _instances(dtype)
    monkeypatch.setenv("MODAL_TPU_SNAPSHOT_DIR", str(tmp_path / "jax"))
    assert jsnap.save_snapshot(FUNCTION, j)
    monkeypatch.setenv("MODAL_TPU_SNAPSHOT_DIR", str(tmp_path / "port"))
    assert tsnap.save_snapshot(FUNCTION, t)
    key = tsnap.snapshot_key(FUNCTION)
    return t, tmp_path / "jax" / key, tmp_path / "port" / key


def test_snapshot_key_is_the_jax_key():
    """A message (deterministic serialization) and its bytes give JAX's key."""
    key = jsnap.snapshot_key(FUNCTION)
    assert tsnap.snapshot_key(FUNCTION) == key
    assert tsnap.snapshot_key(FUNCTION.SerializeToString(deterministic=True)) == key
    other = api_pb2.Function(function_name="Model", module_name="app2")
    assert tsnap.snapshot_key(other) == jsnap.snapshot_key(other) != key


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_leaf_files_and_manifest_equal_jax(tmp_path, monkeypatch, dtype):
    _t, jdir, tdir = _save_both(tmp_path, monkeypatch, dtype)
    bins = sorted(f for f in os.listdir(jdir) if f.endswith(".bin"))
    assert bins == sorted(f for f in os.listdir(tdir) if f.endswith(".bin"))
    assert len(bins) == len(jax.tree_util.tree_leaves(_jax_params(dtype))) + 1  # + the numpy table
    for name in bins:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
    jm = json.loads((jdir / "manifest.json").read_text())
    tm = json.loads((tdir / "manifest.json").read_text())
    assert list(jm["attrs"]) == list(tm["attrs"]) == ["params", "table", "meta"]

    def leaves(entry):
        return [{k: v for k, v in leaf.items() if k != "data"} for leaf in entry["leaves"]]

    for name in jm["attrs"]:
        assert leaves(tm["attrs"][name]) == leaves(jm["attrs"][name]), name
    dt = "bfloat16" if dtype == "bf16" else "float32"
    assert {leaf["dtype"] for leaf in tm["attrs"]["params"]["leaves"]} == {dt}
    assert tm["attrs"]["table"]["devices"] == ["numpy"]
    assert set(tm["attrs"]["params"]["devices"]) == {"cpu"}
    assert tm["attrs"]["meta"]["devices"] == [None] * 4  # n, name, and the pair's 1.5 and "x"


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_restore_is_bit_equal(tmp_path, monkeypatch, dtype):
    """Every tensor comes back on the CPU, bit for bit, with its dtype; the
    numpy leaf stays numpy; the tree (tuple with None) is rebuilt."""
    t, _jdir, _tdir = _save_both(tmp_path, monkeypatch, dtype)
    got = Instance()
    assert tsnap.restore_snapshot(FUNCTION, got)
    assert got.meta == t.meta and isinstance(got.meta["pair"], tuple)
    assert isinstance(got.table, np.ndarray) and np.array_equal(got.table, t.table)
    flat_want, flat_got = [], []
    tsnap._flatten(t.params, flat_want)
    tsnap._flatten(got.params, flat_got)
    assert len(flat_got) == len(flat_want) > 0
    for a, b in zip(flat_want, flat_got):
        assert b.device.type == "cpu" and b.dtype == a.dtype and b.shape == a.shape
        assert torch.equal(a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8))


def test_flatten_follows_jax_pytree_rules():
    from collections import OrderedDict, defaultdict, namedtuple

    Pair = namedtuple("Pair", "a b")
    tree = {"z": [1, (2, None)], "a": OrderedDict([("y", 3), ("b", 4)]),
            "m": defaultdict(list, {"k2": 5, "k1": 6}), "p": Pair(7, {"q": 8}), "s": "leaf"}
    leaves: list = []
    treedef = tsnap._flatten(tree, leaves)
    assert leaves == jax.tree_util.tree_leaves(tree)
    back = tsnap._unflatten(treedef, iter(leaves))
    assert back == tree and type(back["a"]) is OrderedDict and type(back["p"]) is Pair
    assert back["m"].default_factory is list


def test_unpicklable_state_abandons_without_a_trace(tmp_path, monkeypatch):
    """What cloudpickle also refuses (a lock) abandons the snapshot; nothing
    stays behind, and a restore finds nothing."""
    import threading

    monkeypatch.setenv("MODAL_TPU_SNAPSHOT_DIR", str(tmp_path))
    for bad in (threading.Lock(), threading.RLock()):
        inst = Instance()
        inst.w = torch.arange(4.0)
        inst.bad = {"h": bad}
        assert tsnap.save_snapshot(FUNCTION, inst) is False
        assert os.listdir(tmp_path) == []
        assert tsnap.restore_snapshot(FUNCTION, Instance()) is False


def test_lambdas_closures_and_local_classes_are_kept_as_under_jax(tmp_path, monkeypatch):
    """The port pickles the treedef and non-array leaves with its cloudpickle
    serialization, as JAX does: a lambda, a closure and an instance of a
    local class save and restore (in both packages), and still work."""
    scale = 3.0

    def closure(x):
        return x * scale

    class Local:
        def __init__(self, k):
            self.k = k

        def twice(self):
            return 2 * self.k

    def state(inst, tensor):
        inst.w = tensor
        inst.hooks = {"lam": lambda x: x + 1, "clo": closure}
        inst.local = Local(5)
        return inst

    monkeypatch.setenv("MODAL_TPU_SNAPSHOT_DIR", str(tmp_path / "jax"))
    assert jsnap.save_snapshot(FUNCTION, state(Instance(), jnp.arange(4.0)))
    jgot = Instance()
    assert jsnap.restore_snapshot(FUNCTION, jgot)
    monkeypatch.setenv("MODAL_TPU_SNAPSHOT_DIR", str(tmp_path / "port"))
    assert tsnap.save_snapshot(FUNCTION, state(Instance(), torch.arange(4.0)))
    got = Instance()
    assert tsnap.restore_snapshot(FUNCTION, got)
    for g in (jgot, got):
        assert g.hooks["lam"](1) == 2 and g.hooks["clo"](2.0) == 6.0 and g.local.twice() == 10
    assert torch.equal(got.w, torch.arange(4.0))
    with open(os.path.join(tmp_path / "port", tsnap.snapshot_key(FUNCTION), "manifest.json")) as f:
        assert [e["kind"] for e in json.load(f)["attrs"]["hooks"]["leaves"]] == ["pickle", "pickle"]


def test_a_save_across_ranks_is_abandoned(tmp_path, monkeypatch):
    monkeypatch.setenv("MODAL_TPU_SNAPSHOT_DIR", str(tmp_path))
    monkeypatch.setattr(tsnap, "_world_size", lambda: 2)
    inst = Instance()
    inst.w = torch.arange(4.0)
    assert tsnap.save_snapshot(FUNCTION, inst) is False
    assert os.listdir(tmp_path) == []


@pytest.fixture
def one_rank_group():
    tmesh.init_process_group("cpu")
    try:
        yield tmesh.build_mesh({})
    finally:
        torch.distributed.destroy_process_group()


def test_dtensor_leaf_round_trip_and_a_larger_mesh_keeps_it(tmp_path, monkeypatch, one_rank_group):
    """A DTensor records JAX's sharding schema; a group that can host the
    mesh restores it; a mesh larger than the group (or no group at all)
    raises _ShardingUnavailable and the snapshot stays on disk."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    monkeypatch.setenv("MODAL_TPU_SNAPSHOT_DIR", str(tmp_path))
    mesh = one_rank_group
    placements = [Shard(0) if n == "fsdp" else Shard(1) if n == "model" else Replicate()
                  for n in mesh.mesh_dim_names]
    full = torch.arange(24.0).reshape(4, 6)
    inst = Instance()
    inst.w = DTensor.from_local(full.clone(), mesh, placements, run_check=False)
    assert tsnap.save_snapshot(FUNCTION, inst)
    snap_dir = tmp_path / tsnap.snapshot_key(FUNCTION)
    manifest = json.loads((snap_dir / "manifest.json").read_text())
    meta = manifest["attrs"]["w"]["leaves"][0]["sharding"]
    assert meta == {"kind": "named", "axis_names": list(mesh.mesh_dim_names), "mesh_shape": [1] * 6,
                    "spec": ["fsdp", "model"]}
    got = Instance()
    assert tsnap.restore_snapshot(FUNCTION, got)
    assert isinstance(got.w, DTensor) and tuple(got.w.placements) == tuple(placements)
    assert torch.equal(got.w.to_local(), full)

    meta["mesh_shape"] = [1, 1, 1, 2, 1, 1]
    (snap_dir / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(tsnap._ShardingUnavailable, match="over 2 ranks; only 1"):
        tsnap._restore_mesh(meta, {})
    assert tsnap.restore_snapshot(FUNCTION, Instance()) is False
    assert (snap_dir / "manifest.json").exists(), "an unhostable snapshot must stay on disk"


def test_restore_never_applies_partially(tmp_path, monkeypatch):
    """A torn leaf file fails the whole restore: no attribute is set, and the
    worthless snapshot is dropped. A snapshot the JAX package wrote under
    the same key is not the port's to restore, and stays."""
    monkeypatch.setenv("MODAL_TPU_SNAPSHOT_DIR", str(tmp_path))
    inst = Instance()
    inst.a = torch.arange(6.0)
    inst.b = torch.ones(3, 3, dtype=torch.bfloat16)
    assert tsnap.save_snapshot(FUNCTION, inst)
    snap_dir = tmp_path / tsnap.snapshot_key(FUNCTION)
    (snap_dir / "b.0.bin").write_bytes(b"\0" * 7)
    target = Instance()
    target.a = "before"
    assert tsnap.restore_snapshot(FUNCTION, target) is False
    assert vars(target) == {"a": "before"}
    assert not snap_dir.exists()

    j = Instance()
    j.w = jnp.arange(4.0)
    assert jsnap.save_snapshot(FUNCTION, j)
    assert tsnap.restore_snapshot(FUNCTION, target) is False
    assert (snap_dir / "manifest.json").exists() and vars(target) == {"a": "before"}


@pytest.mark.cuda
def test_cuda_leaves_stream_through_the_staging_buffers(tmp_path, monkeypatch):
    """On the card: leaves larger than a staging chunk (shrunk to 4 KiB
    here) go out and back in several chunks, bit for bit, and come back on
    the card; CPU leaves come back on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (pinned staging and the device copies)")
    monkeypatch.setenv("MODAL_TPU_SNAPSHOT_DIR", str(tmp_path))
    monkeypatch.setattr(tsnap, "CHUNK_BYTES", 4096)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inst = Instance()
    inst.params = {"w": torch.randn(37, 1001, device="cuda", generator=gen).to(torch.bfloat16),
                   "b": torch.randn(5, device="cuda", generator=gen), "host": torch.arange(9)}
    assert tsnap.save_snapshot(FUNCTION, inst)
    got = Instance()
    assert tsnap.restore_snapshot(FUNCTION, got)
    torch.cuda.synchronize()
    for k, t in inst.params.items():
        assert got.params[k].device.type == t.device.type and got.params[k].dtype == t.dtype, k
        assert torch.equal(got.params[k].view(-1).view(torch.uint8), t.view(-1).view(torch.uint8)), k
