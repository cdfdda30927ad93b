"""The port's Volume checkpointer (`modal_tpu_torch/checkpoint.py`) against
the JAX package's, on the CPU.

One control plane per package for the module, each with no worker. The
same tree goes through both checkpointers: `tiny` params from PRNGKey(0),
carried across with `params_from_jax` (fp32 and bf16), and a small tree of
every kind of leaf. Every leaf file must be byte-equal to JAX's, and the
manifests equal but for `treedef` (JAX's restore never reads it). Each
package restores the files the other wrote, bit for bit. Sharded: JAX saves
on a 2-device mesh in process, the port on 2 gloo ranks (`mesh.spawn`),
and their shard files must be byte-equal; the port's 2-rank checkpoint
restores onto 1 and 4 ranks, and JAX's onto the port's 4 ranks, each
rank's pieces equal to the full tree's. A train state saved after two steps
and restored into fresh tensors gives a bit-equal third step. Exact
comparisons throughout: the bytes do not change on the way."""

import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import modal_tpu
import modal_tpu_torch
from modal_tpu._utils.async_utils import synchronizer as jsync
from modal_tpu.checkpoint import VolumeCheckpointer as JaxCheckpointer
from modal_tpu.client import _Client as JaxClient
from modal_tpu.models import llama as jllama
from modal_tpu.parallel.sharding import param_shardings as jax_param_shardings
from modal_tpu.server.supervisor import LocalSupervisor as JaxSupervisor
from modal_tpu_torch._utils.async_utils import synchronizer as tsync
from modal_tpu_torch.checkpoint import VolumeCheckpointer
from modal_tpu_torch.client import _Client
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.models.convert import params_from_jax
from modal_tpu_torch.parallel import mesh as tmesh
from modal_tpu_torch.parallel import train as ttrain
from modal_tpu_torch.server.supervisor import LocalSupervisor

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


class _Planes:
    def __init__(self, root: str):
        self.root = root
        self.jsup = JaxSupervisor(num_workers=0, state_dir=os.path.join(root, "jax"))
        self.tsup = LocalSupervisor(num_workers=0, state_dir=os.path.join(root, "port"))
        jsync.run(self.jsup.start())
        tsync.run(self.tsup.start())
        self.jclient = JaxClient(self.jsup.server_url)
        self.jclient._open()
        self.tclient = _Client(self.tsup.server_url)
        self.tclient._open()

    def volumes(self, name: str):
        jvol = modal_tpu.Volume.from_name(name, create_if_missing=True)
        jvol.hydrate(self.jclient)
        tvol = modal_tpu_torch.Volume.from_name(name, create_if_missing=True)
        tvol.hydrate(self.tclient)
        return jvol, tvol

    def close(self):
        self.jclient._close()
        self.tclient._close()
        jsync.run(self.jsup.stop())
        tsync.run(self.tsup.stop())
        shutil.rmtree(self.root, ignore_errors=True)


@pytest.fixture(scope="module")
def planes():
    p = _Planes(tempfile.mkdtemp(prefix="ckpt-", dir="/tmp"))
    try:
        yield p
    finally:
        p.close()


def _files(vol, path: str) -> dict:
    """Every file under `path` of a volume of either package: name -> bytes."""
    out = {}
    for entry in vol.listdir(path, recursive=True):
        out[entry.path[len(path) + 1:]] = b"".join(vol.read_file(entry.path))
    return out


def _copy(files: dict, vol, path: str) -> None:
    with vol.batch_upload(force=True) as batch:
        for name, data in files.items():
            batch.put_data(data, f"{path}/{name}")


def _manifests_equal(jfiles: dict, tfiles: dict) -> None:
    import json

    jm, tm = json.loads(jfiles.pop("manifest.json")), json.loads(tfiles.pop("manifest.json"))
    assert jm.pop("treedef") and tm.pop("treedef")
    assert tm == jm


def _tiny(dtype: str):
    jdt, tdt = DTYPES[dtype]
    jparams = jllama.init_params(jllama.get_config("tiny", dtype=jdt), jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def _assert_tree_equal(got, want) -> None:
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_tree_equal(a, b)
    else:
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype and torch.equal(got, want)


def _leaf_kinds(m):
    """A tree of every kind of leaf, the same values in both packages: a
    float vector, bf16, int32, a list, a scalar, made from a seed."""
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal(10).astype(np.float32), rng.standard_normal((3, 4)).astype(np.float32)
    c = rng.integers(-9, 9, size=(2, 3)).astype(np.int32)
    if m is modal_tpu:
        return {"a": jnp.asarray(a), "nested": {"b": jnp.asarray(b, jnp.bfloat16), "c": jnp.asarray(c)},
                "l": [jnp.zeros(2), jnp.ones(2)], "s": jnp.asarray(np.float32(2.5))}
    return {"a": torch.from_numpy(a), "nested": {"b": torch.from_numpy(b).to(torch.bfloat16), "c": torch.from_numpy(c)},
            "l": [torch.zeros(2), torch.ones(2)], "s": torch.tensor(2.5)}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_a_tree_saved_by_both_packages_gives_byte_equal_files(planes, dtype):
    jparams, tparams = _tiny(dtype)
    jvol, tvol = planes.volumes(f"plain-{dtype}")
    jm = JaxCheckpointer(jvol).save("run/1", jparams)
    tm = VolumeCheckpointer(tvol).save("run/1", tparams)
    assert len(tm["leaves"]) == len(jm["leaves"]) == 12
    jfiles, tfiles = _files(jvol, "run/1"), _files(tvol, "run/1")
    assert sorted(tfiles) == sorted(jfiles)
    _manifests_equal(jfiles, tfiles)
    assert tfiles == jfiles


def test_every_kind_of_leaf_round_trips_byte_equal(planes):
    jvol, tvol = planes.volumes("kinds")
    JaxCheckpointer(jvol).save("k/1", _leaf_kinds(modal_tpu))
    ck = VolumeCheckpointer(tvol)
    ck.save("k/1", _leaf_kinds(modal_tpu_torch))
    jfiles, tfiles = _files(jvol, "k/1"), _files(tvol, "k/1")
    _manifests_equal(jfiles, tfiles)
    assert tfiles == jfiles
    back = ck.restore("k/1", device="cpu")
    _assert_tree_equal(back, _leaf_kinds(modal_tpu_torch))
    assert isinstance(back["l"], list) and back["nested"]["b"].dtype == torch.bfloat16
    assert ck.exists("k/1") and not ck.exists("k/nope")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_each_package_restores_the_others_files(planes, dtype):
    jparams, tparams = _tiny(dtype)
    jvol, tvol = planes.volumes(f"cross-{dtype}")
    JaxCheckpointer(jvol).save("from-jax", jparams)
    VolumeCheckpointer(tvol).save("from-port", tparams)
    _copy(_files(jvol, "from-jax"), tvol, "from-jax")
    _copy(_files(tvol, "from-port"), jvol, "from-port")
    # the port restores JAX's files; JAX restores the port's, rebuilding its
    # tree from the leaf paths (treedef unread)
    _assert_tree_equal(VolumeCheckpointer(tvol).restore("from-jax", device="cpu"), tparams)
    back = JaxCheckpointer(jvol).restore("from-port")
    for (jp, j), (_, w) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                               jax.tree_util.tree_flatten_with_path(jparams)[0]):
        assert j.dtype == w.dtype and np.array_equal(np.asarray(j), np.asarray(w)), jp


def _jax_two_device_shardings(cfg):
    """JAX shardings over a 2-device mesh with the port mesh's six axes
    (fsdp 2), so both sides cut every leaf alike."""
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(1, 1, 1, 2, 1, 1), tmesh.AXIS_ORDER)
    return jax_param_shardings(mesh, cfg)


def _spawn(fn, world: int, *args) -> None:
    tmesh.spawn(fn, world, *args)


@pytest.fixture(scope="module")
def sharded(planes):
    """The tiny bf16 tree saved sharded by JAX on 2 devices and by the port
    on 2 gloo ranks, into volumes of the same name."""
    from tests import torch_checkpoint_workers as workers

    jcfg = jllama.get_config("tiny", dtype=jnp.bfloat16)
    jparams, tparams = _tiny("bf16")
    tree_file = os.path.join(planes.root, "tree.pt")
    torch.save(tparams, tree_file)
    jvol, tvol = planes.volumes("sharded")
    sh = _jax_two_device_shardings(jcfg)
    placed = jax.tree_util.tree_map(lambda a, s: jax.device_put(a, s), jparams, sh)
    jm = JaxCheckpointer(jvol).save("sh/1", placed, shard_leaves_over=0)
    _spawn(workers.save_sharded, 2, planes.tsup.server_url, "sharded", "sh/1", tree_file)
    return {"jvol": jvol, "tvol": tvol, "jm": jm, "tree_file": tree_file, "tparams": tparams}


def test_a_two_rank_sharded_save_matches_jax_file_for_file(sharded):
    jfiles, tfiles = _files(sharded["jvol"], "sh/1"), _files(sharded["tvol"], "sh/1")
    assert any(".s" in name for name in tfiles), sorted(tfiles)
    assert sum(len(m.get("shards", ())) > 1 for m in sharded["jm"]["leaves"]) >= 8
    assert sorted(tfiles) == sorted(jfiles)
    _manifests_equal(jfiles, tfiles)
    assert tfiles == jfiles


@pytest.mark.parametrize("world", [1, 4])
def test_a_two_rank_checkpoint_regrids_onto_other_ranks(sharded, planes, world):
    from tests import torch_checkpoint_workers as workers

    out = os.path.join(planes.root, f"regrid-{world}")
    _spawn(workers.restore_sharded, world, planes.tsup.server_url, "sharded", "sh/1", sharded["tree_file"], out)
    for rank in range(world):
        checks = torch.load(f"{out}.{rank}")
        assert len(checks) == 12 and all(checks.values()), (rank, checks)


def test_the_port_regrids_jax_shards_and_jax_the_ports(sharded, planes):
    """JAX's 2-device shards onto 4 gloo ranks of the port, and the port's
    2-rank shards onto JAX's 8-device fsdp x model mesh."""
    from modal_tpu.parallel.mesh import build_mesh
    from tests import torch_checkpoint_workers as workers

    jfiles = _files(sharded["jvol"], "sh/1")
    _copy(jfiles, sharded["tvol"], "from-jax")
    out = os.path.join(planes.root, "regrid-jax")
    _spawn(workers.restore_sharded, 4, planes.tsup.server_url, "sharded", "from-jax", sharded["tree_file"], out)
    for rank in range(4):
        assert all(torch.load(f"{out}.{rank}").values()), rank
    _copy(_files(sharded["tvol"], "sh/1"), sharded["jvol"], "from-port")
    jcfg = jllama.get_config("tiny", dtype=jnp.bfloat16)
    sh = jax_param_shardings(build_mesh({"fsdp": 4, "model": 2}), jcfg)
    back = JaxCheckpointer(sharded["jvol"]).restore("from-port", shardings=sh)
    want = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    assert back["layers"]["wq"].sharding == sh["layers"]["wq"]
    for (jp, j), (_, w) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                               jax.tree_util.tree_flatten_with_path(want)[0]):
        assert np.array_equal(np.asarray(j).view(np.uint16), np.asarray(w).view(np.uint16)), jp


def test_a_train_state_restored_into_fresh_tensors_steps_bit_equal(planes):
    """Two fp32 `tiny` train steps, the state (params, AdamW's moments and
    count, the step) saved and restored into fresh tensors: every tensor
    bit-equal, and the third step's loss, grad norm and params equal to the
    live state's."""
    cfg = tllama.get_config("tiny", dtype=torch.float32)
    tc = ttrain.TrainConfig(warmup_steps=2, total_steps=10, remat=False)
    state, step_fn = ttrain.create_state(cfg, tc, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, size=(2, 32)))
    for _ in range(2):
        state, _m = step_fn(state, tokens)
    _jvol, tvol = planes.volumes("train-state")
    ck = VolumeCheckpointer(tvol)
    live_tree = ttrain.state_tree(state)
    ck.save("ts/2", live_tree)
    back = ck.restore("ts/2", device="cpu")
    _assert_tree_equal(back, live_tree)
    restored = ttrain.state_from_tree(back, tc)
    assert restored.step == 2
    live_next, live_m = step_fn(state, tokens)
    back_next, back_m = step_fn(restored, tokens)
    assert torch.equal(back_m["loss"], live_m["loss"]) and torch.equal(back_m["grad_norm"], live_m["grad_norm"])
    _assert_tree_equal(back_next.params, live_next.params)
