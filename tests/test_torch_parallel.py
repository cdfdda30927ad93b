"""The port's mesh training (modal_tpu_torch/parallel) against the JAX
package's, on the CPU: the JAX references on the 8-device CPU mesh of
tests/conftest.py in this process, the port in 8 spawned gloo ranks over
the same mesh shapes (one spawn for the whole file, `ranks` below). Params
go across with `params_from_jax`; tokens and inputs come from numpy seeds.
fp32 throughout. Each test of tests/test_parallel.py has its counterpart
here under the same name."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from modal_tpu.models import llama as jllama
from modal_tpu.parallel import pipeline as jpipeline
from modal_tpu.parallel import ring_attention as jring
from modal_tpu.parallel import sharding as jsharding
from modal_tpu.parallel import train as jtrain
from modal_tpu.parallel import mesh as jmesh
from modal_tpu.parallel.mesh import build_mesh as jbuild_mesh
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.parallel import mesh as tmesh
from modal_tpu_torch.parallel import sharding as tsharding

from . import torch_parallel_workers

WORLD = 8
# (config, mesh) of the create_sharded_state checks against JAX: every
# parallel form
SHARDED_CASES = [
    ("tiny", {"fsdp": 8}),
    ("tiny", {"pipe": 2, "fsdp": 4}),
    ("tiny-moe", {"expert": 4, "fsdp": 2}),
    ("tiny", {"fsdp": 2, "seq": 4}),
    ("tiny", {"data": 2, "fsdp": 2, "model": 2}),
]
# the port only: the MoE model without expert sharding (the EP parity check)
PORT_ONLY_CASES = [("tiny-moe", {"fsdp": 8})]
# batch 16: every pipeline microbatch (4 per 2 stages) divides over fsdp 4
TRAIN_SHAPE = (16, 32)


def _jcfg(name):
    return jllama.get_config(name, dtype=jnp.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)


class _Spawned:
    """The spawn of WORLD gloo ranks, run on a thread while the JAX
    references compute; `result()` waits for it."""

    def __init__(self, inputs: dict, tmp):
        self.inputs, self.out, self.error = inputs, tmp / "out.pt", None
        torch.save(inputs, tmp / "in.pt")

        def run():
            try:
                tmesh.spawn(torch_parallel_workers.parallel_rank, WORLD, str(tmp / "in.pt"), str(self.out))
            except BaseException as e:  # re-raised in the test thread by result()
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        self._result = None

    def result(self) -> dict:
        if self._result is None:
            self.thread.join(timeout=600)
            if self.error is not None:
                raise self.error
            assert not self.thread.is_alive(), "the spawned ranks did not finish"
            self._result = torch.load(self.out, weights_only=False)
        return self._result


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs for every multi-rank check, and the spawn of WORLD gloo ranks
    that runs the port on them (`ranks.result()`)."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    rng = np.random.default_rng(0)
    inputs = {
        "params": {name: _np_tree(jllama.init_params(_jcfg(name), jax.random.PRNGKey(0)))
                   for name in ("tiny", "tiny-moe", "debug-1l")},
        "ring_qkv": rng.standard_normal((3, 2, 32, 4, 16)).astype(np.float32),
        "ring_long": rng.standard_normal((3, 1, 4096, 2, 32)).astype(np.float32),
        "seq_tokens": rng.integers(0, 256, (2, 32)).astype(np.int32),
        "pipe_tokens": rng.integers(0, 512, TRAIN_SHAPE).astype(np.int32),
        "train_tokens": rng.integers(0, 512, TRAIN_SHAPE).astype(np.int32),
        "sharded_cases": SHARDED_CASES + PORT_ONLY_CASES,
    }
    return _Spawned(inputs, tmp)


@pytest.fixture(scope="module")
def jax_sharded(ranks):
    """JAX's create_sharded_state, two steps (lr 0, then 3e-4), per case."""
    inputs = ranks.inputs
    out = {}
    for name, axes in SHARDED_CASES:
        cfg = _jcfg(name)
        tc = jtrain.TrainConfig(warmup_steps=1, total_steps=10)
        mesh = jbuild_mesh(axes)
        with mesh:
            state, step, tok_sh = jtrain.create_sharded_state(mesh, cfg, tc)
            tokens = jax.device_put(jnp.asarray(inputs["train_tokens"]), tok_sh)
            metrics = []
            for _ in range(2):
                state, m = step(state, tokens)
                metrics.append({k: float(v) for k, v in m.items()})
        out[f"{name} {axes}"] = {"metrics": metrics, "params": _np_tree(state.params)}
    return out


# -- mesh and placements -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama3-8b", "tiny-moe", "llama3-8x7b-proxy"])
@pytest.mark.parametrize("pipe", [False, True])
def test_param_specs_equal_jax_partition_specs(name, pipe):
    mine = tsharding.param_specs(tllama.get_config(name), pipe=pipe)
    ref = jsharding.param_specs(jllama.get_config(name), pipe=pipe)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref, is_leaf=lambda x: isinstance(x, P))[0]
    assert len(flat_ref) == len(mine) - 1 + len(mine["layers"])
    for path, spec in flat_ref:
        node = mine
        for key in path:
            node = node[key.key]
        assert node == tuple(spec), (jax.tree_util.keystr(path), node, spec)


def test_build_mesh_remainder_absorbed(ranks):
    got = ranks.result()["mesh"]
    ref = jbuild_mesh({"model": 2})
    assert got["remainder"] == dict(ref.shape)
    assert got["{'model': 3}"].startswith("ValueError") and "need 3 devices, have 8" in got["{'model': 3}"]
    assert "unknown mesh axes" in got["{'bogus': 2}"]
    assert got["logical_batch"] == 3 * 4  # per-device batch × data × fsdp
    assert got["slice"] == dict(jmesh.mesh_from_slice_info(2, 4).shape)
    assert got["single"].startswith("ValueError") and "one rank" in got["single"]


def test_build_mesh_rejects_unknown_axis():
    with pytest.raises(ValueError, match="unknown mesh axes"):
        tmesh.build_mesh({"bogus": 2})


def test_mesh_constraint_refuses_pipe_with_moe():
    from modal_tpu_torch.parallel.mesh import MeshConstraintError, validate_mesh_constraints

    with pytest.raises(MeshConstraintError, match="pipeline"):
        validate_mesh_constraints({"pipe": 2}, tllama.get_config("tiny-moe"))
    with pytest.raises(MeshConstraintError):
        validate_mesh_constraints({"pipe": 2, "expert": 2})
    validate_mesh_constraints({"pipe": 2}, tllama.get_config("tiny"))


def test_placements_follow_the_spec_table():
    """Shard(i) on the mesh dim a tensor dim names (both dims of a tuple
    entry, data outermost), Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    from modal_tpu_torch.parallel.moe import moe_param_shardings

    class FakeMesh:
        mesh_dim_names = tmesh.AXIS_ORDER

    def by_axis(**shards):
        return [shards.get(n, Replicate()) for n in tmesh.AXIS_ORDER]

    assert tsharding.placements(FakeMesh, tsharding.token_spec(True)) == by_axis(data=Shard(0), fsdp=Shard(0), seq=Shard(1))
    w_in = tsharding.param_specs(tllama.get_config("tiny-moe"), pipe=True)["layers"]["w_in"]
    assert tsharding.placements(FakeMesh, w_in) == by_axis(pipe=Shard(0), expert=Shard(1), fsdp=Shard(2), model=Shard(3))
    assert tsharding.placements(FakeMesh, tsharding.batch_spec()) == by_axis(data=Shard(0), fsdp=Shard(0))
    ep = moe_param_shardings(FakeMesh)
    assert ep["router"] == by_axis() and ep["w_in"] == ep["w_out"] == by_axis(expert=Shard(0))


# -- ring attention ------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_ring_attention_matches_full(ranks, n_shards):
    inputs, res = ranks.inputs, ranks.result()
    q, k, v = (jnp.asarray(x) for x in inputs["ring_qkv"])
    full = jring.full_causal_attention(q, k, v)
    mesh = Mesh(np.asarray(jax.devices()[:n_shards]).reshape(n_shards), ("seq",))
    spec = NamedSharding(mesh, P(None, "seq", None, None))
    ring = jring.ring_attention(*(jax.device_put(x, spec) for x in (q, k, v)), mesh)
    got = res["ring"][n_shards]["out"].numpy()
    np.testing.assert_allclose(got, np.asarray(full), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(ring), rtol=1e-4, atol=1e-4)


def test_ring_attention_long_context(ranks):
    """4096 tokens over 8 sequence shards of 512 match full attention."""
    inputs, res = ranks.inputs, ranks.result()
    q, k, v = (jnp.asarray(x) for x in inputs["ring_long"])
    ref = jring.full_causal_attention(q, k, v)
    np.testing.assert_allclose(res["ring"]["long"].numpy(), np.asarray(ref), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_ring_attention_grad_matches_full(ranks, n_shards):
    inputs, res = ranks.inputs, ranks.result()
    q, k, v = (jnp.asarray(x) for x in inputs["ring_qkv"])
    mesh = Mesh(np.asarray(jax.devices()[:n_shards]).reshape(n_shards), ("seq",))

    def loss_ring(q, k, v):
        return jnp.sum(jring.ring_attention(q, k, v, mesh) ** 2)

    def loss_full(q, k, v):
        return jnp.sum(jring.full_causal_attention(q, k, v) ** 2)

    g_ring = jax.jit(jax.grad(loss_ring, argnums=(0, 1, 2)))(q, k, v)
    g_full = jax.jit(jax.grad(loss_full, argnums=(0, 1, 2)))(q, k, v)
    for mine, a, b in zip(res["ring"][n_shards]["grads"], g_ring, g_full):
        np.testing.assert_allclose(mine.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(mine.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_seq_parallel_loss_matches_plain(ranks):
    """Ring attention over 4 sequence shards (fsdp 2 beside) gives JAX's
    plain loss, the next-token shift crossing each shard boundary."""
    inputs, res = ranks.inputs, ranks.result()
    cfg = _jcfg("debug-1l")
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"]["debug-1l"])
    plain = float(jtrain.loss_fn(params, cfg, jnp.asarray(inputs["seq_tokens"]), remat=False))
    np.testing.assert_allclose(res["seq_loss"], plain, rtol=1e-5)


def test_seq_parallel_training_step(ranks):
    m = ranks.result()["train_demo"]
    assert m["loss"] > 0 and m["step"] == 2 and np.isfinite(m["grad_norm"])


# -- pipeline ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_pipeline(ranks):
    """JAX's pipelined loss and grads: tiny, pipe 2, 4 microbatches."""
    inputs = ranks.inputs
    cfg = _jcfg("tiny")
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"]["tiny"])
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pipe",))
    tokens = jnp.asarray(inputs["pipe_tokens"])
    fn = jax.jit(jax.value_and_grad(lambda p: jpipeline.pipeline_loss(p, cfg, tokens, mesh, num_microbatches=4)))
    return fn(params)


def test_pipeline_loss_matches_plain_forward(ranks, jax_pipeline):
    """tiny, pipe 2 (fsdp 4 beside), 4 microbatches: the pipelined loss
    equals JAX's pipelined and plain losses, and the port's plain loss."""
    inputs, res = ranks.inputs, ranks.result()
    jloss, _ = jax_pipeline
    cfg = _jcfg("tiny")
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"]["tiny"])
    plain = float(jtrain.loss_fn(params, cfg, jnp.asarray(inputs["pipe_tokens"]), False))
    np.testing.assert_allclose(res["pipeline"]["loss"], float(jloss), rtol=1e-5)
    np.testing.assert_allclose(res["pipeline"]["loss"], plain, rtol=1e-5)
    np.testing.assert_allclose(res["pipeline"]["plain"], plain, rtol=1e-5)


def test_pipeline_grads_match_jax(ranks, jax_pipeline):
    res = ranks.result()
    _, jgrads = jax_pipeline
    mine = res["pipeline"]["grads"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        node = mine
        for key in path:
            node = node[key.key]
        assert _rel_l2(leaf, node.numpy()) <= 1e-5, jax.tree_util.keystr(path)


def test_pipeline_demo_grad_step(ranks):
    out = ranks.result()["pipeline"]["demo"]
    assert out["loss"] > 0 and out["grad_l1"] > 0


def test_pipeline_rejects_bad_split():
    """3 stages cannot split tiny's 2 layers; MoE is refused before any work."""
    from types import SimpleNamespace

    from modal_tpu_torch.parallel.mesh import MeshConstraintError
    from modal_tpu_torch.parallel.pipeline import pipeline_loss

    plan = SimpleNamespace(sizes={"pipe": 3})
    tokens = torch.ones((4, 16), dtype=torch.long)
    with pytest.raises(ValueError, match="divide"):
        pipeline_loss({}, tllama.get_config("tiny"), tokens, plan, num_microbatches=2)
    with pytest.raises(MeshConstraintError):
        pipeline_loss({}, tllama.get_config("tiny-moe"), tokens, plan, num_microbatches=2)


# -- create_sharded_state against JAX's ------------------------------------------------------


@pytest.mark.parametrize("case", [f"{n} {a}" for n, a in SHARDED_CASES])
def test_sharded_train_steps_match_jax(ranks, jax_sharded, case):
    """Both steps' losses and grad norms at 1e-4, and every param after the
    second step (lr 3e-4) within a global relative L2 of 1e-4."""
    got, ref = ranks.result()["sharded"][case], jax_sharded[case]
    for m, r in zip(got["metrics"], ref["metrics"]):
        np.testing.assert_allclose(m["loss"], r["loss"], rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"], r["grad_norm"], rtol=1e-4)
        assert m["step"] == r["step"]
    flat = jax.tree_util.tree_flatten_with_path(ref["params"])[0]
    diff = ref_sq = 0.0
    for path, leaf in flat:
        node = got["params"]
        for key in path:
            node = node[key.key]
        a = np.asarray(leaf, np.float64)
        diff += float(np.sum((node.numpy().astype(np.float64) - a) ** 2))
        ref_sq += float(np.sum(a**2))
    assert (diff / ref_sq) ** 0.5 <= 1e-4, case


@pytest.mark.parametrize("case", [f"{n} {a}" for n, a in SHARDED_CASES])
def test_optimizer_moments_mirror_param_placements(ranks, case):
    got = ranks.result()["sharded"][case]
    assert got["mirrored"]
    assert got["sharded_leaves"] > 0 or "'fsdp': 8" not in case


@pytest.mark.slow
def test_train_step_fsdp_pp_parity(ranks):
    """FSDP+PP: the first-step loss of the dense FSDP step."""
    sharded = ranks.result()["sharded"]
    dense = sharded["tiny {'fsdp': 8}"]["metrics"][0]["loss"]
    pp = sharded["tiny {'pipe': 2, 'fsdp': 4}"]["metrics"][0]["loss"]
    assert abs(dense - pp) < 1e-3, (dense, pp)


@pytest.mark.slow
def test_train_step_fsdp_ep_parity(ranks):
    """FSDP+EP: the MoE step with experts sharded over `expert` against the
    same model without expert sharding."""
    sharded = ranks.result()["sharded"]
    ep = sharded["tiny-moe {'expert': 4, 'fsdp': 2}"]["metrics"][0]["loss"]
    no_ep = sharded["tiny-moe {'fsdp': 8}"]["metrics"][0]["loss"]
    assert abs(ep - no_ep) < 1e-3, (ep, no_ep)
