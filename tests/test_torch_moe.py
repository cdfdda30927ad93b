"""The port's MoE (modal_tpu_torch/parallel/moe.py and the llama MoE
branch) against the JAX package's, on the CPU, fp32 unless stated: the
switch FFN at one rank and over 8 gloo ranks ({"expert": 4, "fsdp": 2},
one spawn for the file) with a router that overflows an expert, the MoE
llama forward with and without a KV cache, one train step, the int8 tree
and the safetensors checkpoint. The counterparts of tests/test_parallel.py's
MoE tests keep their names."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modal_tpu.models import llama as jllama
from modal_tpu.models import quant as jquant
from modal_tpu.models import weights as jweights
from modal_tpu.parallel import moe as jmoe
from modal_tpu.parallel import train as jtrain
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.models import quant as tquant
from modal_tpu_torch.models import weights as tweights
from modal_tpu_torch.models.convert import params_from_jax, stack_layers, unstack_layers
from modal_tpu_torch.parallel import mesh as tmesh
from modal_tpu_torch.parallel import moe as tmoe
from modal_tpu_torch.parallel import train as ttrain

from . import torch_parallel_workers

# tiny-moe: dim 128, 4 experts of FFN 256; capacity 1.0 with a router that
# prefers expert 0 overflows it
OVERFLOW_CAPACITY = 1.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _overflowing_moe(rng, d=128, f=256, e=4):
    p = {"router": rng.standard_normal((d, e)).astype(np.float32) * 0.1,
         "w_in": rng.standard_normal((e, d, f)).astype(np.float32) * 0.05,
         "w_out": rng.standard_normal((e, f, d)).astype(np.float32) * 0.05}
    p["router"][:, 0] += 0.05  # most tokens pick expert 0
    return p


def _jax_moe(x, p, cf, act=None):
    y, aux, dropped = jmoe.moe_ffn(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p), cf, act=act)
    return np.asarray(y), float(aux), float(dropped)


def _models(name, seed=0):
    jcfg = jllama.get_config(name, dtype=jnp.float32)
    tcfg = tllama.get_config(name, dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jparams, tcfg, params_from_jax(_np(jparams), device="cpu")


@pytest.fixture(scope="module")
def moe_ranks(tmp_path_factory):
    """The switch FFN over 8 gloo ranks, {"expert": 4, "fsdp": 2}, on
    x [4, 32, 128] with the overflowing router."""
    tmp = tmp_path_factory.mktemp("torch_moe")
    rng = np.random.default_rng(11)
    jcfg, jparams, tcfg, tparams = _models("tiny-moe", seed=7)
    tweights.export_checkpoint(tparams, tcfg, str(tmp / "ckpt"), max_shard_bytes=1 << 18)
    inputs = {"moe": _overflowing_moe(rng), "x": rng.standard_normal((4, 32, 128)).astype(np.float32),
              "capacity_factor": OVERFLOW_CAPACITY, "ckpt": str(tmp / "ckpt"), "ckpt_params": _np(jparams)}
    torch.save(inputs, tmp / "in.pt")
    tmesh.spawn(torch_parallel_workers.moe_rank, 8, str(tmp / "in.pt"), str(tmp / "out.pt"))
    return inputs, torch.load(tmp / "out.pt", weights_only=False)


# -- the switch FFN -------------------------------------------------------------------------


def test_moe_ffn_matches_jax_with_overflow_at_one_rank():
    rng = np.random.default_rng(5)
    p = _overflowing_moe(rng)
    x = rng.standard_normal((256, 128)).astype(np.float32)
    jy, jaux, jdrop = _jax_moe(x, p, OVERFLOW_CAPACITY, act=jax.nn.silu)
    ty, taux, tdrop = tmoe.moe_ffn(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                                   OVERFLOW_CAPACITY, act=torch.nn.functional.silu)
    assert 0.0 < jdrop < 1.0  # an expert overflowed
    np.testing.assert_allclose(ty.numpy(), jy, atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(taux), jaux, atol=1e-5, rtol=0)
    assert float(tdrop) == jdrop


def test_moe_ffn_over_8_ranks_matches_jax_with_overflow(moe_ranks):
    """Tokens over fsdp 2 and, inside the FFN, over 4 expert ranks (one
    expert each, all-to-all): JAX's global capacity, queue order, aux and
    dropped fraction."""
    inputs, got = moe_ranks
    x = inputs["x"]
    jy, jaux, jdrop = _jax_moe(x.reshape(-1, x.shape[-1]), inputs["moe"], OVERFLOW_CAPACITY, act=jax.nn.silu)
    assert 0.0 < jdrop < 1.0
    np.testing.assert_allclose(got["y"].reshape(-1, x.shape[-1]).numpy(), jy, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["aux"], jaux, atol=1e-5, rtol=0)
    assert got["dropped"] == jdrop


def test_sharded_load_places_the_moe_checkpoint(moe_ranks):
    """load_params(shardings=param_shardings(mesh), mesh=) on {"expert": 4,
    "fsdp": 2}: every leaf a DTensor whose gathered value is the exported
    tensor, bit for bit, the expert stacks and fsdp dims cut, each rank's
    piece and placements those of shard_params."""
    load = moe_ranks[1]["load"]
    assert load["equal"] and load["sharded"] >= 7 and load["leaves"] == 12


def test_moe_single_expert_equals_plain_ffn():
    params = tmoe.init_moe_params(0, 16, 32, 1, device="cpu")
    x = torch.randn(10, 16, generator=torch.Generator().manual_seed(1))
    y, _aux, dropped = tmoe.moe_ffn(x, params, capacity_factor=2.0)
    gate = torch.softmax(x @ params["router"], -1)[:, 0]
    ref = (torch.nn.functional.gelu(x @ params["w_in"][0], approximate="tanh") @ params["w_out"][0]) * gate[:, None]
    torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-5)
    assert float(dropped) == 0.0


def test_moe_capacity_drops_overflow():
    params = tmoe.init_moe_params(2, 8, 16, 4, device="cpu")
    x = torch.randn(64, 8, generator=torch.Generator().manual_seed(3))
    _y, _aux, dropped = tmoe.moe_ffn(x, params, capacity_factor=0.3)
    assert 0.0 < float(dropped) < 1.0


def test_moe_expert_parallel_demo():
    out = tmoe.moe_demo(n_experts=4, device="cpu")
    assert out["grad_l1"] > 0 and out["aux_loss"] > 0


# -- the MoE llama ----------------------------------------------------------------------------


def test_moe_forward_with_aux_matches_jax():
    """Cache-less and through a KVCache: logits at 1e-4, aux at 1e-5."""
    jcfg, jparams, tcfg, tparams = _models("tiny-moe")
    tokens = np.random.default_rng(2).integers(0, 512, (2, 16)).astype(np.int32)
    jl, _, jaux = jllama.forward_with_aux(jparams, jcfg, jnp.asarray(tokens))
    tl, _, taux = tllama.forward_with_aux(tparams, tcfg, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5, rtol=0)
    jc = jllama.KVCache.create(jcfg, 2, 32)
    tc = tllama.KVCache.create(tcfg, 2, 32, device="cpu")
    for chunk in (slice(0, 10), slice(10, 16)):
        jl, jc, jaux = jllama.forward_with_aux(jparams, jcfg, jnp.asarray(tokens[:, chunk]), cache=jc)
        tl, tc, taux = tllama.forward_with_aux(tparams, tcfg, torch.from_numpy(tokens[:, chunk]).long(), cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5, rtol=0)
    assert tc.length == int(jc.length) == 16


def test_moe_llama_forward_and_loss():
    cfg = tllama.get_config("tiny-moe")
    assert cfg.is_moe and cfg.param_count() > tllama.get_config("tiny").param_count()
    params = tllama.init_params(cfg, seed=0, device="cpu")
    assert params["layers"]["w_in"].shape == (2, 4, 128, 256) and "w_gate" not in params["layers"]
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    logits, _, aux = tllama.forward_with_aux(params, cfg, tokens)
    assert logits.shape == (2, 16, cfg.vocab_size) and float(aux) > 0
    cache = tllama.KVCache.create(cfg, 2, 32, device="cpu")
    _logits, cache, _aux = tllama.forward_with_aux(params, cfg, tokens, cache=cache)
    assert cache.length == 16
    assert {k: tuple(v.shape) for k, v in tllama.init_params_abstract(cfg)["layers"].items()} == {
        k: tuple(v.shape) for k, v in params["layers"].items()
    }


def test_moe_train_step_matches_jax():
    """One fp32 tiny-moe step (the loss adds moe_aux_coef · aux) and then a
    second with lr > 0: loss, grad norm and every param at 1e-4."""
    jcfg, jparams, tcfg, tparams = _models("tiny-moe", seed=4)
    tparams = unstack_layers(tparams)
    for p in ttrain.tree_leaves(tparams):
        p.requires_grad_(True)
    jtc = jtrain.TrainConfig(warmup_steps=1, total_steps=10)
    ttc = ttrain.TrainConfig(warmup_steps=1, total_steps=10)
    jopt, topt = jtrain.make_optimizer(jtc), ttrain.make_optimizer(ttc)
    jstate = jtrain.TrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    tstate = ttrain.TrainState(tparams, topt.init(tparams), 0)
    jstep, tstep = jtrain.make_train_step(jcfg, jtc, jopt), ttrain.make_train_step(tcfg, ttc, topt)
    toks = np.random.default_rng(6).integers(0, 512, (2, 64)).astype(np.int32)
    for _ in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.from_numpy(toks).long())
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    mine = stack_layers(tstate.params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        node = mine
        for key in path:
            node = node[key.key]
        a = np.asarray(leaf)
        assert np.linalg.norm(node.detach().numpy() - a) <= 1e-4 * np.linalg.norm(a), jax.tree_util.keystr(path)


def test_moe_train_demo_on_cpu():
    out = ttrain.train_demo("tiny-moe", steps=2, seq_len=64, device="cpu")
    assert out["step"] == 2.0 and np.isfinite(out["loss"]) and out["loss"] > 0


# -- int8 and checkpoints ---------------------------------------------------------------------


def test_quantize_params_moe_equals_jax():
    """router, w_in and w_out quantize as JAX does: q bit-equal, s equal
    (one scale per expert and output channel for the expert stacks)."""
    jcfg, jparams, _tcfg, tparams = _models("tiny-moe")
    want = _np(jquant.quantize_params(jparams))
    got = tquant.quantize_params(tparams)
    for k in ("router", "w_in", "w_out", "wq"):
        assert tquant.is_quantized(got["layers"][k]), k
        np.testing.assert_array_equal(got["layers"][k]["q"].numpy(), want["layers"][k]["q"])
        np.testing.assert_array_equal(got["layers"][k]["s"].float().numpy(), want["layers"][k]["s"].astype(np.float32))
    assert got["layers"]["w_in"]["s"].shape == (2, 4, 1, 256)


def test_quantized_moe_forward_and_fast_init_equal_jax():
    jcfg = jllama.get_config("tiny-moe")
    tcfg = tllama.get_config("tiny-moe")
    want = _np(jquant.init_params_quantized(jcfg, jax.random.PRNGKey(0), fast_host_init=True))
    got = tquant.init_params_quantized(tcfg, fast_host_init=True, device="cpu")
    for k in ("router", "w_in", "w_out"):
        np.testing.assert_array_equal(got["layers"][k]["q"].numpy(), want["layers"][k]["q"])
    tokens = torch.randint(0, 512, (1, 8), generator=torch.Generator().manual_seed(0))
    logits, _, aux = tllama.forward_with_aux(got, tcfg, tokens)
    assert torch.isfinite(logits).all() and torch.isfinite(aux)


def test_moe_export_is_byte_equal_to_jax_and_loads_back(tmp_path):
    jcfg, jparams, tcfg, tparams = _models("tiny-moe")
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    small = 1 << 18
    jindex = jweights.export_checkpoint(jparams, jcfg, str(jdir), max_shard_bytes=small)
    tindex = tweights.export_checkpoint(tparams, tcfg, str(tdir), max_shard_bytes=small)
    assert tindex == jindex
    assert "model.layers.1.block_sparse_moe.experts.3.w_out.weight" in tindex["weight_map"]
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    for name in names:
        assert filecmp.cmp(jdir / name, tdir / name, shallow=False), name
    for layout in ("stacked", "per_layer"):
        loaded = tweights.load_params(str(jdir), tcfg, device="cpu", layout=layout)
        if layout == "per_layer":
            loaded = stack_layers(loaded)
        for k, v in tparams["layers"].items():
            assert torch.equal(loaded["layers"][k], v), (layout, k)
        assert torch.equal(loaded["embed"], tparams["embed"])
    back = _np(jweights.load_params(str(tdir), jcfg))
    for k, v in back["layers"].items():
        np.testing.assert_array_equal(v, tparams["layers"][k].numpy())


def test_hf_key_map_has_the_expert_names():
    for args in (("w_in", 3, 2), ("w_out", 0, 7)):
        assert tweights.hf_key(args[0], args[1], expert=args[2]) == jweights.hf_key(args[0], args[1], expert=args[2])
    cfg = tllama.get_config("tiny-moe")
    assert tweights.layer_map(cfg) == jweights.layer_map(jllama.get_config("tiny-moe"))


@pytest.mark.cuda
def test_moe_forward_through_the_flash_kernel(cuda_device):
    """bf16 tiny-moe at S 128 on the card: K1 launches once per layer, and
    the logits and the aux loss sit within the bf16 bar of the einsum
    path's. Top-1 routing is discrete: at init tiny-moe's router logits
    spread ~0.2, so the bf16 difference between two attention paths flips
    the expert of nearly tied tokens (0.5% of the logits moved by up to 0.39
    on an H100). The router is scaled 20x here so each token's choice is
    clear and the bar measures the attention path, not the tie-breaks."""
    from modal_tpu_torch.ops import _build

    cfg = tllama.get_config("tiny-moe")
    params = tllama.init_params(cfg, seed=0, device=cuda_device)
    params["layers"]["router"] *= 20
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(0))
    before = _build.LAUNCHES["flash_fwd"]
    logits, _, aux = tllama.forward_with_aux(params, cfg, tokens)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_fwd"] == before + cfg.n_layers
    plain, _, plain_aux = tllama.forward_with_aux(params, cfg, tokens, attn_impl=tllama.attention)
    torch.testing.assert_close(logits, plain, atol=5e-2, rtol=0)
    assert torch.isfinite(aux) and abs(float(aux) - float(plain_aux)) < 5e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")
