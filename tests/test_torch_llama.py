"""The port's Llama forward, dense decode and int8 weights against the JAX
package on the same converted `tiny` params (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modal_tpu.models import llama as jllama
from modal_tpu.models import quant as jquant
from modal_tpu.models import sampling as jsampling
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.models import quant as tquant
from modal_tpu_torch.models import sampling as tsampling
from modal_tpu_torch.models.convert import params_from_jax

_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    """(jax params, jax cfg, torch params, torch cfg, tolerance)."""
    jcfg = jllama.get_config("tiny", dtype=jnp.dtype(request.param).type)
    tcfg = tllama.get_config("tiny", dtype=_TORCH_DTYPE[request.param])
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tol = 1e-4 if request.param == "float32" else 3e-2
    return jparams, jcfg, tparams, tcfg, tol


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def test_converted_tree_is_bit_exact(model):
    jparams, _jcfg, tparams, _tcfg, _tol = model
    for (path, leaf), tleaf in zip(
        jax.tree_util.tree_flatten_with_path(jparams)[0], jax.tree_util.tree_leaves(tparams)
    ):
        a = np.asarray(leaf)
        b = tleaf.float().numpy() if tleaf.dtype == torch.bfloat16 else tleaf.numpy()
        np.testing.assert_array_equal(a.astype(np.float32), b, err_msg=str(path))


def test_init_params_matches_jax_structure():
    cfg = tllama.get_config("tiny")
    mine = tllama.init_params(cfg, seed=3, device="cpu")
    ref = jax.eval_shape(lambda k: jllama.init_params(jllama.get_config("tiny"), k), jax.random.PRNGKey(0))
    ref_shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), ref)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), mine) == ref_shapes
    assert all(t.dtype == torch.bfloat16 for t in jax.tree_util.tree_leaves(mine))
    again = tllama.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(mine["layers"]["wq"], again["layers"]["wq"])  # seeded


def test_cacheless_forward_matches_jax(model):
    jparams, jcfg, tparams, tcfg, tol = model
    toks = _tokens(tcfg, (2, 24), seed=1)
    jlogits, _ = jllama.forward(jparams, jcfg, jnp.asarray(toks))
    tlogits, _ = tllama.forward(tparams, tcfg, torch.from_numpy(toks))
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=tol, rtol=0)


def test_cache_path_matches_jax(model):
    """Prefill into the dense cache, then three single-token steps."""
    jparams, jcfg, tparams, tcfg, tol = model
    toks = _tokens(tcfg, (1, 10), seed=2)
    jcache = jllama.KVCache.create(jcfg, 1, 32)
    tcache = tllama.KVCache.create(tcfg, 1, 32, device="cpu")
    jl, jcache = jsampling.prefill(jparams, jcfg, jnp.asarray(toks), jcache)
    tl, tcache = tsampling.prefill(tparams, tcfg, torch.from_numpy(toks), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=0)
    tok = int(np.asarray(jl).argmax())
    for _ in range(3):
        jl, jcache = jsampling.decode_step(jparams, jcfg, jnp.asarray([[tok]], jnp.int32), jcache)
        tl, tcache = tsampling.decode_step(tparams, tcfg, torch.tensor([[tok]]), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=0)
        tok = int(np.asarray(jl).argmax())
    assert tcache.length == int(jcache.length) == 13


def test_greedy_generate_chain_matches_jax_fp32():
    jcfg = jllama.get_config("tiny", dtype=jnp.float32)
    tcfg = tllama.get_config("tiny", dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    prompt = _tokens(tcfg, (2, 8), seed=3)
    jout = jsampling.greedy_generate(jparams, jcfg, jnp.asarray(prompt), 16, cache_len=96)
    tout = tsampling.greedy_generate(tparams, tcfg, torch.from_numpy(prompt).long(), 16, cache_len=96)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_greedy_generate_rejects_overflow_and_benchmark_runs():
    cfg = tllama.get_config("debug-1l")
    params = tllama.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="exceeds cache_len"):
        tsampling.greedy_generate(params, cfg, torch.zeros((1, 8), dtype=torch.int64), 10, cache_len=16)
    stats = tsampling.benchmark_decode(params, cfg, batch=2, prompt_len=8, gen_len=4, cache_len=16)
    assert stats["device"] == "cpu" and stats["decode_tokens_per_s"] > 0


def test_quantized_tree_matches_jax():
    """JAX's int8 tree converts leaf for leaf ({"q","s"} included), the
    port's quantizer reproduces it bit for bit, and the forward agrees
    (bf16: the quantized embedding gathers in its bf16 scale's dtype)."""
    jcfg = jllama.get_config("tiny")
    tcfg = tllama.get_config("tiny")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(2))
    jq = jquant.quantize_params(jparams)
    tq = params_from_jax(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    assert tquant.is_quantized(tq["layers"]["wq"]) and tq["layers"]["wq"]["q"].dtype == torch.int8
    mine = tquant.quantize_params(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    assert torch.equal(mine["layers"]["w_up"]["q"], tq["layers"]["w_up"]["q"])
    assert torch.equal(mine["embed"]["s"], tq["embed"]["s"])
    toks = _tokens(tcfg, (1, 16), seed=4)
    jl, _ = jllama.forward(jq, jcfg, jnp.asarray(toks))
    tl, _ = tllama.forward(tq, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=3e-2, rtol=0)


def test_moe_configs_raise():
    """MoE configs initialise and run the forward (test_torch_moe.py holds
    them against JAX); the paged serving engine refuses them with
    ValueError, as the JAX engine does."""
    from modal_tpu_torch.serving import ServingEngine

    cfg = tllama.get_config("tiny-moe")
    params = tllama.init_params(cfg, device="cpu")
    logits, _ = tllama.forward(params, cfg, torch.zeros((1, 4), dtype=torch.long))
    assert logits.shape == (1, 4, cfg.vocab_size)
    with pytest.raises(ValueError, match="MoE"):
        ServingEngine(params, cfg, device="cpu")
