"""The port's training step against the JAX package's (CPU): the optax
pieces it re-implements, three fp32 train steps on `tiny`, one step through
the flash attention Function on both sides, and the layouts and loss it
adds to the model."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from modal_tpu.models import llama as jllama
from modal_tpu.ops.attention import flash_attention_causal as jax_flash_attention_causal
from modal_tpu.parallel import train as jtrain
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.models.convert import params_from_jax, stack_layers, unstack_layers
from modal_tpu_torch.observability import catalog
from modal_tpu_torch.observability.device_telemetry import StepTimer, sample_device_memory
from modal_tpu_torch.ops.attention import flash_attention_causal
from modal_tpu_torch.parallel import train as ttrain


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def _models(name, seed=0):
    """fp32 JAX params and the same values as the port's training layout
    (per-layer leaves requiring grad)."""
    jcfg = jllama.get_config(name, dtype=jnp.float32)
    tcfg = tllama.get_config(name, dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = unstack_layers(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    for p in ttrain.tree_leaves(tparams):
        p.requires_grad_(True)
    return jcfg, jparams, tcfg, tparams


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(v) for v in tree]
    return tree.grad


def _assert_trees_close(jtree, ttree, rtol, what):
    """Every JAX leaf against the port's leaf at the same key path, by the
    relative L2 error of the tensor."""
    ttree = stack_layers(ttree) if isinstance(ttree["layers"], list) else ttree
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        t = ttree
        for key in path:
            t = t[key.key]
        a, b = np.asarray(leaf, np.float32), t.detach().float().numpy()
        err = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)
        assert err <= rtol, f"{what} {jax.tree_util.keystr(path)}: relative error {err:.3e}"


# -- the optax pieces -------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(10, 100), (2, 10), (0, 50)])
def test_schedule_matches_optax(warmup, total):
    tc = ttrain.TrainConfig(warmup_steps=warmup, total_steps=total)
    mine = ttrain.make_optimizer(tc).schedule
    ref = optax.warmup_cosine_decay_schedule(0.0, tc.learning_rate, warmup, total, tc.learning_rate * 0.1)
    for step in sorted({0, 1, warmup, warmup + 1, total // 2, total, total + 7}):
        np.testing.assert_allclose(mine(step), float(ref(step)), rtol=1e-6, atol=1e-12, err_msg=str(step))
    assert mine(0) == 0.0 or warmup == 0  # optax's first update uses schedule(0)


@pytest.mark.parametrize("max_norm", [0.5, 50.0])  # clipped, and left as it is
def test_global_norm_clip_matches_optax(max_norm):
    rng = np.random.default_rng(5)
    grads = {"a": rng.standard_normal((4, 8)).astype(np.float32), "b": rng.standard_normal(16).astype(np.float32)}
    clipped, _ = optax.clip_by_global_norm(max_norm).update(jax.tree_util.tree_map(jnp.asarray, grads), None)
    mine = [torch.from_numpy(grads[k].copy()) for k in ("a", "b")]
    norm = ttrain.global_norm(mine)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    ttrain.clip_by_global_norm_(mine, max_norm, norm)
    for k, t in zip(("a", "b"), mine):
        np.testing.assert_allclose(t.numpy(), np.asarray(clipped[k]), rtol=1e-6, atol=1e-7)
    if max_norm > float(norm):
        np.testing.assert_array_equal(mine[0].numpy(), grads["a"])  # untouched, not rescaled


# bf16: optax squares and sums in bf16 and rounds (t / norm) · max_norm twice;
# the port sums in fp32 and rounds t · (max_norm / norm) once: a few bf16 ulps
BF16_CLIP_RTOL = 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [0.5, 50.0])  # clipped, and left as it is
def test_clip_selects_on_the_device_like_optax(dtype, max_norm, monkeypatch):
    """The clip makes no host sync (no bool(), float() or .item() of a
    tensor: optax selects with lax.select) and matches optax in both branches:
    fp32 within this file's clip tolerance (rtol 1e-6, atol 1e-7), bf16
    within BF16_CLIP_RTOL; below the bar the grads are untouched."""
    rng = np.random.default_rng(6)
    grads = {"a": rng.standard_normal((4, 8)).astype(np.float32), "b": rng.standard_normal(16).astype(np.float32)}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jgrads = jax.tree_util.tree_map(lambda g: jnp.asarray(g, jdt), grads)
    clipped, _ = optax.clip_by_global_norm(max_norm).update(jgrads, None)
    mine = [torch.from_numpy(grads[k]).to(tdt) for k in ("a", "b")]
    before = [t.clone() for t in mine]
    norm = ttrain.global_norm(mine)

    def no_sync(*_a, **_k):
        raise AssertionError("the clip read a tensor on the host")

    with monkeypatch.context() as m:
        for name in ("__bool__", "__float__", "item", "tolist"):
            m.setattr(torch.Tensor, name, no_sync)
        ttrain.clip_by_global_norm_(mine, max_norm, norm)
    rtol, atol = (1e-6, 1e-7) if dtype == "float32" else (BF16_CLIP_RTOL, 1e-3)
    for k, t in zip(("a", "b"), mine):
        assert t.dtype == tdt
        np.testing.assert_allclose(t.float().numpy(), np.asarray(clipped[k], np.float32), rtol=rtol, atol=atol)
    if max_norm > float(norm):
        assert all(torch.equal(a, b) for a, b in zip(mine, before))  # multiplied by exactly 1
    else:
        assert float(ttrain.global_norm(mine)) == pytest.approx(max_norm, rel=1e-6 if dtype == "float32" else 1e-2)


# -- the train step against JAX ----------------------------------------------------


def test_three_train_steps_match_jax_tiny_fp32():
    """loss, pre-clip grad norm and every parameter after each of three
    steps (lr 0, then 1.5e-4, then 3e-4), within 1e-4 relative."""
    jcfg, jparams, tcfg, tparams = _models("tiny")
    jtc = jtrain.TrainConfig(warmup_steps=2, total_steps=10)
    ttc = ttrain.TrainConfig(warmup_steps=2, total_steps=10)
    jopt, topt = jtrain.make_optimizer(jtc), ttrain.make_optimizer(ttc)
    jstate = jtrain.TrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    tstate = ttrain.TrainState(tparams, topt.init(tparams), 0)
    jstep = jtrain.make_train_step(jcfg, jtc, jopt)
    tstep = ttrain.make_train_step(tcfg, ttc, topt)
    toks = _tokens(tcfg, (2, 128), seed=0)
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.from_numpy(toks).long())
        assert tm["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        _assert_trees_close(jstate.params, tstate.params, 1e-4, f"step {i}")
    assert all(p.grad is None for p in ttrain.tree_leaves(tstate.params))  # freed once applied


def test_one_step_through_flash_attention_function_debug_1l():
    """JAX `flash_attention_causal(..., 128, 128, True)` (Pallas in
    interpret mode) and the port's Function (its plain versions on the
    CPU) as attn_impl: grads of the loss, then one train step."""
    jcfg, jparams, tcfg, tparams = _models("debug-1l")
    toks = _tokens(tcfg, (2, 128), seed=6)

    def j_attn(q, k, v, mask):
        assert mask is None
        return jax_flash_attention_causal(q, k, v, 128, 128, True)

    def t_attn(q, k, v, mask):
        assert mask is None
        return flash_attention_causal(q, k, v, 128, 128)

    jloss, jgrads = jax.value_and_grad(jtrain.loss_fn)(jparams, jcfg, jnp.asarray(toks), True, j_attn)
    tloss = ttrain.loss_fn(tparams, tcfg, torch.from_numpy(toks).long(), True, t_attn)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=2e-3)
    _assert_trees_close(jgrads, _grad_tree(tparams), 2e-3, "grad")

    tc_kw = dict(warmup_steps=0, total_steps=10)  # a first update with lr > 0
    jtc, ttc = jtrain.TrainConfig(**tc_kw), ttrain.TrainConfig(**tc_kw)
    jopt, topt = jtrain.make_optimizer(jtc), ttrain.make_optimizer(ttc)
    for p in ttrain.tree_leaves(tparams):
        p.grad = None
    jstate, jm = jtrain.make_train_step(jcfg, jtc, jopt, attn_impl=j_attn)(
        jtrain.TrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32)), jnp.asarray(toks)
    )
    tstate, tm = ttrain.make_train_step(tcfg, ttc, topt, attn_impl=t_attn)(
        ttrain.TrainState(tparams, topt.init(tparams), 0), torch.from_numpy(toks).long()
    )
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2e-3)
    _assert_trees_close(jstate.params, tstate.params, 2e-3, "params")


# -- the model pieces training adds --------------------------------------------------


def test_unstack_and_stack_layers_are_bit_exact():
    cfg = tllama.get_config("tiny")
    params = tllama.init_params(cfg, seed=1, device="cpu")
    per_layer = unstack_layers(params)
    assert isinstance(per_layer["layers"], list) and len(per_layer["layers"]) == cfg.n_layers
    assert per_layer["layers"][1]["wq"].data_ptr() != params["layers"]["wq"][1].data_ptr()  # copies
    back = stack_layers(per_layer)
    for key, t in params["layers"].items():
        assert torch.equal(back["layers"][key], t) and back["layers"][key].dtype == t.dtype
    from modal_tpu_torch.models.quant import quantize_params

    q = quantize_params(params)
    q_back = stack_layers(unstack_layers(q))
    assert torch.equal(q_back["layers"]["w_up"]["q"], q["layers"]["w_up"]["q"])
    assert torch.equal(q_back["layers"]["w_up"]["s"], q["layers"]["w_up"]["s"])


@pytest.mark.parametrize("remat", [False, True])
def test_training_layout_forward_matches_stacked(remat):
    """The per-layer list layout gives the stacked layout's logits, with and
    without per-layer checkpointing, and remat leaves the grads unchanged."""
    cfg = tllama.get_config("tiny", dtype=torch.float32)
    stacked = tllama.init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (2, 32), seed=7)).long()
    want, _ = tllama.forward(stacked, cfg, toks)
    grads = []
    for use_remat in (False, remat):
        params = unstack_layers(stacked)
        for p in ttrain.tree_leaves(params):
            p.requires_grad_(True)
        got, _ = tllama.forward(params, cfg, toks, remat=use_remat)
        np.testing.assert_array_equal(got.detach().numpy(), want.numpy())
        got.square().mean().backward()
        grads.append([p.grad for p in ttrain.tree_leaves(params)])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-9)


def test_causal_lm_loss_matches_jax():
    jcfg, jparams, tcfg, tparams = _models("tiny", seed=3)
    toks = _tokens(tcfg, (2, 24), seed=8)
    jl = jllama.causal_lm_loss(jparams, jcfg, jnp.asarray(toks))
    tl = tllama.causal_lm_loss(tparams, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)


# -- the entry point ------------------------------------------------------------------


def test_train_demo_on_cpu_and_its_mesh_rule():
    """Every axis 1: the one-device step, no process group. An axis above 1
    needs the process group every rank joins (tests/test_torch_parallel.py
    runs those in gloo ranks); pipe × MoE is refused before any init."""
    import torch.distributed as dist

    from modal_tpu_torch.parallel.mesh import MeshConstraintError

    out = ttrain.train_demo("debug-1l", steps=2, seq_len=64, device="cpu", mesh_axes={"data": 1, "fsdp": 1})
    assert out["step"] == 2.0 and np.isfinite(out["loss"]) and out["loss"] > 0 and out["grad_norm"] > 0
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        ttrain.train_demo("debug-1l", mesh_axes={"fsdp": 2}, device="cpu")
    with pytest.raises(MeshConstraintError):
        ttrain.train_demo("tiny-moe", mesh_axes={"pipe": 2}, device="cpu")


def test_train_demo_first_update_keeps_params_then_moves_them():
    """optax's first lr is schedule(0) = 0: the first step leaves every
    parameter bit for bit, the second (lr > 0) moves them."""
    seen = []

    def on_step(state, metrics):
        seen.append((metrics["step"], state.params["layers"][0]["wq"].detach().clone()))

    ttrain.train_demo("debug-1l", steps=2, seq_len=64, device="cpu", on_step=on_step)
    init = unstack_layers(tllama.init_params(tllama.get_config("debug-1l"), seed=0, device="cpu"))
    assert [s for s, _ in seen] == [1, 2]
    assert torch.equal(seen[0][1], init["layers"][0]["wq"])
    assert not torch.equal(seen[1][1], seen[0][1])


def test_device_telemetry_step_timer_and_memory():
    before = catalog.STEP_SECONDS.totals(kind="unit-test")
    timer = StepTimer("unit-test")
    dt = timer.mark()
    total, count = catalog.STEP_SECONDS.totals(kind="unit-test")
    assert count == before[1] + 1 and total == pytest.approx(before[0] + dt)
    assert sample_device_memory() >= 0
