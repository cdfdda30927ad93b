"""The PyTorch port's attention ops against the JAX package's Pallas kernels.

On the CPU every wrapper runs its plain PyTorch version; those are held
against the Pallas kernels in interpret mode on the same seeded inputs. The
CUDA kernels themselves are held against the plain versions in the tests
marked `cuda`, which skip without a card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modal_tpu.ops.attention import _flash_backward, _flash_forward
from modal_tpu.ops.paged_attention import paged_decode_attention as jax_paged_decode
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.ops import _build
from modal_tpu_torch.ops.attention import (
    BWD_TILE_REL_L2,
    FWD_TILE_REL_L2,
    FlashAttentionCausal,
    _check_operand,
    flash_attention,
    flash_attention_backward,
    flash_attention_bwd_ref,
    flash_attention_causal,
    flash_attention_delta,
    flash_attention_fwd,
    flash_attention_fwd_ref,
    flash_attention_kernel,
    flash_bwd_dkv,
    flash_bwd_dq,
    worst_tile_rel_l2,
)
from modal_tpu_torch.ops.paged_attention import (
    DECODE_CHUNK,
    DECODE_REL_L2,
    _decode_workspace,
    paged_decode_attention,
    paged_decode_attention_ref,
    worst_head_rel_l2,
)

_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _pair(rng, shape, dtype):
    """The same seeded values as a JAX array and a torch tensor (bf16 rounds
    identically on both sides: round-to-nearest-even from the same fp32)."""
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = _DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


# -- flash forward -------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,causal,dtype,block_q,block_k,tol",
    [
        ((2, 256, 4, 64), True, "float32", 128, 128, 2e-3),
        ((1, 256, 2, 64), False, "float32", 128, 128, 2e-3),
        ((1, 128, 2, 64), True, "bfloat16", 128, 128, 5e-2),
        # partial diagonal: block_k > block_q, the causal loop's ceiling division
        ((1, 256, 2, 32), True, "float32", 64, 128, 2e-3),
    ],
)
def test_flash_fwd_plain_matches_pallas(shape, causal, dtype, block_q, block_k, tol):
    rng = np.random.default_rng(sum(shape) + block_q)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, shape, dtype) for _ in range(3))
    j_out, j_lse = _flash_forward(jq, jk, jv, causal, block_q, block_k, interpret=True)
    t_out, t_lse = flash_attention_fwd(tq, tk, tv, causal, block_q, block_k)
    assert t_out.dtype == tq.dtype and tuple(t_out.shape) == shape
    assert t_lse.dtype == torch.float32 and tuple(t_lse.shape) == (shape[0], shape[2], shape[1], 1)
    np.testing.assert_allclose(_np(t_out), _np(j_out), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(t_lse), _np(j_lse), atol=tol, rtol=tol)
    kernel_out = flash_attention_kernel(tq, tk, tv, causal, block_q, block_k)
    np.testing.assert_array_equal(_np(kernel_out), _np(t_out))


def test_flash_errors_match_jax():
    q = torch.zeros((1, 256, 2, 32))
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention_fwd(q, q[:, :128], q[:, :128], causal=True)
    q192 = torch.zeros((1, 192, 2, 32))
    with pytest.raises(ValueError, match="divide"):
        flash_attention_fwd(q192, q192, q192, block_q=128, block_k=128)
    with pytest.raises(ValueError, match="Sq=256 != Sk=128"):
        flash_attention(q, q[:, :128], q[:, :128], None)


def test_flash_dispatch_on_cpu_is_the_einsum_reference():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, 2, 32)).astype(np.float32)) for _ in range(3))
    before = dict(_build.LAUNCHES)
    out = flash_attention(q, k, v, None)
    np.testing.assert_array_equal(out.numpy(), tllama.attention(q, k, v, None).numpy())
    assert _build.LAUNCHES == before  # the CPU path launches nothing


def _skip_k_tile(q, k, v, tile):
    """The plain causal forward with one 64-wide K/V tile left out of every
    row: what a kernel that skipped that tile would return."""
    s, d = q.shape[1], q.shape[-1]
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    keep[:, tile * 64:(tile + 1) * 64] = False
    keep[:, 0] = True  # no row left empty
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    probs = torch.softmax(logits.masked_fill(~keep, float("-inf")), -1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float())


@pytest.mark.parametrize("mutation", ["skip_first_k_tile", "skip_diagonal_k_tile", "zero_last_q_tile"])
def test_fwd_tile_bar_flags_a_wrong_tile(mutation):
    """K1's tile bar catches a last 64-row q tile of one head that skipped a
    K/V tile, which the elementwise atol = rtol = 5e-2 bar passes at S 2048
    (late rows average ~2000 V rows, entries ~0.04), or that was zeroed."""
    rng = np.random.default_rng(21)
    q, k, v = (_pair(rng, (1, 2048, 2, 128), "bfloat16")[1] for _ in range(3))
    ref = flash_attention_fwd_ref(q, k, v, True)[0].float()
    bad = ref.clone()
    if mutation == "zero_last_q_tile":
        bad[:, -64:, 1] = 0
    else:
        skipped = _skip_k_tile(q, k, v, 0 if mutation == "skip_first_k_tile" else 2048 // 64 - 1)
        bad[:, -64:, 1] = skipped[:, -64:, 1]
        assert torch.allclose(bad, ref, atol=5e-2, rtol=5e-2)  # the old bar alone passes it
    assert worst_tile_rel_l2(bad - ref, ref) > 10 * FWD_TILE_REL_L2
    assert worst_tile_rel_l2(torch.zeros_like(ref), ref) == 0.0


def test_worst_tile_rel_l2_needs_whole_tiles():
    ref = torch.ones((1, 96, 2, 32))
    with pytest.raises(ValueError, match="64-row tile"):
        worst_tile_rel_l2(ref, ref)
    assert worst_tile_rel_l2(ref[:, :64] * 0.5, ref[:, :64]) == pytest.approx(0.5)


def _bad_operand(kind, device="cpu"):
    """A [B, S, H, D] bf16 operand that K1's and K3's TMA tensor maps (or
    their template instances) cannot take, made on `device` (a copy to
    another device would make it contiguous)."""
    if kind == "misaligned_base":  # 2 bytes past a 16-byte boundary
        flat = torch.zeros(1 * 64 * 2 * 32 + 1, dtype=torch.bfloat16, device=device)
        return flat[1:].view(1, 64, 2, 32)
    if kind == "stride_not_multiple_of_8":  # row stride 36 elements = 72 bytes
        return torch.zeros((1, 64, 2, 36), dtype=torch.bfloat16, device=device)[..., :32]
    if kind == "head_dim_96":
        return torch.zeros((1, 64, 2, 96), dtype=torch.bfloat16, device=device)
    return torch.zeros((1, 64, 2, 32), dtype=torch.float16, device=device)


@pytest.mark.parametrize(
    "kind,err,match",
    [
        ("misaligned_base", ValueError, "16-byte aligned"),
        ("stride_not_multiple_of_8", ValueError, "multiples of 8"),
        ("head_dim_96", ValueError, "D in"),
        ("float16", TypeError, "bfloat16"),
    ],
)
@pytest.mark.parametrize("fn", ["flash_attention_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
def test_kernel_operand_rules(fn, kind, err, match):
    """The checks K1's, K2's and K3's wrappers run on a CUDA operand before any
    launch (`_check_operand`), on the same layouts on the CPU."""
    t = _bad_operand(kind)
    with pytest.raises(err, match=match):
        _check_operand(fn, "q", t, t.device)
    good = torch.zeros((1, 64, 2, 32), dtype=torch.bfloat16)
    _check_operand(fn, "q", good, good.device)


# -- flash backward ------------------------------------------------------------


def _bwd_inputs(shape, causal, dtype, block_q, block_k, seed):
    """q, k, v, dO and the Pallas forward's (out, lse), as JAX arrays and
    torch tensors holding the same values."""
    rng = np.random.default_rng(seed)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (_pair(rng, shape, dtype) for _ in range(4))
    j_out, j_lse = _flash_forward(jq, jk, jv, causal, block_q, block_k, interpret=True)
    t_out = torch.from_numpy(np.array(_np(j_out))).to(tq.dtype)
    t_lse = torch.from_numpy(np.array(_np(j_lse)))
    return (jq, jk, jv, j_out, j_lse, jdo), (tq, tk, tv, t_out, t_lse, tdo)


@pytest.mark.parametrize(
    "shape,causal,dtype,block_q,block_k,tol",
    [
        # tests/test_ops.py:53-95's shapes and tolerances
        ((2, 256, 2, 64), True, "float32", 128, 128, 2e-3),
        ((1, 128, 4, 32), True, "float32", 128, 128, 2e-3),
        ((1, 128, 2, 64), True, "bfloat16", 128, 128, 1e-1),
        ((1, 256, 2, 64), False, "float32", 128, 128, 2e-3),
        # partial diagonal: block_k > block_q
        ((1, 256, 2, 32), True, "float32", 64, 128, 2e-3),
    ],
)
def test_flash_bwd_plain_matches_pallas(shape, causal, dtype, block_q, block_k, tol):
    j_args, t_args = _bwd_inputs(shape, causal, dtype, block_q, block_k, seed=sum(shape) + block_q)
    j_grads = _flash_backward(*j_args, causal, block_q, block_k, interpret=True)
    ref = flash_attention_bwd_ref(*t_args, causal)
    before = dict(_build.LAUNCHES)
    wrapped = flash_attention_backward(*t_args, causal, block_q, block_k)
    assert _build.LAUNCHES == before  # the CPU path launches nothing
    for name, jg, rg, wg in zip(("dq", "dk", "dv"), j_grads, ref, wrapped):
        assert rg.dtype == torch.float32 and wg.dtype == t_args[0].dtype and tuple(wg.shape) == shape
        np.testing.assert_allclose(_np(rg), _np(jg), atol=tol, rtol=tol, err_msg=name)
        np.testing.assert_array_equal(_np(wg), _np(rg.to(wg.dtype)), err_msg=name)


@pytest.mark.parametrize("shape", [(2, 256, 2, 64), (1, 128, 4, 32)])
def test_flash_causal_function_grads_match_autograd(shape):
    """FlashAttentionCausal's explicit backward against torch autograd
    through the einsum attention (fp32), as tests/test_ops.py:54 holds the
    Pallas backward against JAX's autodiff."""
    rng = np.random.default_rng(3)
    q, k, v, w = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(4))
    grads = []
    for fn in (lambda q, k, v: flash_attention_causal(q, k, v, 128, 128), lambda q, k, v: tllama.attention(q, k, v)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for name, gf, gr in zip("qkv", *grads):
        np.testing.assert_allclose(gf.numpy(), gr.numpy(), atol=2e-4, rtol=2e-4, err_msg=f"d{name}")


def test_flash_causal_function_forward_and_errors():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, 2, 32)).astype(np.float32)) for _ in range(3))
    out = FlashAttentionCausal.apply(q, k, v, 128, 128)
    np.testing.assert_array_equal(out.numpy(), flash_attention_fwd(q, k, v, True)[0].numpy())
    with torch.no_grad():  # the serving callers: no graph, same values
        np.testing.assert_array_equal(flash_attention_causal(q, k, v).numpy(), out.numpy())
    q192 = torch.zeros((1, 192, 2, 32))
    with pytest.raises(ValueError, match="divide"):
        flash_attention_backward(q192, q192, q192, q192, torch.zeros((1, 2, 192, 1)), q192)


def _stats_inputs(shape, causal, seed):
    """bf16 q, k, v, dO and the forward's lse and delta, as K2 and K3 take them."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (_pair(rng, shape, "bfloat16")[1] for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v, causal)
    return q, k, v, out, lse, do, flash_attention_delta(out, do)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_wrappers_on_cpu_are_the_plain_version(causal):
    q, k, v, out, lse, do, delta = _stats_inputs((1, 128, 2, 64), causal, seed=17)
    ref = flash_attention_bwd_ref(q, k, v, out, lse, do, causal)
    before = dict(_build.LAUNCHES)
    got = (flash_bwd_dq(q, k, v, do, lse, delta, causal), *flash_bwd_dkv(q, k, v, do, lse, delta, causal))
    assert _build.LAUNCHES == before  # the CPU path launches nothing
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape
        np.testing.assert_array_equal(_np(g), _np(r.to(g.dtype)), err_msg=name)


@pytest.mark.parametrize(
    "bad,match",
    [
        ("k_heads", "disagree on B, H or D"),  # GQA heads not repeated to H
        ("k_batch", "disagree on B, H or D"),
        ("kv_seq", "Sq == Sk"),
        ("v_shape", r"k, v \[B,Skv,H,D\]"),
        ("do_shape", "q's shape"),
        ("lse_shape", r"lse must be contiguous fp32"),
    ],
)
@pytest.mark.parametrize("wrapper", ["dq", "dkv"])
def test_flash_bwd_wrappers_reject_mismatched_shapes(bad, match, wrapper):
    """K2 and K3 index k, v and dO by q's B, S and H: a mismatch is an error
    before any launch, never an out-of-bounds read."""
    q, k, v, _out, lse, do, delta = _stats_inputs((2, 128, 4, 32), True, seed=18)
    bad_args = {
        "k_heads": dict(k=k[:, :, :2], v=v[:, :, :2]),
        "k_batch": dict(k=k[:1], v=v[:1]),
        "kv_seq": dict(k=k[:, :64], v=v[:, :64]),
        "v_shape": dict(v=v[:, :, :2]),
        "do_shape": dict(do=do[:, :64]),
        "lse_shape": dict(lse=lse[:, :2].contiguous()),
    }[bad]
    args = {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta, **bad_args}
    fn = flash_bwd_dq if wrapper == "dq" else flash_bwd_dkv
    with pytest.raises(ValueError, match=match):
        fn(**args)


# -- paged decode ----------------------------------------------------------------


def _paged_inputs(rng, dtype, s=4, n_kv=2, n_rep=2, hd=32, page=8, pps=4, n_pages=18):
    jq, tq = _pair(rng, (s, n_kv, n_rep, hd), dtype)
    jk, tk = _pair(rng, (n_pages, page, n_kv, hd), dtype)
    jv, tv = _pair(rng, (n_pages, page, n_kv, hd), dtype)
    table = rng.permutation(np.arange(1, n_pages))[: s * pps].reshape(s, pps).astype(np.int32)
    # ragged lengths: mid-page, page boundary, one token, and an inactive slot
    lens = np.array([13, 16, 0, 31], np.int32)[:s]
    table[2] = 0  # inactive slot: table at scratch
    return (jq, jk, jv, jnp.asarray(table), jnp.asarray(lens)), (
        tq, tk, tv, torch.from_numpy(table), torch.from_numpy(lens)
    )


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_paged_decode_plain_matches_pallas(dtype, tol):
    j_args, t_args = _paged_inputs(np.random.default_rng(11), dtype)
    j_out = jax_paged_decode(*j_args, interpret=True)
    before = _build.LAUNCHES["paged_decode"]
    t_out = paged_decode_attention(*t_args)
    assert _build.LAUNCHES["paged_decode"] == before  # CPU: the plain version, no launch
    live = [0, 1, 3]  # slot 2 is inactive: garbage by contract, on both sides
    np.testing.assert_allclose(_np(t_out)[live], _np(j_out)[live], atol=tol, rtol=tol)


def test_paged_decode_plain_is_dense_attention_over_the_span():
    """The plain version equals the einsum reference on each slot's gathered
    tokens 0..q_pos (independent of the page table's indirection)."""
    _j, (q, kp, vp, table, lens) = _paged_inputs(np.random.default_rng(12), "float32")
    out = paged_decode_attention_ref(q, kp, vp, table, lens)
    page = kp.shape[1]
    for s in (0, 1, 3):
        n = int(lens[s]) + 1
        pos = torch.arange(n)
        keys = kp[table[s].long()[pos // page], pos % page]  # [n, n_kv, hd]
        vals = vp[table[s].long()[pos // page], pos % page]
        logits = torch.einsum("krd,nkd->krn", q[s], keys) / math.sqrt(q.shape[-1])
        want = torch.einsum("krn,nkd->krd", torch.softmax(logits, -1), vals)
        np.testing.assert_allclose(out[s].numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


# -- the CUDA kernels against their plain versions (on the card only) ------------


def _drop_or_double_chunk(q, kp, vp, table, lens, slot, chunk, weight):
    """The plain version with the tokens of chunk `chunk` (DECODE_CHUNK
    tokens) of `slot` given softmax weight `weight` x theirs: 0 is a split
    kernel that lost that chunk, 2 one that merged it twice."""
    s, n_kv, _n_rep, hd = q.shape
    span = table.shape[1] * kp.shape[1]
    idx = table.long()
    k_att = kp[idx].reshape(s, span, n_kv, hd).float()
    v_att = vp[idx].reshape(s, span, n_kv, hd)
    logits = torch.einsum("snrd,sknd->snrk", q.float(), k_att) / math.sqrt(hd)
    visible = torch.arange(span)[None, :] <= lens.long()[:, None]
    logits = logits.masked_fill(~visible[:, None, None, :], float("-inf"))
    w = torch.ones(s, span)
    w[slot, chunk * DECODE_CHUNK:(chunk + 1) * DECODE_CHUNK] = weight
    probs = torch.exp(logits - logits.amax(-1, keepdim=True)) * w[:, None, None, :]
    probs = (probs / probs.sum(-1, keepdim=True)).to(q.dtype)
    return torch.einsum("snrk,sknd->snrd", probs, v_att)


@pytest.mark.parametrize("weight", [0.0, 2.0], ids=["dropped_chunk", "doubled_chunk"])
def test_decode_head_bar_flags_a_wrong_chunk(weight):
    """K4's per-(slot, kv head) relative-L2 bar catches a slot at q_pos 8191
    (the serving span) that lost or doubled one of its 32 chunks, which the
    elementwise max|kernel − plain| <= 2e-2 bar passes: such a slot's
    outputs are ~1e-2, a chunk's share of them a few 1e-3."""
    rng = np.random.default_rng(31)
    s, n_kv, n_rep, hd, page, pps = 2, 2, 4, 128, 16, 512
    q, kp, vp = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
                 for shape in ((s, n_kv, n_rep, hd), (1 + s * pps, page, n_kv, hd), (1 + s * pps, page, n_kv, hd)))
    table = torch.from_numpy((rng.permutation(s * pps) + 1).reshape(s, pps).astype(np.int32))
    lens = torch.tensor([page * pps - 1, 1000], dtype=torch.int32)
    ref = paged_decode_attention_ref(q, kp, vp, table, lens).float()
    bad = _drop_or_double_chunk(q, kp, vp, table, lens, slot=0, chunk=13, weight=weight).float()
    assert (bad - ref).abs().max().item() <= 2e-2  # the elementwise bar alone passes it
    assert worst_head_rel_l2(bad, ref, [0, 1]) > 5 * DECODE_REL_L2
    assert worst_head_rel_l2(ref, ref, [0, 1]) == 0.0


def test_decode_workspace_is_made_once_and_bound_to_its_stream():
    """K4's partials and counters are allocated (counters zeroed) at the
    first call for a (device, shapes) and reused; a call from another
    stream raises instead of racing on them."""
    key = (3, 2, 4, 32, 5)  # S, n_kv, n_rep, hd, n_split
    dev = torch.device("cpu")
    partials, counters = _decode_workspace(dev, key, stream=11)
    assert partials.shape == (3, 2, 5, 4 * (32 + 2)) and partials.dtype == torch.float32
    assert counters.shape == (3, 2) and counters.dtype == torch.int32 and not counters.any()
    again = _decode_workspace(dev, key, stream=11)
    assert again[0] is partials and again[1] is counters
    with pytest.raises(RuntimeError, match="bound to stream"):
        _decode_workspace(dev, key, stream=12)
    other = _decode_workspace(dev, (3, 2, 4, 32, 6), stream=12)  # other shapes: their own workspace
    assert other[0] is not partials


def _paged_case(device, case):
    """K4's inputs on the card: `ragged` is `_paged_inputs`' small set
    (mid-page, page boundary, one token, an inactive slot); the others put
    q_pos at 0, on and around the kernel's chunk boundaries and at the span's
    end over a 3-chunk span, at llama3-8b's head shape, at the speculative
    draft's (llama3-1b-proxy: 8 slots, hd 64) and at two others."""
    if case == "ragged":
        _j, t_args = _paged_inputs(np.random.default_rng(13), "bfloat16", hd=128, n_rep=4, pps=4)
        return [t.to(device) for t in t_args], [0, 1, 3]
    n_kv, n_rep, hd = {"boundaries_hd128_rep4": (8, 4, 128), "boundaries_hd64_rep8": (2, 8, 64),
                       "boundaries_hd32_rep1": (4, 1, 32), "draft_hd64_rep4": (8, 4, 64)}[case]
    page, pps = 16, 3 * DECODE_CHUNK // 16
    span = page * pps
    lens = [0, DECODE_CHUNK - 1, DECODE_CHUNK, DECODE_CHUNK + 1, 2 * DECODE_CHUNK - 1, 2 * DECODE_CHUNK, span - 1]
    if case == "draft_hd64_rep4":
        lens.append(517)  # llama3-1b-proxy's heads in the speculative engine's 8 slots
    rng = np.random.default_rng(19)
    s = len(lens)
    q, kp, vp = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
                 for shape in ((s, n_kv, n_rep, hd), (1 + s * pps, page, n_kv, hd), (1 + s * pps, page, n_kv, hd)))
    table = torch.from_numpy((rng.permutation(s * pps) + 1).reshape(s, pps).astype(np.int32))
    args = [q, kp, vp, table, torch.tensor(lens, dtype=torch.int32)]
    return [t.to(device) for t in args], list(range(s))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case",
    ["ragged", "boundaries_hd128_rep4", "boundaries_hd64_rep8", "boundaries_hd32_rep1", "draft_hd64_rep4"],
)
def test_paged_decode_kernel_matches_plain(cuda_device, case):
    """K4 against the plain version on the live slots: max|kernel − plain|
    <= 2e-2 and relative L2 <= DECODE_REL_L2 on every (slot, kv head), which
    a lost or doubled chunk fails where the elementwise bar passes; twice,
    so the counters the first launch left must be back at zero."""
    args, live = _paged_case(cuda_device, case)
    before = _build.LAUNCHES["paged_decode"]
    outs = [paged_decode_attention(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_decode"] == before + 2
    ref = paged_decode_attention_ref(*args)
    for out in outs:
        torch.testing.assert_close(out[live].float(), ref[live].float(), atol=2e-2, rtol=0)
        assert worst_head_rel_l2(out, ref, live) <= DECODE_REL_L2
    with pytest.raises(TypeError, match="bfloat16"):
        paged_decode_attention(args[0].float(), *args[1:])


@pytest.mark.cuda
def test_paged_decode_kernel_refuses_a_second_stream(cuda_device):
    """The workspace of a shape is bound to the stream of its first call."""
    args, _live = _paged_case(cuda_device, "ragged")
    args[0] = args[0][:, :, :1].contiguous()  # n_rep 1: shapes of their own, a fresh workspace
    paged_decode_attention(*args)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side), pytest.raises(RuntimeError, match="bound to stream"):
        paged_decode_attention(*args)
    torch.cuda.synchronize()


# (B, S, H, D) and causal for K1 and K3 on the card: S 64 half fills the
# kernels' 128-row tiles, S 384 is three of them, D 32 and 64 take the 64-byte
# and single-atom swizzles, and B 2 the batch stride
CUDA_FLASH_CASES = [
    ((1, 256, 4, 128), True),
    ((2, 128, 2, 64), False),
    ((1, 64, 2, 128), True),
    ((1, 384, 2, 128), True),
    ((1, 384, 2, 32), True),
    ((1, 384, 2, 64), True),
    ((2, 256, 4, 128), True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", CUDA_FLASH_CASES)
def test_flash_fwd_kernel_matches_plain(cuda_device, shape, causal):
    """K1 against the plain forward: atol = rtol = 5e-2 on out and lse, and
    relative L2 <= FWD_TILE_REL_L2 on every 64-row tile of every (batch,
    head), which a skipped K/V tile fails where the elementwise bar passes."""
    rng = np.random.default_rng(14)
    q, k, v = (_pair(rng, shape, "bfloat16")[1].to(cuda_device) for _ in range(3))
    before = _build.LAUNCHES["flash_fwd"]
    out, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_fwd"] == before + 1
    ref, ref_lse = flash_attention_fwd_ref(q, k, v, causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(lse, ref_lse, atol=5e-2, rtol=5e-2)
    assert worst_tile_rel_l2(out.float() - ref.float(), ref) <= FWD_TILE_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["misaligned_base", "stride_not_multiple_of_8", "head_dim_96"])
def test_flash_kernel_wrappers_reject_operands_on_the_card(cuda_device, kind):
    """K1, K2 and K3 raise before any launch on an operand their tensor maps
    or template instances cannot take."""
    bad = _bad_operand(kind, cuda_device)
    good = torch.zeros(bad.shape, dtype=torch.bfloat16, device=cuda_device)
    stats = torch.zeros((1, 2, 64, 1), device=cuda_device)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError):
        flash_attention_fwd(bad, good, good, True)
    with pytest.raises(ValueError):
        flash_bwd_dkv(good, bad, good, good, stats, stats, True)
    with pytest.raises(ValueError):
        flash_bwd_dq(good, good, good, bad, stats, stats, True)
    assert _build.LAUNCHES == before


def _cuda_bwd_case(device, shape, causal, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (_pair(rng, shape, "bfloat16")[1].to(device) for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v, causal)
    return q, k, v, out, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", CUDA_FLASH_CASES)
def test_flash_bwd_kernels_match_plain(cuda_device, shape, causal):
    """K2 and K3 against the plain backward on the same inputs, at the JAX
    package's bf16 backward bar (bench.py:193-195) and at relative L2 <=
    BWD_TILE_REL_L2 on every 64-row tile of every (batch, head): typical
    gradient entries are ~0.05, so the max bar alone would pass a skipped
    tile."""
    args = _cuda_bwd_case(cuda_device, shape, causal, seed=15)
    before = dict(_build.LAUNCHES)
    grads = flash_attention_backward(*args, causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert _build.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    ref = flash_attention_bwd_ref(*args, causal)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert g.dtype == torch.bfloat16
        diff = g.float() - r
        err, rel = diff.abs().max().item(), worst_tile_rel_l2(diff, r)
        assert err < 0.35 and rel <= BWD_TILE_REL_L2, (name, err, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 64, 2, 128), (1, 192, 2, 128), (2, 320, 2, 64), (1, 192, 4, 32)])
def test_flash_bwd_dq_kernel_at_tile_boundaries(cuda_device, shape, causal):
    """K2 where its tiles end ragged: S a multiple of its 64-row K/V tiles
    but not of its 128-row q tile, so the last block's second warpgroup has
    no rows (TMA fills them with zeros and nothing is written) and, causal,
    the diagonal falls in the first warpgroup. lse and delta come from the
    plain forward, since K1's wrapper takes only whole 128-row blocks."""
    rng = np.random.default_rng(20)
    q, k, v, do = (_pair(rng, shape, "bfloat16")[1].to(cuda_device) for _ in range(4))
    out, lse = flash_attention_fwd_ref(q, k, v, causal)
    delta = flash_attention_delta(out, do)
    before = _build.LAUNCHES["flash_bwd_dq"]
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_bwd_dq"] == before + 1
    ref = flash_attention_bwd_ref(q, k, v, out, lse, do, causal)[0]
    diff = dq.float() - ref
    err, rel = diff.abs().max().item(), worst_tile_rel_l2(diff, ref)
    assert err < 0.35 and rel <= BWD_TILE_REL_L2, (err, rel)


@pytest.mark.cuda
def test_flash_causal_function_launches_k1_k2_k3(cuda_device):
    q, k, v, _out, _lse, do = _cuda_bwd_case(cuda_device, (1, 256, 4, 64), True, seed=16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(_build.LAUNCHES)
    out = flash_attention(*leaves, None)
    # a non-contiguous gradient: the wrapper makes dO contiguous
    out.backward(do.transpose(1, 2).contiguous().transpose(1, 2))
    torch.cuda.synchronize()
    assert {n: _build.LAUNCHES[n] - before[n] for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
    }
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all() for t in leaves)
