"""Flash attention, forward and backward (port of modal_tpu/ops/attention.py).

- `flash_attention_fwd(q, k, v, causal)` → (out [B,S,H,D], lse [B,H,S,1]
  fp32): the port of `_flash_forward` (attention.py:211, Pallas
  `_flash_kernel` at :50). On a CUDA tensor it launches the hand-written
  kernel in `csrc/flash_fwd.cu` (or raises); on a CPU tensor it runs
  `flash_attention_fwd_ref`, the plain fp32 version.
- `flash_attention_backward(q, k, v, out, lse, do, causal)` → (dq, dk, dv):
  the port of `_flash_backward` (:275). delta = rowsum(dO∘O) is plain torch,
  as in JAX (:292-298); on CUDA it then launches `flash_bwd_dq`
  (`csrc/flash_bwd_dq.cu`, K2, `_flash_dq_kernel` :106) and `flash_bwd_dkv`
  (`csrc/flash_bwd_dkv.cu`, K3, `_flash_dkv_kernel` :152); on CPU tensors
  each of those runs the plain version (`flash_attention_bwd_ref`'s
  formulas from the same delta).
- `FlashAttentionCausal` / `flash_attention_causal(q, k, v)`: the
  differentiable causal attention, counterpart of the `custom_vjp` at :351.
  It saves (q, k, v, out, lse) and its backward is the one above.
- `flash_attention_kernel(q, k, v, causal=True)`: `flash_attention_pallas`'s
  counterpart (out only).
- `flash_attention(q, k, v, mask)`: the dispatching drop-in for
  `models.llama.attention`. The JAX rule minus the TPU VMEM budget:
  `mask is None` and a block-aligned sequence (S % 128 == 0) go to
  `flash_attention_causal` on CUDA; everything else goes to the einsum
  `attention`, as on a TPU. The kernels are built for bf16 (the model
  dtype), so an fp32 call routes to the einsum too. This is shape routing,
  not error recovery.

JAX's errors are kept: causal needs Sq == Sk (attention.py:223), block
sizes must divide the sequence lengths (:206), and `mask=None` with
Sq != Sk is an error (:384).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

KERNEL = "flash_fwd"
KERNEL_DQ = "flash_bwd_dq"
KERNEL_DKV = "flash_bwd_dkv"
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
_SUPPORTED_D = (32, 64, 128)


def _blocks(s: int, skv: int, block_q: int, block_k: int) -> tuple[int, int]:
    block_q = min(block_q, s)
    block_k = min(block_k, skv)
    if s % block_q or skv % block_k:
        raise ValueError(f"seq lengths ({s},{skv}) must divide block sizes ({block_q},{block_k})")
    return block_q, block_k


def _check_shapes(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("flash attention takes q [B,S,H,D] and k, v [B,Skv,H,D]")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B, H or D")
    if causal and s != k.shape[1]:
        raise ValueError(
            f"causal flash attention requires Sq == Sk (got {s} != {k.shape[1]}): the kernel "
            "aligns q and k at position 0; cached/chunked calls need an explicit mask"
        )


def _check_args(q, k, v, causal: bool, block_q: int, block_k: int) -> None:
    _check_shapes(q, k, v, causal)
    _blocks(q.shape[1], k.shape[1], block_q, block_k)


def flash_attention_fwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: fp32 logits, softmax and P·V, output cast to q.dtype;
    lse [B, H, Sq, 1] fp32."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)  # [B, H, Sq, 1]
    out = torch.einsum("bhqk,bkhd->bqhd", torch.exp(logits - lse), v.float())
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,  # [B, H, Sq, 1] fp32
    do: torch.Tensor,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward, the kernels' formulas in fp32 (not
    autograd): P = exp(s − lse), δ = rowsum(dO∘O), dS = P∘(dP − δ)·scale,
    dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO. Returns fp32 (dq, dk, dv)."""
    return _bwd_plain(q, k, v, do, lse, flash_attention_delta(out, do), causal)


# The bars the kernels are held to against their plain versions, on every
# 64-row tile of every (batch, head) (`worst_tile_rel_l2`), beside the
# elementwise bars; measured on an H100 80GB HBM3 at 700 W, B1 S2048 H32
# D128 causal. K1's out: ~4x the worst tile of PR 1's kernel (hi + lo P),
# 2.94e-4. K2's dQ and K3's dK, dV: ~4x the worst tile a bf16 rounding of
# P, dS and the outputs gives, 2.85e-3.
FWD_TILE_REL_L2 = 1.2e-3
BWD_TILE_REL_L2 = 1e-2


def worst_tile_rel_l2(diff: torch.Tensor, ref: torch.Tensor, rows: int = 64) -> float:
    """The largest relative L2 error over the `rows`-row tiles of each
    (batch, head) of a [B, S, H, D] result: a tile that a kernel got wrong
    shows at full size, where the whole tensor's norm, or an elementwise
    bar that typical entries sit inside, would pass it."""
    b, s, h, d = ref.shape
    if s % rows:
        raise ValueError(f"sequence length {s} is not a multiple of the {rows}-row tile")
    tiles = (b, s // rows, rows, h, d)
    diff, ref = diff.float().reshape(tiles), ref.float().reshape(tiles)
    return (diff.norm(dim=(2, 4)) / ref.norm(dim=(2, 4))).max().item()


def _bwd_plain(q, k, v, do, lse, delta, causal: bool):
    """`flash_attention_bwd_ref` from the saved delta, as K2 and K3 take it."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq, dk, dv


def _check_operand(fn: str, name: str, t: torch.Tensor, device: torch.device) -> None:
    """What the kernels need of a [B, S, H, D] operand: K1's, K2's and K3's
    TMA tensor maps (csrc/hopper.cuh) take 16-byte aligned bases and
    strides, and the kernels are built for D in {32, 64, 128}."""
    if t.device != device:
        raise ValueError(f"{fn}: {name} on {t.device}, q on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{fn}: kernel takes bfloat16, {name} is {t.dtype}")
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(
            f"{fn}: {name} needs unit stride on D, strides that are multiples of 8 "
            f"elements and a 16-byte aligned base (strides {t.stride()})"
        )
    if t.shape[-1] not in _SUPPORTED_D:
        raise ValueError(f"{fn}: kernel built for D in {_SUPPORTED_D}, got {t.shape[-1]}")


def _argtypes(n_pointers: int) -> list:
    """The C entry points' arguments: the tensors' pointers, (B, H, Sq, Sk,
    D), the strides, scale, causal and the stream."""
    return (
        [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )


def _strides(*ts: torch.Tensor) -> ctypes.Array:
    """The (batch, seq, head) element strides of each tensor, in order."""
    return (ctypes.c_longlong * (3 * len(ts)))(*(st for t in ts for st in t.stride()[:3]))


def _flash_fwd_cuda(q, k, v, causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand("flash_attention_fwd", name, t, q.device)
    b, s, h, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    fn = _build.entry(KERNEL, "flash_fwd_bf16", _argtypes(5))
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, h, s, k.shape[1], d, _strides(q, k, v, out), 1.0 / math.sqrt(d), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(KERNEL, err)
    return out, lse


def flash_attention_fwd(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, Skv, H, D] (kv heads already repeated to H)
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [B,S,H,D], lse [B,H,S,1] fp32). The block sizes carry
    the JAX divisibility contract; the CUDA kernel tiles 128 q rows by 64
    K/V rows itself, and reads a partly filled last tile as zeros."""
    _check_args(q, k, v, causal, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    return _flash_fwd_cuda(q, k, v, causal)


def flash_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Counterpart of `flash_attention_pallas`: the forward's output only."""
    return flash_attention_fwd(q, k, v, causal, block_q, block_k)[0]


def _check_bwd_operands(fn: str, q, k, v, do, lse, delta, causal: bool) -> bool:
    """The shapes K2 and K3 index by (q's B, S, H and D for k, v and dO);
    True when the operands lie on the CPU and the plain version runs, False
    on CUDA once they meet the kernels' layout rules."""
    _check_shapes(q, k, v, causal)
    if do.shape != q.shape:
        raise ValueError(f"{fn}: do {tuple(do.shape)} must have q's shape {tuple(q.shape)}")
    b, s, h, _d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, s, 1) or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous fp32 [B, H, Sq, 1], got {tuple(t.shape)} {t.dtype}")
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_operand(fn, name, t, q.device)
    return False


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True) -> torch.Tensor:
    """K2 on the card (`csrc/flash_bwd_dq.cu`): dQ [B, S, H, D] like q, from
    the forward's lse and delta = rowsum(dO∘O), both [B, H, S, 1] fp32. On
    CPU tensors, the plain version."""
    if _check_bwd_operands("flash_bwd_dq", q, k, v, do, lse, delta, causal):
        return _bwd_plain(q, k, v, do, lse, delta, causal)[0].to(q.dtype)
    b, s, h, d = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    launch = _build.entry(KERNEL_DQ, "flash_bwd_dq_bf16", _argtypes(7))
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), b, h, s, k.shape[1], d, _strides(q, k, v, do, dq), 1.0 / math.sqrt(d),
        int(causal), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(KERNEL_DQ, err)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """K3 on the card (`csrc/flash_bwd_dkv.cu`): (dK, dV) like k and v. On
    CPU tensors, the plain version."""
    if _check_bwd_operands("flash_bwd_dkv", q, k, v, do, lse, delta, causal):
        _dq, dk, dv = _bwd_plain(q, k, v, do, lse, delta, causal)
        return dk.to(k.dtype), dv.to(v.dtype)
    b, s, h, d = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    launch = _build.entry(KERNEL_DKV, "flash_bwd_dkv_bf16", _argtypes(8))
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, s, k.shape[1], d, _strides(q, k, v, do, dk, dv),
        1.0 / math.sqrt(d), int(causal), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(KERNEL_DKV, err)
    return dk, dv


def flash_attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO ∘ O) as [B, H, S, 1] fp32, plain torch as in JAX
    (attention.py:292-298)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).unsqueeze(-1).contiguous()


def flash_attention_backward(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, Skv, H, D]
    v: torch.Tensor,
    out: torch.Tensor,  # the forward's output
    lse: torch.Tensor,  # [B, H, S, 1] fp32, the forward's logsumexp
    do: torch.Tensor,  # [B, S, H, D], the output's gradient
    causal: bool = True,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the dtypes of (q, k, v). `do` is made contiguous
    first: it arrives as a reshape of the output projection's gradient, and
    the kernels' tile loads need unit stride on D."""
    _check_args(q, k, v, causal, block_q, block_k)
    do = do.contiguous()
    delta = flash_attention_delta(out, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return flash_bwd_dq(q, k, v, do, lse, delta, causal), dk, dv


class FlashAttentionCausal(torch.autograd.Function):
    """Differentiable causal flash attention: the `custom_vjp`
    `flash_attention_causal` (attention.py:351-375). The forward saves
    (q, k, v, out, lse); the backward recomputes P from lse in K2 and K3 on
    CUDA, in the plain version on the CPU. Under non-reentrant activation
    checkpointing the forward runs again in the backward pass, so K1
    launches twice per layer and step."""

    @staticmethod
    def forward(ctx, q, k, v, block_q: int, block_k: int):
        out, lse = flash_attention_fwd(q, k, v, True, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, do, True, *ctx.blocks)
        return dq, dk, dv, None, None


def flash_attention_causal(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Causal attention [B, S, H, D] that autograd differentiates through
    the flash backward (`FlashAttentionCausal`)."""
    return FlashAttentionCausal.apply(q, k, v, block_q, block_k)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Drop-in for models.llama.attention (`mask=None` = pure causal, q/k
    aligned at position 0, Sq == Sk)."""
    if mask is None and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"mask=None implies aligned causal attention but Sq={q.shape[1]} != Sk={k.shape[1]}; "
            "pass the cache visibility mask for cached/chunked calls"
        )
    if (
        q.device.type == "cuda"
        and mask is None
        and q.dtype == torch.bfloat16
        and q.shape[1] >= DEFAULT_BLOCK_Q
        and q.shape[1] % DEFAULT_BLOCK_Q == 0
    ):
        # differentiable, so the training path runs K1 forward and K2/K3 backward
        return flash_attention_causal(q, k, v)
    from ..models.llama import attention as einsum_attention

    return einsum_attention(q, k, v, mask)
