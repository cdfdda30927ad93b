"""Flash-attention forward (port of modal_tpu/ops/attention.py).

- `flash_attention_fwd(q, k, v, causal)` → (out [B,S,H,D], lse [B,H,S,1]
  fp32): the port of `_flash_forward` (attention.py:211, Pallas
  `_flash_kernel` at :50). On a CUDA tensor it launches the hand-written
  kernel in `csrc/flash_fwd.cu` (or raises); on a CPU tensor it runs
  `flash_attention_fwd_ref`, the plain fp32 version.
- `flash_attention_kernel(q, k, v, causal=True)`: `flash_attention_pallas`'s
  counterpart (out only).
- `flash_attention(q, k, v, mask)`: the dispatching drop-in for
  `models.llama.attention`. The JAX rule minus the TPU VMEM budget:
  `mask is None` and a block-aligned sequence (S % 128 == 0) go to the
  kernel on CUDA; everything else goes to the einsum `attention`, as on a
  TPU. The kernel is built for bf16 (the model dtype), so an fp32 call
  routes to the einsum too. This is shape routing, not error recovery.

JAX's errors are kept: causal needs Sq == Sk (attention.py:223), block
sizes must divide the sequence lengths (:206), and `mask=None` with
Sq != Sk is an error (:384). The backward kernels (K2/K3) are not ported
yet: a call that needs gradients raises instead of silently detaching.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

KERNEL = "flash_fwd"
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
_SUPPORTED_D = (32, 64, 128)


def _blocks(s: int, skv: int, block_q: int, block_k: int) -> tuple[int, int]:
    block_q = min(block_q, s)
    block_k = min(block_k, skv)
    if s % block_q or skv % block_k:
        raise ValueError(f"seq lengths ({s},{skv}) must divide block sizes ({block_q},{block_k})")
    return block_q, block_k


def _check_args(q, k, v, causal: bool, block_q: int, block_k: int) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("flash attention takes q [B,S,H,D] and k, v [B,Skv,H,D]")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B, H or D")
    skv = k.shape[1]
    if causal and s != skv:
        raise ValueError(
            f"causal flash attention requires Sq == Sk (got {s} != {skv}): the kernel "
            "aligns q and k at position 0; cached/chunked calls need an explicit mask"
        )
    _blocks(s, skv, block_q, block_k)


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


_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


def _flash_fwd_cuda(q, k, v, causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash attention backward kernels are not ported yet (ROADMAP: K2/K3); "
            "run the forward under torch.no_grad()"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention_fwd: kernel takes bfloat16, {name} is {t.dtype}")
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention_fwd: {name} needs unit stride on D, strides that are "
                f"multiples of 8 elements and a 16-byte aligned base (strides {t.stride()})"
            )
    b, s, h, d = q.shape
    if d not in _SUPPORTED_D:
        raise ValueError(f"flash_attention_fwd: kernel built for D in {_SUPPORTED_D}, got {d}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    fn = _build.entry(KERNEL, "flash_fwd_bf16", _ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, h, s, k.shape[1], d, strides, 1.0 / math.sqrt(d), int(causal),
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
    the JAX divisibility contract; the CUDA kernel tiles 64x64 itself."""
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
        return flash_attention_fwd(q, k, v, causal=True)[0]
    from ..models.llama import attention as einsum_attention

    return einsum_attention(q, k, v, mask)
