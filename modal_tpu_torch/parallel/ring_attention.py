"""Ring attention: sequence parallelism over the `seq` mesh axis (port of
modal_tpu/parallel/ring_attention.py).

Q stays on its sequence shard; the K/V blocks travel round the ring of
`seq` ranks by point-to-point send/receive (`spmd.ring_shift`, JAX's
`ppermute` by +1), and each arriving block is merged by the online
softmax, a running (max, sum, output) per query row in fp32. The causal
mask uses global positions, so blocks entirely in a row's future add
exactly 0. The gradient is autograd's through the merge, with the ring run
backwards for the K/V cotangents (`ring_shift`'s backward), as JAX
differentiates through `ppermute`.

The block attention is plain torch, as it is plain `jnp` in JAX: no Pallas
kernel runs here, so no CUDA kernel either.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _block_attend(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, H, D]
    v: torch.Tensor,
    q_pos: torch.Tensor,  # [Sq] global positions
    kv_pos: torch.Tensor,  # [Sk]
    m: torch.Tensor,  # [B, H, Sq] running max
    l: torch.Tensor,  # [B, H, Sq] running sum
    o: torch.Tensor,  # [B, Sq, H, D] running (unnormalised) output, fp32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One flash-style accumulation step against a K/V block
    (ring_attention.py:33)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    causal = kv_pos[None, None, None, :] <= q_pos[None, None, :, None]
    s = torch.where(causal, s, float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a row with nothing seen yet (max -inf) takes correction 0
    correction = torch.where(torch.isinf(m) & (m < 0), torch.zeros_like(m), torch.exp(m - m_new))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(causal, p, torch.zeros_like(p))
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    o_new = o * correction.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def ring_attention(
    q: torch.Tensor,  # [B, S_local, H, D]: this rank's sequence shard
    k: torch.Tensor,
    v: torch.Tensor,
    plan,  # parallel.spmd.SpmdPlan
    axis_name: str = "seq",
) -> torch.Tensor:
    """Causal self-attention over a sequence sharded on `axis_name`; the
    output is this rank's shard. Heads are whatever the rank holds (its
    `model` shard under tensor parallelism): attention is independent per
    head, so no collective crosses heads."""
    from .spmd import ring_shift

    n = plan.sizes[axis_name]
    me = plan.coords[axis_name]
    group, ranks = plan.group(axis_name), plan.ranks[axis_name]
    b, s_local, h, d = q.shape
    dev = q.device
    q_pos = me * s_local + torch.arange(s_local, device=dev)
    m = torch.full((b, h, s_local), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s_local), dtype=torch.float32, device=dev)
    o = torch.zeros((b, s_local, h, d), dtype=torch.float32, device=dev)
    for i in range(n):
        kv_pos = ((me - i) % n) * s_local + torch.arange(s_local, device=dev)
        m, l, o = _block_attend(q, k, v, q_pos, kv_pos, m, l, o)
        if i + 1 < n:  # shard p hands its block to p + 1
            k = ring_shift(k, group, ranks)
            v = ring_shift(v, group, ranks)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l_safe.transpose(1, 2)[..., None]).to(q.dtype)


def make_ring_attention_impl(plan, axis_name: str = "seq"):
    """Adapter with the model's attention signature (q, k, v, mask): the
    causal mask comes from global positions, so `mask` must be None
    (training and prefill)."""

    def _impl(q, k, v, mask: Optional[torch.Tensor] = None):
        if mask is not None:
            raise ValueError("ring attention is causal over global positions; it takes no mask")
        return ring_attention(q, k, v, plan, axis_name)

    return _impl


def full_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Reference single-device causal attention (ring_attention.py:146)."""
    s = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    logits = torch.where(causal[None, None], logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
