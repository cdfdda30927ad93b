"""The yardstick's arithmetic: the card's peaks, and the operations and bytes
that each kernel's inputs need and that a model's tokens need.

Every count is what the inputs need, not what a kernel happens to do:
each input byte read once, each output byte written once, causal work
only. A kernel rewritten later is read against the same work.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit."""

from __future__ import annotations

from typing import Optional

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def share(flops: float, nbytes: float, seconds: float) -> Optional[float]:
    """The roofline share, in %, of work done in `seconds` of kernel time;
    None where no such kernel ran."""
    if seconds <= 0 or (flops <= 0 and nbytes <= 0):
        return None
    return 100.0 * bound_s(flops, nbytes) / seconds


# -- attention kernels of training (K1-K3), one call at [B, S, H, hd] causal --

def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def flash_fwd(b: int, s: int, h: int, hd: int) -> tuple[float, float]:
    """K1: Q·Kᵀ and P·V over the causal triangle; reads q, k, v, writes the
    output and the log-sum-exp (bf16 tensors, fp32 lse)."""
    flops = 4 * b * h * hd * causal_pairs(s)
    tile = b * s * h * hd * 2
    return flops, 4 * tile + b * h * s * 4


def flash_bwd_dq(b: int, s: int, h: int, hd: int) -> tuple[float, float]:
    """K2: Q·Kᵀ again, dO·Vᵀ and dS·K; reads q, k, v, dO, lse, delta and
    writes dQ."""
    flops = 3 * 2 * b * h * hd * causal_pairs(s)
    tile = b * s * h * hd * 2
    return flops, 5 * tile + 2 * b * h * s * 4


def flash_bwd_dkv(b: int, s: int, h: int, hd: int) -> tuple[float, float]:
    """K3: Q·Kᵀ, dO·Vᵀ, Pᵀ·dO and dSᵀ·Q; reads q, k, v, dO, lse, delta and
    writes dK and dV."""
    flops = 4 * 2 * b * h * hd * causal_pairs(s)
    tile = b * s * h * hd * 2
    return flops, 6 * tile + 2 * b * h * s * 4


# -- paged decode attention (K4) ----------------------------------------------

def paged_decode_kv_bytes(context: int, n_kv: int, hd: int, dtype_bytes: int = 2) -> int:
    """The live K and V rows of one slot with `context` visible tokens, one
    layer, each read once."""
    return context * n_kv * hd * 2 * dtype_bytes


def paged_decode_io_bytes(slots: int, h: int, hd: int, pages_per_slot: int, dtype_bytes: int = 2) -> int:
    """One call's q and output of every slot, its page table and lengths."""
    return 2 * slots * h * hd * dtype_bytes + slots * pages_per_slot * 4 + slots * 4


def paged_decode_flops(context: int, h: int, hd: int) -> int:
    return 4 * context * h * hd


# -- whole-model counts --------------------------------------------------------

def attention_flops(n_layers: int, h: int, hd: int, context: int) -> int:
    """One token attending to `context` positions, every layer (Q·K and P·V)."""
    return 4 * n_layers * h * hd * context


def train_step_flops(model, batch: int, seq_len: int) -> float:
    """PERF.md's step count: 6 · (N − V·D) · tokens + 3 × the forward's causal
    attention FLOPs (the backward is twice the forward)."""
    m = model
    dense = 6 * (m.params - m.vocab_size * m.hidden_size) * batch * seq_len
    attn = 2 * 2 * m.num_attention_heads * m.head_dim * causal_pairs(seq_len) * m.num_hidden_layers * batch
    return dense + 3 * attn


def decode_token_flops(model, context: int) -> float:
    """One generated token: every weight but the embedding's lookup (2
    FLOPs a weight), and attention over its `context` positions."""
    m = model
    return 2 * (m.params - m.vocab_size * m.hidden_size) + attention_flops(
        m.num_hidden_layers, m.num_attention_heads, m.head_dim, context)


def prefill_chunk_flops(model, offset: int, tokens: int) -> float:
    """A prefill chunk of `tokens` after `offset` cached ones: the layers
    for every token (no embedding lookup, no output head), attention of
    each token over what precedes it, and the head for the chunk's last
    token alone (the only logits a chunk needs)."""
    m = model
    head = m.vocab_size * m.hidden_size
    layers = 2 * (m.params - 2 * head) * tokens
    contexts = tokens * offset + causal_pairs(tokens)
    return layers + 4 * m.num_hidden_layers * m.num_attention_heads * m.head_dim * contexts + 2 * head
