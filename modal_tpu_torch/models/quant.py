"""Weight-only int8 quantization (port of modal_tpu/models/quant.py:36-82).

Per-output-channel symmetric int8 with a bf16 scale. The product is
`(x @ W_q.to(x.dtype)) * s`: the scale is constant along the contraction,
so applying it to the (small) output after the matmul is exact. These are
plain torch ops: the JAX version is XLA-fused, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Any

import torch

# params leaves that are matmul weights (quantizable); norm gains stay as is
_WEIGHT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "embed", "lm_head"}
)


def _quantize_leaf(w: torch.Tensor) -> dict:
    """Scale over the contraction axis (second-to-last; stacked layer
    weights carry a leading n_layers axis)."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2, keepdim=True)
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(torch.bfloat16)}


def quantize_params(params: dict) -> dict:
    """Same-structure tree with matmul weights replaced by
    {"q": int8, "s": bf16 per-output-channel scale} dicts."""

    def walk(node: Any, key: str = "") -> Any:
        if isinstance(node, dict) and "q" not in node:
            return {k: walk(v, k) for k, v in node.items()}
        if key in _WEIGHT_KEYS and isinstance(node, torch.Tensor) and node.ndim >= 2:
            return _quantize_leaf(node)
        return node

    return walk(params)


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and "s" in leaf


def qmm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for plain or quantized weights."""
    if is_quantized(w):
        y = x @ w["q"].to(x.dtype)
        return y * w["s"].reshape(w["s"].shape[-1]).to(x.dtype)
    return x @ w


def qembed(embed: Any, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding gather for plain or quantized tables (scale the gathered
    rows only)."""
    if is_quantized(embed):
        rows = embed["q"][tokens].to(embed["s"].dtype)
        return rows * embed["s"].reshape(embed["s"].shape[-1])
    return embed[tokens]
