"""Weight-only int8 quantization (port of modal_tpu/models/quant.py).

Per-output-channel symmetric int8 with a bf16 scale. The product is
`(x @ W_q.to(x.dtype)) * s`: the scale is constant along the contraction,
so applying it to the (small) output after the matmul is exact. These are
plain torch ops: the JAX version is XLA-fused, not a Pallas kernel. Unlike
XLA, eager PyTorch materialises the bf16 copy of the weight on every call.

`init_params_quantized` makes random int8 params directly (no bf16 tree):
with `fast_host_init` they are the JAX package's, bit for bit, because both
tile the same numpy block. The MoE weight keys (`router`, `w_in`, `w_out`)
wait for ROADMAP.md Queue A 5.
"""

from __future__ import annotations

import zlib
from typing import Any

import numpy as np
import torch

from ..config import host_to_device, resolve_device

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


# fast_host_init tensors at/above this stream chunk by chunk into the device
# buffer instead of staging a full-size host copy (the JAX package's sizes:
# the chunk boundaries decide where the tile restarts, so they must match)
_CHUNKED_INIT_BYTES = 256 * 1024 * 1024
_CHUNK_BYTES = 64 * 1024 * 1024


def _tile_to(host_tile: np.ndarray, size: int) -> np.ndarray:
    """Exactly `size` int8 values by repeating host_tile (the remainder is
    cut before it is written, so no oversized temporary)."""
    full = size // host_tile.size
    rem = size - full * host_tile.size
    out = np.empty(size, np.int8)
    if full:
        out[: full * host_tile.size].reshape(full, host_tile.size)[:] = host_tile
    if rem:
        out[full * host_tile.size :] = host_tile[:rem]
    return out


def _fill_int8_chunked(shape: tuple, host_tile: np.ndarray, device: torch.device) -> torch.Tensor:
    """An int8 tensor of `shape` on `device`, filled one leading-axis chunk
    at a time from one host slab of tiled values (~64 MiB, pinned on CUDA)
    that every chunk reuses: each chunk restarts the tile, as in the JAX
    package. Host transient = the slab; the copies do not wait for the
    device."""
    size = int(np.prod(shape))
    rows = shape[0]
    row_bytes = size // rows
    chunk_rows = max(1, min(rows, _CHUNK_BYTES // max(row_bytes, 1)))
    buf = torch.empty(shape, dtype=torch.int8, device=device)
    slab = torch.from_numpy(_tile_to(host_tile, chunk_rows * row_bytes).reshape((chunk_rows, *shape[1:])))
    if device.type == "cuda":
        slab = slab.pin_memory()
    for i in range(0, rows, chunk_rows):
        r = min(chunk_rows, rows - i)
        buf[i : i + r].copy_(slab[:r], non_blocking=True)
    return buf


def init_params_quantized(cfg, seed: int = 0, fast_host_init: bool = False, device=None) -> dict:
    """Random int8 params created directly in quantized form, every scale
    0.01 and every norm gain 1: no bf16 staging, so a model whose bf16 tree
    would not fit still initialises (throughput and memory runs; real
    weights come from `weights.load_params` + `quantize_params`).

    `fast_host_init` tiles `np.random.default_rng(0)`'s 1 MiB int8 block,
    as the JAX package does, so the int8 leaves equal its leaves bit for
    bit; large tensors stream through `_fill_int8_chunked`. Otherwise each
    weight draws from a `torch.Generator` keyed by (seed, its name): the
    same structure, dtypes and bytes as the JAX package's, other values."""
    from .llama import init_params_abstract

    dev = resolve_device(device)
    abstract = init_params_abstract(cfg)
    if fast_host_init:
        host_tile = np.random.default_rng(0).integers(-127, 128, size=1 << 20, dtype=np.int8)

    def make(key: str, spec: torch.Tensor) -> Any:
        if key in _WEIGHT_KEYS and spec.ndim >= 2:
            shape = tuple(spec.shape)
            if fast_host_init:
                size = spec.numel()
                if size >= _CHUNKED_INIT_BYTES and shape[0] > 1:
                    q = _fill_int8_chunked(shape, host_tile, dev)
                else:
                    q = host_to_device(_tile_to(host_tile, size).reshape(shape), dev)
            else:
                gen = torch.Generator(device=dev)
                gen.manual_seed(zlib.crc32(f"{int(seed)}/{key}".encode()))  # the CPU generator keeps 32 bits
                q = torch.randint(-127, 128, shape, dtype=torch.int8, generator=gen, device=dev)
            s_shape = shape[:-2] + (1, shape[-1])
            return {"q": q, "s": torch.full(s_shape, 0.01, dtype=torch.bfloat16, device=dev)}
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)

    def walk(node: Any, key: str = "") -> Any:
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return make(key, node)

    return walk(abstract)


def quantized_bytes(params: Any) -> int:
    """Bytes of every tensor in a param tree (int8 weights, their scales
    and the plain leaves alike); meta tensors count as their shapes say."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(quantized_bytes(v) for v in params)
    return params.numel() * params.element_size()
