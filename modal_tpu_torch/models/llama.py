"""Llama-3 family in PyTorch (port of modal_tpu/models/llama.py:32-395).

Parameters are a plain dict with the JAX package's key names: layer tensors
are stacked `[n_layers, ...]` and weights keep JAX's `[in, out]` layout
(`x @ w`), so a converted JAX tree (models/convert.py) drops straight in.
The JAX `lax.scan` over layers is a Python loop over the stacked index.
Training holds the layers instead as a list of per-layer dicts
(`convert.unstack_layers`): under autograd, the backward of each index into
a stacked tensor would build a zero tensor of the whole stack.

bf16 rounding happens where the JAX reference rounds (parity depends on it):
`rms_norm` casts to `x.dtype` before the gain multiply, `apply_rope` runs in
fp32 and casts, attention logits are fp32 and the probabilities are cast to
`q.dtype` before P·V, SiLU runs in fp32 and casts back, logits are fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import resolve_device
from .quant import is_quantized, qembed, qmm


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    name: str
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    ffn_dim: int
    norm_eps: float = 1e-5
    rope_theta: float = 500_000.0
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    # MoE (switch-style top-1 expert FFNs): not ported yet (ROADMAP)
    n_experts: int = 0
    capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        embed = self.vocab_size * self.dim
        if self.is_moe:
            ffn = self.dim * self.n_experts + 2 * self.n_experts * self.dim * self.ffn_dim
        else:
            ffn = 3 * self.dim * self.ffn_dim
        per_layer = (
            self.dim * self.n_heads * self.head_dim
            + 2 * self.dim * self.n_kv_heads * self.head_dim
            + self.n_heads * self.head_dim * self.dim
            + ffn
            + 2 * self.dim
        )
        return embed * 2 + per_layer * self.n_layers + self.dim


# Llama-3 architecture hyperparameters (public: Meta Llama 3 release); the
# same table as the JAX package's.
CONFIGS: dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(
        name="tiny", vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=256, max_seq_len=256,
    ),
    "debug-1l": LlamaConfig(
        name="debug-1l", vocab_size=256, dim=64, n_layers=1, n_heads=2, n_kv_heads=1,
        ffn_dim=128, max_seq_len=128,
    ),
    "llama3-1b-proxy": LlamaConfig(
        name="llama3-1b-proxy", vocab_size=128_256, dim=2048, n_layers=16, n_heads=32,
        n_kv_heads=8, ffn_dim=8192, max_seq_len=8192,
    ),
    "llama3-8b": LlamaConfig(
        name="llama3-8b", vocab_size=128_256, dim=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, ffn_dim=14336, max_seq_len=8192,
    ),
    "llama3-70b": LlamaConfig(
        name="llama3-70b", vocab_size=128_256, dim=8192, n_layers=80, n_heads=64,
        n_kv_heads=8, ffn_dim=28672, max_seq_len=8192,
    ),
    "tiny-moe": LlamaConfig(
        name="tiny-moe", vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=256, max_seq_len=256, n_experts=4,
    ),
    "llama3-8x7b-proxy": LlamaConfig(
        name="llama3-8x7b-proxy", vocab_size=128_256, dim=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, ffn_dim=14336, max_seq_len=8192, n_experts=8,
    ),
}


def get_config(name: str, **overrides: Any) -> LlamaConfig:
    cfg = CONFIGS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _reject_moe(cfg: LlamaConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE configs are not ported to modal_tpu_torch yet "
            "(ROADMAP.md, PyTorch port queue: parallel/MoE)"
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: LlamaConfig, seed: int = 0, device=None) -> dict:
    """Random N(0, 0.02) weights and unit norm gains, sampled straight in
    `cfg.dtype` on the device from one seeded generator (8B's stacked
    `w_gate` alone is 3.7 GB: no fp32 or host staging copy)."""
    _reject_moe(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def normal(*shape: int) -> torch.Tensor:
        return torch.empty(shape, dtype=cfg.dtype, device=dev).normal_(0.0, 0.02, generator=gen)

    def ones(*shape: int) -> torch.Tensor:
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    return _param_tree(cfg, normal, ones)


def init_params_abstract(cfg: LlamaConfig) -> dict:
    """The param tree's shapes and dtypes as tensors on the "meta" device,
    which hold no memory (JAX: `jax.eval_shape` of `init_params`). The int8
    init and the AOT warm-up read shapes and bytes from it."""
    _reject_moe(cfg)

    def empty(*shape: int) -> torch.Tensor:
        return torch.empty(shape, dtype=cfg.dtype, device="meta")

    return _param_tree(cfg, empty, empty)


def _param_tree(cfg: LlamaConfig, normal: Callable, ones: Callable) -> dict:
    """The stacked param tree, each weight made by `normal(*shape)` and each
    norm gain by `ones(*shape)`, in the JAX package's key order."""
    hd = cfg.head_dim
    L = cfg.n_layers
    layers = {
        "attn_norm": ones(L, cfg.dim),
        "wq": normal(L, cfg.dim, cfg.n_heads * hd),
        "wk": normal(L, cfg.dim, cfg.n_kv_heads * hd),
        "wv": normal(L, cfg.dim, cfg.n_kv_heads * hd),
        "wo": normal(L, cfg.n_heads * hd, cfg.dim),
        "mlp_norm": ones(L, cfg.dim),
        "w_gate": normal(L, cfg.dim, cfg.ffn_dim),
        "w_up": normal(L, cfg.dim, cfg.ffn_dim),
        "w_down": normal(L, cfg.ffn_dim, cfg.dim),
    }
    return {
        "embed": normal(cfg.vocab_size, cfg.dim),
        "layers": layers,
        "final_norm": ones(cfg.dim),
        "lm_head": normal(cfg.dim, cfg.vocab_size),
    }


def layer_params(layers: dict | list, i: int) -> dict:
    """Layer `i`'s parameters: its slice of the stacked layer tree (views, no
    copy), or entry `i` of the training layout, a list of per-layer dicts
    (`convert.unstack_layers`)."""
    if isinstance(layers, list):
        return layers[i]
    return {
        k: ({"q": v["q"][i], "s": v["s"][i]} if is_quantized(v) else v[i])
        for k, v in layers.items()
    }


def params_device(params: dict) -> torch.device:
    embed = params["embed"]
    return (embed["q"] if is_quantized(embed) else embed).device


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    # fp32 reduction; cast to x.dtype BEFORE the gain (llama.py:176)
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rope_frequencies(cfg: LlamaConfig, device=None) -> torch.Tensor:
    """[head_dim/2] inverse frequencies (fp32)."""
    hd = cfg.head_dim
    exponents = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (cfg.rope_theta**exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S]. fp32 math, cast at the end."""
    angles = positions[..., None].float() * inv_freq  # [B, S, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, n_kv, hd] -> [B, S, n_kv*n_rep, hd] (head = kv*n_rep + rep)."""
    if n_rep == 1:
        return x
    b, s, nkv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, nkv, n_rep, hd).reshape(b, s, nkv * n_rep, hd)


def causal_mask(sq: int, sk: int, device=None) -> torch.Tensor:
    """[1, 1, Sq, Sk] additive fp32 mask, q and k aligned at position 0."""
    keep = torch.ones(sq, sk, dtype=torch.bool, device=device).tril()
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(keep, zero, float("-inf"))[None, None]


def attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Sk, H, hd]
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # [B, 1, Sq, Sk] additive (0 / -inf)
) -> torch.Tensor:
    """Reference attention: fp32 logits → fp32 softmax → probs cast to
    q.dtype → P·V. `mask=None` means pure causal with q and k aligned at
    position 0 (only valid when Sq == Sk); cache calls pass a mask."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    if mask is None:
        if q.shape[1] != k.shape[1]:
            raise ValueError(
                f"mask=None implies aligned causal attention but Sq={q.shape[1]} != Sk={k.shape[1]}"
            )
        mask = causal_mask(q.shape[1], k.shape[1], q.device)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits + mask, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@dataclasses.dataclass
class KVCache:
    """Static-shape dense cache: k/v [n_layers, B, max_seq, n_kv, hd],
    updated in place; `length` is the number of filled positions."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0

    @staticmethod
    def create(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None, device=None) -> "KVCache":
        dev = resolve_device(device)
        max_len = max_len or cfg.max_seq_len
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
            v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
            length=0,
        )


def swiglu(h: torch.Tensor, layer: dict, dtype: torch.dtype) -> torch.Tensor:
    """SiLU in fp32, cast back, times the up projection (llama.py:301)."""
    gate = F.silu(qmm(h, layer["w_gate"]).float()).to(dtype)
    return qmm(gate * qmm(h, layer["w_up"]), layer["w_down"])


def _layer_forward(
    cfg: LlamaConfig,
    x: torch.Tensor,  # [B, S, D]
    layer: dict,
    positions: torch.Tensor,  # [B, S]
    mask: Optional[torch.Tensor],
    inv_freq: torch.Tensor,
    cache_kv: Optional[tuple[torch.Tensor, torch.Tensor]],  # ([B, max, n_kv, hd], ...), written in place
    cache_offset: int,
    attn_impl: Callable,
) -> torch.Tensor:
    b, s, _d = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = qmm(h, layer["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = qmm(h, layer["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = qmm(h, layer["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    if cache_kv is not None:
        ck, cv = cache_kv
        ck[:, cache_offset : cache_offset + s] = k
        cv[:, cache_offset : cache_offset + s] = v
        k, v = ck, cv
    n_rep = cfg.n_heads // cfg.n_kv_heads
    attn_out = attn_impl(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep), mask)
    x = x + qmm(attn_out.reshape(b, s, cfg.n_heads * hd), layer["wo"])
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    return x + swiglu(h, layer, x.dtype)


def forward(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] int
    positions: Optional[torch.Tensor] = None,  # [B, S]
    cache: Optional[KVCache] = None,
    attn_impl: Optional[Callable] = None,
    remat: bool = False,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Full forward pass. Without cache: causal training/prefill forward,
    attention through `ops.attention.flash_attention` (the CUDA kernels for
    block-aligned bf16 sequences on the card, the einsum elsewhere). With
    cache: writes K/V at cache.length in place and attends over the cache.
    Returns (logits fp32 [B, S, V], cache with its length advanced).
    Autograd records the graph when grad mode is on and the params require
    grad; the serving callers run under `torch.no_grad()`."""
    logits, new_cache, _ = forward_with_aux(params, cfg, tokens, positions, cache, attn_impl, remat)
    return logits, new_cache


def forward_with_aux(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    attn_impl: Optional[Callable] = None,
    remat: bool = False,
) -> tuple[torch.Tensor, Optional[KVCache], torch.Tensor]:
    """`forward` plus the mean MoE aux loss (always 0.0: dense only).
    `remat` checkpoints each layer of the cache-less path (non-reentrant
    `torch.utils.checkpoint`, as JAX's `jax.checkpoint` of the scan body,
    llama.py:363-368): the backward recomputes one layer at a time from the
    inter-layer activations."""
    _reject_moe(cfg)
    b, s = tokens.shape
    dev = tokens.device
    if positions is None:
        base = cache.length if cache is not None else 0
        positions = (base + torch.arange(s, dtype=torch.int64, device=dev)).expand(b, s)
    x = qembed(params["embed"], tokens)  # [B, S, D]
    inv_freq = rope_frequencies(cfg, dev)
    layers = params["layers"]

    if cache is None:
        if attn_impl is None:
            from ..ops.attention import flash_attention

            attn_impl = flash_attention

        def layer_fn(x: torch.Tensor, layer: dict) -> torch.Tensor:
            return _layer_forward(cfg, x, layer, positions, None, inv_freq, None, 0, attn_impl)

        for i in range(cfg.n_layers):
            if remat:
                x = checkpoint(layer_fn, x, layer_params(layers, i), use_reentrant=False)
            else:
                x = layer_fn(x, layer_params(layers, i))
        new_cache = None
    else:
        offset = cache.length
        max_len = cache.k.shape[2]
        kv_pos = torch.arange(max_len, device=dev)[None, None, None, :]
        visible = kv_pos <= positions[:, None, :, None]
        mask = torch.where(visible, 0.0, float("-inf")).float()
        for i in range(cfg.n_layers):
            x = _layer_forward(
                cfg, x, layer_params(layers, i), positions, mask, inv_freq,
                (cache.k[i], cache.v[i]), offset, attn_impl or attention,
            )
        new_cache = KVCache(k=cache.k, v=cache.v, length=offset + s)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = qmm(x, params["lm_head"]).float()
    return logits, new_cache, torch.zeros((), dtype=torch.float32, device=dev)


# ---------------------------------------------------------------------------
# Loss (training)
# ---------------------------------------------------------------------------


def causal_lm_loss(
    params: dict, cfg: LlamaConfig, tokens: torch.Tensor, attn_impl: Optional[Callable] = None
) -> torch.Tensor:
    """Next-token cross-entropy, mean over all positions (llama.py:403).
    It forwards `tokens[:, :-1]`; the training step uses
    `parallel.train.loss_fn`, which forwards the full sequence."""
    logits, _ = forward(params, cfg, tokens[:, :-1], attn_impl=attn_impl)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None]).squeeze(-1).mean()
