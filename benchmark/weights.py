"""Seeded weights, made on the device in the served dtype.

Every weight matrix is N(0, initializer_range), every norm gain 1, the
layout the program takes (stacked `[layers, in, out]`, the product `x @ w`).
Each tensor comes from a generator of its own, seeded from the run's seed
and the tensor's name, in one call: a tensor can be made again alone, and
the same seed always gives the same weights. The reference makes them
again after the window rather than read anything the program held."""

from __future__ import annotations

import hashlib

import torch

from .models import Model


def shapes(m: Model) -> dict:
    """{name: shape} of every weight; norm gains are the names ending in `norm`."""
    d, hd, n_l = m.hidden_size, m.head_dim, m.num_hidden_layers
    return {
        "embed": (m.vocab_size, d),
        "final_norm": (d,),
        "lm_head": (d, m.vocab_size),
        "layers.attn_norm": (n_l, d),
        "layers.wq": (n_l, d, m.num_attention_heads * hd),
        "layers.wk": (n_l, d, m.num_key_value_heads * hd),
        "layers.wv": (n_l, d, m.num_key_value_heads * hd),
        "layers.wo": (n_l, m.num_attention_heads * hd, d),
        "layers.mlp_norm": (n_l, d),
        "layers.w_gate": (n_l, d, m.intermediate_size),
        "layers.w_up": (n_l, d, m.intermediate_size),
        "layers.w_down": (n_l, m.intermediate_size, d),
    }


def tensor_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def make_tensor(m: Model, seed: int, name: str, device) -> torch.Tensor:
    shape = shapes(m)[name]
    if name.endswith("norm"):
        return torch.ones(shape, dtype=m.dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(tensor_seed(seed, name))
    return torch.empty(shape, dtype=m.dtype, device=device).normal_(0.0, m.initializer_range, generator=gen)


def make(m: Model, seed: int, device) -> dict:
    """The whole tree: {"embed", "layers": {key: stacked}, "final_norm", "lm_head"}."""
    tree: dict = {"layers": {}}
    for name in shapes(m):
        t = make_tensor(m, seed, name, device)
        if name.startswith("layers."):
            tree["layers"][name.split(".", 1)[1]] = t
        else:
            tree[name] = t
    return tree
