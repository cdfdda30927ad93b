"""JAX param tree (pulled to host numpy) → the port's param tree, and the
stacked ⇄ per-layer layouts.

The caller does the JAX side: `jax.tree_util.tree_map(np.asarray, params)`.
Keys, nesting, stacked layer axes and the `[in, out]` weight layout carry
over unchanged, quantized `{"q", "s"}` leaves included. bf16 arrays arrive
as `ml_dtypes.bfloat16`, which `torch.from_numpy` refuses: they travel as
their raw 16-bit patterns (`view(np.uint16)` → torch → `view(bfloat16)`).

`unstack_layers` / `stack_layers` move `params["layers"]` between the
stacked `{key: [n_layers, ...]}` layout (JAX, `init_params`, serving) and the
training layout, a list of per-layer dicts, bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import resolve_device
from .llama import layer_params


def tensor_from_numpy(arr: Any, device=None) -> torch.Tensor:
    dev = resolve_device(device)
    a = np.array(np.asarray(arr), order="C", copy=True)  # writable: torch shares the buffer
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(dev)


def params_from_jax(tree: Any, device=None) -> Any:
    """Walk a nested dict of numpy arrays; every leaf becomes a tensor on
    `device` (dtype preserved bit for bit)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def unstack_layers(params: dict) -> dict:
    """The training layout: `params["layers"]` as a list of n_layers dicts
    whose leaves are copies of the stacked slices (the stacked tree can then
    be dropped). Other entries are shared, not copied."""
    layers = params["layers"]
    first = next(iter(layers.values()))
    n_layers = (first["q"] if isinstance(first, dict) else first).shape[0]
    per_layer = [_map(layer_params(layers, i), torch.clone) for i in range(n_layers)]
    return {**params, "layers": per_layer}


def stack_layers(params: dict) -> dict:
    """The inverse of `unstack_layers`: `params["layers"]` stacked back to
    `{key: [n_layers, ...]}`."""
    layers = params["layers"]

    def stack(key: str) -> Any:
        leaves = [layer[key] for layer in layers]
        if isinstance(leaves[0], dict):
            return {k: torch.stack([leaf[k] for leaf in leaves]) for k in leaves[0]}
        return torch.stack(leaves)

    return {**params, "layers": {key: stack(key) for key in layers[0]}}
