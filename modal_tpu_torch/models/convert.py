"""JAX param tree (pulled to host numpy) → the port's param tree.

The caller does the JAX side: `jax.tree_util.tree_map(np.asarray, params)`.
Keys, nesting, stacked layer axes and the `[in, out]` weight layout carry
over unchanged, quantized `{"q", "s"}` leaves included. bf16 arrays arrive
as `ml_dtypes.bfloat16`, which `torch.from_numpy` refuses: they travel as
their raw 16-bit patterns (`view(np.uint16)` → torch → `view(bfloat16)`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import resolve_device


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
