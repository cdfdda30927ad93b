"""Per-dim mesh axes for the Llama parameter tree (port of
modal_tpu/parallel/sharding.py).

One table, `_LAYER_RULES` / `_MOE_LAYER_RULES` / `_TOP_RULES`, gives for
each param the mesh axis (or None) of every tensor dim: the content of the
JAX package's PartitionSpecs, as tuples. `placements` turns a spec into
DTensor placements over a DeviceMesh (Shard(i) on the mesh dim a tensor dim
names, Replicate elsewhere); a tensor dim that names two axes is sharded over
both, the first outermost, as a JAX spec's tuple entry is.

FSDP (`fsdp`): the largest weight dim is sharded. TP (`model`):
Megatron-style, qkv/gate/up column-parallel and o/down row-parallel. MoE:
experts over `expert`, within-expert dims over fsdp/model.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..models.llama import LlamaConfig

Spec = tuple  # one entry per tensor dim: a mesh axis name, a tuple of names, or None

# param key (under "layers") -> spec WITHOUT the stacked layer axis
_LAYER_RULES: dict[str, Spec] = {
    "attn_norm": (None,),
    "wq": ("fsdp", "model"),
    "wk": ("fsdp", "model"),
    "wv": ("fsdp", "model"),
    "wo": ("model", "fsdp"),
    "mlp_norm": (None,),
    "w_gate": ("fsdp", "model"),
    "w_up": ("fsdp", "model"),
    "w_down": ("model", "fsdp"),
}

# MoE FFN (cfg.n_experts > 0) in place of w_gate / w_up / w_down
_MOE_LAYER_RULES: dict[str, Spec] = {
    "router": (None, None),
    "w_in": ("expert", "fsdp", "model"),
    "w_out": ("expert", "model", "fsdp"),
}

_TOP_RULES: dict[str, Spec] = {
    "embed": ("model", "fsdp"),  # vocab over model, dim over fsdp
    "final_norm": (None,),
    "lm_head": ("fsdp", "model"),
}


def layer_specs(cfg: LlamaConfig) -> dict[str, Spec]:
    """Specs of one layer's params (no stacked axis)."""
    rules = dict(_LAYER_RULES)
    if cfg.is_moe:
        for k in ("w_gate", "w_up", "w_down"):
            rules.pop(k)
        rules.update(_MOE_LAYER_RULES)
    return rules


def param_specs(cfg: LlamaConfig, pipe: bool = False) -> dict:
    """Spec tree matching init_params' (stacked) structure. With `pipe=True`
    the stacked layer axis is sharded over `pipe` (each stage holds its
    contiguous block of layers)."""
    stack_axis = "pipe" if pipe else None
    return {
        "embed": _TOP_RULES["embed"],
        "layers": {k: (stack_axis, *spec) for k, spec in layer_specs(cfg).items()},
        "final_norm": _TOP_RULES["final_norm"],
        "lm_head": _TOP_RULES["lm_head"],
    }


def placements(mesh, spec: Spec) -> list:
    """DTensor placements over `mesh` for a spec (one per mesh dim)."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, entry in enumerate(spec)
                if entry == name or (isinstance(entry, tuple) and name in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def map_specs(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: map_specs(v, fn) for k, v in tree.items()}
    return fn(tree)


def param_shardings(mesh, cfg: LlamaConfig, pipe: bool = False) -> dict:
    """The placement tree of `param_specs` over `mesh`."""
    return map_specs(param_specs(cfg, pipe=pipe), lambda spec: placements(mesh, spec))


def batch_spec() -> Spec:
    """Tokens [B, S]: batch over (data, fsdp); `seq` shards S on the
    sequence-parallel path (`token_spec`)."""
    return (("data", "fsdp"), None)


def token_spec(seq: bool) -> Spec:
    return (("data", "fsdp"), "seq" if seq else None)


def logical_batch_size(mesh, per_device_batch: int) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return per_device_batch * sizes["data"] * sizes["fsdp"]


def local_chunk(t: torch.Tensor, mesh, pls: list) -> torch.Tensor:
    """This rank's piece of a full tensor under `pls` (mesh dims in order,
    each Shard cutting the piece the earlier dims left). The sharded dims
    must divide evenly."""
    coords = mesh.get_coordinate()
    for size, coord, pl in zip(mesh.shape, coords, pls):
        if isinstance(pl, Shard) and size > 1:
            d = pl.dim
            if t.shape[d] % size:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide over {size} ranks")
            n = t.shape[d] // size
            t = t.narrow(d, coord * n, n)
    return t


def distribute(t: torch.Tensor, mesh, pls: list) -> DTensor:
    """A DTensor over `mesh` from the same full tensor on every rank: each
    rank keeps a contiguous copy of its own piece (no communication)."""
    local = local_chunk(t, mesh, pls).contiguous().clone()
    return DTensor.from_local(local, mesh, pls, run_check=False, shape=t.shape, stride=t.contiguous().stride())


def place(mesh, tree: Any, pls: Any) -> Any:
    """Every leaf of a full tree as a DTensor with the placements at the
    same path of `pls`."""
    if isinstance(tree, dict):
        return {k: place(mesh, tree[k], pls[k]) for k in tree}
    return distribute(tree, mesh, pls)


def shard_params(mesh, cfg: LlamaConfig, params: dict, pipe: bool = False) -> dict:
    """Place a full (stacked) param tree on the mesh: every leaf a DTensor
    with its `param_shardings` placements."""
    return place(mesh, params, param_shardings(mesh, cfg, pipe=pipe))


def full_tensor(p: DTensor) -> torch.Tensor:
    """The whole tensor on every rank of `p`'s mesh, all-gathered dim by
    dim, innermost mesh dim first (what `DTensor.full_tensor` gives, without
    its redistribute planner)."""
    import torch.distributed as dist

    x = p._local_tensor.detach()
    mesh = p.device_mesh
    for name, size, pl in reversed(list(zip(mesh.mesh_dim_names, mesh.shape, p.placements))):
        if isinstance(pl, Shard) and size > 1:
            parts = [torch.empty_like(x) for _ in range(size)]
            dist.all_gather(parts, x.contiguous(), group=mesh.get_group(name))
            x = torch.cat(parts, dim=pl.dim)
    return x


def shard_train_params(mesh, params: dict, specs: dict) -> dict:
    """The training layout on a mesh from a full stacked tree (the same on
    every rank): embed / final_norm / lm_head DTensors over `mesh`, and
    `layers` a list of per-layer dicts of DTensors. When the specs shard
    the stacked axis over `pipe`, each stage holds its contiguous block of
    layers as DTensors over its stage's sub-mesh (the mesh without `pipe`),
    and the other stages' entries are None."""
    top = {k: distribute(params[k], mesh, placements(mesh, specs[k])) for k in ("embed", "final_norm", "lm_head")}
    layer_specs_ = specs["layers"]
    n_layers = next(iter(params["layers"].values())).shape[0]
    own, layer_mesh = range(n_layers), mesh
    if any(spec[0] == "pipe" for spec in layer_specs_.values()):
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        n_stages = sizes["pipe"]
        if n_layers % n_stages:
            raise ValueError(f"pipe={n_stages} must divide n_layers={n_layers}")
        per = n_layers // n_stages
        stage = mesh.get_coordinate()[mesh.mesh_dim_names.index("pipe")]
        own = range(stage * per, (stage + 1) * per)
        layer_mesh = mesh[tuple(n for n in mesh.mesh_dim_names if n != "pipe")]
    layers = [
        {k: distribute(v[i], layer_mesh, placements(layer_mesh, layer_specs_[k][1:])) for k, v in params["layers"].items()}
        if i in own else None
        for i in range(n_layers)
    ]
    return {**top, "layers": layers}


def gather_train_params(mesh, params: dict) -> dict:
    """The full stacked tree on every rank from the training layout of
    `shard_train_params` (a collective: every rank calls it)."""
    import torch.distributed as dist

    top = {k: full_tensor(params[k]) for k in ("embed", "final_norm", "lm_head")}
    mine = [layer for layer in params["layers"] if layer is not None]
    full = [{k: full_tensor(v) for k, v in layer.items()} for layer in mine]
    if len(mine) == len(params["layers"]):
        layers = full
    else:  # each stage's block, gathered over pipe in stage order
        group = mesh.get_group("pipe")
        n_stages = dist.get_world_size(group)
        blocks = [[None] * len(full) for _ in range(n_stages)]
        for li, layer in enumerate(full):
            for k, t in layer.items():
                parts = [torch.empty_like(t) for _ in range(n_stages)]
                dist.all_gather(parts, t.contiguous(), group=group)
                for st in range(n_stages):
                    blocks[st][li] = {**(blocks[st][li] or {}), k: parts[st]}
        layers = [layer for block in blocks for layer in block]
    return {**top, "layers": {k: torch.stack([layer[k] for layer in layers]) for k in layers[0]}}


def pipeline_param_specs(cfg: LlamaConfig) -> dict:
    """The pipeline's own specs (pipeline.py:150): the stacked layers split
    over `pipe`, embed and head replicated."""
    return {
        "embed": (None, None),
        "final_norm": (None,),
        "lm_head": (None, None),
        "layers": {k: ("pipe",) + (None,) * len(spec) for k, spec in layer_specs(cfg).items()},
    }


def local_grads(params: dict) -> dict:
    """The training layout's gradients as DTensors placed like their params
    (each made from its param's local piece's `.grad`), for
    `gather_train_params`."""

    def grad(p: Any) -> Any:
        if p is None:
            return None
        return DTensor.from_local(p._local_tensor.grad, p.device_mesh, p.placements, run_check=False,
                                  shape=p.shape, stride=p.stride())

    top = {k: grad(params[k]) for k in ("embed", "final_norm", "lm_head")}
    return {**top, "layers": [None if layer is None else {k: grad(v) for k, v in layer.items()}
                              for layer in params["layers"]]}
