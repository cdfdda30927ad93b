"""Pipeline parallelism: GPipe microbatching over the `pipe` mesh axis
(port of modal_tpu/parallel/pipeline.py).

Stage p holds layers [p·L/P, (p+1)·L/P) (`sharding.shard_train_params`
with the stacked axis over `pipe`). The embedding runs outside the
pipeline, on every stage; microbatches then flow through the stages for
M + P − 1 ticks. Every tick, every stage runs its layer block on its
current activation (uniform work, as in JAX), stage 0 first taking
microbatch t, and the activations move one stage on (`spmd.ring_shift`,
JAX's `ppermute`); the last stage collects microbatch t − P + 1. The
collection is fp32 at the stage boundary, as in JAX (:79, :111), and summed
over `pipe` (only the last stage's is non-zero), so every stage computes
the head and the loss. The backward is autograd's through the ring shifts,
each of which sends its cotangent back one stage: the transposed schedule
JAX derives (:117, :127).

Each stage's layers are gathered once per call (FSDP / TP within the stage
go through `SpmdPlan.localize`); attention is the einsum unless an
`attn_impl` (ring attention over `seq`) is given, as in JAX.
"""

from __future__ import annotations

import torch

from ..config import resolve_device


def pipeline_loss(
    params: dict,
    cfg,
    tokens: torch.Tensor,  # [B_l, S_l]: this rank's tokens
    plan,  # parallel.spmd.SpmdPlan over a mesh with a pipe axis
    num_microbatches: int,
    axis_name: str = "pipe",
    attn_impl=None,
) -> torch.Tensor:
    """Next-token loss with the layer stack pipelined over `axis_name`;
    `params` in the training layout of `shard_train_params` (this stage's
    layers, None elsewhere). Returns the global mean loss on every rank."""
    from ..models.llama import _layer_forward, attention, rms_norm, rope_frequencies
    from ..models.quant import qembed
    from .mesh import MeshConstraintError
    from .spmd import reduce_from, ring_shift

    if cfg.is_moe:
        raise MeshConstraintError(
            "pipeline parallelism cannot compose with MoE layers: the GPipe stage "
            "loop assumes a uniform dense layer block per stage. Use expert "
            "parallelism (mesh expert axis) without pipe."
        )
    n_stages = plan.sizes[axis_name]
    if cfg.n_layers % n_stages:
        raise ValueError(f"pipe={n_stages} must divide n_layers={cfg.n_layers}")
    b, s = tokens.shape
    if b % num_microbatches:
        raise ValueError(f"microbatches {num_microbatches} must divide batch {b}")
    mb = b // num_microbatches
    dev = tokens.device
    stage = plan.coords[axis_name]
    group, ranks = plan.group(axis_name), plan.ranks[axis_name]
    inv_freq = rope_frequencies(cfg, dev)
    positions = plan.positions(mb, s, dev)
    embed = plan.localize(params["embed"], "embed")
    x = qembed(embed, tokens).reshape(num_microbatches, mb, s, cfg.dim).float()
    layers = [plan.localize_layer(layer) for layer in params["layers"] if layer is not None]
    attn = attn_impl or attention
    first = torch.tensor(stage == 0, device=dev)
    last = float(stage == n_stages - 1)

    ticks = num_microbatches + n_stages - 1
    act = torch.zeros((mb, s, cfg.dim), dtype=cfg.dtype, device=dev)
    collected = []
    for t in range(ticks):
        inject = x[min(t, num_microbatches - 1)].to(cfg.dtype)
        act = torch.where(first, inject, act)  # both branches stay in the graph on every stage
        for layer in layers:
            act, _aux = _layer_forward(cfg, act, layer, positions, None, inv_freq, None, 0, attn, plan)
        if t >= n_stages - 1:  # the last stage finishes microbatch t - P + 1
            collected.append(act.float())
        if t + 1 < ticks:
            act = ring_shift(act, group, ranks)
    out = reduce_from(torch.stack(collected) * last, group)  # [M, mb, S, D] fp32

    final_norm = plan.localize(params["final_norm"], "head")
    lm_head = plan.localize(params["lm_head"], "head")
    h = rms_norm(out.reshape(b, s, cfg.dim), final_norm, cfg.norm_eps)
    logits = (h @ lm_head.to(h.dtype)).float()
    return plan.next_token_loss(logits, tokens)


def pipeline_param_shardings(mesh, cfg) -> dict:
    """Placements: the stacked layers split over `pipe`, embed and head
    replicated (pipeline.py:150)."""
    from .sharding import map_specs, pipeline_param_specs, placements

    return map_specs(pipeline_param_specs(cfg), lambda spec: placements(mesh, spec))


def pipeline_demo(
    cfg_name: str = "tiny",
    n_stages: int = 2,
    num_microbatches: int = 4,
    batch: int = 8,
    seq_len: int = 64,
    device=None,
) -> dict:
    """One pipelined loss + grad on the mesh {"pipe": n_stages} of the
    current process group (every rank calls it; the remainder of the world
    goes to fsdp), params from `init_params(seed 0)` placed by
    `pipeline_param_shardings`."""
    from ..models.llama import get_config, init_params
    from .mesh import build_mesh
    from .sharding import gather_train_params, local_grads, pipeline_param_specs, shard_train_params
    from .spmd import SpmdPlan

    dev = resolve_device(device)
    cfg = get_config(cfg_name)
    mesh = build_mesh({"pipe": n_stages}, model_cfg=cfg)
    plan = SpmdPlan(mesh, pipelined=True)
    params = shard_train_params(mesh, init_params(cfg, 0, dev), pipeline_param_specs(cfg))
    held = [params[k] for k in ("embed", "final_norm", "lm_head")]
    held += [t for layer in params["layers"] if layer is not None for t in layer.values()]
    for p in held:
        p._local_tensor.requires_grad_(True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq_len), generator=gen, device=dev)
    loss = pipeline_loss(params, cfg, plan.local_tokens(tokens), plan, num_microbatches)
    loss.backward()
    full = gather_train_params(mesh, local_grads(params))
    grad_l1 = sum(float(t.abs().sum()) for t in [full["embed"], full["final_norm"], full["lm_head"],
                                                  *full["layers"].values()])
    return {"loss": float(loss), "grad_l1": grad_l1}
