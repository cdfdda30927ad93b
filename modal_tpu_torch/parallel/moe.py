"""Expert parallelism: the switch-style MoE FFN (port of
modal_tpu/parallel/moe.py).

Top-1 routing with a static capacity, `int(capacity_factor · T / E)` slots
per expert; a token past its expert's capacity is dropped (its FFN output
is 0). Each token's place in its expert's queue is its rank among the
tokens routed there in global token order. aux = E · Σ_e frac_e · mean_prob_e
(the Switch load-balancing loss); the dropped fraction beside it. The
dispatch and combine are einsums over one-hot [T, E, C] tensors, as in JAX:
plain torch, there is no Pallas kernel here.

On a mesh (`moe_layer` with a `SpmdPlan`), JAX's global semantics hold on
local tokens:
- the tokens a rank holds are split further over the `expert` ranks (which
  hold the same tokens: the batch is not sharded over `expert`);
- T is the global token count; each slice's queue positions start at the
  exclusive prefix of per-expert counts over the slices before it in
  global token order (an all-gather of [E] counts per row segment);
- aux and the dropped fraction are global sums (all-reduced);
- with `expert` > 1 the [E, C, D] blocks go to the ranks holding their
  experts by all-to-all and come back the same way; with `model` > 1 the
  FFN dim is sharded and the expert outputs summed over `model`.
A token's FFN output does not depend on which slot it takes, so a slice
packs its kept tokens into its own `min(C, T_slice)` slots.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import resolve_device


def init_moe_params(seed: int, dim: int, ffn_dim: int, n_experts: int, dtype=torch.float32, device=None) -> dict:
    """N(0, 0.02) router [D, E], w_in [E, D, F] and w_out [E, F, D] from
    one seeded generator on the device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def normal(*shape: int) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device=dev).normal_(0.0, 0.02, generator=gen)

    return {"router": normal(dim, n_experts), "w_in": normal(n_experts, dim, ffn_dim),
            "w_out": normal(n_experts, ffn_dim, dim)}


def moe_param_shardings(mesh, axis_name: str = "expert") -> dict:
    """Placements: the router replicated, the experts sharded over `axis_name`."""
    from torch.distributed.tensor import Replicate, Shard

    def pls(shard: bool) -> list:
        return [Shard(0) if (shard and n == axis_name) else Replicate() for n in mesh.mesh_dim_names]

    return {"router": pls(False), "w_in": pls(True), "w_out": pls(True)}


def _qeinsum(eq: str, x: torch.Tensor, w) -> torch.Tensor:
    """einsum for plain or int8 weights ({"q", "s"}: the scale applies to
    the output, per output channel). The int8 weight is converted whole on
    every call, as `quant.qmm` does (ROADMAP Queue C 6)."""
    from ..models.quant import is_quantized

    if is_quantized(w):
        y = torch.einsum(eq, x, w["q"].to(x.dtype))
        return y * w["s"].to(x.dtype)
    return torch.einsum(eq, x, w)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class _Ranks:
    """The collectives of a sharded `moe_ffn`: `token_groups` (ranks that
    hold other tokens), `expert_group` (the all-to-all), `model_group` (the
    FFN dim), and the segment keys of this rank's tokens."""

    def __init__(self, token_groups: list, expert_group, model_group, seg_keys: torch.Tensor, seg_len: int):
        self.token_groups = token_groups
        self.expert_group = expert_group
        self.model_group = model_group
        self.seg_keys = seg_keys  # [n_seg] global index of each segment's first token
        self.seg_len = seg_len

    def token_count(self, t: int) -> int:
        for g in self.token_groups:
            t *= dist.get_world_size(g)
        return t

    def offsets(self, counts: torch.Tensor) -> torch.Tensor:
        """[n_seg, E] number of tokens routed to each expert in the global
        token order before each of this rank's segments."""
        keys, cnts = self.seg_keys, counts
        for g in self.token_groups:
            n = dist.get_world_size(g)
            kl = [torch.empty_like(keys) for _ in range(n)]
            cl = [torch.empty_like(cnts) for _ in range(n)]
            dist.all_gather(kl, keys.contiguous(), group=g)
            dist.all_gather(cl, cnts.contiguous(), group=g)
            keys, cnts = torch.cat(kl), torch.cat(cl)
        order = torch.argsort(keys)
        before = torch.cumsum(cnts[order], dim=0) - cnts[order]  # exclusive, in global order
        at = torch.searchsorted(keys[order], self.seg_keys)
        return before[at]


def moe_ffn(
    x: torch.Tensor,  # [T, D] tokens (on a mesh: this rank's, in segments of global order)
    params: dict,
    capacity_factor: float = 1.25,
    act: Optional[Callable] = None,  # activation; default gelu (llama passes silu)
    ranks: Optional[_Ranks] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-1 switch MoE. Returns (y [T, D], aux_loss, dropped_fraction),
    aux and dropped as fp32 scalars over all tokens."""
    from .spmd import all_to_all, copy_to, reduce_from

    act = act or _gelu
    t, d = x.shape
    router = params["router"]
    e = (router["q"] if isinstance(router, dict) else router).shape[-1]
    t_all = t if ranks is None else ranks.token_count(t)
    capacity = max(1, int(capacity_factor * t_all / e))

    from ..models.quant import qmm

    logits = qmm(x, router)  # [T, E]
    probs = torch.softmax(logits.float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)  # [T]
    gate = probs.gather(-1, expert[:, None])[:, 0]  # [T]
    onehot = F.one_hot(expert, e).to(torch.float32)  # [T, E]

    # queue positions: rank among the tokens routed to the same expert, in
    # global token order (this rank's segments start after the counts of
    # every segment before them)
    cum = torch.cumsum(onehot, dim=0)
    if ranks is not None:
        seg_onehot = onehot.reshape(-1, ranks.seg_len, e)
        seg_counts = seg_onehot.sum(dim=1)  # [n_seg, E]
        seg_cum = torch.cumsum(seg_onehot, dim=1) + ranks.offsets(seg_counts)[:, None, :]
        pos_global = (seg_cum.reshape(t, e) - 1.0) * onehot
    else:
        pos_global = (cum - 1.0) * onehot
    keep = (pos_global < capacity) * onehot  # [T, E]: overflow dropped
    # this rank's slots: kept tokens are a prefix of each expert's routed
    # tokens here, so their local rank among the routed ones is < slots
    slots = min(capacity, t)
    pos_local = ((cum - 1.0) * keep).sum(dim=-1).to(torch.int64).clamp(max=slots - 1)
    slot = F.one_hot(pos_local, slots).to(torch.float32)
    dispatch = (keep[:, :, None] * slot[:, None, :]).to(x.dtype)  # [T, E, C], exact 0/1

    expert_in = torch.einsum("tec,td->ecd", dispatch, x)  # [E, C, D]
    w_in, w_out = params["w_in"], params["w_out"]
    n_local = (w_in["q"] if isinstance(w_in, dict) else w_in).shape[0]
    group = ranks.expert_group if ranks is not None else None
    if n_local != e:  # experts sharded: blocks to the ranks that hold them
        n = e // n_local
        expert_in = all_to_all(expert_in, group)  # [n·E_l, C, D]: block r from rank r
        expert_in = expert_in.reshape(n, n_local, slots, d).transpose(0, 1).reshape(n_local, n * slots, d)
    mgroup = ranks.model_group if ranks is not None else None
    h = act(_qeinsum("ecd,edf->ecf", copy_to(expert_in, mgroup), w_in))
    expert_out = reduce_from(_qeinsum("ecf,efd->ecd", h, w_out), mgroup)
    if n_local != e:
        expert_out = expert_out.reshape(n_local, n, slots, d).transpose(0, 1).reshape(e, slots, d)
        expert_out = all_to_all(expert_out, group)
    combine = dispatch * gate.to(x.dtype)[:, None, None]
    y = torch.einsum("tec,ecd->td", combine, expert_out)

    # Switch load balancing: E · Σ_e frac_tokens_e · mean_prob_e, global
    kept = keep.sum()
    sums = torch.cat([onehot.sum(dim=0), probs.sum(dim=0), kept[None]])
    if ranks is not None:
        for g in ranks.token_groups:
            sums = reduce_from(sums, g)
    frac_tokens, mean_probs = sums[:e] / t_all, sums[e : 2 * e] / t_all
    aux = e * torch.sum(frac_tokens * mean_probs)
    dropped = 1.0 - sums[2 * e].detach() / t_all
    return y.to(x.dtype), aux, dropped


def moe_layer(h: torch.Tensor, layer: dict, cfg, act: Callable, plan=None):
    """The MoE FFN of one llama layer on h [B, S, D]. Without a plan: JAX's
    `moe_ffn(h.reshape(B·S, D))`. With one (h is this rank's [B_l, S_l, D]
    block, the same on every expert rank), each expert rank takes its
    1/expert of every row's positions, routes them with global queue
    positions and takes the all-to-all; the outputs are all-gathered back."""
    from .spmd import gather_from, scatter_to

    b, s, d = h.shape
    params = {"router": layer["router"], "w_in": layer["w_in"], "w_out": layer["w_out"]}
    if plan is None:
        y, aux, dropped = moe_ffn(h.reshape(b * s, d), params, cfg.capacity_factor, act=act)
        return y.reshape(b, s, d), aux, dropped
    n_exp = plan.sizes["expert"]
    if s % n_exp:
        raise ValueError(f"the sequence shard ({s}) must divide over expert={n_exp}")
    sub = s // n_exp
    xs = scatter_to(h, 1, plan.group("expert"))  # [B_l, S_l / expert, D]
    b0 = plan.coords["data"] * plan.sizes["fsdp"] * b + plan.coords["fsdp"] * b
    s_full = s * plan.sizes["seq"]
    s0 = plan.coords["seq"] * s + plan.coords["expert"] * sub
    keys = (b0 + torch.arange(b, device=h.device)) * s_full + s0
    ranks = _Ranks(plan.token_groups(with_expert=True), plan.group("expert"), plan.group("model"), keys, sub)
    y, aux, dropped = moe_ffn(xs.reshape(b * sub, d), params, cfg.capacity_factor, act=act, ranks=ranks)
    return gather_from(y.reshape(b, sub, d), 1, plan.group("expert")), aux, dropped


def moe_demo(
    n_experts: int = 4, dim: int = 64, ffn_dim: int = 128, tokens: int = 256, device=None
) -> dict:
    """One loss + grad of the MoE FFN on seeded params and inputs (the JAX
    demo shards the experts over an `expert` mesh; this runs on one rank)."""
    dev = resolve_device(device)
    params = init_moe_params(0, dim, ffn_dim, n_experts, device=dev)
    for p in params.values():
        p.requires_grad_(True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn(tokens, dim, generator=gen, device=dev)
    y, aux, dropped = moe_ffn(x, params)
    loss = torch.mean(y**2) + 0.01 * aux
    loss.backward()
    grad_l1 = sum(float(p.grad.abs().sum()) for p in params.values())
    return {"loss": loss.item(), "aux_loss": aux.item(), "dropped_frac": dropped.item(), "grad_l1": grad_l1}
