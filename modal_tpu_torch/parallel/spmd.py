"""One rank's view of a mesh, and collectives with the gradients JAX's
GSPMD derives (the port's counterpart of jit over NamedShardings).

Under GSPMD every JAX function computes as if on unsharded arrays. The port
runs one process per rank on local pieces, so it places each collective
itself, and each is an autograd Function whose backward is the transposed
communication. The convention: a tensor replicated over some ranks carries
the FULL gradient on each of them (all of them compute the same thing
downstream). Hence:

- `reduce_from` (a sum over ranks): all-reduce forward, identity backward;
- `copy_to` (a replicated input into rank-local work): identity forward,
  all-reduce backward (Megatron's f; `reduce_from` is its g);
- `gather_from` / `scatter_to`: all-gather a dim / take this rank's slice,
  each the other's backward;
- `all_to_all`: the exchange of dim-0 blocks, its own backward;
- `ring_shift`: send to the next rank of a ring and receive from the
  previous (JAX's `ppermute` by +1); backward the other way round.

Params are DTensors placed by `sharding.param_shardings`; the autograd
leaves are their local pieces (`DTensor._local_tensor`, which the optimizer
updates in place). `SpmdPlan.localize` turns one into the tensor the rank
computes with: all-gathered over fsdp (and over model for the embedding and
the head, which run whole on every rank), kept sharded over model and
expert. Its backward combines the rank's gradient as DTensor's Partial
placement would: summed over the axes whose ranks hold different tokens
(data, fsdp, seq; expert inside the MoE, whose tokens are split over expert
ranks; pipe for the embedding, which only stage 0 injects), by a
reduce-scatter where the param is sharded and an all-reduce where it is
replicated, as XLA does for the JAX step. The collectives are placed here,
not by DTensor's redistribute, whose planner searches placement states
(over a six-dim mesh, minutes for one 3-D expert stack).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

# axes whose ranks hold different tokens of the batch (sharding.token_spec)
TOKEN_AXES = ("data", "fsdp", "seq")
# keys of the MoE FFN, whose tokens are split over the expert ranks
MOE_KEYS = frozenset({"router", "w_in", "w_out"})


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    return x.chunk(n, dim=dim)[r].contiguous()


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group, this rank's chunk of `dim` kept."""
    if dist.get_backend(group) == "nccl":
        n = dist.get_world_size(group)
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous()
    return _slice(_all_reduce(x, group), dim, group)  # gloo has no reduce-scatter


class _Localize(torch.autograd.Function):
    """A param's local piece → the tensor the rank computes with. `steps`:
    per mesh dim, (group, gather dim or None, backward) with backward one
    of "sum" (all-reduce), "sum_scatter" (reduce-scatter on the gather
    dim), "slice" (keep this rank's chunk) or None."""

    @staticmethod
    def forward(ctx, local, steps):
        ctx.steps = steps
        x = local
        for group, dim, _back in steps:
            if dim is not None:
                x = _all_gather(x, dim, group)
        return x

    @staticmethod
    def backward(ctx, g):
        for group, dim, back in reversed(ctx.steps):
            if back == "sum":
                g = _all_reduce(g, group)
            elif back == "sum_scatter":
                g = _reduce_scatter(g, dim, group)
            elif back == "slice":
                g = _slice(g, dim, group)
        return g, None


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def _shift(x: torch.Tensor, group, ranks: list, step: int) -> torch.Tensor:
    """Send `x` to the rank `step` places on in `ranks` (global ranks of
    the ring), receive from the one `step` places back."""
    me = ranks.index(dist.get_rank())
    n = len(ranks)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(me + step) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(me - step) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, ranks):
        ctx.group, ctx.ranks = group, ranks
        return _shift(x, group, ranks, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, ctx.ranks, -1), None, None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherFrom.apply(x, dim, group)


def scatter_to(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _ScatterTo.apply(x, dim, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Rank r's block i (of dim 0 cut into group-size blocks) goes to rank
    i's block r."""
    return x if group is None else _AllToAll.apply(x, group)


def ring_shift(x: torch.Tensor, group, ranks: list) -> torch.Tensor:
    return x if group is None else _RingShift.apply(x, group, ranks)


class SpmdPlan:
    """This rank's coordinates, groups and rules on a mesh built by
    `mesh.build_mesh`. `pipelined` marks the GPipe path: layers live on the
    stage's sub-mesh (their norms sum over `pipe`)."""

    def __init__(self, mesh, pipelined: bool = False):
        self.mesh = mesh
        self.sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        self.coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self.pipelined = pipelined
        self.groups = {a: (mesh.get_group(a) if n > 1 else None) for a, n in self.sizes.items()}
        self.ranks = {a: mesh[a].mesh.tolist() for a in self.sizes}

    def group(self, axis: str):
        """The process group along `axis`, None when it has one rank."""
        return self.groups[axis]

    def size(self, *axes: str) -> int:
        n = 1
        for a in axes:
            n *= self.sizes[a]
        return n

    def token_groups(self, with_expert: bool = False) -> list:
        """The groups over which ranks hold different tokens."""
        axes = TOKEN_AXES + (("expert",) if with_expert else ())
        return [self.groups[a] for a in axes if self.groups[a] is not None]

    def reduce_tokens(self, x: torch.Tensor, with_expert: bool = False) -> torch.Tensor:
        """Sum over the token-holding ranks (all-reduce forward, identity
        backward): a rank-local sum becomes the global one."""
        for g in self.token_groups(with_expert):
            x = reduce_from(x, g)
        return x

    # -- params --------------------------------------------------------------------------

    def localize(self, p, kind: str = "layer") -> torch.Tensor:
        """The tensor this rank computes with for the DTensor param `p`
        (whose local piece is the autograd leaf). `kind`: "layer", "moe"
        (router / w_in / w_out), "embed" or "head"."""
        steps = []
        whole = kind in ("embed", "head")
        for name, pl in zip(p.device_mesh.mesh_dim_names, p.placements):
            if self.sizes[name] == 1:
                continue
            sharded = isinstance(pl, Shard)
            if name in ("model", "expert") and sharded and not whole:
                continue  # computed on this rank's shard
            partial = name in TOKEN_AXES or (name == "expert" and kind == "moe") or (name == "pipe" and kind == "embed")
            if sharded:
                steps.append((self.groups[name], pl.dim, "sum_scatter" if partial else "slice"))
            elif partial:
                steps.append((self.groups[name], None, "sum"))
        local = p._local_tensor
        return _Localize.apply(local, steps) if steps else local

    def localize_layer(self, layer: dict) -> dict:
        return {k: self.localize(v, "moe" if k in MOE_KEYS else "layer") for k, v in layer.items()}

    # -- activations ---------------------------------------------------------------------

    def tp_enter(self, h: torch.Tensor) -> torch.Tensor:
        """A replicated activation into the model-sharded projections."""
        return copy_to(h, self.groups["model"])

    def tp_exit(self, y: torch.Tensor) -> torch.Tensor:
        """The row-parallel projections' partial sums, summed over `model`."""
        return reduce_from(y, self.groups["model"])

    def positions(self, b: int, s_local: int, device) -> torch.Tensor:
        """Global positions [b, s_local] of this rank's sequence shard."""
        s0 = self.coords["seq"] * s_local
        return (s0 + torch.arange(s_local, dtype=torch.int64, device=device)).expand(b, s_local)

    def next_tokens(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(targets, valid) for the next-token loss on a [B, S_local] shard
        of the sequence: position s's target is token s + 1, which for the
        shard's last position is the next shard's first token; the last
        shard's last position has none (valid False)."""
        g = self.groups["seq"]
        if g is None:
            nxt = tokens[:, :1]  # unused: the only shard is the last
        else:
            firsts = _all_gather(tokens[:, :1].contiguous(), 1, g)  # [B, n_seq]
            nxt = firsts[:, (self.coords["seq"] + 1) % self.sizes["seq"]][:, None]
        targets = torch.cat([tokens[:, 1:], nxt], dim=1)
        valid = torch.ones_like(targets, dtype=torch.bool)
        if self.coords["seq"] == self.sizes["seq"] - 1:
            valid[:, -1] = False
        return targets, valid

    def next_token_loss(self, logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The mean next-token NLL over the GLOBAL batch (B · (S − 1)
        positions, train.py:74-76) from this rank's logits [B_l, S_l, V]
        and tokens, summed over the token-holding ranks."""
        targets, valid = self.next_tokens(tokens)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None].long()).squeeze(-1)
        b, s = tokens.shape
        total = b * self.size("data", "fsdp") * (s * self.size("seq") - 1)
        local = torch.where(valid, nll, torch.zeros_like(nll)).sum() / total
        return self.reduce_tokens(local)

    def local_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's [B / (data·fsdp), S / seq] block of the global
        tokens (a DTensor's local piece, or cut from a full tensor)."""
        from torch.distributed.tensor import DTensor

        from .sharding import local_chunk, placements, token_spec

        if isinstance(tokens, DTensor):
            return tokens.to_local()
        return local_chunk(tokens, self.mesh, placements(self.mesh, token_spec(self.sizes["seq"] > 1)))


def global_sq_norm(params: list, grads: list, plan: SpmdPlan) -> torch.Tensor:
    """Σ‖g‖² in fp32 of the local pieces `grads` of the DTensor `params`'
    gradients, on the device with no host sync: each piece's squared norm,
    summed over the mesh dims along which the pieces differ (the dims its
    param is sharded over, and `pipe` for a layer a stage holds alone)."""
    by_axes: dict[tuple, list] = {}
    for p, g in zip(params, grads):
        names = p.device_mesh.mesh_dim_names
        axes = tuple(n for n, pl in zip(names, p.placements) if isinstance(pl, Shard))
        if plan.pipelined and "pipe" not in names:
            axes += ("pipe",)
        by_axes.setdefault(axes, []).append(torch.linalg.vector_norm(g, dtype=torch.float32).square())
    total = None
    for axes, sq in sorted(by_axes.items()):
        s = torch.stack(sq).sum()
        for a in axes:
            if plan.groups[a] is not None:
                dist.all_reduce(s, group=plan.groups[a])
        total = s if total is None else total + s
    return total
