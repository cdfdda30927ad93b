"""The training step, on one device or over a mesh (port of
modal_tpu/parallel/train.py).

- `TrainState`, `TrainConfig`: the same fields and defaults (:25-46).
- `make_optimizer(tc)`: optax's `chain(clip_by_global_norm,
  adamw(warmup_cosine_decay_schedule))` (:49) as an `Optimizer` around
  `torch.optim.AdamW` (fused on CUDA): the schedule sets the learning rate
  before each update (optax's first update uses `schedule(0)`, 0 during
  warmup), and the clip is optax's rule, not `clip_grad_norm_`'s.
- `loss_fn` (:63): the forward over the full sequence, then the shift, so S
  stays block-aligned and attention takes the flash kernels.
- `make_train_step` (:79), `create_state` (one device) and
  `create_sharded_state` (:168, a mesh) and `train_demo` (:227).

Params are held in the training layout (`convert.unstack_layers`), updated
in place, with AdamW's moments in the param dtype as optax keeps them.

On a mesh (any axis above 1, or a state from `create_sharded_state`) the
leaves are DTensors placed by `sharding.param_specs` (the pipeline's
stages hold their layers alone), AdamW's moments are placed like their
params (`mirror_opt_shardings`), and the step computes on this rank's
tokens through `spmd.SpmdPlan`: the global loss, gradients reduce-scattered
over fsdp and all-reduced over the other token axes, and the global norm for
the clip summed over the shards on the device. With every axis 1
`train_demo` keeps the one-device step: no process group, no DTensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..config import resolve_device
from ..models.convert import unstack_layers
from ..models.llama import LlamaConfig, forward_with_aux, get_config, init_params
from ..observability.device_telemetry import StepTimer, sample_device_memory


class TrainState(NamedTuple):
    params: dict
    opt_state: Any  # the torch.optim.AdamW bound to the params
    step: int


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 2000
    total_steps: int = 100_000
    remat: bool = True  # checkpoint each layer: memory for FLOPs
    num_microbatches: int = 0  # pipeline microbatches; 0 = 2 × pipe stages

    def resolve_num_microbatches(self, n_stages: int) -> int:
        """The one rule make_train_step and train_demo share."""
        return self.num_microbatches or 2 * n_stages


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float = 0.0
) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule (exponent 1) as a plain function
    of the update count: linear from `init_value` to `peak_value` over
    `warmup_steps`, then cosine down to `end_value` at `decay_steps`."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - max(step, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        count = min(step - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a nested dict/list tree, dict keys in sorted order
    (None entries, another pipeline stage's layers, skipped)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm in fp32, one tensor at a time (no temporaries the
    size of the whole tree)."""
    return torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32).square() for t in tensors]).sum().sqrt()


def clip_by_global_norm_(tensors: list[torch.Tensor], max_norm: float, norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm, in place, selecting on the device as optax
    does (no host sync): every tensor is multiplied by
    where(norm < max_norm, 1, max_norm / norm) in its own dtype, one
    `_foreach_mul_` per dtype. Below the bar the factor is exactly 1; above
    it, t · (max_norm / norm) rounds once where optax's (t / norm) · max_norm
    rounds twice (not clip_grad_norm_'s max_norm / (norm + 1e-6))."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, group in by_dtype.items():
        torch._foreach_mul_(group, scale.to(dtype))


class Optimizer:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    weight_decay)) over torch tensors. `init(params)` gives the opt state (a
    `torch.optim.AdamW` bound to the param leaves); `update` applies one
    step from the leaves' `.grad` in place."""

    def __init__(self, tc: TrainConfig):
        self.tc = tc
        self.schedule = warmup_cosine_decay_schedule(
            init_value=0.0,
            peak_value=tc.learning_rate,
            warmup_steps=tc.warmup_steps,
            decay_steps=tc.total_steps,
            end_value=tc.learning_rate * 0.1,
        )

    def init(self, params: dict) -> torch.optim.AdamW:
        """For DTensor leaves (a mesh) AdamW is bound to their local pieces,
        the autograd leaves (`spmd.SpmdPlan.localize`), which it updates in
        place under the DTensors: each moment is then the same piece of the
        same mesh as its param (`sharded_moments`), and AdamW's arithmetic
        runs as plain tensor ops, not through DTensor's op dispatch (whose
        sharding propagation over a six-dim mesh costs seconds per new op
        signature)."""
        leaves = [_local(p) for p in tree_leaves(params)]
        on_cuda = all(p.device.type == "cuda" for p in leaves)
        # fused on the card: no foreach scratch the size of the param tree
        kind = {"fused": True} if on_cuda else {"foreach": False}
        return torch.optim.AdamW(
            leaves, lr=0.0, betas=(self.tc.b1, self.tc.b2), eps=1e-8,
            weight_decay=self.tc.weight_decay, **kind,
        )

    def update(self, opt_state: torch.optim.AdamW, step: int, plan=None, params=None) -> torch.Tensor:
        """Clip the grads, set the lr to `schedule(step)`, step AdamW.
        Returns the global norm of the grads before the clip. With a `plan`
        the grads are the local pieces' of `params`' DTensors, and the norm
        sums the squares of every shard over the mesh."""
        grads = [p.grad for group in opt_state.param_groups for p in group["params"]]
        if plan is None:
            norm = global_norm(grads)
        else:
            from .spmd import global_sq_norm

            norm = global_sq_norm(tree_leaves(params), grads, plan).sqrt()
        clip_by_global_norm_(grads, self.tc.grad_clip, norm)
        for group in opt_state.param_groups:
            group["lr"] = self.schedule(step)
        opt_state.step()
        return norm


def _local(p: torch.Tensor) -> torch.Tensor:
    """A DTensor's local piece (the autograd leaf on a mesh), or `p`."""
    from torch.distributed.tensor import DTensor

    return p._local_tensor if isinstance(p, DTensor) else p


def make_optimizer(tc: TrainConfig) -> Optimizer:
    return Optimizer(tc)


def loss_fn(
    params: dict, cfg: LlamaConfig, tokens: torch.Tensor, remat: bool, attn_impl: Optional[Callable] = None,
    plan=None,
) -> torch.Tensor:
    """Next-token loss: the forward over the FULL sequence, then the shift
    (an S − 1 forward would not be block-aligned, and attention would leave
    the flash kernels for the einsum); MoE configs add the aux loss. With a
    `plan`, `tokens` is this rank's block and the loss the global one."""
    if plan is not None:
        b, s = tokens.shape
        positions = plan.positions(b, s, tokens.device)
        logits, _, aux = forward_with_aux(params, cfg, tokens, positions, attn_impl=attn_impl, remat=remat, plan=plan)
        return plan.next_token_loss(logits, tokens) + cfg.moe_aux_coef * aux
    logits, _, aux = forward_with_aux(params, cfg, tokens, attn_impl=attn_impl, remat=remat)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None].long()).squeeze(-1)
    return nll.mean() + cfg.moe_aux_coef * aux


def make_train_step(
    cfg: LlamaConfig,
    tc: TrainConfig,
    optimizer: Optimizer,
    attn_impl: Optional[Callable] = None,
    pipeline_mesh: Any = None,
    state_shardings: Optional[dict] = None,
    mesh: Any = None,
) -> Callable:
    """Returns train_step(state, tokens) -> (state, metrics), metrics
    {"loss", "grad_norm" (before the clip), "step"}. The params and the
    AdamW moments are updated in place (the JAX step donates them); the
    grads are freed once applied.

    On a mesh (`mesh`, or `pipeline_mesh` for the GPipe loss over its
    `pipe` axis) `tokens` is the global batch, a DTensor or a full tensor
    the same on every rank, and each rank steps on its block.
    `state_shardings` (from `create_sharded_state`) are the placements the
    state must keep: checked on every step, as JAX pins them as the step's
    out_shardings, so no step reshards the state."""
    plan = None
    if pipeline_mesh is not None or mesh is not None:
        from .mesh import axis_sizes, validate_mesh_constraints
        from .spmd import SpmdPlan

        mesh = pipeline_mesh if pipeline_mesh is not None else mesh
        validate_mesh_constraints(axis_sizes(mesh), cfg)
        plan = SpmdPlan(mesh, pipelined=pipeline_mesh is not None)
    if pipeline_mesh is not None:
        from .pipeline import pipeline_loss

        num_micro = tc.resolve_num_microbatches(plan.sizes["pipe"])

        def compute_loss(params, tokens):
            return pipeline_loss(params, cfg, tokens, plan, num_micro, attn_impl=attn_impl)
    else:
        def compute_loss(params, tokens):
            return loss_fn(params, cfg, tokens, tc.remat, attn_impl, plan)

    def train_step(state: TrainState, tokens: torch.Tensor):
        opt = state.opt_state
        if state_shardings is not None and train_state_shardings(state) != state_shardings:
            raise ValueError("the train state's placements differ from state_shardings")
        opt.zero_grad(set_to_none=True)
        loss = compute_loss(state.params, tokens if plan is None else plan.local_tokens(tokens))
        loss.backward()
        grad_norm = optimizer.update(opt, state.step, plan, state.params)
        opt.zero_grad(set_to_none=True)
        new_state = TrainState(state.params, opt, state.step + 1)
        return new_state, {"loss": loss.detach(), "grad_norm": grad_norm, "step": new_state.step}

    return train_step


def _placements_tree(tree: Any) -> Any:
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _placements_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_placements_tree(v) for v in tree]
    return tuple(tree.placements) if isinstance(tree, DTensor) else tree


def mirror_opt_shardings(params: dict) -> dict:
    """Placements for AdamW's state that MIRROR the params': each moment
    (`exp_avg`, `exp_avg_sq`) takes its param's placements on its param's
    mesh; the step counter is a plain scalar (JAX: each moment leaf gets the
    sharding of the param whose key path it ends with, `count` replicates,
    train.py:144)."""
    pls = _placements_tree(params)
    return {"exp_avg": pls, "exp_avg_sq": pls, "step": None}


def sharded_moments(state: TrainState) -> dict:
    """AdamW's moments as DTensors in the params' tree: each the moment's
    local piece (which AdamW updates in place) on its param's mesh with its
    param's placements. A moment whose piece has another shape than its
    param's raises."""
    from torch.distributed.tensor import DTensor

    opt = state.opt_state

    def wrap(tree: Any, name: str) -> Any:
        if isinstance(tree, dict):
            return {k: wrap(v, name) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [wrap(v, name) for v in tree]
        if tree is None:
            return None
        m = opt.state[_local(tree)].get(name)
        if m is None or not isinstance(tree, DTensor):
            return m
        if m.shape != tree.to_local().shape:
            raise ValueError(f"moment {name} {tuple(m.shape)} is not its param's piece {tuple(tree.to_local().shape)}")
        return DTensor.from_local(m, tree.device_mesh, tree.placements, run_check=False,
                                  shape=tree.shape, stride=tree.stride())

    return {"exp_avg": wrap(state.params, "exp_avg"), "exp_avg_sq": wrap(state.params, "exp_avg_sq")}


def state_tree(state: TrainState) -> dict:
    """The train state as a tree of tensors, what `checkpoint.VolumeCheckpointer`
    saves: the params, AdamW's moments in the params' tree (DTensors on a
    mesh, as `sharded_moments` gives) and its step count, and the step, in
    the layout of JAX's TrainState (params, opt_state, step) with optax's
    names (`mu`, `nu`, `count`)."""
    opt = state.opt_state
    if not opt.state:
        _init_moments(opt)
    moments = sharded_moments(state)
    first = _local(tree_leaves(state.params)[0])
    return {"params": state.params,
            "opt_state": {"mu": moments["exp_avg"], "nu": moments["exp_avg_sq"], "count": opt.state[first]["step"]},
            "step": torch.tensor(state.step, dtype=torch.int32)}


def state_from_tree(tree: dict, tc: TrainConfig) -> TrainState:
    """A TrainState from `state_tree`'s tree (a restored one): a fresh AdamW
    bound to its params, holding its moments and step count."""
    params = tree["params"]
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = make_optimizer(tc).init(params)
    count = tree["opt_state"]["count"]
    moments = zip(tree_leaves(params), tree_leaves(tree["opt_state"]["mu"]), tree_leaves(tree["opt_state"]["nu"]))
    for group in opt.param_groups:
        on_device = group["fused"] or group["capturable"]
        for p, mu, nu in moments:
            local = _local(p)
            opt.state[local] = {"step": count.to(local.device if on_device else "cpu", copy=True),
                                "exp_avg": _local(mu), "exp_avg_sq": _local(nu)}
    return TrainState(params=params, opt_state=opt, step=int(tree["step"]))


def train_state_shardings(state: TrainState) -> dict:
    """The placements a sharded train state carries: its params' and its
    AdamW moments' (in the params' tree), as `mirror_opt_shardings` gives."""
    moments = sharded_moments(state)
    return {"params": _placements_tree(state.params),
            "opt": {"exp_avg": _placements_tree(moments["exp_avg"]),
                    "exp_avg_sq": _placements_tree(moments["exp_avg_sq"]), "step": None}}


def create_state(
    cfg: LlamaConfig, tc: TrainConfig, seed: int = 0, device=None, checkpoint: Optional[str] = None
) -> tuple[TrainState, Callable]:
    """Params initialised on the device (no host staging), or loaded from
    the safetensors checkpoint in the directory `checkpoint` straight into
    the per-layer layout (no stacked copy); held per layer and requiring
    grad, the AdamW state and the step function. Returns (state, train_step)."""
    dev = resolve_device(device)
    optimizer = make_optimizer(tc)
    if checkpoint is None:
        params = unstack_layers(init_params(cfg, seed, dev))  # the stacked tree is dropped here
    else:
        from ..models.weights import load_params

        params = load_params(checkpoint, cfg, device=dev, layout="per_layer")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    state = TrainState(params=params, opt_state=optimizer.init(params), step=0)
    return state, make_train_step(cfg, tc, optimizer)


def _init_moments(opt: torch.optim.AdamW) -> None:
    """AdamW's state made now, as torch makes it at the first step (each
    moment `zeros_like` its param's local piece), so the state exists,
    placed, before any step, as JAX's `optimizer.init` does."""
    for group in opt.param_groups:
        on_device = group["fused"] or group["capturable"]
        for p in group["params"]:  # the params' local pieces (Optimizer.init)
            opt.state[p] = {
                "step": torch.zeros((), dtype=torch.float32, device=p.device if on_device else "cpu"),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }


def create_sharded_state(
    mesh, cfg: LlamaConfig, tc: TrainConfig, seed: int = 0, params: Optional[dict] = None
) -> tuple[TrainState, Callable, list]:
    """Params placed on `mesh` by `sharding.param_specs` (the stacked axis
    over `pipe` when the mesh has one), AdamW's moments mirroring them, and
    the step for this mesh: the GPipe loss with a `pipe` axis, ring
    attention with a `seq` axis. `params` is the full stacked tree to place
    (the same on every rank; default `init_params(cfg, seed)` on the mesh's
    device). Every rank calls it. Returns (state, train_step, the tokens'
    placements)."""
    from .mesh import axis_sizes, validate_mesh_constraints
    from .sharding import param_specs, placements, shard_train_params, token_spec

    sizes = axis_sizes(mesh)
    validate_mesh_constraints(sizes, cfg)  # before any init
    dev = resolve_device(mesh.device_type)
    optimizer = make_optimizer(tc)
    pipe = sizes["pipe"] > 1
    if params is None:
        params = init_params(cfg, seed, dev)
    sharded = shard_train_params(mesh, params, param_specs(cfg, pipe=pipe))
    del params
    for p in tree_leaves(sharded):
        _local(p).requires_grad_(True)
    attn_impl = None
    if sizes["seq"] > 1:
        from .ring_attention import make_ring_attention_impl
        from .spmd import SpmdPlan

        attn_impl = make_ring_attention_impl(SpmdPlan(mesh, pipelined=pipe), "seq")
    opt = optimizer.init(sharded)
    _init_moments(opt)
    state = TrainState(params=sharded, opt_state=opt, step=0)
    shardings = train_state_shardings(state)
    mirror = mirror_opt_shardings(sharded)
    if shardings["opt"] != mirror:
        raise AssertionError("AdamW's moments are not placed like their params")
    step_fn = make_train_step(
        cfg, tc, optimizer, attn_impl=attn_impl, pipeline_mesh=mesh if pipe else None,
        state_shardings=shardings, mesh=mesh,
    )
    return state, step_fn, placements(mesh, token_spec(sizes["seq"] > 1))


def train_demo(
    cfg_name: str = "tiny",
    mesh_axes: Optional[dict] = None,
    steps: int = 2,
    per_device_batch: int = 1,
    seq_len: int = 128,
    device=None,
    on_step: Optional[Callable[[TrainState, dict], None]] = None,
    overrides: Optional[dict] = None,
) -> dict:
    """A few train steps on synthetic tokens from a seeded generator (CUDA
    unless `device` says otherwise). Returns the last step's metrics as
    floats. `overrides` are `get_config` overrides (a depth cut, say).
    `on_step(state, metrics)`, if given, runs after each step has finished
    on the device and been timed.

    With every mesh axis 1 (or none given): the one-device step. Otherwise
    every rank of a process group (`mesh.init_process_group` or
    `mesh.spawn`) calls it: the mesh takes the whole world (the remainder
    in fsdp), the batch is `per_device_batch` × data × fsdp (rounded up so
    every pipeline microbatch divides over data × fsdp), and each rank steps
    on its block of the same seeded tokens."""
    cfg = get_config(cfg_name, **(overrides or {}))
    dev = resolve_device(device)
    tc = TrainConfig(warmup_steps=10, total_steps=100)
    if mesh_axes and any(int(n) != 1 for n in mesh_axes.values()):
        from .mesh import axis_sizes, build_mesh

        mesh = build_mesh(mesh_axes, model_cfg=cfg)
        if mesh.device_type != dev.type:
            raise ValueError(f"the process group runs on {mesh.device_type}, the demo was asked for {dev}")
        state, step_fn, _ = create_sharded_state(mesh, cfg, tc)
        sizes = axis_sizes(mesh)
        group = sizes["data"] * sizes["fsdp"]
        n_batch = group * per_device_batch
        if sizes["pipe"] > 1:
            unit = group * tc.resolve_num_microbatches(sizes["pipe"])
            n_batch = (n_batch + unit - 1) // unit * unit
    else:
        state, step_fn = create_state(cfg, tc, seed=0, device=dev)
        n_batch = per_device_batch
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (n_batch, seq_len), generator=gen, device=dev)
    metrics: dict = {}
    timer = StepTimer("train")
    for _ in range(steps):
        state, metrics = step_fn(state, tokens)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the mark records the step, not its enqueue
        timer.mark()
        if on_step is not None:
            on_step(state, metrics)
    sample_device_memory()
    return {k: float(v) for k, v in metrics.items()}
