"""The training step on one device (port of modal_tpu/parallel/train.py).

The JAX step is a jit of value_and_grad over an FSDP/TP mesh; this slice
ports its one-device form:

- `TrainState`, `TrainConfig`: the same fields and defaults (:25-46).
- `make_optimizer(tc)`: optax's `chain(clip_by_global_norm,
  adamw(warmup_cosine_decay_schedule))` (:49) as an `Optimizer` around
  `torch.optim.AdamW` (fused on CUDA): the schedule sets the learning rate
  before each update (optax's first update uses `schedule(0)`, 0 during
  warmup), and the clip is optax's rule, not `clip_grad_norm_`'s.
- `loss_fn` (:63): the forward over the full sequence, then the shift, so S
  stays block-aligned and attention takes the flash kernels.
- `make_train_step` (:79), `create_state` (the one-device counterpart of
  `create_sharded_state`, :168) and `train_demo` (:227).

Params are held in the training layout (`convert.unstack_layers`), updated
in place, with AdamW's moments in the param dtype as optax keeps them.
Meshes other than one device (FSDP, `mirror_opt_shardings`, the pipeline
branch, ring attention, MoE) wait for ROADMAP.md Queue A 5.
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
    num_microbatches: int = 0  # pipeline microbatches (the pipeline waits for Queue A 5)


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
    """The tensors of a nested dict/list tree, dict keys in sorted order."""
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
        leaves = tree_leaves(params)
        on_cuda = all(p.device.type == "cuda" for p in leaves)
        # fused on the card: no foreach scratch the size of the param tree
        kind = {"fused": True} if on_cuda else {"foreach": False}
        return torch.optim.AdamW(
            leaves, lr=0.0, betas=(self.tc.b1, self.tc.b2), eps=1e-8,
            weight_decay=self.tc.weight_decay, **kind,
        )

    def update(self, opt_state: torch.optim.AdamW, step: int) -> torch.Tensor:
        """Clip the grads, set the lr to `schedule(step)`, step AdamW.
        Returns the global norm of the grads before the clip."""
        grads = [p.grad for group in opt_state.param_groups for p in group["params"]]
        norm = global_norm(grads)
        clip_by_global_norm_(grads, self.tc.grad_clip, norm)
        for group in opt_state.param_groups:
            group["lr"] = self.schedule(step)
        opt_state.step()
        return norm


def make_optimizer(tc: TrainConfig) -> Optimizer:
    return Optimizer(tc)


def loss_fn(
    params: dict, cfg: LlamaConfig, tokens: torch.Tensor, remat: bool, attn_impl: Optional[Callable] = None
) -> torch.Tensor:
    """Next-token loss: the forward over the FULL sequence, then the shift
    (an S − 1 forward would not be block-aligned, and attention would leave
    the flash kernels for the einsum)."""
    logits, _, aux = forward_with_aux(params, cfg, tokens, attn_impl=attn_impl, remat=remat)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None].long()).squeeze(-1)
    return nll.mean() + cfg.moe_aux_coef * aux


def make_train_step(
    cfg: LlamaConfig, tc: TrainConfig, optimizer: Optimizer, attn_impl: Optional[Callable] = None
) -> Callable:
    """Returns train_step(state, tokens) -> (state, metrics), metrics
    {"loss", "grad_norm" (before the clip), "step"}. The params and the
    AdamW moments are updated in place (the JAX step donates them); the
    grads are freed once applied."""

    def train_step(state: TrainState, tokens: torch.Tensor):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, cfg, tokens, tc.remat, attn_impl)
        loss.backward()
        grad_norm = optimizer.update(opt, state.step)
        opt.zero_grad(set_to_none=True)
        new_state = TrainState(state.params, opt, state.step + 1)
        return new_state, {"loss": loss.detach(), "grad_norm": grad_norm, "step": new_state.step}

    return train_step


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


def train_demo(
    cfg_name: str = "tiny",
    mesh_axes: Optional[dict] = None,
    steps: int = 2,
    per_device_batch: int = 1,
    seq_len: int = 128,
    device=None,
    on_step: Optional[Callable[[TrainState, dict], None]] = None,
) -> dict:
    """A few train steps on synthetic tokens from a seeded generator, on one
    device (CUDA unless `device` says otherwise). Returns the last step's
    metrics as floats. `on_step(state, metrics)`, if given, runs after each
    step has finished on the device and been timed."""
    if mesh_axes and any(int(n) != 1 for n in mesh_axes.values()):
        raise NotImplementedError(
            f"mesh {mesh_axes}: the port trains on one device; meshes (FSDP, pipeline, ring "
            "attention, MoE) wait for ROADMAP.md Queue A 5"
        )
    cfg = get_config(cfg_name)
    dev = resolve_device(device)
    tc = TrainConfig(warmup_steps=10, total_steps=100)
    state, step_fn = create_state(cfg, tc, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (per_device_batch, seq_len), generator=gen, device=dev)
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
