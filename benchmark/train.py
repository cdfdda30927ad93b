"""A training cell: the step function and state that the program's
`create_state` returns, holding the benchmark's weights, stepped on a new
seeded row each step.

Set-up runs the first `check_steps` steps through that same step function
(they build the kernels and warm the allocator) and keeps what the check
compares: each step's loss, each leaf's first gradient as AdamW holds it
after step 1 (its first moment over 1 − β1), and each leaf's change after
the last of them. The window then runs whole steps, each synchronised,
until `--seconds` have passed; its length runs to the end of its last
step, so the rate is all the window's work over all its time. The state
the window leaves must count every update it took: set-up's and the
window's (`step_count_gap`)."""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from . import weights as weights_mod
from . import workload


@dataclasses.dataclass
class TrainRun:
    losses: list
    grad_norms: dict  # path -> ‖first gradient‖ as AdamW got it
    update_norms: dict  # path -> ‖params after the set-up steps − initial params‖
    t0: float = 0.0
    t1: float = 0.0
    steps: int = 0
    tokens: int = 0
    launches: dict = dataclasses.field(default_factory=dict)
    trace: object = None
    step_count_gap: float = 0.0  # set-up's and the window's steps against the state's counts


def program_leaves(params: dict) -> dict:
    """path -> the program's per-layer param tensor (the paths of
    `benchmark.reference.llama.leaf_paths`)."""
    out = {("embed",): params["embed"], ("final_norm",): params["final_norm"], ("lm_head",): params["lm_head"]}
    for i, layer in enumerate(params["layers"]):
        for key, t in layer.items():
            out[("layers", key, i)] = t
    return out


def initial_leaves(model, seed: int, device):
    """Yields (path, initial value) one stacked weight at a time."""
    for name in weights_mod.shapes(model):
        t = weights_mod.make_tensor(model, seed, name, device)
        if name.startswith("layers."):
            key = name.split(".", 1)[1]
            for i in range(t.shape[0]):
                yield ("layers", key, i), t[i]
        else:
            yield (name,), t
        del t


def run(model, mix: dict, seed: int, seconds: float, device, trace: bool, trace_seconds: float,
        tracer_cls, step_hook=None) -> tuple[TrainRun, object]:
    """Returns the run and the train state (for the caller to free after
    reading memory). `step_hook(step_fn)` may wrap the step function (the
    fault tests break it there)."""
    from modal_tpu_torch.ops import _build
    from modal_tpu_torch.parallel.train import TrainConfig, create_state

    from .models import llama_config

    cfg = llama_config(model)
    tc = TrainConfig(**mix.get("train_config", {}))
    state, step_fn = create_state(cfg, tc, seed=0, device=device)
    if step_hook is not None:
        step_fn = step_hook(step_fn)
    leaves = program_leaves(state.params)
    with torch.no_grad():
        for path, init in initial_leaves(model, seed, device):
            leaves[path].copy_(init)
    gc.collect()
    b, s = int(mix["batch"]), int(mix["seq_len"])
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)

    def step(k: int):
        nonlocal state
        state, m = step_fn(state, workload.train_row(seed, k, b, s, model.vocab_size, device))
        sync()
        return m

    n_check = int(mix["check_steps"])
    losses, grad_norms = [], {}
    for k in range(n_check):
        losses.append(float(step(k)["loss"]))
        if k == 0:
            opt = state.opt_state
            grad_norms = {path: float(torch.linalg.vector_norm(opt.state[t]["exp_avg"].float())) / (1 - tc.b1)
                          for path, t in leaves.items()}
    with torch.no_grad():
        update_norms = {path: float(torch.linalg.vector_norm(leaves[path].float() - init.float()))
                        for path, init in initial_leaves(model, seed, device)}
    out = TrainRun(losses=losses, grad_norms=grad_norms, update_norms=update_norms)
    if trace:
        tracer_cls.warm()
    launches0 = dict(_build.LAUNCHES)
    tracer = None
    k = n_check
    out.t0 = time.perf_counter()
    while True:
        if trace and tracer is None and time.perf_counter() >= out.t0 + seconds - trace_seconds:
            tracer = tracer_cls()
            tracer.start()
        step(k)
        k += 1
        out.steps += 1
        if time.perf_counter() >= out.t0 + seconds:
            break
    out.t1 = time.perf_counter()
    out.tokens = out.steps * b * s
    out.step_count_gap = step_count_gap(state, n_check + out.steps)
    out.launches = {name: v - launches0.get(name, 0) for name, v in _build.LAUNCHES.items()}
    if tracer is not None:
        out.trace = tracer.stop()
    return out, state


def step_count_gap(state, expected: int) -> float:
    """How far the state the window leaves is from having taken `expected`
    updates: the largest miss of its step and of each leaf's AdamW step
    count (the count its bias correction reads)."""
    counts = [float(st["step"]) for st in state.opt_state.state.values()]
    return max([abs(c - expected) for c in counts] + [abs(float(state.step) - expected)])


def metrics(run: TrainRun) -> dict:
    return {"train_tok_s": run.tokens / (run.t1 - run.t0)}
