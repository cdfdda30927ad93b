"""How `correct` is decided: the program's outputs against the plain
reference (`benchmark.reference`), which works everything out again from
the seed.

Serving: `served_gap`, the widest gap by which a served greedy token's
reference logit lies below the reference's best at that position, over a
sample of the requests the window finished (the longest among them).

Training: the reference runs the same `check_steps` steps from the same
weights and rows, with AdamW as the configuration keeps it, and three
numbers compare the two:
- `loss_gap`: the largest |loss − reference loss| / reference loss of a step;
- `grad_gap`: the largest gap between a leaf's first-gradient norm and the
  reference's, over the larger of the reference leaf's norm and the median
  leaf's;
- `update_gap`: the same for each leaf's change over the steps.
Leaves whose reference gradient is under a thousandth of the median
leaf's (gradients that are nought but for rounding) are left out of both.

A cell's limits are `benchmark/limits/<cell>.json`: {"<number>": {"max":
limit}} or {"<number>": {"min": limit}}, beside the readings each was set
from. Every number named there is compared; a number not named is
printed with no limit."""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

import torch

from .reference.llama import AdamW, Model as Reference, leaf


def load_limits(path: Path) -> dict:
    return json.loads(Path(path).read_text()) if Path(path).exists() else {}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number the limits name
    is compared, and must be there; a number they do not name is reported
    with no limit and compared with nothing. No limits at all is not
    correct."""
    out, ok = {}, bool(limits)
    for name in limits:
        if name not in numbers:
            out[name] = {"value": None, "limit": "missing"}
            ok = False
    for name, value in numbers.items():
        spec = limits.get(name, {})
        if "max" in spec:
            passed = value is not None and math.isfinite(value) and value <= spec["max"]
            out[name] = {"value": value, "limit": f"<= {spec['max']}"}
        elif "min" in spec:
            passed = value is not None and value >= spec["min"]
            out[name] = {"value": value, "limit": f">= {spec['min']}"}
        else:
            passed = True
            out[name] = {"value": value, "limit": None}
        ok = ok and passed
    return ok, out


# -- serving -------------------------------------------------------------------

def widest_gap(logits: list, chosen: list) -> float:
    """max over positions of (best reference logit − the chosen token's)."""
    worst = 0.0
    for lg, toks in zip(logits, chosen):
        idx = torch.as_tensor(toks, device=lg.device).long()
        gap = lg.max(dim=-1).values - lg.gather(1, idx[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def serving_numbers(model, weights: dict, sample: list) -> dict:
    """`sample`: records with `.prompt` and `.tokens` (every served token)."""
    if not sample:
        return {"served_gap": None}
    seqs = [list(r.prompt) + list(r.tokens[:-1]) for r in sample]
    positions = [list(range(len(r.prompt) - 1, len(s))) for r, s in zip(sample, seqs)]
    logits = Reference(model, weights).logits(seqs, positions)
    return {"served_gap": widest_gap(logits, [r.tokens for r in sample])}


def lower_precision_gaps(model, weights: dict, sample: list, precisions=("fp8",)) -> dict:
    """At the same positions of the same sequences, the widest gap of the
    token the reference computed in each of `precisions` puts first: "fp8"
    is the control, "bf16" a witness in the served precision."""
    seqs = [list(r.prompt) + list(r.tokens[:-1]) for r in sample]
    positions = [list(range(len(r.prompt) - 1, len(s))) for r, s in zip(sample, seqs)]
    exact = Reference(model, weights).logits(seqs, positions)
    out = {}
    for p in precisions:
        low = Reference(model, weights, precision=p).logits(seqs, positions)
        out[p] = widest_gap(exact, [lg.argmax(dim=-1).tolist() for lg in low])
    return out


# -- training ------------------------------------------------------------------

def schedule(tc, step: int) -> float:
    """optax's warmup_cosine_decay_schedule from 0 to the peak and down to a
    tenth of it at `total_steps`, at update `step` (0 for the first)."""
    peak, warm, total = tc["learning_rate"], tc["warmup_steps"], tc["total_steps"]
    if step < warm:
        return peak * step / warm
    count = min(step - warm, total - warm)
    return peak * (0.9 * 0.5 * (1 + math.cos(math.pi * count / (total - warm))) + 0.1)


def reference_training(model, weights: dict, rows: list, tc: dict, precision: str = "fp32") -> dict:
    """The reference over `rows` (one [S] row per step), updating `weights`
    in place. Returns {"losses", "grad_norms", "update_norms"} with the
    update norms left for the caller (it needs the initial weights)."""
    ref = Reference(model, weights, precision=precision)
    opt = AdamW(weights, lr=tc["learning_rate"], b1=tc["b1"], b2=tc["b2"], eps=1e-8,
                weight_decay=tc["weight_decay"], clip=tc["grad_clip"])
    losses, first = [], {}
    for k, row in enumerate(rows):
        grads, sq = {}, [0.0]

        def on_grad(path, g, k=k):
            n = float(torch.linalg.vector_norm(g))
            sq[0] += n * n
            if k == 0:
                first[path] = n
            grads[path] = g.to(leaf(weights, path).dtype)

        losses.append(ref.loss_and_grads(row, on_grad))
        if k == 0:
            norm = math.sqrt(sq[0])
            scale = 1.0 if norm < tc["grad_clip"] else tc["grad_clip"] / norm
            first = {p: n * scale for p, n in first.items()}
        opt.step(grads, sq[0], lr=schedule(tc, k))
        del grads
    return {"losses": losses, "grad_norms": first}


def leaf_gaps(program: dict, reference: dict, counted: list) -> dict:
    """Each counted leaf's |program norm − reference norm| over the larger of
    the reference leaf's norm and the median leaf's."""
    med = statistics.median(reference[p] for p in counted)
    return {p: abs(program[p] - reference[p]) / max(reference[p], med) for p in counted}


def training_numbers(prog_losses: list, prog_grads: dict, prog_updates: dict, ref: dict, ref_updates: dict) -> dict:
    """The worst step's loss gap, and the worst leaf's gap for the first
    gradient and for the change over the steps."""
    med = statistics.median(ref["grad_norms"].values())
    counted = [p for p, n in ref["grad_norms"].items() if n >= 1e-3 * med]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog_losses, ref["losses"])),
        "grad_gap": max(leaf_gaps(prog_grads, ref["grad_norms"], counted).values()),
        "update_gap": max(leaf_gaps(prog_updates, ref_updates, counted).values()),
    }


def worst_leaves(prog_grads: dict, prog_updates: dict, ref: dict, ref_updates: dict, top: int = 5) -> dict:
    """The leaves behind the worst gaps, for a look at what sets them."""
    med = statistics.median(ref["grad_norms"].values())
    counted = [p for p, n in ref["grad_norms"].items() if n >= 1e-3 * med]
    out = {}
    for name, prog, refn in (("grad", prog_grads, ref["grad_norms"]), ("update", prog_updates, ref_updates)):
        gaps = leaf_gaps(prog, refn, counted)
        out[name] = [[".".join(map(str, p)), g, refn[p]] for p, g in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]
    return out


def update_norms(model, weights: dict, seed: int, device) -> dict:
    """Each leaf's change: ‖weights now − the initial weights‖, the initial
    ones made again from the seed one stacked tensor at a time."""
    from .weights import make_tensor, shapes

    out = {}
    for name in shapes(model):
        init = make_tensor(model, seed, name, device)
        if name.startswith("layers."):
            key = name.split(".", 1)[1]
            for i in range(init.shape[0]):
                out[("layers", key, i)] = float(torch.linalg.vector_norm(
                    leaf(weights, ("layers", key, i)).float() - init[i].float()))
        else:
            out[(name,)] = float(torch.linalg.vector_norm(leaf(weights, (name,)).float() - init.float()))
        del init
    return out


