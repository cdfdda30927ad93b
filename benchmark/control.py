"""The readings each limit of `benchmark/limits/<cell>.json` is set from,
many seeds in one process (set-up is long):

    python -m benchmark.control --workload <cell> --seeds 1,2,3 --seconds 10 --mode program|control|token|half_batch [--out FILE]

- `program`: the cell as the benchmark runs it; each check number of each
  seed (the lower readings);
- `control`: the same, then the reference computed in the nearest
  precision below the configuration's (float8 for bfloat16) in the
  program's place: for serving, the widest gap of the token it puts first
  at the served positions, beside a witness computed in bfloat16; for
  training, its three numbers against the float32 reference (the upper
  readings);
- `token`: serving with a token altered where it is produced (every 7th
  token of every request, shifted by one id);
- `half_batch`: training on half of each step's row, the mean taken over
  the rest (the row is the batch of a B 1 cell).

A state left unchanged by a step needs no run: its parameters' change is
0, so `update_gap` reads 1.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

from .run import ROOT, execute, parse


@contextlib.contextmanager
def altered_tokens(every: int = 7):
    """Every `every`-th token a request receives is the produced one plus 1."""
    from modal_tpu_torch.serving import engine as engine_mod

    original = engine_mod.GenRequest._append

    def _append(self, token: int) -> None:
        if (len(self.tokens) + 1) % every == 0:
            token = token + 1
        original(self, token)

    engine_mod.GenRequest._append = _append
    try:
        yield
    finally:
        engine_mod.GenRequest._append = original


def half_batch(step_fn):
    def step(state, tokens):
        return step_fn(state, tokens[:, : tokens.shape[1] // 2])

    return step


def control_numbers(out, seed: int, device) -> dict:
    """The control's readings for the run `out` (weights made again)."""
    import torch

    from . import check
    from . import weights as weights_mod

    run = out.run
    model, mix = run.model, run.mix
    if mix["kind"] == "serve":
        w = weights_mod.make(model, seed, device)
        gaps = check.lower_precision_gaps(model, w, out.sample, ("fp8", "bf16"))
        return {"served_gap.fp8": gaps["fp8"], "served_gap.bf16_witness": gaps["bf16"]}
    tc = mix["train_config"]
    w = weights_mod.make(model, seed, device)
    ref = check.reference_training(model, w, out.rows, tc)
    ref_updates = check.update_norms(model, w, seed, device)
    del w
    gc.collect()
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    w = weights_mod.make(model, seed, device)
    low = check.reference_training(model, w, out.rows, tc, precision="fp8")
    low_updates = check.update_norms(model, w, seed, device)
    del w
    nums = check.training_numbers(low["losses"], low["grad_norms"], low_updates, ref, ref_updates)
    out = {f"{k}.fp8": v for k, v in nums.items()}
    out["worst_leaves.program"] = check.worst_leaves(run.train.grad_norms, run.train.update_norms, ref, ref_updates)
    out["worst_leaves.fp8"] = check.worst_leaves(low["grad_norms"], low_updates, ref, ref_updates)
    return out


def main(argv=None, device=None, root: Path = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=("program", "control", "token", "half_batch"), default="program")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        run_args = parse(["--workload", args.workload, "--seed", str(seed), "--seconds", str(args.seconds)])
        t0 = time.time()
        ctx = altered_tokens() if args.mode == "token" else contextlib.nullcontext()
        with ctx:
            out = execute(run_args, device, root, step_hook=half_batch if args.mode == "half_batch" else None)
        row = {"workload": args.workload, "seed": seed, "mode": args.mode, "numbers": out.numbers,
               "e2e": out.e2e, "peak": out.peak}
        if args.mode == "control":
            dev = device if device is not None else torch.device("cuda", 0)
            row["control"] = control_numbers(out, seed, dev)
        row["wall_s"] = time.time() - t0
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        del out
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
