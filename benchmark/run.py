"""Run one cell of the benchmark and print its result as the last line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the chips the cell asks
for. `--trace 0` prints the cell's end-to-end metrics, with the program
at its defaults; `--trace 1` the per-layer ones, read through a span tap
and `torch.profiler` over the window's last `TRACE_SECONDS`. Either way
the run ends with the check against the reference (`benchmark.check`):
its numbers go to standard error as the last lines and into the result
under `check`, its last key. Kernel and compiler caches live under
`benchmark/.cache/` in the checkout, so only a checkout's first run builds.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TRACE_SECONDS = 5.0
FORBIDDEN = ("jax", "jaxlib", "flax", "modal_tpu")


def process_start() -> float:
    """Wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


STARTED = process_start()


def set_cache_dirs(root: Path) -> None:
    cache = root / "benchmark" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


class Run:
    """What a metric's reader gets: the cell's model and mix, and the
    serving or training run with its trace."""

    def __init__(self, model, mix: dict, cell: dict, seconds: float):
        self.model = model
        self.mix = mix
        self.cell = cell
        self.seconds = seconds
        self.serve = None
        self.train = None
        self.trace = None


class Outcome:
    """One run of a cell, up to the check: what the result line reports."""

    def __init__(self, run: Run):
        self.run = run
        self.e2e: dict = {}
        self.attempted = self.failed = 0
        self.peak = 0
        self.numbers: dict = {}
        self.sample: list = []  # serving: the records the check compared
        self.rows: list = []  # training: the rows of the checked steps


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args: argparse.Namespace, device, root: Path = ROOT, step_hook=None) -> Outcome:
    """Set up, measure, free the program's state and compare with the
    reference. `device` None asks for the cell's CUDA devices (SystemExit
    with code 3 without them); the tests pass "cpu". `step_hook` may wrap
    a training cell's step function (a planted fault)."""
    set_cache_dirs(root)
    # the program first: a checkout without it fails here, before any weights
    import modal_tpu_torch.parallel.train  # noqa: F401
    import modal_tpu_torch.serving.engine  # noqa: F401

    from . import check, models, spec, workload

    bench = spec.load(root)
    cell = spec.cell(bench, args.workload)
    entry = spec.config_entry(bench, cell["config"])
    model, _raw = models.load(root / entry["file"])
    mix = json.loads(spec.traffic_path(root, cell["traffic"]).read_text())
    refused = workload.mix_errors(mix)
    if refused:
        print(f"benchmark: traffic {cell['traffic']}: {'; '.join(refused)}", file=sys.stderr)
        raise SystemExit(2)

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); this machine has {have}",
                  file=sys.stderr)
            raise SystemExit(3)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    on_cuda = device.type == "cuda"

    from . import serve as serve_mod
    from . import train as train_mod
    from . import weights as weights_mod
    from .trace import Tracer

    run = Run(model, mix, cell, args.seconds)
    out = Outcome(run)
    kind = mix["kind"]
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if kind == "serve":
        w = weights_mod.make(model, args.seed, device)
        run.serve, engine = serve_mod.run(model, mix, w, args.seed, args.seconds, device, bool(args.trace),
                                          TRACE_SECONDS, Tracer)
        window_wall = run.serve.wall0
        run.trace = run.serve.trace
        out.e2e = serve_mod.metrics(run.serve)
        out.attempted, out.failed = serve_mod.attempted_failed(run.serve)
    elif kind == "train":
        run.train, state = train_mod.run(model, mix, args.seed, args.seconds, device, bool(args.trace),
                                         TRACE_SECONDS, Tracer, step_hook=step_hook)
        window_wall = time.time() - (time.perf_counter() - run.train.t0)
        run.trace = run.train.trace
        out.e2e = train_mod.metrics(run.train)
        out.attempted, out.failed = run.train.steps, 0
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    out.e2e["setup_s"] = window_wall - STARTED
    out.peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0

    # the program's state goes before the reference makes the weights again
    if kind == "serve":
        serve_mod.free(engine)
        del engine, w
    else:
        del state
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    w = weights_mod.make(model, args.seed, device)
    if kind == "serve":
        out.sample = serve_mod.sample_for_check(run.serve, int(mix["check_requests"]), args.seed)
        out.numbers.update(check.serving_numbers(model, w, out.sample))
        out.numbers["k4_launches"] = run.serve.launches.get("paged_decode", 0)
    else:
        out.rows = [workload.train_row(args.seed, k, int(mix["batch"]), int(mix["seq_len"]), model.vocab_size,
                                       device)[0] for k in range(int(mix["check_steps"]))]
        ref = check.reference_training(model, w, out.rows, mix["train_config"])
        ref_updates = check.update_norms(model, w, args.seed, device)
        out.numbers.update(check.training_numbers(run.train.losses, run.train.grad_norms,
                                                  run.train.update_norms, ref, ref_updates))
        out.numbers["step_count_gap"] = run.train.step_count_gap
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            out.numbers[f"{k}_launches"] = run.train.launches.get(k, 0)
    del w
    return out


def result_line(out: Outcome, trace: bool, root: Path = ROOT) -> dict:
    """The result's JSON object; `check` comes last."""
    import torch

    from . import check, spec

    run, cell = out.run, out.run.cell
    bench = spec.load(root)
    correct, compared = check.judge(out.numbers, check.load_limits(spec.limits_path(root, cell["name"])))
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed}
    if trace:
        values = {}
        for m in spec.cell_metrics(bench, cell["name"], "per_layer"):
            v = spec.reader(root, m["name"])(run)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = values
    else:
        result["metrics"] = {m["name"]: {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
                             for m in spec.cell_metrics(bench, cell["name"], "end_to_end")}
    on_cuda = out.peak > 0 or torch.cuda.is_available()
    result["device"] = {
        "platform": "gpu" if on_cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(out.peak),
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["check"] = compared
    return result


def main(argv=None, device=None, root: Path = ROOT) -> int:
    args = parse(argv)
    try:
        out = execute(args, device, root)
    except SystemExit as exc:
        return int(exc.code or 1)
    result = result_line(out, bool(args.trace), root)
    # last, once the window, the check and the readers have run: a module
    # any of them loaded counts
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; the port may load none of them", file=sys.stderr)
        return 4
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
