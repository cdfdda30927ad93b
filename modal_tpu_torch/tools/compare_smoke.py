"""Per-call cold and warm numbers of the function-calling phases of two
`chip_smoke.py --out` runs, side by side.

    python -m modal_tpu_torch.tools.compare_smoke BASE.json NEW.json

For the worker, app, pool, image and cli phases it prints each call's
time in the base run and the new one, and the difference. Where a
`BASE.log` and `NEW.log` (the runs' standard output) sit beside the JSON
files, it also prints each phase's wall time from their `[phase] phase
done in` lines. The warm calls whose rounds the smoke keeps (the app
phase's five `.remote()` pings) are given as their median.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
from typing import Any, Optional

PHASES = ("worker", "app", "pool", "image", "cli")


def _get(doc: dict, path: str) -> Any:
    """`doc` at a dotted path (list items by index); None where absent."""
    node: Any = doc
    for key in path.split("."):
        if isinstance(node, list):
            node = node[int(key)] if key.isdigit() and int(key) < len(node) else None
        elif isinstance(node, dict):
            node = node.get(key)
        else:
            return None
        if node is None:
            return None
    return node


def _median(values: Optional[list]) -> Optional[float]:
    return statistics.median(values) if values else None


# (phase, label, unit, how to read it from one run's JSON)
ROWS = (
    ("worker", "cold .map() input -> output", "s", lambda d: _get(d, "worker.map_to_output_s.0")),
    ("worker", "warm .map() input -> output", "s", lambda d: _get(d, "worker.map_to_output_s.1")),
    ("worker", "cold spawn -> first output", "s", lambda d: _get(d, "worker.split_cold.spawn_to_first_output_s")),
    ("worker", "cold import torch", "s", lambda d: _get(d, "worker.split_cold.import_torch_s")),
    ("worker", "crash: first output", "s", lambda d: _get(d, "worker.crash.first_output_s")),
    ("worker", "crash: second output after the first", "s",
     lambda d: _get(d, "worker.crash.second_output_after_first_s")),
    ("app", "cold cls .remote()", "s", lambda d: _get(d, "app.cold_split.remote_s")),
    ("app", "warm cls .remote() (serve 8)", "s", lambda d: _get(d, "app.serve_all.1.wall_s_client")),
    ("app", "warm method ping, median of 5", "ms", lambda d: _median(_get(d, "app.warm.app_ms"))),
    ("app", "warm raw ping, median of 5", "ms", lambda d: _median(_get(d, "app.warm.raw_ms"))),
    ("app", ".map() of 8 forwards, per input", "s", lambda d: _get(d, "app.forward_last.map_per_input_s")),
    ("app", "app-file function .remote()", "s", lambda d: _get(d, "app.file_function.remote_s")),
    ("pool", "pooled .map() input -> output", "s", lambda d: _get(d, "pool.runs.0.split.map_to_output_s")),
    ("pool", "unpooled .map() input -> output", "s", lambda d: _get(d, "pool.runs.1.split.map_to_output_s")),
    ("pool", "min_containers=1 input -> output", "s", lambda d: _get(d, "pool.min_containers.map_to_output_s")),
    ("image", "prewarmed: call -> first output", "s",
     lambda d: _get(d, "image.prewarmed.split.call_to_first_output_s")),
    ("image", "prewarmed: spawn -> first output", "s",
     lambda d: _get(d, "image.prewarmed.split.spawn_to_first_output_s")),
    ("image", "twin: call -> first output", "s", lambda d: _get(d, "image.twin.split.call_to_first_output_s")),
    ("image", "twin: spawn -> first output", "s", lambda d: _get(d, "image.twin.split.spawn_to_first_output_s")),
    ("image", "pooled: call -> result", "s", lambda d: _get(d, "image.pooled.call_to_result_s")),
    ("cli", "`run` (cold class call, map across a crash)", "s", lambda d: _get(d, "cli.commands.run")),
    ("cli", "cold class call, critical path", "ms", lambda d: _get(d, "cli.critical_paths.0.total_ms")),
    ("cli", "warm class call, critical path", "ms", lambda d: _get(d, "cli.critical_paths.1.total_ms")),
    ("cli", "warm function .remote()", "s", lambda d: _get(d, "cli.result.single.remote_s")),
    ("cli", ".map() of 8 across the crash", "s", lambda d: _get(d, "cli.result.map_s")),
    ("cli", "crash -> next output", "s", lambda d: _get(d, "cli.crash_to_next_output_s")),
)

_PHASE_DONE = re.compile(r"^\[(\w+)\] phase done in ([0-9.]+)s")


def phase_seconds(log_path: str) -> dict[str, float]:
    """{phase: wall seconds} from a run's standard output; {} without it."""
    if not os.path.exists(log_path):
        return {}
    out = {}
    with open(log_path, errors="replace") as f:
        for line in f:
            m = _PHASE_DONE.match(line)
            if m:
                out[m.group(1)] = float(m.group(2))
    return out


def compare(base: dict, new: dict) -> list[tuple[str, str, str, Optional[float], Optional[float]]]:
    return [(phase, label, unit, read(base), read(new)) for phase, label, unit, read in ROWS]


def _fmt(x: Optional[float]) -> str:
    return "-" if x is None else f"{x:.4f}"


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", help="the base run's chip_smoke.py --out JSON")
    ap.add_argument("new", help="the new run's chip_smoke.py --out JSON")
    args = ap.parse_args(argv)
    with open(args.base) as f:
        base = json.load(f)
    with open(args.new) as f:
        new = json.load(f)
    print(f"base {args.base}: {base.get('nvidia_smi', '')}")
    print(f"new  {args.new}: {new.get('nvidia_smi', '')}")
    print(f"{'phase':<11} {'call':<44} {'unit':<4} {'base':>10} {'new':>10} {'new-base':>10}")
    for phase, label, unit, b, n in compare(base, new):
        diff = None if b is None or n is None else n - b
        print(f"{phase:<11} {label:<44} {unit:<4} {_fmt(b):>10} {_fmt(n):>10} {_fmt(diff):>10}")
    pb = phase_seconds(os.path.splitext(args.base)[0] + ".log")
    pn = phase_seconds(os.path.splitext(args.new)[0] + ".log")
    if pb or pn:
        print(f"{'phase':<11} {'wall':<44} {'unit':<4} {'base':>10} {'new':>10} {'new-base':>10}")
        for phase in sorted(set(pb) | set(pn), key=lambda p: (p not in PHASES, p)):
            b, n = pb.get(phase), pn.get(phase)
            diff = None if b is None or n is None else n - b
            print(f"{phase:<11} {'phase wall time':<44} {'s':<4} {_fmt(b):>10} {_fmt(n):>10} {_fmt(diff):>10}")
        tb, tn = sum(pb.values()), sum(pn.values())
        print(f"{'all':<11} {'sum of phase wall times':<44} {'s':<4} {tb:>10.4f} {tn:>10.4f} {tn - tb:>10.4f}")


if __name__ == "__main__":
    main()
