"""Repeated runs of one cell, each a fresh process, as the benchmark's
bounds and limits are measured:

    python -m benchmark.measure --workload <cell> --seeds 11,12,13 --seconds 45 [--trace 0|1] [--out FILE]

Runs `python3 -m benchmark.run` once per seed, in order, from the
checkout's root; keeps each run's result line (or its exit code and the
end of its standard error) in `--out` as JSON lines, and prints each end-
to-end metric's values and spread (the quartiles' distance over the
median) with the card's name and power limit."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from .stats import spread

ROOT = Path(__file__).resolve().parent.parent


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    print(f"card: {card()}", flush=True)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        cmd = [sys.executable, "-m", "benchmark.run", "--workload", args.workload, "--seed", str(seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace)]
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        row = {"workload": args.workload, "seed": seed, "trace": args.trace, "rc": proc.returncode,
               "wall_s": time.time() - t0}
        lines = proc.stdout.strip().splitlines()
        try:
            row["result"] = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
        except json.JSONDecodeError:
            row["result"] = None
        if row["result"] is None:
            row["stderr"] = proc.stderr[-4000:]
        rows.append(row)
        summary = {k: v["value"] for k, v in (row["result"] or {}).get("metrics", {}).items()}
        checks = {k: v["value"] for k, v in (row["result"] or {}).get("check", {}).items()}
        print(f"seed {seed} rc {proc.returncode} {row['wall_s']:.1f}s correct "
              f"{(row['result'] or {}).get('correct')} {json.dumps(summary)} check {json.dumps(checks)}", flush=True)
        if row["result"] is None:
            print(row["stderr"][-2500:], flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    good = [r["result"] for r in rows if r["result"]]
    if len(good) >= 2:
        for name in good[0]["metrics"]:
            values = [g["metrics"][name]["value"] for g in good if name in g["metrics"]]
            print(f"{name}: {values} spread {spread(values) if len(values) >= 2 else 'n/a'}", flush=True)
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
