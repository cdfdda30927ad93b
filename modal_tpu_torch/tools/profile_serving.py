"""Where a serving iteration's time goes on the card: llama3-8b (seeded
random weights) in the ServingEngine, 8 slots decoding at once.

    python -m modal_tpu_torch.tools.profile_serving [--steps 16] [--cuda-graphs on|off] [--out PATH]

Driven without the engine thread, so each measured piece is exactly one
engine method: `_prefill_one` (one 128-token chunk) and `_decode_step` (one
step over all 8 slots). Host clock around work that ends in a device
synchronise gives the wall times; `torch.profiler` over the decode window
gives device time by kernel and the device's busy share (sum of kernel time
over the window's wall time; overlapping kernels would count twice, and the
engine runs on one stream). `--cuda-graphs on` (the engine's default on a
card) replays the captured decode step, `off` runs it eagerly, so the two
modes' numbers come from the same tool. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=16, help="decode steps in the profiled window")
    ap.add_argument("--cuda-graphs", choices=("on", "off"), default="on",
                    help="decode step as a captured CUDA graph (on) or eagerly (off)")
    ap.add_argument("--out", default="", help="write the measurements as JSON here")
    args = ap.parse_args()

    from modal_tpu_torch.models.llama import get_config, init_params
    from modal_tpu_torch.ops import _build
    from modal_tpu_torch.serving import ServingEngine

    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    _build.build()
    cfg = get_config("llama3-8b")
    params = init_params(cfg, seed=0, device="cuda")
    engine = ServingEngine(params, cfg, max_slots=8, page_size=16, prefill_chunk=128, device="cuda",
                           cuda_graphs=args.cuda_graphs == "on")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in rng.integers(100, 601, size=8)]
    for p in prompts:
        engine.submit(p, 64 + args.steps)

    def synced(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    engine._admit()
    chunk_ms = []
    while any(s is not None and s.state == "prefill" for s in engine.slots):
        chunk_ms.append(synced(engine._prefill_one))
    for _ in range(4):  # warm-up steps
        engine._decode_step()
    step_ms = [synced(engine._decode_step) for _ in range(args.steps)]

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine._decode_step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    engine.stop()

    def device_us(e) -> float:
        return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))

    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = sorted(
        ((e.key, device_us(e) / 1e3, e.count) for e in kernels if device_us(e) > 0),
        key=lambda t: -t[1],
    )
    device_ms = sum(ms for _k, ms, _n in by_kernel)
    result = {
        "card": card,
        "cuda_graphs": args.cuda_graphs,
        "slots": 8,
        "prompt_tokens": [len(p) for p in prompts],
        "prefill_chunk_ms": chunk_ms,
        "decode_step_ms": step_ms,
        "decode_step_ms_mean": float(np.mean(step_ms)),
        "decode_tokens_per_s": 8 * 1e3 / float(np.mean(step_ms)),
        "profiled_window_ms": window_ms,
        "profiled_device_ms": device_ms,
        "device_busy_share": device_ms / window_ms,
        "top_kernels": [
            {"name": k[:120], "ms_per_step": ms / args.steps, "calls_per_step": n / args.steps}
            for k, ms, n in by_kernel[:15]
        ],
    }
    print(f"card: {card}; decode step {'captured as a CUDA graph' if args.cuda_graphs == 'on' else 'eager'}")
    print(f"prefill chunk ms (128 tokens or fewer): {[round(x, 2) for x in chunk_ms]}")
    print(f"decode step ms (8 slots): mean {result['decode_step_ms_mean']:.2f} "
          f"-> {result['decode_tokens_per_s']:.1f} tokens/s")
    print(f"profiled {args.steps} steps: wall {window_ms:.1f} ms, device {device_ms:.1f} ms, "
          f"busy share {result['device_busy_share']:.3f}")
    for row in result["top_kernels"]:
        print(f"  {row['ms_per_step']:8.3f} ms/step  {row['calls_per_step']:6.1f} calls/step  {row['name']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
