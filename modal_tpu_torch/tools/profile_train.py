"""Where a training step's time goes on the card: llama3-8b (seeded random
weights), B 1, S 2048, remat on, one card.

    python -m modal_tpu_torch.tools.profile_train [--steps 3] [--out PATH]

Built from `create_state` and its step function, as `train_demo` runs them.
After two warm-up steps, `--steps` steps are timed on the host clock (each
ends in a device synchronise; the time until the step function returns is
the host's part), then `--steps` more run under
`torch.profiler` for device time by kernel, grouped into the attention
kernels, cuBLAS GEMMs, the fused AdamW and the rest, and the device's busy
share (kernel time over the window's wall time; the step runs on one
stream; host-side ranges that the profiler also draws on the device are
left out), and the profiled device time per step over the unprofiled step
time, which leaves out the profiler's own host overhead. Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

GROUPS = (
    ("K1 flash_fwd", ("flash_fwd_kernel",)),
    ("K2 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("K3 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("AdamW (fused)", ("adam",)),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, needles in GROUPS:
        if any(n in low for n in needles):
            return group
    return "other (elementwise, reductions, copies)"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3, help="steps timed, and steps profiled")
    ap.add_argument("--out", default="", help="write the measurements as JSON here")
    args = ap.parse_args()

    from modal_tpu_torch.models.llama import get_config
    from modal_tpu_torch.ops import _build
    from modal_tpu_torch.parallel.train import TrainConfig, create_state

    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    _build.build()
    cfg = get_config("llama3-8b")
    state, step_fn = create_state(cfg, TrainConfig(warmup_steps=10, total_steps=100), seed=0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")

    def step() -> tuple[float, float]:
        """(step ms, host ms): the wall time to the device's end of the
        step, and the time until the step function returned to the host."""
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _metrics = step_fn(state, tokens)
        t_host = time.perf_counter()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, (t_host - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    warmup_ms = [step()[0] for _ in range(2)]
    timed = [step() for _ in range(args.steps)]
    step_ms = [t for t, _h in timed]
    host_ms = [h for _t, h in timed]
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, _metrics = step_fn(state, tokens)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e) -> float:
        return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))

    averages = prof.key_averages()
    # a record_function range (the optimizer's "Optimizer.step#AdamW.step")
    # shows on the device too, under the same name as on the host: not a kernel
    host_keys = {e.key for e in averages if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host_keys]
    by_kernel = sorted(
        ((e.key, device_us(e) / 1e3, e.count) for e in kernels if device_us(e) > 0), key=lambda t: -t[1]
    )
    device_ms = sum(ms for _k, ms, _n in by_kernel)
    groups: dict[str, dict] = {}
    for name, ms, n in by_kernel:
        g = groups.setdefault(group_of(name), {"ms_per_step": 0.0, "calls_per_step": 0.0})
        g["ms_per_step"] += ms / args.steps
        g["calls_per_step"] += n / args.steps
    mean_ms = sum(step_ms) / len(step_ms)
    result = {
        "card": card,
        "config": "llama3-8b B1 S2048 remat",
        "warmup_step_ms": warmup_ms,
        "step_ms": step_ms,
        "step_ms_mean": mean_ms,
        # the host's share of the step: until the step function returns
        # (its launches and the clip's one device sync) over the step
        "host_ms": host_ms,
        "host_share": sum(host_ms) / sum(step_ms),
        "tokens_per_s": 2048 * 1e3 / mean_ms,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "profiled_window_ms": window_ms,
        "profiled_device_ms": device_ms,
        "device_busy_share": device_ms / window_ms,
        # the profiled device time per step over the unprofiled step time:
        # the busy share without the profiler's own host overhead
        "device_share_of_step": device_ms / args.steps / mean_ms,
        "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms_per_step"])),
        "top_kernels": [
            {"name": k[:120], "ms_per_step": ms / args.steps, "calls_per_step": n / args.steps}
            for k, ms, n in by_kernel[:15]
        ],
    }
    print(f"card: {card}")
    print(f"step ms: warm-up {[round(x, 1) for x in warmup_ms]}, timed {[round(x, 1) for x in step_ms]} "
          f"(mean {mean_ms:.1f} -> {result['tokens_per_s']:.1f} tokens/s), peak "
          f"{result['peak_memory_bytes'] / 1e9:.2f} GB")
    print(f"host: the step function returned after {[round(x, 1) for x in host_ms]} ms "
          f"(host share {result['host_share']:.3f})")
    print(f"profiled {args.steps} steps: wall {window_ms:.1f} ms, device {device_ms:.1f} ms, "
          f"busy share {result['device_busy_share']:.3f} under the profiler; device ms per step over "
          f"the unprofiled step: {result['device_share_of_step']:.3f}")
    for name, g in result["groups"].items():
        print(f"  {g['ms_per_step']:8.2f} ms/step  {g['calls_per_step']:7.1f} calls/step  {name}")
    for row in result["top_kernels"]:
        print(f"  {row['ms_per_step']:8.3f} ms/step  {row['calls_per_step']:6.1f} calls/step  {row['name']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
