"""The cache-less forward of a seeded Llama through the flash kernel (K1),
held against the plain attention and fp32 attention, in a process of its
own: what a `gpu=` sandbox's exec runs.

    python -m modal_tpu_torch.tools.sandbox_forward [--config llama3-8b] \\
        [--seed 0] [--lengths 128,256,384,512] [--device cuda]

Builds the model's random weights from the seed on the device, runs one
untimed forward (K1's build and the libraries' warm-up), then
`llama.forward` twice per prompt (one prompt per length, tokens from the
seed), counts K1's launches per call, times each call on the device and
on the host (until the call returned, before any sync), then runs the same
prompts through the plain attention and through fp32 attention, and prints
one JSON line:

    {"device": ..., "cuda_visible_devices": ..., "config": ..., "lengths": [...],
     "launches_per_call": [...], "ms_per_call": [...], "host_ms_per_call": [...],
     "launches_per_call_again": [...], "ms_per_call_again": [...],
     "host_ms_per_call_again": [...], "gaps": {...}, "peak_device_bytes": N}

`gaps` holds, over every prompt's logits, the max and mean |difference| of
kernel vs plain, kernel vs fp32 and plain vs fp32, and the share of rows
whose greedy token matches fp32 attention's (ROADMAP Queue C 4: the kernel
path must sit at least as close to fp32 as the plain path). On the CPU
(`--device cpu`) the wrapper runs its plain version and K1 counts no launch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _sums(out: dict) -> dict:
    """One forward's gap terms as sums, so several forwards pool."""
    ref = out["fp32"].argmax(-1)
    sums = {"rows": ref.numel(), "n": out["fp32"].numel(), "sum": out["fp32"].sum().item(),
            "sumsq": out["fp32"].square().sum().item()}
    for a, b in (("kernel", "plain"), ("kernel", "fp32"), ("plain", "fp32")):
        d = (out[a] - out[b]).abs()
        sums[f"{a}_vs_{b}"] = {"max": d.max().item(), "sum": d.sum().item()}
    for a in ("kernel", "plain"):
        sums[f"{a}_agree"] = (out[a].argmax(-1) == ref).sum().item()
    return sums


def pooled_gaps(parts: list) -> dict:
    n, rows = sum(p["n"] for p in parts), sum(p["rows"] for p in parts)
    mean = sum(p["sum"] for p in parts) / n
    g = {k: {"max": max(p[k]["max"] for p in parts), "mean": sum(p[k]["sum"] for p in parts) / n}
         for k in ("kernel_vs_plain", "kernel_vs_fp32", "plain_vs_fp32")}
    g.update({f"{a}_token_agreement": sum(p[f"{a}_agree"] for p in parts) / rows for a in ("kernel", "plain")})
    g["logit_std"] = ((sum(p["sumsq"] for p in parts) - n * mean * mean) / (n - 1)) ** 0.5
    return g


def _timed(torch, fn, on_card: bool) -> tuple:
    """`fn()`, with the device's ms between CUDA events around it and the
    host's ms until `fn` returned, before any sync: when the two are close,
    the device waited on the host's launches."""
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    out = fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    if not on_card:
        return out, host_ms, host_ms
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), host_ms


def measure(params, cfg, lengths: list, seed: int, device: str, gaps: bool = True) -> dict:
    """One untimed forward (K1's build and the libraries' warm-up), then per
    length one prompt (tokens from the seed) through `llama.forward` twice,
    each call timed (`_timed`), K1's launches counted per call; with `gaps`,
    the prompt also goes through the plain attention and fp32 attention."""
    import torch

    from ..models.llama import attention, forward
    from ..ops import _build

    def fp32_attention(q, k, v, mask):
        return attention(q.float(), k.float(), v.float(), mask).to(q.dtype)

    on_card = device == "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    forward(params, cfg, torch.randint(0, cfg.vocab_size, (1, lengths[0]), generator=gen, device=device))
    res = {f"{k}{again}": [] for again in ("", "_again") for k in ("launches_per_call", "ms_per_call",
                                                                   "host_ms_per_call")}
    parts = []
    for length in lengths:
        tokens = torch.randint(0, cfg.vocab_size, (1, length), generator=gen, device=device)
        for again in ("", "_again"):
            _build.reset_launches()
            logits, ms, host_ms = _timed(torch, lambda: forward(params, cfg, tokens)[0][0], on_card)
            res[f"launches_per_call{again}"].append(_build.LAUNCHES["flash_fwd"])
            res[f"ms_per_call{again}"].append(ms)
            res[f"host_ms_per_call{again}"].append(host_ms)
        if not bool(torch.isfinite(logits).all()) or list(logits.shape) != [length, cfg.vocab_size]:
            raise AssertionError(f"the forward at length {length} gave non-finite logits or shape "
                                 f"{list(logits.shape)}")
        if gaps:
            out = {"kernel": logits.float(),
                   "plain": forward(params, cfg, tokens, attn_impl=attention)[0][0].float(),
                   "fp32": forward(params, cfg, tokens, attn_impl=fp32_attention)[0][0].float()}
            parts.append(_sums(out))
            del out
        del logits
    if gaps:
        res["gaps"] = pooled_gaps(parts)
    return res


def run(config: str, seed: int, lengths: list, device: str) -> dict:
    import torch

    from ..models.llama import get_config, init_params

    cfg = get_config(config)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=seed, device=device)
    return {
        "device": torch.cuda.get_device_name(0) if on_card else "cpu",
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "config": config, "n_layers": cfg.n_layers, "lengths": lengths,
        **measure(params, cfg, lengths, seed, device),
        "peak_device_bytes": torch.cuda.max_memory_allocated() if on_card else 0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="llama3-8b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lengths", default="128,256,384,512")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("sandbox_forward: started", flush=True)  # the first byte an exec's reader sees
    result = run(args.config, args.seed, [int(x) for x in args.lengths.split(",")], args.device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
