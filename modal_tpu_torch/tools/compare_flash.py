"""Check and time the flash-attention kernels (K1 forward, K2 dQ, K3 dK/dV)
of one checkout of this repository, so that two checkouts can be compared
on one card inside one call.

    python modal_tpu_torch/tools/compare_flash.py [--root PATH] [--rounds 5] [--out PATH]

`--root` names the checkout whose `modal_tpu_torch` is imported (default:
the one holding this file); run it as a script, not with `-m`, so that the
package comes from that root. For each (B, S, H, D, causal) of SHAPES the
kernels are held to their plain versions: the largest |kernel − plain| and
the worst relative L2 over the 64-row tiles of every (batch, head) of K1's
out, K2's dQ and K3's dK and dV (K2 and K3 from the plain forward's lse, so
a fault in K1 does not reach them). Then, at B1 S2048 H32 D128 causal, the
median, min and max of `--rounds` rounds of each kernel's mean time over 20
launches (CUDA events), in turns with SDPA's forward and backward (its
cuDNN backend). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPES = ((1, 2048, 32, 128, True), (2, 256, 4, 64, False), (1, 384, 2, 128, True), (1, 64, 2, 128, True),
          (1, 384, 2, 32, True), (1, 384, 2, 64, True), (2, 256, 4, 128, True), (1, 128, 2, 128, False))


def worst_tile(diff, ref, rows: int = 64) -> float:
    b, s, h, d = ref.shape
    tiles = (b, s // rows, rows, h, d)
    return (diff.float().reshape(tiles).norm(dim=(2, 4)) / ref.float().reshape(tiles).norm(dim=(2, 4))).max().item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from modal_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        raise SystemExit("compare_flash needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    checks = []
    for (b, s, h, d, causal) in SHAPES:
        q, k, v, do = (rnd((b, s, h, d)) for _ in range(4))
        out, lse = A.flash_attention_fwd(q, k, v, causal)
        ref_out, ref_lse = A.flash_attention_fwd_ref(q, k, v, causal)
        delta = A.flash_attention_delta(ref_out, do)
        dq = A.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal)
        dk, dv = A.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal)
        torch.cuda.synchronize()
        grads = A.flash_attention_bwd_ref(q, k, v, ref_out, ref_lse, do, causal)
        row = {"shape": [b, s, h, d, causal], "lse_max_err": (lse - ref_lse).abs().max().item()}
        for name, got, ref in (("out", out, ref_out), ("dq", dq, grads[0]), ("dk", dk, grads[1]), ("dv", dv, grads[2])):
            diff = got.float() - ref.float()
            row[name] = {"max_err": diff.abs().max().item(), "worst_tile_rel_l2": worst_tile(diff, ref)}
        checks.append(row)
        print(f"check B{b} S{s} H{h} D{d} causal={causal}: lse {row['lse_max_err']:.3e} " + ", ".join(
            f"{n} max {row[n]['max_err']:.3e} tile {row[n]['worst_tile_rel_l2']:.3e}" for n in ("out", "dq", "dk", "dv")),
            flush=True)

    q, k, v, do = (rnd((1, 2048, 32, 128)) for _ in range(4))
    out, lse = A.flash_attention_fwd(q, k, v, True)
    delta = A.flash_attention_delta(out, do)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    def sdpa_cudnn():  # SDPA pinned to its cuDNN backend, as chip_smoke.py pins it
        return sdpa_kernel(SDPBackend.CUDNN_ATTENTION)

    with sdpa_cudnn():
        o_sd = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    do_sd = do.transpose(1, 2).contiguous()
    fns = {
        "K1 flash_fwd": lambda: A.flash_attention_fwd(q, k, v, True),
        "SDPA forward": lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        "K2 flash_bwd_dq": lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, True),
        "K3 flash_bwd_dkv": lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, True),
        "SDPA backward": lambda: torch.autograd.grad(o_sd, (qt, kt, vt), do_sd, retain_graph=True),
    }

    def time_ms(fn, iters: int = 20) -> float:
        """As chip_smoke.py's: a spin kernel holds the card while the host
        queues the calls, so the events time the device."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    times: dict = {name: [] for name in fns}
    with sdpa_cudnn():
        for r in range(args.rounds):
            for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                times[name].append(time_ms(fns[name]))
    timing = {n: {"median_ms": statistics.median(ts), "min_ms": min(ts), "max_ms": max(ts)} for n, ts in times.items()}
    print(f"card: {card}; root {os.path.abspath(args.root)}; B1 S2048 H32 D128 causal, median [min, max] of "
          f"{args.rounds} rounds:")
    for n, t in timing.items():
        print(f"  {n:18s} {t['median_ms']:.4f} [{t['min_ms']:.4f}, {t['max_ms']:.4f}] ms", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "root": os.path.abspath(args.root), "checks": checks, "timing": timing}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
