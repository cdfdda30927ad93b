"""Check and time the attention kernels (K1 flash forward, K2 dQ, K3 dK/dV,
K4 paged decode) of one checkout of this repository, so that two checkouts
can be compared on one card inside one call.

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
cuDNN backend).

K4 goes through the public `paged_decode_attention` and its plain version
`paged_decode_attention_ref`, which every checkout since the first has, at
the serving shapes (8 slots, n_kv 8, n_rep 4, hd 128, page 16, 512 pages per
slot): held to its plain version (largest |kernel − plain| and the worst
relative L2 over each (slot, kv head) of the live slots) at the serving
lengths and at q_pos on and around 256-token boundaries, then timed warm (50
back-to-back calls per round, in the same turns) and cold (the median of 20
calls, each timed alone after a 256 MB write flushes the 50 MB L2). Needs
one CUDA card.
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
    from modal_tpu_torch.ops import paged_attention as PA

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

    # K4 at the serving shapes: the serving lengths (slot 3 inactive, its
    # table at the scratch page), then q_pos on and around 256-token
    # boundaries and at the span's end
    s, n_kv, n_rep, hd, page, pps = 8, 8, 4, 128, 16, 512
    span = page * pps
    pq = rnd((s, n_kv, n_rep, hd))
    kp, vp = rnd((1 + s * pps, page, n_kv, hd)), rnd((1 + s * pps, page, n_kv, hd))

    def tables(lens, inactive=()):
        pt = (torch.randperm(s * pps, generator=gen, device="cuda").to(torch.int32) + 1).reshape(s, pps)
        for i in inactive:
            pt[i] = 0
        return pt.contiguous(), torch.tensor(lens, dtype=torch.int32, device="cuda")

    pt, sl = tables([0, 4095, 1, 0, 2047, 517, 3000, 100], inactive=[3])
    live = [0, 1, 2, 4, 5, 6, 7]
    boundary = tables([0, 255, 256, 257, span - 1, 511, 512, 4097])
    for label, (tab, lens), rows in (("serving", (pt, sl), live), ("boundaries", boundary, list(range(s)))):
        got = PA.paged_decode_attention(pq, kp, vp, tab, lens)
        torch.cuda.synchronize()
        ref = PA.paged_decode_attention_ref(pq, kp, vp, tab, lens)
        diff = (got[rows].float() - ref[rows].float())
        row = {"kernel": "K4 paged_decode", "lengths": lens.tolist(), "max_err": diff.abs().max().item(),
               "worst_head_rel_l2": (diff.norm(dim=(2, 3)) / ref[rows].float().norm(dim=(2, 3))).max().item()}
        checks.append(row)
        print(f"check K4 {label} q_pos {row['lengths']}: max {row['max_err']:.3e} "
              f"worst (slot, kv head) rel L2 {row['worst_head_rel_l2']:.3e}", flush=True)
    del boundary

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
        "K4 paged_decode": lambda: PA.paged_decode_attention(pq, kp, vp, pt, sl),
    }
    iters = {"K4 paged_decode": 50}

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
                times[name].append(time_ms(fns[name], iters.get(name, 20)))
    timing = {n: {"median_ms": statistics.median(ts), "min_ms": min(ts), "max_ms": max(ts)} for n, ts in times.items()}

    # K4 cold: each call timed alone after a write of 5x the L2
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(20)]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        flush.fill_(1)
        start.record()
        fns["K4 paged_decode"]()
        end.record()
    torch.cuda.synchronize()
    cold = [start.elapsed_time(end) for start, end in events]
    timing["K4 paged_decode cold"] = {"median_ms": statistics.median(cold), "min_ms": min(cold), "max_ms": max(cold)}
    print(f"card: {card}; root {os.path.abspath(args.root)}; K1-K3 at B1 S2048 H32 D128 causal, K4 at the "
          f"serving shapes; median [min, max] of {args.rounds} rounds (K4 cold: of 20 calls):")
    for n, t in timing.items():
        print(f"  {n:20s} {t['median_ms']:.4f} [{t['min_ms']:.4f}, {t['max_ms']:.4f}] ms", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "root": os.path.abspath(args.root), "checks": checks, "timing": timing}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
