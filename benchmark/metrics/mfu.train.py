"""The window's training FLOPs over its length, as a share of the card's
bf16 peak: PERF.md's count per step, 6 · (N − V·D) · tokens + 3 × the
forward's causal attention FLOPs."""

from benchmark import roofline


def read(run):
    t = run.train
    if t is None or t.steps == 0:
        return None
    flops = t.steps * roofline.train_step_flops(run.model, int(run.mix["batch"]), int(run.mix["seq_len"]))
    return 100.0 * flops / (t.t1 - t.t0) / roofline.BF16_FLOPS
