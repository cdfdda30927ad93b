"""Device milliseconds a step in the fused AdamW kernels, over the traced
stretch; its steps are counted by K3's calls (one per layer a step)."""

from benchmark.trace import ADAM, K3


def read(run):
    tr = run.trace
    if tr is None:
        return None
    steps = len(tr.kernels(K3)) / run.model.num_hidden_layers
    adam = [op for op in tr.ops if ADAM in op[0].lower()]
    if steps <= 0 or not adam:
        return None
    return 1e3 * sum(e - s for _n, s, e in adam) / steps
