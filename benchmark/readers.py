"""What the per-layer readers (`benchmark/metrics/<metric>.py`) share: the
window's tokens as the clients saw them, the prefill chunks as the
engine's spans recorded them, and the traced kernels. Each function
returns None where the run holds nothing to read."""

from __future__ import annotations

from typing import Optional

from . import roofline


def decode_tokens(serve, t0: float, t1: float):
    """(prompt tokens, token index) of every token a decode step produced
    that reached its client in [t0, t1); the first token of a request
    comes from its prefill and is left out."""
    for r in serve.records:
        for i, t in enumerate(r.arrivals):
            if i >= 1 and t0 <= t < t1:
                yield r.prompt_tokens, i


def prefill_chunks(serve):
    """(request id, offset, chunk tokens, wall start) of every prefill chunk
    span the run recorded."""
    for name, start, _end, attrs in serve.spans:
        if name == "serving.prefill_chunk":
            yield attrs["request_id"], int(attrs["offset"]), int(attrs["chunk_tokens"]), start


def idle_share(run) -> Optional[float]:
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - min(tr.busy_s, tr.window_s) / tr.window_s)


def train_kernel_share(run, needle: str, count_fn) -> Optional[float]:
    """The roofline share of every traced call of the training kernel named
    by `needle`, each call doing the work `count_fn(batch, seq_len, heads,
    head_dim)` gives as (flops, bytes)."""
    tr = run.trace
    if tr is None:
        return None
    calls = tr.kernels(needle)
    if not calls:
        return None
    m, mix = run.model, run.mix
    flops, nbytes = count_fn(int(mix["batch"]), int(mix["seq_len"]), m.num_attention_heads, m.head_dim)
    seconds = sum(e - s for _n, s, e in calls)
    return roofline.share(len(calls) * flops, len(calls) * nbytes, seconds)
