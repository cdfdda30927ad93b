"""The window's model FLOPs over its length, as a share of the card's bf16
peak: the prefill chunks that began in it (`serving.prefill_chunk` spans)
and the decode tokens that reached a client in it, each counted as
`benchmark.roofline` counts a token (every weight but the embedding,
attention over its context, the head where logits are needed)."""

from benchmark import roofline
from benchmark.readers import decode_tokens, prefill_chunks


def read(run):
    s = run.serve
    if s is None:
        return None
    m = run.model
    flops = sum(roofline.prefill_chunk_flops(m, offset, tokens)
                for _rid, offset, tokens, start in prefill_chunks(s) if s.wall0 <= start < s.wall1)
    flops += sum(roofline.decode_token_flops(m, prompt + i) for prompt, i in decode_tokens(s, s.t0, s.t1))
    if flops <= 0:
        return None
    return 100.0 * flops / (s.t1 - s.t0) / roofline.BF16_FLOPS
