"""Share of the prompt tokens of the requests whose prefill began in the
window that the prefix cache spared: per request, the first
`serving.prefill_chunk` span's `offset` (tokens already cached) over that
offset plus every chunk's `chunk_tokens`."""

from benchmark.readers import prefill_chunks


def read(run):
    s = run.serve
    if s is None:
        return None
    per: dict = {}
    for rid, offset, tokens, start in prefill_chunks(s):
        first, total, t = per.get(rid, (offset, 0, start))
        per[rid] = (min(first, offset), total + tokens, min(t, start))
    inside = [(first, total) for first, total, t in per.values() if s.wall0 <= t < s.wall1]
    prompt = sum(first + total for first, total in inside)
    if prompt == 0:
        return None
    return 100.0 * sum(first for first, _ in inside) / prompt
