"""K4's share of its roofline in the traced stretch: the bytes its calls
need over the device time of `paged_decode_kernel`, against the card's HBM
bandwidth. A call's bytes: each decoding slot's live K and V read once per
layer, where the full pages of a shared document, which several slots
read through the prefix cache, are one input and count once per call;
and each call's q, output, page table and lengths. The decode tokens that
reached their clients while the trace ran give the live contexts, grouped
into steps by their arrival (a step's tokens arrive together, steps tens
of milliseconds apart)."""

from benchmark import roofline
from benchmark.trace import K4

STEP_GAP_S = 0.005


def read(run):
    s, tr = run.serve, run.trace
    if s is None or tr is None:
        return None
    calls = tr.kernels(K4)
    if not calls:
        return None
    m, info = run.model, s.engine_info
    doc = run.mix.get("shared_prefix")
    shared = (int(doc["tokens"]) // info["page_size"]) * info["page_size"] if doc else 0
    tokens = sorted((t, r.prompt_tokens + i, r.shared_prefix) for r in s.records
                    for i, t in enumerate(r.arrivals) if i >= 1 and tr.t0 <= t < tr.t1)
    kv_token = m.num_hidden_layers * roofline.paged_decode_kv_bytes(1, m.num_key_value_heads, m.head_dim)
    kv = flops = 0
    step_docs: set = set()
    last = None
    for t, ctx, d in tokens:
        if last is not None and t - last > STEP_GAP_S:
            kv += len(step_docs) * shared * kv_token
            step_docs = set()
        last = t
        own = ctx - shared if d >= 0 else ctx
        if d >= 0:
            step_docs.add(d)
        kv += own * kv_token
        flops += m.num_hidden_layers * roofline.paged_decode_flops(ctx, m.num_attention_heads, m.head_dim)
    kv += len(step_docs) * shared * kv_token
    io = len(calls) * roofline.paged_decode_io_bytes(info["max_slots"], m.num_attention_heads, m.head_dim,
                                                     info["pages_per_slot"])
    return roofline.share(flops, kv + io, sum(e - st for _n, st, e in calls))
