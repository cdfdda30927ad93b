"""The arithmetic of the split-sequence paged decode kernel, held on the CPU.

`csrc/paged_decode.cu` (K4) cuts each slot's span into chunks of `chunk`
tokens, one block per (kv head, slot, chunk). Each live chunk keeps its own
online-softmax partial (m, l, acc) in fp32; a slot with one live chunk writes
acc / l directly, otherwise the last block to finish rescales every partial
to the common max and divides, with the `l == 0` guard of the Pallas kernel
(modal_tpu/ops/paged_attention.py:89). `split_decode` below is a plain-torch
model of that partition and combine, written here and not taken from the
kernel, so that the partition itself is held against the plain gather
version and against the Pallas kernel in interpret mode, at chunk sizes of
one page, two pages and the whole span, with q_pos at 0, on and around the
chunk boundaries and at the span's end.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modal_tpu.ops.paged_attention import paged_decode_attention as jax_paged_decode
from modal_tpu_torch.ops.paged_attention import (
    DECODE_CHUNK,
    decode_splits,
    paged_decode_attention_ref,
)

NEG = -1e30  # the kernel's and the Pallas kernel's "no score yet"
PAGE, PPS, N_KV, N_REP, HD = 8, 4, 2, 2, 32
SPAN = PAGE * PPS
_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _chunk_partial(q, keys, vals):
    """(m, l, acc) of one chunk for every (kv head, rep): q [n_kv, n_rep, hd],
    keys and vals [n, n_kv, hd], all fp32. An empty chunk is (NEG, 0, 0)."""
    n_kv, n_rep, hd = q.shape
    if keys.shape[0] == 0:
        return (torch.full((n_kv, n_rep), NEG), torch.zeros((n_kv, n_rep)), torch.zeros((n_kv, n_rep, hd)))
    logits = torch.einsum("krd,nkd->krn", q, keys) / math.sqrt(hd)
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    return m, p.sum(-1), torch.einsum("krn,nkd->krd", p, vals)


def _combine(parts):
    """The last block's merge of a slot's partials, `l == 0` guarded."""
    ms, ls, accs = (torch.stack(x) for x in zip(*parts))
    m = ms.amax(0)
    c = torch.exp(ms - m)
    l_tot = (ls * c).sum(0)
    acc = (accs * c[..., None]).sum(0)
    return acc / torch.where(l_tot == 0, torch.ones_like(l_tot), l_tot)[..., None]


def split_decode(q, k_pages, v_pages, page_table, seq_lens, chunk, extra_empty=0):
    """K4's partition in plain torch: per slot, the live chunks'
    ceil((q_pos + 1) / chunk) partials (at least one, so a slot with no
    token still writes its l == 0 output), merged unless there is only one.
    `extra_empty` appends that many empty partials to every merge, as a
    chunk with no live token would give."""
    s_count, _n_kv, _n_rep, hd = q.shape
    page = k_pages.shape[1]
    span = page_table.shape[1] * page
    out = torch.empty(q.shape, dtype=torch.float32)
    for s in range(s_count):
        n_tok = min(max(int(seq_lens[s]) + 1, 0), span)
        n_live = max(1, -(-n_tok // chunk))
        pos = torch.arange(n_tok)
        keys = k_pages[page_table[s].long()[pos // page], pos % page].float()
        vals = v_pages[page_table[s].long()[pos // page], pos % page].float()
        parts = [
            _chunk_partial(q[s].float(), keys[i * chunk:(i + 1) * chunk], vals[i * chunk:(i + 1) * chunk])
            for i in range(n_live)
        ]
        if n_live == 1 and not extra_empty:
            _m, l_sum, acc = parts[0]
            out[s] = acc / torch.where(l_sum == 0, torch.ones_like(l_sum), l_sum)[..., None]
        else:
            empty = _chunk_partial(q[s].float(), keys[:0], vals[:0])
            out[s] = _combine(parts + [empty] * extra_empty)
    return out.to(q.dtype)


def _boundary_positions(chunk):
    """q_pos at 0, on and around the chunk boundaries, and at the span's end."""
    cands = {0, chunk - 1, chunk, chunk + 1, 2 * chunk - 1, 2 * chunk, SPAN - 1}
    return sorted(p for p in cands if 0 <= p < SPAN)


def _inputs(dtype, positions, seed):
    """Seeded q and page pool as JAX arrays and torch tensors holding the same
    values, a random page table over pages 1.. and the slots' q_pos."""
    rng = np.random.default_rng(seed)
    s = len(positions)
    n_pages = 1 + s * PPS
    jd, td = _DTYPES[dtype]
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((s, N_KV, N_REP, HD), (n_pages, PAGE, N_KV, HD), (n_pages, PAGE, N_KV, HD))]
    table = (rng.permutation(s * PPS) + 1).reshape(s, PPS).astype(np.int32)
    lens = np.asarray(positions, np.int32)
    jax_args = [jnp.asarray(a, jd) for a in arrays] + [jnp.asarray(table), jnp.asarray(lens)]
    torch_args = [torch.from_numpy(a).to(td) for a in arrays] + [torch.from_numpy(table), torch.from_numpy(lens)]
    return jax_args, torch_args


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("reference", ["plain", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [PAGE, 2 * PAGE, SPAN])
def test_split_partition_matches_references(chunk, dtype, reference):
    positions = _boundary_positions(chunk)
    j_args, t_args = _inputs(dtype, positions, seed=chunk)
    got = split_decode(*t_args, chunk=chunk)
    if reference == "plain":
        want = paged_decode_attention_ref(*t_args)
    else:
        want = jax_paged_decode(*j_args, interpret=True)
    assert got.dtype == t_args[0].dtype and got.shape == t_args[0].shape
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=TOL[dtype],
                               err_msg=f"q_pos {positions}")


@pytest.mark.parametrize("chunk", [PAGE, 2 * PAGE, SPAN])
def test_split_combine_ignores_empty_chunks(chunk):
    """An empty partial (m = NEG, l = 0, acc = 0) weighs exp(NEG − m) = 0 in
    the merge: adding some changes no output, and a slot whose single chunk
    sees every token merges to the unsplit result."""
    positions = _boundary_positions(chunk)
    _j, t_args = _inputs("float32", positions, seed=100 + chunk)
    plain = split_decode(*t_args, chunk=chunk)
    np.testing.assert_allclose(split_decode(*t_args, chunk=chunk, extra_empty=3).numpy(), plain.numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(split_decode(*t_args, chunk=SPAN).numpy(), plain.numpy(), atol=1e-5, rtol=1e-5)


def test_split_l_zero_guard_matches_pallas():
    """A slot with no visible token (q_pos = −1) has l = 0 in its only chunk
    and in the merge alike: the guard writes 0, as the Pallas kernel does,
    where the plain softmax over nothing would give NaN."""
    j_args, t_args = _inputs("float32", [-1, 5, SPAN - 1], seed=7)
    want = _np(jax_paged_decode(*j_args, interpret=True))
    np.testing.assert_array_equal(want[0], 0.0)
    for extra in (0, 2):
        got = split_decode(*t_args, chunk=PAGE, extra_empty=extra).numpy()
        np.testing.assert_array_equal(got[0], 0.0)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "page,pps,chunk,want",
    [(16, 512, DECODE_CHUNK, 32), (16, 4, DECODE_CHUNK, 1), (8, 4, 8, 4), (8, 5, 16, 3), (16, 17, 256, 2)],
)
def test_decode_splits_from_shapes(page, pps, chunk, want):
    """The split count is ceil(pages_per_slot · page / chunk), from the
    shapes alone (the host never reads seq_lens), and covers the span."""
    n = decode_splits(page, pps, chunk)
    assert n == want
    assert (n - 1) * chunk < page * pps <= n * chunk
