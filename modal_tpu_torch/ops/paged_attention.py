"""Paged decode attention: one query token per slot over its KV pages.

`paged_decode_attention` is the port of modal_tpu/ops/paged_attention.py:93
(the Pallas `_paged_decode_kernel`), with the same contract and layout:
q [S, n_kv, n_rep, hd], pages [P, page, n_kv, hd], page_table
[S, pages_per_slot] int32, seq_lens [S] int32 holding each slot's decode
position q_pos (inclusive: kv_pos <= q_pos is attended). Output has q's
layout. Inactive slots produce garbage the caller must not read, exactly as
in the JAX package.

On a CUDA tensor it launches the hand-written kernel in
`csrc/paged_decode.cu` (or raises); on a CPU tensor it runs
`paged_decode_attention_ref`, the plain gather + fp32-softmax version (the
gather branch of modal_tpu/models/paged_kv.py:305-317).

The kernel splits each slot's span into chunks of `DECODE_CHUNK` tokens,
one block per (kv head, slot, chunk), and merges a slot's chunks in the same
launch through a workspace of per-chunk softmax partials and per-(slot,
kv head) counters (`_decode_workspace`). An eager call's workspace belongs
to its stream; inside `graph_workspaces(store)` (a CUDA graph's warm-up and
capture) calls use the graph's own, so a graph never shares counters with
eager calls or with another graph.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading

import torch

from . import _build

KERNEL = "paged_decode"
_SUPPORTED_HD = (32, 64, 128)
_SUPPORTED_NREP = (1, 2, 4, 8)
# tokens of a slot each block of the kernel takes: 16 pages at page 16
DECODE_CHUNK = 256
# The bar the kernel is held to against its plain version on every (slot,
# kv head) of the live slots (`worst_head_rel_l2`), beside max|·| <= 2e-2:
# ~4x the worst value measured on an H100 80GB HBM3 at 700 W, 3.30e-3 (the
# bf16 rounding of the output), at the serving lengths and at q_pos on and
# around the chunk boundaries. With random V a slot that attends to ~8192
# tokens has outputs of ~1e-2, so the elementwise bar alone passes a lost or
# doubled chunk, which fails this one by more than 5x (tests/test_torch_ops.py).
DECODE_REL_L2 = 1.3e-2


def decode_splits(page: int, pages_per_slot: int, chunk: int = DECODE_CHUNK) -> int:
    """The kernel's split count, from the shapes alone: reading seq_lens on
    the host would sync the device on every decode step."""
    return -(-page * pages_per_slot // chunk)


def worst_head_rel_l2(out: torch.Tensor, ref: torch.Tensor, live) -> float:
    """The largest ‖out − ref‖ / ‖ref‖ over the (slot, kv head) pairs of the
    `live` slots of two [S, n_kv, n_rep, hd] results: a slot that lost or
    doubled part of its sequence shows at full size there."""
    out, ref = (t[list(live)].float() for t in (out, ref))
    return ((out - ref).norm(dim=(2, 3)) / ref.norm(dim=(2, 3))).max().item()


def paged_decode_attention_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
) -> torch.Tensor:
    """Gather every slot's page span, fp32 logits and softmax, probs cast to
    q.dtype before P·V."""
    s, n_kv, n_rep, hd = q.shape
    page = k_pages.shape[1]
    span = page_table.shape[1] * page
    idx = page_table.long()
    k_att = k_pages[idx].reshape(s, span, n_kv, hd)
    v_att = v_pages[idx].reshape(s, span, n_kv, hd)
    logits = torch.einsum("snrd,sknd->snrk", q.float(), k_att.float()) / math.sqrt(hd)
    kv_pos = torch.arange(span, device=q.device)
    visible = kv_pos[None, :] <= seq_lens.long()[:, None]  # [S, K]
    logits = logits.masked_fill(~visible[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("snrk,sknd->snrd", probs, v_att)


def _check_cuda(q, k_pages, v_pages, page_table, seq_lens) -> None:
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "page_table": page_table, "seq_lens": seq_lens}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous")
    for name in ("q", "k_pages", "v_pages"):
        if tensors[name].dtype != torch.bfloat16:
            raise TypeError(f"paged_decode_attention: {name} must be bfloat16, got {tensors[name].dtype}")
    for name in ("page_table", "seq_lens"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"paged_decode_attention: {name} must be int32, got {tensors[name].dtype}")
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("paged_decode_attention: q is [S, n_kv, n_rep, hd], pages [P, page, n_kv, hd]")
    s, n_kv, n_rep, hd = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[2:] != (n_kv, hd):
        raise ValueError(
            f"paged_decode_attention: pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
            f"do not match q {tuple(q.shape)}"
        )
    if page_table.dim() != 2 or page_table.shape[0] != s or tuple(seq_lens.shape) != (s,):
        raise ValueError("paged_decode_attention: page_table [S, pps] and seq_lens [S] must match q's S")
    if hd not in _SUPPORTED_HD or n_rep not in _SUPPORTED_NREP:
        raise ValueError(
            f"paged_decode_attention: kernel built for hd in {_SUPPORTED_HD}, "
            f"n_rep in {_SUPPORTED_NREP}; got hd={hd}, n_rep={n_rep}"
        )


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]

# (device, S, n_kv, n_rep, hd, n_split) -> (stream, partials, counters)
_WORKSPACES: dict[tuple, tuple[int, torch.Tensor, torch.Tensor]] = {}
_graph = threading.local()  # .store: the workspace dict of the graph this thread captures


@contextlib.contextmanager
def graph_workspaces(store: dict):
    """Inside: this thread's calls take their workspaces from `store`, which
    the caller keeps for one CUDA graph (its warm-up and its capture), not
    from the per-stream ones. The graph's replays then use its own partials
    and counters, which each launch, captured or not, leaves at zero."""
    prev = getattr(_graph, "store", None)
    _graph.store = store
    try:
        yield store
    finally:
        _graph.store = prev


def _decode_workspace(device: torch.device, key: tuple, stream: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's fp32 chunk partials [S, n_kv, n_split, n_rep·(hd + 2)]
    and its int32 counters [S, n_kv], zeroed once: made at the first call
    for (device, shapes) and reused by every later one. Each launch leaves
    the counters at zero, so calls on one stream may share them; calls on
    two streams could interleave, so the workspace is bound to the stream of
    its first call and a call from another stream raises. Inside
    `graph_workspaces(store)` the graph's store is used instead; a capture
    outside one raises."""
    s, n_kv, n_rep, hd, n_split = key
    full = (device, *key)
    store = getattr(_graph, "store", None)
    if store is None and device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("paged_decode_attention captured into a CUDA graph outside graph_workspaces()")
    workspaces = _WORKSPACES if store is None else store
    if full not in workspaces:
        workspaces[full] = (
            stream,
            torch.empty((s, n_kv, n_split, n_rep * (hd + 2)), dtype=torch.float32, device=device),
            torch.zeros((s, n_kv), dtype=torch.int32, device=device),
        )
    bound, partials, counters = workspaces[full]
    if store is None and bound != stream:
        raise RuntimeError(
            f"paged_decode_attention: the workspace for {key} on {device} is bound to stream "
            f"{bound:#x}; this call comes from stream {stream:#x}"
        )
    return partials, counters


def paged_decode_attention(
    q: torch.Tensor,  # [S, n_kv, n_rep, hd]
    k_pages: torch.Tensor,  # [P, page, n_kv, hd]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [S, pages_per_slot] int32
    seq_lens: torch.Tensor,  # [S] int32 — each slot's decode position
) -> torch.Tensor:
    """One decode step's attention over paged KV. Returns [S, n_kv, n_rep, hd].

    On CUDA the kernel's workspace (chunk partials and counters, one per
    device and shapes) is tied to the stream of its first call: a later call
    with the same shapes from another stream raises instead of racing."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table, seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    _check_cuda(q, k_pages, v_pages, page_table, seq_lens)
    s, n_kv, n_rep, hd = q.shape
    page, pps = k_pages.shape[1], page_table.shape[1]
    n_split = decode_splits(page, pps)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    partials, counters = _decode_workspace(q.device, (s, n_kv, n_rep, hd, n_split), stream)
    out = torch.empty_like(q)
    fn = _build.entry(KERNEL, "paged_decode_bf16", _ARGTYPES)
    err = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), partials.data_ptr(), counters.data_ptr(),
        s, n_kv, n_rep, hd, page, pps, DECODE_CHUNK, n_split, 1.0 / math.sqrt(hd), stream,
    )
    _build.check(KERNEL, err)
    return out
