"""Paged (block) KV cache: fixed-size pages shared by every slot through a
page table, plus the host-side block allocator and the content-keyed prefix
cache (port of modal_tpu/models/paged_kv.py).

- pages: `[n_layers, num_pages, page_size, n_kv, hd]` K and V tensors, the
  whole serving tier's KV memory, allocated once at engine start;
- page table: `[slots, pages_per_slot]` int32 — slot s's position p lives in
  page `page_table[s, p // page_size]` at offset `p % page_size`;
- page 0 is the scratch page: inactive slots and padded prefill rows write
  there, and nothing ever attends it.

The JAX package donates the cache to each jitted step and gets a new one
back. This port updates the cache's tensors IN PLACE (pages, table, lengths)
and returns the same object, so call sites read the same way.

Decode attention is either the hand-written CUDA page-streaming kernel
(`ops/paged_attention.py`, attn_impl "kernel") or the gather path, which
materialises every slot's page span and runs the einsum reference (attn_impl
"gather"). Multi-token calls (prefill, speculative verify) always take the
gather path, as in the JAX package.

`export_pages` / `import_pages` move whole pages between pools (a
prefill-role engine ships a prompt's KV to a decode-role engine).

`DecodeGraph` captures `paged_decode_step` over one persistent cache as a
CUDA graph: one launch per step, where the JAX package dispatches the step
as one compiled executable. Its addresses are fixed at capture, which is
why every helper here updates the cache's tensors in place and none
rebinds them.
"""

from __future__ import annotations

import gc
import math
import os
import time
import weakref
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve_device
from .llama import LlamaConfig, apply_rope, layer_params, repeat_kv, rms_norm, rope_frequencies
from .quant import qembed, qmm

DEFAULT_PAGE_SIZE = 16


class PagePoolExhausted(Exception):
    """The shared page pool has no free pages (caller preempts or queues)."""


class PageAllocator:
    """Host-side free-list block allocator over the page pool, with
    per-page refcounts for shared-prefix reuse.

    Pages are interchangeable (the page table adds the indirection), so
    `can_alloc(n)` ⇔ `len(free) >= n` whatever the alloc/free history. Page 0
    is the scratch page and never handed out. A page with refcount > 1 is
    copy-on-write for whoever wants to mutate it (`shared()`)."""

    def __init__(self, num_pages: int, page_size: int = DEFAULT_PAGE_SIZE):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the reserved scratch page)")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: list[int] = list(range(num_pages - 1, 0, -1))  # pop() yields 1, 2, ...
        self._refs: dict[int, int] = {}  # page -> live holder count
        self.high_water = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def pages_for(self, num_tokens: int) -> int:
        return max(1, math.ceil(num_tokens / self.page_size))

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} pages, {len(self._free)} free (pool {self.num_pages - 1})"
            )
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.high_water = max(self.high_water, self.allocated_pages)
        return pages

    def share(self, pages: list[int]) -> None:
        """Add one holder to each page."""
        for p in pages:
            if self._refs.get(p, 0) <= 0:
                raise ValueError(f"share of unallocated page {p}")
            self._refs[p] += 1

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def shared(self, page: int) -> bool:
        """More than one holder: any write must copy first (the CoW barrier)."""
        return self._refs.get(page, 0) > 1

    def free(self, pages: list[int]) -> None:
        """Drop one holder per page; a page returns to the free list at
        refcount zero. Over-freeing raises (the refcount is the detector)."""
        if len(set(pages)) != len(pages):
            raise ValueError(f"double free within one batch: {pages}")
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"page {p} out of range")
            if self._refs.get(p, 0) <= 0:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)


class PagedKVCache:
    """Device state of the shared pool (one per engine, not per request).
    Every method and helper below mutates these tensors in place."""

    def __init__(self, k_pages, v_pages, page_table, seq_lens):
        self.k_pages = k_pages  # [n_layers, num_pages, page_size, n_kv, hd]
        self.v_pages = v_pages
        self.page_table = page_table  # [slots, pages_per_slot] int32 (0 = scratch)
        self.seq_lens = seq_lens  # [slots] int32 — tokens written per slot

    @staticmethod
    def create(
        cfg: LlamaConfig,
        slots: int,
        num_pages: int,
        page_size: int = DEFAULT_PAGE_SIZE,
        pages_per_slot: Optional[int] = None,
        device=None,
    ) -> "PagedKVCache":
        dev = resolve_device(device)
        pages_per_slot = pages_per_slot or math.ceil(cfg.max_seq_len / page_size)
        shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
        return PagedKVCache(
            k_pages=torch.zeros(shape, dtype=cfg.dtype, device=dev),
            v_pages=torch.zeros(shape, dtype=cfg.dtype, device=dev),
            page_table=torch.zeros((slots, pages_per_slot), dtype=torch.int32, device=dev),
            seq_lens=torch.zeros((slots,), dtype=torch.int32, device=dev),
        )

    @property
    def device(self) -> torch.device:
        return self.k_pages.device

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def num_slots(self) -> int:
        return self.page_table.shape[0]

    @property
    def kv_span(self) -> int:
        """Max attended positions per slot (pages_per_slot × page_size)."""
        return self.page_table.shape[1] * self.page_size

    def pool_bytes(self) -> int:
        return (self.k_pages.numel() + self.v_pages.numel()) * self.k_pages.element_size()


# -- host-directed table maintenance (in place) -------------------------------


def _ids(values, device) -> torch.Tensor:
    return torch.as_tensor(values, dtype=torch.int32).to(device)


def assign_pages(cache: PagedKVCache, slot: int, start_index: int, pages) -> PagedKVCache:
    """Write page ids into the slot's table row at [start_index, +len(pages))."""
    ids = _ids(pages, cache.device)
    cache.page_table[slot, start_index : start_index + ids.numel()] = ids
    return cache


def release_slot(cache: PagedKVCache, slot: int) -> PagedKVCache:
    """Point the slot back at scratch and zero its length (the host frees
    the pages on the allocator side)."""
    cache.page_table[slot] = 0
    cache.seq_lens[slot] = 0
    return cache


def copy_page(cache: PagedKVCache, slot: int, table_index: int, dst_page: int) -> PagedKVCache:
    """Copy-on-write: duplicate the page the slot's table points at (all
    layers' K and V rows) into `dst_page` and repoint the table. The source
    page, still held by the prefix cache or other slots, is never mutated."""
    src = cache.page_table[slot, table_index].long()
    cache.k_pages[:, dst_page] = cache.k_pages.index_select(1, src.reshape(1))[:, 0]
    cache.v_pages[:, dst_page] = cache.v_pages.index_select(1, src.reshape(1))[:, 0]
    cache.page_table[slot, table_index] = dst_page
    return cache


def set_seq_lens(cache: PagedKVCache, new_lens, update) -> PagedKVCache:
    """Host-directed per-slot length update (masked by `update`)."""
    new = torch.as_tensor(new_lens, dtype=torch.int32).to(cache.device)
    upd = torch.as_tensor(update, dtype=torch.bool).to(cache.device)
    cache.seq_lens.copy_(torch.where(upd, new, cache.seq_lens))
    return cache


# -- KV-page shipment (prefill/decode disaggregation) --------------------------


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t`. A CUDA tensor lands in pinned memory from
    PyTorch's caching host allocator: one DMA at the card's copy rate, and
    a block freed by an earlier shipment is reused, so a steady stream of
    exports neither allocates pinned memory nor first-touches fresh
    pageable pages (what a plain `.cpu()` pays for)."""
    if t.device.type != "cuda":
        return t.cpu()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return out


def export_pages(cache: PagedKVCache, page_ids: list[int]) -> dict:
    """The named pages as CPU tensors {"k", "v"}, each [n_layers,
    len(page_ids), page_size, n_kv, hd] in the pool dtype, copied off a
    card into pinned memory (`_to_host`). Whole pages travel: positions
    past the holder's length are garbage that stays unattended on the
    importer too. Read-only, so exporting pages shared with the prefix
    cache is safe."""
    idx = _ids(page_ids, cache.device).long()
    return {
        "k": _to_host(cache.k_pages.index_select(1, idx)),
        "v": _to_host(cache.v_pages.index_select(1, idx)),
    }


def import_pages(cache: PagedKVCache, page_ids: list[int], data: dict) -> PagedKVCache:
    """Write a shipped page bundle (`export_pages`' dict; k/v as tensors or
    numpy arrays) into the named local pages, cast to the pool dtype. The
    caller owns the allocation and the page-table wiring."""
    idx = _ids(page_ids, cache.device).long()
    for name, pages in (("k", cache.k_pages), ("v", cache.v_pages)):
        src = data[name]
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.array(src))  # a writable copy: torch shares the buffer
        pages.index_copy_(1, idx, src.to(device=cache.device, dtype=pages.dtype))
    return cache


# -- paged forward internals --------------------------------------------------


def _scatter_kv(k_pages, v_pages, k, v, page_ids, offsets) -> None:
    """Write per-position K/V rows into their pages, in place.
    k_pages/v_pages: [P, page, n_kv, hd] (one layer's view of the pool);
    k/v: [T, n_kv, hd]; page_ids/offsets: [T] long.

    Inactive slots and padded prefill rows all target scratch (page 0,
    offset 0). With duplicate indices `index_put_` keeps an arbitrary one of
    the rows; that is harmless because page 0 is never attended."""
    k_pages.index_put_((page_ids, offsets), k)
    v_pages.index_put_((page_ids, offsets), v)


def _paged_attention(q, k_pages, v_pages, page_table, mask, positions=None, attn_impl="gather"):
    """Attend each slot's page span. q: [S, Sq, H, hd]; k_pages/v_pages:
    [P, page, n_kv, hd]; page_table: [S, pages_per_slot] int32; mask:
    [S, 1, Sq, K] additive (None on the kernel path). Returns [S, Sq, H, hd].

    "kernel" streams pages through `paged_decode_attention` (decode only:
    Sq == 1, `positions` = each slot's token position); multi-token calls
    always take the gather path."""
    s, sq, h, hd = q.shape
    n_kv = k_pages.shape[2]
    n_rep = h // n_kv
    if attn_impl == "kernel" and sq == 1 and positions is not None:
        from ..ops.paged_attention import paged_decode_attention

        out = paged_decode_attention(
            q.reshape(s, n_kv, n_rep, hd),  # repeat_kv order: head = kv*n_rep + rep
            k_pages, v_pages, page_table, positions,
        )
        return out.reshape(s, sq, h, hd)
    page = k_pages.shape[1]
    k_span = page_table.shape[1] * page
    idx = page_table.long()
    k_att = repeat_kv(k_pages[idx].reshape(s, k_span, n_kv, hd), n_rep)
    v_att = repeat_kv(v_pages[idx].reshape(s, k_span, n_kv, hd), n_rep)
    logits = torch.einsum("sqhd,skhd->shqk", q.float(), k_att.float()) * (1.0 / math.sqrt(hd))
    probs = torch.softmax(logits + mask, dim=-1).to(q.dtype)
    return torch.einsum("shqk,skhd->sqhd", probs, v_att)


def _paged_layer(cfg, x, layer, positions, write_page_ids, write_offsets, mask, inv_freq,
                 page_table, kp, vp, attn_impl="gather"):
    """One transformer layer over paged KV. x: [S, Sq, D]; positions:
    [S, Sq]; write_page_ids/offsets: flat [S*Sq]. The scatter comes BEFORE
    attention: the decode kernel attends the position it just wrote."""
    s, sq, _d = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = qmm(h, layer["wq"]).reshape(s, sq, cfg.n_heads, hd)
    k = qmm(h, layer["wk"]).reshape(s, sq, cfg.n_kv_heads, hd)
    v = qmm(h, layer["wv"]).reshape(s, sq, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    _scatter_kv(
        kp, vp,
        k.reshape(s * sq, cfg.n_kv_heads, hd), v.reshape(s * sq, cfg.n_kv_heads, hd),
        write_page_ids, write_offsets,
    )
    attn_out = _paged_attention(
        q, kp, vp, page_table, mask, positions=positions[:, 0].contiguous(), attn_impl=attn_impl
    )
    x = x + qmm(attn_out.reshape(s, sq, cfg.n_heads * hd), layer["wo"])
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    gated = F.silu(qmm(h, layer["w_gate"]).float()).to(x.dtype) * qmm(h, layer["w_up"])
    return x + qmm(gated, layer["w_down"])


def _run_layers(params, cfg, x, positions, write_page_ids, write_offsets, mask, page_table,
                cache, attn_impl="gather"):
    inv_freq = rope_frequencies(cfg, x.device)
    for i in range(cfg.n_layers):
        x = _paged_layer(
            cfg, x, layer_params(params["layers"], i), positions, write_page_ids,
            write_offsets, mask, inv_freq, page_table, cache.k_pages[i], cache.v_pages[i],
            attn_impl,
        )
    return x


def _logits(params, cfg, x_last):
    x_last = rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    return qmm(x_last, params["lm_head"]).float()


def _span_mask(kv_span: int, q_pos: torch.Tensor) -> torch.Tensor:
    """Additive fp32 mask [..., K]: kv_pos <= q_pos visible, else -inf."""
    kv_pos = torch.arange(kv_span, dtype=torch.int32, device=q_pos.device)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(kv_pos <= q_pos[..., None], zero, float("-inf"))


# -- public entry points ------------------------------------------------------


@torch.no_grad()
def paged_prefill(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [S_pad] int — one slot's prompt chunk, padded
    length: int,  # real token count (<= S_pad)
    cache: PagedKVCache,
    slot: int,
    start_pos: int,  # tokens already in the slot (chunked prefill)
):
    """Prefill one slot's prompt chunk into its pages in place; other slots'
    pages stay untouched. Padded positions (>= length) scatter to the scratch
    page and are never attended. Returns (last_logits [V] fp32, next_token
    [] int, cache)."""
    (s_pad,) = tokens.shape
    dev = cache.device
    page = cache.page_size
    idx = torch.arange(s_pad, dtype=torch.int64, device=dev)
    valid = idx < length
    positions = start_pos + idx  # [S_pad]
    row = cache.page_table[slot].long()  # [pages_per_slot]
    page_of = row[torch.clamp(positions // page, 0, row.shape[0] - 1)]
    write_page_ids = torch.where(valid, page_of, 0)
    write_offsets = torch.where(valid, positions % page, 0)

    x = qembed(params["embed"], tokens.to(dev).long()[None, :])  # [1, S_pad, D]
    mask = _span_mask(cache.kv_span, positions)[None, None]  # [1, 1, S_pad, K]
    x = _run_layers(
        params, cfg, x, positions[None, :], write_page_ids, write_offsets, mask,
        cache.page_table[slot : slot + 1], cache,
    )
    logits = _logits(params, cfg, x[0, length - 1])
    cache.seq_lens[slot] = start_pos + length
    return logits, logits.argmax(), cache


@torch.no_grad()
def paged_decode_step(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [slots] int — current token per slot
    cache: PagedKVCache,
    active: torch.Tensor,  # [slots] bool
    attn_impl: str = "gather",
):
    """One continuous-batching decode step over every slot (inactive slots
    compute on garbage routed to the scratch page). Writes the new K/V in
    place and advances active slots' lengths. Returns (logits [slots, V]
    fp32, next_tokens [slots], cache)."""
    dev = cache.device
    page = cache.page_size
    active = active.to(dev)
    positions = cache.seq_lens.clone()  # [slots] int32 — the new token's position
    pos = positions.long()
    rows = cache.page_table.long()
    page_idx = torch.clamp(pos // page, 0, rows.shape[1] - 1)
    write_page_ids = torch.where(active, rows.gather(1, page_idx[:, None])[:, 0], 0)
    write_offsets = torch.where(active, pos % page, 0)

    x = qembed(params["embed"], tokens.to(dev).long()[:, None])  # [slots, 1, D]
    mask = None if attn_impl == "kernel" else _span_mask(cache.kv_span, pos)[:, None, None, :]
    x = _run_layers(
        params, cfg, x, positions[:, None], write_page_ids, write_offsets, mask,
        cache.page_table, cache, attn_impl,
    )
    logits = _logits(params, cfg, x[:, 0, :])
    cache.seq_lens.add_(active.to(torch.int32))
    return logits, logits.argmax(dim=-1), cache


# Capture streams that no live DecodeGraph holds, per device. cuBLAS keeps a
# workspace (32 MiB on Hopper) for every stream it ran on, for the life of
# the process, and a captured GEMM bakes in its capture stream's: a stream
# is lent to one graph at a time (so no warm-up runs beside a live graph's
# replays on the same workspace) and reused once that graph is gone, which
# bounds the workspaces by the graphs alive at once.
_FREE_CAPTURE_STREAMS: dict[torch.device, list] = {}


class DecodeGraph:
    """`paged_decode_step` over `cache`, captured once as a CUDA graph and
    replayed per step: `graph(tokens, active)` copies the step's inputs
    (device tensors) into the static `tokens` and `active` buffers, replays,
    and returns the static `(logits, next_tokens)`, which the next replay
    overwrites (read or copy them first).

    The graph reads the params and the cache's pages, page table and
    lengths at the addresses they had at capture: the cache must only ever
    be updated in place. Warm-up and capture run with every slot inactive,
    so their writes land on the scratch page and no length moves; the
    warm-up runs eagerly on the capture stream (PyTorch's rule for cuBLAS
    workspaces) and builds the kernels. K4 takes the graph's own workspace
    (`graph_workspaces`), never a stream's, and the launches recorded at
    capture are counted per replay (`_build.CountedGraph`). A failed capture
    raises. `pool_bytes` is what the graph's private memory pool reserved,
    `capture_s` the warm-up and capture time. The capture stream is the
    graph's own while it lives (`_FREE_CAPTURE_STREAMS`); replays run on
    the caller's stream, the default stream for every engine.

    Nothing flash-based (K1-K3) is captured here. A captured train step
    would need their one-time `cudaFuncSetAttribute` done by an eager call
    first, and would bake in the TMA descriptors each call encodes on the
    host with that call's tensor addresses (csrc/hopper.cuh)."""

    WARMUP = 3

    def __init__(self, params: dict, cfg: LlamaConfig, cache: PagedKVCache, attn_impl: str = "kernel"):
        from ..ops import _build
        from ..ops.paged_attention import graph_workspaces

        dev = cache.device
        if dev.type != "cuda":
            raise ValueError(f"DecodeGraph captures on a CUDA device; the cache lives on {dev}")
        t0 = time.perf_counter()
        self.tokens = torch.zeros((cache.num_slots,), dtype=torch.int64, device=dev)
        self.active = torch.zeros((cache.num_slots,), dtype=torch.bool, device=dev)
        self.workspaces: dict = {}

        def step():
            logits, next_tokens, _cache = paged_decode_step(params, cfg, self.tokens, cache, self.active, attn_impl)
            return logits, next_tokens

        free = _FREE_CAPTURE_STREAMS.setdefault(dev, [])
        stream = free.pop() if free else torch.cuda.Stream(dev)
        weakref.finalize(self, free.append, stream)
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with graph_workspaces(self.workspaces):
            with torch.cuda.stream(stream):
                for _ in range(self.WARMUP):
                    step()
            torch.cuda.synchronize(dev)
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            with _build.recording_launches() as launches:
                with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                    self.logits, self.next_tokens = step()
        torch.cuda.synchronize(dev)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph = _build.CountedGraph(graph, launches)
        self.capture_s = time.perf_counter() - t0
        _build.report_compile("graph_capture", self.capture_s)

    def __call__(self, tokens: torch.Tensor, active: torch.Tensor):
        self.tokens.copy_(tokens, non_blocking=True)
        self.active.copy_(active, non_blocking=True)
        self.graph.replay()
        return self.logits, self.next_tokens


@torch.no_grad()
def paged_verify_step(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [slots, K1] int — [cur, draft_1..draft_k] per slot
    cache: PagedKVCache,
    active: torch.Tensor,  # [slots] bool
):
    """Speculative-decoding verify: K1 = k+1 tokens per slot through the
    model in one step, their KV written at `seq_lens + [0..k]`. Returns
    (logits [slots, K1, V] fp32, cache); logits[s, j] is the distribution of
    the token after tokens[s, j].

    seq_lens does NOT advance: acceptance is the host's decision, which
    rolls the lengths with `set_seq_lens`; rejected positions stay behind as
    unattended garbage. The engine keeps every write inside the page table
    by reserving spec_k positions of context at submit."""
    dev = cache.device
    page = cache.page_size
    _slots, k1 = tokens.shape
    active = active.to(dev)
    rows = cache.page_table.long()
    positions = cache.seq_lens[:, None] + torch.arange(k1, dtype=torch.int32, device=dev)[None, :]
    pos = positions.long()
    page_idx = torch.clamp(pos // page, 0, rows.shape[1] - 1)
    write_page_ids = torch.where(active[:, None], rows.gather(1, page_idx), 0)
    write_offsets = torch.where(active[:, None], pos % page, 0)

    x = qembed(params["embed"], tokens.to(dev).long())  # [slots, K1, D]
    mask = _span_mask(cache.kv_span, pos)[:, None]  # [S, 1, K1, K]
    x = _run_layers(
        params, cfg, x, positions, write_page_ids.reshape(-1), write_offsets.reshape(-1), mask,
        cache.page_table, cache,
    )
    return _logits(params, cfg, x), cache


# -- shared-prefix KV reuse ---------------------------------------------------


class PrefixCacheEntry:
    """One cached prefix: the exact token prefix and the pages holding its
    KV. The entry is a page holder, so its pages outlive the inserter."""

    __slots__ = ("tokens", "pages", "last_used", "hits")

    def __init__(self, tokens: tuple, pages: list[int]):
        self.tokens = tokens
        self.pages = pages
        self.last_used = 0.0
        self.hits = 0


class PrefixCache:
    """Content-keyed prefix → KV-pages lookup over the shared pool.

    An entry for prompt T is indexed under every full-page prefix
    `T[:j*page]`, so a follower finds the longest full-page match in
    O(pages) probes; a hit can extend token-granular into the entry's next
    page, which is then refcount-shared and copied on the follower's first
    write into it (`copy_page`). `lookup` refs pages for the caller,
    `insert` refs them for the entry, `evict_lru`/`clear` un-ref."""

    def __init__(self, allocator: PageAllocator):
        self.allocator = allocator
        self.page_size = allocator.page_size
        self._entries: dict[tuple, PrefixCacheEntry] = {}  # full-token key -> entry
        self._index: dict[tuple, PrefixCacheEntry] = {}  # page-granular prefix -> entry
        self._clock = 0.0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def held_pages(self) -> int:
        return sum(len(e.pages) for e in self._entries.values())

    def _tick(self) -> float:
        self._clock += 1.0
        return self._clock

    def lookup(
        self, tokens: list, allow_partial: bool = True
    ) -> Optional[tuple[list[int], int, PrefixCacheEntry]]:
        """Longest cached prefix of `tokens` covering at most len(tokens)-1
        positions (the suffix must still prefill to produce last-token
        logits). Returns (pages, covered_tokens, entry) with one holder ref
        taken on every returned page, or None. Hit/miss counters and the LRU
        clock move at `commit_use`/`note_miss`, not here."""
        page = self.page_size
        max_cover = len(tokens) - 1
        for j in range(max_cover // page, 0, -1):
            entry = self._index.get(tuple(tokens[: j * page]))
            if entry is None:
                continue
            covered = j * page
            pages = list(entry.pages[:j])
            if allow_partial and len(entry.tokens) > covered and len(entry.pages) > j:
                limit = min(page, len(entry.tokens) - covered, max_cover - covered)
                extra = 0
                while extra < limit and entry.tokens[covered + extra] == tokens[covered + extra]:
                    extra += 1
                if extra > 0:
                    pages.append(entry.pages[j])
                    covered += extra
            self.allocator.share(pages)
            return pages, covered, entry
        return None

    def commit_use(self, entry: PrefixCacheEntry) -> None:
        entry.last_used = self._tick()
        entry.hits += 1
        self.hits += 1

    def note_miss(self) -> None:
        self.misses += 1

    def insert(self, tokens: list, pages: list[int], full_pages_only: bool = False) -> bool:
        """Cache `tokens`' prefix KV (the entry refs the covering pages).
        Needs at least one full page. Returns True if a new entry was made."""
        page = self.page_size
        full = len(tokens) // page
        if full < 1:
            return False
        if full_pages_only:
            tokens = list(tokens[: full * page])
        key = tuple(tokens)
        if key in self._entries:
            return False
        n_pages = math.ceil(len(tokens) / page)
        if n_pages > len(pages):
            return False
        entry = PrefixCacheEntry(key, list(pages[:n_pages]))
        self.allocator.share(entry.pages)
        entry.last_used = self._tick()
        self._entries[key] = entry
        for j in range(1, full + 1):
            # first inserter wins a contested page-prefix key
            self._index.setdefault(tuple(tokens[: j * page]), entry)
        return True

    def _drop(self, entry: PrefixCacheEntry) -> None:
        self._entries.pop(entry.tokens, None)
        for k in [k for k, e in self._index.items() if e is entry]:
            del self._index[k]
        self.allocator.free(entry.pages)

    def evict_lru(self) -> int:
        """Evict the least-recently-used entry; returns how many pages this
        actually released (pages still held by live slots stay allocated)."""
        if not self._entries:
            return 0
        entry = min(self._entries.values(), key=lambda e: e.last_used)
        released = sum(1 for p in entry.pages if self.allocator.refcount(p) == 1)
        self._drop(entry)
        return released

    def clear(self) -> None:
        for entry in list(self._entries.values()):
            self._drop(entry)


# -- decode attention selection -----------------------------------------------

PAGED_KERNEL_ENV = "MODAL_TPU_PAGED_KERNEL"


def resolve_attn_impl(device) -> str:
    """Map the env knob to `paged_decode_step`'s attn_impl:

    - auto (default): "kernel" on CUDA, "gather" on the CPU;
    - 1/on/kernel: "kernel" (on the CPU the wrapper runs its plain version);
    - 0/off/gather: the gather path, an explicit choice, never a fallback."""
    val = os.environ.get(PAGED_KERNEL_ENV, "auto").strip().lower()
    if val in ("0", "off", "false", "no", "gather"):
        return "gather"
    if val in ("1", "on", "true", "yes", "kernel"):
        return "kernel"
    return "kernel" if torch.device(device).type == "cuda" else "gather"


# prompt-length buckets: chunks pad up to one of these (the JAX package
# keys one executable on each; here it keeps the two implementations'
# padded shapes identical)
PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def prefill_bucket(n: int, max_len: int) -> int:
    for b in PREFILL_BUCKETS:
        if b >= n and b <= max_len:
            return b
    return max_len
