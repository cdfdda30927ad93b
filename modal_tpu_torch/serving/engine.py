"""Continuous-batching decode loop over the paged KV pool (port of the core
loop of modal_tpu/serving/engine.py).

- slots: the decode batch has `max_slots` fixed rows; a request joins a free
  slot the moment one (plus KV pages) is available, mid-decode, without
  restarting in-flight sequences;
- prompts prefill in `prefill_chunk`-token slices, one slice per loop
  iteration, interleaved with decode steps;
- all slots share one page pool (models/paged_kv.py); when it runs dry the
  prefix cache is evicted first, then the youngest request is preempted
  (pages freed, request requeued with its generated prefix: tokens already
  streamed are never re-emitted);
- shared-prefix reuse with copy-on-write pages is on by default;
- generated tokens append to a per-request buffer that stream consumers read
  with a cursor, so a dropped stream re-reads without loss or duplication.

The loop runs on its own thread and does its device work on the device's
default stream; it reads results back to the host through `.cpu()`, once
per prefill chunk and once per decode step. Speculative decoding (`draft=`)
and the prefill/decode roles with KV shipping belong to a later slice of the
port and raise `NotImplementedError`.
"""

from __future__ import annotations

import itertools
import math
import os
import socket
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..config import logger, resolve_device
from ..models.llama import params_device
from ..models.paged_kv import (
    DEFAULT_PAGE_SIZE,
    PageAllocator,
    PagedKVCache,
    PagePoolExhausted,
    PrefixCache,
    assign_pages,
    copy_page,
    paged_decode_step,
    paged_prefill,
    prefill_bucket,
    release_slot,
    resolve_attn_impl,
)
from ..models.sampling import sample_step
from ..observability import tracing
from ..observability.catalog import (
    KV_PAGES_ALLOCATED,
    KV_PAGES_COW,
    KV_PAGES_FREE,
    SERVING_BATCH_OCCUPANCY,
    SERVING_PREEMPTIONS,
    SERVING_PREFIX_HITS,
    SERVING_PREFIX_MISSES,
    SERVING_QUEUE_DEPTH,
    SERVING_REQUESTS,
    SERVING_SAMPLED_TOKENS,
    SERVING_TOKENS,
    SERVING_TOKENS_PER_S,
    SERVING_TTFT,
    SERVING_TTFT_P95,
)

_req_counter = itertools.count()

# per-request timeline spans; MODAL_TPU_SERVING_SPANS=0 turns them off
SPANS_ENV = "MODAL_TPU_SERVING_SPANS"
SPAN_TOKENS_ENV = "MODAL_TPU_SERVING_SPAN_TOKENS"
SAMPLING_ENV = "MODAL_TPU_SERVING_SAMPLING"  # 0 → greedy-only engine
PREFIX_CACHE_ENV = "MODAL_TPU_SERVING_PREFIX_CACHE"  # 0 → no shared-prefix reuse
# (the decode-attention knob MODAL_TPU_PAGED_KERNEL lives in models/paged_kv.py)


def replica_id() -> str:
    """Request-id prefix: the task id under the stack, else host-pid."""
    return os.environ.get("MODAL_TPU_TASK_ID") or f"{socket.gethostname()}-{os.getpid()}"


def _env_on(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default).strip().lower() not in ("0", "false", "no", "off")


def _spans_enabled() -> bool:
    return _env_on(SPANS_ENV)


def _span_mark_tokens() -> int:
    try:
        return max(1, int(os.environ.get(SPAN_TOKENS_ENV, "8")))
    except ValueError:
        return 8


class EngineStopped(RuntimeError):
    pass


class GenRequest:
    """One generation request: prompt in, token stream out. `tokens` is the
    buffered, exactly-once source of truth that consumers read by cursor."""

    def __init__(
        self,
        prompt: list[int],
        max_new_tokens: int,
        request_id: str = "",
        eos_token_id: Optional[int] = None,
        trace_context: Optional[Any] = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
    ):
        self.id = request_id or f"gr-{replica_id()}-{next(_req_counter)}"
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.trace_context = trace_context
        # temperature 0 = greedy; token #i of a sampled stream is drawn from
        # a generator seeded by (seed, i): reproducible under joins and
        # preemption (models/sampling.sample_step)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed) & 0x7FFFFFFF
        self.created_at = time.time()
        self.admitted_at = 0.0
        self.first_token_at = 0.0
        self.finished_at = 0.0
        self.preemptions = 0
        self.tokens: list[int] = []
        self.done = False
        self.error: Optional[str] = None
        self.root_span: Optional[Any] = None
        self.queue_from = self.created_at
        self._cond = threading.Condition()
        self._async_waiters: list[tuple[Any, Any]] = []  # (loop, asyncio.Event)

    # -- engine side --------------------------------------------------------

    def _append(self, token: int) -> None:
        with self._cond:
            if self.first_token_at == 0.0:
                self.first_token_at = time.time()
            self.tokens.append(token)
            self._wake()

    def _finish(self, error: Optional[str] = None) -> None:
        with self._cond:
            self.done = True
            self.error = error
            self.finished_at = time.time()
            self._wake()
        if self.root_span is not None:
            self.root_span.attrs.update(
                {
                    "request_id": self.id,
                    "tokens": len(self.tokens),
                    "preemptions": self.preemptions,
                    "ttft_s": round(self.ttft_s, 6) if self.ttft_s is not None else None,
                }
            )
            tracing.close_span(self.root_span, status="error" if error else "ok")
            self.root_span = None

    def _wake(self) -> None:
        self._cond.notify_all()
        for loop, event in self._async_waiters:
            try:
                loop.call_soon_threadsafe(event.set)
            except RuntimeError:
                pass  # consumer's loop is gone; the buffer still has the tokens
        self._async_waiters.clear()

    # -- consumer side ------------------------------------------------------

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at:
            return self.first_token_at - self.created_at
        return None

    def reached_end(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens or (
            self.eos_token_id is not None
            and bool(self.tokens)
            and self.tokens[-1] == self.eos_token_id
        )

    def wait_new(self, offset: int, timeout: Optional[float] = None) -> tuple[list[int], bool]:
        """Block until tokens beyond `offset` exist (or done/timeout)."""
        with self._cond:
            self._cond.wait_for(lambda: len(self.tokens) > offset or self.done, timeout)
            return list(self.tokens[offset:]), self.done

    async def wait_new_async(self, offset: int, timeout: Optional[float] = None) -> tuple[list[int], bool]:
        """Async twin of `wait_new` (the engine wakes the consumer's loop)."""
        import asyncio

        deadline = (time.monotonic() + timeout) if timeout is not None else None
        while True:
            with self._cond:
                if len(self.tokens) > offset or self.done:
                    return list(self.tokens[offset:]), self.done
                event = asyncio.Event()
                self._async_waiters.append((asyncio.get_running_loop(), event))
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return list(self.tokens[offset:]), self.done
            try:
                await asyncio.wait_for(event.wait(), remaining)
            except asyncio.TimeoutError:
                return list(self.tokens[offset:]), self.done

    def result(self, timeout: Optional[float] = None) -> list[int]:
        """Block until completion; returns the full generated token list."""
        with self._cond:
            if not self._cond.wait_for(lambda: self.done, timeout):
                raise TimeoutError(f"request {self.id} not done after {timeout}s")
        if self.error:
            raise EngineStopped(self.error)
        return list(self.tokens)


@dataclass
class _Slot:
    request: GenRequest
    pages: list[int] = field(default_factory=list)
    pos: int = 0  # tokens written to the slot's pages (mirrors seq_lens)
    prefill_tokens: list[int] = field(default_factory=list)  # prompt (+ regenerated prefix)
    prefill_done: int = 0  # tokens of prefill_tokens already written
    cur_token: int = 0  # token to feed the next decode step
    state: str = "prefill"  # "prefill" | "decode"
    admitted_step: int = 0
    last_mark_t: float = 0.0  # last serving.decode span's end
    tokens_at_mark: int = 0


class ServingEngine:
    """One shared paged-KV pool + one continuous decode loop. `device`
    defaults to CUDA (raising without a card); the params must live there."""

    def __init__(
        self,
        params: dict,
        cfg: Any,
        *,
        max_slots: int = 8,
        num_pages: Optional[int] = None,
        page_size: int = 16,
        pages_per_slot: Optional[int] = None,
        prefill_chunk: int = 128,
        max_waiting: int = 1024,
        draft: Optional[tuple] = None,
        prefix_cache: Optional[bool] = None,  # None = env default (on)
        role: Optional[str] = None,
        device=None,
    ):
        if draft is not None:
            raise NotImplementedError(
                "speculative decoding (draft=) is not ported to modal_tpu_torch yet (ROADMAP.md)"
            )
        if role not in (None, "both"):
            raise NotImplementedError(
                f"serving role {role!r}: prefill/decode roles and KV shipping are not "
                "ported to modal_tpu_torch yet (ROADMAP.md)"
            )
        if getattr(cfg, "is_moe", False):
            raise NotImplementedError("MoE configs are not paged-servable (dense FFN only)")
        self.device = resolve_device(device)
        if params_device(params) != self.device:
            raise ValueError(f"params live on {params_device(params)}, engine on {self.device}")
        page_size = page_size or DEFAULT_PAGE_SIZE
        pages_per_slot = pages_per_slot or math.ceil(cfg.max_seq_len / page_size)
        if num_pages is None:
            # default pool: half of what dense per-slot max_len caches would take
            num_pages = 1 + max(2 * max_slots, (max_slots * pages_per_slot) // 2)
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.prefill_chunk = prefill_chunk
        self.max_context = pages_per_slot * page_size
        self.max_waiting = max_waiting
        self.allocator = PageAllocator(num_pages, page_size)
        self.cache = PagedKVCache.create(
            cfg, max_slots, num_pages, page_size, pages_per_slot, device=self.device
        )
        self.attn_impl = resolve_attn_impl(self.device)  # "kernel" | "gather"
        self.sampling_enabled = _env_on(SAMPLING_ENV)
        want_prefix = _env_on(PREFIX_CACHE_ENV) if prefix_cache is None else bool(prefix_cache)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.allocator) if want_prefix else None
        )
        self.slots: list[Optional[_Slot]] = [None] * max_slots
        self.waiting: deque[GenRequest] = deque()
        self.requests: dict[str, GenRequest] = {}  # id -> request (bounded retention)
        self._retired: deque[str] = deque()
        self.step_count = 0
        self.tokens_generated = 0
        self.sampled_tokens = 0
        self.requests_completed = 0
        self.preemptions = 0
        self.cow_copies = 0
        self._ttft_window: deque[float] = deque(maxlen=100)
        self._rate_window: deque[tuple[float, int]] = deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ServingEngine":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, name="serving-engine", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        with self._work:
            self._stop = True
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        # fail anything still in flight — consumers must not hang
        with self._lock:
            leftovers = [s.request for s in self.slots if s is not None] + list(self.waiting)
            self.slots = [None] * self.max_slots
            self.waiting.clear()
            for req in leftovers:
                self._retired.append(req.id)
        for req in leftovers:
            req._finish(error="engine stopped")
            SERVING_REQUESTS.inc(outcome="stopped")
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
            self._sync_page_gauges()

    # -- submission ---------------------------------------------------------

    def submit(
        self,
        prompt: list[int],
        max_new_tokens: int = 64,
        *,
        request_id: str = "",
        eos_token_id: Optional[int] = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
    ) -> GenRequest:
        """Thread-safe admission into the running loop; returns immediately.
        temperature=0 is exact greedy; temperature>0 samples with optional
        top_k/top_p cuts, reproducible for a fixed seed."""
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        temperature = float(temperature)
        if temperature != temperature or temperature < 0 or temperature == float("inf"):
            raise ValueError(f"temperature must be finite and >= 0, got {temperature}")
        top_k = int(top_k)
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        top_p = float(top_p)
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if len(prompt) + max_new_tokens > self.max_context:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) exceeds the "
                f"engine's context limit ({self.max_context} = pages_per_slot × page_size)"
            )
        total_pages = self.allocator.num_pages - 1
        if self.allocator.pages_for(len(prompt) + max_new_tokens) > total_pages:
            raise ValueError(f"request needs more KV pages than the whole pool ({total_pages})")
        if not self.sampling_enabled:
            temperature = 0.0  # greedy-only engine (SAMPLING_ENV=0)
        req = GenRequest(
            prompt, max_new_tokens, request_id=request_id, eos_token_id=eos_token_id,
            trace_context=tracing.current_context(),
            temperature=temperature, top_k=top_k, top_p=top_p, seed=int(seed),
        )
        if _spans_enabled():
            req.root_span = tracing.open_span(
                "serving.request", attrs={"request_id": req.id, "prompt_tokens": len(prompt)}
            )
            req.trace_context = req.root_span.context
        with self._work:
            if self._stop:
                raise EngineStopped("engine stopped")
            if len(self.waiting) >= self.max_waiting:
                raise EngineStopped(f"admission queue full ({self.max_waiting})")
            self.waiting.append(req)
            self.requests[req.id] = req
            self._retire_requests()
            SERVING_QUEUE_DEPTH.set(float(len(self.waiting)))
            self._work.notify_all()
        return req

    def get(self, request_id: str) -> Optional[GenRequest]:
        with self._lock:
            return self.requests.get(request_id)

    def _retire_requests(self, keep: int = 512) -> None:
        while len(self.requests) > keep and self._retired:
            self.requests.pop(self._retired.popleft(), None)

    # -- the loop -----------------------------------------------------------

    def _run(self) -> None:
        logger.debug(
            f"serving engine up on {self.device}: slots={self.max_slots} "
            f"pages={self.allocator.num_pages - 1} page_size={self.page_size} "
            f"pool={self.cache.pool_bytes() / 1e6:.1f}MB attn={self.attn_impl}"
        )
        while True:
            with self._work:
                while not self._stop and not self.waiting and not any(self.slots):
                    self._work.wait(timeout=0.5)
                if self._stop:
                    return
            try:
                self.run_once()
            except Exception as exc:  # noqa: BLE001 — the loop must survive; requests fail loudly
                logger.exception(f"serving loop iteration failed: {exc}")
                self._fail_all(f"engine loop error: {type(exc).__name__}: {exc}")

    @torch.no_grad()
    def run_once(self) -> None:
        """One loop iteration: admit, advance one prefill chunk, one decode
        step. The thread calls it; a test may drive the engine with it."""
        self._admit()
        self._prefill_one()
        self._decode_step()

    def _fail_all(self, message: str) -> None:
        with self._lock:
            victims = [s for s in self.slots if s is not None]
            self.slots = [None] * self.max_slots
            for s in victims:
                self._retired.append(s.request.id)
        for s in victims:
            self.allocator.free(s.pages)
            s.request._finish(error=message)
            SERVING_REQUESTS.inc(outcome="error")
        self._sync_page_gauges()

    def _sync_page_gauges(self) -> None:
        KV_PAGES_ALLOCATED.set(float(self.allocator.allocated_pages))
        KV_PAGES_FREE.set(float(self.allocator.free_pages))

    def _evict_prefix_for(self, shortage: int) -> int:
        """Drop LRU prefix-cache entries until `shortage` pages came free (or
        the cache is empty); always tried before a preemption."""
        released = 0
        while released < shortage and self.prefix_cache is not None and len(self.prefix_cache):
            released += self.prefix_cache.evict_lru()
        if released:
            self._sync_page_gauges()
        return released

    def _admit(self) -> None:
        """Move waiting requests into free slots while pages allow (FIFO). A
        prefix-cache hit hands the slot refcounted pages holding an already
        prefilled prefix; only the suffix pays prefill."""
        while True:
            with self._lock:
                if not self.waiting:
                    return
                free_idx = next((i for i, s in enumerate(self.slots) if s is None), None)
                if free_idx is None:
                    return
                req = self.waiting[0]
                prefill_tokens = req.prompt + req.tokens  # preempted: regen prefix too
                need = self.allocator.pages_for(len(prefill_tokens) + 1)
                shared_pages: list[int] = []
                covered = 0
                hit_entry = None
                if self.prefix_cache is not None:
                    hit = self.prefix_cache.lookup(prefill_tokens)
                    if hit is not None:
                        shared_pages, covered, hit_entry = hit
                fresh_need = max(0, need - len(shared_pages))
                if not self.allocator.can_alloc(fresh_need):
                    self._evict_prefix_for(fresh_need - self.allocator.free_pages)
                if not self.allocator.can_alloc(fresh_need):
                    if shared_pages:
                        self.allocator.free(shared_pages)  # drop the lookup's refs
                    return  # pool dry; preemption or completions will free
                self.waiting.popleft()
                SERVING_QUEUE_DEPTH.set(float(len(self.waiting)))
                try:
                    pages = shared_pages + self.allocator.alloc(fresh_need)
                except PagePoolExhausted:  # pragma: no cover — guarded above
                    self.waiting.appendleft(req)
                    return
                slot = _Slot(
                    request=req,
                    pages=pages,
                    prefill_tokens=prefill_tokens,
                    prefill_done=covered,
                    pos=covered,
                    admitted_step=self.step_count,
                )
                self.slots[free_idx] = slot
                if self.prefix_cache is not None:
                    if hit_entry is not None and covered:
                        self.prefix_cache.commit_use(hit_entry)
                        SERVING_PREFIX_HITS.inc()
                    else:
                        self.prefix_cache.note_miss()
                        SERVING_PREFIX_MISSES.inc()
            assign_pages(self.cache, free_idx, 0, pages)
            req.admitted_at = time.time()
            self._sync_page_gauges()
            if req.trace_context is not None:
                tracing.record_span(
                    "serving.admit",
                    start=req.queue_from,
                    end=req.admitted_at,
                    parent=req.trace_context,
                    attrs={
                        "request_id": req.id,
                        "slot": free_idx,
                        "pages": len(pages),
                        "prefix_tokens": covered,
                        "requeue": req.preemptions > 0,
                    },
                )

    def _emit_first(self, idx: int, slot: _Slot, tok: int) -> None:
        """The slot's prefill-completion emission: first decode feed, TTFT."""
        req = slot.request
        slot.cur_token = tok
        slot.state = "decode"
        slot.last_mark_t = time.time()
        slot.tokens_at_mark = len(req.tokens) + 1  # the token appended below
        req._append(tok)
        if len(req.tokens) == 1:
            self._note_ttft(req)
        self.tokens_generated += 1
        self._note_rate(1)
        self._maybe_finish(idx, slot)

    def _cow_range(self, idx: int, slot: _Slot, start_pos: int, end_pos: int) -> bool:
        """Copy-on-write barrier: before any write to [start_pos, end_pos),
        every refcount-shared page in that range is copied into a private
        page and the shared original's ref dropped. Returns False if a copy
        needed a page the pool couldn't provide (caller preempts)."""
        page = self.page_size
        for t_idx in range(start_pos // page, (max(start_pos, end_pos - 1)) // page + 1):
            if t_idx >= len(slot.pages):
                break  # growth's job, not CoW's
            pid = slot.pages[t_idx]
            if not self.allocator.shared(pid):
                continue
            if not self.allocator.can_alloc(1):
                self._evict_prefix_for(1)
            if not self.allocator.can_alloc(1):
                return False
            new_page = self.allocator.alloc(1)[0]
            copy_page(self.cache, idx, t_idx, new_page)
            self.allocator.free([pid])  # drop this slot's ref; other holders keep it
            slot.pages[t_idx] = new_page
            self.cow_copies += 1
            KV_PAGES_COW.inc()
            self._sync_page_gauges()
        return True

    def _prefill_one(self) -> None:
        """Advance the oldest prefilling slot by one chunk."""
        with self._lock:
            candidates = [
                (i, s) for i, s in enumerate(self.slots) if s is not None and s.state == "prefill"
            ]
        if not candidates:
            return
        idx, slot = min(candidates, key=lambda t: t[1].admitted_step)
        req = slot.request
        total = len(slot.prefill_tokens)
        t0 = time.time()
        chunk = slot.prefill_tokens[slot.prefill_done : slot.prefill_done + self.prefill_chunk]
        if not self._cow_range(idx, slot, slot.prefill_done, slot.prefill_done + len(chunk)):
            # CoW starved for a page: the needy slot itself is a valid victim
            self._preempt_youngest()
            return
        bucket = prefill_bucket(len(chunk), self.max_context)
        padded = torch.zeros((bucket,), dtype=torch.int64)
        padded[: len(chunk)] = torch.as_tensor(chunk, dtype=torch.int64)
        logits, next_tok, self.cache = paged_prefill(
            self.params, self.cfg, padded.to(self.device), len(chunk), self.cache, idx,
            slot.prefill_done,
        )
        if req.trace_context is not None and _spans_enabled():
            tracing.record_span(
                "serving.prefill_chunk",
                start=t0,
                end=time.time(),
                parent=req.trace_context,
                attrs={
                    "request_id": req.id,
                    "chunk_tokens": len(chunk),
                    "offset": slot.prefill_done,
                    "bucket": bucket,
                },
            )
        slot.prefill_done += len(chunk)
        slot.pos = slot.prefill_done
        if slot.prefill_done < total:
            return
        # prefill complete: the continuation after the whole prefix is a NEW
        # token (the first for a fresh request, the next for a readmitted one)
        if self.prefix_cache is not None and len(req.prompt) >= self.page_size:
            self.prefix_cache.insert(req.prompt, slot.pages)
            self._sync_page_gauges()
        if req.temperature > 0:
            next_tok = sample_step(
                logits[None, :], [req.seed], [len(req.tokens)], [req.temperature],
                [req.top_k], [req.top_p],
            )[0]
            self.sampled_tokens += 1
            SERVING_SAMPLED_TOKENS.inc()
        tok = int(next_tok.cpu())
        if req.trace_context is not None:
            tracing.record_span(
                "serving.prefill",
                start=req.admitted_at or t0,
                end=time.time(),
                parent=req.trace_context,
                attrs={"request_id": req.id, "prompt_tokens": total},
            )
        self._emit_first(idx, slot, tok)

    def _note_ttft(self, req: GenRequest) -> None:
        ttft = req.first_token_at - req.created_at
        SERVING_TTFT.observe(
            ttft,
            exemplar=req.trace_context.trace_id if req.trace_context is not None else None,
        )
        self._ttft_window.append(ttft)
        window = sorted(self._ttft_window)
        SERVING_TTFT_P95.set(window[min(len(window) - 1, int(0.95 * len(window)))])

    def _note_rate(self, n: int) -> None:
        now = time.time()
        SERVING_TOKENS.inc(n)
        self._rate_window.append((now, n))
        while self._rate_window and now - self._rate_window[0][0] > 10.0:
            self._rate_window.popleft()
        span = max(1e-3, now - self._rate_window[0][0]) if len(self._rate_window) > 1 else 1.0
        SERVING_TOKENS_PER_S.set(sum(c for _, c in self._rate_window) / span)

    def _decoding(self) -> list[tuple[int, _Slot]]:
        with self._lock:
            return [
                (i, s) for i, s in enumerate(self.slots) if s is not None and s.state == "decode"
            ]

    def _grow_pages(self) -> bool:
        """Before a decode step, every slot whose next write crosses its page
        coverage gets a fresh page, and shared pages in the write range are
        CoW'd. A dry pool evicts cached prefixes first, then preempts the
        youngest slot and retries. Returns False if nothing can decode."""
        span = self.page_size
        while True:
            needy = [
                (i, s, -(-(s.pos + 1) // span) - len(s.pages))
                for i, s in self._decoding()
                if s.pos + 1 > len(s.pages) * span
            ]
            if not needy:
                break
            short = sum(n for _i, _s, n in needy) - self.allocator.free_pages
            if short > 0:
                self._evict_prefix_for(short)
                short = sum(n for _i, _s, n in needy) - self.allocator.free_pages
            if short > 0:
                if not self._preempt_youngest():
                    return False  # nothing left to preempt
                continue
            for i, s, n in needy:
                pages = self.allocator.alloc(n)
                assign_pages(self.cache, i, len(s.pages), pages)
                s.pages.extend(pages)
            self._sync_page_gauges()
            break
        for i, s in self._decoding():
            if not self._cow_range(i, s, s.pos, s.pos + 1):
                if not self._preempt_youngest():
                    return False
                return self._grow_pages()  # geometry changed; re-run
        return True

    def _preempt_youngest(self) -> bool:
        """Free the most recently admitted slot's pages and requeue its
        request (re-admission re-prefills prompt + generated tokens; the
        stream never sees a duplicate)."""
        with self._lock:
            victims = [(i, s) for i, s in enumerate(self.slots) if s is not None]
            if not victims:
                return False
            idx, slot = max(victims, key=lambda t: t[1].admitted_step)
            self.slots[idx] = None
            self.waiting.appendleft(slot.request)
            SERVING_QUEUE_DEPTH.set(float(len(self.waiting)))
        self.allocator.free(slot.pages)
        release_slot(self.cache, idx)
        req = slot.request
        req.preemptions += 1
        self.preemptions += 1
        SERVING_PREEMPTIONS.inc()
        self._sync_page_gauges()
        now = time.time()
        if req.trace_context is not None and _spans_enabled():
            if slot.last_mark_t and slot.state == "decode":
                tracing.record_span(
                    "serving.decode",
                    start=slot.last_mark_t,
                    end=now,
                    parent=req.trace_context,
                    attrs={"request_id": req.id, "tokens": len(req.tokens), "preempted": True},
                )
            tracing.record_span(
                "serving.preempt",
                start=now,
                end=now,
                parent=req.trace_context,
                attrs={"request_id": req.id, "slot": idx, "tokens_kept": len(req.tokens)},
            )
        req.queue_from = now
        logger.debug(f"serving: preempted {req.id} (slot {idx}, {len(req.tokens)} tokens kept)")
        return True

    def _decode_step(self) -> None:
        if not self._grow_pages():
            return
        decoding = self._decoding()
        if not decoding:
            return
        tokens = np.zeros((self.max_slots,), np.int64)
        active = np.zeros((self.max_slots,), bool)
        for i, s in decoding:
            tokens[i] = s.cur_token
            active[i] = True
        logits, next_tokens, self.cache = paged_decode_step(
            self.params, self.cfg, torch.from_numpy(tokens).to(self.device), self.cache,
            torch.from_numpy(active).to(self.device), self.attn_impl,
        )
        n_sampled = sum(1 for _i, s in decoding if s.request.temperature > 0)
        if n_sampled:
            # greedy rows of sample_step are the exact argmax, so a mixed
            # batch stays identical for its greedy slots
            seeds = np.zeros((self.max_slots,), np.int64)
            indices = np.zeros((self.max_slots,), np.int64)
            temps = np.zeros((self.max_slots,), np.float32)
            top_ks = np.zeros((self.max_slots,), np.int64)
            top_ps = np.ones((self.max_slots,), np.float32)
            for i, s in decoding:
                req = s.request
                seeds[i], indices[i], temps[i] = req.seed, len(req.tokens), req.temperature
                top_ks[i], top_ps[i] = req.top_k, req.top_p
            next_tokens = sample_step(logits, seeds, indices, temps, top_ks, top_ps)
            self.sampled_tokens += n_sampled
            SERVING_SAMPLED_TOKENS.inc(n_sampled)
        next_host = next_tokens.cpu().tolist()
        self.step_count += 1
        SERVING_BATCH_OCCUPANCY.observe(float(len(decoding)))
        spans_on = _spans_enabled()
        mark_every = _span_mark_tokens()
        for i, s in decoding:
            s.pos += 1  # the fed token was written at its position
            s.cur_token = int(next_host[i])
            req = s.request
            req._append(s.cur_token)
            if spans_on and req.trace_context is not None:
                if req.reached_end() or len(req.tokens) - s.tokens_at_mark >= mark_every:
                    now = time.time()
                    tracing.record_span(
                        "serving.decode",
                        start=s.last_mark_t or now,
                        end=now,
                        parent=req.trace_context,
                        attrs={
                            "request_id": req.id,
                            "tokens": len(req.tokens),
                            "batch_occupancy": len(decoding),
                            "kv_pages_free": self.allocator.free_pages,
                            "kv_pages_allocated": self.allocator.allocated_pages,
                        },
                    )
                    s.last_mark_t = now
                    s.tokens_at_mark = len(req.tokens)
            self._maybe_finish(i, s)
        self.tokens_generated += len(decoding)
        self._note_rate(len(decoding))

    def _maybe_finish(self, idx: int, slot: _Slot) -> None:
        req = slot.request
        if not req.reached_end():
            return
        with self._lock:
            self.slots[idx] = None
            self._retired.append(req.id)
        self.allocator.free(slot.pages)
        release_slot(self.cache, idx)
        self.requests_completed += 1
        SERVING_REQUESTS.inc(outcome="ok")
        self._sync_page_gauges()
        req._finish()

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            active = sum(1 for s in self.slots if s is not None)
            waiting = len(self.waiting)
        pc = self.prefix_cache
        return {
            "device": str(self.device),
            "max_slots": self.max_slots,
            "active_slots": active,
            "waiting": waiting,
            "steps": self.step_count,
            "tokens_generated": self.tokens_generated,
            "sampled_tokens": self.sampled_tokens,
            "requests_completed": self.requests_completed,
            "preemptions": self.preemptions,
            "kv_pages_total": self.allocator.num_pages - 1,
            "kv_pages_allocated": self.allocator.allocated_pages,
            "kv_pages_free": self.allocator.free_pages,
            "kv_pages_high_water": self.allocator.high_water,
            "kv_pool_bytes": self.cache.pool_bytes(),
            "attn_impl": self.attn_impl,
            "sampling_enabled": self.sampling_enabled,
            "prefix_cache_entries": len(pc) if pc else 0,
            "prefix_cache_pages": pc.held_pages if pc else 0,
            "prefix_cache_hits": pc.hits if pc else 0,
            "prefix_cache_misses": pc.misses if pc else 0,
            "kv_pages_cow_copies": self.cow_copies,
            "tokens_per_s": SERVING_TOKENS_PER_S.value(),
            "ttft_p95_s": SERVING_TTFT_P95.value(),
        }
