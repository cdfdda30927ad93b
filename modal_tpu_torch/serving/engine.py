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

Two serving modes ride the same loop:

- speculative decoding (`draft=(params, cfg)`): a draft model proposes
  `spec_k` tokens per slot, the target verifies them in one multi-token
  step, and the engine emits the longest prefix on which the draft matched
  the target's own chain plus the target's next token. Emitted tokens are
  always the target's; the draft's KV lives in a second pool that mirrors
  the target's slot and page geometry;
- prefill/decode disaggregation (`role=`, `prefill_export`,
  `submit_prefilled`): a prefill engine runs a prompt's prefill only and
  exports its KV pages (`shipment.py` carries them); a decode engine imports
  them into fresh pages and goes straight to decode. A shipment that does
  not fit degrades to a local prefill, with the same tokens.

The loop runs on its own thread and does its device work on the device's
default stream; it reads results back to the host through `.cpu()`, once
per prefill chunk, once per decode step and once per speculative slot group.
While spans are read, each iteration is one `serving.step` span of
contiguous host phases (step_trace.py).

On CUDA the decode step is a captured CUDA graph (`cuda_graphs=None` or
True; `paged_kv.DecodeGraph`): the target's step, or in speculative mode the
draft's, replayed k + 1 times per dispatch. Prefill and the speculative
verify run eagerly. `cuda_graphs=False` is the explicit eager choice.
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

from ..config import host_to_device, logger, resolve_device
from ..models.llama import params_device
from ..models.paged_kv import (
    DEFAULT_PAGE_SIZE,
    DecodeGraph,
    PageAllocator,
    PagedKVCache,
    PagePoolExhausted,
    PrefixCache,
    assign_pages,
    copy_page,
    export_pages,
    import_pages,
    paged_decode_step,
    paged_prefill,
    paged_verify_step,
    prefill_bucket,
    release_slot,
    resolve_attn_impl,
    set_seq_lens,
)
from ..models.sampling import sample_step
from ..observability import tracing
from ..observability.catalog import (
    KV_PAGES_ALLOCATED,
    KV_PAGES_COW,
    KV_PAGES_FREE,
    KV_PAGES_SHIPPED,
    KV_SHIP_SECONDS,
    SERVING_BATCH_OCCUPANCY,
    SERVING_PREEMPTIONS,
    SERVING_PREFIX_HITS,
    SERVING_PREFIX_MISSES,
    SERVING_QUEUE_DEPTH,
    SERVING_REQUESTS,
    SERVING_ROLE,
    SERVING_SAMPLED_TOKENS,
    SERVING_SPEC_ACCEPT_RATIO,
    SERVING_TOKENS,
    SERVING_TOKENS_PER_S,
    SERVING_TTFT,
    SERVING_TTFT_P95,
)
from .router import prefix_digest
from .step_trace import StepPhases

_req_counter = itertools.count()

# per-request timeline spans; MODAL_TPU_SERVING_SPANS=0 turns them off
SPANS_ENV = "MODAL_TPU_SERVING_SPANS"
SPAN_TOKENS_ENV = "MODAL_TPU_SERVING_SPAN_TOKENS"
SAMPLING_ENV = "MODAL_TPU_SERVING_SAMPLING"  # 0 → greedy-only engine
PREFIX_CACHE_ENV = "MODAL_TPU_SERVING_PREFIX_CACHE"  # 0 → no shared-prefix reuse
SPEC_ENV = "MODAL_TPU_SERVING_SPEC"  # 0 → ignore any configured draft model
# prefill | decode | both (unset → both). The role never disables an engine
# path; it advertises intent, so a mis-set role degrades routing, not service
ROLE_ENV = "MODAL_TPU_SERVING_ROLE"
# 1 (default) → a speculative round queues both slot groups' device work
# before reading either back; 0 → one group at a time. Same tokens either way
SPEC_OVERLAP_ENV = "MODAL_TPU_SPEC_OVERLAP"
# chaos: drop the next N inbound KV shipments at the decode side (a prefill
# replica dying mid-ship); the engine prefills locally and loses no token
CHAOS_KV_SHIP_DROP_ENV = "MODAL_TPU_CHAOS_KV_SHIP_DROP"
# chaos: sleep this many seconds before each loop iteration (a slow replica)
CHAOS_STEP_DELAY_ENV = "MODAL_TPU_CHAOS_SERVING_STEP_DELAY_S"
# (the decode-attention knob MODAL_TPU_PAGED_KERNEL lives in models/paged_kv.py)

_kv_ship_chaos: dict = {}


def _consume_kv_ship_drop() -> bool:
    """Take one unit of the chaos drop budget, read from the env at first
    use (tests set the env, then `_reset_kv_ship_chaos_for_tests()`)."""
    budget = _kv_ship_chaos.get("budget")
    if budget is None:
        try:
            budget = int(os.environ.get(CHAOS_KV_SHIP_DROP_ENV, "0") or 0)
        except ValueError:
            budget = 0
        _kv_ship_chaos["budget"] = budget
    if budget > 0:
        _kv_ship_chaos["budget"] = budget - 1
        return True
    return False


def _reset_kv_ship_chaos_for_tests() -> None:
    _kv_ship_chaos.clear()


def resolve_role() -> str:
    """MODAL_TPU_SERVING_ROLE → "prefill" | "decode" | "both". Anything else,
    unset included, is "both": a typo must give the do-everything replica,
    never one that refuses work."""
    val = os.environ.get(ROLE_ENV, "").strip().lower()
    return val if val in ("prefill", "decode") else "both"


# the serving_role gauge carries the role as a number
ROLE_GAUGE_VALUES = {"both": 0, "prefill": 1, "decode": 2}
ROLE_GAUGE_NAMES = {v: k for k, v in ROLE_GAUGE_VALUES.items()}


def replica_id() -> str:
    """Request-id prefix: the task id under the stack, else host-pid."""
    return os.environ.get("MODAL_TPU_TASK_ID") or f"{socket.gethostname()}-{os.getpid()}"


def _env_on(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default).strip().lower() not in ("0", "false", "no", "off")


def _spans_enabled() -> bool:
    return _env_on(SPANS_ENV)


def _spans_on() -> bool:
    """The engine builds spans only while something reads them."""
    return tracing.active() and _spans_enabled()


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
        # disaggregation: `shipment` is the export side's result (a host KV
        # bundle, set before _finish); `_shipment` an inbound bundle, used at
        # the first admission only (a later preemption prefills locally)
        self.shipment: Optional[dict] = None
        self._shipment: Optional[dict] = None
        self._export = False
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
    draft_pages: list[int] = field(default_factory=list)  # speculative: the draft pool's mirror
    pos: int = 0  # tokens written to the slot's pages (mirrors seq_lens)
    prefill_tokens: list[int] = field(default_factory=list)  # prompt (+ regenerated prefix)
    prefill_done: int = 0  # tokens of prefill_tokens already written (target pool)
    draft_prefill_done: int = 0  # the draft pool's progress (its own prefix hits may differ)
    first_emitted: bool = False  # the prefill-completion token went out
    cur_token: int = 0  # token to feed the next decode step
    state: str = "prefill"  # "prefill" | "decode"
    admitted_step: int = 0
    last_mark_t: float = 0.0  # last serving.decode span's end
    tokens_at_mark: int = 0




class ServingEngine:
    """One shared paged-KV pool + one continuous decode loop. `device`
    defaults to CUDA (raising without a card); the params, and a draft's,
    must live there. `cuda_graphs`: None captures the decode step as a CUDA
    graph on a card and runs eagerly on the CPU; True requires a card;
    False runs eagerly (an A/B choice, never a fallback)."""

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
        draft: Optional[tuple] = None,  # (draft_params, draft_cfg) → speculative decoding
        spec_k: int = 3,  # draft tokens proposed per speculative round
        prefix_cache: Optional[bool] = None,  # None = env default (on)
        role: Optional[str] = None,  # prefill | decode | both; None = env default
        device=None,
        cuda_graphs: Optional[bool] = None,  # None = on for CUDA, off on the CPU
    ):
        if getattr(cfg, "is_moe", False):
            raise ValueError("MoE configs are not paged-servable (dense FFN only)")
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
        # speculative decoding: the draft's pool mirrors the target's slot and
        # page geometry 1:1, so the two can never disagree on what fits
        self.draft_params: Optional[dict] = None
        self.draft_cfg: Optional[Any] = None
        self.spec_k = 0
        if draft is not None and _env_on(SPEC_ENV):
            draft_params, draft_cfg = draft
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab ({draft_cfg.vocab_size}) != target vocab ({cfg.vocab_size})"
                )
            if getattr(draft_cfg, "is_moe", False):
                raise ValueError("MoE draft configs are not paged-servable")
            if params_device(draft_params) != self.device:
                raise ValueError(
                    f"draft params live on {params_device(draft_params)}, engine on {self.device}"
                )
            self.draft_params = draft_params
            self.draft_cfg = draft_cfg
            self.spec_k = max(1, int(spec_k))
            self.draft_allocator = PageAllocator(num_pages, page_size)
            self.draft_cache = PagedKVCache.create(
                draft_cfg, max_slots, num_pages, page_size, pages_per_slot, device=self.device
            )
        # shared-prefix reuse: the target pool shares partial pages and copies
        # them on write; the draft pool shares full pages only, so it never
        # writes into a shared page and needs no copy-on-write
        want_prefix = _env_on(PREFIX_CACHE_ENV) if prefix_cache is None else bool(prefix_cache)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.allocator) if want_prefix else None
        )
        self.draft_prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.draft_allocator) if (want_prefix and self.spec_k) else None
        )
        self.role = role if role in ("prefill", "decode", "both") else resolve_role()
        SERVING_ROLE.set(float(ROLE_GAUGE_VALUES[self.role]))
        self.spec_overlap = _env_on(SPEC_OVERLAP_ENV)
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda"
        elif cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs=True needs a CUDA device; this engine runs on {self.device}")
        # one graph per engine: the step this engine's decode repeats (the
        # draft's in speculative mode, where the target only verifies)
        self.decode_graph: Optional[DecodeGraph] = None
        if cuda_graphs:
            self.decode_graph = (
                DecodeGraph(self.draft_params, self.draft_cfg, self.draft_cache, self.attn_impl)
                if self.spec_k
                else DecodeGraph(self.params, self.cfg, self.cache, self.attn_impl)
            )
        self.kv_pages_shipped = 0
        self.kv_ship_drops = 0
        self.remote_prefills = 0
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
        # acceptance over a trailing window of rounds: (accepted, proposed)
        self._spec_window: deque[tuple[int, int]] = deque(maxlen=200)
        self.spec_rounds = 0
        self.spec_dispatches = 0  # slot groups dispatched: k + 1 draft steps each
        try:
            self.chaos_step_delay = float(os.environ.get(CHAOS_STEP_DELAY_ENV, "0") or 0)
        except ValueError:
            self.chaos_step_delay = 0.0
        self._step: Optional[StepPhases] = None  # the running iteration's, while spans are read
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
        if self.draft_prefix_cache is not None:
            self.draft_prefix_cache.clear()

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
        shipment: Optional[dict] = None,  # remotely prefilled KV bundle (submit_prefilled)
        export: bool = False,  # prefill only, KV pages shipped out (prefill_export)
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
        # speculative mode reserves spec_k positions: a verify round on the
        # request's last token still writes k positions past it, and the
        # page table cannot grow past pages_per_slot (the write's page index
        # would clamp onto a live page and corrupt it)
        effective_context = self.max_context - self.spec_k
        if len(prompt) + max_new_tokens > effective_context:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) exceeds the "
                f"engine's context limit ({effective_context} = pages_per_slot × page_size"
                + (f" − spec_k ({self.spec_k})" if self.spec_k else "")
                + ")"
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
        req._export = bool(export)
        req._shipment = shipment
        if _spans_on():
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

    def prefill_export(
        self,
        prompt: list[int],
        *,
        request_id: str = "",
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
    ) -> GenRequest:
        """Prefill-role entry point: run only the prompt's prefill, emit its
        one continuation token, and attach the prompt's KV pages to
        `req.shipment` as a host bundle {prompt, first_token, n_tokens, k,
        v}. The request completes with exactly one token, so a prefill
        engine's pool turns over at admission rate."""
        return self.submit(
            prompt, max_new_tokens=1, request_id=request_id,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            export=True,
        )

    def submit_prefilled(
        self,
        prompt: list[int],
        shipment: Optional[dict],
        max_new_tokens: int = 64,
        *,
        request_id: str = "",
        eos_token_id: Optional[int] = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
    ) -> GenRequest:
        """Decode-role admission of a remotely prefilled prompt: the
        shipment's pages are imported (no local prefill), its first token is
        this engine's first emission, and the prompt is published into the
        local prefix cache. No shipment, or one the chaos knob eats, gives a
        plain `submit` (a local prefill, the same tokens); a shipment that
        does not match this prompt and geometry raises ValueError."""
        kwargs = dict(
            request_id=request_id, eos_token_id=eos_token_id,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        )
        if shipment is None:
            return self.submit(prompt, max_new_tokens, **kwargs)
        n_ship = -(-len(prompt) // self.page_size) if prompt else 0
        want = (self.cfg.n_layers, n_ship, self.page_size, self.cfg.n_kv_heads, self.cfg.head_dim)
        k_arr, v_arr = shipment.get("k"), shipment.get("v")
        ok = (
            bool(prompt)
            and list(shipment.get("prompt", ())) == list(prompt)
            and k_arr is not None
            and v_arr is not None
            and tuple(getattr(k_arr, "shape", ())) == want
            and tuple(getattr(v_arr, "shape", ())) == want
        )
        if not ok:
            raise ValueError("shipment does not match this prompt/engine geometry")
        if _consume_kv_ship_drop():
            self.kv_ship_drops += 1
            shipment = None
        return self.submit(prompt, max_new_tokens, shipment=shipment, **kwargs)

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
            f"pool={self.cache.pool_bytes() / 1e6:.1f}MB attn={self.attn_impl} "
            f"spec_k={self.spec_k} role={self.role}"
        )
        while True:
            with self._work:
                while not self._stop and not self.waiting and not any(self.slots):
                    self._work.wait(timeout=0.5)
                if self._stop:
                    return
            try:
                if self.chaos_step_delay > 0:
                    time.sleep(self.chaos_step_delay)
                self.run_once()
            except Exception as exc:  # noqa: BLE001 — the loop must survive; requests fail loudly
                logger.exception(f"serving loop iteration failed: {exc}")
                self._fail_all(f"engine loop error: {type(exc).__name__}: {exc}")

    @torch.no_grad()
    def run_once(self) -> None:
        """One loop iteration: admit, advance one prefill chunk, one decode
        step (or speculative round). The thread calls it; a test may drive
        the engine with it. While spans are read, the iteration is one
        `serving.step` span of contiguous host phases (step_trace.py)."""
        step = self._step = StepPhases() if _spans_on() else None
        completed = self.requests_completed
        try:
            if step is not None:
                step.enter("admit")
            self._admit()
            if step is not None:
                step.enter("prefill")
            self._prefill_one()
            self._decode_step()
        finally:
            self._step = None
            if step is not None:
                step.close(finished=self.requests_completed - completed)

    def _fail_all(self, message: str) -> None:
        with self._lock:
            victims = [s for s in self.slots if s is not None]
            self.slots = [None] * self.max_slots
            for s in victims:
                self._retired.append(s.request.id)
        for s in victims:
            self.allocator.free(s.pages)
            if s.draft_pages:
                self.draft_allocator.free(s.draft_pages)
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

    def _evict_draft_prefix_for(self, shortage: int) -> int:
        """The draft pool's `_evict_prefix_for` (the page gauges track the
        target pool only)."""
        released = 0
        while (
            released < shortage
            and self.draft_prefix_cache is not None
            and len(self.draft_prefix_cache)
        ):
            released += self.draft_prefix_cache.evict_lru()
        return released

    def _admit(self) -> None:
        """Move waiting requests into free slots while pages allow (FIFO). A
        prefix-cache hit hands the slot refcounted pages holding an already
        prefilled prefix; only the suffix pays prefill. A request carrying a
        shipment skips the target's prefix lookup: its pages arrive whole."""
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
                shipment = req._shipment
                shared_pages: list[int] = []
                covered = 0
                hit_entry = None
                if shipment is None and self.prefix_cache is not None:
                    hit = self.prefix_cache.lookup(prefill_tokens)
                    if hit is not None:
                        shared_pages, covered, hit_entry = hit
                fresh_need = max(0, need - len(shared_pages))
                draft_shared: list[int] = []
                draft_covered = 0
                draft_entry = None
                if self.draft_prefix_cache is not None:
                    dhit = self.draft_prefix_cache.lookup(prefill_tokens, allow_partial=False)
                    if dhit is not None:
                        draft_shared, draft_covered, draft_entry = dhit
                draft_need = max(0, need - len(draft_shared)) if self.spec_k else 0
                if not self.allocator.can_alloc(fresh_need):
                    self._evict_prefix_for(fresh_need - self.allocator.free_pages)
                if self.spec_k and not self.draft_allocator.can_alloc(draft_need):
                    self._evict_draft_prefix_for(draft_need - self.draft_allocator.free_pages)
                if not self.allocator.can_alloc(fresh_need) or (
                    self.spec_k and not self.draft_allocator.can_alloc(draft_need)
                ):
                    if shared_pages:
                        self.allocator.free(shared_pages)  # drop the lookups' refs
                    if draft_shared:
                        self.draft_allocator.free(draft_shared)
                    return  # pool dry; preemption or completions will free
                self.waiting.popleft()
                SERVING_QUEUE_DEPTH.set(float(len(self.waiting)))
                try:
                    pages = shared_pages + self.allocator.alloc(fresh_need)
                    draft_pages = (
                        draft_shared + self.draft_allocator.alloc(draft_need)
                        if self.spec_k
                        else []
                    )
                except PagePoolExhausted:  # pragma: no cover — guarded above
                    self.waiting.appendleft(req)
                    return
                slot = _Slot(
                    request=req,
                    pages=pages,
                    draft_pages=draft_pages,
                    prefill_tokens=prefill_tokens,
                    prefill_done=covered,
                    draft_prefill_done=draft_covered,
                    pos=covered,
                    admitted_step=self.step_count,
                )
                self.slots[free_idx] = slot
                # an imported prefill is neither a hit nor a miss: the prefix
                # work happened on another engine
                if self.prefix_cache is not None and shipment is None:
                    if hit_entry is not None and covered:
                        self.prefix_cache.commit_use(hit_entry)
                        SERVING_PREFIX_HITS.inc()
                    else:
                        self.prefix_cache.note_miss()
                        SERVING_PREFIX_MISSES.inc()
                if draft_entry is not None and draft_covered:
                    self.draft_prefix_cache.commit_use(draft_entry)
            assign_pages(self.cache, free_idx, 0, pages)
            if draft_pages:
                assign_pages(self.draft_cache, free_idx, 0, draft_pages)
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
                        "draft_prefix_tokens": draft_covered,
                        "remote_prefill": shipment is not None,
                        "requeue": req.preemptions > 0,
                    },
                )
            if shipment is not None:
                self._import_shipment(free_idx, slot, shipment)

    def _import_shipment(self, idx: int, slot: _Slot, shipment: dict) -> None:
        """Land a remotely prefilled KV bundle in the slot's fresh pages, set
        the slot's length to the prompt, publish the prompt into the local
        prefix cache and emit the shipped token as this engine's first. In
        speculative mode the draft still prefills locally: the slot stays in
        "prefill" until the draft mirror catches up."""
        req = slot.request
        req._shipment = None  # consumed: a later preemption prefills locally
        n_ship = -(-len(req.prompt) // self.page_size)
        t0 = time.time()
        import_pages(self.cache, slot.pages[:n_ship], shipment)
        self.cache.seq_lens[idx] = len(req.prompt)
        slot.prefill_done = len(slot.prefill_tokens)
        slot.pos = len(req.prompt)
        self.remote_prefills += 1
        if req.trace_context is not None and _spans_enabled():
            tracing.record_span(
                "serving.kv_ship",
                start=t0,
                end=time.time(),
                parent=req.trace_context,
                attrs={"request_id": req.id, "side": "import", "pages": n_ship},
            )
        if self.prefix_cache is not None and len(req.prompt) >= self.page_size:
            self.prefix_cache.insert(req.prompt, slot.pages)
            self._sync_page_gauges()
        self._emit_first(idx, slot, int(shipment["first_token"]))

    def _emit_first(self, idx: int, slot: _Slot, tok: int) -> None:
        """The slot's prefill-completion emission (local prefill or import):
        first decode feed and TTFT; the slot decodes once the draft mirror,
        if any, is resident too."""
        req = slot.request
        slot.cur_token = tok
        slot.first_emitted = True
        if not self.spec_k or slot.draft_prefill_done >= len(slot.prefill_tokens):
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

    def _prefill_chunk(self, params, cfg, cache, idx: int, tokens: list[int], done: int):
        """One chunk of a slot's prefill (`prefill_chunk` tokens from
        `done`) into `cache`. Returns (logits, next_token, chunk tokens)."""
        chunk = tokens[done : done + self.prefill_chunk]
        bucket = prefill_bucket(len(chunk), self.max_context)
        padded = torch.zeros((bucket,), dtype=torch.int64)
        padded[: len(chunk)] = torch.as_tensor(chunk, dtype=torch.int64)
        logits, next_tok, _cache = paged_prefill(
            params, cfg, padded.to(self.device), len(chunk), cache, idx, done
        )
        return logits, next_tok, chunk

    def _prefill_one(self) -> None:
        """Advance the oldest prefilling slot by one chunk.

        The target and draft pools progress independently: each has its own
        prefix cache, so their covered offsets differ, and an imported
        shipment leaves the target covered while the draft still prefills.
        The first token goes out when the TARGET completes; decode waits for
        both."""
        with self._lock:
            candidates = [
                (i, s) for i, s in enumerate(self.slots) if s is not None and s.state == "prefill"
            ]
        if not candidates:
            return
        idx, slot = min(candidates, key=lambda t: t[1].admitted_step)
        req = slot.request
        step = self._step
        total = len(slot.prefill_tokens)
        t0 = time.time()
        target_done_now = False
        if slot.prefill_done < total:
            end = min(total, slot.prefill_done + self.prefill_chunk)
            if not self._cow_range(idx, slot, slot.prefill_done, end):
                # CoW starved for a page: the needy slot itself is a valid victim
                self._preempt_youngest()
                return
            logits, next_tok, chunk = self._prefill_chunk(
                self.params, self.cfg, self.cache, idx, slot.prefill_tokens, slot.prefill_done
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
                        "bucket": prefill_bucket(len(chunk), self.max_context),
                    },
                )
            if step is not None:
                step.prefill_tokens = len(chunk)
            slot.prefill_done += len(chunk)
            slot.pos = slot.prefill_done
            target_done_now = slot.prefill_done >= total
        if self.spec_k and slot.draft_prefill_done < total:
            _dl, _dn, dchunk = self._prefill_chunk(
                self.draft_params, self.draft_cfg, self.draft_cache, idx, slot.prefill_tokens,
                slot.draft_prefill_done,
            )
            slot.draft_prefill_done += len(dchunk)
            if step is not None and not step.prefill_tokens:
                step.prefill_tokens = len(dchunk)
            if slot.draft_prefill_done >= total:
                if self.draft_prefix_cache is not None and len(req.prompt) >= self.page_size:
                    # full pages only: the draft pool has no copy-on-write
                    self.draft_prefix_cache.insert(
                        req.prompt, slot.draft_pages, full_pages_only=True
                    )
                if slot.first_emitted and slot.state == "prefill":
                    slot.state = "decode"  # the target finished earlier (import)
        if not target_done_now:
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
        t_sync = time.perf_counter()
        tok = int(next_tok.cpu())
        if step is not None:
            step.prefill_sync(t_sync)
        if req._export:
            self._export_shipment(slot, tok)
        if req.trace_context is not None:
            tracing.record_span(
                "serving.prefill",
                start=req.admitted_at or t0,
                end=time.time(),
                parent=req.trace_context,
                attrs={"request_id": req.id, "prompt_tokens": total},
            )
        self._emit_first(idx, slot, tok)

    def _export_shipment(self, slot: _Slot, first_token: int) -> None:
        """Copy the slot's prompt pages to the host and attach them to the
        request as a shipment bundle, before the emission can finish the
        request and free the slot."""
        req = slot.request
        n_ship = -(-len(req.prompt) // self.page_size)
        t0 = time.time()
        data = export_pages(self.cache, slot.pages[:n_ship])
        dt = time.time() - t0
        req.shipment = {
            "prompt": list(req.prompt),
            "first_token": int(first_token),
            "n_tokens": len(req.prompt),
            "k": data["k"],
            "v": data["v"],
        }
        self.kv_pages_shipped += n_ship
        KV_PAGES_SHIPPED.inc(n_ship)
        KV_SHIP_SECONDS.observe(dt)
        if req.trace_context is not None and _spans_enabled():
            tracing.record_span(
                "serving.kv_ship",
                start=t0,
                end=t0 + dt,
                parent=req.trace_context,
                attrs={"request_id": req.id, "side": "export", "pages": n_ship},
            )

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
        """Before a decode step, every slot whose upcoming writes (one token,
        or k+1 in a speculative round, in both pools) cross its page coverage
        gets fresh pages, and shared pages in the write range are CoW'd. A
        dry pool evicts cached prefixes first, then preempts the youngest
        slot and retries. Returns False if nothing can decode."""
        lookahead = (self.spec_k + 1) if self.spec_k else 1  # positions written per round
        span = self.page_size
        while True:
            needy = [
                (i, s, -(-(s.pos + lookahead) // span) - len(s.pages))
                for i, s in self._decoding()
                if s.pos + lookahead > len(s.pages) * span
            ]
            if not needy:
                break
            n_need = sum(n for _i, _s, n in needy)
            if n_need > self.allocator.free_pages:
                self._evict_prefix_for(n_need - self.allocator.free_pages)
            if self.spec_k and n_need > self.draft_allocator.free_pages:
                self._evict_draft_prefix_for(n_need - self.draft_allocator.free_pages)
            if n_need > self.allocator.free_pages or (
                self.spec_k and n_need > self.draft_allocator.free_pages
            ):
                if not self._preempt_youngest():
                    return False  # nothing left to preempt
                continue
            for i, s, n in needy:
                pages = self.allocator.alloc(n)
                assign_pages(self.cache, i, len(s.pages), pages)
                s.pages.extend(pages)
                if self.spec_k:
                    dpages = self.draft_allocator.alloc(n)
                    assign_pages(self.draft_cache, i, len(s.draft_pages), dpages)
                    s.draft_pages.extend(dpages)
            self._sync_page_gauges()
            break
        for i, s in self._decoding():
            if not self._cow_range(i, s, s.pos, s.pos + lookahead):
                if not self._preempt_youngest():
                    return False
                return self._grow_pages()  # geometry changed; re-run
        return True

    def _preempt_youngest(self) -> bool:
        """Free the most recently admitted slot's pages (both pools) and
        requeue its request (re-admission re-prefills prompt + generated
        tokens; the stream never sees a duplicate)."""
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
        if slot.draft_pages:
            self.draft_allocator.free(slot.draft_pages)
            release_slot(self.draft_cache, idx)
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

    def _sampling_arrays(self, decoding: list) -> tuple:
        """Per-slot host arrays (seeds, indices, temps, top_ks, top_ps) for
        sample_step; indices[i] is the slot's NEXT token index."""
        seeds = np.zeros((self.max_slots,), np.int64)
        indices = np.zeros((self.max_slots,), np.int64)
        temps = np.zeros((self.max_slots,), np.float32)
        top_ks = np.zeros((self.max_slots,), np.int64)
        top_ps = np.ones((self.max_slots,), np.float32)
        for i, s in decoding:
            req = s.request
            seeds[i], indices[i], temps[i] = req.seed, len(req.tokens), req.temperature
            top_ks[i], top_ps[i] = req.top_k, req.top_p
        return seeds, indices, temps, top_ks, top_ps

    def _mark_decode(self, s: _Slot, batch: int, spans_on: bool, mark_every: int, **extra) -> None:
        """A serving.decode progress span every `mark_every` tokens and at
        the request's end."""
        req = s.request
        if not spans_on or req.trace_context is None:
            return
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
                    "batch_occupancy": batch,
                    **extra,
                    "kv_pages_free": self.allocator.free_pages,
                    "kv_pages_allocated": self.allocator.allocated_pages,
                },
            )
            s.last_mark_t = now
            s.tokens_at_mark = len(req.tokens)

    def _decode_step(self) -> None:
        step = self._step
        if step is not None:
            step.enter("grow")
        if self.spec_k:
            return self._spec_round()
        if not self._grow_pages():
            return
        decoding = self._decoding()
        if not decoding:
            return
        if step is not None:
            step.enter("launch")
            step.batch = len(decoding)
        tokens = np.zeros((self.max_slots,), np.int64)
        active = np.zeros((self.max_slots,), bool)
        for i, s in decoding:
            tokens[i] = s.cur_token
            active[i] = True
        tokens_d, active_d = host_to_device(tokens, self.device), host_to_device(active, self.device)
        if step is not None:
            step.mark_replay()
        if self.decode_graph is not None:
            logits, next_tokens = self.decode_graph(tokens_d, active_d)
        else:
            logits, next_tokens, self.cache = paged_decode_step(
                self.params, self.cfg, tokens_d, self.cache, active_d, self.attn_impl
            )
        n_sampled = sum(1 for _i, s in decoding if s.request.temperature > 0)
        if n_sampled:
            # greedy rows of sample_step are the exact argmax, so a mixed
            # batch stays identical for its greedy slots
            next_tokens = sample_step(logits, *self._sampling_arrays(decoding))
            self.sampled_tokens += n_sampled
            SERVING_SAMPLED_TOKENS.inc(n_sampled)
        if step is not None:
            step.enter("sync")
        next_host = next_tokens.cpu().tolist()
        if step is not None:
            step.enter("emit")
        self.step_count += 1
        SERVING_BATCH_OCCUPANCY.observe(float(len(decoding)))
        spans_on = _spans_enabled()
        mark_every = _span_mark_tokens()
        for i, s in decoding:
            s.pos += 1  # the fed token was written at its position
            s.cur_token = int(next_host[i])
            s.request._append(s.cur_token)
            self._mark_decode(s, len(decoding), spans_on, mark_every)
            self._maybe_finish(i, s)
        self.tokens_generated += len(decoding)
        self._note_rate(len(decoding))

    def _spec_round(self) -> None:
        """One speculative round: per slot the draft proposes spec_k tokens
        (k+1 draft decode steps: the extra one writes the last proposal's KV,
        so a fully accepted round leaves the draft cache complete), the
        target verifies all of them in ONE `paged_verify_step`, and emission
        takes the longest prefix on which the draft matched the target's own
        chain, plus the target's next token.

        Emitted tokens are always the target's chain: its argmax at
        temperature 0, else the same (seed, index)-keyed samples the
        non-speculative path draws. The draft only decides how many land per
        round.

        With MODAL_TPU_SPEC_OVERLAP on (default) and >= 2 decoding slots, the
        batch splits in two groups and `_spec_dispatch` queues both groups'
        device work before `_spec_accept` reads either back, so no host sync
        sits between group A's verify and group B's draft chain."""
        if not self._grow_pages():
            return
        decoding = self._decoding()
        if not decoding:
            return
        k = self.spec_k
        t0 = time.time()
        step = self._step
        if step is not None:
            step.enter("launch")
            step.batch = len(decoding)
        self.step_count += 1
        SERVING_BATCH_OCCUPANCY.observe(float(len(decoding)))
        groups = [decoding]
        if self.spec_overlap and len(decoding) >= 2:
            mid = (len(decoding) + 1) // 2
            groups = [decoding[:mid], decoding[mid:]]
        if step is not None:
            step.mark_replay()
        pendings = [self._spec_dispatch(g) for g in groups]
        totals = [self._spec_accept(g, p, batch=len(decoding)) for g, p in zip(groups, pendings)]
        total_emitted = sum(t[0] for t in totals)
        total_accepted = sum(t[1] for t in totals)
        n_sampled = sum(t[2] for t in totals)

        self.spec_rounds += 1
        self._spec_window.append((total_accepted, k * len(decoding)))
        acc = sum(a for a, _p in self._spec_window)
        prop_total = max(1, sum(p for _a, p in self._spec_window))
        SERVING_SPEC_ACCEPT_RATIO.set(acc / prop_total)
        if n_sampled:
            self.sampled_tokens += n_sampled
            SERVING_SAMPLED_TOKENS.inc(n_sampled)
        if _spans_enabled():
            rep = min(decoding, key=lambda t: t[1].admitted_step)[1].request
            if rep.trace_context is not None:
                tracing.record_span(
                    "serving.spec_verify",
                    start=t0,
                    end=time.time(),
                    parent=rep.trace_context,
                    attrs={
                        "proposed": k * len(decoding),
                        "accepted": total_accepted,
                        "batch": len(decoding),
                        "groups": len(groups),
                    },
                )
        self.tokens_generated += total_emitted
        self._note_rate(total_emitted)

    def _spec_dispatch(self, group: list) -> tuple:
        """Queue one group's speculative round: k draft decode steps (the
        proposals stay on the device between steps), the extra draft feed,
        the target verify and the target's sampling. Reads nothing back from
        the device. Returns (proposals [slots, k], targets [slots*(k+1)]),
        both still being computed; `_spec_accept` reads them."""
        k, k1 = self.spec_k, self.spec_k + 1
        cur = np.zeros((self.max_slots,), np.int64)
        active = np.zeros((self.max_slots,), bool)
        for i, s in group:
            cur[i] = s.cur_token
            active[i] = True
        cur_d = host_to_device(cur, self.device)
        active_d = host_to_device(active, self.device)
        seeds, indices, temps, top_ks, top_ps = self._sampling_arrays(group)

        # 1) draft chain: propose with the SAME (seed, index) keys the target
        # samples with, so a good draft agrees often even at temperature > 0
        props = []
        feed = cur_d
        for j in range(k):
            dlogits = self._draft_step(feed, active_d)
            feed = sample_step(dlogits, seeds, indices + j, temps, top_ks, top_ps)
            props.append(feed)
        self._draft_step(feed, active_d)

        # 2) the target verifies [cur, d_1..d_k] in one step
        proposals = torch.stack(props, dim=1)  # [slots, k]
        fed = torch.cat([cur_d[:, None], proposals], dim=1)
        vlogits, self.cache = paged_verify_step(self.params, self.cfg, fed, self.cache, active_d)

        # 3) the target's own chain at every verified position
        flat = vlogits.reshape(self.max_slots * k1, vlogits.shape[-1])
        idx_f = (indices[:, None] + np.arange(k1)[None, :]).reshape(-1)
        targets = sample_step(
            flat, np.repeat(seeds, k1), idx_f, np.repeat(temps, k1), np.repeat(top_ks, k1),
            np.repeat(top_ps, k1),
        )
        self.spec_dispatches += 1
        return proposals, targets

    def _draft_step(self, tokens: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """One draft decode step from device tensors (the graph's replay, or
        eager); returns the draft's logits [slots, V]."""
        if self.decode_graph is not None:
            return self.decode_graph(tokens, active)[0]
        dlogits, _g, self.draft_cache = paged_decode_step(
            self.draft_params, self.draft_cfg, tokens, self.draft_cache, active, self.attn_impl
        )
        return dlogits

    def _spec_accept(self, group: list, pending: tuple, batch: int) -> tuple[int, int, int]:
        """Host side of a group's round: read the results back, walk
        acceptance, emit tokens, roll BOTH pools' lengths for this group's
        rows only, then release finished slots. Returns (emitted, accepted,
        sampled)."""
        k, k1 = self.spec_k, self.spec_k + 1
        proposals_dev, targets_dev = pending
        step = self._step
        if step is not None:
            step.enter("sync")
        proposals = proposals_dev.cpu().numpy()  # [slots, k]: the host sync
        targets = targets_dev.cpu().numpy().reshape(self.max_slots, k1)
        if step is not None:
            step.enter("emit")
        spans_on = _spans_enabled()
        mark_every = _span_mark_tokens()
        new_lens = np.zeros((self.max_slots,), np.int32)
        update = np.zeros((self.max_slots,), bool)
        total_emitted = total_accepted = n_sampled = 0
        for i, s in group:
            req = s.request
            emitted = 0
            for j in range(k1):
                tok = int(targets[i, j])
                req._append(tok)
                emitted += 1
                if req.temperature > 0:
                    n_sampled += 1
                if req.reached_end() or j == k:
                    break
                if int(proposals[i, j]) != tok:
                    break  # the draft diverged: tok IS the target's correction
                total_accepted += 1
            s.pos += emitted
            new_lens[i] = s.pos
            update[i] = True
            s.cur_token = int(targets[i, emitted - 1])
            total_emitted += emitted
            self._mark_decode(s, batch, spans_on, mark_every, speculative=True)
        # roll both pools to the accepted frontier: the verify wrote k+1
        # positions and the draft advanced k+1; only pos+emitted are real.
        # BEFORE any release: release_slot zeroes a slot's length, and the
        # roll must not write a stale one back onto a freed slot
        set_seq_lens(self.cache, new_lens, update)
        set_seq_lens(self.draft_cache, new_lens, update)
        for i, s in group:
            self._maybe_finish(i, s)
        return total_emitted, total_accepted, n_sampled

    def _maybe_finish(self, idx: int, slot: _Slot) -> None:
        req = slot.request
        if not req.reached_end():
            return
        with self._lock:
            self.slots[idx] = None
            self._retired.append(req.id)
        self.allocator.free(slot.pages)
        release_slot(self.cache, idx)
        if slot.draft_pages:
            self.draft_allocator.free(slot.draft_pages)
            release_slot(self.draft_cache, idx)
        self.requests_completed += 1
        SERVING_REQUESTS.inc(outcome="ok")
        self._sync_page_gauges()
        req._finish()

    # -- introspection ------------------------------------------------------

    def prefix_digests(self, limit: int = 512) -> list[str]:
        """Digests of the full-page prefix keys the target prefix cache
        serves, capped (a digest names a prefix without its tokens)."""
        if self.prefix_cache is None:
            return []
        keys = list(self.prefix_cache._index.keys())  # atomic snapshot (GIL)
        return [prefix_digest(key) for key in keys[:limit]]

    def stats(self) -> dict:
        with self._lock:
            active = sum(1 for s in self.slots if s is not None)
            waiting = len(self.waiting)
        pc, dpc = self.prefix_cache, self.draft_prefix_cache
        acc = sum(a for a, _p in self._spec_window)
        prop = sum(p for _a, p in self._spec_window)
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
            "cuda_graphs": self.decode_graph is not None,
            "sampling_enabled": self.sampling_enabled,
            "prefix_cache_entries": len(pc) if pc else 0,
            "prefix_cache_pages": pc.held_pages if pc else 0,
            "prefix_cache_hits": pc.hits if pc else 0,
            "prefix_cache_misses": pc.misses if pc else 0,
            "kv_pages_cow_copies": self.cow_copies,
            "spec_k": self.spec_k,
            "spec_rounds": self.spec_rounds,
            "spec_dispatches": self.spec_dispatches,
            "spec_accept_ratio": round(acc / prop, 4) if prop else None,
            "spec_overlap": self.spec_overlap,
            "role": self.role,
            "remote_prefills": self.remote_prefills,
            "kv_pages_shipped": self.kv_pages_shipped,
            "kv_ship_drops": self.kv_ship_drops,
            "draft_prefix_cache_entries": len(dpc) if dpc else 0,
            "draft_prefix_cache_hits": dpc.hits if dpc else 0,
            "prefix_digests": self.prefix_digests(),
            "tokens_per_s": SERVING_TOKENS_PER_S.value(),
            "ttft_p95_s": SERVING_TTFT_P95.value(),
        }
