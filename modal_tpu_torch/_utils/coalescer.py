"""Adaptive micro-batching for scheduling RPCs (port of
modal_tpu/_utils/coalescer.py).

N concurrent dispatches would cost O(N) control-plane RPCs per tick: every
`.remote()` its own FunctionMap, every finished input its own
FunctionPutOutputs. That per-RPC cost, not payload bytes, is what caps
concurrent throughput.

``MicroBatcher`` collapses them: callers ``submit(item)`` and await their own
result; a drainer task flushes the accumulated batch through one
``flush_fn(items) -> results`` call. The window is *adaptive* rather than a
fixed timer:

- an isolated submit flushes after one event-loop tick (``sleep(0)``): no
  added latency when idle; same-tick concurrent submitters share the flush;
- while a flush RPC is in flight, new submits pile into the next batch and
  flush the moment the RPC returns: under load the in-flight RPC *is* the
  window, so N in-flight callers cost O(1) RPCs per round trip;
- an optional fixed ``window_s`` (~1 ms) adds a linger for producers that
  trickle, trading that 1 ms for fuller batches.

Every flush records its occupancy (``modal_tpu_dispatch_batch_occupancy``)
and, for traced callers, a ``dispatch.coalesce`` span covering the
enqueue→flush wait.

``MODAL_TPU_DISPATCH_COALESCE=0`` disables coalescing everywhere (callers
send one RPC per item).
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Any, Awaitable, Callable, Optional



def coalescing_enabled() -> bool:
    return os.environ.get("MODAL_TPU_DISPATCH_COALESCE", "1") not in ("0", "false", "no")


class MicroBatcher:
    """One coalescing plane (e.g. "FunctionMap" submissions on one client).

    ``flush_fn(items)`` must return a list of per-item results, 1:1 and in
    order; a result that IS an exception instance is raised on that item's
    waiter alone (per-item degradation). A flush_fn exception propagates to
    every waiter of that batch (their retry wrappers decide what happens
    next)."""

    def __init__(
        self,
        flush_fn: Callable[[list], Awaitable[list]],
        *,
        max_batch: int = 256,
        window_s: float = 0.0,
        label: str = "",
    ):
        self._flush_fn = flush_fn
        self._max_batch = max(1, max_batch)
        self._window_s = window_s
        self.label = label or getattr(flush_fn, "__name__", "batch")
        # (item, future, trace ctx, enqueue time)
        self._pending: list[tuple[Any, asyncio.Future, Any, float]] = []
        self._drainer: Optional[asyncio.Task] = None
        self.flushes = 0
        self.items_flushed = 0

    async def submit(self, item: Any) -> Any:
        from ..observability import tracing

        fut = asyncio.get_running_loop().create_future()
        self._pending.append((item, fut, tracing.current_context(), time.time()))
        if self._drainer is None or self._drainer.done():
            self._drainer = asyncio.create_task(self._drain(), name=f"coalesce-{self.label}")
        return await fut

    async def _drain(self) -> None:
        from ..observability import tracing
        from ..observability.catalog import DISPATCH_BATCH_OCCUPANCY

        while self._pending:
            if self._window_s > 0 and len(self._pending) < self._max_batch:
                # linger: keep the window open while the producer is still
                # actively adding (each extra window must earn its keep with
                # new arrivals), bounded by max_batch and a 20-window cap —
                # a fast producer fills the batch, a stalled one flushes
                # after one quiet window
                lingers = 0
                prev = len(self._pending)
                while len(self._pending) < self._max_batch and lingers < 20:
                    await asyncio.sleep(self._window_s)
                    lingers += 1
                    if len(self._pending) == prev:
                        break
                    prev = len(self._pending)
            else:
                # one tick: same-iteration submitters join the batch; an
                # isolated caller pays ~µs, not a timer
                await asyncio.sleep(0)
            batch = self._pending[: self._max_batch]
            del self._pending[: len(batch)]
            if not batch:
                continue
            now = time.time()
            for _item, _fut, ctx, t_enq in batch:
                if ctx is not None and now - t_enq > 0.0001:
                    tracing.record_span(
                        "dispatch.coalesce",
                        start=t_enq,
                        end=now,
                        parent=ctx,
                        attrs={"plane": self.label, "batch": len(batch)},
                    )
            DISPATCH_BATCH_OCCUPANCY.observe(len(batch), rpc=self.label)
            self.flushes += 1
            self.items_flushed += len(batch)
            try:
                results = await self._flush_fn([item for item, _f, _c, _t in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"coalesced flush returned {len(results)} results for {len(batch)} items"
                    )
                for (_item, fut, _c, _t), result in zip(batch, results):
                    if fut.done():
                        continue
                    if isinstance(result, BaseException):
                        fut.set_exception(result)
                    else:
                        fut.set_result(result)
            except BaseException as exc:  # noqa: BLE001 — waiters own the error
                for _item, fut, _c, _t in batch:
                    if not fut.done():
                        fut.set_exception(exc)
                if isinstance(exc, (KeyboardInterrupt, SystemExit, asyncio.CancelledError)):
                    raise


class BatcherRegistry:
    """Lazy per-plane MicroBatchers hanging off one owner (a client, an
    io_manager). Keyed by label so e.g. FunctionMap and PutOutputs coalesce
    independently; created on the submitting loop."""

    def __init__(self) -> None:
        # keyed per running LOOP OBJECT (weakly): futures and drainer tasks
        # are loop-bound, so a client driven from both the synchronizer loop
        # and a user's own asyncio loop must not share a batcher across them,
        # and a dead loop's batchers must neither leak nor be aliased by a
        # new loop reusing the freed address (id() keys would do both)
        import weakref

        self._by_loop: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def get(
        self,
        label: str,
        flush_fn: Callable[[list], Awaitable[list]],
        *,
        max_batch: int = 256,
        window_s: float = 0.0,
    ) -> MicroBatcher:
        loop = asyncio.get_running_loop()
        per_loop = self._by_loop.get(loop)
        if per_loop is None:
            per_loop = self._by_loop.setdefault(loop, {})
        b = per_loop.get(label)
        if b is None:
            b = per_loop[label] = MicroBatcher(
                flush_fn, max_batch=max_batch, window_s=window_s, label=label
            )
        return b
