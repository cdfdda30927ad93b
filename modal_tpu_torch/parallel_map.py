"""Streaming fan-out: .map()/.starmap()/.for_each()/.spawn_map() (port of
modal_tpu/parallel_map.py).

Reference: py/modal/parallel_map.py — `_map_invocation` (parallel_map.py:361)
with concurrent stages: input pump (`SyncInputPumper.pump_inputs`,
parallel_map.py:173-215, batched FunctionPutInputs), output stream or
long-poll (`get_all_outputs`, parallel_map.py:446-522, last_entry_id cursor),
blob fetch, ordered/unordered yield.

Failure story (reference parallel_map.py:241,793 + blob_utils.py:66):
- **Client-driven retries**: a failed output whose retry_count is under the
  function's retry policy is NOT yielded — a single timestamp-ordered
  retry-deadline heap (drained by ONE loop, batched re-submission via
  FunctionRetryInputs) re-submits the input after the policy's backoff
  delay. (Container crashes are retried server-side; this path covers
  user-code exceptions, exactly like the reference's TimestampPriorityQueue.)
- **Lost-input polling**: every LOST_INPUT_CHECK_PERIOD the client asks
  MapCheckInputs which unfinished idxs the server no longer tracks and
  re-pumps those (payloads for unfinished inputs are retained — bounded by
  the byte budget).
- **Byte-budgeted backpressure**: the pump admits at most
  DEFAULT_BYTE_BUDGET inflight serialized bytes / MAX_INPUTS_OUTSTANDING
  items; finished outputs release their input's budget.

Every input rides a per-map MicroBatcher (a ~1 ms linger, at most
MAP_INPUT_BATCH_SIZE a flush), as the JAX pump's do, so submission
pipelines with the generator; MODAL_TPU_DISPATCH_COALESCE=0 puts them in
batches of MAP_INPUT_BATCH_SIZE instead. A map goes through the input plane
(MapStartOrContinue / MapAwait, `_InputPlaneMapTransport`) when the client's
function would (`_Function._use_input_plane`), as the JAX client's does;
else through the control plane, where its outputs arrive on one
FunctionStreamOutputs stream, in process or over the plane's Unix socket
when the plane is local (_utils/local_transport.py).
"""

from __future__ import annotations

import asyncio
import heapq
import time
import typing

import grpc
import grpc.aio
from typing import Any, AsyncGenerator, AsyncIterable, Iterable, Optional, Union

from ._utils.async_utils import TaskContext, aclosing, synchronizer, sync_or_async_iter
from ._utils.blob_utils import _ByteBudget
from ._utils.function_utils import OUTPUTS_TIMEOUT
from ._utils.grpc_utils import retry_transient_errors
from .config import logger
from .exception import InvalidError
from .proto import api_pb2
from .retries import RetryManager

if typing.TYPE_CHECKING:
    from .functions import _Function, _FunctionCall

# Input pump batching (reference parallel_map.py:48-50: 8 retries, batched
# puts, RESOURCE_EXHAUSTED-aware).
MAP_INPUT_BATCH_SIZE = 100
MAX_INPUTS_OUTSTANDING = 1000
LOST_INPUT_CHECK_PERIOD = 30.0  # reference MapCheckInputs cadence

# server backpressure on input puts must back off, not kill the map: the
# puts retry this status beyond the transient set
_RESOURCE_EXHAUSTED = [grpc.StatusCode.RESOURCE_EXHAUSTED]


class _ControlPlaneMapTransport:
    """Default map wire path: FunctionMap / FunctionPutInputs /
    FunctionRetryInputs on the control plane; outputs arrive on ONE
    keep-alive FunctionStreamOutputs stream (pushed the instant the server
    appends them), degrading to the FunctionGetOutputs poll after repeated
    stream failures (docs/DISPATCH.md)."""

    MAX_STREAM_RESETS = 3

    def __init__(self, client, function_id: str):
        self.stub = client.stub
        self.function_id = function_id
        self._stream = None  # live FunctionStreamOutputs call
        self._stream_iter = None
        self._stream_resets = 0

    async def create_call(self, return_exceptions: bool) -> str:
        resp = await retry_transient_errors(
            self.stub.FunctionMap,
            api_pb2.FunctionMapRequest(
                function_id=self.function_id,
                function_call_type=api_pb2.FUNCTION_CALL_TYPE_MAP,
                invocation_type=api_pb2.FUNCTION_CALL_INVOCATION_TYPE_SYNC,
                return_exceptions=return_exceptions,
            ),
        )
        return resp.function_call_id

    async def put_batch(self, call_id: str, batch: list[api_pb2.FunctionPutInputsItem]) -> None:
        await retry_transient_errors(
            self.stub.FunctionPutInputs,
            api_pb2.FunctionPutInputsRequest(
                function_id=self.function_id, function_call_id=call_id, inputs=batch
            ),
            max_retries=8,
            max_delay=15.0,
            additional_status_codes=_RESOURCE_EXHAUSTED,
        )

    async def retry_inputs(
        self, call_id: str, entries: list[tuple[str, int, int, Optional[api_pb2.FunctionPutInputsItem]]]
    ) -> None:
        """Re-submit a batch of (input_id, retry_count, idx, item) entries in
        ONE RPC — the retry drainer pops every due deadline at once.
        Restart-sized retry window: a supervisor crash-recovery takes
        seconds, and a failed re-submission permanently hangs these inputs'
        slots in the map — ride out the outage like put_batch does."""
        await retry_transient_errors(
            self.stub.FunctionRetryInputs,
            api_pb2.FunctionRetryInputsRequest(
                function_call_jwt=call_id,
                inputs=[
                    api_pb2.FunctionRetryInputsItem(input_id=input_id, retry_count=retry_count)
                    for input_id, retry_count, _idx, _item in entries
                ],
            ),
            max_retries=8,
            max_delay=15.0,
        )

    def discard(self, idx: int) -> None:
        pass  # no per-input client state on the control plane

    def _stream_enabled(self) -> bool:
        return self._stream_resets < self.MAX_STREAM_RESETS

    async def close(self) -> None:
        if self._stream is not None:
            from .functions import _close_stream_call

            await _close_stream_call(self._stream)
            self._stream = self._stream_iter = None

    async def get_outputs(self, call_id: str, last_entry_id: str) -> tuple[list, str]:
        from .observability.catalog import OUTPUT_STREAM_EVENTS

        if self._stream_enabled():
            try:
                if self._stream_iter is None:
                    self._stream = self.stub.FunctionStreamOutputs(
                        api_pb2.FunctionGetOutputsRequest(
                            function_call_id=call_id,
                            timeout=OUTPUTS_TIMEOUT,
                            last_entry_id=last_entry_id,
                            max_values=0,
                            clear_on_success=False,
                            requested_at=time.time(),
                        )
                    )
                    self._stream_iter = self._stream.__aiter__()
                    OUTPUT_STREAM_EVENTS.inc(
                        event="open" if self._stream_resets == 0 else "reconnect"
                    )
                resp = await self._stream_iter.__anext__()
                OUTPUT_STREAM_EVENTS.inc(event="batch" if resp.outputs else "keepalive")
                return list(resp.outputs), resp.last_entry_id or last_entry_id
            except (grpc.aio.AioRpcError, StopAsyncIteration) as exc:
                # NOT_FOUND is real (call gone) — let the poll rung raise it
                # through the standard converter; everything else counts a
                # reset and reconnects (poll takes over past the budget)
                await self.close()
                self._stream_resets += 1
                OUTPUT_STREAM_EVENTS.inc(event="reset")
                code = exc.code() if isinstance(exc, grpc.aio.AioRpcError) else None
                if code == grpc.StatusCode.UNIMPLEMENTED:
                    self._stream_resets = self.MAX_STREAM_RESETS  # legacy server
                    OUTPUT_STREAM_EVENTS.inc(event="fallback")
                logger.debug(f"map output stream reset ({code}); rung retry/poll")
        resp = await retry_transient_errors(
            self.stub.FunctionGetOutputs,
            api_pb2.FunctionGetOutputsRequest(
                function_call_id=call_id,
                timeout=OUTPUTS_TIMEOUT,
                last_entry_id=last_entry_id,
                max_values=0,
                clear_on_success=False,
                requested_at=time.time(),
            ),
            attempt_timeout=OUTPUTS_TIMEOUT + 5.0,
            max_retries=None,
        )
        return list(resp.outputs), resp.last_entry_id or last_entry_id


class _InputPlaneMapTransport:
    """The input plane's map wire path (reference parallel_map.py:620):
    MapStartOrContinue / MapAwait with the plane's JWT. The attempt token of
    each item re-submits a failed attempt; blobs and MapCheckInputs stay on
    the control plane."""

    def __init__(self, client, ip_stub, function_id: str):
        self.client = client
        self.stub = ip_stub
        self.function_id = function_id
        self.token_by_idx: dict[int, str] = {}

    @staticmethod
    async def create_for(client, function_id: str) -> "_InputPlaneMapTransport":
        ip_stub = await client.get_stub(client.input_plane_url)
        return _InputPlaneMapTransport(client, ip_stub, function_id)

    async def _start_or_continue(
        self, call_id: str, items: list[api_pb2.MapStartOrContinueItem]
    ) -> str:
        metadata = await self.client.get_input_plane_metadata()
        resp = await retry_transient_errors(
            self.stub.MapStartOrContinue,
            api_pb2.MapStartOrContinueRequest(
                function_id=self.function_id, function_call_id=call_id, items=items
            ),
            max_retries=8,
            max_delay=15.0,
            additional_status_codes=_RESOURCE_EXHAUSTED,
            metadata=metadata,
        )
        for item, token in zip(items, resp.attempt_tokens):
            self.token_by_idx[item.input.idx] = token
        return resp.function_call_id

    async def create_call(self, return_exceptions: bool) -> str:
        return await self._start_or_continue("", [])

    async def put_batch(self, call_id: str, batch: list[api_pb2.FunctionPutInputsItem]) -> None:
        await self._start_or_continue(
            call_id, [api_pb2.MapStartOrContinueItem(input=item) for item in batch]
        )

    async def retry_inputs(
        self, call_id: str, entries: list[tuple[str, int, int, Optional[api_pb2.FunctionPutInputsItem]]]
    ) -> None:
        items = []
        for _input_id, _retry_count, idx, item in entries:
            if item is None:
                raise InvalidError(f"input-plane retry for idx {idx} lost its payload")
            items.append(
                api_pb2.MapStartOrContinueItem(input=item, attempt_token=self.token_by_idx.get(idx, ""))
            )
        await self._start_or_continue(call_id, items)

    def discard(self, idx: int) -> None:
        # a token is needed only while its input may be retried: the map
        # stays bounded by its outstanding window, not its size
        self.token_by_idx.pop(idx, None)

    async def close(self) -> None:
        pass  # MapAwait is unary; nothing persistent to release

    async def get_outputs(self, call_id: str, last_entry_id: str) -> tuple[list, str]:
        metadata = await self.client.get_input_plane_metadata()
        resp = await retry_transient_errors(
            self.stub.MapAwait,
            api_pb2.MapAwaitRequest(
                function_call_id=call_id,
                timeout=OUTPUTS_TIMEOUT,
                last_entry_id=last_entry_id,
                requested_at=time.time(),
            ),
            attempt_timeout=OUTPUTS_TIMEOUT + 5.0,
            max_retries=None,
            metadata=metadata,
        )
        return list(resp.outputs), resp.last_entry_id or last_entry_id


async def _map_invocation(
    function: "_Function",
    raw_input_gen: AsyncGenerator[tuple[tuple, dict], None],
    order_outputs: bool,
    return_exceptions: bool,
    *,
    function_call_id_out: Optional[list] = None,
    wait_for_outputs: bool = True,
) -> AsyncGenerator[Any, None]:
    """The core pipeline: create map call → pump inputs concurrently with
    polling outputs → yield results."""
    if not function.is_hydrated:
        await function.hydrate()
    client = function.client
    stub = client.stub

    if function._use_input_plane():
        transport: Any = await _InputPlaneMapTransport.create_for(client, function.object_id)
    else:
        transport = _ControlPlaneMapTransport(client, function.object_id)
    function_call_id = await transport.create_call(return_exceptions)
    if function_call_id_out is not None:
        function_call_id_out.append(function_call_id)

    # retry policy: user-code failures under max_retries are re-queued via
    # FunctionRetryInputs with backoff (reference retry-deadline queue,
    # parallel_map.py:241). Container crashes retry server-side.
    retry_proto = None
    if function._spec is not None:
        retry_proto = function._spec.retry_policy_proto()
    max_retries = retry_proto.retries if retry_proto is not None else 0
    retry_mgr = RetryManager(retry_proto) if retry_proto is not None else None

    pump_done = asyncio.Event()
    inputs_sent = 0
    # unfinished inputs: idx -> (item, nbytes). Bounded by the byte budget;
    # needed for retries (input_id comes back on the failed output) and for
    # lost-input re-pump.
    unfinished: dict[int, tuple[api_pb2.FunctionPutInputsItem, int]] = {}
    finalized: set[int] = set()
    pending_retries = 0
    retry_errors: list[BaseException] = []
    # backpressure only applies when outputs are consumed — spawn_map never
    # polls outputs, so nothing would ever release the budget
    budget = _ByteBudget(max_items=MAX_INPUTS_OUTSTANDING) if wait_for_outputs else None

    async def _put_batch(batch: list[api_pb2.FunctionPutInputsItem]) -> None:
        await transport.put_batch(function_call_id, batch)

    async def pump_inputs() -> None:
        """Submit side: every input rides a per-map MicroBatcher (a ~1 ms
        linger, at most MAP_INPUT_BATCH_SIZE a flush), so a 1k-input map
        sends a bounded number of PutInputs however the producer trickles.
        With MODAL_TPU_DISPATCH_COALESCE=0 inputs go out in batches of
        MAP_INPUT_BATCH_SIZE (a flush also happens before the byte budget
        would block, so inflight inputs can produce outputs and release
        it)."""
        nonlocal inputs_sent
        from ._utils.coalescer import MicroBatcher, coalescing_enabled
        from .functions import _create_input

        async def _flush_items(items: list[api_pb2.FunctionPutInputsItem]) -> list:
            nonlocal inputs_sent
            await _put_batch(items)
            inputs_sent += len(items)
            return [None] * len(items)

        batcher = (
            MicroBatcher(_flush_items, max_batch=MAP_INPUT_BATCH_SIZE, window_s=0.001, label="FunctionPutInputs")
            if coalescing_enabled()
            else None
        )
        batch: list[api_pb2.FunctionPutInputsItem] = []
        # in-flight coalesced submits, awaited in windows: a flush error
        # surfaces promptly, and a huge map never holds a future per input
        submits: list[asyncio.Task] = []

        async def _reap_submits(limit: int) -> None:
            while len(submits) > limit:
                await submits.pop(0)

        async def _flush() -> None:
            nonlocal batch, inputs_sent
            if not batch:
                return
            await _put_batch(batch)
            inputs_sent += len(batch)
            batch = []

        idx = 0
        try:
            async with aclosing(raw_input_gen) as gen:
                async for args, kwargs in gen:
                    item = await _create_input(
                        args,
                        kwargs,
                        stub,
                        idx=idx,
                        method_name=function._use_method_name,
                        data_format=function._data_format,
                    )
                    nbytes = len(item.input.args) if item.input.WhichOneof("args_oneof") == "args" else 64
                    if budget is not None:
                        if batcher is None and batch and budget.would_block(nbytes):
                            # an unflushed local batch can't drain: flush
                            # first so inflight inputs can release budget
                            # (the batcher's drainer flushes on its own)
                            await _flush()
                        await budget.acquire(nbytes)
                        unfinished[idx] = (item, nbytes)
                    if batcher is not None:
                        submits.append(asyncio.ensure_future(batcher.submit(item)))
                        await _reap_submits(4 * MAP_INPUT_BATCH_SIZE)
                    else:
                        batch.append(item)
                        if len(batch) >= MAP_INPUT_BATCH_SIZE:
                            await _flush()
                    idx += 1
            await _flush()
            await _reap_submits(0)
        except BaseException:
            for t in submits:
                t.cancel()
            raise
        finally:
            # always unblock the poll loop: on a pump failure it drains what
            # was sent, then `await pump_task` surfaces the error instead of
            # the caller hanging in the output wait
            pump_done.set()

    async def _finalize(idx: int) -> None:
        finalized.add(idx)
        transport.discard(idx)
        entry = unfinished.pop(idx, None)
        if entry is not None and budget is not None:
            await budget.release(entry[1])

    # Retry-deadline queue: ONE timestamp-ordered heap drained by ONE loop
    # (reference TimestampPriorityQueue, parallel_map.py:241-260), not a
    # timer task per retried input.
    retry_heap: list[tuple[float, int, str, int, int]] = []  # (due, seq, input_id, count, idx)
    retry_wakeup = asyncio.Event()
    retry_seq = 0

    def _schedule_retry(item: api_pb2.FunctionGetOutputsItem) -> None:
        nonlocal pending_retries, retry_seq
        pending_retries += 1
        next_count = item.retry_count + 1
        # jittered: a preempted worker requeues many inputs at once — their
        # retries must spread instead of re-arriving as one synchronized wave
        delay = retry_mgr.attempt_delay(next_count, jitter=True) if retry_mgr is not None else 0.0
        retry_seq += 1
        heapq.heappush(
            retry_heap, (time.monotonic() + delay, retry_seq, item.input_id, next_count, item.idx)
        )
        retry_wakeup.set()

    async def drain_retries() -> None:
        """The single drainer: sleep to the earliest deadline, pop everything
        due, re-submit as one batched RPC per transport call."""
        nonlocal pending_retries
        while True:
            if not retry_heap:
                retry_wakeup.clear()
                await retry_wakeup.wait()
                continue
            now = time.monotonic()
            due_at = retry_heap[0][0]
            if due_at > now:
                # a new earlier deadline re-arms the wait via the event
                retry_wakeup.clear()
                try:
                    await asyncio.wait_for(retry_wakeup.wait(), timeout=due_at - now)
                except asyncio.TimeoutError:
                    pass
                continue
            batch: list[tuple[str, int, int, Optional[api_pb2.FunctionPutInputsItem]]] = []
            while retry_heap and retry_heap[0][0] <= now and len(batch) < MAP_INPUT_BATCH_SIZE:
                _due, _seq, input_id, count, idx = heapq.heappop(retry_heap)
                entry = unfinished.get(idx)
                batch.append((input_id, count, idx, entry[0] if entry else None))
            try:
                await transport.retry_inputs(function_call_id, batch)
            except BaseException as exc:  # noqa: BLE001
                # a failed re-submission means these inputs will never
                # produce another output — surface it instead of hanging
                retry_errors.append(exc)
                return
            finally:
                pending_retries -= len(batch)

    async def check_lost_inputs() -> None:
        """Periodic MapCheckInputs: re-pump inputs the server forgot
        (reference parallel_map.py:793)."""
        while True:
            await asyncio.sleep(LOST_INPUT_CHECK_PERIOD)
            idxs = [i for i in unfinished.keys() if i not in finalized]
            if not idxs:
                continue
            try:
                resp = await retry_transient_errors(
                    stub.MapCheckInputs,
                    api_pb2.MapCheckInputsRequest(function_call_id=function_call_id, idxs=idxs),
                )
            except Exception as exc:  # noqa: BLE001 — advisory check
                logger.debug(f"MapCheckInputs failed: {exc}")
                continue
            lost = [unfinished[i][0] for i in resp.lost_idxs if i in unfinished]
            if lost:
                logger.warning(f"re-submitting {len(lost)} lost map inputs")
                await _put_batch(lost)

    async def poll_outputs() -> AsyncGenerator[tuple[int, Any], None]:
        last_entry_id = ""
        while True:
            outputs, last_entry_id = await transport.get_outputs(function_call_id, last_entry_id)
            for item in outputs:
                if item.idx in finalized:
                    continue  # stale output from a retried attempt
                retryable = (
                    item.result.status
                    in (api_pb2.GENERIC_STATUS_FAILURE, api_pb2.GENERIC_STATUS_INTERNAL_FAILURE)
                    and item.retry_count < max_retries
                )
                if retryable:
                    _schedule_retry(item)
                    continue
                await _finalize(item.idx)
                value = await _decode_output(item, stub, client, return_exceptions)
                yield item.idx, value
            if retry_errors:
                raise retry_errors[0]
            if pump_done.is_set() and len(finalized) >= inputs_sent and pending_retries == 0 and not unfinished:
                return
            if pump_task.done() and pump_task.exception() is not None:
                raise pump_task.exception()

    async with TaskContext() as tc:
        pump_task = tc.create_task(pump_inputs())
        if not wait_for_outputs:
            await pump_task
            return
        checker_task = tc.create_task(check_lost_inputs())
        retry_task = tc.create_task(drain_retries())
        try:
            if order_outputs:
                buffer: dict[int, Any] = {}
                next_idx = 0
                async for idx, value in poll_outputs():
                    buffer[idx] = value
                    while next_idx in buffer:
                        yield buffer.pop(next_idx)
                        next_idx += 1
            else:
                async for _idx, value in poll_outputs():
                    yield value
        finally:
            checker_task.cancel()
            retry_task.cancel()
            await transport.close()  # release the output stream, if any
        # surface pump errors (e.g. serialization failures)
        await pump_task


async def _decode_output(
    item: api_pb2.FunctionGetOutputsItem, stub, client, return_exceptions: bool
) -> Any:
    from .functions import _process_result

    try:
        return await _process_result(item.result, item.data_format, stub, client)
    except Exception as exc:
        if return_exceptions:
            return exc
        raise


async def _input_gen_from_iterators(
    *input_iterators: Union[Iterable, AsyncIterable], kwargs: dict, star: bool
) -> AsyncGenerator[tuple[tuple, dict], None]:
    if star:
        assert len(input_iterators) == 1
        async for item in sync_or_async_iter(input_iterators[0]):
            if not isinstance(item, (tuple, list)):
                item = (item,)
            yield tuple(item), kwargs
    elif len(input_iterators) == 1:
        async for item in sync_or_async_iter(input_iterators[0]):
            yield (item,), kwargs
    else:
        # zip semantics over multiple iterators (like builtin map)
        iters = [sync_or_async_iter(it) for it in input_iterators]
        while True:
            args = []
            for it in iters:
                try:
                    args.append(await it.__anext__())
                except StopAsyncIteration:
                    return
            yield tuple(args), kwargs


def _map_sync(
    function: "_Function",
    *input_iterators: Iterable,
    kwargs: dict = {},
    order_outputs: bool = True,
    return_exceptions: bool = False,
) -> typing.Generator[Any, None, None]:
    """Blocking .map() — a sync generator bridged off the synchronizer loop."""
    gen = _map_invocation(
        function,
        _input_gen_from_iterators(*input_iterators, kwargs=kwargs, star=False),
        order_outputs,
        return_exceptions,
    )
    return synchronizer.run_generator(gen)


async def _map_async(
    function: "_Function",
    *input_iterators: Union[Iterable, AsyncIterable],
    kwargs: dict = {},
    order_outputs: bool = True,
    return_exceptions: bool = False,
) -> AsyncGenerator[Any, None]:
    async for item in _map_invocation(
        function,
        _input_gen_from_iterators(*input_iterators, kwargs=kwargs, star=False),
        order_outputs,
        return_exceptions,
    ):
        yield item


def _starmap_sync(
    function: "_Function",
    input_iterator: Iterable,
    *,
    kwargs: dict = {},
    order_outputs: bool = True,
    return_exceptions: bool = False,
) -> typing.Generator[Any, None, None]:
    gen = _map_invocation(
        function,
        _input_gen_from_iterators(input_iterator, kwargs=kwargs, star=True),
        order_outputs,
        return_exceptions,
    )
    return synchronizer.run_generator(gen)


def _for_each_sync(function: "_Function", *input_iterators: Iterable, kwargs: dict = {}, ignore_exceptions: bool = False) -> None:
    for _ in _map_sync(
        function,
        *input_iterators,
        kwargs=kwargs,
        order_outputs=False,
        return_exceptions=ignore_exceptions,
    ):
        pass


async def _spawn_map_async(function: "_Function", *input_iterators, kwargs: dict = {}) -> "_FunctionCall":
    """Pump all inputs, return a detached FunctionCall without waiting."""
    from .functions import _FunctionCall

    call_id_out: list = []
    async for _ in _map_invocation(
        function,
        _input_gen_from_iterators(*input_iterators, kwargs=kwargs, star=False),
        order_outputs=False,
        return_exceptions=False,
        function_call_id_out=call_id_out,
        wait_for_outputs=False,
    ):
        pass
    return _FunctionCall._new_hydrated(call_id_out[0], function.client, None)
