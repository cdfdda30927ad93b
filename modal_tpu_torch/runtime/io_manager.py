"""ContainerIOManager: heartbeats, input loop, batching, concurrency, outputs
(port of modal_tpu/runtime/io_manager.py).

Reference: py/modal/_runtime/container_io_manager.py — `_ContainerIOManager`
(container_io_manager.py:463), heartbeat/cancellation loop
(container_io_manager.py:577-643), `_generate_inputs` input fetch loop
(container_io_manager.py:788-843), `InputSlots` (container_io_manager.py:417),
`IOContext` batch assembly (container_io_manager.py:55,145-211), output
batching ≤20/RPC (container_io_manager.py:870-885).

Outputs go through the port's `serialize_payload`: a CUDA tensor leaves the
card out of band through pinned staging, and a payload over 2 MiB goes to
the blob store. The heartbeat pushes the container's device and compile
telemetry. Claims and outputs coalesce as the JAX manager's do: a container
with N free concurrency slots asks for up to N inputs in one long-poll, and
outputs of concurrent inputs finishing within one window share one
FunctionPutOutputs (`_utils/coalescer.py`; off with
MODAL_TPU_DISPATCH_COALESCE=0). The heartbeat's answer carries the plane's
profiling command (ProfileControl), which the container applies to its own
sampling profiler (observability/profiler.py).
"""

from __future__ import annotations

import asyncio
import os
import time
from dataclasses import dataclass
from typing import Any, AsyncGenerator, Optional

from .._utils.async_utils import ConcurrencySemaphore
from .._utils.blob_utils import MAX_OBJECT_SIZE_BYTES, blob_upload
from .._utils.grpc_utils import retry_transient_errors
from ..client import _Client
from ..config import config, logger
from ..exception import InputCancellation
from ..observability import tracing
from ..proto import api_pb2
from ..serialization import deserialize, serialize_exception, serialize_payload_data_format

MAX_OUTPUT_BATCH_SIZE = 20  # reference container_io_manager.py:874


@dataclass
class IOContext:
    """One unit of user work: a single input, or a batch of inputs assembled
    for a @batched function (reference IOContext, container_io_manager.py:55)."""

    input_ids: list[str]
    function_call_ids: list[str]
    idxs: list[int]
    retry_counts: list[int]
    inputs: list[tuple[tuple, dict]]  # deserialized (args, kwargs) per input
    method_name: str = ""
    # per-input wire format (pickle/cbor), echoed on results so a CBOR
    # caller gets a CBOR answer (reference _serialization.py:359)
    data_format: int = 0  # api_pb2.DATA_FORMAT_* (0 = unspecified -> pickle)
    # server claim stamp (FunctionGetInputsItem.claimed_at; response-arrival
    # fallback): the container.input_deliver span starts here, covering the
    # claim→execute hop (delivery + args deserialize + runner spawn)
    fetched_at: float = 0.0
    _cancelled: bool = False

    @property
    def is_batch(self) -> bool:
        return len(self.input_ids) > 1

    def batched_args_kwargs(self) -> tuple[tuple, dict]:
        """Assemble per-parameter lists for @batched functions (reference
        _args_and_kwargs, container_io_manager.py:145-211): each positional/
        keyword argument becomes a list with one element per input."""
        if not self.is_batch:
            return self.inputs[0]
        n_args = max(len(a) for a, _ in self.inputs)
        args_lists: list[list] = [[] for _ in range(n_args)]
        kwargs_lists: dict[str, list] = {}
        all_keys: set[str] = set()
        for _, kw in self.inputs:
            all_keys.update(kw.keys())
        for a, kw in self.inputs:
            for i in range(n_args):
                args_lists[i].append(a[i] if i < len(a) else None)
            for k in all_keys:
                kwargs_lists.setdefault(k, []).append(kw.get(k))
        return tuple(args_lists), kwargs_lists


class ContainerIOManager:
    """Process-singleton owning the container's data plane."""

    _singleton: Optional["ContainerIOManager"] = None

    def __init__(self, client: _Client, task_id: str, function_def: api_pb2.Function):
        self.client = client
        self.stub = client.stub
        self.task_id = task_id
        self.function_def = function_def
        self.current_input_ids: set[str] = set()
        self.cancelled_input_ids: set[str] = set()
        self._running_tasks: dict[str, asyncio.Task] = {}
        # input_id -> main-thread executor job (sync inputs only): cancelled
        # via SIGUSR1 instead of task.cancel (container_entrypoint._call_sync)
        self._mt_jobs: dict[str, Any] = {}
        self.terminate = False
        # preemption resume plumbing (execution_context.resume_token /
        # set_resume_token): tokens redelivered WITH inputs, and tokens user
        # code recorded for in-flight inputs (flushed on preempt)
        self.delivered_resume_tokens: dict[str, str] = {}
        self.recorded_resume_tokens: dict[str, str] = {}
        # distributed tracing: per-input trace context delivered on
        # FunctionGetInputsItem.trace_context — the container's user.execute
        # span parents there so the input stitches into the caller's trace
        self.input_trace_contexts: dict[str, str] = {}
        max_conc = function_def.max_concurrent_inputs or 1
        self.input_slots = ConcurrencySemaphore(max_conc)
        self.average_call_time = 0.0
        self._calls_completed = 0
        # merged-turnaround exchange: outputs finishing
        # while the input loop is PARKED on a slot ride the next claim as
        # one FunctionExchange; outputs finishing mid-long-poll go direct
        # (they must not wait out a 10s claim window)
        self._pending_exchange: list[api_pb2.FunctionPutOutputsItem] = []
        self._poll_in_flight = False
        self._executed_an_input = False  # the first input is the cold call
        self._out_batcher = None  # the coalesced FunctionPutOutputs plane
        ContainerIOManager._singleton = self

    @classmethod
    def singleton(cls) -> Optional["ContainerIOManager"]:
        return cls._singleton

    # -- heartbeats ---------------------------------------------------------

    async def heartbeat_loop(self) -> None:
        """Heartbeat doubles as the cancellation channel (reference
        container_io_manager.py:577-643) — and as the telemetry and
        profiling plane: each beat pushes the container's device/compile
        metric families up (ContainerHeartbeatRequest.telemetry_json) and
        applies the plane's profiling command coming back down."""
        from ..observability import device_telemetry, profiler

        interval = float(config["heartbeat_interval"]) / 3
        while not self.terminate:
            try:
                resp = await retry_transient_errors(
                    self.stub.ContainerHeartbeat,
                    api_pb2.ContainerHeartbeatRequest(
                        task_id=self.task_id,
                        supports_graceful_input_cancellation=True,
                        telemetry_json=device_telemetry.container_report(),
                    ),
                    attempt_timeout=10.0,
                    max_retries=2,
                )
                if resp.profile_command:
                    profiler.apply_command(
                        resp.profile_command, os.environ.get(profiler.PROFILE_DIR_ENV, ""), tag=self.task_id
                    )
                if resp.HasField("cancel_input_event"):
                    event = resp.cancel_input_event
                    if event.terminate_containers:
                        self.terminate = True
                    if event.input_ids:
                        self._cancel_inputs(set(event.input_ids))
            except asyncio.CancelledError:
                return
            except Exception as exc:
                logger.warning(f"heartbeat failed: {type(exc).__name__}: {exc}")
            await asyncio.sleep(max(1.0, interval))

    def _cancel_inputs(self, input_ids: set[str]) -> None:
        """Cancel running/pending inputs (reference IOContext.cancel,
        _container_entrypoint.py:194-264): sync inputs on the main-thread
        executor get SIGUSR1 → InputCancellation raised INSIDE the running
        frame (interrupts even a blocking time.sleep); everything else gets
        asyncio task cancellation. A delayed task.cancel backstops the signal
        path in case user code swallows BaseException and keeps running."""
        from .main_thread_exec import get_executor

        executor = get_executor()
        loop = asyncio.get_running_loop()
        for input_id in input_ids:
            job = self._mt_jobs.get(input_id)
            task = self._running_tasks.get(input_id)
            if job is not None and executor is not None:
                logger.debug(f"cancelling sync input {input_id} via SIGUSR1")
                executor.cancel(job)
                if task is not None:
                    loop.call_later(5.0, task.cancel)  # no-op if already done
            elif task is not None:
                logger.debug(f"cancelling input {input_id}")
                task.cancel()
        self.cancelled_input_ids |= input_ids

    # -- input loop ---------------------------------------------------------

    async def _assemble_context(self, items: list) -> IOContext:
        """Deserialize a claimed item group (blob-aware) into one IOContext."""
        # delivery-span anchor: the server's claim stamp when carried
        # (claim→execute is exactly the delivery hop); a server that
        # predates the field falls back to response arrival — never
        # the time the poll was sent, which in steady state predates the
        # call itself and would swallow the client's prep/RPC window
        claim_stamps = [i.claimed_at for i in items if i.claimed_at > 0]
        fetched_at = min(claim_stamps) if claim_stamps else time.time()
        ctx_inputs: list[tuple[tuple, dict]] = []
        method_name = ""
        ctx_format = api_pb2.DATA_FORMAT_PICKLE
        for item in items:
            raw = item.input.args
            if item.input.args_blob_id:
                from .._utils.blob_utils import blob_download

                # large args spill to disk and arrive as an
                # mmap-backed view: the container never holds the
                # serialized payload AND its deserialized tensors as
                # two anonymous-RSS copies (tensors alias the mmap)
                raw = await blob_download(item.input.args_blob_id, self.stub)
            fmt = item.input.data_format or api_pb2.DATA_FORMAT_PICKLE
            if not raw:
                args, kwargs = (), {}
            elif fmt == api_pb2.DATA_FORMAT_CBOR:
                # cross-language convention: [args array, kwargs map]
                from ..serialization import deserialize_data_format

                payload = deserialize_data_format(raw, fmt, self.client)
                args, kwargs = tuple(payload[0]), dict(payload[1])
            else:
                args, kwargs = deserialize(raw, self.client)
            ctx_inputs.append((args, kwargs))
            method_name = item.input.method_name or method_name
            ctx_format = fmt
        ctx = IOContext(
            input_ids=[i.input_id for i in items],
            function_call_ids=[i.function_call_id for i in items],
            idxs=[i.idx for i in items],
            retry_counts=[i.retry_count for i in items],
            inputs=ctx_inputs,
            method_name=method_name,
            data_format=ctx_format,
            fetched_at=fetched_at,
        )
        for item in items:
            if item.resume_token:
                self.delivered_resume_tokens[item.input_id] = item.resume_token
            if item.trace_context:
                self.input_trace_contexts[item.input_id] = item.trace_context
        self.current_input_ids |= set(ctx.input_ids)
        return ctx

    async def generate_inputs(self) -> AsyncGenerator[IOContext, None]:
        """The hot loop: acquire a slot → FunctionExchange (long-poll) →
        assemble IOContext (reference _generate_inputs,
        container_io_manager.py:788-843). Exits on kill_switch or after
        scaledown_window idle.

        Coalesced claim: with N free concurrency slots, ONE long-poll asks
        for up to N inputs and splits the response into per-input
        IOContexts. @batched functions keep their batch assembly (one ctx
        per fetch)."""
        from .._utils.coalescer import coalescing_enabled

        scaledown = self.function_def.autoscaler_settings.scaledown_window or 60
        batch_max = self.function_def.batch_max_size or 1
        is_batched = (self.function_def.batch_max_size or 0) > 1
        idle_since = time.monotonic()
        while not self.terminate:
            await self.input_slots.acquire()
            slots_held = 1
            try:
                if not is_batched and coalescing_enabled():
                    # soak up every currently free slot, so the server can
                    # hand over a whole group in one response
                    while slots_held < self.input_slots.value and self.input_slots.try_acquire():
                        slots_held += 1
                request = api_pb2.FunctionGetInputsRequest(
                    function_id="",  # filled below; def carries no id — use env
                    task_id=self.task_id,
                    max_values=batch_max if is_batched else slots_held,
                    average_call_time=self.average_call_time,
                    input_concurrency=self.input_slots.value,
                    batch_max_size=self.function_def.batch_max_size,
                    batch_linger_ms=self.function_def.batch_linger_ms,
                )
                request.function_id = self._function_id
                resp = await self._claim(request)
                if resp.rate_limit_sleep_duration:
                    await asyncio.sleep(resp.rate_limit_sleep_duration)
                items = [i for i in resp.inputs]
                if any(i.kill_switch for i in items):
                    logger.debug("kill switch received; draining")
                    self.terminate = True
                    return
                if not items:
                    if (
                        time.monotonic() - idle_since > scaledown
                        and not self.current_input_ids
                        and not resp.scaledown_blocked
                    ):
                        logger.debug(f"idle for {scaledown}s; scaling down")
                        return
                    continue
                idle_since = time.monotonic()
                if is_batched:
                    groups = [items]  # one ctx: the @batched user call
                else:
                    groups = [[item] for item in items]  # one ctx per input
                for group in groups:
                    try:
                        ctx = await self._assemble_context(group)
                    except Exception as exc:  # noqa: BLE001 — poison input
                        # a poison payload fails its own group and the loop
                        # keeps going
                        logger.warning(
                            f"input assembly failed for {[i.input_id for i in group]}: {exc}"
                        )
                        await self._fail_assembly(group, exc)
                        self.input_slots.release()
                        slots_held -= 1
                        continue
                    slots_held -= 1  # transferred to the runner
                    yield ctx
            finally:
                for _ in range(max(0, slots_held)):
                    self.input_slots.release()
                slots_held = 0

    _function_id: str = ""

    async def _claim(self, request: api_pb2.FunctionGetInputsRequest):
        """One claim long-poll, as a FunctionExchange (PutOutputs + GetInputs
        in one turnaround): any outputs stashed by `push_outputs` while the
        loop was parked ride the same RPC."""
        put_items, self._pending_exchange = self._pending_exchange, []
        ex_req = api_pb2.FunctionExchangeRequest(get=request)
        if put_items:
            ex_req.put.CopyFrom(api_pb2.FunctionPutOutputsRequest(outputs=put_items, task_id=self.task_id))
        self._poll_in_flight = True
        try:
            # carried-payload accounting (with_outputs | claim_only) happens
            # server-side in services.FunctionExchange
            return await retry_transient_errors(
                self.stub.FunctionExchange, ex_req, attempt_timeout=15.0, max_retries=None
            )
        except Exception:
            # the stash must survive this claim attempt: the retried poll (or
            # the exit flush) delivers it; dropping it would force the inputs
            # through lease-expiry re-execution
            self._pending_exchange[:0] = put_items
            raise
        finally:
            self._poll_in_flight = False

    async def _put_outputs_direct(self, items: list[api_pb2.FunctionPutOutputsItem]) -> None:
        for start in range(0, len(items), MAX_OUTPUT_BATCH_SIZE):
            await retry_transient_errors(
                self.stub.FunctionPutOutputs,
                api_pb2.FunctionPutOutputsRequest(
                    outputs=items[start : start + MAX_OUTPUT_BATCH_SIZE], task_id=self.task_id
                ),
                max_retries=None,
                additional_status_codes=[],
            )

    async def flush_pending_exchange(self) -> None:
        """Drain outputs stashed for the next exchange when no next poll is
        coming (terminate/scaledown exit) — delivery must not die with the
        loop."""
        if self._pending_exchange:
            items, self._pending_exchange = self._pending_exchange, []
            await self._put_outputs_direct(items)

    async def _fail_assembly(self, items: list, exc: BaseException) -> None:
        """Report an assembly (deserialize/blob-fetch) failure for one
        claimed group as that group's result."""
        result = self.format_exception(exc)
        await retry_transient_errors(
            self.stub.FunctionPutOutputs,
            api_pb2.FunctionPutOutputsRequest(
                outputs=[
                    api_pb2.FunctionPutOutputsItem(
                        input_id=i.input_id,
                        result=result,
                        idx=i.idx,
                        function_call_id=i.function_call_id,
                        data_format=result.data_format,
                        output_created_at=time.time(),
                        retry_count=i.retry_count,
                    )
                    for i in items
                ],
                task_id=self.task_id,
            ),
            max_retries=None,
            additional_status_codes=[],
        )

    # -- outputs ------------------------------------------------------------

    async def _flush_output_batch(self, items: list[api_pb2.FunctionPutOutputsItem]) -> list:
        """One coalesced FunctionPutOutputs flush (at most
        MAX_OUTPUT_BATCH_SIZE items by construction). The server dedupes by
        (input_id, retry_count) and group-commits the batch's journal
        records, so regrouping outputs across inputs cannot deliver twice."""
        await self._put_outputs_direct(items)
        return [None] * len(items)

    async def push_outputs(self, ctx: IOContext, results: list[api_pb2.GenericResult]) -> None:
        from .._utils.coalescer import coalescing_enabled

        items = []
        for i, result in enumerate(results):
            items.append(
                api_pb2.FunctionPutOutputsItem(
                    input_id=ctx.input_ids[i],
                    result=result,
                    idx=ctx.idxs[i],
                    function_call_id=ctx.function_call_ids[i],
                    data_format=result.data_format,
                    output_created_at=time.time(),
                    retry_count=ctx.retry_counts[i],
                )
            )
        if (
            not self._poll_in_flight
            and not self.terminate
            # the piggyback stays one well-formed output batch; overflow
            # (many concurrent inputs finishing in one park window) takes
            # the direct paths below rather than building an oversized RPC
            and len(self._pending_exchange) + len(items) <= MAX_OUTPUT_BATCH_SIZE
        ):
            # the input loop is parked on slot acquire (not mid-long-poll):
            # these outputs ride the NEXT claim as one FunctionExchange —
            # the slot release below is exactly what unblocks that claim, so
            # publication happens at the head of the next poll instead of as
            # its own round trip. Mid-poll finishes fall through to the
            # direct paths (delivery must not wait out a 10s claim window).
            self._pending_exchange.extend(items)
        elif coalescing_enabled():
            # coalesced publication: concurrent inputs finishing within one
            # window share one RPC; the submit still completes before the
            # slot is released, so delivery stays on the critical path
            if self._out_batcher is None:
                from .._utils.coalescer import MicroBatcher

                self._out_batcher = MicroBatcher(
                    self._flush_output_batch, max_batch=MAX_OUTPUT_BATCH_SIZE, label="FunctionPutOutputs"
                )
            await asyncio.gather(*(self._out_batcher.submit(item) for item in items))
        else:
            await self._put_outputs_direct(items)
        self.current_input_ids -= set(ctx.input_ids)
        for iid in ctx.input_ids:
            self.delivered_resume_tokens.pop(iid, None)
            self.recorded_resume_tokens.pop(iid, None)
            self.input_trace_contexts.pop(iid, None)
        self.input_slots.release()

    # -- preemption checkpoint flush ----------------------------------------

    async def flush_resume_tokens(self) -> int:
        """Preempt hook (container_entrypoint): push every in-flight input's
        recorded resume token to the control plane so the requeued attempt is
        redelivered with it. Returns the number flushed. Bounded retries —
        the grace window is ticking."""
        async def _flush_one(input_id: str, token: str) -> bool:
            try:
                await retry_transient_errors(
                    self.stub.ContainerCheckpoint,
                    api_pb2.ContainerCheckpointRequest(
                        task_id=self.task_id, input_id=input_id, resume_token=token
                    ),
                    max_retries=2,
                    attempt_timeout=5.0,
                )
                return True
            except Exception as exc:
                logger.warning(f"resume-token flush failed for {input_id}: {exc}")
                return False

        # concurrent: sequential flushes would sum per-input retry time and
        # blow the caller's grace-window budget, silently dropping the tail
        pending = [
            (iid, self.recorded_resume_tokens.get(iid, ""))
            for iid in list(self.current_input_ids)
        ]
        results = await asyncio.gather(
            *(_flush_one(iid, token) for iid, token in pending if token)
        )
        flushed = sum(results)
        if flushed:
            logger.warning(f"preempt: flushed {flushed} resume token(s)")
        return flushed

    async def format_result(self, value: Any, data_format: int = api_pb2.DATA_FORMAT_PICKLE) -> api_pb2.GenericResult:
        # zero-copy: tensor results serialize as out-of-band segments (a
        # CUDA tensor through pinned staging) and a large payload streams to
        # the blob store without a join
        payload = serialize_payload_data_format(value, data_format)
        result = api_pb2.GenericResult(status=api_pb2.GENERIC_STATUS_SUCCESS, data_format=data_format)
        if payload.nbytes > MAX_OBJECT_SIZE_BYTES:
            # the upload of the result, by the rung it took (the handoff by
            # path beside the store, else HTTP), as a span of the input
            rungs = getattr(self.stub, "rungs", None)
            before = rungs["BlobUpload:blob_local"] if rungs is not None else 0
            t0 = time.time()
            result.data_blob_id = await blob_upload(payload, self.stub)
            local = rungs is not None and rungs["BlobUpload:blob_local"] > before
            tracing.record_span("container.blob_upload", start=t0, end=time.time(),
                                attrs={"task_id": self.task_id, "bytes": payload.nbytes,
                                       "rung": "blob_local" if local else "http"})
        else:
            result.data = payload.join()
        return result

    def format_exception(self, exc: BaseException) -> api_pb2.GenericResult:
        if isinstance(exc, (asyncio.CancelledError, InputCancellation)):
            return api_pb2.GenericResult(
                status=api_pb2.GENERIC_STATUS_TERMINATED, exception="input cancelled"
            )
        data, exc_repr, tb_str, serialized_tb = serialize_exception(exc)
        return api_pb2.GenericResult(
            status=api_pb2.GENERIC_STATUS_FAILURE,
            exception=exc_repr,
            traceback=tb_str,
            serialized_tb=serialized_tb,
            data=data,
            data_format=api_pb2.DATA_FORMAT_PICKLE,
        )

    async def push_generator_data(self, function_call_id: str, value: Any) -> None:
        payload = serialize_payload_data_format(value, api_pb2.DATA_FORMAT_PICKLE)
        chunk = api_pb2.DataChunk(data_format=api_pb2.DATA_FORMAT_PICKLE)
        if payload.nbytes > MAX_OBJECT_SIZE_BYTES:
            chunk.data_blob_id = await blob_upload(payload, self.stub)
        else:
            chunk.data = payload.join()
        await retry_transient_errors(
            self.stub.FunctionCallPutData,
            api_pb2.FunctionCallPutDataRequest(function_call_id=function_call_id, data_chunks=[chunk]),
        )

    async def push_generator_done(self, function_call_id: str, items_total: int) -> None:
        done = api_pb2.GeneratorDone(items_total=items_total)
        chunk = api_pb2.DataChunk(
            data_format=api_pb2.DATA_FORMAT_GENERATOR_DONE, data=done.SerializeToString()
        )
        await retry_transient_errors(
            self.stub.FunctionCallPutData,
            api_pb2.FunctionCallPutDataRequest(function_call_id=function_call_id, data_chunks=[chunk]),
        )

    def note_call_time(self, dt: float) -> None:
        self._calls_completed += 1
        alpha = 1.0 / min(self._calls_completed, 100)
        self.average_call_time = (1 - alpha) * self.average_call_time + alpha * dt
