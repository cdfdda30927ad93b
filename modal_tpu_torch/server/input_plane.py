"""The input plane: the invocation data plane with JWT auth (port of
modal_tpu/server/input_plane.py).

The reference routes latency-sensitive invocations through a regional input
plane that speaks AttemptStart/AttemptAwait/AttemptRetry (single calls,
reference _functions.py:394) and MapStartOrContinue/MapAwait (maps,
reference parallel_map.py:620), authenticated with a refreshing JWT
(_utils/auth_token_manager.py). This is its serving half: a lean gRPC
service on its own port and Unix socket that shares the control plane's
state and checks the JWT of `AuthTokenGet` on every RPC. Here it runs in the
control plane's process, so what it exercises is the wire contract, the
JWT, the re-dispatch of a lost input and the client's choice of plane, not
region locality.

An attempt token is a server-minted id that maps to (function_call_id,
input_id) and is journaled (`attempt` records), so a client awaiting an
attempt across a crash_restart resumes; a retry requeues the same input and
mints a fresh token that supersedes the old one.
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Optional

import grpc

from .._utils.jwt_utils import verify_jwt
from ..config import logger
from ..proto import api_pb2
from ..proto.rpc import build_generic_handler
from .state import FunctionCallState, ServerState

AUTH_METADATA_KEY = "x-modal-tpu-auth-token"


class InputPlaneServicer:
    """Serves ONLY the input-plane RPCs; everything else is UNIMPLEMENTED
    (the generic handler skips methods the servicer doesn't define)."""

    def __init__(self, state: ServerState, control_servicer):
        self.s = state
        self.control = control_servicer  # reuses _enqueue_input + conditions
        self.auth_failures = 0  # observability for tests
        self.rpc_counts: dict[str, int] = {}
        # set when the server stops: an await parked on this (abandoned)
        # state answers empty, and the client's next poll reaches the plane
        # that replaced it (ROADMAP Queue C 47)
        self.stopped = False

    def _count(self, name: str) -> None:
        self.rpc_counts[name] = self.rpc_counts.get(name, 0) + 1

    async def _require_auth(self, context) -> None:
        md = dict(context.invocation_metadata() or ())
        token = md.get(AUTH_METADATA_KEY, "")
        if not token or verify_jwt(token, self.s.auth_secret) is None:
            self.auth_failures += 1
            await context.abort(grpc.StatusCode.UNAUTHENTICATED, "missing or invalid input-plane auth token")

    # tokens older than this are assumed abandoned (no client awaits an
    # attempt for an hour; function timeout ceiling is far below it)
    ATTEMPT_TTL_S = 3600.0

    def _mint_attempt(self, call_id: str, input_id: str, supersedes: str = "") -> str:
        token = self.s.make_id("at")
        self.s.attempts[token] = (call_id, input_id, time.monotonic())
        # journaled so a client awaiting this attempt across a control-plane
        # restart resumes instead of NOT_FOUND-ing (server/journal.py)
        self.control._j(
            "attempt", token=token, call_id=call_id, input_id=input_id, supersedes=supersedes
        )
        if supersedes:
            # the replaced attempt's token must stop resolving
            self.s.attempts.pop(supersedes, None)
        if len(self.s.attempts) > 100_000:
            # opportunistic GC. Client-originated calls are never removed from
            # state.function_calls, so call-liveness alone frees nothing —
            # age out stale tokens too so the scan actually shrinks the dict.
            cutoff = time.monotonic() - self.ATTEMPT_TTL_S
            self.s.attempts = {
                t: (cid, iid, ts)
                for t, (cid, iid, ts) in self.s.attempts.items()
                if cid in self.s.function_calls and ts > cutoff
            }
        return token

    def _start_call(self, function_id: str, call_type: int) -> FunctionCallState:
        call = FunctionCallState(
            function_call_id=self.s.make_id("fc"),
            function_id=function_id,
            call_type=call_type,
        )
        self.s.function_calls[call.function_call_id] = call
        # journal via the control servicer (one sink for both planes): a
        # crash mid-map must recover input-plane calls too, or the client's
        # MapAwait resumes into NOT_FOUND
        self.control._j(
            "call",
            function_call_id=call.function_call_id,
            function_id=function_id,
            call_type=call_type,
        )
        return call

    async def _enqueue(self, fn, call, item: api_pb2.FunctionPutInputsItem) -> str:
        inp = self.control._enqueue_input(fn, call, item)
        return inp.input_id

    async def _notify(self, fn) -> None:
        async with fn.input_condition:
            fn.input_condition.notify_all()
        self.s.schedule_event.set()

    # -- single-input attempts (ref _functions.py:394) ----------------------

    async def AttemptStart(self, request: api_pb2.AttemptStartRequest, context) -> api_pb2.AttemptStartResponse:
        await self._require_auth(context)
        self._count("AttemptStart")
        fn = self.s.functions.get(request.function_id)
        if fn is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"function {request.function_id} not found")
        call = self._start_call(request.function_id, api_pb2.FUNCTION_CALL_TYPE_UNARY)
        input_id = await self._enqueue(fn, call, request.input)
        await self._notify(fn)
        resp = api_pb2.AttemptStartResponse(attempt_token=self._mint_attempt(call.function_call_id, input_id))
        if fn.definition.HasField("retry_policy"):
            resp.retry_policy.CopyFrom(fn.definition.retry_policy)
        return resp

    async def AttemptStartBatch(
        self, request: api_pb2.AttemptStartBatchRequest, context
    ) -> api_pb2.AttemptStartBatchResponse:
        """Coalesced unary dispatch on the input plane (_utils/coalescer.py):
        N concurrent `.remote()`s share one RPC; each sub-request mints its
        own call + attempt token exactly as a lone AttemptStart would, and
        the journal group-commits the batch's records in one flush."""
        await self._require_auth(context)
        self._count("AttemptStartBatch")
        # validate before executing anything: an abort mid-batch would leave
        # a dispatched prefix the client's per-item fallback re-dispatches
        for sub in request.requests:
            if sub.function_id not in self.s.functions:
                await context.abort(
                    grpc.StatusCode.NOT_FOUND, f"function {sub.function_id} not found"
                )
        resp = api_pb2.AttemptStartBatchResponse()
        # one group commit across the per-item awaits is the design: one
        # flush per batch, committed before the return; groups are scoped to
        # their task
        with self.control._journal_group():  # lint: disable=lock-across-await
            for sub in request.requests:
                fn = self.s.functions.get(sub.function_id)
                if fn is None:
                    # vanished between validation and execution: answer THIS
                    # item empty (no attempt token = not found) — the batch
                    # must never abort after partial execution
                    resp.responses.append(api_pb2.AttemptStartResponse())
                    continue
                call = self._start_call(sub.function_id, api_pb2.FUNCTION_CALL_TYPE_UNARY)
                input_id = await self._enqueue(fn, call, sub.input)
                one = api_pb2.AttemptStartResponse(
                    attempt_token=self._mint_attempt(call.function_call_id, input_id)
                )
                if fn.definition.HasField("retry_policy"):
                    one.retry_policy.CopyFrom(fn.definition.retry_policy)
                resp.responses.append(one)
                await self._notify(fn)
        return resp

    async def AttemptAwait(self, request: api_pb2.AttemptAwaitRequest, context) -> api_pb2.AttemptAwaitResponse:
        await self._require_auth(context)
        self._count("AttemptAwait")
        entry = self.s.attempts.get(request.attempt_token)
        if entry is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "unknown attempt token")
        call_id, input_id = entry[0], entry[1]
        call = self.s.function_calls.get(call_id)
        if call is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "call not found")
        deadline = time.monotonic() + min(max(request.timeout, 0.0), 60.0)
        # predicate is checked while HOLDING the condition lock: producers
        # notify under it (appends happen just before, outside the lock), so
        # a notify can't slip between our scan and wait() — that race would
        # stall the RPC a full poll window
        async with call.output_condition:
            while True:
                for item in call.outputs:
                    if item.input_id == input_id:
                        return api_pb2.AttemptAwaitResponse(output=item)
                if time.monotonic() >= deadline or self.stopped:
                    return api_pb2.AttemptAwaitResponse()
                try:
                    await asyncio.wait_for(
                        call.output_condition.wait(), timeout=max(0.05, deadline - time.monotonic())
                    )
                except asyncio.TimeoutError:
                    pass

    def _requeue_input(self, fn, call, inp, supersedes: str, *, prune_output: bool, new_input=None) -> str:
        """Reset a failed attempt's input to pending and mint the superseding
        token — the shared invariant block of AttemptRetry (which also prunes
        the stale output so the new attempt is awaitable) and
        MapStartOrContinue re-submission (which keeps outputs: the map cursor
        already handed them out)."""
        if prune_output:
            call.outputs[:] = [o for o in call.outputs if o.input_id != inp.input_id]
        was_done = inp.status == "done"
        if was_done:
            # the failed attempt's output already counted toward num_done; the
            # retry will count again — keep num_unfinished_inputs truthful.
            # Conditional: retrying an input that never delivered must not
            # steal a count from a different completed input (and the journal
            # replay guards its decrement with undo_done the same way).
            call.num_done = max(0, call.num_done - 1)
        inp.status = "pending"
        inp.retry_count += 1
        payload_update = None
        if new_input is not None and new_input.WhichOneof("args_oneof"):
            inp.input.CopyFrom(new_input)
            payload_update = inp.input.SerializeToString()
        inp.delivered_to.clear()
        inp.claimed_by = ""
        inp.claimed_at = 0.0
        if inp.input_id not in fn.pending:
            fn.pending.append(inp.input_id)
        rec: dict = {
            "input_id": inp.input_id,
            "retry_count": inp.retry_count,
            "undo_done": was_done,
            "prune_output": prune_output,
        }
        if payload_update is not None:
            from .journal import _b64

            rec["input"] = _b64(payload_update)
        self.control._j("input_retry", **rec)
        return self._mint_attempt(call.function_call_id, inp.input_id, supersedes=supersedes)

    async def AttemptRetry(self, request: api_pb2.AttemptRetryRequest, context) -> api_pb2.AttemptRetryResponse:
        await self._require_auth(context)
        self._count("AttemptRetry")
        entry = self.s.attempts.get(request.attempt_token)
        if entry is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "unknown attempt token")
        call_id, input_id = entry[0], entry[1]
        call = self.s.function_calls.get(call_id)
        inp = self.s.inputs.get(input_id)
        if call is None or inp is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "attempt state lost")
        fn = self.s.functions[call.function_id]
        token = self._requeue_input(
            fn, call, inp, request.attempt_token, prune_output=True, new_input=request.input.input
        )
        await self._notify(fn)
        return api_pb2.AttemptRetryResponse(attempt_token=token)

    # -- map attempts (ref parallel_map.py:620) -----------------------------

    async def MapStartOrContinue(
        self, request: api_pb2.MapStartOrContinueRequest, context
    ) -> api_pb2.MapStartOrContinueResponse:
        await self._require_auth(context)
        self._count("MapStartOrContinue")
        fn = self.s.functions.get(request.function_id)
        if fn is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"function {request.function_id} not found")
        if request.function_call_id:
            call = self.s.function_calls.get(request.function_call_id)
            if call is None:
                await context.abort(grpc.StatusCode.NOT_FOUND, "call not found")
        else:
            call = self._start_call(request.function_id, api_pb2.FUNCTION_CALL_TYPE_MAP)
        tokens = []
        for item in request.items:
            if item.attempt_token:
                # re-submission of a failed attempt: reset the same input
                entry = self.s.attempts.get(item.attempt_token)
                if entry is not None and (inp := self.s.inputs.get(entry[1])) is not None:
                    tokens.append(
                        self._requeue_input(fn, call, inp, item.attempt_token, prune_output=False)
                    )
                    continue
            input_id = await self._enqueue(fn, call, item.input)
            tokens.append(self._mint_attempt(call.function_call_id, input_id))
        await self._notify(fn)
        return api_pb2.MapStartOrContinueResponse(
            function_call_id=call.function_call_id, attempt_tokens=tokens
        )

    async def MapAwait(self, request: api_pb2.MapAwaitRequest, context) -> api_pb2.MapAwaitResponse:
        await self._require_auth(context)
        self._count("MapAwait")
        call = self.s.function_calls.get(request.function_call_id)
        if call is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "call not found")
        deadline = time.monotonic() + min(max(request.timeout, 0.0), 60.0)
        # same lock discipline as AttemptAwait: predicate under the condition
        # lock so the producer's notify can't be lost between scan and wait
        async with call.output_condition:
            while True:
                start = int(request.last_entry_id or 0)
                available = call.outputs[start:]
                if available:
                    return api_pb2.MapAwaitResponse(
                        outputs=available,
                        last_entry_id=str(start + len(available)),
                        num_unfinished_inputs=call.num_inputs - call.num_done,
                    )
                if time.monotonic() >= deadline or self.stopped:
                    return api_pb2.MapAwaitResponse(
                        outputs=[],
                        last_entry_id=str(start),
                        num_unfinished_inputs=call.num_inputs - call.num_done,
                    )
                try:
                    await asyncio.wait_for(
                        call.output_condition.wait(), timeout=max(0.05, deadline - time.monotonic())
                    )
                except asyncio.TimeoutError:
                    pass


class InputPlaneServer:
    """Owns the gRPC server for the input-plane servicer (own port; in
    production a separate regional deployment)."""

    def __init__(self, state: ServerState, control_servicer, port: int = 0, chaos=None):
        self.servicer = InputPlaneServicer(state, control_servicer)
        self.state = state
        self.port = port
        # the control plane's ChaosPolicy (chaos.py) injects here too, so
        # the knob families cover both planes
        self.chaos = chaos
        self._server: Optional[grpc.aio.Server] = None

    async def start(self) -> None:
        from .._utils import local_transport

        self._server = grpc.aio.server(
            options=[
                ("grpc.max_receive_message_length", 128 * 1024 * 1024),
                ("grpc.max_send_message_length", 128 * 1024 * 1024),
            ]
        )
        handler_target = self.servicer
        if self.chaos is not None:
            from ..chaos import ChaosServicerProxy

            handler_target = ChaosServicerProxy(self.servicer, self.chaos)
        self._server.add_generic_rpc_handlers((build_generic_handler(handler_target),))
        requested = self.port
        self.port = self._server.add_insecure_port(f"127.0.0.1:{self.port}")
        if self.port == 0 and requested:
            # requested port unavailable (e.g. the crashed predecessor's
            # socket lingering): fall back to an ephemeral one — clients with
            # the old URL lose input-plane locality but the plane stays up
            logger.warning(f"input plane port {requested} unavailable; binding ephemeral")
            self.port = self._server.add_insecure_port("127.0.0.1:0")
        # the local fast path: a Unix socket for co-located peers in other
        # processes, advertised at ClientHello beside the TCP url
        self.uds_path = ""
        uds = os.path.join(self.state.state_dir, "input_plane.sock")
        if local_transport.uds_enabled() and local_transport.usable_uds_path(uds):
            try:
                os.unlink(uds)
            except FileNotFoundError:
                pass
            try:
                self._server.add_insecure_port(f"unix:{uds}")
                self.uds_path = uds
            except Exception as exc:  # noqa: BLE001 — UDS is an optimization
                logger.warning(f"input-plane UDS bind failed ({exc}); TCP only")
        self.state.input_plane_url = f"grpc://127.0.0.1:{self.port}"
        self.state.input_plane_uds = self.uds_path
        await self._server.start()
        # in-process rung for same-process clients (default local mode)
        local_transport.register_local_server(self.state.input_plane_url, handler_target)
        logger.debug(f"input plane up at {self.state.input_plane_url}")

    async def stop(self) -> None:
        from .._utils import local_transport

        local_transport.unregister_local_server(self.state.input_plane_url)
        # wake the awaits parked on this state's calls: an in-process caller
        # holds no connection for the server's stop to cut
        self.servicer.stopped = True
        for call in list(self.state.function_calls.values()):
            async with call.output_condition:
                call.output_condition.notify_all()
        if getattr(self, "uds_path", ""):
            try:
                os.unlink(self.uds_path)
            except OSError:
                pass
        if self._server is not None:
            await self._server.stop(grace=0.5)
