"""Control-plane RPC handlers of the function path (port of
modal_tpu/server/services.py).

The handlers a serialized function or class call goes through, with the JAX
control plane's semantics: apps, blobs, function definition and invocation
(FunctionMap / FunctionGetOutputs long polls, generators, cancellation),
the container data plane (hello, heartbeats, input claims, outputs, logs,
results) and the worker plane (register, poll, heartbeat).

The state is in memory only (ROADMAP Queue A 4b' brings the journal). Every
RPC of the wire contract this servicer has no handler for answers gRPC
UNIMPLEMENTED (proto/rpc.py): the task cluster rendezvous, volumes and
cluster listing (4d); sandboxes, tunnels, images, mounts, secrets, proxies,
dicts, queues, environments, tokens, workspaces, profiles and the input
plane (4e); shard and journal administration and metrics history (4b', 4d).
"""

from __future__ import annotations

import asyncio
import hashlib
import time

import grpc

from ..config import logger
from ..observability import tracing
from ..observability.catalog import INPUT_QUEUE_WAIT, TASK_RESULTS, WORKER_HEARTBEATS
from ..proto import api_pb2
from .state import AppState, FunctionCallState, FunctionState, InputState, ServerState, TaskState_, WorkerState

CREATE_IF_MISSING = api_pb2.OBJECT_CREATION_TYPE_CREATE_IF_MISSING
FAIL_IF_EXISTS = api_pb2.OBJECT_CREATION_TYPE_CREATE_FAIL_IF_EXISTS
AUTH_TOKEN_TTL_S = 1200.0
# a draining worker that promised its containers no grace gets this one
PREEMPT_GRACE_S = 10.0
_FINISHED_TASK_STATES = (
    api_pb2.TASK_STATE_COMPLETED,
    api_pb2.TASK_STATE_FAILED,
    api_pb2.TASK_STATE_TERMINATED,
    api_pb2.TASK_STATE_PREEMPTED,
)


def waiting_feature(definition: api_pb2.Function) -> str:
    """What of a function definition the port's control plane cannot run:
    TPU chips, which it never places (it places cards, `gpu_config`), or a
    feature that waits, named with the ROADMAP Queue A sub-slice that
    brings it; "" if none."""
    if definition.resources.tpu_config.tpu_type:
        return (f"tpu_config ({definition.resources.tpu_config.tpu_type!r}) asks for TPU chips, which this control "
                f"plane does not place: ask for cards with gpu= (resources.gpu_config)")
    if (definition.group_size or 0) > 1:
        return "gang functions (group_size > 1) wait for the port's gang runtime (ROADMAP Queue A 4d)"
    if definition.webhook_type != api_pb2.WEB_ENDPOINT_TYPE_UNSPECIFIED:
        return "web endpoints wait for the port's App and web runtime (ROADMAP Queue A 4c)"
    if definition.schedule.WhichOneof("schedule_oneof") is not None:
        return "scheduled functions wait for the port's App (ROADMAP Queue A 4c)"
    return ""


class ModalTPUServicer:
    """The function path's RPC handlers. One instance per control plane."""

    def __init__(self, state: ServerState):
        self.s = state
        self.scheduler = None  # wired by the supervisor (worker drains)
        # throttling surfaced to containers on every GetInputs response
        self.rate_limit_sleep_duration = 0.0

    # the durable control plane's hooks, read by proto/rpc.py at handler-build
    # time: None while the state is in memory only (ROADMAP Queue A 4b')
    @property
    def idempotency(self):
        return self.s.idempotency

    @property
    def replicator(self):
        return self.s.replicator

    def _append_output(self, call: FunctionCallState, item: api_pb2.FunctionGetOutputsItem) -> bool:
        """The one funnel every delivered output goes through: dedupe by
        (input_id, retry_count) so a requeued input whose dead attempt
        already reported cannot deliver twice, then append. Returns False
        for a duplicate."""
        key = f"{item.input_id}:{item.retry_count}"
        if item.input_id and key in call.output_keys:
            return False
        if item.input_id:
            call.output_keys.add(key)
        call.outputs.append(item)
        call.num_done += 1
        call.first_output_at = call.first_output_at or time.time()
        return True

    # ------------------------------------------------------------------
    # Misc
    # ------------------------------------------------------------------

    async def ClientHello(self, request: api_pb2.ClientHelloRequest, context) -> api_pb2.ClientHelloResponse:
        return api_pb2.ClientHelloResponse(server_version="0.1.0", image_builder_version="2026.07")

    async def AuthTokenGet(self, request: api_pb2.AuthTokenGetRequest, context) -> api_pb2.AuthTokenGetResponse:
        """An input-plane JWT, valid for AUTH_TOKEN_TTL_S."""
        from .._utils.jwt_utils import encode_jwt

        return api_pb2.AuthTokenGetResponse(
            token=encode_jwt({"sub": "input-plane"}, self.s.auth_secret, ttl_s=AUTH_TOKEN_TTL_S)
        )

    # ------------------------------------------------------------------
    # Apps
    # ------------------------------------------------------------------

    async def AppCreate(self, request: api_pb2.AppCreateRequest, context) -> api_pb2.AppCreateResponse:
        app_id = self.s.make_id("ap")
        self.s.apps[app_id] = AppState(
            app_id=app_id,
            description=request.description,
            state=request.app_state or api_pb2.APP_STATE_INITIALIZING,
            environment_name=request.environment_name,
        )
        return api_pb2.AppCreateResponse(app_id=app_id, app_page_url=f"http://local/apps/{app_id}")

    async def AppGetOrCreate(self, request: api_pb2.AppGetOrCreateRequest, context) -> api_pb2.AppGetOrCreateResponse:
        key = (request.environment_name, request.app_name)
        app_id = self.s.deployed_apps.get(key)
        if app_id is None:
            if request.object_creation_type not in (CREATE_IF_MISSING, FAIL_IF_EXISTS):
                await context.abort(grpc.StatusCode.NOT_FOUND, f"app {request.app_name!r} not found")
            app_id = self.s.make_id("ap")
            self.s.apps[app_id] = AppState(
                app_id=app_id,
                name=request.app_name,
                description=request.app_name,
                state=api_pb2.APP_STATE_DEPLOYED,
                environment_name=key[0],
            )
            self.s.deployed_apps[key] = app_id
        elif request.object_creation_type == FAIL_IF_EXISTS:
            await context.abort(grpc.StatusCode.ALREADY_EXISTS, f"app {request.app_name!r} exists")
        return api_pb2.AppGetOrCreateResponse(app_id=app_id)

    async def AppHeartbeat(self, request, context) -> api_pb2.AppHeartbeatResponse:
        app = self.s.apps.get(request.app_id)
        if app is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"app {request.app_id} not found")
        app.last_heartbeat = time.time()
        return api_pb2.AppHeartbeatResponse()

    async def AppPublish(self, request: api_pb2.AppPublishRequest, context) -> api_pb2.AppPublishResponse:
        app = self.s.apps.get(request.app_id)
        if app is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "app not found")
        app.state = request.app_state
        app.function_ids.update(request.function_ids)
        app.class_ids.update(request.class_ids)
        if request.name:
            app.name = request.name
            self.s.deployed_apps[(app.environment_name, request.name)] = app.app_id
            for env, app_name, tag in list(self.s.deployed_functions):
                if env == app.environment_name and app_name == request.name:
                    del self.s.deployed_functions[(env, app_name, tag)]
            for tag, fn_id in request.function_ids.items():
                self.s.deployed_functions[(app.environment_name, request.name, tag)] = fn_id
            app.version += 1
            app.deployment_history.append(
                api_pb2.AppDeploymentHistory(
                    app_id=app.app_id,
                    version=app.version,
                    deployed_at=time.time(),
                    deployment_tag=request.deployment_tag,
                    commit_info=request.commit_info,
                )
            )
        self.s.schedule_event.set()
        return api_pb2.AppPublishResponse(url=f"http://local/apps/{app.app_id}")

    async def AppClientDisconnect(self, request, context) -> api_pb2.AppClientDisconnectResponse:
        app = self.s.apps.get(request.app_id)
        if app is not None and app.state in (api_pb2.APP_STATE_EPHEMERAL, api_pb2.APP_STATE_INITIALIZING):
            await self._stop_app(app)
        return api_pb2.AppClientDisconnectResponse()

    async def AppStop(self, request, context) -> api_pb2.AppStopResponse:
        app = self.s.apps.get(request.app_id)
        if app is not None:
            await self._stop_app(app)
        return api_pb2.AppStopResponse()

    async def _stop_app(self, app: AppState) -> None:
        app.state = api_pb2.APP_STATE_STOPPED
        app.stopped_at = time.time()
        app.done = True
        for task in list(self.s.tasks.values()):
            if task.app_id == app.app_id and task.state not in _FINISHED_TASK_STATES:
                task.terminate = True
                worker = self.s.workers.get(task.worker_id)
                if worker is not None:
                    await worker.events.put(api_pb2.WorkerPollResponse(stop=api_pb2.TaskStopEvent(task_id=task.task_id)))
        # wake every input long-poll so containers see the kill switch
        for fn_id in app.function_ids.values():
            fn = self.s.functions.get(fn_id)
            if fn is not None:
                async with fn.input_condition:
                    fn.input_condition.notify_all()
        await self.s.notify_logs(app.app_id)

    async def AppGetLayout(self, request, context) -> api_pb2.AppGetLayoutResponse:
        app = self.s.apps.get(request.app_id)
        if app is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "app not found")
        layout = api_pb2.AppLayout()
        for tag, fn_id in app.function_ids.items():
            layout.objects[tag] = fn_id
            fn = self.s.functions.get(fn_id)
            if fn is not None:
                layout.function_metadata[tag].CopyFrom(self._function_metadata(fn))
        for tag, cls_id in app.class_ids.items():
            layout.objects[tag] = cls_id
        return api_pb2.AppGetLayoutResponse(app_layout=layout)

    async def AppList(self, request, context) -> api_pb2.AppListResponse:
        items = []
        for app in self.s.apps.values():
            if request.environment_name and app.environment_name != request.environment_name:
                continue
            n_running = sum(
                1 for t in self.s.tasks.values() if t.app_id == app.app_id and t.state == api_pb2.TASK_STATE_ACTIVE
            )
            items.append(
                api_pb2.AppListItem(
                    app_id=app.app_id,
                    description=app.description,
                    state=app.state,
                    created_at=app.created_at,
                    stopped_at=app.stopped_at,
                    name=app.name,
                    n_running_tasks=n_running,
                )
            )
        return api_pb2.AppListResponse(apps=sorted(items, key=lambda a: a.created_at, reverse=True))

    async def AppDeploy(self, request, context) -> api_pb2.AppDeployResponse:
        app = self.s.apps.get(request.app_id)
        if app is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "app not found")
        app.state = api_pb2.APP_STATE_DEPLOYED
        self.s.deployed_apps[(app.environment_name, request.name)] = app.app_id
        return api_pb2.AppDeployResponse(url=f"http://local/apps/{app.app_id}")

    async def AppGetByDeploymentName(self, request, context) -> api_pb2.AppGetByDeploymentNameResponse:
        app_id = self.s.deployed_apps.get((request.environment_name, request.name))
        if app_id is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"deployed app {request.name!r} not found")
        return api_pb2.AppGetByDeploymentNameResponse(app_id=app_id)

    async def AppDeploymentHistory(self, request, context) -> api_pb2.AppDeploymentHistoryResponse:
        app = self.s.apps.get(request.app_id)
        if app is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "app not found")
        return api_pb2.AppDeploymentHistoryResponse(history=app.deployment_history)

    async def AppGetLogs(self, request: api_pb2.AppGetLogsRequest, context):
        """Server-streaming log tail with long-poll."""
        app = self.s.apps.get(request.app_id)
        if app is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "app not found")
        pos = int(request.last_entry_id) if request.last_entry_id else 0
        deadline = time.monotonic() + (request.timeout or 55.0)
        while time.monotonic() < deadline:
            entries = app.log_entries[pos:]
            if entries:
                for i, entry in enumerate(entries):
                    if request.task_id and entry.task_id != request.task_id:
                        continue  # filtered entries still advance the cursor
                    batch = api_pb2.TaskLogsBatch(entry_id=str(pos + i + 1))
                    batch.items.append(entry)
                    yield batch
                pos += len(entries)
            if app.done:
                yield api_pb2.TaskLogsBatch(app_done=True, entry_id=str(pos))
                return
            async with app.log_condition:
                try:
                    await asyncio.wait_for(app.log_condition.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    pass

    # ------------------------------------------------------------------
    # Blobs
    # ------------------------------------------------------------------

    async def BlobCreate(self, request: api_pb2.BlobCreateRequest, context) -> api_pb2.BlobCreateResponse:
        blob_id = "bl-" + hashlib.sha256(
            (request.content_sha256_base64 + str(time.time_ns())).encode()
        ).hexdigest()[:16]
        # multipart above the threshold; the part length balances the
        # S3-style 10k part cap against memory
        from .._utils import blob_utils

        if request.content_length >= blob_utils.MULTIPART_THRESHOLD:
            part_length = max(blob_utils.MULTIPART_PART_BYTES, (request.content_length + 9_999) // 10_000)
            n_parts = (request.content_length + part_length - 1) // part_length
            mp = api_pb2.MultiPartUpload(
                part_length=part_length,
                upload_urls=[f"{self.s.blob_url_base}/blob/{blob_id}/part/{i}" for i in range(n_parts)],
                completion_url=f"{self.s.blob_url_base}/blob/{blob_id}/complete/{n_parts}",
            )
            return api_pb2.BlobCreateResponse(blob_id=blob_id, multipart=mp)
        return api_pb2.BlobCreateResponse(blob_id=blob_id, upload_url=f"{self.s.blob_url_base}/blob/{blob_id}")

    async def BlobGet(self, request, context) -> api_pb2.BlobGetResponse:
        return api_pb2.BlobGetResponse(download_url=f"{self.s.blob_url_base}/blob/{request.blob_id}")

    # ------------------------------------------------------------------
    # Functions: definition
    # ------------------------------------------------------------------

    def _function_metadata(self, fn: FunctionState) -> api_pb2.FunctionHandleMetadata:
        d = fn.definition
        return api_pb2.FunctionHandleMetadata(
            function_name=d.function_name,
            function_type=d.function_type,
            is_generator=d.function_type == api_pb2.FUNCTION_TYPE_GENERATOR,
            definition_id=fn.function_id,
            input_concurrency=d.max_concurrent_inputs,
            batch_max_size=d.batch_max_size,
            batch_wait_ms=d.batch_linger_ms,
            schema=d.function_schema,
        )

    async def FunctionCreate(self, request: api_pb2.FunctionCreateRequest, context) -> api_pb2.FunctionCreateResponse:
        if request.app_id and request.app_id not in self.s.apps:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"app {request.app_id} not found")
        waiting = waiting_feature(request.function)
        if waiting:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"InvalidError: {waiting}")
        function_id = request.existing_function_id or self.s.make_id("fu")
        fn = FunctionState(
            function_id=function_id,
            app_id=request.app_id,
            tag=request.tag or request.function.function_name,
            definition=request.function,
        )
        self.s.functions[function_id] = fn
        app = self.s.apps.get(request.app_id)
        if app is not None:
            app.function_ids[fn.tag] = function_id
        self.s.schedule_event.set()
        return api_pb2.FunctionCreateResponse(function_id=function_id, handle_metadata=self._function_metadata(fn))

    async def FunctionGet(self, request: api_pb2.FunctionGetRequest, context) -> api_pb2.FunctionGetResponse:
        fn_id = self.s.deployed_functions.get((request.environment_name, request.app_name, request.object_tag))
        if fn_id is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"function {request.app_name}/{request.object_tag} not found")
        return api_pb2.FunctionGetResponse(
            function_id=fn_id, handle_metadata=self._function_metadata(self.s.functions[fn_id])
        )

    async def FunctionBindParams(self, request, context) -> api_pb2.FunctionBindParamsResponse:
        parent = self.s.functions.get(request.function_id)
        if parent is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "function not found")
        bound_def = api_pb2.Function()
        bound_def.CopyFrom(parent.definition)
        # with_options variant: merge the overrides the caller passed;
        # everything else keeps the parent's values
        opts = request.options
        for name in ("min_containers", "max_containers", "buffer_containers", "scaledown_window"):
            if opts.HasField(name):
                setattr(bound_def.autoscaler_settings, name, getattr(opts, name))
        if opts.HasField("timeout_secs"):
            bound_def.timeout_secs = opts.timeout_secs
        if opts.has_retry_policy:
            bound_def.retry_policy.CopyFrom(opts.retry_policy)
        if opts.HasField("max_concurrent_inputs"):
            bound_def.max_concurrent_inputs = opts.max_concurrent_inputs
        bound = FunctionState(
            function_id=self.s.make_id("fu"),
            app_id=parent.app_id,
            tag=parent.tag,
            definition=bound_def,
            bound_parent=parent.function_id,
            serialized_params=request.serialized_params,
        )
        self.s.functions[bound.function_id] = bound
        return api_pb2.FunctionBindParamsResponse(
            bound_function_id=bound.function_id, handle_metadata=self._function_metadata(bound)
        )

    async def FunctionUpdateSchedulingParams(self, request, context):
        fn = self.s.functions.get(request.function_id)
        if fn is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "function not found")
        fn.autoscaler_override = request.settings
        self.s.schedule_event.set()
        return api_pb2.FunctionUpdateSchedulingParamsResponse()

    async def FunctionGetCurrentStats(self, request, context) -> api_pb2.FunctionStats:
        fn = self.s.functions.get(request.function_id)
        if fn is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "function not found")
        active = sum(1 for tid in fn.task_ids if self.s.tasks[tid].state == api_pb2.TASK_STATE_ACTIVE)
        return api_pb2.FunctionStats(backlog=len(fn.pending), num_total_tasks=len(fn.task_ids), num_active_tasks=active)

    # ------------------------------------------------------------------
    # Functions: invocation
    # ------------------------------------------------------------------

    def _enqueue_input(self, fn: FunctionState, call: FunctionCallState, item: api_pb2.FunctionPutInputsItem) -> InputState:
        inp = InputState(
            input_id=self.s.make_id("in"),
            function_call_id=call.function_call_id,
            idx=item.idx,
            input=item.input,
            # the submitting RPC's server span (proto/rpc.py) rides the input
            # to the container
            trace_context=tracing.format_context(tracing.current_context()),
        )
        self.s.inputs[inp.input_id] = inp
        call.input_ids.append(inp.input_id)
        call.num_inputs += 1
        fn.pending.append(inp.input_id)
        return inp

    async def FunctionMap(self, request: api_pb2.FunctionMapRequest, context) -> api_pb2.FunctionMapResponse:
        fn = self.s.functions.get(request.function_id)
        if fn is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"function {request.function_id} not found")
        call = FunctionCallState(
            function_call_id=self.s.make_id("fc"),
            function_id=request.function_id,
            call_type=request.function_call_type,
            invocation_type=request.invocation_type,
            return_exceptions=request.return_exceptions,
        )
        self.s.function_calls[call.function_call_id] = call
        resp = api_pb2.FunctionMapResponse(
            function_call_id=call.function_call_id, function_call_jwt=call.function_call_id, max_inputs_outstanding=1000
        )
        for item in request.pipelined_inputs:
            inp = self._enqueue_input(fn, call, item)
            resp.pipelined_inputs.append(api_pb2.FunctionPutInputsResponseItem(idx=item.idx, input_id=inp.input_id))
        async with fn.input_condition:
            fn.input_condition.notify_all()
        self.s.schedule_event.set()
        return resp

    async def FunctionPutInputs(self, request, context) -> api_pb2.FunctionPutInputsResponse:
        fn = self.s.functions.get(request.function_id)
        call = self.s.function_calls.get(request.function_call_id)
        if fn is None or call is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "function or call not found")
        resp = api_pb2.FunctionPutInputsResponse()
        for item in request.inputs:
            inp = self._enqueue_input(fn, call, item)
            resp.inputs.append(api_pb2.FunctionPutInputsResponseItem(idx=item.idx, input_id=inp.input_id))
        async with fn.input_condition:
            fn.input_condition.notify_all()
        self.s.schedule_event.set()
        return resp

    async def FunctionRetryInputs(self, request, context) -> api_pb2.FunctionRetryInputsResponse:
        call = self.s.function_calls.get(request.function_call_jwt)
        if call is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "call not found")
        fn = self.s.functions[call.function_id]
        jwts = []
        for item in request.inputs:
            old = self.s.inputs.get(item.input_id)
            if old is None:
                continue
            old.status = "pending"
            old.retry_count = item.retry_count
            if item.input.WhichOneof("args_oneof"):  # payload resend optional
                old.input.CopyFrom(item.input)
            old.claimed_by = ""
            old.claimed_at = 0.0
            if old.input_id not in fn.pending:
                fn.pending.append(old.input_id)
            jwts.append(old.input_id)
        async with fn.input_condition:
            fn.input_condition.notify_all()
        self.s.schedule_event.set()
        return api_pb2.FunctionRetryInputsResponse(input_jwts=jwts)

    async def MapCheckInputs(self, request: api_pb2.MapCheckInputsRequest, context) -> api_pb2.MapCheckInputsResponse:
        """Which of the caller's unfinished idxs does the server no longer
        track? (the client re-submits lost inputs)"""
        call = self.s.function_calls.get(request.function_call_id)
        if call is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "call not found")
        known_idxs = {self.s.inputs[iid].idx for iid in call.input_ids if iid in self.s.inputs}
        return api_pb2.MapCheckInputsResponse(lost_idxs=[idx for idx in request.idxs if idx not in known_idxs])

    def _take_outputs(self, call: FunctionCallState, request, start: int) -> api_pb2.FunctionGetOutputsResponse:
        available = call.outputs[start:]
        n = len(available) if request.max_values <= 0 else min(len(available), request.max_values)
        if request.clear_on_success:
            call.outputs_consumed += n
        return api_pb2.FunctionGetOutputsResponse(
            outputs=available[:n], last_entry_id=str(start + n), num_unfinished_inputs=call.num_inputs - call.num_done
        )

    async def FunctionGetOutputs(self, request: api_pb2.FunctionGetOutputsRequest, context) -> api_pb2.FunctionGetOutputsResponse:
        call = self.s.function_calls.get(request.function_call_id)
        if call is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"call {request.function_call_id} not found")
        deadline = time.monotonic() + min(max(request.timeout, 0.0), 60.0)
        while True:
            start = call.outputs_consumed if request.clear_on_success else int(request.last_entry_id or 0)
            if call.outputs[start:] or time.monotonic() >= deadline:
                return self._take_outputs(call, request, start)
            async with call.output_condition:
                try:
                    await asyncio.wait_for(call.output_condition.wait(), timeout=max(0.05, deadline - time.monotonic()))
                except asyncio.TimeoutError:
                    pass

    async def FunctionStreamOutputs(self, request: api_pb2.FunctionGetOutputsRequest, context):
        """The keep-alive server-streaming twin of FunctionGetOutputs: a batch
        is pushed as soon as it lands, an empty response every 5 s lets the
        client tell a quiet call from a dead stream."""
        call = self.s.function_calls.get(request.function_call_id)
        if call is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"call {request.function_call_id} not found")
        cursor = int(request.last_entry_id or 0)
        while True:
            start = call.outputs_consumed if request.clear_on_success else cursor
            if call.outputs[start:]:
                resp = self._take_outputs(call, request, start)
                cursor = int(resp.last_entry_id)
                yield resp
                continue
            timed_out = False
            async with call.output_condition:
                try:
                    await asyncio.wait_for(call.output_condition.wait(), timeout=5.0)
                except asyncio.TimeoutError:
                    timed_out = True
            if timed_out:  # the keep-alive goes out with the lock released
                yield self._take_outputs(call, request, start)

    async def FunctionCallGetData(self, request: api_pb2.FunctionCallGetDataRequest, context):
        call = self.s.function_calls.get(request.function_call_id)
        if call is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "call not found")
        idx = int(request.last_index)
        deadline = time.monotonic() + 55.0
        while time.monotonic() < deadline:
            chunks = call.data_chunks[idx:]
            if chunks:
                for c in chunks:
                    yield c
                idx += len(chunks)
                if chunks[-1].data_format == api_pb2.DATA_FORMAT_GENERATOR_DONE:
                    return
                deadline = time.monotonic() + 55.0
                continue
            if call.num_done >= call.num_inputs > 0:
                # the call finished without a GENERATOR_DONE chunk (the
                # generator raised mid-stream): end the stream now
                return
            async with call.data_condition:
                try:
                    await asyncio.wait_for(call.data_condition.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    pass

    async def FunctionCallPutData(self, request: api_pb2.FunctionCallPutDataRequest, context):
        call = self.s.function_calls.get(request.function_call_id)
        if call is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "call not found")
        for chunk in request.data_chunks:
            new = api_pb2.DataChunk()
            new.CopyFrom(chunk)
            new.index = len(call.data_chunks) + 1
            call.data_chunks.append(new)
        async with call.data_condition:
            call.data_condition.notify_all()
        return api_pb2.FunctionCallPutDataResponse()

    def _call_info(self, call: FunctionCallState) -> api_pb2.FunctionCallInfo:
        return api_pb2.FunctionCallInfo(
            function_call_id=call.function_call_id,
            created_at=call.created_at,
            type=call.call_type,
            num_inputs=call.num_inputs,
            num_outputs=len(call.outputs),
        )

    async def FunctionCallList(self, request, context) -> api_pb2.FunctionCallListResponse:
        return api_pb2.FunctionCallListResponse(
            calls=[self._call_info(c) for c in self.s.function_calls.values() if c.function_id == request.function_id]
        )

    async def FunctionCallCancel(self, request, context) -> api_pb2.FunctionCallCancelResponse:
        call = self.s.function_calls.get(request.function_call_id)
        if call is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "call not found")
        call.cancelled = True
        fn = self.s.functions[call.function_id]
        # drop pending inputs; running ones are cancelled through the
        # container's heartbeat
        for input_id in call.input_ids:
            inp = self.s.inputs.get(input_id)
            if inp is None:
                continue
            if inp.status == "pending":
                inp.status = "cancelled"
                if input_id in fn.pending:
                    fn.pending.remove(input_id)
            elif inp.status == "claimed":
                task = self.s.tasks.get(inp.claimed_by)
                if task is not None:
                    task.cancelled_input_ids.append(input_id)
                    if request.terminate_containers:
                        task.terminate = True
        async with call.output_condition:
            call.output_condition.notify_all()
        return api_pb2.FunctionCallCancelResponse()

    async def FunctionCallGetInfo(self, request, context) -> api_pb2.FunctionCallGetInfoResponse:
        call = self.s.function_calls.get(request.function_call_id)
        if call is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "call not found")
        return api_pb2.FunctionCallGetInfoResponse(info=self._call_info(call), function_id=call.function_id)

    # ------------------------------------------------------------------
    # Container data plane
    # ------------------------------------------------------------------

    async def ContainerHello(self, request, context) -> api_pb2.ContainerHelloResponse:
        task = self.s.tasks.get(request.task_id)
        if task is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"task {request.task_id} not found")
        task.state = api_pb2.TASK_STATE_ACTIVE
        task.started_at = task.started_at or time.time()
        task.last_heartbeat = time.time()
        fn = self.s.functions.get(task.function_id)
        if fn is not None:
            fn.init_failures = 0  # a container came up: init is healthy
        return api_pb2.ContainerHelloResponse()

    async def ContainerHeartbeat(self, request, context) -> api_pb2.ContainerHeartbeatResponse:
        task = self.s.tasks.get(request.task_id)
        if task is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "task not found")
        task.last_heartbeat = time.time()
        if request.telemetry_json:
            # the container's device and compile metric families, merged
            # into this process's registry (deltas against its last push)
            from ..observability.device_telemetry import merge_container_report

            task.telemetry_prev_json = merge_container_report(
                request.telemetry_json, task.telemetry_prev_json, task_id=task.task_id
            )
        resp = api_pb2.ContainerHeartbeatResponse()
        if task.cancelled_input_ids:
            resp.cancel_input_event.input_ids.extend(task.cancelled_input_ids)
            task.cancelled_input_ids = []
        if task.terminate:
            resp.cancel_input_event.terminate_containers = True
        return resp

    def _scaledown_blocked(self, fn: FunctionState, task: TaskState_) -> bool:
        """Is this container one of the `min_containers` oldest live ones of
        its function? Those stay warm through idle; oldest-first lets exactly
        min_containers containers self-select without a reservation."""
        min_containers = fn.autoscaler.min_containers
        if min_containers <= 0:
            return False
        live = sorted(
            (
                tid
                for tid in fn.task_ids
                if self.s.tasks[tid].state
                in (api_pb2.TASK_STATE_CREATED, api_pb2.TASK_STATE_ACTIVE, api_pb2.TASK_STATE_IDLE)
            ),
            key=lambda tid: self.s.tasks[tid].created_at,
        )
        return task.task_id in live[:min_containers]

    def _note_input_claimed(self, fn: FunctionState, inp: InputState) -> None:
        """The enqueue → claim wait becomes a histogram sample and, for a
        traced input, a retroactive `scheduler.queue_wait` span."""
        now = time.time()
        INPUT_QUEUE_WAIT.observe(max(0.0, now - inp.created_at))
        tracing.record_span(
            "scheduler.queue_wait",
            start=inp.created_at,
            end=now,
            parent=tracing.parse_context(inp.trace_context),
            attrs={"input_id": inp.input_id, "function_call_id": inp.function_call_id, "function_id": fn.function_id},
        )

    async def FunctionGetInputs(self, request: api_pb2.FunctionGetInputsRequest, context) -> api_pb2.FunctionGetInputsResponse:
        fn = self.s.functions.get(request.function_id)
        task = self.s.tasks.get(request.task_id)
        if fn is None or task is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "function or task not found")
        if request.average_call_time > 0:
            fn.reported_call_time = request.average_call_time
        # long-poll for inputs; kill switch when the app stops or the task
        # is being drained
        deadline = time.monotonic() + 10.0
        while True:
            app = self.s.apps.get(fn.app_id)
            if task.terminate or (app is not None and app.done):
                return api_pb2.FunctionGetInputsResponse(inputs=[api_pb2.FunctionGetInputsItem(kill_switch=True)])
            batch_size = max(1, request.max_values or 1)
            items = []
            # batching linger: once the first input of a batch is seen, wait
            # up to batch_linger_ms for the batch to fill
            linger_deadline = None
            while True:
                while fn.pending and len(items) < batch_size:
                    inp = self.s.inputs[fn.pending.pop(0)]
                    if inp.status != "pending":
                        continue
                    inp.status = "claimed"
                    inp.claimed_by = task.task_id
                    inp.claimed_at = time.time()
                    self._note_input_claimed(fn, inp)
                    task.first_input_at = task.first_input_at or time.time()
                    items.append(
                        api_pb2.FunctionGetInputsItem(
                            input_id=inp.input_id,
                            input=inp.input,
                            function_call_id=inp.function_call_id,
                            idx=inp.idx,
                            retry_count=inp.retry_count,
                            resume_token=inp.resume_token,
                            trace_context=inp.trace_context,
                            claimed_at=inp.claimed_at,
                        )
                    )
                if not items or len(items) >= batch_size or not request.batch_linger_ms:
                    break
                if linger_deadline is None:
                    linger_deadline = time.monotonic() + request.batch_linger_ms / 1000.0
                remaining = linger_deadline - time.monotonic()
                if remaining <= 0:
                    break
                async with fn.input_condition:
                    try:
                        await asyncio.wait_for(fn.input_condition.wait(), timeout=remaining)
                    except asyncio.TimeoutError:
                        break
            if items:
                return api_pb2.FunctionGetInputsResponse(inputs=items, rate_limit_sleep_duration=self.rate_limit_sleep_duration)
            if time.monotonic() >= deadline:
                return api_pb2.FunctionGetInputsResponse(
                    inputs=[],
                    rate_limit_sleep_duration=self.rate_limit_sleep_duration,
                    scaledown_blocked=self._scaledown_blocked(fn, task),
                )
            async with fn.input_condition:
                try:
                    await asyncio.wait_for(fn.input_condition.wait(), timeout=max(0.05, deadline - time.monotonic()))
                except asyncio.TimeoutError:
                    pass

    async def FunctionPutOutputs(self, request: api_pb2.FunctionPutOutputsRequest, context) -> api_pb2.FunctionPutOutputsResponse:
        return await self._put_outputs(request)

    async def FunctionExchange(self, request: api_pb2.FunctionExchangeRequest, context) -> api_pb2.FunctionGetInputsResponse:
        """One container turnaround in one RPC: apply the finished inputs'
        outputs (the same dedupe as FunctionPutOutputs), then run the
        FunctionGetInputs long-poll. Outputs land and notify their waiters
        before the poll blocks."""
        from ..observability.catalog import DISPATCH_EXCHANGES

        if request.HasField("put") and request.put.outputs:
            DISPATCH_EXCHANGES.inc(carried="with_outputs")
            await self._put_outputs(request.put)
        else:
            DISPATCH_EXCHANGES.inc(carried="claim_only")
        return await self.FunctionGetInputs(request.get, context)

    async def _put_outputs(self, request: api_pb2.FunctionPutOutputsRequest) -> api_pb2.FunctionPutOutputsResponse:
        touched: set[str] = set()
        pushing_task = self.s.tasks.get(request.task_id) if request.task_id else None
        for item in request.outputs:
            call = self.s.function_calls.get(item.function_call_id)
            if call is None:
                continue
            if pushing_task is not None and pushing_task.preempted:
                # a preempted task's inputs are (being) requeued: a stale
                # result would complete the call with partial work
                continue
            if pushing_task is not None:
                pushing_task.first_output_at = pushing_task.first_output_at or time.time()
            inp = self.s.inputs.get(item.input_id)
            if inp is not None:
                if inp.status == "done":
                    continue  # duplicate
                inp.status = "done"
            appended = self._append_output(
                call,
                api_pb2.FunctionGetOutputsItem(
                    result=item.result,
                    idx=item.idx,
                    input_id=item.input_id,
                    data_format=item.data_format,
                    retry_count=item.retry_count,
                ),
            )
            if appended:
                touched.add(call.function_call_id)
        for call_id in touched:
            call = self.s.function_calls[call_id]
            async with call.output_condition:
                call.output_condition.notify_all()
        return api_pb2.FunctionPutOutputsResponse()

    async def ContainerCheckpoint(self, request, context):
        # preemption flush: the container recorded a checkpoint for a claimed
        # input; the requeued attempt is redelivered with its resume token
        if request.input_id and request.resume_token:
            inp = self.s.inputs.get(request.input_id)
            # a dead attempt's delayed flush must not clobber the token a
            # newer attempt recorded: accept only from the current holder, or
            # a first-ever token for an input nobody holds
            if inp is not None and (
                inp.claimed_by == request.task_id or (not inp.claimed_by and not inp.resume_token)
            ):
                inp.resume_token = request.resume_token
        return api_pb2.ContainerCheckpointResponse()

    async def ContainerStop(self, request, context):
        task = self.s.tasks.get(request.task_id)
        if task is not None:
            task.terminate = True
            worker = self.s.workers.get(task.worker_id)
            if worker is not None:
                await worker.events.put(api_pb2.WorkerPollResponse(stop=api_pb2.TaskStopEvent(task_id=task.task_id)))
        return api_pb2.ContainerStopResponse()

    async def TaskList(self, request: api_pb2.TaskListRequest, context) -> api_pb2.TaskListResponse:
        """Running (and optionally finished) containers across apps."""
        out = []
        for task in self.s.tasks.values():
            if not request.include_finished and task.state in _FINISHED_TASK_STATES:
                continue
            app = self.s.apps.get(task.app_id)
            if request.environment_name and (app is None or app.environment_name != request.environment_name):
                continue
            fn = self.s.functions.get(task.function_id)
            out.append(
                api_pb2.TaskInfo(
                    task_id=task.task_id,
                    app_id=task.app_id,
                    app_description=app.description if app else "",
                    function_tag=fn.tag if fn else "",
                    state=task.state,
                    worker_id=task.worker_id,
                    created_at=task.created_at,
                    started_at=task.started_at,
                    finished_at=task.finished_at,
                    gpu_ids=list(task.gpu_ids),
                )
            )
        return api_pb2.TaskListResponse(tasks=out)

    async def ContainerLog(self, request: api_pb2.ContainerLogRequest, context):
        task = self.s.tasks.get(request.task_id)
        app = self.s.apps.get(task.app_id) if task is not None else None
        if app is not None:
            for entry in request.logs:
                e = api_pb2.TaskLogs()
                e.CopyFrom(entry)
                e.task_id = task.task_id
                app.log_entries.append(e)
            await self.s.notify_logs(app.app_id)
        return api_pb2.ContainerLogResponse()

    async def AppCountLogs(self, request: api_pb2.AppCountLogsRequest, context) -> api_pb2.AppCountLogsResponse:
        """Histogram of stored log entries over [min_timestamp,
        max_timestamp): the client refines dense buckets into fetch
        intervals instead of paging the whole history."""
        app = self.s.apps.get(request.app_id)
        if app is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "app not found")
        lo = request.min_timestamp or (app.log_entries[0].timestamp if app.log_entries else time.time())
        hi = request.max_timestamp or time.time()
        n = min(max(request.n_buckets or 16, 1), 256)
        if hi <= lo:
            hi = lo + 1e-6
        width = (hi - lo) / n
        counts = [0] * n
        first_index = [0] * n  # offset of each bucket's first entry
        for i, entry in enumerate(app.log_entries):
            if entry.timestamp < lo or entry.timestamp >= hi:
                continue
            if request.task_id and entry.task_id != request.task_id:
                continue
            b = min(int((entry.timestamp - lo) / width), n - 1)
            if counts[b] == 0:
                first_index[b] = i
            counts[b] += 1
        return api_pb2.AppCountLogsResponse(
            buckets=[
                api_pb2.LogBucket(start=lo + i * width, end=lo + (i + 1) * width, count=c, start_index=first_index[i])
                for i, c in enumerate(counts)
            ]
        )

    async def AppFetchLogs(self, request: api_pb2.AppFetchLogsRequest, context) -> api_pb2.AppFetchLogsResponse:
        """Historical log backfill: offset-paged over the app's stored
        entries with time and task filters."""
        app = self.s.apps.get(request.app_id)
        if app is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "app not found")
        page = request.max_entries or 500
        resp = api_pb2.AppFetchLogsResponse(total=len(app.log_entries))
        i = request.start_index
        while i < len(app.log_entries) and len(resp.entries) < page:
            entry = app.log_entries[i]
            i += 1
            if request.min_timestamp and entry.timestamp < request.min_timestamp:
                continue
            if request.max_timestamp and entry.timestamp >= request.max_timestamp:
                # entries are stamped worker-side and appended on arrival, so
                # the store is only roughly time-ordered: keep scanning until
                # entries are past the window by more than any delivery skew
                if entry.timestamp >= request.max_timestamp + 30.0:
                    i = len(app.log_entries)
                    break
                continue
            if request.task_id and entry.task_id != request.task_id:
                continue
            resp.entries.append(entry)
        resp.next_index = i
        return resp

    async def TaskResult(self, request: api_pb2.TaskResultRequest, context) -> api_pb2.TaskResultResponse:
        task = self.s.tasks.get(request.task_id)
        if task is None:
            return api_pb2.TaskResultResponse()
        TASK_RESULTS.inc(status=api_pb2.GenericResultStatus.Name(request.result.status))
        if task.result is not None:
            # first report wins: the container's own result must not be
            # overwritten by the worker's exit-code report
            return api_pb2.TaskResultResponse()
        task.result = request.result
        if request.result.status == api_pb2.GENERIC_STATUS_SUCCESS:
            task.state = api_pb2.TASK_STATE_COMPLETED
            if task.preempted:
                # outputs pushed after the preempt flag were dropped: those
                # inputs are still claimed and must requeue
                await self._requeue_claimed_inputs(task)
        elif task.preempted:
            # preemption drain: claimed inputs go back to pending without
            # consuming the user's retry budget
            task.state = api_pb2.TASK_STATE_PREEMPTED
            await self._requeue_claimed_inputs(task)
        else:
            task.state = api_pb2.TASK_STATE_FAILED
            await self._fail_claimed_inputs(task, request.result)
            if request.result.status == api_pb2.GENERIC_STATUS_INIT_FAILURE:
                # containers that die before serving never claim inputs:
                # repeated init failures fail the backlog, or clients hang
                fn = self.s.functions.get(task.function_id)
                if fn is not None:
                    fn.init_failures += 1
                    if fn.init_failures >= 2:
                        await self._fail_pending_inputs(fn, request.result)
        task.finished_at = time.time()
        self._release_task(task)
        return api_pb2.TaskResultResponse()

    async def _fail_pending_inputs(self, fn: FunctionState, result: api_pb2.GenericResult) -> None:
        for input_id in list(fn.pending):
            inp = self.s.inputs.get(input_id)
            if inp is None or inp.status != "pending":
                continue
            inp.status = "done"
            fn.pending.remove(input_id)
            call = self.s.function_calls.get(inp.function_call_id)
            if call is None:
                continue
            self._append_output(
                call,
                api_pb2.FunctionGetOutputsItem(result=result, idx=inp.idx, input_id=inp.input_id, retry_count=inp.retry_count),
            )
            async with call.output_condition:
                call.output_condition.notify_all()

    async def _fail_claimed_inputs(self, task: TaskState_, result: api_pb2.GenericResult) -> None:
        """Inputs claimed by a dead container retry under the function's
        policy, or fail once it is spent."""
        fn = self.s.functions.get(task.function_id)
        for inp in self.s.inputs.values():
            if inp.status != "claimed" or inp.claimed_by != task.task_id:
                continue
            call = self.s.function_calls.get(inp.function_call_id)
            if call is None or fn is None:
                continue
            if inp.retry_count < fn.definition.retry_policy.retries:
                inp.retry_count += 1
                inp.status = "pending"
                inp.claimed_by = ""
                inp.claimed_at = 0.0
                if inp.input_id not in fn.pending:
                    fn.pending.append(inp.input_id)
                async with fn.input_condition:
                    fn.input_condition.notify_all()
                self.s.schedule_event.set()
            else:
                inp.status = "done"
                self._append_output(
                    call,
                    api_pb2.FunctionGetOutputsItem(
                        result=result, idx=inp.idx, input_id=inp.input_id, retry_count=inp.retry_count
                    ),
                )
                async with call.output_condition:
                    call.output_condition.notify_all()

    async def _requeue_claimed_inputs(self, task: TaskState_) -> None:
        """Preemption: inputs claimed by a preempted task return to pending
        without consuming the retry budget; a recorded resume token rides
        the next attempt. Idempotent."""
        fn = self.s.functions.get(task.function_id)
        if fn is None:
            return
        requeued = 0
        for inp in self.s.inputs.values():
            if inp.claimed_by != task.task_id or inp.status not in ("pending", "claimed"):
                continue
            inp.status = "pending"
            inp.claimed_by = ""
            inp.claimed_at = 0.0
            if inp.input_id not in fn.pending:
                fn.pending.append(inp.input_id)
            requeued += 1
        if requeued:
            logger.warning(f"requeued {requeued} input(s) from preempted task {task.task_id} (no retry consumed)")
            async with fn.input_condition:
                fn.input_condition.notify_all()
            self.s.schedule_event.set()

    def _release_task(self, task: TaskState_) -> None:
        worker = self.s.workers.get(task.worker_id)
        if worker is not None:
            worker.active_tasks.discard(task.task_id)
            for gpu, tid in list(worker.gpus_in_use.items()):
                if tid == task.task_id:
                    del worker.gpus_in_use[gpu]
        # the task's pushed device-memory series go with it
        from ..observability.device_telemetry import drop_task_device_series

        drop_task_device_series(task.task_id)
        fn = self.s.functions.get(task.function_id)
        if fn is not None:
            fn.task_ids.discard(task.task_id)
        self.s.schedule_event.set()

    # ------------------------------------------------------------------
    # Workers
    # ------------------------------------------------------------------

    async def WorkerRegister(self, request: api_pb2.WorkerRegisterRequest, context) -> api_pb2.WorkerRegisterResponse:
        worker_id = request.worker_id or self.s.make_id("wk")
        stale = self.s.workers.get(worker_id)
        if stale is not None:
            # re-registration under an existing id: tasks the stale record ran
            # are marked lost (the reaper retries or fails their inputs)
            for task_id in stale.active_tasks:
                task = self.s.tasks.get(task_id)
                if task is not None and not task.finished_at:
                    task.terminate = True
        self.s.workers[worker_id] = WorkerState(
            worker_id=worker_id,
            hostname=request.hostname,
            gpu_type=request.gpu_type,
            num_gpus=request.num_gpus,
            milli_cpu=request.milli_cpu,
            memory_mb=request.memory_mb,
            container_address=request.container_address,
            region=request.region,
            zone=request.zone,
            spot=request.spot,
            instance_type=request.instance_type,
        )
        self.s.schedule_event.set()
        return api_pb2.WorkerRegisterResponse(worker_id=worker_id)

    async def WorkerPoll(self, request: api_pb2.WorkerPollRequest, context):
        worker = self.s.workers.get(request.worker_id)
        if worker is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "worker not registered")
        while True:
            try:
                event = await asyncio.wait_for(worker.events.get(), timeout=5.0)
            except asyncio.TimeoutError:
                # a re-registration replaced the WorkerState and its events
                # queue: end this stream so the agent binds the live one
                if self.s.workers.get(request.worker_id) is not worker:
                    return
                continue
            yield event

    async def WorkerHeartbeat(self, request, context) -> api_pb2.WorkerHeartbeatResponse:
        worker = self.s.workers.get(request.worker_id)
        if worker is None:
            # unknown id (this control plane restarted, or deregistered the
            # worker): tell the worker to re-announce under its id
            return api_pb2.WorkerHeartbeatResponse(reannounce=True)
        WORKER_HEARTBEATS.inc()
        worker.last_heartbeat = time.time()
        if request.draining and not worker.draining and self.scheduler is not None:
            # the worker announces its preemption and signals its own
            # containers; honor the grace it promised them
            grace = request.drain_grace_s or PREEMPT_GRACE_S
            await self.scheduler.drain_worker(request.worker_id, grace_s=grace, notify_worker=False)
        return api_pb2.WorkerHeartbeatResponse()

    async def TaskReady(self, request: api_pb2.TaskReadyRequest, context) -> api_pb2.TaskReadyResponse:
        # readiness of a sandbox task; sandboxes come with ROADMAP Queue A 4e
        return api_pb2.TaskReadyResponse()
