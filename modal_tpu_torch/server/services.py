"""Control-plane RPC handlers (port of modal_tpu/server/services.py).

The handlers a function or class call of the App layer goes through, with
the JAX control plane's semantics: apps, blobs, function definition and
invocation (FunctionMap and the coalesced FunctionMapBatch, FunctionGetOutputs
long polls, generators, cancellation), web endpoints (a container sets its
URL, a client long-polls for it), images (each definition registered by its
content hash, built by the worker on first use, listed with its reference
count and deleted unless referenced), mounts (content-addressed
blocks), secrets (resolved into a container's env at placement), the
container data plane (hello, heartbeats, input claims, outputs, logs,
results) and the worker plane (register, poll, heartbeat). Beside them, the
sandboxes: create, wait, terminate, stdin and logs, sidecars, the worker
router's address and token (SandboxGetCommandRouterAccess), filesystem and
full snapshots and restore, tunnels (SandboxGetTunnels, TaskTunnelsUpdate,
TunnelStart, TunnelStop) and readiness (TaskReady). A sandbox asks for
cards with `gpu_config`; a `tpu_config` ask is refused. The SDK's objects:
dicts, queues (partitions, blocking gets and long-polled iteration),
proxies (a static egress IP, exported to a proxied function's containers),
environments (an empty name resolves to the workspace's default), the token
flow and the workspace (its settings: `image_builder_version`, which
ClientHello advertises, and `default_environment`).

Every mutating handler appends the effect it applied to the write-ahead
journal (server/journal.py) under the JAX handler's record type, so a
restarted plane replays its apps, calls and queued inputs; claims, tasks,
heartbeats and logs are transient by design, and so are sandboxes and
tunnels, and the contents of dicts and queues (journal.EXEMPT_RPCS).
Volumes (the 13 Volume* RPCs and the
ephemeral heartbeat of volumes, dicts and queues) keep files as block lists over the content-addressed
block store, and gangs meet at TaskClusterHello (ClusterList lists them): a
broadcast input reaches every rank, rank 0's result is the output, and a
dead rank fails its gang's inputs and preempts its peers. The metrics
plane answers MetricsHistory (server/history.py), ProfileControl (the
sampling profiler, fanned out to containers on their heartbeats),
AppListProfiles (the runtime_debug traces) and TaskGetTimeline. A shard
of a sharded plane answers ShardControl (the director's probes, takeovers
and fencing, server/shards.py) and JournalReplicate (its sibling writers'
journal streams, server/replication.py). This servicer serves 137 of the
wire contract's 148 RPCs, as the JAX package's does; the others answer gRPC
UNIMPLEMENTED (proto/rpc.py). The input plane's six (Attempt*,
MapStartOrContinue, MapAwait) are served by the input plane
(server/input_plane.py), and the five ContainerExec* and
ContainerFilesystemExec RPCs have no handler in the JAX package either
(exec and the filesystem of a sandbox, and the warm pool's handoff, are
served by each worker's task command router, server/task_router.py). With
chaos on (chaos.py), `stream_reset` charges abort FunctionStreamOutputs
mid-flight.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import time

import grpc

from ..config import logger
from ..observability import tracing
from ..observability.catalog import INPUT_QUEUE_WAIT, TASK_RESULTS, WORKER_HEARTBEATS, WORKERS_READOPTED
from ..proto import api_pb2
from .journal import _b64 as _jb64
from .state import (
    AppState,
    DictState,
    FunctionCallState,
    FunctionState,
    ImageState,
    InputState,
    ProxyState,
    QueueState,
    SecretState,
    ServerState,
    TaskState_,
    WorkerState,
)

CREATE_IF_MISSING = api_pb2.OBJECT_CREATION_TYPE_CREATE_IF_MISSING
FAIL_IF_EXISTS = api_pb2.OBJECT_CREATION_TYPE_CREATE_FAIL_IF_EXISTS
EPHEMERAL = api_pb2.OBJECT_CREATION_TYPE_EPHEMERAL
ANONYMOUS = api_pb2.OBJECT_CREATION_TYPE_ANONYMOUS_OWNED_BY_APP
# the input-plane JWT's lifetime (MODAL_TPU_AUTH_TOKEN_TTL overrides, per call)
AUTH_TOKEN_TTL_S = 1200.0
# a draining worker that promised its containers no grace gets this one
# (MODAL_TPU_PREEMPT_GRACE overrides, per heartbeat)
PREEMPT_GRACE_S = 10.0
# how long a ProfileControl "stop" keeps riding the heartbeats: long enough
# for every live container's next few beats, short enough that a later
# container's env-enabled profiler is not stopped at boot
PROFILE_STOP_TTL_S = 60.0
_FINISHED_TASK_STATES = (
    api_pb2.TASK_STATE_COMPLETED,
    api_pb2.TASK_STATE_FAILED,
    api_pb2.TASK_STATE_TERMINATED,
    api_pb2.TASK_STATE_PREEMPTED,
)


def waiting_feature(definition: api_pb2.Function) -> str:
    """What of a function definition the port's control plane cannot run:
    TPU chips, which it never places (it places cards, `gpu_config`); ""
    if nothing."""
    if definition.resources.tpu_config.tpu_type:
        return (f"tpu_config ({definition.resources.tpu_config.tpu_type!r}) asks for TPU chips, which this control "
                f"plane does not place: ask for cards with gpu= (resources.gpu_config)")
    return ""


class ModalTPUServicer:
    """The function path's RPC handlers. One instance per control plane."""

    def __init__(self, state: ServerState):
        self.s = state
        self.scheduler = None  # wired by the supervisor (worker drains)
        self.chaos = None  # the plane's ChaosPolicy, wired by the supervisor
        self.supervisor = None  # the LocalSupervisor (ShardControl, JournalReplicate)
        # throttling surfaced to containers on every GetInputs response
        self.rate_limit_sleep_duration = 0.0

    # the durable control plane's hooks, read by proto/rpc.py at handler-build
    # time: the journal-backed idempotency cache (None with the journal off),
    # and the quorum replicator (None on a standalone plane)
    @property
    def idempotency(self):
        return self.s.idempotency

    @property
    def replicator(self):
        return self.s.replicator

    def _j(self, t: str, **payload) -> None:
        """Append one typed record to the write-ahead journal (a no-op with
        the journal off). Every mutating handler calls this with the effect
        it just applied: replay does not depend on the handlers."""
        j = self.s.journal
        if j is not None:
            j.append(t, **payload)

    def _journal_group(self):
        """Group-commit scope of a handler that appends many records: one
        flush, committed before the RPC returns."""
        import contextlib

        j = self.s.journal
        return j.group() if j is not None else contextlib.nullcontext()

    def _append_output(self, call: FunctionCallState, item: api_pb2.FunctionGetOutputsItem) -> bool:
        """The one funnel every delivered output goes through: dedupe by
        (input_id, retry_count) so a requeued input whose dead attempt
        already reported cannot deliver twice, then append and journal.
        Returns False for a duplicate."""
        key = f"{item.input_id}:{item.retry_count}"
        if item.input_id and key in call.output_keys:
            return False
        if item.input_id:
            call.output_keys.add(key)
        call.outputs.append(item)
        call.num_done += 1
        call.first_output_at = call.first_output_at or time.time()
        if self.s.journal is not None:  # no serialize and base64 with the journal off
            self._j("output", function_call_id=call.function_call_id, item=_jb64(item.SerializeToString()))
        return True

    async def maybe_compact(self) -> None:
        """Periodic compaction (the scheduler's reap tick): snapshot the
        state and prune covered segments once enough records pile up. The
        records are synthesized on the loop; the write runs in a thread."""
        from .journal import COMPACT_EVERY_RECORDS, synthesize_records

        j = self.s.journal
        if j is not None and j.records_since_snapshot() >= COMPACT_EVERY_RECORDS:
            await j.compact_async(synthesize_records(self.s))
            logger.info(f"journal compacted at seq {j.seq}")

    # ------------------------------------------------------------------
    # Misc
    # ------------------------------------------------------------------

    async def ClientHello(self, request: api_pb2.ClientHelloRequest, context) -> api_pb2.ClientHelloResponse:
        return api_pb2.ClientHelloResponse(
            server_version="0.1.0",
            # the workspace-wide setting (WorkspaceSettingsSet) wins over the
            # build default: a client takes it at its handshake
            image_builder_version=self.s.workspace_settings.get("image_builder_version", "2026.07"),
            input_plane_url=self.s.input_plane_url,
            # local fast-path coordinates: a client that can stat these paths
            # is co-located and upgrades its transport; others ignore them
            uds_path=self.s.uds_path,
            input_plane_uds_path=self.s.input_plane_uds,
            blob_local_dir=self.s.blob_local_dir,
        )

    async def AuthTokenGet(self, request: api_pb2.AuthTokenGetRequest, context) -> api_pb2.AuthTokenGetResponse:
        """An input-plane JWT, valid for AUTH_TOKEN_TTL_S."""
        from .._utils.jwt_utils import encode_jwt

        ttl = float(os.environ.get("MODAL_TPU_AUTH_TOKEN_TTL", AUTH_TOKEN_TTL_S))
        return api_pb2.AuthTokenGetResponse(token=encode_jwt({"sub": "input-plane"}, self.s.auth_secret, ttl_s=ttl))

    def _resolve_environment(self, name: str) -> str:
        """An empty environment name is the workspace's default environment
        (WorkspaceSettingsSet default_environment), else "" (the implicit
        main): the reference's per-workspace default (_workspace.py:420)."""
        return name or self.s.workspace_settings.get("default_environment", "")

    # ------------------------------------------------------------------
    # Environments, tokens and the workspace (reference _workspace.py:70;
    # the billing RPCs are not part of the contract)
    # ------------------------------------------------------------------

    async def EnvironmentList(self, request, context) -> api_pb2.EnvironmentListResponse:
        names = set(self.s.environments) | {env for env, _ in self.s.deployed_apps if env}
        return api_pb2.EnvironmentListResponse(items=[api_pb2.EnvironmentListItem(name=n) for n in sorted(names)])

    async def EnvironmentCreate(self, request, context) -> api_pb2.EnvironmentCreateResponse:
        if not request.name:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, "environment needs a name")
        self.s.environments.setdefault(request.name, "")
        self._j("environment", name=request.name, web_suffix=self.s.environments[request.name])
        return api_pb2.EnvironmentCreateResponse()

    async def EnvironmentDelete(self, request, context) -> api_pb2.EnvironmentDeleteResponse:
        if any(env == request.name for env, _ in self.s.deployed_apps):
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                                f"environment {request.name!r} still has deployed apps")
        self.s.environments.pop(request.name, None)
        self._j("environment_del", name=request.name)
        return api_pb2.EnvironmentDeleteResponse()

    async def EnvironmentUpdate(self, request, context) -> api_pb2.EnvironmentUpdateResponse:
        current = request.current_name
        if current not in self.s.environments:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"environment {current!r} not found")
        if request.HasField("web_suffix"):
            self.s.environments[current] = request.web_suffix
        if request.HasField("name") and request.name and request.name != current:
            if request.name in self.s.environments:
                await context.abort(grpc.StatusCode.ALREADY_EXISTS, f"environment {request.name!r} already exists")
            self.s.environments[request.name] = self.s.environments.pop(current)
            # deployments move with their environment
            for (env, app_name), app_id in list(self.s.deployed_apps.items()):
                if env == current:
                    del self.s.deployed_apps[(env, app_name)]
                    self.s.deployed_apps[(request.name, app_name)] = app_id
        rec: dict = {"current": current}
        if request.HasField("web_suffix"):
            rec["web_suffix"] = request.web_suffix
        if request.HasField("name") and request.name:
            rec["name"] = request.name
        self._j("environment_update", **rec)
        return api_pb2.EnvironmentUpdateResponse()

    async def TokenFlowCreate(self, request, context) -> api_pb2.TokenFlowCreateResponse:
        """Browser-completed token issuance (reference token_flow.py:1): the
        flow's web_url is a page of this plane's blob server; visiting it
        with the verification code approves the flow and unblocks
        TokenFlowWait. A headless caller waits with timeout=0 for an
        immediate local grant."""
        import secrets as _secrets

        flow_id = self.s.make_id("tf")
        flow = self.s.pending_token_flows[flow_id] = {
            "token_id": "tk-" + _secrets.token_hex(8),
            "token_secret": "ts-" + _secrets.token_hex(16),
            "code": _secrets.token_hex(3),
            "approved": asyncio.Event(),
            "localhost_port": request.localhost_port,
        }
        base = self.s.blob_url_base or ""
        web_url = f"{base}/auth/token-flow/{flow_id}?code={flow['code']}" if base else "local://token-granted"
        return api_pb2.TokenFlowCreateResponse(token_flow_id=flow_id, web_url=web_url, code=flow["code"])

    async def TokenFlowWait(self, request, context) -> api_pb2.TokenFlowWaitResponse:
        flow = self.s.pending_token_flows.get(request.token_flow_id)
        if flow is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "unknown token flow")
        if request.timeout > 0:
            # the browser flow: block until the page approves, or time out
            # (the CLI polls)
            try:
                await asyncio.wait_for(flow["approved"].wait(), request.timeout)
            except asyncio.TimeoutError:
                return api_pb2.TokenFlowWaitResponse(timeout=True)
        # a retried Wait may race another waiter of the same flow: the grant
        # is idempotent, both get the same credentials
        self.s.tokens[flow["token_id"]] = flow["token_secret"]
        self.s.token_granted_at.setdefault(flow["token_id"], time.time())
        self._j("token", token_id=flow["token_id"], token_secret=flow["token_secret"],
                granted_at=self.s.token_granted_at[flow["token_id"]])
        self.s.pending_token_flows.pop(request.token_flow_id, None)
        return api_pb2.TokenFlowWaitResponse(
            token_id=flow["token_id"], token_secret=flow["token_secret"], workspace_name="local"
        )

    # the settings this plane understands: WorkspaceSettingsSet refuses any
    # other name (the reference's settings manager has a curated set too,
    # _workspace.py:387)
    _WORKSPACE_SETTINGS = ("image_builder_version", "default_environment")

    async def WorkspaceNameLookup(self, request, context) -> api_pb2.WorkspaceNameLookupResponse:
        return api_pb2.WorkspaceNameLookupResponse(workspace_name="local", username="local")

    async def WorkspaceMemberList(self, request, context) -> api_pb2.WorkspaceMemberListResponse:
        ordered = sorted(self.s.tokens, key=lambda t: self.s.token_granted_at.get(t, 0.0))
        return api_pb2.WorkspaceMemberListResponse(members=[
            api_pb2.WorkspaceMemberInfo(username=token_id, role="owner" if i == 0 else "member",
                                        created_at=self.s.token_granted_at.get(token_id, 0.0))
            for i, token_id in enumerate(ordered)
        ])

    async def WorkspaceSettingsList(self, request, context) -> api_pb2.WorkspaceSettingsListResponse:
        return api_pb2.WorkspaceSettingsListResponse(settings=[
            api_pb2.WorkspaceSetting(name=k, value=v) for k, v in sorted(self.s.workspace_settings.items())
        ])

    async def WorkspaceSettingsSet(self, request, context) -> api_pb2.WorkspaceSettingsSetResponse:
        if request.name not in self._WORKSPACE_SETTINGS:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"unknown workspace setting {request.name!r} (known: {', '.join(self._WORKSPACE_SETTINGS)})",
            )
        if not request.value:
            # an empty value unsets (there is no separate delete RPC)
            self.s.workspace_settings.pop(request.name, None)
            self._j("ws_setting", name=request.name, value="")
            return api_pb2.WorkspaceSettingsSetResponse()
        if request.name == "image_builder_version":
            from ..builder import known_versions

            known = known_versions()
            if known and request.value not in known:
                await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                    f"unknown image builder version {request.value!r} (known: {', '.join(known)})")
        if request.name == "default_environment" and request.value not in self.s.environments:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"environment {request.value!r} does not exist")
        self.s.workspace_settings[request.name] = request.value
        self._j("ws_setting", name=request.name, value=request.value)
        return api_pb2.WorkspaceSettingsSetResponse()

    # ------------------------------------------------------------------
    # Apps
    # ------------------------------------------------------------------

    async def AppCreate(self, request: api_pb2.AppCreateRequest, context) -> api_pb2.AppCreateResponse:
        app_id = self.s.make_id("ap")
        app = self.s.apps[app_id] = AppState(
            app_id=app_id,
            description=request.description,
            state=request.app_state or api_pb2.APP_STATE_INITIALIZING,
            environment_name=self._resolve_environment(request.environment_name),
        )
        self._j("app", app_id=app_id, description=app.description, state=app.state,
                environment_name=app.environment_name)
        return api_pb2.AppCreateResponse(app_id=app_id, app_page_url=f"http://local/apps/{app_id}")

    async def AppGetOrCreate(self, request: api_pb2.AppGetOrCreateRequest, context) -> api_pb2.AppGetOrCreateResponse:
        key = (self._resolve_environment(request.environment_name), request.app_name)
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
            self._j("app", app_id=app_id, name=request.app_name, description=request.app_name,
                    state=api_pb2.APP_STATE_DEPLOYED, environment_name=key[0], deploy_name=request.app_name)
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
        self._j(
            "app_state",
            app_id=app.app_id,
            state=app.state,
            function_ids=dict(request.function_ids),
            class_ids=dict(request.class_ids),
            name=request.name or "",
            publish=True,  # replay re-keys deployed_functions (AppDeploy does not)
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
        self._j("app_state", app_id=app.app_id, state=app.state, done=True, stopped_at=app.stopped_at)
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
        self._j("app_state", app_id=app.app_id, state=app.state, name=request.name)
        return api_pb2.AppDeployResponse(url=f"http://local/apps/{app.app_id}")

    async def AppGetByDeploymentName(self, request, context) -> api_pb2.AppGetByDeploymentNameResponse:
        app_id = self.s.deployed_apps.get((self._resolve_environment(request.environment_name), request.name))
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

        threshold = int(os.environ.get("MODAL_TPU_MULTIPART_THRESHOLD", blob_utils.MULTIPART_THRESHOLD))
        if request.content_length >= threshold:
            part_bytes = int(os.environ.get("MODAL_TPU_MULTIPART_PART_LEN", blob_utils.MULTIPART_PART_BYTES))
            part_length = max(part_bytes, (request.content_length + 9_999) // 10_000)
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
            web_url=fn.web_url,
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
        if request.function.webhook_type != api_pb2.WEB_ENDPOINT_TYPE_UNSPECIFIED:
            # a web function serves HTTP, not a queue: at least one warm
            # container must exist for the endpoint to answer
            settings = request.function.autoscaler_settings
            settings.min_containers = max(1, settings.min_containers)
        fn = FunctionState(
            function_id=function_id,
            app_id=request.app_id,
            tag=request.tag or request.function.function_name,
            definition=request.function,
        )
        self.s.functions[function_id] = fn
        self._j("function", function_id=function_id, app_id=request.app_id, tag=fn.tag,
                definition=_jb64(request.function.SerializeToString()))
        app = self.s.apps.get(request.app_id)
        if app is not None:
            app.function_ids[fn.tag] = function_id
            self._j("app_state", app_id=app.app_id, state=app.state, function_ids={fn.tag: function_id})
        self.s.schedule_event.set()
        return api_pb2.FunctionCreateResponse(function_id=function_id, handle_metadata=self._function_metadata(fn))

    async def FunctionGet(self, request: api_pb2.FunctionGetRequest, context) -> api_pb2.FunctionGetResponse:
        key = (self._resolve_environment(request.environment_name), request.app_name, request.object_tag)
        fn_id = self.s.deployed_functions.get(key)
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
        if opts.has_tpu:
            bound_def.resources.tpu_config.CopyFrom(opts.tpu_config)  # refused below, as FunctionCreate refuses it
        if opts.has_gpu:
            bound_def.resources.gpu_config.CopyFrom(opts.gpu_config)  # the card ask ONLY
        if opts.has_retry_policy:
            bound_def.retry_policy.CopyFrom(opts.retry_policy)
        if opts.HasField("max_concurrent_inputs"):
            bound_def.max_concurrent_inputs = opts.max_concurrent_inputs
        if opts.replace_secrets:
            del bound_def.secret_ids[:]
            bound_def.secret_ids.extend(opts.secret_ids)
        waiting = waiting_feature(bound_def)
        if waiting:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"InvalidError: {waiting}")
        bound = FunctionState(
            function_id=self.s.make_id("fu"),
            app_id=parent.app_id,
            tag=parent.tag,
            definition=bound_def,
            bound_parent=parent.function_id,
            serialized_params=request.serialized_params,
        )
        self.s.functions[bound.function_id] = bound
        self._j("function", function_id=bound.function_id, app_id=parent.app_id, tag=parent.tag,
                definition=_jb64(bound_def.SerializeToString()), bound_parent=parent.function_id,
                serialized_params=_jb64(request.serialized_params))
        return api_pb2.FunctionBindParamsResponse(
            bound_function_id=bound.function_id, handle_metadata=self._function_metadata(bound)
        )

    async def FunctionSetWebUrl(self, request: api_pb2.FunctionSetWebUrlRequest, context) -> api_pb2.FunctionSetWebUrlResponse:
        fn = self.s.functions.get(request.function_id)
        if fn is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "function not found")
        fn.init_failures = 0  # a web container has booted
        fn.web_url = request.web_url
        async with fn.input_condition:
            fn.input_condition.notify_all()
        return api_pb2.FunctionSetWebUrlResponse()

    async def FunctionGetWebUrl(self, request: api_pb2.FunctionGetWebUrlRequest, context) -> api_pb2.FunctionGetWebUrlResponse:
        fn = self.s.functions.get(request.function_id)
        if fn is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "function not found")
        if fn.definition.webhook_type == api_pb2.WEB_ENDPOINT_TYPE_UNSPECIFIED:
            # fast-fail: a non-web function never grows a URL, so the client
            # must not wait out the long-poll window
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, "function has no web endpoint (webhook_type unset)")
        deadline = time.monotonic() + min(max(request.timeout, 0.0), 60.0)
        while time.monotonic() < deadline:
            async with fn.input_condition:
                # re-check UNDER the lock: a SetWebUrl notify between an
                # unlocked check and wait() would otherwise be lost
                if fn.web_url:
                    break
                try:
                    await asyncio.wait_for(fn.input_condition.wait(), timeout=max(0.05, deadline - time.monotonic()))
                except asyncio.TimeoutError:
                    break
        return api_pb2.FunctionGetWebUrlResponse(web_url=fn.web_url)

    async def FunctionUpdateSchedulingParams(self, request, context):
        fn = self.s.functions.get(request.function_id)
        if fn is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "function not found")
        fn.autoscaler_override = request.settings
        self._j("fn_sched", function_id=request.function_id, settings=_jb64(request.settings.SerializeToString()))
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
        if self.s.journal is not None:  # no serialize and base64 with the journal off
            self._j("input", input_id=inp.input_id, function_call_id=call.function_call_id,
                    function_id=fn.function_id, idx=item.idx, input=_jb64(item.input.SerializeToString()),
                    retry_count=0)
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
        with self._journal_group():
            # the call before its inputs (replay order): an input record
            # naming an unjournaled call would recover orphaned
            self._j("call", function_call_id=call.function_call_id, function_id=request.function_id,
                    call_type=call.call_type, invocation_type=call.invocation_type,
                    return_exceptions=call.return_exceptions)
            for item in request.pipelined_inputs:
                inp = self._enqueue_input(fn, call, item)
                resp.pipelined_inputs.append(
                    api_pb2.FunctionPutInputsResponseItem(idx=item.idx, input_id=inp.input_id))
        async with fn.input_condition:
            fn.input_condition.notify_all()
        self.s.schedule_event.set()
        return resp

    async def FunctionMapBatch(self, request: api_pb2.FunctionMapBatchRequest, context) -> api_pb2.FunctionMapBatchResponse:
        """Coalesced dispatch (_utils/coalescer.py): N `.remote()`s submitted
        within one client-side window arrive as one RPC. Each sub-request
        runs the FunctionMap path (its own call id, its own journal
        records); the journal group-commits the batch: one flush."""
        # validate EVERY sub-request before executing ANY: an abort must mean
        # "nothing happened", or the client's per-item resend would run the
        # successful prefix twice
        for sub in request.requests:
            if sub.function_id not in self.s.functions:
                await context.abort(grpc.StatusCode.NOT_FOUND, f"function {sub.function_id} not found")
        resp = api_pb2.FunctionMapBatchResponse()
        # group-commit across the sub-handler awaits is the DESIGN: N records,
        # one flush, committed before this RPC returns; journal.group() is
        # task-scoped, so interleaved handlers keep their per-record flush
        with self._journal_group():  # lint: disable=lock-across-await
            for sub in request.requests:
                if sub.function_id not in self.s.functions:
                    # gone BETWEEN validation and execution (an app stop
                    # racing an await): answer THIS item empty (no call id =
                    # not found), never abort after a partial execution
                    resp.responses.append(api_pb2.FunctionMapResponse())
                    continue
                resp.responses.append(await self.FunctionMap(sub, context))
        return resp

    async def FunctionPutInputs(self, request, context) -> api_pb2.FunctionPutInputsResponse:
        fn = self.s.functions.get(request.function_id)
        call = self.s.function_calls.get(request.function_call_id)
        if fn is None or call is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "function or call not found")
        resp = api_pb2.FunctionPutInputsResponse()
        with self._journal_group():
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
                # re-journal the payload, so a replay retries the new bytes
                # (the resume token rides along: the replacing record must
                # not drop a checkpoint)
                if self.s.journal is not None:
                    self._j("input", input_id=old.input_id, function_call_id=old.function_call_id,
                            function_id=call.function_id, idx=old.idx,
                            input=_jb64(old.input.SerializeToString()), retry_count=old.retry_count,
                            resume_token=old.resume_token)
            else:
                self._j("input_retry", input_id=old.input_id, retry_count=old.retry_count)
            old.delivered_to.clear()
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
        if request.clear_on_success and n:
            call.outputs_consumed += n
            # the consumption pointer survives a restart: a recovered call
            # must not re-deliver outputs this client already took
            self._j("consumed", function_call_id=call.function_call_id, n=call.outputs_consumed)
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
        client tell a quiet call from a dead stream. A chaos `stream_reset`
        charge aborts the stream mid-flight: the client degrades to the
        poll RPC."""
        call = self.s.function_calls.get(request.function_call_id)
        if call is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"call {request.function_call_id} not found")
        cursor = int(request.last_entry_id or 0)
        while True:
            if self.chaos is not None and self.chaos.consume_knob("stream_reset"):
                await context.abort(grpc.StatusCode.UNAVAILABLE, "chaos: output stream reset")
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
        self._j("call_cancel", function_call_id=call.function_call_id)
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
        if request.warm_pool_hit:
            task.warm_pool_hit = True  # served by a pre-forked warm-pool interpreter
        if request.sandbox_workdir:
            # the cwd the worker chose: a fs snapshot tars this, not a guess
            for sb in self.s.sandboxes.values():
                if sb.task_id == request.task_id:
                    sb.workdir = request.sandbox_workdir
                    break
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
        if self.s.profile_command == "stop" and time.time() - self.s.profile_command_set_at > PROFILE_STOP_TTL_S:
            # every container live at the stop has had many beats to apply
            # it; broadcast forever it would stop later containers'
            # env-enabled profilers at their first beat
            self.s.profile_command = ""
        if self.s.profile_command:
            # repeated on every beat; containers apply it idempotently
            resp.profile_command = self.s.profile_command
        if task.cancelled_input_ids:
            resp.cancel_input_event.input_ids.extend(task.cancelled_input_ids)
            task.cancelled_input_ids = []
        if task.terminate:
            resp.cancel_input_event.terminate_containers = True
        return resp

    async def ProfileControl(self, request, context) -> api_pb2.ProfileControlResponse:
        """The sampling profiler's switch (observability/profiler.py): it
        applies to the plane's process at once and reaches live containers
        through the heartbeat's profile_command."""
        from ..observability import profiler

        profiles_dir = os.path.join(self.s.state_dir, "observability", "profiles")
        action = request.action or "status"
        if action == "start":
            hz = request.hz or profiler.DEFAULT_HZ
            self.s.profile_command = f"start:{hz:g}"
            self.s.profile_command_set_at = time.time()
            profiler.start(profiles_dir, tag="supervisor", hz=hz)
        elif action == "stop":
            self.s.profile_command = "stop"
            self.s.profile_command_set_at = time.time()
            profiler.stop()
        elif action != "status":
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"unknown profile action {action!r}")
        prof = profiler.current()
        return api_pb2.ProfileControlResponse(
            running=profiler.running(),
            supervisor_profile_path=prof.path if prof is not None else "",
            n_samples=prof.n_samples if prof is not None else 0,
            profile_paths=profiler.list_profiles(profiles_dir),
        )

    async def MetricsHistory(self, request, context) -> api_pb2.MetricsHistoryResponse:
        """Windowed history and burn-rate alert queries against the
        time-series store (server/history.py; GET /metrics/history answers
        the same)."""
        from .history import history_payload

        payload = history_payload(
            self.s, query=request.query, family=request.family, window_s=request.window_s, q=request.q
        )
        return api_pb2.MetricsHistoryResponse(payload_json=json.dumps(payload))

    async def ShardControl(self, request, context) -> api_pb2.ShardControlResponse:
        """Administration of a shard (server/shards.py): the placement
        director drives health probes, the takeover of a partition and epoch
        fencing through this RPC, so a subprocess shard is driven as an
        in-process one is. Not journaled: the topology is runtime state, and
        the takeover it drives replays and compacts journals."""
        sup = self.supervisor
        if sup is None:
            await context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "shard administration requires a supervisor-attached servicer",
            )
        if request.epoch and hasattr(sup, "note_fleet_epoch"):
            # the director's probes carry the fleet epoch: the replicator
            # stamps later appends with it, so followers can fence a writer
            # that missed a takeover
            sup.note_fleet_epoch(request.epoch)
        if request.action == "status":
            return api_pb2.ShardControlResponse(payload_json=json.dumps(sup.shard_status()))
        if request.action == "adopt":
            report = await sup.adopt_partition(request.journal_dir, request.partition)
            return api_pb2.ShardControlResponse(payload_json=json.dumps(report))
        if request.action == "adopt_replica":
            # a quorum takeover: adopt the partition from this shard's
            # replica stream of the dead writer
            report = await sup.adopt_from_replica(
                request.shard_index, request.partition, request.epoch
            )
            return api_pb2.ShardControlResponse(payload_json=json.dumps(report))
        if request.action == "fence":
            # fencing stops the very gRPC server carrying this call: run it as
            # a task so the response gets out before the listener dies
            t = asyncio.create_task(sup.fence(request.epoch))
            sup._chaos_subtasks.add(t)
            t.add_done_callback(sup._chaos_subtasks.discard)
            return api_pb2.ShardControlResponse(
                payload_json=json.dumps({"fencing": True, "epoch": request.epoch})
            )
        await context.abort(
            grpc.StatusCode.INVALID_ARGUMENT, f"unknown shard action {request.action!r}"
        )

    async def JournalReplicate(self, request, context) -> api_pb2.JournalReplicateResponse:
        """The follower side of quorum journal replication
        (server/replication.py): a peer writer streams its appends, its
        compacted snapshots and seal requests here, into this shard's
        ReplicaStore stream of that writer. Every message carries the
        writer's fleet epoch and a stale one is refused (a fencing token), so
        a cut-off old writer cannot commit past a takeover. Not journaled:
        the payload is journal records."""
        sup = self.supervisor
        store = getattr(sup, "replica_store", None) if sup is not None else None
        if store is None:
            await context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "journal replication requires a replica store (journaling + replicas > 0)",
            )
        kind = request.kind
        # payload is newline-joined record lines, not a JSON array: the hot
        # append path must not re-encode/re-parse what is already JSONL
        lines = request.payload_json.split("\n") if request.payload_json else []
        if kind == "append":
            result = store.append(
                request.writer_shard,
                request.epoch,
                lines,
                incarnation=request.incarnation,
                boot_seq=request.boot_seq,
            )
        elif kind == "snapshot":
            result = store.install_snapshot(
                request.writer_shard,
                request.epoch,
                request.base_seq,
                lines,
                incarnation=request.incarnation,
                boot_seq=request.boot_seq,
            )
        elif kind == "seal":
            result = store.seal(request.writer_shard, request.epoch)
        elif kind == "status":
            result = store.status(request.writer_shard)
        else:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, f"unknown replicate kind {request.kind!r}"
            )
        return api_pb2.JournalReplicateResponse(payload_json=json.dumps(result))

    async def AppListProfiles(self, request: api_pb2.AppListProfilesRequest, context) -> api_pb2.AppListProfilesResponse:
        """The torch.profiler traces that runtime_debug tasks of this app
        wrote (`<task_dir>/profile`, the container entrypoint's
        `_maybe_profile`); `num_traces` counts the Chrome traces
        (`*.pt.trace.json`) where the JAX plane counts `.xplane.pb` files
        (ROADMAP Queue C 33)."""
        out = []
        for task in self.s.tasks.values():
            if request.app_id and task.app_id != request.app_id:
                continue
            profile_dir = os.path.join(self.s.state_dir, "tasks", task.task_id, "profile")
            if not os.path.isdir(profile_dir):
                continue
            size = 0
            traces = 0
            for root, _dirs, files in os.walk(profile_dir):
                for f in files:
                    try:
                        size += os.path.getsize(os.path.join(root, f))
                    except OSError:
                        pass
                    if f.endswith(".pt.trace.json"):
                        traces += 1
            out.append(api_pb2.ProfileEntry(task_id=task.task_id, path=profile_dir, size_bytes=size, num_traces=traces))
        return api_pb2.AppListProfilesResponse(profiles=out)

    async def TaskGetTimeline(self, request: api_pb2.TaskGetTimelineRequest, context) -> api_pb2.TaskGetTimelineResponse:
        """A task's boot and serve stamps for cold-start attribution (set by
        the plane at assignment, ContainerHello, first input and first
        output); by function call, every task that claimed or delivered one
        of its inputs."""
        resp = api_pb2.TaskGetTimelineResponse()
        task_ids: list[str] = []
        if request.task_id:
            if request.task_id not in self.s.tasks:
                await context.abort(grpc.StatusCode.NOT_FOUND, "task not found")
            task_ids = [request.task_id]
        elif request.function_call_id:
            call = self.s.function_calls.get(request.function_call_id)
            if call is None:
                await context.abort(grpc.StatusCode.NOT_FOUND, "call not found")
            resp.call_created_at = call.created_at
            resp.call_first_output_at = call.first_output_at
            seen: set[str] = set()
            for iid in call.input_ids:
                inp = self.s.inputs.get(iid)
                if inp is None:
                    continue
                for tid in [inp.claimed_by, *inp.delivered_to]:
                    if tid and tid not in seen:
                        seen.add(tid)
                        task_ids.append(tid)
        for tid in task_ids:
            task = self.s.tasks.get(tid)
            if task is None:
                continue
            resp.tasks.append(
                api_pb2.TaskTimeline(
                    task_id=task.task_id,
                    created_at=task.created_at,
                    started_at=task.started_at,
                    first_input_at=task.first_input_at,
                    first_output_at=task.first_output_at,
                    finished_at=task.finished_at,
                    warm_pool_hit=task.warm_pool_hit,
                )
            )
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

    @staticmethod
    def _input_item(task: TaskState_, inp: InputState) -> api_pb2.FunctionGetInputsItem:
        task.first_input_at = task.first_input_at or time.time()
        return api_pb2.FunctionGetInputsItem(
            input_id=inp.input_id,
            input=inp.input,
            function_call_id=inp.function_call_id,
            idx=inp.idx,
            retry_count=inp.retry_count,
            resume_token=inp.resume_token,
            trace_context=inp.trace_context,
            claimed_at=inp.claimed_at,
        )

    async def FunctionGetInputs(self, request: api_pb2.FunctionGetInputsRequest, context) -> api_pb2.FunctionGetInputsResponse:
        fn = self.s.functions.get(request.function_id)
        task = self.s.tasks.get(request.task_id)
        if fn is None or task is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "function or task not found")
        # a container that asks for inputs has booted: init is healthy (its
        # hello comes before the user's import and @enter hooks)
        fn.init_failures = 0
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
            cluster = self.s.clusters.get(task.cluster_id) if task.cluster_id else None
            # batching linger: once the first input of a batch is seen, wait
            # up to batch_linger_ms for the batch to fill
            linger_deadline = None
            while True:
                if cluster is not None and fn.definition.broadcast_inputs:
                    # gang broadcast: every rank gets each input, which leaves
                    # the queue once all have it; the first claiming rank's
                    # gang owns it. Rank 0's SUCCESS is the output, a FAILURE
                    # from any rank fails it (_put_outputs)
                    for input_id in list(fn.pending):
                        if len(items) >= batch_size:
                            break
                        inp = self.s.inputs[input_id]
                        if inp.status != "pending" or task.task_id in inp.delivered_to:
                            continue
                        claimer = self.s.tasks.get(inp.claimed_by) if inp.claimed_by else None
                        if claimer is not None and claimer.cluster_id != task.cluster_id:
                            continue
                        inp.delivered_to.add(task.task_id)
                        inp.claimed_by = inp.claimed_by or task.task_id
                        inp.claimed_at = inp.claimed_at or time.time()
                        if len(inp.delivered_to) >= cluster.size:
                            inp.status = "claimed"
                            fn.pending.remove(input_id)
                            self._note_input_claimed(fn, inp)
                        items.append(self._input_item(task, inp))
                    break
                while fn.pending and len(items) < batch_size:
                    inp = self.s.inputs[fn.pending.pop(0)]
                    if inp.status != "pending":
                        continue
                    inp.status = "claimed"
                    inp.claimed_by = task.task_id
                    inp.claimed_at = time.time()
                    self._note_input_claimed(fn, inp)
                    items.append(self._input_item(task, inp))
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
        # task-scoped group-commit (see FunctionMapBatch): intentional hold
        with self._journal_group():  # lint: disable=lock-across-await
            return await self._put_outputs(request)

    async def FunctionExchange(self, request: api_pb2.FunctionExchangeRequest, context) -> api_pb2.FunctionGetInputsResponse:
        """One container turnaround in one RPC: apply the finished inputs'
        outputs (the same dedupe as FunctionPutOutputs), then run the
        FunctionGetInputs long-poll. Outputs land and notify their waiters
        before the poll blocks."""
        from ..observability.catalog import DISPATCH_EXCHANGES

        if request.HasField("put") and request.put.outputs:
            DISPATCH_EXCHANGES.inc(carried="with_outputs")
            # task-scoped group-commit (see FunctionMapBatch): intentional hold
            with self._journal_group():  # lint: disable=lock-across-await
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
                    continue  # duplicate (a gang peer's, say)
                if (pushing_task is not None and pushing_task.cluster_id and pushing_task.rank != 0
                        and inp.delivered_to and item.result.status == api_pb2.GENERIC_STATUS_SUCCESS):
                    continue  # a broadcast gang's output is rank 0's
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
                inp.claimed_by == request.task_id
                or request.task_id in inp.delivered_to
                or (not inp.claimed_by and not inp.resume_token)
            ):
                inp.resume_token = request.resume_token
                # the checkpoint survives a crash of the plane too
                self._j("input_token", input_id=request.input_id, resume_token=request.resume_token)
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
                    cluster_id=task.cluster_id,
                    rank=task.rank,
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

    def _gang_of(self, task: TaskState_) -> set:
        cluster = self.s.clusters.get(task.cluster_id) if task.cluster_id else None
        return set(cluster.task_ids) if cluster is not None else set()

    async def _fail_claimed_inputs(self, task: TaskState_, result: api_pb2.GenericResult) -> None:
        """Inputs claimed by a dead container retry under the function's
        policy, or fail once it is spent. A gang fails as a unit: a dead
        rank preempts its live peers, and every input delivered to the gang
        (a broadcast input may be claimed by any rank, or be partly
        delivered) retries or fails, each consuming a retry."""
        gang = self._gang_of(task)
        for peer_id in gang - {task.task_id}:
            peer = self.s.tasks.get(peer_id)
            if peer is not None and not peer.terminate:
                peer.terminate = True
                peer.preempted = True  # surfaces as TASK_STATE_PREEMPTED
                worker = self.s.workers.get(peer.worker_id)
                if worker is not None:
                    await worker.events.put(api_pb2.WorkerPollResponse(stop=api_pb2.TaskStopEvent(task_id=peer_id)))
        dead = gang | {task.task_id}
        fn = self.s.functions.get(task.function_id)
        for inp in self.s.inputs.values():
            touched_pending = inp.status == "pending" and bool(inp.delivered_to & dead or inp.claimed_by in dead)
            claimed = inp.status == "claimed" and (
                inp.claimed_by == task.task_id or bool(gang and (inp.claimed_by in gang or task.task_id in inp.delivered_to)))
            if not (touched_pending or claimed):
                continue
            call = self.s.function_calls.get(inp.function_call_id)
            if call is None or fn is None:
                continue
            if inp.retry_count < fn.definition.retry_policy.retries:
                inp.retry_count += 1
                inp.status = "pending"
                self._j("input_retry", input_id=inp.input_id, retry_count=inp.retry_count)
                inp.delivered_to -= dead
                inp.claimed_by = ""
                inp.claimed_at = 0.0
                if inp.input_id not in fn.pending:
                    fn.pending.append(inp.input_id)
                async with fn.input_condition:
                    fn.input_condition.notify_all()
                self.s.schedule_event.set()
            else:
                inp.status = "done"
                if inp.input_id in fn.pending:  # a partly delivered broadcast input
                    fn.pending.remove(inp.input_id)
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
        the next attempt. A gang's inputs requeue as a unit. Idempotent: the
        gang's ranks reporting one after another requeue each input once."""
        dead = self._gang_of(task) | {task.task_id}
        fn = self.s.functions.get(task.function_id)
        if fn is None:
            return
        requeued = 0
        for inp in self.s.inputs.values():
            touched = bool(inp.delivered_to & dead or inp.claimed_by in dead)
            if not touched or inp.status not in ("pending", "claimed"):
                continue
            inp.status = "pending"
            inp.delivered_to -= dead
            inp.claimed_by = ""
            inp.claimed_at = 0.0
            if inp.input_id not in fn.pending:
                fn.pending.append(inp.input_id)
            # a free requeue, journaled: a crash after the preemption
            # replays the input as pending
            self._j("input_retry", input_id=inp.input_id, retry_count=inp.retry_count)
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
        # forward() tunnels the container left open (a crash, or no exit)
        for key in [k for k in self.s.tunnels if k[0] == task.task_id]:
            entry = self.s.tunnels.pop(key)
            if isinstance(entry, asyncio.Future):
                if not entry.done():
                    entry.set_result(None)
            elif entry[0] is not None:
                entry[0].close()
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
            router_address=request.router_address,
            region=request.region,
            zone=request.zone,
            spot=request.spot,
            instance_type=request.instance_type,
        )
        self._j("worker", worker_id=worker_id, hostname=request.hostname, gpu_type=request.gpu_type,
                num_gpus=request.num_gpus, milli_cpu=request.milli_cpu, memory_mb=request.memory_mb,
                container_address=request.container_address, router_address=request.router_address,
                region=request.region, zone=request.zone, spot=request.spot, instance_type=request.instance_type)
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
        if worker.adoption_pending:
            # a journal-recovered worker proved it outlived the crash:
            # placements may land on it again
            worker.adoption_pending = False
            worker.recovered_at = 0.0
            WORKERS_READOPTED.inc()
            logger.info(f"worker {request.worker_id} re-adopted after recovery")
            self.s.schedule_event.set()
        WORKER_HEARTBEATS.inc()
        worker.last_heartbeat = time.time()
        worker.warm_pool_ready = request.warm_pool_ready
        if request.draining and not worker.draining and self.scheduler is not None:
            # the worker announces its preemption and signals its own
            # containers; honor the grace it promised them
            grace = request.drain_grace_s or float(os.environ.get("MODAL_TPU_PREEMPT_GRACE", PREEMPT_GRACE_S))
            await self.scheduler.drain_worker(request.worker_id, grace_s=grace, notify_worker=False)
        return api_pb2.WorkerHeartbeatResponse()


    # ------------------------------------------------------------------
    # Images: the plane registers each definition by its content hash; the
    # worker builds the layer chain on first use (server/image_builder.py)
    # and a build that fails fails the task with INIT_FAILURE
    # ------------------------------------------------------------------

    async def ImageGetOrCreate(self, request: api_pb2.ImageGetOrCreateRequest, context) -> api_pb2.ImageGetOrCreateResponse:
        key = hashlib.sha256(request.image.SerializeToString(deterministic=True)).hexdigest()[:16]
        image_id = self.s.images_by_hash.get(key)
        if image_id is None:
            image_id = self.s.make_id("im")
            metadata = api_pb2.ImageMetadata(
                image_builder_version=request.builder_version or "2026.07", python_version="local"
            )
            self.s.images[image_id] = ImageState(image_id=image_id, definition=request.image, metadata=metadata,
                                                 built=True)
            self.s.images_by_hash[key] = image_id
            self._j("image", image_id=image_id, definition=_jb64(request.image.SerializeToString()),
                    metadata=_jb64(metadata.SerializeToString()), built=True, hash_key=key)
        return api_pb2.ImageGetOrCreateResponse(image_id=image_id, metadata=self.s.images[image_id].metadata)

    async def ImageJoinStreaming(self, request, context) -> api_pb2.ImageJoinStreamingResponse:
        image = self.s.images.get(request.image_id)
        if image is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "image not found")
        return api_pb2.ImageJoinStreamingResponse(
            result=api_pb2.GenericResult(status=api_pb2.GENERIC_STATUS_SUCCESS), eof=True, metadata=image.metadata
        )

    async def ImageFromId(self, request, context) -> api_pb2.ImageFromIdResponse:
        image = self.s.images.get(request.image_id)
        if image is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "image not found")
        return api_pb2.ImageFromIdResponse(image_id=request.image_id, metadata=image.metadata,
                                           definition=image.definition)

    def _image_refs(self) -> dict[str, int]:
        """Pin counts for an image prune: an image is pinned while a function
        or sandbox of a running app names it (a scale-to-zero deployment
        included: its autoscaler can start a task later), and a FROM chain's
        base images by their pinned children."""
        refs: dict[str, int] = {}

        def add_with_parents(image_id: str) -> None:
            for _ in range(32):  # FROM chains are short; bound anyway
                if not image_id:
                    return
                refs[image_id] = refs.get(image_id, 0) + 1
                img = self.s.images.get(image_id)
                if img is None:
                    return
                image_id = next((c.strip()[5:].strip() for c in img.definition.dockerfile_commands
                                 if c.strip().startswith("FROM im-")), "")

        def app_alive(app_id: str) -> bool:
            app = self.s.apps.get(app_id)
            return app is not None and not app.done

        for fn in self.s.functions.values():
            if fn.definition.image_id and app_alive(fn.app_id):
                add_with_parents(fn.definition.image_id)
        for sb in self.s.sandboxes.values():
            if sb.definition.image_id and sb.state != api_pb2.SANDBOX_STATE_TERMINATED:
                add_with_parents(sb.definition.image_id)
        return refs

    async def ImageList(self, request, context) -> api_pb2.ImageListResponse:
        refs = self._image_refs()
        return api_pb2.ImageListResponse(images=[
            api_pb2.ImageInfo(image_id=image.image_id, built=image.built,
                              builder_version=image.metadata.image_builder_version,
                              python_version=image.metadata.python_version, created_at=image.created_at,
                              ref_count=refs.get(image.image_id, 0))
            for image in self.s.images.values()
        ])

    async def ImageDelete(self, request: api_pb2.ImageDeleteRequest, context) -> api_pb2.ImageDeleteResponse:
        """Delete an image RECORD (an image prune's building block). A pinned
        image is refused: a record has no rebuild path from its id, so
        deleting a referenced one would fail every later cold start. The
        content-addressed venv on disk is shared and stays."""
        if request.image_id in self._image_refs():
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                                f"image {request.image_id} is referenced by a live app/sandbox")
        self.s.images.pop(request.image_id, None)
        # the content-hash index stays consistent: a later ImageGetOrCreate of
        # the same definition mints a fresh record, not a dangling id
        for key, image_id in list(self.s.images_by_hash.items()):
            if image_id == request.image_id:
                del self.s.images_by_hash[key]
        self._j("image_del", image_id=request.image_id)
        return api_pb2.ImageDeleteResponse()

    # ------------------------------------------------------------------
    # Mounts: file contents by sha256 in the block store, a manifest per
    # mount (the worker shares the client's filesystem: nothing is copied
    # into a container)
    # ------------------------------------------------------------------

    async def MountPutFile(self, request: api_pb2.MountPutFileRequest, context) -> api_pb2.MountPutFileResponse:
        if request.WhichOneof("data_oneof") is None:
            return api_pb2.MountPutFileResponse(exists=self.s.has_block(request.sha256_hex))
        data = request.data
        if request.data_blob_id:
            with open(self.s.blob_path(request.data_blob_id), "rb") as f:
                data = f.read()
        self.s.put_block(request.sha256_hex, data)
        return api_pb2.MountPutFileResponse(exists=True)

    async def MountGetOrCreate(self, request: api_pb2.MountGetOrCreateRequest, context) -> api_pb2.MountGetOrCreateResponse:
        missing = [f.sha256_hex for f in request.files if not self.s.has_block(f.sha256_hex)]
        if missing:
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION, f"missing file content: {missing[:3]}")
        mount_id = self.s.make_id("mo")
        manifest = json.dumps(
            [{"filename": f.filename, "sha256_hex": f.sha256_hex, "mode": f.mode, "size": f.size}
             for f in request.files]
        ).encode()
        self.s.put_block("mount-" + mount_id, manifest)
        return api_pb2.MountGetOrCreateResponse(
            mount_id=mount_id,
            handle_metadata=api_pb2.MountHandleMetadata(content_checksum_sha256_hex=hashlib.sha256(manifest).hexdigest()),
        )

    # ------------------------------------------------------------------
    # Secrets: env dicts, resolved into a container's env at placement
    # (scheduler._container_arguments).
    # ------------------------------------------------------------------

    async def SecretGetOrCreate(self, request: api_pb2.SecretGetOrCreateRequest, context) -> api_pb2.SecretGetOrCreateResponse:
        if request.object_creation_type in (ANONYMOUS, EPHEMERAL) or (not request.deployment_name and request.env_dict):
            secret_id = self.s.make_id("st")
            self.s.secrets[secret_id] = SecretState(secret_id=secret_id, env_dict=dict(request.env_dict))
            self._j("secret", secret_id=secret_id, env=dict(request.env_dict))
            return api_pb2.SecretGetOrCreateResponse(secret_id=secret_id)
        key = (self._resolve_environment(request.environment_name), request.deployment_name)
        secret_id = self.s.deployed_secrets.get(key)
        if secret_id is None:
            if request.object_creation_type not in (CREATE_IF_MISSING, FAIL_IF_EXISTS) and not request.env_dict:
                await context.abort(grpc.StatusCode.NOT_FOUND, f"secret {request.deployment_name!r} not found")
            secret_id = self.s.make_id("st")
            self.s.secrets[secret_id] = SecretState(secret_id=secret_id, name=request.deployment_name,
                                                    env_dict=dict(request.env_dict))
            self.s.deployed_secrets[key] = secret_id
            self._j("secret", secret_id=secret_id, name=request.deployment_name, env=dict(request.env_dict),
                    deploy_key=list(key))
        elif request.object_creation_type == FAIL_IF_EXISTS:
            await context.abort(grpc.StatusCode.ALREADY_EXISTS, "secret exists")
        elif request.env_dict:
            self.s.secrets[secret_id].env_dict = dict(request.env_dict)
            self._j("secret", secret_id=secret_id, name=self.s.secrets[secret_id].name, env=dict(request.env_dict),
                    deploy_key=list(key))
        self.s.secrets[secret_id].last_used_at = time.time()
        return api_pb2.SecretGetOrCreateResponse(secret_id=secret_id)

    async def SecretList(self, request, context) -> api_pb2.SecretListResponse:
        return api_pb2.SecretListResponse(items=[
            api_pb2.SecretListItem(label=s.name, created_at=s.created_at, last_used_at=s.last_used_at,
                                   secret_id=s.secret_id)
            for s in self.s.secrets.values() if s.name
        ])

    async def SecretDelete(self, request, context) -> api_pb2.SecretDeleteResponse:
        secret = self.s.secrets.pop(request.secret_id, None)
        if secret is not None:
            for key, sid in list(self.s.deployed_secrets.items()):
                if sid == request.secret_id:
                    del self.s.deployed_secrets[key]
            self._j("secret_del", secret_id=request.secret_id)
        return api_pb2.SecretDeleteResponse()

    # ------------------------------------------------------------------
    # Volumes: files are block lists over the content-addressed block
    # store; the blocks travel by VolumeBlockPut/Get or the blob server's
    # /block and /volfile routes, or are read in place by a co-located
    # client (VolumeGetFile2 advertises the block dir)
    # ------------------------------------------------------------------

    async def VolumeGetOrCreate(self, request: api_pb2.VolumeGetOrCreateRequest, context) -> api_pb2.VolumeGetOrCreateResponse:
        from .state import VolumeState

        if request.object_creation_type == EPHEMERAL or not request.deployment_name:
            volume_id = self.s.make_id("vo")
            ephemeral = request.object_creation_type == EPHEMERAL
            self.s.volumes[volume_id] = VolumeState(volume_id=volume_id, version=request.version, ephemeral=ephemeral,
                                                    last_heartbeat=time.time())
            self._j("volume", volume_id=volume_id, version=request.version, ephemeral=ephemeral)
            return api_pb2.VolumeGetOrCreateResponse(volume_id=volume_id,
                                                     metadata=api_pb2.VolumeMetadata(version=request.version))
        key = (self._resolve_environment(request.environment_name), request.deployment_name)
        volume_id = self.s.deployed_volumes.get(key)
        if volume_id is None:
            if request.object_creation_type not in (CREATE_IF_MISSING, FAIL_IF_EXISTS):
                await context.abort(grpc.StatusCode.NOT_FOUND, f"volume {request.deployment_name!r} not found")
            volume_id = self.s.make_id("vo")
            self.s.volumes[volume_id] = VolumeState(volume_id=volume_id, name=request.deployment_name,
                                                    version=request.version)
            self.s.deployed_volumes[key] = volume_id
            self._j("volume", volume_id=volume_id, name=request.deployment_name, version=request.version,
                    deploy_key=list(key))
        vol = self.s.volumes[volume_id]
        return api_pb2.VolumeGetOrCreateResponse(volume_id=volume_id,
                                                 metadata=api_pb2.VolumeMetadata(version=vol.version, name=vol.name))

    async def _volume(self, volume_id: str, context):
        vol = self.s.volumes.get(volume_id)
        if vol is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        return vol

    async def VolumePutFiles2(self, request: api_pb2.VolumePutFiles2Request, context) -> api_pb2.VolumePutFiles2Response:
        """Register files by their block lists; answers the blocks the store
        lacks instead (the client uploads those, then puts again)."""
        vol = await self._volume(request.volume_id, context)
        missing = sorted({sha for f in request.files for sha in f.block_sha256_hex if not self.s.has_block(sha)})
        if missing:
            return api_pb2.VolumePutFiles2Response(missing_blocks=missing)
        stored = []
        for f in request.files:
            path = f.path.lstrip("/")
            if request.disallow_overwrite_existing_files and path in vol.files:
                await context.abort(grpc.StatusCode.ALREADY_EXISTS, f"file {path!r} already exists")
            new = api_pb2.VolumeFile()
            new.CopyFrom(f)
            new.path = path
            new.mtime = time.time()
            vol.files[path] = new
            stored.append(new)
        if stored:
            self._j("volume_files", volume_id=request.volume_id, files=[_jb64(f.SerializeToString()) for f in stored])
        return api_pb2.VolumePutFiles2Response()

    async def VolumeBlockPut(self, request, context) -> api_pb2.VolumeBlockPutResponse:
        # the hash and the write run in a thread (both release the GIL): the
        # loop serves a batch's other block puts meanwhile
        if not await asyncio.to_thread(self._put_verified_block, request.sha256_hex, request.data):
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, "block hash mismatch")
        return api_pb2.VolumeBlockPutResponse()

    def _put_verified_block(self, sha256_hex: str, data: bytes) -> bool:
        if hashlib.sha256(data).hexdigest() != sha256_hex:
            return False
        self.s.put_block(sha256_hex, data)
        return True

    async def VolumeBlockGet(self, request, context) -> api_pb2.VolumeBlockGetResponse:
        if not self.s.has_block(request.sha256_hex):
            await context.abort(grpc.StatusCode.NOT_FOUND, "block not found")
        data = await asyncio.to_thread(self.s.get_block, request.sha256_hex, request.offset, request.length)
        return api_pb2.VolumeBlockGetResponse(data=data)

    async def VolumeGetFile2(self, request, context) -> api_pb2.VolumeGetFile2Response:
        from .._utils.hash_utils import BLOCK_SIZE

        vol = await self._volume(request.volume_id, context)
        f = vol.files.get(request.path.lstrip("/"))
        if f is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"file {request.path!r} not found")
        # the HTTP block plane (Range-capable GET /block/{sha}) and the block
        # dir: a co-located client preads from the page cache
        return api_pb2.VolumeGetFile2Response(file=f, block_size=BLOCK_SIZE, block_url_base=self.s.blob_url_base or "",
                                              block_local_dir=self.s.block_dir)

    async def VolumeListFiles(self, request, context) -> api_pb2.VolumeListFilesResponse:
        vol = await self._volume(request.volume_id, context)
        prefix = request.path.lstrip("/").rstrip("/")
        files = []
        for path, f in sorted(vol.files.items()):
            if prefix and not (path == prefix or path.startswith(prefix + "/")):
                continue
            rel = path[len(prefix):].lstrip("/") if prefix else path
            if not request.recursive and "/" in rel:
                continue
            files.append(f)
        return api_pb2.VolumeListFilesResponse(files=files)

    async def VolumeRemoveFile(self, request, context) -> api_pb2.VolumeRemoveFileResponse:
        vol = await self._volume(request.volume_id, context)
        path = request.path.lstrip("/")
        if request.recursive:
            for p in [p for p in vol.files if p == path or p.startswith(path + "/")]:
                del vol.files[p]
        elif path in vol.files:
            del vol.files[path]
        else:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"file {path!r} not found")
        self._j("volume_rm", volume_id=request.volume_id, path=path, recursive=request.recursive)
        return api_pb2.VolumeRemoveFileResponse()

    async def VolumeCopyFiles(self, request, context) -> api_pb2.VolumeCopyFilesResponse:
        vol = await self._volume(request.volume_id, context)
        dst = request.dst_path.lstrip("/")
        into_dir = dst.endswith("/") or len(request.src_paths) > 1
        copied = []
        for src in request.src_paths:
            src = src.lstrip("/")
            f = vol.files.get(src)
            if f is None:
                await context.abort(grpc.StatusCode.NOT_FOUND, f"file {src!r} not found")
            new = api_pb2.VolumeFile()
            new.CopyFrom(f)
            new.path = dst.rstrip("/") + "/" + src.rsplit("/", 1)[-1] if into_dir else dst
            vol.files[new.path] = new
            copied.append(new)
        if copied:
            self._j("volume_files", volume_id=request.volume_id, files=[_jb64(f.SerializeToString()) for f in copied])
        return api_pb2.VolumeCopyFilesResponse()

    async def VolumeCommit(self, request, context) -> api_pb2.VolumeCommitResponse:
        vol = await self._volume(request.volume_id, context)
        vol.committed_version += 1
        self._j("volume_meta", volume_id=request.volume_id, committed_version=vol.committed_version)
        return api_pb2.VolumeCommitResponse(skip_reload=False)

    async def VolumeReload(self, request, context) -> api_pb2.VolumeReloadResponse:
        await self._volume(request.volume_id, context)
        return api_pb2.VolumeReloadResponse()

    async def VolumeRename(self, request, context) -> api_pb2.VolumeRenameResponse:
        vol = await self._volume(request.volume_id, context)
        for key, vid in list(self.s.deployed_volumes.items()):
            if vid == vol.volume_id:
                del self.s.deployed_volumes[key]
                self.s.deployed_volumes[(key[0], request.name)] = vid
        vol.name = request.name
        self._j("volume_meta", volume_id=request.volume_id, name=request.name)
        return api_pb2.VolumeRenameResponse()

    async def VolumeDelete(self, request, context) -> api_pb2.VolumeDeleteResponse:
        if self.s.volumes.pop(request.volume_id, None) is not None:
            for key, vid in list(self.s.deployed_volumes.items()):
                if vid == request.volume_id:
                    del self.s.deployed_volumes[key]
            self._j("volume_del", volume_id=request.volume_id)
        return api_pb2.VolumeDeleteResponse()

    async def VolumeList(self, request, context) -> api_pb2.VolumeListResponse:
        return api_pb2.VolumeListResponse(items=[
            api_pb2.VolumeListItem(volume_id=v.volume_id, name=v.name, created_at=v.created_at, version=v.version)
            for v in self.s.volumes.values() if v.name
        ])

    async def EphemeralObjectHeartbeat(self, request, context) -> api_pb2.EphemeralObjectHeartbeatResponse:
        """Liveness of an ephemeral dict, queue or volume (reference
        _object.py:21)."""
        pools = {"di": self.s.dicts, "qu": self.s.queues, "vo": self.s.volumes}
        pool = pools.get(request.object_id[:2])
        obj = pool.get(request.object_id) if pool is not None else None
        if obj is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"no such object {request.object_id}")
        obj.last_heartbeat = time.time()
        return api_pb2.EphemeralObjectHeartbeatResponse(ttl_seconds=self.ephemeral_ttl_seconds())

    @staticmethod
    def ephemeral_ttl_seconds() -> float:
        """How long an ephemeral object outlives its last heartbeat; the
        client heartbeats at a third of it (object.py)."""
        return float(os.environ.get("MODAL_TPU_EPHEMERAL_TTL", "900"))

    def reap_stale_ephemerals(self) -> int:
        """Drop the ephemeral dicts, queues and volumes whose client stopped
        heartbeating (the scheduler's reap tick). Returns how many went."""
        cutoff = time.time() - self.ephemeral_ttl_seconds()
        reaped = 0
        for pool in (self.s.dicts, self.s.queues, self.s.volumes):
            for obj_id in [oid for oid, obj in pool.items()
                           if obj.ephemeral and obj.last_heartbeat and obj.last_heartbeat < cutoff]:
                logger.debug(f"reaping stale ephemeral object {obj_id}")
                del pool[obj_id]
                reaped += 1
        return reaped

    # ------------------------------------------------------------------
    # Gangs: the rendezvous and the listing
    # ------------------------------------------------------------------

    async def TaskClusterHello(self, request: api_pb2.TaskClusterHelloRequest, context) -> api_pb2.TaskClusterHelloResponse:
        """Gang rendezvous: block until every rank has reported, then answer
        this rank, the world size and the coordinator (rank 0's host, the
        gang's port), where the container's process group meets."""
        task = self.s.tasks.get(request.task_id)
        if task is None or not task.cluster_id:
            await context.abort(grpc.StatusCode.NOT_FOUND, "task has no cluster")
        cluster = self.s.clusters.get(task.cluster_id)
        if cluster is None:  # the gang was rolled back while this container booted
            await context.abort(grpc.StatusCode.NOT_FOUND, "cluster torn down")
        task.container_address = request.container_address
        async with cluster.condition:
            cluster.reported[request.task_id] = request.container_address
            cluster.condition.notify_all()
            deadline = time.monotonic() + 120.0
            while len(cluster.reported) < cluster.size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    await asyncio.wait_for(cluster.condition.wait(), timeout=remaining)
                except asyncio.TimeoutError:
                    pass
        if len(cluster.reported) < cluster.size:
            # outside the lock: the abort's send must not stall the others' reports
            await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, "gang rendezvous timeout")
        rank0 = cluster.reported[cluster.task_ids[0]]
        host = rank0.rsplit(":", 1)[0] if ":" in rank0 else rank0
        return api_pb2.TaskClusterHelloResponse(
            rank=cluster.task_ids.index(request.task_id),
            world_size=cluster.size,
            coordinator_address=f"{host}:{cluster.coordinator_port}",
            peer_addresses=[cluster.reported[tid] for tid in cluster.task_ids],
            cluster_id=cluster.cluster_id,
        )

    async def ClusterList(self, request, context) -> api_pb2.ClusterListResponse:
        out = []
        for cluster in self.s.clusters.values():
            fn = self.s.functions.get(cluster.function_id)
            out.append(api_pb2.ClusterInfo(cluster_id=cluster.cluster_id, function_tag=fn.tag if fn else "",
                                           size=cluster.size, task_ids=list(cluster.task_ids),
                                           ranks_reported=len(cluster.reported)))
        return api_pb2.ClusterListResponse(clusters=out)

    # ------------------------------------------------------------------
    # Sandboxes (reference sandbox.py: on-demand containers; here a
    # supervised subprocess of a worker), their sidecars, snapshots and
    # tunnels. Not journaled (server/journal.py EXEMPT_RPCS).
    # ------------------------------------------------------------------

    async def SandboxCreate(self, request: api_pb2.SandboxCreateRequest, context) -> api_pb2.SandboxCreateResponse:
        from .scheduler import PLACEMENT_UNSAT_GRACE_S, gpu_spec
        from .state import SandboxState_

        if self.scheduler is None:
            await context.abort(grpc.StatusCode.UNIMPLEMENTED, "no scheduler attached")
        resources = request.definition.resources
        if resources.tpu_config.tpu_type:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"tpu_config ({resources.tpu_config.tpu_type!r}) asks for TPU chips, which this control plane "
                "does not place: ask for cards with gpu= (resources.gpu_config)")
        try:
            spec = gpu_spec(resources)
        except Exception as exc:  # noqa: BLE001 — a malformed gpu ask
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"sandbox gpu: {exc}")
        app_id = request.app_id
        if not app_id:
            # a sandbox may be app-less: it gets an implicit ephemeral app
            resp = await self.AppCreate(
                api_pb2.AppCreateRequest(description="sandbox", app_state=api_pb2.APP_STATE_EPHEMERAL), context)
            app_id = resp.app_id
        sandbox_id = self.s.make_id("sb")
        sb = SandboxState_(sandbox_id=sandbox_id, app_id=app_id, definition=request.definition,
                           name=request.definition.name)
        placement = request.definition.scheduler_placement
        task = await self.scheduler.launch_sandbox(sb)
        unsat = None
        if task is None:
            # a placement no worker could ever take fails loudly, after a
            # bounded grace (a matching worker may not have registered yet)
            unsat = self.scheduler.placement_unsatisfiable_reason(placement, spec=spec)
            if unsat is not None:
                deadline = time.time() + PLACEMENT_UNSAT_GRACE_S
                while time.time() < deadline:
                    await asyncio.sleep(0.25)
                    unsat = self.scheduler.placement_unsatisfiable_reason(placement, spec=spec)
                    if unsat is None:
                        task = await self.scheduler.launch_sandbox(sb)
                        break
        if task is None:
            # no ghost state: neither the sandbox nor its implicit app
            if not request.app_id:
                implicit_app = self.s.apps.get(app_id)
                if implicit_app is not None:
                    await self._stop_app(implicit_app)
                    del self.s.apps[app_id]
            if unsat is not None:
                await context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"sandbox {unsat}")
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, "no worker capacity for sandbox")
        self.s.sandboxes[sandbox_id] = sb
        sb.state = api_pb2.SANDBOX_STATE_RUNNING
        return api_pb2.SandboxCreateResponse(sandbox_id=sandbox_id)

    async def SandboxGetTaskId(self, request, context) -> api_pb2.SandboxGetTaskIdResponse:
        sb = self.s.sandboxes.get(request.sandbox_id)
        if sb is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "sandbox not found")
        if request.wait_until_ready:
            # block until the readiness probe passes, or the sandbox exits
            # first (its result goes back so the client raises)
            deadline = time.monotonic() + min(max(request.timeout, 0.0) or 55.0, 60.0)
            while not sb.ready and sb.result is None and time.monotonic() < deadline:
                task = self.s.tasks.get(sb.task_id)
                if task is not None and task.result is not None:
                    sb.result = task.result
                    break
                await asyncio.sleep(0.05)
            if not sb.ready and sb.result is not None:
                return api_pb2.SandboxGetTaskIdResponse(
                    task_id=sb.task_id,
                    task_result_json=json.dumps({"status": int(sb.result.status), "exception": sb.result.exception}),
                )
        return api_pb2.SandboxGetTaskIdResponse(task_id=sb.task_id, ready=sb.ready)

    async def SandboxWait(self, request: api_pb2.SandboxWaitRequest, context) -> api_pb2.SandboxWaitResponse:
        sb = self.s.sandboxes.get(request.sandbox_id)
        if sb is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "sandbox not found")
        # timeout=0 polls once
        deadline = time.monotonic() + min(max(request.timeout, 0.0), 60.0)
        while True:
            task = self.s.tasks.get(sb.task_id)
            if task is not None and task.result is not None:
                sb.result = task.result
                sb.state = (api_pb2.SANDBOX_STATE_TIMEOUT if task.result.status == api_pb2.GENERIC_STATUS_TIMEOUT
                            else api_pb2.SANDBOX_STATE_TERMINATED)
                return api_pb2.SandboxWaitResponse(result=task.result)
            if time.monotonic() >= deadline:
                return api_pb2.SandboxWaitResponse()
            await asyncio.sleep(0.1)

    async def SandboxTerminate(self, request, context) -> api_pb2.SandboxTerminateResponse:
        sb = self.s.sandboxes.get(request.sandbox_id)
        if sb is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "sandbox not found")
        task = self.s.tasks.get(sb.task_id)
        if task is not None and task.result is None:
            task.terminate = True
            worker = self.s.workers.get(task.worker_id)
            if worker is not None:
                await worker.events.put(api_pb2.WorkerPollResponse(stop=api_pb2.TaskStopEvent(task_id=task.task_id)))
        sb.state = api_pb2.SANDBOX_STATE_TERMINATED
        return api_pb2.SandboxTerminateResponse()

    async def SandboxSidecarCreate(self, request: api_pb2.SandboxSidecarCreateRequest, context):
        sb = self.s.sandboxes.get(request.sandbox_id)
        if sb is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "sandbox not found")
        sc = request.sidecar
        if not sc.name or sc.name == "main":
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, "sidecar name required ('main' is reserved)")
        if sc.name in sb.sidecars and sb.sidecars[sc.name].running:
            await context.abort(grpc.StatusCode.ALREADY_EXISTS, f"sidecar {sc.name!r} is running")
        if not sc.entrypoint_args:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, "sidecar command required")
        task = self.s.tasks.get(sb.task_id)
        worker = self.s.workers.get(task.worker_id) if task is not None else None
        if task is None or task.result is not None or worker is None:
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION, "sandbox is not running — cannot attach a sidecar")
        rec = api_pb2.SandboxSidecar()
        rec.CopyFrom(sc)
        rec.running = True
        sb.sidecars[sc.name] = rec
        await worker.events.put(api_pb2.WorkerPollResponse(
            sidecar=api_pb2.SidecarLaunchEvent(task_id=task.task_id, sandbox_id=sb.sandbox_id, sidecar=rec)))
        return api_pb2.SandboxSidecarCreateResponse(name=sc.name)

    async def SandboxSidecarList(self, request, context) -> api_pb2.SandboxSidecarListResponse:
        sb = self.s.sandboxes.get(request.sandbox_id)
        if sb is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "sandbox not found")
        return api_pb2.SandboxSidecarListResponse(sidecars=list(sb.sidecars.values()))

    async def SandboxSidecarStop(self, request, context) -> api_pb2.SandboxSidecarStopResponse:
        sb = self.s.sandboxes.get(request.sandbox_id)
        if sb is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "sandbox not found")
        if request.name not in sb.sidecars:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"no sidecar {request.name!r}")
        task = self.s.tasks.get(sb.task_id)
        worker = self.s.workers.get(task.worker_id) if task is not None else None
        if worker is not None:
            await worker.events.put(api_pb2.WorkerPollResponse(
                stop=api_pb2.TaskStopEvent(task_id=sb.task_id, force=True, sidecar_name=request.name)))
        return api_pb2.SandboxSidecarStopResponse()

    async def SandboxSidecarExit(self, request, context) -> api_pb2.SandboxSidecarExitResponse:
        for sb in self.s.sandboxes.values():
            if sb.task_id == request.task_id and request.name in sb.sidecars:
                sb.sidecars[request.name].running = False
                sb.sidecars[request.name].returncode = request.returncode
                break
        return api_pb2.SandboxSidecarExitResponse()

    async def SandboxList(self, request, context) -> api_pb2.SandboxListResponse:
        out = []
        for sb in self.s.sandboxes.values():
            if request.app_id and sb.app_id != request.app_id:
                continue
            info = api_pb2.SandboxInfo(sandbox_id=sb.sandbox_id, created_at=sb.created_at, state=sb.state,
                                       name=sb.name)
            if sb.result is not None:
                info.result.CopyFrom(sb.result)
            out.append(info)
        return api_pb2.SandboxListResponse(sandboxes=out)

    async def SandboxGetFromName(self, request, context) -> api_pb2.SandboxGetFromNameResponse:
        for sb in self.s.sandboxes.values():
            if sb.name == request.name:
                return api_pb2.SandboxGetFromNameResponse(sandbox_id=sb.sandbox_id)
        await context.abort(grpc.StatusCode.NOT_FOUND, f"sandbox {request.name!r} not found")

    async def SandboxStdinWrite(self, request: api_pb2.SandboxStdinWriteRequest, context):
        sb = self.s.sandboxes.get(request.sandbox_id)
        if sb is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "sandbox not found")
        # idempotent on the client's increasing index: a retried write (its
        # response lost) must not duplicate stdin bytes
        if request.index and request.index <= sb.stdin_last_index:
            return api_pb2.SandboxStdinWriteResponse()
        if request.index:
            sb.stdin_last_index = request.index
        if request.input:
            sb.stdin_chunks.append(bytes(request.input))
        if request.eof:
            sb.stdin_eof = True
        async with sb.condition:
            sb.condition.notify_all()
        return api_pb2.SandboxStdinWriteResponse()

    async def SandboxGetStdin(self, request: api_pb2.SandboxGetStdinRequest, context):
        sb = self.s.sandboxes.get(request.sandbox_id)
        if sb is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "sandbox not found")
        deadline = time.monotonic() + min(request.timeout or 5.0, 30.0)
        # the predicate is re-checked under the condition's lock: a notify
        # between the check and the wait cannot be lost
        async with sb.condition:
            while True:
                chunks = sb.stdin_chunks[request.offset:]
                if chunks or sb.stdin_eof:
                    return api_pb2.SandboxGetStdinResponse(chunks=chunks, eof=sb.stdin_eof,
                                                           next_offset=len(sb.stdin_chunks))
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return api_pb2.SandboxGetStdinResponse(next_offset=request.offset)
                try:
                    await asyncio.wait_for(sb.condition.wait(), timeout=remaining)
                except asyncio.TimeoutError:
                    pass

    async def SandboxGetLogs(self, request: api_pb2.SandboxGetLogsRequest, context):
        sb = self.s.sandboxes.get(request.sandbox_id)
        if sb is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "sandbox not found")
        app = self.s.apps.get(sb.app_id)
        if app is None:
            return
        pos = int(request.last_entry_id) if request.last_entry_id else 0
        deadline = time.monotonic() + (request.timeout or 30.0)
        while time.monotonic() < deadline:
            entries = [e for e in app.log_entries[pos:] if e.task_id == sb.task_id
                       and (not request.file_descriptor or e.file_descriptor == request.file_descriptor)]
            new_pos = len(app.log_entries)
            if entries:
                batch = api_pb2.TaskLogsBatch(entry_id=str(new_pos))
                batch.items.extend(entries)
                yield batch
            pos = new_pos
            task = self.s.tasks.get(sb.task_id)
            if task is not None and task.result is not None:
                yield api_pb2.TaskLogsBatch(entry_id=str(pos), eof_task_id=sb.task_id)
                return
            async with app.log_condition:
                try:
                    await asyncio.wait_for(app.log_condition.wait(), timeout=0.5)
                except asyncio.TimeoutError:
                    pass

    async def SandboxGetCommandRouterAccess(self, request, context) -> api_pb2.SandboxGetCommandRouterAccessResponse:
        """The worker's direct data plane for this sandbox (reference
        SandboxGetCommandRouterAccess, task_command_router_client.py)."""
        sb = self.s.sandboxes.get(request.sandbox_id)
        if sb is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "sandbox not found")
        # still scheduling: UNAVAILABLE keeps the client's bounded connect loop polling
        task = self.s.tasks.get(sb.task_id) if sb.task_id else None
        if task is None:
            await context.abort(grpc.StatusCode.UNAVAILABLE, "sandbox not yet scheduled")
        worker = self.s.workers.get(task.worker_id)
        if worker is None or not worker.router_address:
            await context.abort(grpc.StatusCode.UNAVAILABLE, "worker router unavailable")
        return api_pb2.SandboxGetCommandRouterAccessResponse(
            router_address=worker.router_address, task_id=task.task_id, router_token=task.router_token)

    async def _snapshot_sandbox_fs(self, sb) -> str:
        """Tar the sandbox's workdir into the blob store; returns the blob id."""
        from .fs_snapshot import sandbox_workdir, tar_dir

        # the cwd the worker reported at ContainerHello, else the default
        workdir = sb.workdir or sandbox_workdir(self.s.state_dir, sb.task_id, sb.definition.workdir)
        if not os.path.isdir(workdir):
            raise FileNotFoundError(f"sandbox workdir {workdir} not found on this host")
        data = await tar_dir(workdir)
        blob_id = self.s.make_id("bl")
        path = self.s.blob_path(blob_id)
        with open(path + ".tmp", "wb") as f:
            f.write(data)
        os.replace(path + ".tmp", path)
        return blob_id

    def _snapshot_image(self, blob_id: str) -> str:
        image_id = self.s.make_id("im")
        self.s.images[image_id] = ImageState(image_id=image_id, definition=api_pb2.Image(fs_snapshot_blob_id=blob_id),
                                             built=True)
        return image_id

    async def SandboxSnapshotFs(self, request, context) -> api_pb2.SandboxSnapshotFsRequestResponse:
        """A filesystem snapshot as an image new sandboxes start from
        (reference sandbox.py `snapshot_filesystem`)."""
        sb = self.s.sandboxes.get(request.sandbox_id)
        if sb is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "sandbox not found")
        try:
            blob_id = await self._snapshot_sandbox_fs(sb)
        except Exception as exc:  # noqa: BLE001 — a result, as in the reference
            return api_pb2.SandboxSnapshotFsRequestResponse(result=api_pb2.GenericResult(
                status=api_pb2.GENERIC_STATUS_FAILURE, exception=f"fs snapshot failed: {exc}"))
        return api_pb2.SandboxSnapshotFsRequestResponse(
            image_id=self._snapshot_image(blob_id), result=api_pb2.GenericResult(status=api_pb2.GENERIC_STATUS_SUCCESS))

    async def SandboxSnapshot(self, request, context) -> api_pb2.SandboxSnapshotResponse:
        from .state import SandboxSnapshotState

        sb = self.s.sandboxes.get(request.sandbox_id)
        if sb is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "sandbox not found")
        try:
            blob_id = await self._snapshot_sandbox_fs(sb)
        except (OSError, ValueError) as exc:
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION, f"snapshot failed: {exc}")
        snapshot_id = self.s.make_id("sn")
        definition = api_pb2.Sandbox()
        definition.CopyFrom(sb.definition)
        self.s.sandbox_snapshots[snapshot_id] = SandboxSnapshotState(snapshot_id=snapshot_id, definition=definition,
                                                                     fs_blob_id=blob_id)
        return api_pb2.SandboxSnapshotResponse(snapshot_id=snapshot_id)

    async def SandboxSnapshotGet(self, request, context) -> api_pb2.SandboxSnapshotGetResponse:
        snap = self.s.sandbox_snapshots.get(request.snapshot_id)
        if snap is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "snapshot not found")
        return api_pb2.SandboxSnapshotGetResponse(snapshot_id=snap.snapshot_id, created_at=snap.created_at)

    async def SandboxRestore(self, request, context) -> api_pb2.SandboxRestoreResponse:
        """A new sandbox from a snapshot: the same definition, its workdir
        seeded from the snapshot's tarball (through a snapshot image)."""
        snap = self.s.sandbox_snapshots.get(request.snapshot_id)
        if snap is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "snapshot not found")
        definition = api_pb2.Sandbox()
        definition.CopyFrom(snap.definition)
        if snap.fs_blob_id:
            definition.image_id = self._snapshot_image(snap.fs_blob_id)
            definition.workdir = ""  # a seeded copy, not the old sandbox's dir
        if request.name:
            definition.name = request.name
        resp = await self.SandboxCreate(api_pb2.SandboxCreateRequest(definition=definition), context)
        return api_pb2.SandboxRestoreResponse(sandbox_id=resp.sandbox_id)

    async def SandboxGetTunnels(self, request, context) -> api_pb2.SandboxGetTunnelsResponse:
        sb = self.s.sandboxes.get(request.sandbox_id)
        if sb is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "sandbox not found")
        if not sb.definition.open_ports:
            return api_pb2.SandboxGetTunnelsResponse(result=api_pb2.GenericResult(
                status=api_pb2.GENERIC_STATUS_FAILURE,
                exception="sandbox has no open ports — pass unencrypted_ports/encrypted_ports to create()"))
        deadline = time.monotonic() + min(max(request.timeout, 0.0), 60.0)
        while not sb.tunnels_reported and time.monotonic() < deadline:
            task = self.s.tasks.get(sb.task_id)
            if sb.result is not None or (task is not None and task.result is not None):
                break  # the sandbox already exited
            await asyncio.sleep(0.05)
        if not sb.tunnels_reported:
            # an empty list must not read as success: callers index by port
            task = self.s.tasks.get(sb.task_id)
            result = sb.result or (task.result if task is not None else None)
            reason = (f"sandbox exited before tunnels came up: {result.exception or 'exit'}" if result is not None
                      else f"tunnels not reported within {request.timeout:.0f}s")
            return api_pb2.SandboxGetTunnelsResponse(result=api_pb2.GenericResult(
                status=api_pb2.GENERIC_STATUS_FAILURE, exception=reason))
        return api_pb2.SandboxGetTunnelsResponse(tunnels=list(sb.tunnels),
                                                 result=api_pb2.GenericResult(status=api_pb2.GENERIC_STATUS_SUCCESS))

    async def TaskTunnelsUpdate(self, request, context) -> api_pb2.TaskTunnelsUpdateResponse:
        for sb in self.s.sandboxes.values():
            if sb.task_id == request.task_id:
                sb.tunnels = list(request.tunnels)
                sb.tunnels_reported = True
                break
        return api_pb2.TaskTunnelsUpdateResponse()

    async def TaskReady(self, request: api_pb2.TaskReadyRequest, context) -> api_pb2.TaskReadyResponse:
        for sb in self.s.sandboxes.values():
            if sb.task_id == request.task_id:
                sb.ready = True
                break
        return api_pb2.TaskReadyResponse()

    async def TunnelStart(self, request: api_pb2.TunnelStartRequest, context) -> api_pb2.TunnelStartResponse:
        """In-container `forward(port)` (reference _tunnel.py): the plane
        serves a TCP proxy to the container's port on this host."""
        from .worker import tcp_proxy

        task = self.s.tasks.get(request.task_id)
        if task is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "task not found")
        key = (request.task_id, request.port)
        scheme = "tcp" if request.unencrypted else "tls"
        # a start in flight holds a Future under the key: a late arrival
        # awaits it instead of binding a second listener
        for _ in range(3):
            existing = self.s.tunnels.get(key)
            if existing is None:
                break
            if isinstance(existing, asyncio.Future):
                try:
                    await asyncio.wait_for(asyncio.shield(existing), timeout=15.0)
                except asyncio.TimeoutError:
                    pass
                continue  # re-read: a listener now, or stopped
            return api_pb2.TunnelStartResponse(host="127.0.0.1", port=existing[1],
                                               url=f"{scheme}://127.0.0.1:{existing[1]}")
        else:
            await context.abort(grpc.StatusCode.UNAVAILABLE, "tunnel start contended; retry")
        # the task may have finished while this waited (and _release_task
        # closed its tunnels): a listener bound now would leak
        task = self.s.tasks.get(request.task_id)
        if task is None or task.finished_at:
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION, "task finished")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.s.tunnels[key] = fut
        try:
            server = await asyncio.start_server(tcp_proxy(request.port), "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            if self.s.tunnels.get(key) is fut:
                self.s.tunnels[key] = (server, port)
            else:
                # a TunnelStop raced the start: close the listener, hand out no port
                server.close()
                await context.abort(grpc.StatusCode.UNAVAILABLE, "tunnel stopped during start")
        finally:
            # any exit releases a reservation still held and wakes waiters
            if self.s.tunnels.get(key) is fut:
                del self.s.tunnels[key]
            if not fut.done():
                fut.set_result(None)
        return api_pb2.TunnelStartResponse(host="127.0.0.1", port=port, url=f"{scheme}://127.0.0.1:{port}")

    async def TunnelStop(self, request: api_pb2.TunnelStopRequest, context) -> api_pb2.TunnelStopResponse:
        entry = self.s.tunnels.pop((request.task_id, request.port), None)
        if entry is None:
            return api_pb2.TunnelStopResponse(exists=False)
        if isinstance(entry, asyncio.Future):
            # a start in flight sees its reservation gone and closes its own
            # listener; wake its waiters now
            if not entry.done():
                entry.set_result(None)
        elif entry[0] is not None:
            entry[0].close()
        return api_pb2.TunnelStopResponse(exists=True)

    # ------------------------------------------------------------------
    # Proxies: static egress (reference proxy.py:1)
    # ------------------------------------------------------------------

    async def ProxyCreate(self, request: api_pb2.ProxyCreateRequest, context) -> api_pb2.ProxyCreateResponse:
        if not request.name:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, "proxy name required")
        key = (self._resolve_environment(request.environment_name), request.name)
        if key in self.s.deployed_proxies:
            await context.abort(grpc.StatusCode.ALREADY_EXISTS, f"proxy {request.name!r} exists")
        proxy_id = self.s.make_id("pr")
        # a static IP from a private range, never one a live proxy holds;
        # the scheduler exports it to the containers of a proxied function
        # (locally as env; a production deployment binds SNAT to it)
        in_use = {p.proxy_ip for p in self.s.proxies.values()}
        ip = next((f"10.250.{block}.{octet}" for block in range(256) for octet in range(2, 252)
                   if f"10.250.{block}.{octet}" not in in_use), None)
        if ip is None:
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, "proxy IP range exhausted")
        # the resolved environment, so ProxyDelete un-keys what this keyed
        proxy = ProxyState(proxy_id=proxy_id, name=request.name, proxy_ip=ip, environment_name=key[0])
        self.s.proxies[proxy_id] = proxy
        self.s.deployed_proxies[key] = proxy_id
        self._j("proxy", proxy_id=proxy_id, name=proxy.name, proxy_ip=proxy.proxy_ip,
                environment_name=proxy.environment_name)
        return api_pb2.ProxyCreateResponse(proxy=api_pb2.Proxy(proxy_id=proxy_id, name=proxy.name, proxy_ip=ip))

    async def ProxyGet(self, request: api_pb2.ProxyGetRequest, context) -> api_pb2.ProxyGetResponse:
        proxy_id = self.s.deployed_proxies.get((self._resolve_environment(request.environment_name), request.name))
        if proxy_id is None:
            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"proxy {request.name!r} not found: provision it with Proxy.create")
        proxy = self.s.proxies[proxy_id]
        return api_pb2.ProxyGetResponse(proxy=api_pb2.Proxy(proxy_id=proxy_id, name=proxy.name, proxy_ip=proxy.proxy_ip))

    async def ProxyList(self, request: api_pb2.ProxyListRequest, context) -> api_pb2.ProxyListResponse:
        return api_pb2.ProxyListResponse(proxies=[
            api_pb2.Proxy(proxy_id=p.proxy_id, name=p.name, proxy_ip=p.proxy_ip) for p in self.s.proxies.values()
            if not request.environment_name or p.environment_name == request.environment_name
        ])

    async def ProxyDelete(self, request: api_pb2.ProxyDeleteRequest, context) -> api_pb2.ProxyDeleteResponse:
        proxy = self.s.proxies.pop(request.proxy_id, None)
        if proxy is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "proxy not found")
        self.s.deployed_proxies.pop((proxy.environment_name, proxy.name), None)
        self._j("proxy_del", proxy_id=request.proxy_id)
        return api_pb2.ProxyDeleteResponse()

    # ------------------------------------------------------------------
    # Dicts: the registry is journaled, the contents are not
    # ------------------------------------------------------------------

    async def _dict(self, dict_id: str, context) -> DictState:
        d = self.s.dicts.get(dict_id)
        if d is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "dict not found")
        return d

    async def DictGetOrCreate(self, request: api_pb2.DictGetOrCreateRequest, context) -> api_pb2.DictGetOrCreateResponse:
        if request.object_creation_type == EPHEMERAL or not request.deployment_name:
            dict_id = self.s.make_id("di")
            ephemeral = request.object_creation_type == EPHEMERAL
            self.s.dicts[dict_id] = DictState(dict_id=dict_id, ephemeral=ephemeral, last_heartbeat=time.time())
            self._j("dictq", pool="dicts", id=dict_id, ephemeral=ephemeral)
            return api_pb2.DictGetOrCreateResponse(dict_id=dict_id)
        key = (self._resolve_environment(request.environment_name), request.deployment_name)
        dict_id = self.s.deployed_dicts.get(key)
        if dict_id is None:
            if request.object_creation_type not in (CREATE_IF_MISSING, FAIL_IF_EXISTS):
                await context.abort(grpc.StatusCode.NOT_FOUND, f"dict {request.deployment_name!r} not found")
            dict_id = self.s.make_id("di")
            self.s.dicts[dict_id] = DictState(dict_id=dict_id, name=request.deployment_name)
            self.s.deployed_dicts[key] = dict_id
            self._j("dictq", pool="dicts", id=dict_id, name=request.deployment_name, deploy_key=list(key))
        return api_pb2.DictGetOrCreateResponse(dict_id=dict_id)

    async def DictUpdate(self, request, context) -> api_pb2.DictUpdateResponse:
        d = await self._dict(request.dict_id, context)
        if request.if_not_exists and len(request.updates) == 1:
            entry = request.updates[0]
            if bytes(entry.key) in d.data:
                return api_pb2.DictUpdateResponse(created=False)
            d.data[bytes(entry.key)] = bytes(entry.value)
            return api_pb2.DictUpdateResponse(created=True)
        for entry in request.updates:
            d.data[bytes(entry.key)] = bytes(entry.value)
        return api_pb2.DictUpdateResponse(created=True)

    async def DictGet(self, request, context) -> api_pb2.DictGetResponse:
        value = (await self._dict(request.dict_id, context)).data.get(bytes(request.key))
        return api_pb2.DictGetResponse(found=value is not None, value=value or b"")

    async def DictPop(self, request, context) -> api_pb2.DictPopResponse:
        value = (await self._dict(request.dict_id, context)).data.pop(bytes(request.key), None)
        return api_pb2.DictPopResponse(found=value is not None, value=value or b"")

    async def DictContains(self, request, context) -> api_pb2.DictContainsResponse:
        return api_pb2.DictContainsResponse(found=bytes(request.key) in (await self._dict(request.dict_id, context)).data)

    async def DictLen(self, request, context) -> api_pb2.DictLenResponse:
        return api_pb2.DictLenResponse(len=len((await self._dict(request.dict_id, context)).data))

    async def DictContents(self, request, context) -> api_pb2.DictContentsResponse:
        d = await self._dict(request.dict_id, context)
        return api_pb2.DictContentsResponse(items=[api_pb2.DictEntry(key=k, value=v) for k, v in d.data.items()])

    async def DictClear(self, request, context) -> api_pb2.DictClearResponse:
        (await self._dict(request.dict_id, context)).data.clear()
        return api_pb2.DictClearResponse()

    async def DictDelete(self, request, context) -> api_pb2.DictDeleteResponse:
        if self.s.dicts.pop(request.dict_id, None) is not None:
            for key, did in list(self.s.deployed_dicts.items()):
                if did == request.dict_id:
                    del self.s.deployed_dicts[key]
            self._j("dictq_del", pool="dicts", id=request.dict_id)
        return api_pb2.DictDeleteResponse()

    async def DictList(self, request, context) -> api_pb2.DictListResponse:
        return api_pb2.DictListResponse(items=[
            api_pb2.DictListItem(name=d.name, created_at=d.created_at, dict_id=d.dict_id)
            for d in self.s.dicts.values() if d.name
        ])

    # ------------------------------------------------------------------
    # Queues: partitions, each with its own condition; the registry is
    # journaled, the contents are not
    # ------------------------------------------------------------------

    async def _queue(self, queue_id: str, context) -> QueueState:
        q = self.s.queues.get(queue_id)
        if q is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "queue not found")
        return q

    async def QueueGetOrCreate(self, request: api_pb2.QueueGetOrCreateRequest, context) -> api_pb2.QueueGetOrCreateResponse:
        if request.object_creation_type == EPHEMERAL or not request.deployment_name:
            queue_id = self.s.make_id("qu")
            ephemeral = request.object_creation_type == EPHEMERAL
            self.s.queues[queue_id] = QueueState(queue_id=queue_id, ephemeral=ephemeral, last_heartbeat=time.time())
            self._j("dictq", pool="queues", id=queue_id, ephemeral=ephemeral)
            return api_pb2.QueueGetOrCreateResponse(queue_id=queue_id)
        key = (self._resolve_environment(request.environment_name), request.deployment_name)
        queue_id = self.s.deployed_queues.get(key)
        if queue_id is None:
            if request.object_creation_type not in (CREATE_IF_MISSING, FAIL_IF_EXISTS):
                await context.abort(grpc.StatusCode.NOT_FOUND, f"queue {request.deployment_name!r} not found")
            queue_id = self.s.make_id("qu")
            self.s.queues[queue_id] = QueueState(queue_id=queue_id, name=request.deployment_name)
            self.s.deployed_queues[key] = queue_id
            self._j("dictq", pool="queues", id=queue_id, name=request.deployment_name, deploy_key=list(key))
        return api_pb2.QueueGetOrCreateResponse(queue_id=queue_id)

    async def QueuePut(self, request: api_pb2.QueuePutRequest, context) -> api_pb2.QueuePutResponse:
        part = (await self._queue(request.queue_id, context)).partition(request.partition_key)
        for v in request.values:
            part.next_entry += 1
            part.items.append((str(part.next_entry), bytes(v)))
        async with part.condition:
            part.condition.notify_all()
        return api_pb2.QueuePutResponse()

    async def _wait_items(self, part, deadline: float) -> bool:
        """Wait on the partition's condition until a put or the deadline;
        False once the deadline has passed."""
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return False
        async with part.condition:
            try:
                await asyncio.wait_for(part.condition.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                pass
        return True

    async def QueueGet(self, request: api_pb2.QueueGetRequest, context) -> api_pb2.QueueGetResponse:
        part = (await self._queue(request.queue_id, context)).partition(request.partition_key)
        n = max(1, request.n_values)
        deadline = time.monotonic() + (request.timeout or 0.0)
        while True:
            if part.items:
                taken = part.items[:n]
                del part.items[:n]
                return api_pb2.QueueGetResponse(values=[v for _, v in taken])
            if not await self._wait_items(part, deadline):
                return api_pb2.QueueGetResponse(values=[])

    async def QueueNextItems(self, request: api_pb2.QueueNextItemsRequest, context) -> api_pb2.QueueNextItemsResponse:
        part = (await self._queue(request.queue_id, context)).partition(request.partition_key)
        last = int(request.last_entry_id) if request.last_entry_id else 0
        deadline = time.monotonic() + (request.item_poll_timeout or 0.0)
        while True:
            items = [api_pb2.QueueItem(value=v, entry_id=eid) for eid, v in part.items if int(eid) > last]
            if items:
                return api_pb2.QueueNextItemsResponse(items=items)
            if not await self._wait_items(part, deadline):
                return api_pb2.QueueNextItemsResponse(items=[])

    async def QueueLen(self, request, context) -> api_pb2.QueueLenResponse:
        q = await self._queue(request.queue_id, context)
        if request.total:
            return api_pb2.QueueLenResponse(len=sum(len(p.items) for p in q.partitions.values()))
        return api_pb2.QueueLenResponse(len=len(q.partition(request.partition_key).items))

    async def QueueClear(self, request, context) -> api_pb2.QueueClearResponse:
        q = await self._queue(request.queue_id, context)
        if request.all_partitions:
            q.partitions.clear()
        else:
            q.partition(request.partition_key).items.clear()
        return api_pb2.QueueClearResponse()

    async def QueueDelete(self, request, context) -> api_pb2.QueueDeleteResponse:
        if self.s.queues.pop(request.queue_id, None) is not None:
            for key, qid in list(self.s.deployed_queues.items()):
                if qid == request.queue_id:
                    del self.s.deployed_queues[key]
            self._j("dictq_del", pool="queues", id=request.queue_id)
        return api_pb2.QueueDeleteResponse()

    async def QueueList(self, request, context) -> api_pb2.QueueListResponse:
        return api_pb2.QueueListResponse(items=[
            api_pb2.QueueListItem(name=q.name, created_at=q.created_at, num_partitions=len(q.partitions),
                                  total_size=sum(len(p.items) for p in q.partitions.values()), queue_id=q.queue_id)
            for q in self.s.queues.values() if q.name
        ])
