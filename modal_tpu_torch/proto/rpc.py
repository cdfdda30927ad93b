"""RPC spine of the port: the JAX package's registry of every RPC of the wire
contract (modal_tpu/proto/rpc.py), over the port's messages.

Names, request and response messages, arity and the method paths are the
JAX package's, and the paths keep its service name: the path *is* the wire
contract, so the port's client talks to the JAX control plane and the JAX
client to the port's. The grpc.aio client multicallables derive from the
registry, and so does the server's generic handler: every RPC the servicer
implements, wrapped in the JAX server's middleware (tracing and metrics,
idempotency dedupe, quorum commit); every other RPC answers UNIMPLEMENTED.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import TYPE_CHECKING, Any, Optional

from . import api_pb2

if TYPE_CHECKING:
    import grpc

SERVICE_NAME = "modal.tpu.api.ModalTPU"


class Arity(enum.Enum):
    UNARY_UNARY = "unary_unary"
    UNARY_STREAM = "unary_stream"
    STREAM_UNARY = "stream_unary"
    STREAM_STREAM = "stream_stream"


@dataclasses.dataclass(frozen=True)
class RPCMethod:
    name: str
    request_type: Any
    response_type: Any
    arity: Arity
    service_name: str = SERVICE_NAME

    @property
    def path(self) -> str:
        return f"/{self.service_name}/{self.name}"


# RPCs whose response message doesn't follow the `<Name>Response` convention,
# or that stream.
_OVERRIDES: dict[str, tuple[Optional[str], Optional[str], Arity]] = {
    # name: (request_msg, response_msg, arity); None = derive by convention
    "AppGetLogs": (None, "TaskLogsBatch", Arity.UNARY_STREAM),
    "FunctionGetCurrentStats": (None, "FunctionStats", Arity.UNARY_UNARY),
    "FunctionCallGetData": (None, "DataChunk", Arity.UNARY_STREAM),
    # push-streamed output delivery (docs/DISPATCH.md): same request/response
    # wire shape as the FunctionGetOutputs poll, but server-streaming — a
    # batch is pushed the instant _append_output fires, with periodic empty
    # keep-alives; the poll path stays as the fallback rung
    "FunctionStreamOutputs": ("FunctionGetOutputsRequest", "FunctionGetOutputsResponse", Arity.UNARY_STREAM),
    # merged container turnaround (docs/DISPATCH.md): PutOutputs + GetInputs
    # in one exchange — the response is wire-identical to the claim poll's
    "FunctionExchange": ("FunctionExchangeRequest", "FunctionGetInputsResponse", Arity.UNARY_UNARY),
    "SandboxGetLogs": (None, "TaskLogsBatch", Arity.UNARY_STREAM),
    "SandboxSnapshotFs": (None, "SandboxSnapshotFsRequestResponse", Arity.UNARY_UNARY),
    "ContainerExecGetOutput": (None, "RuntimeOutputBatch", Arity.UNARY_STREAM),
    "WorkerPoll": (None, "WorkerPollResponse", Arity.UNARY_STREAM),
}

_RPC_NAMES = [
    # App lifecycle (ref: AppCreate..AppClientDisconnect, api.proto service defn)
    "AppCreate",
    "AppGetOrCreate",
    "AppHeartbeat",
    "AppPublish",
    "AppClientDisconnect",
    "AppStop",
    "AppGetLayout",
    "AppList",
    "AppDeploy",
    "AppGetByDeploymentName",
    "AppDeploymentHistory",
    "AppGetLogs",
    "AppFetchLogs",
    "AppCountLogs",
    "AppListProfiles",
    # Blob store
    "BlobCreate",
    "BlobGet",
    # Function definition + invocation
    "FunctionCreate",
    "FunctionGet",
    "FunctionBindParams",
    "FunctionUpdateSchedulingParams",
    "FunctionSetWebUrl",
    "FunctionGetWebUrl",
    "FunctionGetCurrentStats",
    "FunctionMap",
    "FunctionMapBatch",
    "FunctionPutInputs",
    "FunctionRetryInputs",
    "MapCheckInputs",
    "FunctionGetOutputs",
    "FunctionStreamOutputs",
    "FunctionCallGetData",
    "FunctionCallPutData",
    "FunctionCallList",
    "FunctionCallCancel",
    "FunctionCallGetInfo",
    # Container data plane
    "ContainerHello",
    "ContainerHeartbeat",
    "FunctionGetInputs",
    "FunctionPutOutputs",
    "FunctionExchange",
    "ContainerCheckpoint",
    "ContainerStop",
    "ContainerLog",
    "TaskResult",
    "TaskClusterHello",
    "TaskGetTimeline",
    # Image builder
    "ImageGetOrCreate",
    "ImageJoinStreaming",
    "ImageFromId",
    # Mounts
    "MountPutFile",
    "MountGetOrCreate",
    # Volumes
    "VolumeGetOrCreate",
    "VolumePutFiles2",
    "VolumeBlockPut",
    "VolumeBlockGet",
    "VolumeGetFile2",
    "VolumeListFiles",
    "VolumeRemoveFile",
    "VolumeCopyFiles",
    "VolumeCommit",
    "VolumeReload",
    "VolumeRename",
    "VolumeDelete",
    "VolumeList",
    # Secrets
    "SecretGetOrCreate",
    "SecretList",
    "SecretDelete",
    # Proxies (static egress)
    "ProxyGet",
    "ProxyCreate",
    "ProxyList",
    "ProxyDelete",
    # Ephemeral-object liveness
    "EphemeralObjectHeartbeat",
    # Dicts
    "DictGetOrCreate",
    "DictUpdate",
    "DictGet",
    "DictPop",
    "DictContains",
    "DictLen",
    "DictContents",
    "DictClear",
    "DictDelete",
    "DictList",
    # Queues
    "QueueGetOrCreate",
    "QueuePut",
    "QueueGet",
    "QueueNextItems",
    "QueueLen",
    "QueueClear",
    "QueueDelete",
    "QueueList",
    # Sandboxes
    "SandboxCreate",
    "SandboxGetTaskId",
    "SandboxWait",
    "SandboxTerminate",
    "SandboxList",
    "SandboxGetFromName",
    "SandboxStdinWrite",
    "SandboxGetStdin",
    "SandboxGetCommandRouterAccess",
    "SandboxGetLogs",
    "SandboxSnapshotFs",
    "SandboxSnapshot",
    "SandboxSnapshotGet",
    "SandboxRestore",
    "SandboxSidecarCreate",
    "SandboxSidecarList",
    "SandboxSidecarStop",
    "SandboxSidecarExit",
    "SandboxGetTunnels",
    "TaskTunnelsUpdate",
    "TaskReady",
    "TunnelStart",
    "TunnelStop",
    "ContainerExec",
    "ContainerExecGetOutput",
    "ContainerExecWait",
    "ContainerExecPutInput",
    "ContainerFilesystemExec",
    # Workers
    "WorkerRegister",
    "WorkerPoll",
    "WorkerHeartbeat",
    # Input plane (region-local data plane; ref _functions.py:394,
    # parallel_map.py:620)
    "AuthTokenGet",
    "AttemptStart",
    "AttemptStartBatch",
    "AttemptAwait",
    "AttemptRetry",
    "MapStartOrContinue",
    "MapAwait",
    # Misc
    "ClientHello",
    "TokenFlowCreate",
    "TokenFlowWait",
    # Continuous profiling (observability/profiler.py): toggle the sampling
    # profiler in the supervisor and fan out to live containers via
    # ContainerHeartbeatResponse.profile_command
    "ProfileControl",
    # Fleet SLO observability (observability/timeseries.py +
    # slo.py): windowed metric history, burn-rate alert states, and the
    # `modal_tpu top` dashboard payload from the supervisor-resident store
    "MetricsHistory",
    # Sharded control plane (server/shards.py): director↔shard
    # administration — shard status probes, journal-fed partition takeover,
    # and epoch fencing of stale shards
    "ShardControl",
    # Quorum journal replication (server/replication.py): a writer
    # shard streams journal appends / snapshots / seals to follower shards,
    # every message fenced by the writer's fleet epoch
    "JournalReplicate",
    # Workspace (identity/membership/settings; billing is NG)
    "WorkspaceNameLookup",
    "WorkspaceMemberList",
    "WorkspaceSettingsList",
    "WorkspaceSettingsSet",
    "EnvironmentList",
    "EnvironmentCreate",
    "EnvironmentDelete",
    "EnvironmentUpdate",
    # CLI management surface (ref cli/container.py, cli/cluster.py, cli/image.py)
    "TaskList",
    "ClusterList",
    "ImageList",
    "ImageDelete",
]


def _build_registry(
    names: list[str],
    overrides: dict[str, tuple[Optional[str], Optional[str], Arity]],
    service_name: str,
) -> dict[str, RPCMethod]:
    registry = {}
    for name in names:
        req_name, resp_name, arity = overrides.get(name, (None, None, Arity.UNARY_UNARY))
        req_name = req_name or f"{name}Request"
        resp_name = resp_name or f"{name}Response"
        req = getattr(api_pb2, req_name, None)
        resp = getattr(api_pb2, resp_name, None)
        if req is None or resp is None:
            raise RuntimeError(f"proto message missing for RPC {name}: {req_name if req is None else resp_name}")
        registry[name] = RPCMethod(name, req, resp, arity, service_name)
    return registry


RPCS: dict[str, RPCMethod] = {}  # populated below


# --- second data plane: the worker-served task command router ---------------
# (reference modal_proto/task_command_router.proto — exec/stdio/FS directly
# against the worker hosting a sandbox, bypassing the control plane)

ROUTER_SERVICE_NAME = "modal.tpu.api.TaskCommandRouter"

_ROUTER_OVERRIDES: dict[str, tuple[Optional[str], Optional[str], Arity]] = {
    "TaskExecStdioRead": (None, "TaskExecStdioChunk", Arity.UNARY_STREAM),
    # warm-pool handoff (server/warm_pool.py): parked interpreters long-poll
    # the worker's router for their next ContainerArguments
    "PoolAwaitArguments": ("PoolAwaitRequest", "PoolAwaitResponse", Arity.UNARY_UNARY),
}

_ROUTER_RPC_NAMES = [
    "TaskExecStart",
    "TaskExecStdioRead",
    "TaskExecPutInput",
    "TaskExecPtyResize",
    "TaskExecWait",
    "TaskFsOp",
    "PoolAwaitArguments",
    "PoolAdoptAck",
]


RPCS.update(_build_registry(_RPC_NAMES, _OVERRIDES, SERVICE_NAME))
ROUTER_RPCS: dict[str, RPCMethod] = _build_registry(
    _ROUTER_RPC_NAMES, _ROUTER_OVERRIDES, ROUTER_SERVICE_NAME
)


class _StubBase:
    """Client-side stub: one multicallable per RPC on a grpc.aio channel."""

    _registry: dict[str, RPCMethod] = {}
    # monotonically-unique stub ids: id(channel) could alias a GC'd channel's
    # address and inherit its (possibly open) breaker state
    _scope_counter = itertools.count()

    def __init__(self, channel: "grpc.aio.Channel"):
        self._channel = channel
        # per-channel circuit-breaker scope (grpc_utils._breaker_for): one
        # server's failures must not open the circuit for its namesake
        # method on other servers
        breaker_scope = f"ch{next(_StubBase._scope_counter)}"
        for method in self._registry.values():
            if method.arity == Arity.UNARY_UNARY:
                factory = channel.unary_unary
            elif method.arity == Arity.UNARY_STREAM:
                factory = channel.unary_stream
            elif method.arity == Arity.STREAM_UNARY:
                factory = channel.stream_unary
            else:
                factory = channel.stream_stream
            multicallable = factory(
                method.path,
                request_serializer=method.request_type.SerializeToString,
                response_deserializer=method.response_type.FromString,
            )
            multicallable._breaker_scope = breaker_scope
            setattr(self, method.name, multicallable)


class ModalTPUStub(_StubBase):
    _registry = RPCS


class TaskRouterStub(_StubBase):
    _registry = ROUTER_RPCS


def _instrument_unary(name: str, impl: Any) -> Any:
    """Server-side handler wrapper: opens a server span under the caller's
    trace context (from the gRPC metadata) when the caller traces, and
    records the RPC's latency and outcome for every call."""
    import time as _time

    from ..observability import tracing
    from ..observability.catalog import RPC_LATENCY, RPC_TOTAL

    async def instrumented(request, context, _impl=impl, _name=name):
        ctx = tracing.extract_metadata(context.invocation_metadata())
        t0 = _time.perf_counter()
        code = "ok"
        try:
            if ctx is not None:
                with tracing.span(f"rpc.server.{_name}", parent=ctx):
                    return await _impl(request, context)
            return await _impl(request, context)
        except BaseException:
            code = "error"
            raise
        finally:
            RPC_LATENCY.observe(
                _time.perf_counter() - t0, method=_name, exemplar=ctx.trace_id if ctx is not None else None
            )
            RPC_TOTAL.inc(method=_name, code=code)

    return instrumented


def _instrument_stream(name: str, impl: Any) -> Any:
    """Streams (log tails, worker polls) are long-lived: count calls, but
    keep no latency histogram (a poll's duration measures patience)."""
    from ..observability.catalog import RPC_TOTAL

    async def instrumented(request, context, _impl=impl, _name=name):
        code = "ok"
        try:
            async for item in _impl(request, context):
                yield item
        except BaseException:
            code = "error"
            raise
        finally:
            RPC_TOTAL.inc(method=_name, code=code)

    return instrumented


def _maybe_dedupe(servicer: Any, method: RPCMethod, impl: Any) -> Any:
    """Exactly-once layer for mutating RPCs (server/journal.py): when the
    servicer carries a journal-backed IdempotencyCache and the method is in
    IDEMPOTENT_RPCS, a request whose `x-idempotency-key` was already
    answered replays the cached response instead of re-executing, so a
    `retry_transient_errors` re-send after a lost response or a restart of
    the plane cannot apply its effect twice.

    Known window (the JAX package's): the dedupe record is appended after
    the handler's effect records, so a crash exactly between them makes the
    retry re-execute. For the map plane that is harmless (duplicate inputs
    share an idx and the client drops the duplicate output)."""
    from ..server.journal import IDEMPOTENT_RPCS  # lazy: proto must not pull server at import

    cache = getattr(servicer, "idempotency", None)
    if cache is None or method.name not in IDEMPOTENT_RPCS:
        return impl

    async def deduped(request, context, _impl=impl, _name=method.name, _resp=method.response_type):
        key = ""
        for md_key, md_value in context.invocation_metadata() or ():
            if md_key == "x-idempotency-key":
                key = md_value if isinstance(md_value, str) else md_value.decode("utf-8", "replace")
                break
        if key:
            hit = cache.get(key, _name)
            if hit is not None:
                from ..observability.catalog import IDEMPOTENT_REPLAYS

                IDEMPOTENT_REPLAYS.inc(method=_name)
                return _resp.FromString(hit)
        response = await _impl(request, context)
        if key:
            cache.put(key, _name, response.SerializeToString())
        return response

    return deduped


def _maybe_quorum(servicer: Any, method: RPCMethod, impl: Any) -> Any:
    """Quorum-commit layer for journaled RPCs: holds a response until a
    quorum of follower shards has the journal's records. It wraps outside
    `_maybe_dedupe`, as in the JAX package, so the dedupe record is covered
    too. A standalone plane has no replicator and this returns `impl` as it
    is, the JAX layer's path without one; replication and its shard fleet
    come with ROADMAP Queue A 4e."""
    if getattr(servicer, "replicator", None) is None:
        return impl
    raise NotImplementedError("journal quorum replication comes with replication and shards (ROADMAP Queue A 4e)")


def _build_handler(servicer: Any, registry: dict[str, RPCMethod], service_name: str) -> "grpc.GenericRpcHandler":
    import grpc

    handlers = {}
    for method in registry.values():
        impl = getattr(servicer, method.name, None)
        if impl is None:
            continue  # grpc answers UNIMPLEMENTED for a method with no handler
        kwargs = dict(
            request_deserializer=method.request_type.FromString,
            response_serializer=method.response_type.SerializeToString,
        )
        if method.arity == Arity.UNARY_UNARY:
            handlers[method.name] = grpc.unary_unary_rpc_method_handler(
                _instrument_unary(method.name, _maybe_quorum(servicer, method, _maybe_dedupe(servicer, method, impl))),
                **kwargs,
            )
        elif method.arity == Arity.UNARY_STREAM:
            handlers[method.name] = grpc.unary_stream_rpc_method_handler(
                _instrument_stream(method.name, impl), **kwargs
            )
        elif method.arity == Arity.STREAM_UNARY:
            handlers[method.name] = grpc.stream_unary_rpc_method_handler(impl, **kwargs)
        else:
            handlers[method.name] = grpc.stream_stream_rpc_method_handler(impl, **kwargs)
    return grpc.method_handlers_generic_handler(service_name, handlers)


def build_generic_handler(servicer: Any) -> "grpc.GenericRpcHandler":
    """Route every registered control-plane RPC to a same-named async method
    of `servicer`; RPCs it does not implement answer UNIMPLEMENTED."""
    return _build_handler(servicer, RPCS, SERVICE_NAME)


def build_local_handlers(servicer: Any) -> dict[str, tuple[RPCMethod, Any]]:
    """The in-process rung's handler table (_utils/local_transport.py): the
    same wrappers the gRPC server gets (idempotency dedupe, metrics), minus
    the wire. Stream-request methods are not served in process."""
    handlers: dict[str, tuple[RPCMethod, Any]] = {}
    for method in RPCS.values():
        impl = getattr(servicer, method.name, None)
        if impl is None:
            continue
        if method.arity == Arity.UNARY_UNARY:
            handlers[method.name] = (
                method,
                _instrument_unary(method.name, _maybe_quorum(servicer, method, _maybe_dedupe(servicer, method, impl))),
            )
        elif method.arity == Arity.UNARY_STREAM:
            handlers[method.name] = (method, _instrument_stream(method.name, impl))
    return handlers
