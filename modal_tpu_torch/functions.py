"""Function: the remote-callable unit, definition and invocation sides (port
of modal_tpu/functions.py).

Reference: py/modal/_functions.py — `_Function.from_local` (builds
FunctionCreate, _functions.py:594,657), `_FunctionSpec` (_functions.py:549),
`_Invocation` (FunctionMap → FunctionGetOutputs polling, _functions.py:122,
140,284), `_FunctionCall` (detached handles, _functions.py:2002), and
py/modal/parallel_map.py for `.map()`.

Resources carry a `GPUConfig` (`gpu="H100"`, `"H100:8"`, parsed by
`gpu_config.parse_gpu_config`) where the JAX package carries a `TPUConfig`.

`volumes=` maps container paths to Volumes (`volume_mounts`) and to
CloudBucketMounts (`cloud_bucket_mounts`); a `@clustered` function is a gang
(`group_size`, `broadcast_inputs`, `fabric_size`); `target_ttft_ms` and
`target_tokens_per_replica` feed the plane's SLO autoscaler; `proxy=` binds
a static-egress Proxy (its containers see `MODAL_TPU_PROXY_IP`). What waits
for a later sub-slice of ROADMAP Queue A, refused with InvalidError when a
function asks for it: `cloud=` (4e). Every
call goes through the control plane (the region-local input plane,
`_InputPlaneInvocation` and the Attempt* RPCs, comes with 4e); concurrent
FunctionMaps coalesce into one FunctionMapBatch through the client's
micro-batcher (`_utils/coalescer.py`), as the JAX client's do. A web
function's URL comes from `get_web_url`, long-polled while its container
boots.
"""

from __future__ import annotations

import asyncio
import random
import time
import typing
from dataclasses import dataclass, field
from typing import Any, AsyncGenerator, Callable, Optional, Sequence, Union

import grpc
import grpc.aio

from ._utils.async_utils import TaskContext, synchronize_api
from ._utils.blob_utils import MAX_OBJECT_SIZE_BYTES, blob_upload, resolve_blob_data
from ._utils.function_utils import OUTPUTS_TIMEOUT, FunctionInfo, is_generator_fn
from ._utils.grpc_utils import retry_transient_errors
from .client import _Client
from .config import logger
from .exception import ExecutionError, FunctionTimeoutError, InvalidError, NotFoundError, RemoteError
from .gpu_config import GPUSpec, parse_gpu_config
from .object import LoadContext, Resolver, _Object, live_method, live_method_gen
from .proto import api_pb2
from .retries import Retries
from .schedule import Schedule, SchedulerPlacement
from .serialization import deserialize_data_format, deserialize_exception, serialize, serialize_payload_data_format


def build_function_options(
    *,
    min_containers: Optional[int] = None,
    max_containers: Optional[int] = None,
    buffer_containers: Optional[int] = None,
    scaledown_window: Optional[int] = None,
    timeout: Optional[int] = None,
    gpu: Optional[str] = None,
    retries: Optional[Any] = None,
    max_concurrent_inputs: Optional[int] = None,
    secrets: Sequence[Any] = (),
) -> api_pb2.FunctionOptions:
    """FunctionOptions proto for `with_options` rebinding (shared by
    Function and Cls). Only fields the caller passed are present — the
    server merges them over the parent definition; `gpu=` rides the
    `gpu_config` / `has_gpu` pair as the JAX client's `tpu=` rides
    `tpu_config` / `has_tpu`. Secrets must be loaded already."""
    opts = api_pb2.FunctionOptions()
    if min_containers is not None:
        opts.min_containers = min_containers
    if max_containers is not None:
        opts.max_containers = max_containers
    if buffer_containers is not None:
        opts.buffer_containers = buffer_containers
    if scaledown_window is not None:
        opts.scaledown_window = scaledown_window
    if timeout is not None:
        opts.timeout_secs = timeout
    if gpu is not None:
        spec = parse_gpu_config(gpu)
        if spec is not None:
            opts.has_gpu = True
            opts.gpu_config.CopyFrom(spec.to_proto())
    if retries is not None:
        policy = Retries(max_retries=retries) if isinstance(retries, int) else retries
        opts.has_retry_policy = True
        opts.retry_policy.CopyFrom(policy.to_proto())
    if max_concurrent_inputs is not None:
        opts.max_concurrent_inputs = max_concurrent_inputs
    if secrets:
        opts.replace_secrets = True
        for s in secrets:
            opts.secret_ids.append(s.object_id)
    return opts


if typing.TYPE_CHECKING:
    from .app import _App
    from .image import _Image
    from .secret import _Secret


@dataclass
class _FunctionSpec:
    """Everything that defines a function's runtime environment (reference
    `_FunctionSpec`, _functions.py:549)."""

    image: Optional["_Image"] = None
    secrets: Sequence["_Secret"] = field(default_factory=list)
    # container path -> a Volume or a CloudBucketMount
    volumes: dict[str, Any] = field(default_factory=dict)
    mounts: Sequence[Any] = field(default_factory=list)
    # static egress (reference proxy.py:1): a _Proxy handle
    proxy: Optional[Any] = None
    gpu: Optional[GPUSpec] = None
    cpu: Optional[float] = None
    memory: Optional[int] = None
    ephemeral_disk: Optional[int] = None
    timeout: int = 300
    startup_timeout: int = 300
    retries: Optional[Union[int, Retries]] = None
    min_containers: int = 0
    max_containers: int = 0
    buffer_containers: int = 0
    scaledown_window: int = 60
    # serving-tier SLO targets, read by the plane's SLO autoscaler
    # (server/scheduler.py `_slo_desired`)
    target_ttft_ms: float = 0.0
    target_tokens_per_replica: float = 0.0
    max_concurrent_inputs: int = 0
    target_concurrent_inputs: int = 0
    batch_max_size: int = 0
    batch_wait_ms: int = 0
    schedule: Optional[Schedule] = None
    scheduler_placement: Optional[SchedulerPlacement] = None
    enable_memory_snapshot: bool = False
    restrict_output: bool = False
    # "pickle" (rich Python payloads) or "cbor" (cross-language wire format,
    # reference _serialization.py:359) — negotiated per-input, echoed on
    # results by the container
    payload_format: str = "pickle"
    experimental_options: dict[str, str] = field(default_factory=dict)
    # a gang (@clustered): ranks per call, each input to every rank, and the
    # ranks that must share one fabric
    cluster_size: int = 0
    broadcast_inputs: bool = True
    fabric_size: int = 0
    i6pn: bool = False

    def resources_proto(self) -> api_pb2.Resources:
        res = api_pb2.Resources(
            milli_cpu=int((self.cpu or 0) * 1000),
            memory_mb=self.memory or 0,
            ephemeral_disk_mb=self.ephemeral_disk or 0,
        )
        if self.gpu is not None:
            res.gpu_config.CopyFrom(self.gpu.to_proto())
        return res

    def retry_policy_proto(self) -> Optional[api_pb2.RetryPolicy]:
        if self.retries is None:
            return None
        if isinstance(self.retries, int):
            return Retries(max_retries=self.retries).to_proto()
        return self.retries.to_proto()


class _Function(_Object, type_prefix="fu"):
    _info: Optional[FunctionInfo]
    _app: Optional["_App"] = None
    _spec: Optional[_FunctionSpec] = None
    _metadata: Optional[api_pb2.FunctionHandleMetadata] = None
    _is_generator: Optional[bool] = None
    _use_method_name: str = ""

    def _initialize_from_empty(self) -> None:
        self._info = None
        self._metadata = None
        self._is_generator = None

    def _hydrate_metadata(self, metadata: Optional[api_pb2.FunctionHandleMetadata]) -> None:
        if metadata is not None:
            self._metadata = metadata
            self._is_generator = metadata.is_generator

    def _get_metadata(self) -> Optional[bytes]:
        return self._metadata.SerializeToString() if self._metadata is not None else b""

    @classmethod
    def _deserialize_metadata(cls, metadata_bytes: bytes) -> Optional[api_pb2.FunctionHandleMetadata]:
        return api_pb2.FunctionHandleMetadata.FromString(metadata_bytes) if metadata_bytes else None

    # ------------------------------------------------------------------
    # Definition side
    # ------------------------------------------------------------------

    @staticmethod
    def from_local(
        info: FunctionInfo,
        app: "_App",
        spec: _FunctionSpec,
        is_generator: Optional[bool] = None,
        is_class: bool = False,
        class_serialized: Optional[bytes] = None,
        tag: Optional[str] = None,
        webhook_type: int = api_pb2.WEB_ENDPOINT_TYPE_UNSPECIFIED,
    ) -> "_Function":
        """Build the unhydrated Function whose loader issues FunctionCreate
        (reference from_local, _functions.py:657-1173). Nothing reaches the
        control plane until the app runs: a container that imports the
        user's file builds these handles and never loads them."""
        tag = tag or info.function_name
        if is_generator is None:
            is_generator = info.raw_f is not None and is_generator_fn(info.raw_f)

        def _deps() -> list[_Object]:
            deps: list[_Object] = []
            if spec.image is not None:
                deps.append(spec.image)
            deps.extend(spec.secrets)
            deps.extend(v for v in spec.volumes.values() if isinstance(v, _Object))
            deps.extend(m for m in spec.mounts if isinstance(m, _Object))
            if spec.proxy is not None:
                deps.append(spec.proxy)
            return deps

        async def _load(self: "_Function", resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
            f_def = api_pb2.Function(
                module_name=info.module_name or "",
                function_name=info.function_name,
                function_type=(
                    api_pb2.FUNCTION_TYPE_GENERATOR if is_generator else api_pb2.FUNCTION_TYPE_FUNCTION
                ),
                definition_type=info.definition_type,
                timeout_secs=spec.timeout,
                startup_timeout_secs=spec.startup_timeout,
                concurrency_limit=spec.max_containers,
                max_concurrent_inputs=spec.max_concurrent_inputs,
                target_concurrent_inputs=spec.target_concurrent_inputs,
                batch_max_size=spec.batch_max_size,
                batch_linger_ms=spec.batch_wait_ms,
                group_size=spec.cluster_size,
                broadcast_inputs=spec.broadcast_inputs,
                fabric_size=spec.fabric_size,
                i6pn_enabled=spec.i6pn,
                is_class=is_class,
                enable_memory_snapshot=spec.enable_memory_snapshot,
                restrict_output=spec.restrict_output,
                app_name=app.name or "",
                function_schema=info.get_schema(),
                webhook_type=webhook_type,
            )
            f_def.autoscaler_settings.CopyFrom(
                api_pb2.AutoscalerSettings(
                    min_containers=spec.min_containers,
                    max_containers=spec.max_containers,
                    buffer_containers=spec.buffer_containers,
                    scaledown_window=spec.scaledown_window,
                    target_ttft_ms=spec.target_ttft_ms,
                    target_tokens_per_replica=spec.target_tokens_per_replica,
                )
            )
            for k, v in spec.experimental_options.items():
                f_def.experimental_options[k] = v
            f_def.resources.CopyFrom(spec.resources_proto())
            retry_proto = spec.retry_policy_proto()
            if retry_proto is not None:
                f_def.retry_policy.CopyFrom(retry_proto)
            if spec.schedule is not None:
                f_def.schedule.CopyFrom(spec.schedule.to_proto())
            if spec.scheduler_placement is not None:
                f_def.scheduler_placement.CopyFrom(spec.scheduler_placement.to_proto())
            class_bytes = getattr(self, "_class_serialized_bytes", None) or class_serialized
            if class_bytes:
                f_def.is_class = True
                f_def.class_serialized = class_bytes
            if info.is_serialized:
                if info.raw_f is not None:
                    f_def.function_serialized = serialize(info.raw_f)
            else:
                # the import path, so a local worker's container can sys.path it
                globals_path = info.get_globals_path()
                if globals_path:
                    f_def.experimental_options["globals_path"] = globals_path
                if info.module_name == "__main__" and info.file_path:
                    f_def.experimental_options["main_file_path"] = info.file_path
            if spec.image is not None:
                f_def.image_id = spec.image.object_id
            f_def.secret_ids.extend([s.object_id for s in spec.secrets])
            f_def.mount_ids.extend([m.object_id for m in spec.mounts if isinstance(m, _Object)])
            if spec.proxy is not None:
                f_def.proxy_id = spec.proxy.object_id
            from .cloud_bucket_mount import CloudBucketMount

            for path, vol in spec.volumes.items():
                if isinstance(vol, CloudBucketMount):
                    f_def.cloud_bucket_mounts[path] = vol.serialize()
                else:
                    f_def.volume_mounts[path] = vol.object_id

            req = api_pb2.FunctionCreateRequest(
                app_id=context.app_id or "",
                function=f_def,
                existing_function_id=existing_object_id or "",
                tag=tag,
            )
            resp = await retry_transient_errors(context.client.stub.FunctionCreate, req)
            self._hydrate(resp.function_id, context.client, resp.handle_metadata)

        obj = _Function._from_loader(_load, f"Function({tag})", deps=_deps)
        obj._info = info
        obj._app = app
        obj._spec = spec
        obj._is_generator = is_generator
        obj._tag = tag
        return obj

    @staticmethod
    def from_name(
        app_name: str,
        name: str,
        *,
        environment_name: Optional[str] = None,
    ) -> "_Function":
        """Reference a deployed function (reference from_name,
        _functions.py:1293)."""

        async def _load(self: "_Function", resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
            req = api_pb2.FunctionGetRequest(
                app_name=app_name,
                object_tag=name,
                environment_name=environment_name or context.environment_name,
            )
            try:
                resp = await retry_transient_errors(context.client.stub.FunctionGet, req)
            except NotFoundError:
                raise NotFoundError(f"function {app_name}/{name} not found") from None
            self._hydrate(resp.function_id, context.client, resp.handle_metadata)

        return _Function._from_loader(_load, f"Function.from_name({app_name!r}, {name!r})", hydrate_lazily=True)

    @staticmethod
    async def lookup(app_name: str, name: str, *, client: Optional[_Client] = None) -> "_Function":
        obj = _Function.from_name(app_name, name)
        await obj.hydrate(client)
        return obj

    def with_options(
        self,
        *,
        min_containers: Optional[int] = None,
        max_containers: Optional[int] = None,
        buffer_containers: Optional[int] = None,
        scaledown_window: Optional[int] = None,
        timeout: Optional[int] = None,
        gpu: Optional[str] = None,
        retries: Optional[Any] = None,
        max_concurrent_inputs: Optional[int] = None,
        secrets: Sequence[Any] = (),
    ) -> "_Function":
        """A variant of this function with rebinding-time overrides —
        autoscaler, card ask, timeout, retries, secrets — without redefining
        it (reference `with_options`, _function_variants.py /
        _functions.py:1526). The variant is created server-side at hydration
        via FunctionBindParams."""
        opts = build_function_options(
            min_containers=min_containers,
            max_containers=max_containers,
            buffer_containers=buffer_containers,
            scaledown_window=scaledown_window,
            timeout=timeout,
            gpu=gpu,
            retries=retries,
            max_concurrent_inputs=max_concurrent_inputs,
            secrets=secrets,
        )
        parent = self

        async def _load(self: "_Function", resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
            if not parent.is_hydrated:
                await resolver.load(parent, context)
            resp = await retry_transient_errors(
                parent.client.stub.FunctionBindParams,
                api_pb2.FunctionBindParamsRequest(function_id=parent.object_id, options=opts),
            )
            self._hydrate(resp.bound_function_id, parent.client, resp.handle_metadata)

        fn = _Function._from_loader(_load, f"{self._rep}.with_options(...)", hydrate_lazily=True, deps=lambda: [parent])
        fn._spec = self._spec
        fn._info = self._info
        fn._is_generator = self._is_generator
        return fn

    # ------------------------------------------------------------------
    # Properties
    # ------------------------------------------------------------------

    @property
    def tag(self) -> str:
        return getattr(self, "_tag", self._info.function_name if self._info else "<unknown>")

    @property
    def app(self) -> Optional["_App"]:
        return self._app

    @property
    def info(self) -> Optional[FunctionInfo]:
        return self._info

    @property
    def spec(self) -> Optional[_FunctionSpec]:
        return self._spec

    @property
    def _data_format(self) -> int:
        """Wire format this handle's inputs are serialized with."""
        if self._spec is not None and self._spec.payload_format == "cbor":
            return api_pb2.DATA_FORMAT_CBOR
        return api_pb2.DATA_FORMAT_PICKLE

    @property
    def is_generator(self) -> bool:
        return bool(self._is_generator)

    @property
    def cluster_size(self) -> int:
        """Ranks per call: a gang's size, 1 otherwise."""
        return (self._spec.cluster_size if self._spec is not None else 0) or 1

    def get_raw_f(self) -> Callable:
        assert self._info is not None and self._info.raw_f is not None
        return self._info.raw_f

    # ------------------------------------------------------------------
    # Invocation side
    # ------------------------------------------------------------------

    @live_method
    async def _call_function(self, args: tuple, kwargs: dict) -> Any:
        # root span of the distributed trace: the client's RPCs, the queue
        # wait, the placement, the container's boot and the user's
        # execution stitch under this trace id (observability/tracing.py)
        from .observability import tracing
        from .observability.catalog import DISPATCH_LATENCY

        t_dispatch0 = time.perf_counter()
        with tracing.span(
            "function.call",
            attrs={"function_id": self.object_id or "", "function": self.tag},
        ) as root:
            try:
                # client.prepare / client.await_output: the SDK's own wall
                # time (serialize, FunctionMap) and the result wait
                with tracing.span("client.prepare"):
                    invocation = await _Invocation.create(
                        self, args, kwargs, client=self.client, invocation_type=api_pb2.FUNCTION_CALL_INVOCATION_TYPE_SYNC
                    )
                with tracing.span("client.await_output"):
                    return await invocation.run_function()
            finally:
                DISPATCH_LATENCY.observe(time.perf_counter() - t_dispatch0, exemplar=root.trace_id)

    @live_method_gen
    async def _call_function_generator(self, args: tuple, kwargs: dict) -> AsyncGenerator[Any, None]:
        invocation = await _Invocation.create(
            self, args, kwargs, client=self.client, invocation_type=api_pb2.FUNCTION_CALL_INVOCATION_TYPE_SYNC
        )
        async for item in invocation.run_generator():
            yield item

    async def remote(self, *args: Any, **kwargs: Any) -> Any:
        """Call the function remotely and wait for the result."""
        if self.is_generator:
            raise InvalidError("use remote_gen() for generator functions")
        return await self._call_function(args, kwargs)

    async def remote_gen(self, *args: Any, **kwargs: Any) -> AsyncGenerator[Any, None]:
        if not self.is_generator:
            raise InvalidError("remote_gen() is only for generator functions")
        async for item in self._call_function_generator(args, kwargs):
            yield item

    def local(self, *args: Any, **kwargs: Any) -> Any:
        """Run the underlying callable locally, bypassing the platform."""
        if self._info is None or self._info.raw_f is None:
            raise ExecutionError(f"{self._rep} has no local definition (looked up from server?)")
        return self._info.raw_f(*args, **kwargs)

    @live_method
    async def spawn(self, *args: Any, **kwargs: Any) -> "_FunctionCall":
        """Start the call without waiting; returns a detached handle
        (reference .spawn, _functions.py)."""
        invocation = await _Invocation.create(
            self, args, kwargs, client=self.client, invocation_type=api_pb2.FUNCTION_CALL_INVOCATION_TYPE_ASYNC
        )
        fc = _FunctionCall._new_hydrated(invocation.function_call_id, self.client, None)
        fc._is_generator = self.is_generator
        return fc

    def map(
        self,
        *input_iterators: Any,
        kwargs: dict = {},
        order_outputs: bool = True,
        return_exceptions: bool = False,
    ):
        """Streaming fan-out over inputs (reference parallel_map.py:361)."""
        from .parallel_map import _map_sync

        return _map_sync(
            self,
            *input_iterators,
            kwargs=kwargs,
            order_outputs=order_outputs,
            return_exceptions=return_exceptions,
        )

    def starmap(
        self,
        input_iterator: Any,
        *,
        kwargs: dict = {},
        order_outputs: bool = True,
        return_exceptions: bool = False,
    ):
        from .parallel_map import _starmap_sync

        return _starmap_sync(
            self, input_iterator, kwargs=kwargs, order_outputs=order_outputs, return_exceptions=return_exceptions
        )

    def for_each(self, *input_iterators: Any, kwargs: dict = {}, ignore_exceptions: bool = False) -> None:
        from .parallel_map import _for_each_sync

        return _for_each_sync(self, *input_iterators, kwargs=kwargs, ignore_exceptions=ignore_exceptions)

    async def spawn_map(self, *input_iterators: Any, kwargs: dict = {}) -> "_FunctionCall":
        from .parallel_map import _spawn_map_async

        return await _spawn_map_async(self, *input_iterators, kwargs=kwargs)

    @live_method
    async def get_web_url(self, timeout: float = 60.0) -> str:
        """URL of this function's web endpoint, long-polling while the
        serving container boots (reference web_url on function handles)."""
        resp = await retry_transient_errors(
            self.client.stub.FunctionGetWebUrl,
            api_pb2.FunctionGetWebUrlRequest(function_id=self.object_id, timeout=timeout),
            attempt_timeout=timeout + 5.0,
        )
        if not resp.web_url:
            raise ExecutionError("web endpoint did not come up (is webhook_type set?)")
        return resp.web_url

    @live_method
    async def get_current_stats(self) -> api_pb2.FunctionStats:
        return await retry_transient_errors(
            self.client.stub.FunctionGetCurrentStats,
            api_pb2.FunctionGetCurrentStatsRequest(function_id=self.object_id),
            total_timeout=10.0,
        )

    @live_method
    async def update_autoscaler(
        self,
        *,
        min_containers: Optional[int] = None,
        max_containers: Optional[int] = None,
        buffer_containers: Optional[int] = None,
        scaledown_window: Optional[int] = None,
        target_ttft_ms: Optional[float] = None,
        target_tokens_per_replica: Optional[float] = None,
    ) -> None:
        settings = api_pb2.AutoscalerSettings(
            min_containers=min_containers or 0,
            max_containers=max_containers or 0,
            buffer_containers=buffer_containers or 0,
            scaledown_window=scaledown_window or 0,
            target_ttft_ms=target_ttft_ms or 0.0,
            target_tokens_per_replica=target_tokens_per_replica or 0.0,
        )
        await retry_transient_errors(
            self.client.stub.FunctionUpdateSchedulingParams,
            api_pb2.FunctionUpdateSchedulingParamsRequest(function_id=self.object_id, settings=settings),
        )


# ---------------------------------------------------------------------------
# Invocation engine
# ---------------------------------------------------------------------------


async def _flush_function_maps(client: _Client, requests: list) -> list:
    """One coalesced FunctionMap flush: one FunctionMapBatch for the window;
    per-item FunctionMaps ONLY on errors that guarantee the batch executed
    nothing: UNIMPLEMENTED (an older server, remembered client-wide) and
    NOT_FOUND (the server validates every sub-request before executing
    any). Anything else (transport loss after the retry budget, INTERNAL)
    may have committed server-side, so it propagates to every waiter
    instead of silently re-dispatching the window. A per-item not-found
    arrives as an EMPTY sub-response (the server never aborts after a
    partial execution) and is raised on that waiter alone."""
    from .observability.catalog import FASTPATH_FALLBACKS

    stub = client.stub
    if len(requests) > 1 and not client._map_batch_unsupported:
        try:
            resp = await retry_transient_errors(stub.FunctionMapBatch, api_pb2.FunctionMapBatchRequest(requests=requests))
            return [
                r if r.function_call_id else NotFoundError("function not found (removed mid-dispatch)")
                for r in resp.responses
            ]
        except grpc.aio.AioRpcError as exc:
            if exc.code() != grpc.StatusCode.UNIMPLEMENTED:
                raise
            client._map_batch_unsupported = True
            FASTPATH_FALLBACKS.inc(rung="batch", reason="unimplemented")
        except NotFoundError:
            # retry_transient_errors converts NOT_FOUND: the server's upfront
            # validation aborted BEFORE executing anything, so a per-item
            # resend is safe and isolates the stale caller
            FASTPATH_FALLBACKS.inc(rung="batch", reason="validation")
    # per-item sends with per-item outcomes: one bad sub-request fails ITS
    # caller only (the MicroBatcher raises a returned exception on the
    # matching waiter)
    return await asyncio.gather(*(retry_transient_errors(stub.FunctionMap, r) for r in requests),
                                return_exceptions=True)


async def _submit_function_map(client: _Client, request: api_pb2.FunctionMapRequest) -> api_pb2.FunctionMapResponse:
    """Submit one FunctionMap through the client's coalescing window (the
    concurrent submits of one event-loop tick, or of one in-flight flush,
    share one FunctionMapBatch), or directly when coalescing is disabled
    (MODAL_TPU_DISPATCH_COALESCE=0)."""
    from ._utils.coalescer import coalescing_enabled

    if not coalescing_enabled():
        return await retry_transient_errors(client.stub.FunctionMap, request)
    batcher = client._batchers.get("FunctionMap", lambda reqs: _flush_function_maps(client, reqs))
    return await batcher.submit(request)


async def _create_input(
    args: tuple,
    kwargs: dict,
    stub,
    *,
    idx: int = 0,
    method_name: str = "",
    data_format: int = api_pb2.DATA_FORMAT_PICKLE,
) -> api_pb2.FunctionPutInputsItem:
    """Serialize (args, kwargs); offload to blob store over the inline limit
    (reference _create_input, _functions.py). data_format is negotiated
    per-input: the container deserializes by this format and echoes it on
    the result (reference _serialization.py:359 — CBOR is how non-Python
    SDKs call deployed functions)."""
    from .observability import tracing

    ser_ctx = tracing.current_context()
    t_ser = time.time()
    if data_format == api_pb2.DATA_FORMAT_CBOR:
        payload = serialize_payload_data_format([list(args), kwargs], data_format)
    else:
        # zero-copy: tensor args ride as out-of-band segments; the blob
        # upload below streams them without joining the payload
        payload = serialize_payload_data_format((args, kwargs), data_format)
    input_pb = api_pb2.FunctionInput(data_format=data_format, method_name=method_name)
    if payload.nbytes > MAX_OBJECT_SIZE_BYTES:
        input_pb.args_blob_id = await blob_upload(payload, stub)
    else:
        input_pb.args = payload.join()
    if ser_ctx is not None:
        # the serialize segment of the dispatch critical path, blob offload
        # time included
        tracing.record_span(
            "client.serialize",
            start=t_ser,
            end=time.time(),
            parent=ser_ctx,
            attrs={"bytes": payload.nbytes, "blob": bool(input_pb.args_blob_id)},
        )
    return api_pb2.FunctionPutInputsItem(idx=idx, input=input_pb)


async def _process_result(result: api_pb2.GenericResult, data_format: int, stub, client) -> Any:
    """Decode a GenericResult into a value or raise (reference
    _process_result, _functions.py)."""
    from .observability import tracing

    des_ctx = tracing.current_context()
    t_des = time.time()
    try:
        data = await resolve_blob_data(result, stub)

        if result.status == api_pb2.GENERIC_STATUS_TIMEOUT:
            raise FunctionTimeoutError(result.exception)
        elif result.status == api_pb2.GENERIC_STATUS_TERMINATED:
            raise RemoteError(f"function terminated: {result.exception or 'container stopped'}")
        elif result.status == api_pb2.GENERIC_STATUS_INTERNAL_FAILURE:
            raise ExecutionError(result.exception)
        elif result.status != api_pb2.GENERIC_STATUS_SUCCESS:
            if data:
                raise deserialize_exception(data, result.exception, result.traceback, client, result.serialized_tb)
            raise RemoteError(result.exception or "remote function failed")

        return deserialize_data_format(data, data_format or api_pb2.DATA_FORMAT_PICKLE, client)
    finally:
        if des_ctx is not None:
            # the deserialize tail of the dispatch critical path (blob fetch
            # for spilled results and exception decode included)
            tracing.record_span("client.deserialize", start=t_des, end=time.time(), parent=des_ctx)


async def _close_stream_call(call: Any) -> None:
    """Release a server-streaming outputs call: gRPC calls cancel, in-process
    async generators aclose. A leaked stream would park a waiter on the
    server's output condition forever."""
    try:
        call.cancel()
    except AttributeError:
        try:
            await call.aclose()
        except BaseException:  # noqa: BLE001 — best-effort release
            pass
    except BaseException:  # noqa: BLE001
        pass


class _Invocation:
    """One function call's client-side state machine (reference
    _Invocation, _functions.py:122)."""

    def __init__(self, stub, function_call_id: str, client: _Client, input_id: Optional[str] = None):
        self.stub = stub
        self.client = client
        self.function_call_id = function_call_id
        self.input_id = input_id
        # push-streamed output delivery: tried first, and downgraded to the
        # unary poll rung for this invocation the first time the stream path
        # proves unusable (a server without it, a reset, transport loss)
        self._stream_broken = False

    @staticmethod
    async def create(
        function: _Function,
        args: tuple,
        kwargs: dict,
        *,
        client: _Client,
        invocation_type: int,
        method_name: str = "",
    ) -> "_Invocation":
        stub = client.stub
        item = await _create_input(
            args,
            kwargs,
            stub,
            method_name=method_name or function._use_method_name,
            data_format=function._data_format,
        )
        request = api_pb2.FunctionMapRequest(
            function_id=function.object_id,
            function_call_type=api_pb2.FUNCTION_CALL_TYPE_UNARY,
            pipelined_inputs=[item],
            invocation_type=invocation_type,
        )
        response = await _submit_function_map(client, request)
        input_id = response.pipelined_inputs[0].input_id if response.pipelined_inputs else None
        return _Invocation(stub, response.function_call_id, client, input_id)

    async def _pop_outputs_stream(
        self, timeout: Optional[float], clear_on_success: bool, last_entry_id: str
    ) -> api_pb2.FunctionGetOutputsResponse:
        """Streaming rung: ONE keep-alive FunctionStreamOutputs RPC delivers
        the output the instant the server appends it. Raises on any
        stream-level failure; the caller downgrades to the poll rung."""
        from .observability import tracing
        from .observability.catalog import OUTPUT_STREAM_EVENTS

        # always cursor reads (clear_on_success=False) on the stream rung:
        # consuming server-side before the client has the bytes would lose
        # the output to a reset landing in the delivery window
        request = api_pb2.FunctionGetOutputsRequest(
            function_call_id=self.function_call_id,
            timeout=OUTPUTS_TIMEOUT,
            last_entry_id=last_entry_id,
            max_values=1,
            clear_on_success=False,
            requested_at=time.time(),
        )
        t0 = time.monotonic()
        stream = self.stub.FunctionStreamOutputs(request)
        OUTPUT_STREAM_EVENTS.inc(event="open")
        t_span = time.time()
        ctx = tracing.current_context()
        last_empty = None
        try:
            it = stream.__aiter__()
            while True:
                remaining = None if timeout is None else timeout - (time.monotonic() - t0)
                if remaining is not None and remaining <= 0:
                    return last_empty or api_pb2.FunctionGetOutputsResponse(outputs=[], last_entry_id=last_entry_id)
                try:
                    if remaining is None:
                        response = await it.__anext__()
                    else:
                        response = await asyncio.wait_for(it.__anext__(), remaining)
                except asyncio.TimeoutError:
                    return last_empty or api_pb2.FunctionGetOutputsResponse(outputs=[], last_entry_id=last_entry_id)
                except StopAsyncIteration:
                    # the server closed a stream we still needed: broken rung
                    raise grpc.aio.AioRpcError(
                        grpc.StatusCode.UNAVAILABLE,
                        grpc.aio.Metadata(),
                        grpc.aio.Metadata(),
                        details="output stream ended early",
                    ) from None
                if response.outputs:
                    OUTPUT_STREAM_EVENTS.inc(event="batch")
                    return response
                OUTPUT_STREAM_EVENTS.inc(event="keepalive")
                last_empty = response
        finally:
            await _close_stream_call(stream)
            if ctx is not None:
                tracing.record_span(
                    "client.stream_outputs",
                    start=t_span,
                    end=time.time(),
                    parent=ctx,
                    attrs={"function_call_id": self.function_call_id},
                )

    async def pop_function_call_outputs(
        self, timeout: Optional[float], clear_on_success: bool, last_entry_id: str = ""
    ) -> api_pb2.FunctionGetOutputsResponse:
        t0 = time.monotonic()
        # streaming serves the blocking waits; instant and sub-second checks
        # (run_generator's "did the call end?" probe, short .get timeouts)
        # keep the unary poll. UNIMPLEMENTED is remembered client-wide
        if (
            not self._stream_broken
            and not getattr(self.client, "_stream_outputs_unsupported", False)
            and (timeout is None or timeout >= 1.0)
        ):
            try:
                return await self._pop_outputs_stream(timeout, clear_on_success, last_entry_id)
            except grpc.aio.AioRpcError as exc:
                code = exc.code()
                if code == grpc.StatusCode.NOT_FOUND:
                    raise NotFoundError(exc.details()) from None
                if code == grpc.StatusCode.UNAUTHENTICATED:
                    from .exception import AuthError

                    raise AuthError(exc.details()) from None
                # anything else downgrades this invocation to the poll rung;
                # the call still completes exactly once there
                from .observability.catalog import OUTPUT_STREAM_EVENTS

                self._stream_broken = True
                if code == grpc.StatusCode.UNIMPLEMENTED:
                    self.client._stream_outputs_unsupported = True
                    OUTPUT_STREAM_EVENTS.inc(event="fallback")
                else:
                    OUTPUT_STREAM_EVENTS.inc(event="reset")
                logger.debug(f"output stream broke ({code}); polling instead")
        # t0 predates the stream attempt: time spent streaming counts against
        # the caller's timeout
        while True:
            remaining = None if timeout is None else timeout - (time.monotonic() - t0)
            poll_window = OUTPUTS_TIMEOUT if remaining is None else max(0.0, min(remaining, OUTPUTS_TIMEOUT))
            request = api_pb2.FunctionGetOutputsRequest(
                function_call_id=self.function_call_id,
                timeout=poll_window,
                last_entry_id=last_entry_id,
                max_values=1,
                clear_on_success=clear_on_success,
                requested_at=time.time(),
            )
            response = await retry_transient_errors(
                self.stub.FunctionGetOutputs,
                request,
                attempt_timeout=poll_window + 5.0,
                max_retries=None,
            )
            if response.outputs:
                return response
            if timeout is not None and (time.monotonic() - t0) >= timeout:
                return response
            if poll_window < 1.0:
                # jittered pause for sub-second windows: as `timeout` runs
                # down the server returns at once, and the tail of the
                # deadline must not become a hot re-issue loop
                remaining = None if timeout is None else timeout - (time.monotonic() - t0)
                pause = random.uniform(0.02, 0.1)
                if remaining is not None:
                    pause = min(pause, max(0.0, remaining))
                await asyncio.sleep(pause)
            last_entry_id = response.last_entry_id or last_entry_id

    async def run_function(self) -> Any:
        response = await self.pop_function_call_outputs(timeout=None, clear_on_success=True)
        assert response.outputs
        item = response.outputs[0]
        return await _process_result(item.result, item.data_format, self.stub, self.client)

    async def poll_function(self, timeout: Optional[float] = None) -> Any:
        """One bounded poll (used by FunctionCall.get with timeout)."""
        response = await self.pop_function_call_outputs(timeout=timeout, clear_on_success=False)
        if not response.outputs:
            from .exception import TimeoutError as _TimeoutError

            raise _TimeoutError("function call result not ready")
        item = response.outputs[0]
        return await _process_result(item.result, item.data_format, self.stub, self.client)

    async def run_generator(self) -> AsyncGenerator[Any, None]:
        """Stream generator outputs via FunctionCallGetData (reference data
        chunk streaming). A generator that raises mid-stream produces no
        GENERATOR_DONE data chunk, only a FAILURE unary output, so every
        empty data poll also checks the unary channel and re-raises the
        remote exception instead of spinning."""
        last_index = 0
        failed_item = None  # failure output seen; raise after draining chunks
        while True:
            got_chunk = False
            req = api_pb2.FunctionCallGetDataRequest(function_call_id=self.function_call_id, last_index=last_index)
            async for chunk in self.stub.FunctionCallGetData(req):
                got_chunk = True
                last_index = chunk.index
                if chunk.data_format == api_pb2.DATA_FORMAT_GENERATOR_DONE:
                    return
                data = chunk.data
                if chunk.data_blob_id:
                    from ._utils.blob_utils import blob_download

                    data = await blob_download(chunk.data_blob_id, self.stub)
                yield deserialize_data_format(data, chunk.data_format, self.client)
            if got_chunk:
                continue
            if failed_item is not None:
                # the stream is dry and the call failed: the items the
                # generator did yield were drained above
                await _process_result(failed_item.result, failed_item.data_format, self.stub, self.client)
                return
            # data channel idle: did the call end without a DONE chunk?
            response = await self.pop_function_call_outputs(timeout=0.0, clear_on_success=False)
            if response.outputs:
                item = response.outputs[0]
                if item.result.status != api_pb2.GENERIC_STATUS_SUCCESS:
                    failed_item = item
                    continue  # one more GetData round collects raced chunks
                if item.data_format != api_pb2.DATA_FORMAT_GENERATOR_DONE:
                    # a unary call consumed through the generator surface: no
                    # DONE chunk will ever arrive
                    raise InvalidError("call produced a unary result, not a generator stream — use .get()")
                continue
            await asyncio.sleep(0.01)


class _FunctionCall(_Object, type_prefix="fc"):
    """Detached handle to a running/completed call (reference
    _FunctionCall, _functions.py:2002)."""

    _is_generator: bool = False

    def _invocation(self) -> _Invocation:
        return _Invocation(self.client.stub, self.object_id, self.client)

    @live_method
    async def get(self, timeout: Optional[float] = None) -> Any:
        if self._is_generator:
            raise InvalidError("use get_gen() on generator calls")
        if timeout is not None:
            return await self._invocation().poll_function(timeout=timeout)
        return await self._invocation().run_function()

    @live_method_gen
    async def get_gen(self) -> AsyncGenerator[Any, None]:
        async for item in self._invocation().run_generator():
            yield item

    @live_method
    async def get_call_graph(self) -> list:
        resp = await retry_transient_errors(
            self.client.stub.FunctionCallGetInfo, api_pb2.FunctionCallGetInfoRequest(function_call_id=self.object_id)
        )
        return [resp.info]

    @live_method
    async def get_timeline(self) -> api_pb2.TaskGetTimelineResponse:
        """The plane's boot and serve stamps of the tasks that served this
        call (assignment → ContainerHello → first input → first output)."""
        return await retry_transient_errors(
            self.client.stub.TaskGetTimeline, api_pb2.TaskGetTimelineRequest(function_call_id=self.object_id)
        )

    @live_method
    async def cancel(self, terminate_containers: bool = False) -> None:
        await retry_transient_errors(
            self.client.stub.FunctionCallCancel,
            api_pb2.FunctionCallCancelRequest(function_call_id=self.object_id, terminate_containers=terminate_containers),
        )

    @staticmethod
    async def from_id(function_call_id: str, client: Optional[_Client] = None) -> "_FunctionCall":
        if client is None:
            client = await _Client.from_env()
        return _FunctionCall._new_hydrated(function_call_id, client, None)

    @staticmethod
    async def gather(*function_calls: "_FunctionCall") -> list[Any]:
        return await TaskContext.gather(*[fc.get() for fc in function_calls])


Function = synchronize_api(_Function)
FunctionCall = synchronize_api(_FunctionCall)
