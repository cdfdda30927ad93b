"""Container entrypoint: the process the worker spawns (port of
modal_tpu/runtime/container_entrypoint.py).

Reference: py/modal/_container_entrypoint.py — `main` (:468), `run_function`
(:422), `call_function` (:114); bootstrap from ContainerArguments at
MODAL_CONTAINER_ARGUMENTS_PATH (:475-490).

    python -m modal_tpu_torch.runtime.container_entrypoint

A boot runs in the JAX entrypoint's order: import tracing first; the
client (on the local fast path: the plane's Unix socket and its blob store
by path, from the worker's env), ContainerHello and the heartbeat, with no
torch loaded yet; for a function that asks for a card, torch, on the main
thread (`container.import_torch`); the user's function or class;
the compile hooks and the fleet compile cache under the kernel builds
(the port's counterpart of the persistent XLA cache); `restore_snapshot`,
or else the `@enter(snap=True)` hooks and `save_snapshot`, then
ContainerCheckpoint; the other enter hooks; the AOT warm-up of the kernels
(`MODAL_TPU_AOT_LOWER`); then the input loop until the kill switch or the
scaledown window, or, for a web function, an HTTP server on a local port
whose URL goes to the control plane (FunctionSetWebUrl; runtime/asgi.py). Sync user code runs on the main thread, where a cancel
(SIGUSR1) raises InputCancellation inside it; SIGTERM drains gracefully
and SIGUSR2 (preemption) flushes the in-flight inputs' resume tokens first.

A gang member meets its peers before the user's code is imported
(`runtime/clustered.py`: TaskClusterHello, then a torch.distributed process
group over NCCL or gloo); cloud bucket mounts are synced into their paths
then too, and written back at exit, and each mounted Volume is committed at
exit.

A function with `runtime_debug=True` runs each input under torch.profiler
(`_maybe_profile`) and exports a Chrome trace (`*.pt.trace.json`) into
`<task_dir>/profile`, which AppListProfiles lists; the profiler traces the
card (CUDA activity) when the function asked for one, and the CPU only when
it asked for none. `MODAL_TPU_PROFILE` starts the sampling profiler at boot
(observability/profiler.py), and the heartbeat applies the plane's
ProfileControl commands to it.

With `MODAL_TPU_POOL_ID` set the process is a warm-pool interpreter
(server/warm_pool.py, `pool_main`): it imports torch on the main thread
with no CUDA context and parks on the worker's task router; each handoff
applies the placement's environment (its card pinning and kernel build dir
among it) and runs `main_async`, then the process re-parks, or exits when
the placement initialized CUDA (ROADMAP Queue C 28). With
`MODAL_TPU_AOT_LOWER` set, a parked interpreter also builds, or fetches
from the fleet store, its entries' kernel libraries while it waits, into
the build directory its placements use, and loads them into the process
(`_park_aot_warmup`, span `coldstart.aot_lower`): loading a kernel library
makes no CUDA context (ROADMAP Queue C 28).
"""

from __future__ import annotations

import asyncio
import contextlib
import importlib
import inspect
import os
import sys
import threading
import time
import traceback
from typing import Any, Optional

# import tracing hooks in first so the heavy imports below are attributed
from .telemetry import maybe_instrument_from_env

maybe_instrument_from_env()

# adopt the worker-exported span sink before anything else runs, so the
# boot's spans land in the supervisor's trace store
from ..observability import tracing  # noqa: E402

tracing.maybe_configure_from_env()

from .._utils.grpc_utils import retry_transient_errors  # noqa: E402
from ..client import _Client  # noqa: E402
from ..config import config, logger, tune_switch_interval  # noqa: E402
from ..exception import ExecutionError  # noqa: E402
from ..proto import api_pb2  # noqa: E402
from ..serialization import deserialize  # noqa: E402
from ..server.warm_pool import POOL_BUILD_ENV, SPAWN_ENV_DROP  # noqa: E402
from . import execution_context  # noqa: E402
from .io_manager import ContainerIOManager, IOContext  # noqa: E402
from .user_code import Service, import_class_service, import_single_function_service  # noqa: E402

# True while this process serves a placement it took as a warm-pool
# interpreter (stamped on its ContainerHello)
_WARM_POOL_SERVE = False


def load_container_arguments() -> api_pb2.ContainerArguments:
    path = os.environ.get("MODAL_TPU_CONTAINER_ARGS_PATH")
    if not path:
        raise ExecutionError("MODAL_TPU_CONTAINER_ARGS_PATH not set — not a container environment")
    with open(path, "rb") as f:
        return api_pb2.ContainerArguments.FromString(f.read())


async def _run_to_end(fut: "asyncio.Future") -> bool:
    """Await `fut` to its end through cancels of the awaiting task; True if
    one came (the caller re-raises it once the work is done)."""
    cancelled = False
    while not fut.done():
        try:
            await asyncio.shield(fut)
        except asyncio.CancelledError:
            cancelled = True
    fut.result()
    return cancelled


def is_gang_member(container_args: api_pb2.ContainerArguments) -> bool:
    return container_args.function_def.group_size > 1 or container_args.world_size > 1


async def run_lifecycle_hooks(hooks: list, name: str) -> None:
    for hook in hooks:
        logger.debug(f"running {name} hook {getattr(hook, '__name__', hook)}")
        if inspect.iscoroutinefunction(hook):
            await hook()
            continue
        # sync hooks run off the loop, like function bodies, so the heartbeat
        # keeps beating through a long weight load
        res = await asyncio.to_thread(hook)
        if inspect.isawaitable(res):
            await res


# set by main_async for a runtime_debug function: each input runs under
# torch.profiler and its Chrome trace lands here; PROFILE_CUDA adds the CUDA
# activity (the function asked for a card; never decided by asking the
# driver, ROADMAP Queue C 28)
PROFILE_DIR: Optional[str] = None
PROFILE_CUDA = False
# torch.profiler is not reentrant: concurrent inputs take turns at the one
# trace, and an input that finds it taken runs unprofiled
_profile_lock = threading.Lock()
_profile_seq = 0


@contextlib.contextmanager
def _maybe_profile():
    """Profile the enclosed input with torch.profiler when PROFILE_DIR is
    set. The trace names `<pid>-<n>.pt.trace.json`. A card's profile needs
    CUPTI: when torch cannot trace CUDA, this raises, and never falls back
    to a CPU-only trace."""
    global _profile_seq
    if PROFILE_DIR is None or not _profile_lock.acquire(blocking=False):
        yield
        return
    try:
        import torch.profiler as tprof

        activities = [tprof.ProfilerActivity.CPU]
        if PROFILE_CUDA:
            if tprof.ProfilerActivity.CUDA not in tprof.supported_activities():
                raise ExecutionError("runtime_debug: torch.profiler cannot trace CUDA here (no CUPTI)")
            activities.append(tprof.ProfilerActivity.CUDA)
        with tprof.profile(activities=activities) as prof:
            yield
        _profile_seq += 1
        os.makedirs(PROFILE_DIR, exist_ok=True)
        prof.export_chrome_trace(os.path.join(PROFILE_DIR, f"{os.getpid()}-{_profile_seq}.pt.trace.json"))
    finally:
        _profile_lock.release()


def _profiled(callable_: Any) -> Any:
    """`callable_` entering `_maybe_profile` on the thread that runs it:
    torch.profiler records the CPU ops of the thread that started it."""
    if PROFILE_DIR is None:
        return callable_

    def run(*args: Any, **kwargs: Any) -> Any:
        with _maybe_profile():
            return callable_(*args, **kwargs)

    return run


async def _call_sync(callable_: Any, args: tuple, kwargs: dict, ctx: IOContext, io: ContainerIOManager) -> Any:
    """Run a sync user callable, cancellable by signal when possible: on the
    main-thread executor (SIGUSR1 → InputCancellation interrupts it even in
    a blocking C call) when it is idle, else in a thread (cancellable only
    at the await, as the reference's extra-thread inputs are)."""
    from .main_thread_exec import get_executor

    executor = get_executor()
    if executor is not None and executor.idle():
        job = executor.submit(callable_, *args, **kwargs)
        for iid in ctx.input_ids:
            io._mt_jobs[iid] = job
        try:
            return await asyncio.wrap_future(job.future)
        finally:
            for iid in ctx.input_ids:
                io._mt_jobs.pop(iid, None)
    return await asyncio.to_thread(callable_, *args, **kwargs)


async def call_user_code(service: Service, ctx: IOContext, io: ContainerIOManager) -> list[api_pb2.GenericResult]:
    """Run one IOContext (single input or batch) to results."""
    callable_ = service.get_callable(ctx.method_name)
    args, kwargs = ctx.batched_args_kwargs()
    t0 = time.monotonic()
    try:
        if service.is_gen(ctx.method_name):
            # stream items to the data channel; the unary output records DONE
            count = 0
            gen = callable_(*args, **kwargs)
            if hasattr(gen, "__aiter__"):
                async for item in gen:
                    await io.push_generator_data(ctx.function_call_ids[0], item)
                    count += 1
            else:
                for item in gen:
                    await io.push_generator_data(ctx.function_call_ids[0], item)
                    count += 1
                    await asyncio.sleep(0)
            await io.push_generator_done(ctx.function_call_ids[0], count)
            done = api_pb2.GeneratorDone(items_total=count)
            return [
                api_pb2.GenericResult(
                    status=api_pb2.GENERIC_STATUS_SUCCESS,
                    data=done.SerializeToString(),
                    data_format=api_pb2.DATA_FORMAT_GENERATOR_DONE,
                )
            ]
        if inspect.iscoroutinefunction(callable_):
            with _maybe_profile():
                value = await callable_(*args, **kwargs)
        else:
            value = await _call_sync(_profiled(callable_), args, kwargs, ctx, io)
        io.note_call_time(time.monotonic() - t0)
        fmt = ctx.data_format or api_pb2.DATA_FORMAT_PICKLE
        if ctx.is_batch:
            if not isinstance(value, (list, tuple)) or len(value) != len(ctx.input_ids):
                raise ExecutionError(
                    f"@batched function must return a list with one item per input "
                    f"({len(ctx.input_ids)} inputs, got {type(value).__name__})"
                )
            return [await io.format_result(v, fmt) for v in value]
        return [await io.format_result(value, fmt)]
    except BaseException as exc:  # noqa: BLE001 — every failure becomes a result
        if isinstance(exc, (KeyboardInterrupt, SystemExit)):
            raise
        logger.debug(f"user code raised: {type(exc).__name__}: {exc}")
        err = io.format_exception(exc)
        return [err for _ in ctx.input_ids]


async def run_input_loop(service: Service, io: ContainerIOManager) -> None:
    """Concurrent input execution under slots (reference
    run_inputs_outputs, container_io_manager.py:845), with TaskGroup
    semantics: the first failed input task aborts the loop, and every
    in-flight input finishes (or reports TERMINATED) before exit."""
    running: set[asyncio.Task] = set()
    first_exc: list[BaseException] = []
    child_failed = asyncio.Event()

    def _on_done(t: asyncio.Task) -> None:
        running.discard(t)
        if not t.cancelled() and t.exception() is not None:
            if not first_exc:
                first_exc.append(t.exception())
            child_failed.set()

    async def _terminated(ctx: IOContext, why: str) -> None:
        results = [api_pb2.GenericResult(status=api_pb2.GENERIC_STATUS_TERMINATED, exception=why) for _ in ctx.input_ids]
        try:
            await asyncio.shield(io.push_outputs(ctx, results))
        except Exception:  # noqa: BLE001 — the container is going down anyway
            traceback.print_exc()

    async def _run_one(ctx: IOContext) -> None:
        reset = execution_context._set_current_context_ids(ctx.input_ids[0], ctx.function_call_ids[0])
        try:
            task = asyncio.current_task()
            for iid in ctx.input_ids:
                io._running_tasks[iid] = task
            # user-execution span under the input's delivered trace (else
            # the boot's); cold_call marks the container's first input
            cold_call = not io._executed_an_input
            io._executed_an_input = True
            parent = tracing.parse_context(io.input_trace_contexts.get(ctx.input_ids[0], "")) or tracing.context_from_env()
            if ctx.fetched_at and parent is not None:
                tracing.record_span(
                    "container.input_deliver",
                    start=ctx.fetched_at,
                    end=time.time(),
                    parent=parent,
                    attrs={"input_id": ctx.input_ids[0], "task_id": io.task_id},
                )
            with tracing.span(
                "user.execute",
                parent=parent,
                attrs={"input_id": ctx.input_ids[0], "function_call_id": ctx.function_call_ids[0],
                       "task_id": io.task_id, "batch_size": len(ctx.input_ids), "cold_call": cold_call},
            ):
                results = await call_user_code(service, ctx, io)
                await io.push_outputs(ctx, results)
        except asyncio.CancelledError:
            await _terminated(ctx, "input cancelled")
        finally:
            for iid in ctx.input_ids:
                io._running_tasks.pop(iid, None)
            reset()

    try:
        # the fetch races against child failure: a failed input aborts the
        # loop at once, not after the next input arrives
        gen = io.generate_inputs().__aiter__()
        while True:
            fetch = asyncio.ensure_future(gen.__anext__())
            failed = asyncio.ensure_future(child_failed.wait())
            try:
                await asyncio.wait({fetch, failed}, return_when=asyncio.FIRST_COMPLETED)
            except BaseException:
                fetch.cancel()
                failed.cancel()
                await asyncio.gather(fetch, failed, return_exceptions=True)
                raise
            failed.cancel()
            if first_exc:
                fetch.cancel()
                fetched = (await asyncio.gather(fetch, return_exceptions=True))[0]
                if isinstance(fetched, IOContext):
                    # claimed in the same wakeup: report it, do not drop it
                    await _terminated(fetched, "input loop aborted")
                raise first_exc[0]
            try:
                ctx = fetch.result()
            except StopAsyncIteration:
                break
            t = asyncio.create_task(_run_one(ctx))
            running.add(t)
            t.add_done_callback(_on_done)
        if running:
            await asyncio.gather(*running, return_exceptions=True)
        # outputs stashed for an exchange poll that will never come
        await io.flush_pending_exchange()
        if first_exc:
            raise first_exc[0]
    except BaseException:
        for t in running:
            t.cancel()
        if running:
            await asyncio.shield(asyncio.gather(*running, return_exceptions=True))
        raise


def _import_module(name: str) -> str:
    importlib.import_module(name)
    return threading.current_thread().name


async def _import_on_main_thread(name: str) -> str:
    """Import `name` on the main-thread executor (idle while the container
    boots); returns the name of the thread that imported it."""
    from .main_thread_exec import get_executor

    return await asyncio.wrap_future(get_executor().submit(_import_module, name).future)


async def _boot_service(
    container_args: api_pb2.ContainerArguments, client: _Client, boot_span: tracing.Span
) -> Service:
    """Import the user's code and bring its state up, in the JAX
    entrypoint's order (modal_tpu/runtime/container_entrypoint.py:480-570)."""
    from ..observability import device_telemetry

    function_def = container_args.function_def
    task_id = container_args.task_id
    if function_def.resources.gpu_config.gpu_type:
        # a function that asks for a card loads torch now, after the hello
        # and on the main thread: the AOT warm-up, the enter hooks and the
        # restore run in pool threads, where the import took ~1.4 s longer
        # on an H100 host (tools/import_cost.py)
        t_torch = time.time()
        thread = await _import_on_main_thread("torch")
        tracing.record_span("container.import_torch", start=t_torch, end=time.time(), parent=boot_span.context,
                            attrs={"task_id": task_id, "thread": thread})
    if is_gang_member(container_args):
        # the rendezvous and the process group before the user's code
        # (reference hook point: _container_entrypoint.py:451-457)
        from .clustered import init_cluster

        t_gang = time.time()
        info = await init_cluster(container_args, client)
        tracing.record_span("container.cluster_init", start=t_gang, end=time.time(), parent=boot_span.context,
                            attrs={"task_id": task_id, "rank": info.rank, "world_size": info.world_size,
                                   "backend": info.backend})
    bound_params = None
    if os.environ.get("MODAL_TPU_BOUND_PARAMS"):
        bound_params = deserialize(bytes.fromhex(os.environ["MODAL_TPU_BOUND_PARAMS"]), client)
    t_imports = time.time()
    if function_def.is_class:
        service = import_class_service(function_def, client, bound_params)
    else:
        service = import_single_function_service(function_def, client)
    tracing.record_span("container.imports", start=t_imports, end=time.time(), parent=boot_span.context,
                        attrs={"task_id": task_id, "import_trace": bool(os.environ.get("MODAL_TPU_TELEMETRY_PATH"))})
    # compile telemetry and the fleet compile cache under the kernel builds,
    # before any enter hook or first input builds a kernel
    device_telemetry.install_compile_hooks()
    device_telemetry.maybe_install_fleet_cache()

    # enter hooks: with memory snapshots on, a later boot skips the
    # snap-enter hooks and streams the saved state to the card
    t_enter = time.time()
    restored = False
    if function_def.enable_memory_snapshot and service.enter_pre_snapshot:
        from .snapshot import restore_snapshot

        # off the loop: a multi-GB restore must not starve the heartbeat
        restored = await asyncio.to_thread(restore_snapshot, function_def, service.user_instance)
    if not restored:
        await run_lifecycle_hooks(service.enter_pre_snapshot, "enter(snap=True)")
    if function_def.enable_memory_snapshot:
        if not restored:
            from .snapshot import save_snapshot

            await asyncio.to_thread(save_snapshot, function_def, service.user_instance)
        await retry_transient_errors(
            client.stub.ContainerCheckpoint,
            api_pb2.ContainerCheckpointRequest(task_id=task_id, checkpoint_id=""),
            max_retries=2,
        )
    tracing.record_span("container.snapshot_state", start=t_enter, end=time.time(), parent=boot_span.context,
                        attrs={"task_id": task_id, "restored": restored,
                               "snapshot": bool(function_def.enable_memory_snapshot)})
    t_enter = time.time()
    await run_lifecycle_hooks(service.enter_post_snapshot, "enter")
    tracing.record_span("container.enter_hooks", start=t_enter, end=time.time(), parent=boot_span.context,
                        attrs={"task_id": task_id})
    # AOT warm-up (runtime/aot.py): with MODAL_TPU_AOT_LOWER set, build the
    # named entry points' kernels now, off the loop, so the first input
    # builds nothing
    if os.environ.get("MODAL_TPU_AOT_LOWER"):
        from .aot import maybe_aot_lower

        t_aot = time.time()
        report = await asyncio.to_thread(maybe_aot_lower)
        if report is not None:
            tracing.record_span("container.aot_lower", start=t_aot, end=time.time(), parent=boot_span.context,
                                attrs={"task_id": task_id, "errors": report.get("errors", {}),
                                       "sources": {k: v.get("sources", {}) for k, v in report.items()
                                                   if k != "errors"}})
    return service


async def run_web_endpoint(
    service: Service, io: ContainerIOManager, client: _Client, container_args: api_pb2.ContainerArguments
) -> None:
    """Serve the function as HTTP instead of polling the input queue
    (reference run_server/asgi flow, _container_entrypoint.py:394 and
    _runtime/asgi.py): build the ASGI app, bind a local port, register the
    URL with the control plane, serve until drained."""
    from .asgi import AsgiHttpServer, function_to_asgi, proxy_to_port, wait_for_port, wsgi_to_asgi

    function_def = container_args.function_def
    webhook_type = function_def.webhook_type
    # a class names its web method (cls.py from_local); a plain function
    # serves its single callable
    callable_ = service.get_callable(function_def.experimental_options.get("web_method_name", ""))
    if webhook_type == api_pb2.WEB_ENDPOINT_TYPE_ASGI_APP:
        asgi = callable_()  # the user's factory returns the ASGI app
    elif webhook_type == api_pb2.WEB_ENDPOINT_TYPE_WSGI_APP:
        asgi = wsgi_to_asgi(callable_())
    elif webhook_type == api_pb2.WEB_ENDPOINT_TYPE_FUNCTION:
        asgi = function_to_asgi(callable_, method=function_def.experimental_options.get("web_method", "POST"))
    elif webhook_type == api_pb2.WEB_ENDPOINT_TYPE_WEB_SERVER:
        # @web_server: the user's function STARTS a server on the declared
        # port (a thread or a subprocess) and returns; wait for the port,
        # then reverse-proxy the URL to it
        port = int(function_def.experimental_options.get("web_server_port", "0"))
        startup_timeout = float(function_def.experimental_options.get("web_server_startup_timeout", "60"))
        if not port:
            raise ExecutionError("@web_server function def carries no port")
        if inspect.iscoroutinefunction(callable_):
            await callable_()
        else:
            await asyncio.to_thread(callable_)
        await wait_for_port(port, startup_timeout)
        asgi = proxy_to_port(port)
    else:
        raise ExecutionError(f"unsupported webhook type {webhook_type}")

    server = AsgiHttpServer(asgi)
    await server.start()
    try:
        await retry_transient_errors(
            client.stub.FunctionSetWebUrl,
            api_pb2.FunctionSetWebUrlRequest(
                function_id=container_args.function_id, task_id=container_args.task_id, web_url=server.url
            ),
            max_retries=3,
        )
        logger.debug(f"web endpoint registered: {server.url}")
        while not io.terminate:
            await asyncio.sleep(0.3)
    finally:
        await server.stop()


async def main_async() -> int:
    container_args = load_container_arguments()
    task_id = container_args.task_id
    function_def = container_args.function_def
    config.override_locally("task_id", task_id)
    execution_context._set_container_process()
    # every input bounces between the serving loop and the main-thread executor
    tune_switch_interval()

    client = _Client(container_args.server_url or config["server_url"], api_pb2.CLIENT_TYPE_CONTAINER)
    await client._open()
    _Client.set_env_client(client)
    await retry_transient_errors(
        client.stub.ContainerHello, api_pb2.ContainerHelloRequest(task_id=task_id, warm_pool_hit=_WARM_POOL_SERVE),
        max_retries=5,
    )
    if function_def.experimental_options.get("runtime_debug"):
        global PROFILE_DIR, PROFILE_CUDA
        PROFILE_DIR = os.path.join(os.environ.get("MODAL_TPU_TASK_DIR", "") or ".", "profile")
        PROFILE_CUDA = bool(function_def.resources.gpu_config.gpu_type)
        os.makedirs(PROFILE_DIR, exist_ok=True)
    io = ContainerIOManager(client, task_id, function_def)
    io._function_id = container_args.function_id
    heartbeat_task = asyncio.create_task(io.heartbeat_loop(), name="heartbeat")
    # the sampling profiler: the env switch starts it at boot, the heartbeat
    # applies the plane's start and stop commands
    from ..observability import profiler as obs_profiler

    obs_profiler.maybe_start_from_env(os.environ.get(obs_profiler.PROFILE_DIR_ENV, ""), tag=task_id)

    # the boot span starts at the worker's spawn decision (MODAL_TPU_TRACE_T0)
    # and ends when the container is ready for inputs
    boot_start = float(os.environ.get(tracing.TRACE_T0_ENV, "0") or 0) or None
    boot_span = tracing.open_span(
        "container.boot",
        parent=tracing.context_from_env(),
        start=boot_start,
        attrs={"task_id": task_id, "function_id": container_args.function_id},
    )
    exit_status = api_pb2.GENERIC_STATUS_SUCCESS
    exit_exception = ""
    service: Optional[Service] = None
    bucket_states: list = []
    try:
        if function_def.cloud_bucket_mounts:
            # synced before the user's code, which may load weights from them
            from .bucket_mounts import sync_bucket_mounts

            bucket_states = await sync_bucket_mounts(dict(function_def.cloud_bucket_mounts))
        service = await _boot_service(container_args, client, boot_span)
        tracing.close_span(boot_span)
        if function_def.webhook_type != api_pb2.WEB_ENDPOINT_TYPE_UNSPECIFIED:
            await run_web_endpoint(service, io, client, container_args)
        else:
            await run_input_loop(service, io)
    except BaseException as exc:
        if not boot_span.end:
            tracing.close_span(boot_span, status="error")
        if isinstance(exc, (KeyboardInterrupt, asyncio.CancelledError)):
            # SIGTERM from the worker (app stop or drain): graceful shutdown,
            # so the exit hooks and TaskResult still run
            exit_status = api_pb2.GENERIC_STATUS_TERMINATED
            exit_exception = "terminated"
        else:
            exit_status = api_pb2.GENERIC_STATUS_FAILURE
            exit_exception = f"{type(exc).__name__}: {exc}"
            traceback.print_exc()
    finally:
        io.terminate = True

        async def _exit_work() -> None:
            if service is not None:
                try:
                    await run_lifecycle_hooks(service.exit_hooks, "exit")
                except Exception:  # noqa: BLE001 — the result must still be reported
                    traceback.print_exc()
            if bucket_states:
                # blocking on purpose: awaits in a cancelled task's finally were
                # seen hanging until the worker's SIGKILL
                from .bucket_mounts import writeback_bucket_mounts_sync

                try:
                    writeback_bucket_mounts_sync(bucket_states)
                except Exception:  # noqa: BLE001
                    traceback.print_exc()
            # each mounted volume is committed at exit (reference
            # task_lifecycle_manager.py:117)
            for volume_id in function_def.volume_mounts.values():
                try:
                    await retry_transient_errors(
                        client.stub.VolumeCommit, api_pb2.VolumeCommitRequest(volume_id=volume_id), max_retries=1
                    )
                except Exception:  # noqa: BLE001 — the result must still be reported
                    traceback.print_exc()
            if is_gang_member(container_args):
                from .clustered import shutdown_cluster

                shutdown_cluster()
            # which rung of the local fast path each of this container's RPCs
            # took (calls by "<method>:<rung>"), under the boot's trace; written
            # before TaskResult, which the worker's stop waits for
            rungs = getattr(client.stub, "rungs", None)
            tracing.record_span("container.fastpath", start=time.time(), end=time.time(), parent=boot_span.context,
                                attrs={"task_id": task_id, "rungs": dict(rungs or {}),
                                       "uds": getattr(client.stub, "uds_path", "")})
            try:
                await retry_transient_errors(
                    client.stub.TaskResult,
                    api_pb2.TaskResultRequest(
                        task_id=task_id, result=api_pb2.GenericResult(status=exit_status, exception=exit_exception)
                    ),
                    max_retries=2,
                )
            except Exception:  # noqa: BLE001 — the worker's exit-code report is the backstop
                traceback.print_exc()
            heartbeat_task.cancel()
            try:
                await heartbeat_task
            except asyncio.CancelledError:
                pass
            await client._close()

        # an app stop reaches the container twice, as the kill switch (the
        # input loop returns and this block starts) and as the worker's
        # SIGTERM, which cancels this task: the exit work runs to its end
        # through that cancel (a cancelled `to_thread` exit hook that had not
        # started would never run, and TaskResult would be skipped); the
        # worker's SIGKILL escalation still bounds it
        if await _run_to_end(asyncio.ensure_future(_exit_work())):
            raise asyncio.CancelledError
    # a graceful drain (TERMINATED) is an expected shutdown: exit 0
    return 0 if exit_status in (api_pb2.GENERIC_STATUS_SUCCESS, api_pb2.GENERIC_STATUS_TERMINATED) else 1


def check_thread_leaks() -> list:
    """Log user threads still alive at container exit: a leaked non-daemon
    thread blocks process exit until the worker kills it. Returns them."""
    import threading

    leaked = [
        t
        for t in threading.enumerate()
        if t is not threading.main_thread() and t.is_alive() and not t.daemon
    ]
    for t in leaked:
        logger.warning(
            f"user code leaked non-daemon thread {t.name!r} still running at container exit — "
            "it will block process shutdown until the worker kills it"
        )
    return leaked


def _install_preempt_handler(loop, handle_term) -> None:
    """SIGUSR2 = preemption notice (worker `_signal_preempt`): flush every
    in-flight input's resume token to the control plane (bounded: the grace
    window is ticking), then take the graceful-termination path."""
    import signal

    async def _preempt_flush() -> None:
        io = ContainerIOManager.singleton()
        if io is not None:
            try:
                await asyncio.wait_for(io.flush_resume_tokens(), timeout=8.0)
            except Exception:  # noqa: BLE001 — terminate regardless
                traceback.print_exc()
        handle_term(signal.SIGUSR2, None)

    def _handle_preempt(signum, frame):
        logger.warning("preemption notice received; flushing checkpoints")
        loop.call_soon_threadsafe(lambda: asyncio.ensure_future(_preempt_flush()))

    signal.signal(signal.SIGUSR2, _handle_preempt)


# ---------------------------------------------------------------------------
# Warm-pool mode (server/warm_pool.py): this process was pre-forked by the
# worker to park with its imports done, then serve placements by handoff
# over the task router, with no re-exec between them.
# ---------------------------------------------------------------------------

# what parking removes from the environment: per-task state, a process
# group's rendezvous, and what the worker's pool never spawns an interpreter
# with (the card pinning, the kernels' build dir and fleet-cache coordinates:
# each comes with the adoption's env delta)
_CLUSTER_ENV_SCRUB = (
    "MODAL_TPU_BOUND_PARAMS",
    "MODAL_TPU_TASK_ID",
    "MODAL_TPU_TASK_DIR",
    "MODAL_TPU_CONTAINER_ARGS_PATH",
    "MODAL_TPU_TELEMETRY_PATH",
    "MASTER_ADDR",
    "MASTER_PORT",
    "RANK",
    "LOCAL_RANK",
    "WORLD_SIZE",
) + SPAWN_ENV_DROP


def libcuda_mapped() -> bool:
    """Is the CUDA driver library loaded in this process? Its `cuInit`
    reads `CUDA_VISIBLE_DEVICES` once for the process's life."""
    try:
        with open("/proc/self/maps") as f:
            return "libcuda.so" in f.read()
    except OSError:
        return False


def cuda_touched(driver_at_park: bool) -> bool:
    """Did the placement that just ended initialize CUDA here: torch's
    context, or the driver loaded since the interpreter parked?"""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        return True
    return libcuda_mapped() and not driver_at_park


def park_state() -> dict:
    """What a parked interpreter holds that a placement could inherit: a
    CUDA context, the driver, and the pinning variables."""
    torch = sys.modules.get("torch")
    return {
        "pid": os.getpid(),
        "torch_imported": torch is not None,
        "cuda_initialized": bool(torch is not None and torch.cuda.is_initialized()),
        "libcuda_mapped": libcuda_mapped(),
        "python": sys.executable,
        "pinning_env": sorted(k for k in ("CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER") if k in os.environ),
    }


def _pool_span(name: str, start: float, attrs: dict) -> None:
    """A root span of the warm pool's own (no placement's trace holds it)."""
    tracing.close_span(tracing.open_span(name, start=start, attrs=attrs))


def _pool_preimport() -> None:
    """Pay the import bill while parked, on the main thread (ROADMAP Queue C
    24): torch (or what `MODAL_TPU_WARM_POOL_PREIMPORT` names) is imported
    and nothing initializes CUDA, so the pinning set at adoption applies.
    `MODAL_TPU_WARM_POOL_PREINIT=1` also primes torch's CPU side while
    parked (its op dispatch, allocator and math libraries), as JAX's pre-init
    is for the CPU simulation only: a CUDA context made while parked would
    fix the cards this interpreter sees before adoption pins them."""
    for key in _CLUSTER_ENV_SCRUB:
        os.environ.pop(key, None)
    for mod in filter(None, (m.strip() for m in str(config["warm_pool_preimport"]).split(","))):
        t0 = time.time()
        try:
            importlib.import_module(mod)
            _pool_span("coldstart.preimport", t0, {"module": mod, "thread": threading.current_thread().name})
        except Exception as exc:  # noqa: BLE001 — a missing module must not kill the pool
            logger.warning(f"warm pool pre-import of {mod!r} failed: {exc}")
    if config["warm_pool_preinit"]:
        t0 = time.time()
        try:
            import torch

            x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
            _pool_span("coldstart.preinit", t0, {"device": "cpu", "checksum": float((x @ x).sum())})
        except Exception as exc:  # noqa: BLE001
            logger.warning(f"warm pool pre-init failed: {exc}")
    _park_aot_warmup()


def _park_aot_warmup() -> None:
    """The park-time kernel warm-up (the JAX pool's park-time AOT lowering):
    with `MODAL_TPU_AOT_LOWER` set, build the entries' kernel libraries, or
    fetch them from the fleet store, while parked, so a placement's own
    warm-up finds them in its build directory (an image's) or in the fleet
    store (the pool's), then load them into this process. The build dir and
    fleet coordinates of `POOL_BUILD_ENV` apply only while it runs. A
    library's load initializes no CUDA context and makes no compute app
    (`tests/test_torch_warm_pool.py::test_loading_a_kernel_library_makes_no_cuda_context`,
    on the card), so the placement's pinning still takes effect (ROADMAP
    Queue C 28). A library that does not load is left to the placement,
    which raises on it."""
    if not os.environ.get("MODAL_TPU_AOT_LOWER"):
        return
    import json

    from .aot import maybe_aot_lower

    build_env = json.loads(os.environ.get(POOL_BUILD_ENV) or "{}")
    saved = {k: os.environ.get(k) for k in build_env}
    os.environ.update(build_env)
    t0 = time.time()
    loaded: list = []
    load_errors: dict = {}
    try:
        report = maybe_aot_lower()
        if report is not None:
            from ..ops import _build

            for name in sorted({k for v in report.values() for k in v.get("sources", {})}):
                try:
                    _build.load(name)
                    loaded.append(name)
                except Exception as exc:  # noqa: BLE001 — the placement loads it, and raises
                    load_errors[name] = str(exc)[:300]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if report is not None:
        _pool_span("coldstart.aot_lower", t0, {
            "build_dir": build_env.get("TORCH_EXTENSIONS_DIR", ""), "errors": report.get("errors", {}),
            "sources": {k: v.get("sources", {}) for k, v in report.items() if k != "errors"}, "loaded": loaded,
            "load_errors": load_errors, **park_state(),
        })


def _reset_process_state(base_env: dict, base_cwd: str, added_paths: list) -> None:
    """The restore contract between placements: env and cwd go back to the
    park-time snapshot, the SDK singletons are cleared, and the synchronizer
    loop and the imported library modules (torch) carry over. User modules
    loaded from the placement's own sys.path entries (globals_path, its
    PYTHONPATH delta) are purged with those entries: app B's `import utils`
    must never resolve to app A's module."""
    os.environ.clear()
    os.environ.update(base_env)
    try:
        os.chdir(base_cwd)
    except OSError:
        pass
    if added_paths:
        roots = tuple(os.path.abspath(p) + os.sep for p in added_paths)
        for name, mod in list(sys.modules.items()):
            mod_file = getattr(mod, "__file__", None) or ""
            if mod_file and os.path.abspath(mod_file).startswith(roots):
                del sys.modules[name]
        for p in added_paths:
            try:
                sys.path.remove(p)
            except ValueError:
                pass
    global PROFILE_DIR, PROFILE_CUDA
    _Client.set_env_client(None)
    ContainerIOManager._singleton = None
    PROFILE_DIR, PROFILE_CUDA = None, False
    build = sys.modules.get("modal_tpu_torch.ops._build")
    if build is not None:
        build.reset_launches()  # a heartbeat reports this placement's launches only


async def _pool_runner(state: dict) -> int:
    """Park → await a handoff → serve → re-park, on the synchronizer loop."""
    import json

    from .._utils.grpc_utils import AioRpcError, create_channel
    from ..proto.rpc import TaskRouterStub

    global _WARM_POOL_SERVE
    pool_id = os.environ["MODAL_TPU_POOL_ID"]
    token = os.environ.get("MODAL_TPU_POOL_TOKEN", "")
    channel = create_channel(f"grpc://{os.environ['MODAL_TPU_POOL_ROUTER']}")
    stub = TaskRouterStub(channel)
    base_env = dict(os.environ)
    base_cwd = os.getcwd()
    driver_at_park = libcuda_mapped()
    generation = 0
    rc = 0
    try:
        while not state["evict"]:
            _pool_span("coldstart.park", time.time(), {"pool_id": pool_id, "generation": generation, **park_state()})
            poll = asyncio.ensure_future(stub.PoolAwaitArguments(api_pb2.PoolAwaitRequest(
                pool_id=pool_id, token=token, generation=generation, pid=os.getpid(), timeout=50.0)))
            state["poll"] = poll
            try:
                resp = await poll
            except asyncio.CancelledError:
                break  # SIGTERM while parked
            except AioRpcError as exc:
                # the worker owns this process: a router that stopped
                # answering means the worker is gone; exit, do not spin
                logger.warning(f"warm pool poll failed ({exc.code()}); exiting")
                break
            finally:
                state["poll"] = None
            if resp.evict:
                logger.debug("warm pool interpreter evicted")
                break
            if not resp.has_task:
                continue  # the poll window lapsed; park again
            # adopt: apply the env delta in process, ack, serve
            for key in resp.env_unset:
                os.environ.pop(key, None)
            env_set = json.loads(resp.env_set_json or "{}")
            cwd = env_set.pop("MODAL_TPU_POOL_CWD", "")
            os.environ.update(env_set)
            os.environ["MODAL_TPU_CONTAINER_ARGS_PATH"] = resp.args_path
            if os.environ.get("MODAL_TPU_TELEMETRY_PATH"):
                # the placement's imports go to its own task's trace
                from .telemetry import retarget_imports

                retarget_imports(os.environ["MODAL_TPU_TELEMETRY_PATH"])
            # a PYTHONPATH change does not reach sys.path: prepend the task's
            # entries, tracked so the re-park removes them and purges the
            # user modules they loaded
            added_paths = []
            for entry in reversed(os.environ.get("PYTHONPATH", "").split(os.pathsep)):
                if entry and entry not in sys.path:
                    sys.path.insert(0, entry)
                    added_paths.append(entry)
            if cwd:
                try:
                    os.chdir(cwd)
                except OSError as exc:
                    logger.warning(f"warm pool chdir({cwd!r}) failed: {exc}")
                else:
                    # a fresh spawn runs `python -m` in its cwd, which puts
                    # that dir first on sys.path: mirror it
                    if cwd not in sys.path:
                        sys.path.insert(0, cwd)
                        added_paths.append(cwd)
            try:
                await stub.PoolAdoptAck(api_pb2.PoolAdoptAckRequest(
                    pool_id=pool_id, token=token, handoff_id=resp.handoff_id, task_id=resp.task_id))
            except AioRpcError as exc:
                # the worker withdrew the handoff (or died): never run a task
                # the worker does not believe this process owns
                logger.warning(f"warm pool adopt-ack rejected ({exc.code()}); exiting")
                rc = 1
                break
            _WARM_POOL_SERVE = True
            task = asyncio.ensure_future(main_async())
            state["task"] = task
            try:
                rc = await task
            except asyncio.CancelledError:
                rc = 0  # graceful termination, already reported through TaskResult
            except BaseException:  # noqa: BLE001 — a crashed serve poisons the pool
                traceback.print_exc()
                rc = 1
            finally:
                state["task"] = None
                _WARM_POOL_SERVE = False
            generation += 1
            touched = cuda_touched(driver_at_park)
            _reset_process_state(base_env, base_cwd, added_paths)
            if rc != 0:
                break  # a crashed serve leaves suspect state: exit, the pool respawns fresh
            if touched:
                # a CUDA context, its pinned card and cached blocks stay with
                # the process: exit instead of re-parking (Queue C 28)
                logger.debug("warm pool interpreter initialized CUDA in its placement; exiting")
                _pool_span("coldstart.exit_after_cuda", time.time(),
                           {"pool_id": pool_id, "generation": generation, "pid": os.getpid()})
                break
    finally:
        try:
            await channel.close()
        except Exception:  # noqa: BLE001
            pass
    return rc


def pool_main() -> None:
    """Entry of a `MODAL_TPU_POOL_ID` process: main()'s signal semantics,
    but the body loops placements instead of exiting after one."""
    import signal

    from .._utils.async_utils import synchronizer
    from .main_thread_exec import MainThreadExecutor, set_executor

    _pool_preimport()
    loop = synchronizer._ensure_loop()
    state: dict = {"task": None, "poll": None, "evict": False}

    def _handle_term(signum, frame):
        state["evict"] = True
        task = state.get("task")
        poll = state.get("poll")
        if task is not None:
            loop.call_soon_threadsafe(task.cancel)
        elif poll is not None:
            loop.call_soon_threadsafe(poll.cancel)

    signal.signal(signal.SIGTERM, _handle_term)
    _install_preempt_handler(loop, _handle_term)
    executor = MainThreadExecutor()
    executor.install_signal_handler()
    set_executor(executor)
    cf = asyncio.run_coroutine_threadsafe(_pool_runner(state), loop)
    try:
        executor.run_until(cf)
    except KeyboardInterrupt:
        cf.cancel()
        raise
    finally:
        set_executor(None)
        check_thread_leaks()
    sys.exit(cf.result())


def main() -> None:
    """Run `main_async` on the synchronizer loop (the SDK's coroutines are
    pinned to it); the main thread hosts sync user code. SIGTERM cancels
    the main task instead of killing the process, so the exit hooks and
    TaskResult run before the worker's SIGKILL escalation."""
    import signal

    from .._utils.async_utils import synchronizer
    from .main_thread_exec import MainThreadExecutor, set_executor

    loop = synchronizer._ensure_loop()
    task_holder: dict = {}
    term_requested = {"flag": False}

    def _handle_term(signum, frame):
        term_requested["flag"] = True
        task = task_holder.get("task")
        if task is not None:
            loop.call_soon_threadsafe(task.cancel)

    signal.signal(signal.SIGTERM, _handle_term)
    _install_preempt_handler(loop, _handle_term)
    executor = MainThreadExecutor()
    executor.install_signal_handler()
    set_executor(executor)

    async def _runner() -> int:
        task = asyncio.ensure_future(main_async())
        task_holder["task"] = task
        if term_requested["flag"]:
            task.cancel()  # SIGTERM landed before the task was registered
        try:
            return await task
        except asyncio.CancelledError:
            return 0  # graceful termination, already reported via TaskResult

    cf = asyncio.run_coroutine_threadsafe(_runner(), loop)
    try:
        executor.run_until(cf)
    except KeyboardInterrupt:
        cf.cancel()
        raise
    finally:
        set_executor(None)
        check_thread_leaks()
    sys.exit(cf.result())


if __name__ == "__main__":
    if os.environ.get("MODAL_TPU_POOL_ID"):
        pool_main()
    else:
        main()
