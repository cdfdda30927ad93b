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

A definition that asks for what the port's runtime does not run yet is
refused before any user code runs, naming the ROADMAP Queue A sub-slice
that brings it: gangs, cloud bucket mounts and volumes (4d). The runtime
debug profile (4d) and the warm-pool parking (4e) wait too.
"""

from __future__ import annotations

import asyncio
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
from . import execution_context  # noqa: E402
from .io_manager import ContainerIOManager, IOContext  # noqa: E402
from .user_code import Service, import_class_service, import_single_function_service  # noqa: E402


def load_container_arguments() -> api_pb2.ContainerArguments:
    path = os.environ.get("MODAL_TPU_CONTAINER_ARGS_PATH")
    if not path:
        raise ExecutionError("MODAL_TPU_CONTAINER_ARGS_PATH not set — not a container environment")
    with open(path, "rb") as f:
        return api_pb2.ContainerArguments.FromString(f.read())


def waiting_branch(container_args: api_pb2.ContainerArguments) -> str:
    """What of this container's definition the port's runtime cannot run
    yet, naming the ROADMAP Queue A sub-slice that brings it; "" if none."""
    function_def = container_args.function_def
    if function_def.group_size > 1 or container_args.world_size > 1:
        return "a gang container (group_size > 1) waits for the port's gang runtime (ROADMAP Queue A 4d)"
    if function_def.cloud_bucket_mounts:
        return "cloud bucket mounts wait for the port's storage slice (ROADMAP Queue A 4d)"
    if function_def.volume_mounts:
        return "volume mounts wait for the port's Volumes (ROADMAP Queue A 4d)"
    if function_def.experimental_options.get("runtime_debug"):
        return "the runtime debug profile waits for the port's profiler (ROADMAP Queue A 4d)"
    return ""


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
            value = await callable_(*args, **kwargs)
        else:
            value = await _call_sync(callable_, args, kwargs, ctx, io)
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
    waiting = waiting_branch(container_args)
    if waiting:
        raise ExecutionError(waiting)
    if function_def.resources.gpu_config.gpu_type:
        # a function that asks for a card loads torch now, after the hello
        # and on the main thread: the AOT warm-up, the enter hooks and the
        # restore run in pool threads, where the import took ~1.4 s longer
        # on an H100 host (tools/import_cost.py)
        t_torch = time.time()
        thread = await _import_on_main_thread("torch")
        tracing.record_span("container.import_torch", start=t_torch, end=time.time(), parent=boot_span.context,
                            attrs={"task_id": task_id, "thread": thread})
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
                                attrs={"task_id": task_id, "errors": report.get("errors", {})})
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
        client.stub.ContainerHello, api_pb2.ContainerHelloRequest(task_id=task_id), max_retries=5
    )
    io = ContainerIOManager(client, task_id, function_def)
    io._function_id = container_args.function_id
    heartbeat_task = asyncio.create_task(io.heartbeat_loop(), name="heartbeat")

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
    try:
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
        if service is not None:
            try:
                await run_lifecycle_hooks(service.exit_hooks, "exit")
            except Exception:  # noqa: BLE001 — the result must still be reported
                traceback.print_exc()
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
    main()
