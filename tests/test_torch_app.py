"""The port's App layer against the JAX package's: the same user code runs
through `modal_tpu.App` and through `modal_tpu_torch.App`, and the results
are compared.

One control plane per package, created once for the module: a JAX
`LocalSupervisor` (CPU jax containers) and the port's
(`worker_gpus=8, worker_gpu_type="local-sim"`, containers of
`modal_tpu_torch.runtime.container_entrypoint`). Each scenario builds an
app of one package, runs it with `app.run(client=...)` against that
package's plane, and returns what it saw; the two packages' scenarios run
side by side on two threads (each SDK has its own synchronizer loop). User
functions and classes are defined inside the scenario, so each package's
cloudpickle takes them by value.

Counterparts of tests/test_e2e_function.py (remote, exceptions, spawn,
container reuse, generators) and tests/test_cls.py (enter state, exit hook,
parametrised bind, with_options).
"""

import asyncio
import concurrent.futures
import json
import os
import tempfile
import time

import pytest

import modal_tpu
import modal_tpu_torch
from modal_tpu._utils.async_utils import synchronizer as jsync
from modal_tpu.client import _Client as JaxClient
from modal_tpu.server.supervisor import LocalSupervisor as JaxSupervisor
from modal_tpu_torch._utils.async_utils import synchronizer as tsync
from modal_tpu_torch.client import _Client
from modal_tpu_torch.server.supervisor import LocalSupervisor

# the containers of both planes read these at spawn
CONTAINER_ENV = {"MODAL_TPU_HEARTBEAT_INTERVAL": "3"}


class Planes:
    def __init__(self, root: str):
        self.jsup = JaxSupervisor(num_workers=1, state_dir=os.path.join(root, "jax"), worker_chips=8,
                                  worker_tpu_type="local-sim")
        self.tsup = LocalSupervisor(num_workers=1, state_dir=os.path.join(root, "port"), worker_gpus=8,
                                    worker_gpu_type="local-sim")
        jsync.run(self.jsup.start())
        tsync.run(self.tsup.start())
        self.jclient = JaxClient(self.jsup.server_url)
        self.jclient._open()
        self.tclient = _Client(self.tsup.server_url)
        self.tclient._open()
        self.tclient.hello()
        # lazily hydrated handles (with_options, FunctionCall.from_id) take
        # each package's env client: its own plane
        JaxClient.set_env_client(self.jclient)
        _Client.set_env_client(self.tclient)
        self.root = root

    def of(self, m):
        """(client, supervisor) of package `m`."""
        return (self.jclient, self.jsup) if m is modal_tpu else (self.tclient, self.tsup)

    def both(self, scenario):
        """scenario(package, client, supervisor) for each package, side by
        side: {"jax": result, "port": result}."""
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            futs = {name: pool.submit(scenario, m, *self.of(m))
                    for name, m in (("jax", modal_tpu), ("port", modal_tpu_torch))}
            return {name: fut.result(timeout=180) for name, fut in futs.items()}

    def close(self):
        JaxClient.set_env_client(None)
        _Client.set_env_client(None)
        self.jclient._close()
        self.tclient._close()
        jsync.run(self.jsup.stop())
        tsync.run(self.tsup.stop())


@pytest.fixture(scope="module")
def planes():
    saved = {k: os.environ.get(k) for k in CONTAINER_ENV}
    os.environ.update(CONTAINER_ENV)
    p = Planes(tempfile.mkdtemp(prefix="app-", dir="/tmp"))
    try:
        yield p
    finally:
        p.close()
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)


def _wait_tasks_finished(sup, app_id: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while any(not t.finished_at for t in list(sup.state.tasks.values()) if t.app_id == app_id):
        assert time.monotonic() < deadline, f"the tasks of {app_id} did not finish in {timeout}s"
        time.sleep(0.1)


def test_remote_exception_spawn_and_container_reuse(planes):
    """remote, a remote exception's type, message and traceback, spawn/get,
    and sequential inputs served by one warm container."""

    def scenario(m, client, sup):
        app = m.App("e2e")

        def matmul(n):
            import os

            import numpy as np

            a = np.ones((n, n), dtype=np.float32)
            return float((a @ a).sum()), os.getpid()

        def boom(x):
            raise ValueError(f"bad {x}")

        f = app.function(serialized=True)(matmul)
        g = app.function(serialized=True)(boom)
        with app.run(client=client):
            v1, pid1 = f.remote(8)
            v2, pid2 = f.spawn(4).get()
            try:
                g.remote(7)
            except ValueError as exc:
                err = (type(exc).__name__, str(exc), exc.__cause__ is not None, "boom" in str(exc.__cause__))
        return {"values": [v1, v2], "same_pid": pid1 == pid2, "err": err}

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == {"values": [512.0, 64.0], "same_pid": True, "err": ("ValueError", "bad 7", True, True)}


def test_generators(planes):
    """A sync and an async generator stream their items in order; a
    generator that raises after two items delivers them, then the error;
    `.remote()` on a generator is refused."""

    def scenario(m, client, sup):
        app = m.App("gen")

        @app.function(serialized=True)
        def counter(n):
            for i in range(n):
                yield {"i": i, "sq": i * i}

        @app.function(serialized=True)
        async def aitems(n):
            import asyncio as _a

            for i in range(n):
                await _a.sleep(0.01)
                yield i * 10

        @app.function(serialized=True)
        def flaky(n):
            for i in range(n):
                if i == 2:
                    raise ValueError("boom at 2")
                yield i

        out = {}
        with app.run(client=client):
            out["sync"] = list(counter.remote_gen(6))
            out["again"] = [x["i"] for x in counter.remote_gen(3)]
            out["async"] = list(aitems.remote_gen(4))
            got = []
            try:
                for item in flaky.remote_gen(5):
                    got.append(item)
            except Exception as exc:  # noqa: BLE001 — the error is part of the result
                out["flaky"] = (got, type(exc).__name__, "boom at 2" in str(exc))
            try:
                counter.remote(1)
            except m.exception.InvalidError as exc:
                out["refused"] = "remote_gen" in str(exc)
        return out

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"]["sync"] == [{"i": i, "sq": i * i} for i in range(6)]
    assert got["port"]["flaky"] == ([0, 1], "ValueError", True) and got["port"]["refused"] is True


def test_cls_enter_state_methods_and_exit_hook(planes):
    """@enter state persists in the warm container, methods share it, a
    method maps over inputs in order, and @exit runs when the app stops.
    The JAX package's method `.map` raises TypeError (its `_BoundMethod.map`
    hands a Function to `synchronizer.run`), so its side computes the same
    values with `.remote` per input. The exit hook is held on the port's
    side only: JAX's (tests/test_cls.py::test_cls_exit_hook_runs) is a
    known flake."""

    def scenario(m, client, sup):
        app = m.App("cls")
        marker = os.path.join(planes.root, f"exit-{m.__name__}")

        @app.cls(serialized=True)
        class Model:
            @m.enter()
            def load(self):
                import os as _os

                self.weights = [1, 2, 3]
                self.pid = _os.getpid()

            @m.method()
            def predict(self, x):
                return sum(self.weights) * x, self.pid

            @m.method()
            def other(self, s):
                return f"other:{s}"

            @m.exit()
            def cleanup(self):
                with open(marker, "w") as fh:
                    fh.write("clean")

        with app.run(client=client):
            mdl = Model()
            y1, pid1 = mdl.predict.remote(10)
            y2, pid2 = mdl.predict.remote(1)
            other = mdl.other.remote("a")
            if m is modal_tpu_torch:
                mapped = [y for y, _pid in mdl.predict.map([1, 2, 3])]
            else:
                mapped = [mdl.predict.remote(x)[0] for x in (1, 2, 3)]
            app_id = app.app_id
        if m is modal_tpu_torch:
            _wait_tasks_finished(sup, app_id)
            with open(marker) as fh:
                assert fh.read() == "clean"
        return {"ys": [y1, y2], "same_pid": pid1 == pid2, "other": other, "mapped": mapped}

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == {"ys": [60, 6], "same_pid": True, "other": "other:a", "mapped": [6, 12, 18]}


def test_the_exit_work_runs_through_a_late_cancel():
    """ROADMAP Queue C 31: an app stop reaches a container as the kill switch
    (its input loop returns and the exit work starts) and as the worker's
    SIGTERM, whose cancel can land in that work. An exit hook run through
    `asyncio.to_thread` whose thread had not started yet is then dropped
    with its cancelled future, and TaskResult is skipped; the entrypoint
    runs its exit work to the end through the cancel (`_run_to_end`)."""
    import contextlib
    import threading

    from modal_tpu_torch.runtime.container_entrypoint import _run_to_end

    async def stop(carried: bool) -> bool:
        ran, gate = threading.Event(), threading.Event()
        executor = concurrent.futures.ThreadPoolExecutor(1)  # busy: the hook queues behind a job
        asyncio.get_running_loop().set_default_executor(executor)
        executor.submit(gate.wait, 10)

        async def exit_work():
            await asyncio.to_thread(ran.set)

        async def container():
            try:
                pass  # the input loop returned on the kill switch
            finally:
                if carried:
                    if await _run_to_end(asyncio.ensure_future(exit_work())):
                        raise asyncio.CancelledError
                else:
                    await exit_work()

        task = asyncio.ensure_future(container())
        await asyncio.sleep(0)  # the exit work starts; its hook waits for a thread
        task.cancel()  # the SIGTERM
        # one turn of the loop delivers the cancel to the hook's future while
        # the busy thread still holds the hook queued, then the thread frees
        await asyncio.sleep(0)
        gate.set()
        with contextlib.suppress(asyncio.CancelledError):
            await task
        executor.shutdown(wait=True)
        return ran.is_set()

    assert asyncio.run(stop(carried=False)) is False
    assert asyncio.run(stop(carried=True)) is True


def test_an_exiting_containers_last_report_reaches_the_plane(planes):
    """The port's container sends one last heartbeat after its exit hooks
    (io_manager.send_last_report), so the report the plane keeps for the
    task holds kernel launches counted after the last periodic beat. The
    heartbeat loop stops before the exit hooks run, so only that last beat
    can carry the launches the exit hook counts. The JAX package's
    containers send no last beat."""
    app = modal_tpu_torch.App("last-beat")

    @app.cls(serialized=True)
    class Counted:
        @modal_tpu_torch.method()
        def ping(self):
            return "pong"

        @modal_tpu_torch.exit()
        def launch(self):
            from modal_tpu_torch.ops import _build

            _build.LAUNCHES["flash_fwd"] += 7

    with app.run(client=planes.tclient):
        assert Counted().ping.remote() == "pong"
        app_id = app.app_id
    _wait_tasks_finished(planes.tsup, app_id)
    (task,) = [t for t in list(planes.tsup.state.tasks.values()) if t.app_id == app_id]
    report = json.loads(task.telemetry_prev_json)
    assert report["modal_tpu_kernel_launches"]["series"]["flash_fwd"] == 7


def test_cls_parametrized_bind_and_parameter_fields(planes):
    """Constructor params bind through FunctionBindParams: each
    parameterization gets its own warm container; `parameter()` fields
    synthesize the constructor on both sides."""

    def scenario(m, client, sup):
        app = m.App("bind")

        @app.cls(serialized=True)
        class Multiplier:
            def __init__(self, factor=1):
                self.factor = factor

            @m.method()
            def mul(self, x):
                import os as _os

                return self.factor * x, _os.getpid()

        @app.cls(serialized=True)
        class Named:
            name: str = m.parameter(default="tiny")
            size: int = m.parameter()

            @m.method()
            def describe(self):
                return f"{self.name}:{self.size}"

        with app.run(client=client):
            r2, pid2 = Multiplier(factor=2).mul.remote(10)
            r5, pid5 = Multiplier(5).mul.remote(10)
            m2 = Multiplier(factor=2)
            r2b, _ = m2.mul.remote(3)
            named = [Named(size=3).describe.remote(), Named(name="big", size=8).describe.remote()]
            try:
                Named(bogus=1)
                bad = None
            except (m.exception.InvalidError, TypeError) as exc:
                bad = type(exc).__name__
        return {"r": [r2, r5, r2b], "separate": pid2 != pid5, "named": named, "bad": bad}

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"]["r"] == [20, 50, 6] and got["port"]["separate"] is True
    assert got["port"]["named"] == ["tiny:3", "big:8"]


def test_with_options_on_functions_and_classes(planes):
    """with_options rebinds the autoscaler, timeout and retries of a
    function and of a class without redefining them; the variants exist on
    the plane, the base definitions are unchanged. The port's variant of a
    card function keeps its card ask."""

    def scenario(m, client, sup):
        app = m.App("opts")

        @app.cls(serialized=True)
        class Greeter:
            def __init__(self, name="x"):
                self.name = name

            @m.method()
            def hello(self):
                return f"hi {self.name}"

        def double(x):
            return x * 2

        f = app.function(serialized=True, timeout=300)(double)
        with app.run(client=client):
            variant = Greeter.with_options(max_containers=3, timeout=123, retries=2)
            out = [variant(name="opt").hello.remote(), Greeter(name="base").hello.remote()]
            out.append(f.with_options(timeout=77, max_containers=2).remote(21))
            bound = [fn.definition for fn in list(sup.state.functions.values())
                     if fn.bound_parent and fn.app_id == app.app_id]
        cls_variant = [d for d in bound if d.timeout_secs == 123]
        fn_variant = [d for d in bound if d.timeout_secs == 77]
        return {
            "out": out,
            "cls": [(d.autoscaler_settings.max_containers, d.retry_policy.retries) for d in cls_variant],
            "fn": [d.autoscaler_settings.max_containers for d in fn_variant],
        }

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == {"out": ["hi opt", "hi base", 42], "cls": [(3, 2)], "fn": [2]}

    def gpu_variant(m, client, sup):
        app = m.App("opts-gpu")

        @app.function(serialized=True, gpu="H100")
        def ident(x):
            return x

        with app.run(client=client):
            assert ident.with_options(gpu="H100:2", timeout=50).remote(5) == 5
            return [fn.definition.resources.gpu_config for fn in list(sup.state.functions.values())
                    if fn.bound_parent and fn.app_id == app.app_id]

    (cfg,) = gpu_variant(modal_tpu_torch, *planes.of(modal_tpu_torch))
    assert (cfg.gpu_type, cfg.count) == ("H100", 2)


def test_a_file_function_is_found_by_its_module_and_unwrapped(planes):
    """A non-serialized function of a user's file: the container imports the
    file's module (the file's own `App(...)` and decorators run there and
    contact nothing) and unwraps the Function handle to its function."""
    import importlib
    import sys

    def scenario(m, client, sup):
        d = tempfile.mkdtemp(prefix="userapp-", dir=planes.root)
        name = f"userapp_{m.__name__}"
        with open(os.path.join(d, f"{name}.py"), "w") as fh:
            fh.write(f"import os\nimport {m.__name__} as m\n\napp = m.App('file')\n\n\n"
                     "@app.function()\ndef where(x):\n    return x + 1, __name__\n")
        sys.path.insert(0, d)
        try:
            mod = importlib.import_module(name)
        finally:
            sys.path.remove(d)
        with mod.app.run(client=client):
            value, module = mod.where.remote(41)
            fdef = next(f.definition for f in list(sup.state.functions.values()) if f.app_id == mod.app.app_id)
        return {"value": value, "module_is_the_file": module == name, "definition_type": fdef.definition_type}

    got = planes.both(scenario)
    assert got["port"] == got["jax"] == {"value": 42, "module_is_the_file": True, "definition_type": "file"}


def test_dispatch_metrics_and_the_call_span(planes, monkeypatch):
    """What the App layer's row of the port's metrics reads on the CPU: one
    `.remote()` is one `function.call` root span and one DISPATCH_LATENCY
    observation no longer than that span; its output and a `.map()`'s
    arrive on FunctionStreamOutputs (OUTPUT_STREAM_EVENTS `open` and
    `batch`), and the map adds no dispatch observation. JAX's counterpart
    is tests/test_dispatch.py (its client's stream with the input plane
    off, as here: the input plane's calls have no output stream)."""
    monkeypatch.setenv("MODAL_TPU_DISABLE_INPUT_PLANE", "1")
    from modal_tpu_torch.observability import tracing
    from modal_tpu_torch.observability.catalog import DISPATCH_LATENCY, OUTPUT_STREAM_EVENTS

    client, _sup = planes.of(modal_tpu_torch)
    calls = []

    def tap(span):
        if span.name == "function.call":
            calls.append(span)

    def read():
        return (DISPATCH_LATENCY.count_total(), DISPATCH_LATENCY.totals()[0],
                OUTPUT_STREAM_EVENTS.value(event="open"), OUTPUT_STREAM_EVENTS.value(event="batch"))

    def double(x):
        return 2 * x

    app = modal_tpu_torch.App("metrics")
    f = app.function(serialized=True)(double)
    tracing.add_span_tap(tap)
    try:
        with app.run(client=client):
            before = read()
            assert f.remote(4) == 8
            after_remote = read()
            assert list(f.map(range(5))) == [0, 2, 4, 6, 8]
            after_map = read()
    finally:
        tracing.remove_span_tap(tap)
    (span,) = calls
    assert span.attrs["function_id"] == f.object_id and span.parent_id == "" and span.status == "ok"
    assert after_remote[0] - before[0] == 1
    assert 0 < after_remote[1] - before[1] <= span.end - span.start + 1e-3
    assert after_remote[2] > before[2] and after_remote[3] > before[3]
    assert after_map[0] == after_remote[0]
    assert after_map[2] > after_remote[2] and after_map[3] > after_remote[3]
