"""The port's warm pool (server/warm_pool.py, the worker's adoption, the
container's parking) against the JAX package's, on the same scenarios:
counterparts of tests/test_coldstart.py (the handoff served by the parked
pid and stamped `warm_pool_hit`, growing to a directive's target and back,
the scheduler's directives for `buffer_containers` and their eviction when
the app stops, an interpreter killed at adoption falling back to a fresh
spawn, a snapshot restored without a re-exec, the drain under preemption),
without `Image.prewarm` (ROADMAP Queue A 4e). Where the JAX tests use the
chaos knob `warm_kill_handoff`, these kill the parked process at the
handoff themselves.

Both planes run with a baseline pool of one interpreter that pre-imports
`json` only (`MODAL_TPU_WARM_POOL_PREIMPORT`, which both packages read), so
no test pays a framework import it does not measure. The port's own cases:
an interpreter that pre-imported torch holds no CUDA context and no pinning
variables, with and without the CPU pre-init, and the re-park rule's two
branches (ROADMAP Queue C 28).
The scheduler's PoolDirective diffs are compared in memory.
"""

import asyncio
import concurrent.futures
import os
import tempfile
import time

import pytest

import modal_tpu
import modal_tpu_torch
from modal_tpu._utils.async_utils import synchronizer as jsync
from modal_tpu.client import _Client as JaxClient
from modal_tpu.proto import api_pb2 as japi
from modal_tpu.server import scheduler as jsched
from modal_tpu.server import services as jservices
from modal_tpu.server import state as jstate
from modal_tpu.server.supervisor import LocalSupervisor as JaxSupervisor
from modal_tpu_torch._utils.async_utils import synchronizer as tsync
from modal_tpu_torch.client import _Client
from modal_tpu_torch.proto import api_pb2 as tapi
from modal_tpu_torch.server import scheduler as tsched
from modal_tpu_torch.server import services as tservices
from modal_tpu_torch.server import state as tstate
from modal_tpu_torch.server.supervisor import LocalSupervisor

POOL_ENV = {"MODAL_TPU_WARM_POOL": "1", "MODAL_TPU_WARM_POOL_PREIMPORT": "json",
            "MODAL_TPU_HEARTBEAT_INTERVAL": "3"}


def _set_env(values: dict) -> dict:
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
    return saved


class PoolPlanes:
    """One plane per package, each worker with a baseline pool of one."""

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
        JaxClient.set_env_client(self.jclient)
        _Client.set_env_client(self.tclient)

    def of(self, m):
        if m is modal_tpu:
            return self.jclient, self.jsup, jsync
        return self.tclient, self.tsup, tsync

    def both(self, scenario):
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
    saved = _set_env(POOL_ENV)
    p = PoolPlanes(tempfile.mkdtemp(prefix="pool-", dir="/tmp"))
    try:
        yield p
    finally:
        p.close()
        _set_env(saved)


def _same(planes, scenario, expected=None):
    got = planes.both(scenario)
    assert got["port"] == got["jax"], got
    if expected is not None:
        assert got["port"] == expected
    return got["port"]


def _parked(sup, sync, n: int = 1, timeout: float = 60.0) -> bool:
    return sync.run(sup.workers[0].pool.wait_parked(n, timeout))


def _reparked(sup, pid: int, timeout: float = 120.0) -> bool:
    """Has the interpreter `pid` parked again? Parked replacements do not
    count: the pool's next adoption takes the oldest parked interpreter,
    which is this one only once it has re-parked."""
    pool = sup.workers[0].pool
    return _wait(lambda: any(e.state == "parked" and e.proc.pid == pid for e in list(pool.entries.values())),
                 timeout)


def _wait(predicate, timeout: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.1)
    return predicate()


def _whoami(app):
    def whoami(x):
        import os

        return os.getpid(), x * 2

    return app.function(serialized=True)(whoami)


def _hits(sup, app_id: str) -> list:
    return [t.warm_pool_hit for t in sup.state.tasks.values() if t.app_id == app_id]


def test_handoff_without_reexec_same_pid(planes):
    """Two placements, in two app runs, are served by the parked
    interpreter's pid, and both tasks are stamped warm_pool_hit."""

    def scenario(m, client, sup, sync):
        assert _parked(sup, sync)
        pool_pid = next(e for e in sup.workers[0].pool.entries.values() if e.state == "parked").proc.pid
        app = m.App("pool-pid")
        f = _whoami(app)
        with app.run(client=client):
            pid1, v1 = f.remote(21)
            app1 = app.app_id
        assert _parked(sup, sync), "the interpreter did not re-park after the first app"
        with app.run(client=client):
            pid2, v2 = f.remote(4)
            app2 = app.app_id
        return {"values": (v1, v2), "parked_pid": pid1 == pool_pid, "same_pid": pid2 == pid1,
                "hits": _hits(sup, app1) + _hits(sup, app2)}

    _same(planes, scenario, {"values": (42, 8), "parked_pid": True, "same_pid": True, "hits": [True, True]})


def test_pool_grows_to_a_directive_and_shrinks_back(planes):
    """A directive for the host's image grows the pool to its target; its
    withdrawal evicts the surplus (newest first) down to the baseline."""

    def scenario(m, client, sup, sync):
        pool = sup.workers[0].pool
        assert _parked(sup, sync)

        async def directive(target):
            pool.set_directive("", target)

        sync.run(directive(2))
        grown = _parked(sup, sync, 2)
        sync.run(directive(0))
        shrunk = _wait(lambda: pool.ready_count() <= 1 and len(pool.entries) <= 1)
        return grown, shrunk, pool.ready_count()

    _same(planes, scenario, (True, True, 1))


def test_buffer_containers_preforks_and_app_stop_evicts(planes):
    """buffer_containers=2 keeps two interpreters parked through the
    scheduler's PoolDirective (one above the baseline), and stopping the app
    withdraws the directive: back to the baseline."""

    def scenario(m, client, sup, sync):
        pool = sup.workers[0].pool
        app = m.App("pool-buffer")

        def noop(x):
            return x

        f = app.function(serialized=True, buffer_containers=2)(noop)
        with app.run(client=client):
            # the pool's target is 2 and it holds 2 interpreters (parked,
            # or serving the buffer containers' placements)
            grown = _wait(lambda: max(pool.targets.values(), default=0) == 2 and len(pool.entries) >= 2, 60.0)
            value = f.remote(3)
        drained = _wait(lambda: not pool.directives and len(pool.entries) <= 1, 60.0)
        return grown, value, drained

    _same(planes, scenario, (True, 3, True))


class _KillAtHandoff(asyncio.Queue):
    """A handoff queue whose first delivery kills the parked process: the
    interpreter dies between the handoff and its ack."""

    def __init__(self, entry):
        super().__init__(maxsize=1)
        self._entry = entry

    def put_nowait(self, item):
        super().put_nowait(item)
        self._entry.proc.kill()


def test_an_interpreter_killed_at_adoption_falls_back_to_a_fresh_spawn(planes):
    def scenario(m, client, sup, sync):
        pool = sup.workers[0].pool
        assert _parked(sup, sync)
        catalog = __import__(f"{m.__name__}.observability.catalog", fromlist=["WARM_POOL_PLACEMENTS"])
        failed0 = catalog.WARM_POOL_PLACEMENTS.value(outcome="handoff_failed")
        entry = next(e for e in pool.entries.values() if e.state == "parked")
        entry.handoff_q = _KillAtHandoff(entry)
        app = m.App("pool-kill")
        f = _whoami(app)
        with app.run(client=client):
            pid, v = f.remote(5)
            app_id = app.app_id
        return {"value": v, "served_by_the_killed": pid == entry.proc.pid, "hits": _hits(sup, app_id),
                "handoff_failed": catalog.WARM_POOL_PLACEMENTS.value(outcome="handoff_failed") - failed0}

    _same(planes, scenario, {"value": 10, "served_by_the_killed": False, "hits": [False], "handoff_failed": 1})


def _snap_model(m, marker: str):
    """A class whose snap-enter hook runs once: the second boot restores."""

    class Model:
        @m.enter(snap=True)
        def load(self):
            with open(marker, "a") as f:
                f.write("x")
            if m.__name__ == "modal_tpu":
                import jax.numpy as jnp

                self.w = jnp.arange(8.0)
            else:
                import torch

                self.w = torch.arange(8.0)

        @m.method()
        def total(self, k):
            import os

            return os.getpid(), float(self.w.sum()) * k

    return Model


def test_snapshot_restore_without_reexec(planes, tmp_path):
    def scenario(m, client, sup, sync):
        assert _parked(sup, sync)
        marker = str(tmp_path / f"{m.__name__}-enter.txt")
        app = m.App("pool-snap")
        Model = app.cls(serialized=True, enable_memory_snapshot=True)(_snap_model(m, marker))
        with app.run(client=client):
            pid1, v1 = Model().total.remote(2)
        # the event the second call needs: this interpreter parked again (a
        # fresh replacement may park first under load, and one whose first
        # import of the framework races the heartbeat's telemetry sample
        # fails the restore: the JAX package's, ROADMAP Queue C 30)
        assert _reparked(sup, pid1), "the interpreter did not re-park after the snapshot save"
        with app.run(client=client):
            pid2, v2 = Model().total.remote(3)
        return {"values": (v1, v2), "enters": os.path.getsize(marker), "same_pid": pid1 == pid2}

    saved = _set_env({"MODAL_TPU_SNAPSHOT_DIR": str(tmp_path / "snapshots")})
    try:
        _same(planes, scenario, {"values": (56.0, 84.0), "enters": 1, "same_pid": True})
    finally:
        _set_env(saved)


def _directive_events(events) -> list:
    return [(e.pool_directive.image_id, e.pool_directive.target) for e in events if e.HasField("pool_directive")]


def _drain(q: asyncio.Queue) -> list:
    out = []
    while not q.empty():
        out.append(q.get_nowait())
    return out


def test_the_schedulers_send_the_same_pool_directives(tmp_path):
    """The same functions on the same three workers: the JAX scheduler and
    the port's send each worker the same PoolDirective diffs (targets capped
    at 4 and split across the workers), and target 0 once the app stops."""

    async def run(pkg):
        api, state, services, sched = pkg
        s = state.ServerState(str(tmp_path / api.__name__.split(".")[0]))
        svc = services.ModalTPUServicer(s)
        sch = sched.Scheduler(s, svc)
        svc.scheduler = sch
        for i in range(3):
            w = state.WorkerState(worker_id=f"w{i}")
            s.workers[w.worker_id] = w
        s.apps["ap-1"] = state.AppState(app_id="ap-1")
        for fid, image, mins, buf in (("fu-1", "im-a", 1, 0), ("fu-2", "im-b", 0, 6), ("fu-3", "im-a", 0, 2)):
            fdef = api.Function(function_name=fid, image_id=image)
            fdef.autoscaler_settings.min_containers = mins
            fdef.autoscaler_settings.buffer_containers = buf
            fdef.autoscaler_settings.max_containers = 1  # the directive, not the launches, is under test
            s.functions[fid] = state.FunctionState(function_id=fid, app_id="ap-1", tag=fid, definition=fdef)
        rounds = []
        await sch._schedule_once()
        rounds.append({w: _directive_events(_drain(s.workers[w].events)) for w in sorted(s.workers)})
        await sch._schedule_once()  # no change: nothing is sent again
        rounds.append({w: _directive_events(_drain(s.workers[w].events)) for w in sorted(s.workers)})
        s.apps["ap-1"].done = True
        await sch._schedule_once()
        rounds.append({w: _directive_events(_drain(s.workers[w].events)) for w in sorted(s.workers)})
        return rounds

    jax_rounds = jsync.run(run((japi, jstate, jservices, jsched)))
    port_rounds = tsync.run(run((tapi, tstate, tservices, tsched)))
    assert port_rounds == jax_rounds
    assert port_rounds[0] == {"w0": [("im-a", 1), ("im-b", 2)], "w1": [("im-a", 1), ("im-b", 1)],
                              "w2": [("im-b", 1)]}
    assert port_rounds[1] == {"w0": [], "w1": [], "w2": []}
    assert port_rounds[2] == {"w0": [("im-a", 0), ("im-b", 0)], "w1": [("im-a", 0), ("im-b", 0)],
                              "w2": [("im-b", 0)]}


def test_the_placement_tie_break_prefers_a_parked_interpreter(tmp_path):
    """Of two equally loaded workers, the one whose heartbeat reported a
    parked interpreter takes the placement, in both schedulers."""
    picks = {}
    for name, (state, sched) in {"jax": (jstate, jsched), "port": (tstate, tsched)}.items():
        s = state.ServerState(str(tmp_path / name))
        for i in range(2):
            w = state.WorkerState(worker_id=f"w{i}")
            s.workers[w.worker_id] = w
        s.workers["w1"].warm_pool_ready = 1
        sch = sched.Scheduler(s)
        picks[name] = sch._pick_worker(0 if name == "jax" else None).worker_id
    assert picks == {"jax": "w1", "port": "w1"}


# -- the port's own: CUDA and the re-park rule ----------------------------------


def _torch_plane(tmp_path, **env):
    """A port plane whose one parked interpreter pre-imported torch, spawned
    from an environment that pins a card and names a build dir."""
    saved = _set_env({**POOL_ENV, "MODAL_TPU_WARM_POOL_PREIMPORT": "torch", "CUDA_VISIBLE_DEVICES": "0",
                      "CUDA_DEVICE_ORDER": "PCI_BUS_ID", "TORCH_EXTENSIONS_DIR": str(tmp_path / "stray"), **env})
    sup = LocalSupervisor(num_workers=1, state_dir=tempfile.mkdtemp(prefix="pool-torch-", dir="/tmp"),
                          worker_gpus=2, worker_gpu_type="local-sim")
    try:
        tsync.run(sup.start())
    finally:
        _set_env(saved)
    client = _Client(sup.server_url)
    client._open()
    client.hello()
    try:
        yield sup, client
    finally:
        client._close()
        tsync.run(sup.stop())


@pytest.fixture
def torch_pool(tmp_path):
    yield from _torch_plane(tmp_path)


@pytest.fixture
def torch_pool_preinit(tmp_path):
    yield from _torch_plane(tmp_path, MODAL_TPU_WARM_POOL_PREINIT="1")


def _park_spans(sup, name: str = "coldstart.park") -> list:
    from modal_tpu_torch.observability import tracing

    return [s["attrs"] for s in tracing.read_spans(os.path.join(sup.state_dir, "traces"))
            if s["name"] == name]


def test_a_parked_interpreter_holds_no_cuda_context_and_the_rule_decides_the_re_park(torch_pool):
    """Parked: torch imported, no CUDA context, no pinning variables. A
    placement that never touched CUDA re-parks under the same pid; one that
    initialized CUDA exits instead (Queue C 28), and the pool pre-forks a
    fresh interpreter, which takes the next placement as a warm hit. Each
    placement gets its card pinning and build dir from the adoption."""
    sup, client = torch_pool
    pool = sup.workers[0].pool
    assert _parked(sup, tsync, 1, 90.0)
    first_pid = next(iter(pool.entries.values())).proc.pid
    (parked,) = _park_spans(sup)
    assert parked == {"pool_id": parked["pool_id"], "generation": 0, "pid": first_pid, "torch_imported": True,
                      "cuda_initialized": False, "libcuda_mapped": False, "pinning_env": []}
    app = modal_tpu_torch.App("pool-cuda")

    def probe(touch_cuda: bool):
        import os

        import torch

        seen = (os.environ.get("CUDA_VISIBLE_DEVICES"), os.environ.get("TORCH_EXTENSIONS_DIR"),
                torch.cuda.is_initialized())
        if touch_cuda:
            torch.cuda._initialized = True  # what a placement's first CUDA call leaves behind
        return os.getpid(), seen

    f = app.function(serialized=True, gpu="H100")(probe)
    results, app_ids = [], []

    def run(touch: bool) -> None:
        with app.run(client=client):
            results.append(f.remote(touch))
            app_ids.append(app.app_id)

    run(False)
    assert _parked(sup, tsync), "an interpreter that never touched CUDA must re-park"
    run(True)
    assert _wait(lambda: all(e.proc.pid != first_pid for e in pool.entries.values())
                 and pool.ready_count() == 1, 90.0), "the interpreter that touched CUDA must exit and be replaced"
    run(False)
    pids = [r[0] for r in results]
    assert pids[0] == pids[1] == first_pid and pids[2] != first_pid
    tasks = sorted((t for t in sup.state.tasks.values() if t.app_id in app_ids), key=lambda t: t.created_at)
    assert [t.warm_pool_hit for t in tasks] == [True, True, True]
    for (_pid, (cvd, build_dir, initialized)), task in zip(results, tasks):
        assert cvd == "" and not initialized  # a simulated card: pinned to none
        assert build_dir == os.path.join(sup.state_dir, "tasks", task.task_id, "kernels")
    assert [s["generation"] for s in _park_spans(sup)][:3] == [0, 1, 0]


def test_preinit_primes_the_cpu_only_and_an_exiting_interpreter_ships_its_last_output(torch_pool_preinit):
    """`MODAL_TPU_WARM_POOL_PREINIT=1`: the parked interpreter ran the
    pre-init on the CPU and still holds no CUDA context, no driver and no
    pinning variables, so the placement it serves as a warm hit gets the
    pinning of its adoption. That placement touches CUDA, so the
    interpreter exits after it (Queue C 28), and every byte it printed, 1
    MiB, reaches the app's logs: the worker drains the tailer of an exited
    interpreter instead of cutting it off."""
    sup, client = torch_pool_preinit
    pool = sup.workers[0].pool
    assert _parked(sup, tsync, 1, 90.0)
    pid = next(iter(pool.entries.values())).proc.pid
    (parked,) = _park_spans(sup)
    assert parked == {"pool_id": parked["pool_id"], "generation": 0, "pid": pid, "torch_imported": True,
                      "cuda_initialized": False, "libcuda_mapped": False, "pinning_env": []}
    (preinit,) = _park_spans(sup, "coldstart.preinit")
    assert preinit["device"] == "cpu"
    app = modal_tpu_torch.App("pool-preinit")

    def loud(n_lines: int):
        import os
        import sys

        import torch

        seen = (os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.is_initialized())
        sys.stdout.write(("x" * 1023 + "\n") * n_lines)
        sys.stdout.flush()
        torch.cuda._initialized = True  # what a placement's first CUDA call leaves behind
        return os.getpid(), seen

    f = app.function(serialized=True, gpu="H100")(loud)
    with app.run(client=client):
        assert f.remote(1024) == (pid, ("", False))
        app_id = app.app_id
    (task,) = [t for t in sup.state.tasks.values() if t.app_id == app_id]
    assert task.warm_pool_hit
    assert _wait(lambda: all(e.proc.pid != pid for e in pool.entries.values()), 60.0)

    def printed() -> int:
        return sum(e.data.count("x") for e in sup.state.apps[app_id].log_entries
                   if e.task_id == task.task_id and e.file_descriptor == 1)

    assert _wait(lambda: printed() == 1024 * 1023, 30.0), printed()


# last: the preemption drains the worker for good


def test_the_pool_drains_under_preemption(planes):
    def scenario(m, client, sup, sync):
        worker = sup.workers[0]
        assert _parked(sup, sync)
        entry = next(iter(worker.pool.entries.values()))
        sync.run(worker.preempt(grace_s=2.0))
        exited = _wait(lambda: entry.proc.returncode is not None and not worker.pool.entries, 15.0)
        return exited, worker.pool.ready_count()

    _same(planes, scenario, (True, 0))
