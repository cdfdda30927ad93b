"""The port's task command router (server/task_router.py, the worker's
second data plane) against the JAX package's, servicer to servicer, with no
worker: the same requests get the same stdout bytes, exit codes, fs-op
results and status codes. Beside it, the fs snapshot helpers
(server/fs_snapshot.py) and the heartbeat's device sample, which must not
initialize the CUDA driver (a warm-pool interpreter's cards are set later).
"""

import asyncio
import io
import os
import tarfile

import pytest

from modal_tpu.proto import api_pb2 as japi
from modal_tpu.server import fs_snapshot as jfs
from modal_tpu.server import task_router as jrouter
from modal_tpu_torch.proto import api_pb2 as tapi
from modal_tpu_torch.server import fs_snapshot as tfs
from modal_tpu_torch.server import task_router as trouter

PACKAGES = {"jax": (jrouter, japi), "port": (trouter, tapi)}
TOKEN = "tok-1"


class Aborted(Exception):
    def __init__(self, code, details):
        super().__init__(f"{code}: {details}")
        self.code = code


class Context:
    """The part of a grpc.aio servicer context the router uses."""

    def __init__(self, token: str = TOKEN):
        self._md = (("x-task-token", token),) if token is not None else ()

    def invocation_metadata(self):
        return self._md

    async def abort(self, code, details=""):
        raise Aborted(code, details)


def _both(scenario, tmp_path):
    """scenario(router_module, api_pb2, servicer, workdir) on each package,
    each on its own event loop."""
    out = {}
    for name, (mod, api) in PACKAGES.items():
        work = tmp_path / name
        work.mkdir()
        servicer = mod.TaskRouterServicer()
        servicer.register_task("ta-1", dict(os.environ, ROUTER_VAR="rv"), str(work), token=TOKEN)

        async def run():
            try:
                return await scenario(mod, api, servicer, str(work))
            finally:
                await servicer.shutdown()

        out[name] = asyncio.run(run())
    assert out["port"] == out["jax"], out
    return out["port"]


async def _read_all(servicer, api, exec_id: str, fd: int, offset: int = 0) -> bytes:
    data = b""
    while True:
        eof = False
        async for chunk in servicer.TaskExecStdioRead(
                api.TaskExecStdioReadRequest(exec_id=exec_id, file_descriptor=fd, offset=offset + len(data),
                                             timeout=5.0), Context()):
            data += chunk.data
            eof = eof or chunk.eof
        if eof:
            return data


async def _code(coro):
    try:
        await coro
    except Aborted as exc:
        return exc.code.name
    return "OK"


def test_exec_streams_exit_code_and_env(tmp_path):
    async def scenario(mod, api, servicer, work):
        start = await servicer.TaskExecStart(api.TaskExecStartRequest(
            task_id="ta-1", args=["sh", "-c", "echo out-$ROUTER_VAR-$EXTRA; pwd; echo err >&2; exit 7"],
            env={"EXTRA": "x"}, exec_id="ex-a"), Context())
        wait = await servicer.TaskExecWait(api.TaskExecWaitRequest(exec_id=start.exec_id, timeout=10.0), Context())
        out = await _read_all(servicer, api, start.exec_id, 1)
        tail = await _read_all(servicer, api, start.exec_id, 1, offset=4)  # a resume from byte 4
        err = await _read_all(servicer, api, start.exec_id, 2)
        again = await servicer.TaskExecStart(api.TaskExecStartRequest(task_id="ta-1", args=["false"], exec_id="ex-a"),
                                             Context())
        return (start.exec_id, again.exec_id, wait.completed, wait.returncode,
                out == f"out-rv-x\n{work}\n".encode(), tail == out[4:], err)

    assert _both(scenario, tmp_path) == ("ex-a", "ex-a", True, 7, True, True, b"err\n")


def test_stdin_offsets_dedupe_and_refuse_a_gap(tmp_path):
    async def scenario(mod, api, servicer, work):
        start = await servicer.TaskExecStart(api.TaskExecStartRequest(task_id="ta-1", args=["cat"]), Context())
        put = servicer.TaskExecPutInput
        acked = []
        for data, offset in ((b"abc", 0), (b"abc", 0), (b"bcdef", 1)):
            acked.append((await put(api.TaskExecPutInputRequest(exec_id=start.exec_id, data=data, offset=offset),
                                    Context())).acked_offset)
        gap = await _code(put(api.TaskExecPutInputRequest(exec_id=start.exec_id, data=b"z", offset=9), Context()))
        await put(api.TaskExecPutInputRequest(exec_id=start.exec_id, offset=6, eof=True), Context())
        poll = await servicer.TaskExecWait(api.TaskExecWaitRequest(exec_id=start.exec_id, timeout=10.0), Context())
        return acked, gap, poll.returncode, await _read_all(servicer, api, start.exec_id, 1)

    assert _both(scenario, tmp_path) == ([3, 3, 6], "FAILED_PRECONDITION", 0, b"abcdef")


def test_wait_zero_answers_at_once_and_finished_execs_are_bounded(tmp_path, monkeypatch):
    async def scenario(mod, api, servicer, work):
        monkeypatch.setattr(mod.TaskRouterServicer, "MAX_FINISHED_EXECS", 2)
        slow = await servicer.TaskExecStart(api.TaskExecStartRequest(task_id="ta-1", args=["sleep", "5"]), Context())
        poll = await servicer.TaskExecWait(api.TaskExecWaitRequest(exec_id=slow.exec_id, timeout=0.0), Context())
        ids = []
        for i in range(3):
            r = await servicer.TaskExecStart(api.TaskExecStartRequest(task_id="ta-1", args=["true"],
                                                                      exec_id=f"ex-{i}"), Context())
            await servicer.TaskExecWait(api.TaskExecWaitRequest(exec_id=r.exec_id, timeout=10.0), Context())
            ids.append(r.exec_id)
        await asyncio.sleep(0.1)
        evicted = await _code(servicer.TaskExecWait(api.TaskExecWaitRequest(exec_id="ex-0", timeout=0.0), Context()))
        kept = await _code(servicer.TaskExecWait(api.TaskExecWaitRequest(exec_id="ex-2", timeout=0.0), Context()))
        return poll.completed, evicted, kept

    assert _both(scenario, tmp_path) == (False, "NOT_FOUND", "OK")


def test_fs_ops_give_the_same_results(tmp_path):
    async def scenario(mod, api, servicer, work):
        async def op(**kw):
            return await servicer.TaskFsOp(api.TaskFsOpRequest(task_id="ta-1", **kw), Context())

        out = []
        await op(op="write", path="d/a.txt", data=b"hello")
        await op(op="append", path="d/a.txt", data=b" fs")
        out.append((await op(op="read", path="d/a.txt")).data)
        out.append((await op(op="read", path="d/a.txt", offset=2, length=3)).data)
        st = await op(op="stat", path="d/a.txt")
        out.append((st.exists, st.stat.name, st.stat.size, st.stat.is_dir))
        await op(op="cp", path="d/a.txt", dest="d/b.txt")
        await op(op="mv", path="d/b.txt", dest="d/c.txt")
        await op(op="mkdir", path="d/sub/deep", recursive=True)
        out.append([(e.name, e.is_dir, e.size if not e.is_dir else 0) for e in (await op(op="ls", path="d")).entries])
        out.append(await _code(op(op="mkdir", path="d/sub")))  # exists, not recursive
        await op(op="rm", path="d/sub", recursive=True)
        out.append((await op(op="stat", path="d/sub")).exists)
        out.append(await _code(op(op="read", path="missing.txt")))
        out.append(await _code(op(op="chmod", path="d/a.txt")))
        out.append((await op(op="read", path=os.path.join(work, "d", "c.txt"))).data)  # an absolute path
        return out

    assert _both(scenario, tmp_path) == [
        b"hello fs", b"llo", (True, "a.txt", 8, False), [("a.txt", False, 8), ("c.txt", False, 8), ("sub", True, 0)],
        "INVALID_ARGUMENT", False, "NOT_FOUND", "INVALID_ARGUMENT", b"hello fs"]


def test_the_task_token_and_unknown_ids(tmp_path):
    async def scenario(mod, api, servicer, work):
        fs = servicer.TaskFsOp
        start = await servicer.TaskExecStart(api.TaskExecStartRequest(task_id="ta-1", args=["true"]), Context())
        return [
            await _code(fs(api.TaskFsOpRequest(task_id="ta-1", op="stat", path="."), Context(token=None))),
            await _code(fs(api.TaskFsOpRequest(task_id="ta-1", op="stat", path="."), Context(token="wrong"))),
            await _code(servicer.TaskExecWait(api.TaskExecWaitRequest(exec_id=start.exec_id), Context("wrong"))),
            await _code(fs(api.TaskFsOpRequest(task_id="ta-2", op="stat", path="."), Context())),
            await _code(servicer.TaskExecStart(api.TaskExecStartRequest(task_id="ta-2", args=["true"]), Context())),
            await _code(servicer.TaskExecWait(api.TaskExecWaitRequest(exec_id="ex-none"), Context())),
            await _code(servicer.PoolAwaitArguments(api.PoolAwaitRequest(pool_id="pw-1"), Context())),
            await _code(servicer.PoolAdoptAck(api.PoolAdoptAckRequest(pool_id="pw-1"), Context())),
        ]

    assert _both(scenario, tmp_path) == ["PERMISSION_DENIED", "PERMISSION_DENIED", "PERMISSION_DENIED",
                                         "NOT_FOUND", "NOT_FOUND", "NOT_FOUND", "FAILED_PRECONDITION",
                                         "FAILED_PRECONDITION"]


def test_a_pty_exec_is_a_terminal_and_resizes(tmp_path):
    async def scenario(mod, api, servicer, work):
        code = ("import os, sys, time\n"
                "print(sys.stdin.isatty(), sys.stdout.isatty(), os.get_terminal_size(), flush=True)\n"
                "sys.stdin.readline()\n"
                "print(os.get_terminal_size(), flush=True)\n")
        start = await servicer.TaskExecStart(api.TaskExecStartRequest(
            task_id="ta-1", args=["python", "-u", "-c", code], pty=True, pty_rows=30, pty_cols=90), Context())
        first = b""
        while b"columns" not in first:
            async for chunk in servicer.TaskExecStdioRead(api.TaskExecStdioReadRequest(
                    exec_id=start.exec_id, file_descriptor=1, offset=len(first), timeout=5.0), Context()):
                first += chunk.data
                break
        await servicer.TaskExecPtyResize(api.TaskExecPtyResizeRequest(exec_id=start.exec_id, rows=44, cols=120),
                                         Context())
        await servicer.TaskExecPutInput(api.TaskExecPutInputRequest(exec_id=start.exec_id, data=b"go\n", offset=0),
                                        Context())
        wait = await servicer.TaskExecWait(api.TaskExecWaitRequest(exec_id=start.exec_id, timeout=10.0), Context())
        out = (await _read_all(servicer, api, start.exec_id, 1)).decode()
        return (wait.returncode, "True True os.terminal_size(columns=90, lines=30)" in out,
                "os.terminal_size(columns=120, lines=44)" in out)

    assert _both(scenario, tmp_path) == (0, True, True)


def test_fs_snapshot_round_trips_and_refuses_unsafe_names(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(b"alpha")
    (src / "sub" / "b.bin").write_bytes(bytes(range(256)))
    trees = {}
    for name, mod in (("jax", jfs), ("port", tfs)):
        dest = tmp_path / f"dest-{name}"
        data = asyncio.run(mod.tar_dir(str(src)))
        asyncio.run(mod.untar_dir(data, str(dest)))
        trees[name] = sorted((os.path.relpath(os.path.join(r, f), dest), open(os.path.join(r, f), "rb").read())
                             for r, _d, files in os.walk(dest) for f in files)
        assert mod.sandbox_workdir("/s", "ta-1", "") == "/s/tasks/ta-1/work"
        assert mod.sandbox_workdir("/s", "ta-1", "/w") == "/w"
    assert trees["port"] == trees["jax"] == [("a.txt", b"alpha"), ("sub/b.bin", bytes(range(256)))]
    for bad in ("../escape.txt", "/abs.txt"):
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tar:
            info = tarfile.TarInfo(bad)
            info.size = 1
            tar.addfile(info, io.BytesIO(b"x"))
        for mod in (jfs, tfs):
            with pytest.raises(ValueError, match="unsafe path"):
                asyncio.run(mod.untar_dir(buf.getvalue(), str(tmp_path / "unsafe")))


def test_the_heartbeat_device_sample_never_asks_the_driver(monkeypatch):
    """`sample_device_memory` (every container heartbeat) reads
    `torch.cuda.is_initialized()` only: `is_available()` would run cuInit,
    which fixes a warm-pool interpreter's visible cards before its
    adoption sets them."""
    import torch

    from modal_tpu_torch.observability import device_telemetry

    def refuse():
        raise AssertionError("is_available() called")

    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    monkeypatch.setattr(torch.cuda, "device_count", refuse)
    assert device_telemetry.sample_device_memory() in (0, 1)  # the host's RSS, no card


def test_the_served_rpc_counts():
    """The port's plane serves 137 of the wire contract's 148 RPCs, as the
    JAX package's servicer does (ShardControl and JournalReplicate since the
    fleet), and its input plane serves its six (Attempt*,
    MapStartOrContinue, MapAwait); a worker's router serves all 8 of its
    own. Only the five ContainerExec* and ContainerFilesystemExec RPCs are
    left: they have no handler in the JAX package either (its sandboxes
    exec through the task router)."""
    from modal_tpu.server.input_plane import InputPlaneServicer as JaxInputPlane
    from modal_tpu.server.services import ModalTPUServicer as JaxServicer
    from modal_tpu_torch.proto.rpc import ROUTER_RPCS, RPCS
    from modal_tpu_torch.server.input_plane import InputPlaneServicer
    from modal_tpu_torch.server.services import ModalTPUServicer

    assert sorted(n for n in ROUTER_RPCS if hasattr(trouter.TaskRouterServicer, n)) == sorted(ROUTER_RPCS)
    assert len(ROUTER_RPCS) == 8
    served = [n for n in RPCS if hasattr(ModalTPUServicer, n)]
    assert (len(RPCS), len(served)) == (148, 137)
    input_plane = {n for n in RPCS if hasattr(InputPlaneServicer, n)}
    assert input_plane == {"AttemptStart", "AttemptStartBatch", "AttemptAwait", "AttemptRetry",
                           "MapStartOrContinue", "MapAwait"}
    assert input_plane == {n for n in RPCS if hasattr(JaxInputPlane, n)}
    assert sorted(set(RPCS) - set(served) - input_plane) == sorted([
        "ContainerExec", "ContainerExecGetOutput", "ContainerExecPutInput", "ContainerExecWait",
        "ContainerFilesystemExec"])
    jax_served = {n for n in RPCS if hasattr(JaxServicer, n)}
    assert jax_served == set(served)
    assert {"ShardControl", "JournalReplicate"} <= set(served)
    assert len([n for n in served if n.startswith(("Dict", "Queue"))]) == 18
    assert {"ImageList", "ImageDelete"} <= set(served)
    assert {"MetricsHistory", "ProfileControl", "AppListProfiles", "TaskGetTimeline"} <= set(served)
    assert len([n for n in served if n.startswith("Volume")]) == 13
    assert {"EphemeralObjectHeartbeat", "TaskClusterHello", "ClusterList"} <= set(served)
    assert len([n for n in served if n.startswith("Sandbox")]) == 19
    assert {"TaskTunnelsUpdate", "TunnelStart", "TunnelStop"} <= set(served)
