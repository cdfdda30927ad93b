"""The port's sandboxes against the JAX package's: the same scenario runs
through `modal_tpu.Sandbox` on a JAX plane and `modal_tpu_torch.Sandbox` on
the port's, side by side, and what each saw is compared: stdout and stderr
bytes, exit codes, fs-op results.

Counterparts of tests/test_sandbox.py (streams, stdin, exit codes,
terminate, a bad command, the fs snapshot round trip, full snapshot and
restore, the TCP tunnel, readiness probes), tests/test_sandbox_exec.py
(exec through the worker's task command router: stdin offset dedupe, stdio
resume on UNAVAILABLE, poll, workdir and env, fs ops, file handles, token
rejection, pty) and tests/test_sidecars.py. The planes are
`tests.test_torch_app.Planes` (one per package for the module). Port-only
cases: `gpu=` reaches the placement and pins every exec'd process as a
function container is pinned, and a `tpu=` ask is refused.
"""

import importlib
import os
import socket
import tempfile
import time

import grpc
import pytest

import modal_tpu_torch
from tests.test_torch_app import CONTAINER_ENV, Planes


@pytest.fixture(scope="module")
def planes():
    saved = {k: os.environ.get(k) for k in CONTAINER_ENV}
    os.environ.update(CONTAINER_ENV)
    p = Planes(tempfile.mkdtemp(prefix="sandbox-", dir="/tmp"))
    try:
        yield p
    finally:
        p.close()
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)


def _same(planes, scenario, expected=None):
    got = planes.both(scenario)
    assert got["port"] == got["jax"], got
    if expected is not None:
        assert got["port"] == expected
    return got["port"]


def _mod(m, name: str):
    """Package `m`'s submodule `name`."""
    return importlib.import_module(f"{m.__name__}.{name}")


def _sleeper(m, client, *args, **kwargs):
    return m.Sandbox.create("sleep", "30", *args, client=client, **kwargs)


# -- tests/test_sandbox.py ------------------------------------------------------


def test_sandbox_run_and_streams(planes):
    def scenario(m, client, sup):
        sb = m.Sandbox.create("python", "-c", "print('out line'); import sys; print('err line', file=sys.stderr)",
                              client=client)
        return sb.wait(), sb.stdout.read(), sb.stderr.read()

    _same(planes, scenario, (0, "out line\n", "err line\n"))


def test_sandbox_stdin(planes):
    def scenario(m, client, sup):
        sb = m.Sandbox.create("cat", client=client)
        sb.stdin.write(b"hello stdin\n")
        sb.stdin.write_eof()
        sb.stdin.drain()
        return sb.wait(), sb.stdout.read()

    _same(planes, scenario, (0, "hello stdin\n"))


def test_sandbox_exit_code_and_poll(planes):
    def scenario(m, client, sup):
        sb = m.Sandbox.create("python", "-c", "import sys; sys.exit(5)", client=client)
        return sb.wait(raise_on_termination=False), sb.poll()

    _same(planes, scenario, (5, 5))


def test_sandbox_terminate(planes):
    def scenario(m, client, sup):
        sb = _sleeper(m, client)
        time.sleep(0.3)
        running = sb.poll()
        sb.terminate()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and sb.poll() is None:
            time.sleep(0.2)
        with pytest.raises(_mod(m, "exception").SandboxTerminatedError):
            sb.wait()
        return running, sb.poll() is not None

    _same(planes, scenario, (None, True))


def test_sandbox_bad_command(planes):
    def scenario(m, client, sup):
        return m.Sandbox.create("/no/such/binary", client=client).wait(raise_on_termination=False) != 0

    _same(planes, scenario, True)


def test_sandbox_fs_snapshot_roundtrip(planes):
    def scenario(m, client, sup):
        sb = m.Sandbox.create("python", "-c", "open('state.txt','w').write('round-trip')", client=client)
        assert sb.wait() == 0
        image = sb.snapshot_filesystem()
        sb2 = m.Sandbox.create("cat", "state.txt", image=image, client=client)
        return image.object_id[:3], sb2.wait(), sb2.stdout.read()

    _same(planes, scenario, ("im-", 0, "round-trip"))


def test_sandbox_full_snapshot_restore(planes):
    def scenario(m, client, sup):
        # each boot appends a line: the restored sandbox starts from the
        # snapshot's file (one line), not from nothing
        sb = m.Sandbox.create(
            "python", "-c", "f=open('boots','a'); f.write('x'); f.close(); print(open('boots').read())", client=client)
        assert sb.wait() == 0
        first = sb.stdout.read().strip()
        snap = sb.snapshot()
        restored = m.Sandbox.from_snapshot(snap, client=client)
        return first, snap.object_id[:3], restored.wait(), restored.stdout.read().strip()

    _same(planes, scenario, ("x", "sn-", 0, "xx"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _echo_through(tun) -> bytes:
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(tun.tcp_socket, timeout=2) as conn:
                conn.sendall(b"ping")
                payload = conn.recv(1024)
            if payload:
                return payload
        except OSError:
            time.sleep(0.2)
    return b""


def test_sandbox_tunnels_tcp_roundtrip(planes):
    def scenario(m, client, sup):
        port = _free_port()
        server_code = (
            "import socket\n"
            "s = socket.socket(); s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)\n"
            f"s.bind(('127.0.0.1', {port})); s.listen(1)\n"
            "c, _ = s.accept()\n"
            "data = c.recv(1024)\n"
            "c.sendall(b'echo:' + data)\n"
            "c.close(); s.close()\n"
        )
        sb = m.Sandbox.create("python", "-c", server_code, unencrypted_ports=[port], timeout=60, client=client)
        tunnels = sb.tunnels()
        tun = tunnels[port]
        payload = _echo_through(tun)
        sb.wait()
        return list(tunnels) == [port], tun.unencrypted, tun.url.startswith("http://"), payload

    _same(planes, scenario, (True, True, True, b"echo:ping"))


def test_sandbox_readiness_probe(planes):
    def scenario(m, client, sup):
        sb = m.Sandbox.create(
            "python", "-c", "import time; time.sleep(0.8); open('ready','w').close(); time.sleep(5)",
            readiness_probe=["test", "-f", "ready"], timeout=30, client=client)
        t0 = time.monotonic()
        sb.wait_until_ready()
        waited = time.monotonic() - t0 >= 0.3
        sb.terminate()
        return waited

    _same(planes, scenario, True)


def test_sandbox_readiness_probe_sandbox_dies_first(planes):
    def scenario(m, client, sup):
        sb = m.Sandbox.create("python", "-c", "import sys; sys.exit(3)",
                              readiness_probe=m.Probe.with_exec("test", "-f", "never-created"), timeout=30,
                              client=client)
        with pytest.raises(_mod(m, "exception").SandboxTerminatedError):
            sb.wait_until_ready(timeout=15)
        return sb.wait(raise_on_termination=False)

    _same(planes, scenario, 3)


# -- tests/test_sandbox_exec.py -------------------------------------------------


def test_exec_basic(planes):
    def scenario(m, client, sup):
        sb = _sleeper(m, client)
        try:
            p = sb.exec("sh", "-c", "echo out-line; echo err-line >&2; exit 3")
            return p.wait(), p.stdout.read(), p.stderr.read()
        finally:
            sb.terminate()

    _same(planes, scenario, (3, "out-line\n", "err-line\n"))


def test_exec_stdin_roundtrip(planes):
    def scenario(m, client, sup):
        sb = _sleeper(m, client)
        try:
            p = sb.exec("cat")
            p.stdin.write("hello ")
            p.stdin.drain()
            p.stdin.write(b"router")
            p.stdin.write_eof()
            p.stdin.drain()
            return p.wait(), p.stdout.read()
        finally:
            sb.terminate()

    _same(planes, scenario, (0, "hello router"))


def test_exec_stdin_offset_dedupe(planes):
    """A retried PutInput at an acked offset adds no bytes; a partly
    overlapping one adds only its new suffix."""

    def scenario(m, client, sup):
        api_pb2 = _mod(m, "proto.api_pb2")
        sync = _mod(m, "_utils.async_utils").synchronizer
        sb = _sleeper(m, client)
        try:
            p = sb.exec("cat")
            router = sb._router

            async def _dup():
                stub = await router.connect()
                md = router._metadata
                acked = []
                for data, offset, eof in ((b"abc", 0, False), (b"abc", 0, False), (b"bcdef", 1, True)):
                    r = await stub.TaskExecPutInput(
                        api_pb2.TaskExecPutInputRequest(exec_id=p.exec_id, data=data, offset=offset, eof=eof),
                        metadata=md)
                    acked.append(r.acked_offset)
                return acked

            acked = sync.run(_dup())
            return acked, p.wait(), p.stdout.read()
        finally:
            sb.terminate()

    _same(planes, scenario, ([3, 3, 6], 0, "abcdef"))


def test_exec_stdio_resume_on_unavailable(planes):
    """Every stdio stream breaks once with UNAVAILABLE: the client resumes
    from its offset, with no gap and no duplicate."""
    def scenario(m, client, sup):
        router_mod = _mod(m, "server.task_router")
        sb = _sleeper(m, client)
        try:
            router_mod.FAULTS["stdio_unavailable_every"] = 1
            router_mod.FAULTS["_stdio_reads"] = 0
            p = sb.exec("sh", "-c", "for i in $(seq 1 200); do echo line-$i; done")
            rc = p.wait()
            return rc, p.stdout.read().splitlines()
        finally:
            router_mod.FAULTS["stdio_unavailable_every"] = 0
            sb.terminate()

    _same(planes, scenario, (0, [f"line-{i}" for i in range(1, 201)]))


def test_exec_poll_immediate(planes):
    def scenario(m, client, sup):
        sb = _sleeper(m, client)
        try:
            p = sb.exec("sleep", "5")
            t0 = time.monotonic()
            return p.poll(), time.monotonic() - t0 < 2.0
        finally:
            sb.terminate()

    _same(planes, scenario, (None, True))


def test_exec_workdir_and_env(planes, tmp_path):
    def scenario(m, client, sup):
        work = tmp_path / m.__name__
        work.mkdir()
        sb = _sleeper(m, client)
        try:
            p = sb.exec("sh", "-c", "pwd; echo $EXEC_FLAVOR", workdir=str(work), env={"EXEC_FLAVOR": "card"})
            return p.wait(), p.stdout.read().splitlines() == [str(work), "card"]
        finally:
            sb.terminate()

    _same(planes, scenario, (0, True))


def test_sandbox_fs_ops(planes, tmp_path):
    def scenario(m, client, sup):
        work = tmp_path / m.__name__
        work.mkdir()
        sb = _sleeper(m, client, workdir=str(work))
        try:
            fs = sb.fs
            out = []
            fs.write_file("data/a.txt", "hello fs")
            out.append(fs.read_text("data/a.txt"))
            fs.append_file("data/a.txt", "!")
            out.append(fs.read_text("data/a.txt"))
            out.append([(e.name, e.is_dir, e.size) for e in fs.ls("data")])
            out.append((fs.exists("data/a.txt"), fs.exists("data/b.txt")))
            out.append(fs.stat("data/a.txt").size)
            fs.cp("data/a.txt", "data/b.txt")
            fs.mv("data/b.txt", "data/c.txt")
            out.append((fs.exists("data/c.txt"), fs.exists("data/b.txt")))
            fs.mkdir("sub/deep", parents=True)
            out.append(fs.stat("sub/deep").is_dir)
            fs.rm("data", recursive=True)
            out.append(fs.exists("data"))
            fs.write_file("r.bin", b"0123456789")
            out.append(fs.read_file("r.bin", offset=3, length=4))
            return out
        finally:
            sb.terminate()

    _same(planes, scenario, ["hello fs", "hello fs!", [("a.txt", False, 9)], (True, False), 9, (True, False), True,
                             False, b"3456"])


def test_sandbox_open_file_handle(planes, tmp_path):
    def scenario(m, client, sup):
        work = tmp_path / m.__name__
        work.mkdir()
        sb = _sleeper(m, client, workdir=str(work))
        try:
            f = sb.open("notes.txt", "w")
            f.write("line1\n")
            f.write("line2\n")
            f.close()
            g = sb.open("notes.txt", "r")
            whole = g.read()
            g.seek(0)
            head = g.read(5)
            g.close()
            with pytest.raises(FileNotFoundError):
                sb.open("missing.txt", "r")
            return whole, head
        finally:
            sb.terminate()

    _same(planes, scenario, ("line1\nline2\n", "line1"))


def test_router_rejects_missing_or_bad_token(planes):
    """Router RPCs need the task's bearer token: a caller without it gets
    PERMISSION_DENIED, never an exec."""
    def scenario(m, client, sup):
        api_pb2 = _mod(m, "proto.api_pb2")
        sync = _mod(m, "_utils.async_utils").synchronizer
        sb = _sleeper(m, client)
        try:
            p = sb.exec("echo", "hi")
            rc = p.wait()
            raw = sb._get_router()

            async def _call(md):
                stub = await raw.connect()
                try:
                    await stub.TaskFsOp(api_pb2.TaskFsOpRequest(task_id=raw.task_id, op="stat", path="."), metadata=md)
                except grpc.aio.AioRpcError as exc:
                    return exc.code().name
                return "OK"

            return rc, sync.run(_call(None)), sync.run(_call([("x-task-token", "wrong")])), sync.run(
                _call(raw._metadata))
        finally:
            sb.terminate()

    _same(planes, scenario, (0, "PERMISSION_DENIED", "PERMISSION_DENIED", "OK"))


def test_exec_pty_isatty(planes):
    def scenario(m, client, sup):
        sb = _sleeper(m, client)
        try:
            p = sb.exec("python", "-c",
                        "import sys; print(sys.stdin.isatty(), sys.stdout.isatty(), sys.stderr.isatty())", pty=True)
            return p.wait(), "True True True" in p.stdout.read()
        finally:
            sb.terminate()

    _same(planes, scenario, (0, True))


def test_exec_pty_window_size_and_resize(planes):
    def scenario(m, client, sup):
        sb = _sleeper(m, client)
        code = (
            "import os, sys, time\n"
            "print(os.get_terminal_size().lines, os.get_terminal_size().columns, flush=True)\n"
            "time.sleep(1.2)\n"
            "print(os.get_terminal_size().lines, os.get_terminal_size().columns, flush=True)\n"
        )
        try:
            p = sb.exec("python", "-u", "-c", code, pty=True, pty_rows=37, pty_cols=111)
            time.sleep(0.6)
            p.pty_resize(50, 140)
            rc = p.wait()
            out = p.stdout.read()
            return rc, "37 111" in out, "50 140" in out
        finally:
            sb.terminate()

    _same(planes, scenario, (0, True, True))


def test_exec_pty_interactive_stdin(planes):
    def scenario(m, client, sup):
        sb = _sleeper(m, client)
        try:
            p = sb.exec("sh", "-i", pty=True, text=False)
            p.stdin.write(b"echo marker-$((40+2))\n")
            p.stdin.drain()
            p.stdin.write(b"exit\n")
            p.stdin.drain()
            p.wait()
            return "marker-42" in p.stdout.read().decode(errors="replace")
        finally:
            sb.terminate()

    _same(planes, scenario, True)


# -- tests/test_sidecars.py -----------------------------------------------------


def test_sidecar_shares_filesystem_and_reports_exit(planes):
    def scenario(m, client, sup):
        sb = _sleeper(m, client)
        try:
            sc = sb._experimental_sidecars.create("sh", "-c", "echo payload-from-sidecar > sidecar.txt", name="writer")
            code = sc.wait(timeout=30)
            p = sb.exec("cat", "sidecar.txt")
            return code, p.wait(), p.stdout.read().strip()
        finally:
            sb.terminate()

    _same(planes, scenario, (0, 0, "payload-from-sidecar"))


def test_sidecar_env_and_listing(planes):
    def scenario(m, client, sup):
        sb = _sleeper(m, client)
        try:
            sb._experimental_sidecars.create("sh", "-c", "echo $SIDE_VAR > envdump.txt", name="envy",
                                             env={"SIDE_VAR": "sideval"})
            long_runner = sb._experimental_sidecars.create("sleep", "30", name="steady")
            deadline = time.monotonic() + 20
            listing = {}
            while time.monotonic() < deadline:
                listing = {sc.name: sc for sc in sb._experimental_sidecars.list()}
                if "envy" in listing and not listing["envy"].running:
                    break
                time.sleep(0.3)
            p = sb.exec("cat", "envdump.txt")
            rc = p.wait()
            long_runner.stop()
            return (listing["envy"].running, listing["envy"].returncode, listing["steady"].running, rc,
                    p.stdout.read().strip(), long_runner.wait(timeout=20) != 0)
        finally:
            sb.terminate()

    _same(planes, scenario, (False, 0, True, 0, "sideval", True))


def test_sidecar_name_validation_and_get(planes):
    def scenario(m, client, sup):
        sb = _sleeper(m, client)
        try:
            with pytest.raises(_mod(m, "exception").InvalidError):
                sb._experimental_sidecars.create("true", name="main")
            with pytest.raises(_mod(m, "exception").NotFoundError):
                sb._experimental_sidecars.get(name="ghost")
            sb._experimental_sidecars.create("sleep", "5", name="real")
            got = sb._experimental_sidecars.get(name="real").name
            with pytest.raises(_mod(m, "exception").AlreadyExistsError) as dup:
                sb._experimental_sidecars.create("sleep", "5", name="real")
            return got, str(dup.value)
        finally:
            sb.terminate()

    _same(planes, scenario, ("real", "sidecar 'real' is running"))


def test_sidecars_die_with_the_sandbox(planes):
    def scenario(m, client, sup):
        sb = _sleeper(m, client)
        sb._experimental_sidecars.create("sleep", "300", name="orphan-candidate")
        worker = sup.workers[0]
        deadline = time.monotonic() + 15
        key = None
        while key is None and time.monotonic() < deadline:
            key = next((k for k in list(worker._procs) if "/sc/orphan-candidate" in k), None)
            time.sleep(0.1)
        sb.terminate()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and key in worker._procs:
            time.sleep(0.2)
        return key is not None, key in worker._procs

    _same(planes, scenario, (True, False))


# -- the port's own: cards and the refusal of TPU chips --------------------------


def test_a_gpu_sandbox_pins_itself_and_every_exec_to_its_card(planes):
    """`gpu="H100"` reaches the placement (the task holds one of the
    simulated cards) and the sandbox's command and an exec'd process see
    the pinning a function container sees (`CUDA_VISIBLE_DEVICES=""` on a
    simulated host)."""
    client, sup = planes.of(modal_tpu_torch)
    sb = modal_tpu_torch.Sandbox.create("sh", "-c", "echo main=[$CUDA_VISIBLE_DEVICES]; sleep 30", gpu="H100",
                                        client=client)
    try:
        p = sb.exec("sh", "-c", "echo exec=[$CUDA_VISIBLE_DEVICES]")
        assert p.wait() == 0 and p.stdout.read() == "exec=[]\n"
        task = sup.state.tasks[sup.state.sandboxes[sb.object_id].task_id]
        assert len(task.gpu_ids) == 1
        worker = sup.workers[0]
        assert worker._sandbox_runtime[task.task_id][1]["CUDA_VISIBLE_DEVICES"] == ""
    finally:
        sb.terminate()
    assert sb.wait(raise_on_termination=False) != 0
    assert sb.stdout.read() == "main=[]\n"
    deadline = time.monotonic() + 10
    while task.task_id in {t for w in sup.state.workers.values() for t in w.gpus_in_use.values()}:
        assert time.monotonic() < deadline, "the sandbox's card was not released"
        time.sleep(0.1)


def test_a_tpu_sandbox_is_refused_and_an_impossible_placement_fails_loudly(planes):
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch._utils.grpc_utils import retry_transient_errors
    from modal_tpu_torch.proto import api_pb2

    client, _sup = planes.of(modal_tpu_torch)
    req = api_pb2.SandboxCreateRequest(definition=api_pb2.Sandbox(entrypoint_args=["true"]))
    req.definition.resources.tpu_config.tpu_type = "v5e-4"
    with pytest.raises(grpc.aio.AioRpcError) as err:
        synchronizer.run(retry_transient_errors(client.stub.SandboxCreate, req))
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT and "gpu=" in err.value.details()
    with pytest.raises(grpc.aio.AioRpcError) as err:
        modal_tpu_torch.Sandbox.create("true", gpu="H100", region="nowhere", client=client)
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert err.value.details() == "sandbox unsatisfiable placement: regions=['nowhere'] zones=[] matches no registered worker"


def test_the_sandbox_phase_runs_the_forward_tool_in_an_exec(planes):
    """What chip_smoke's sandbox phase runs, at a tiny size on the CPU: the
    exec'd forward tool prints one JSON line through TaskExecStdioRead, the
    plain path as close to fp32 as itself (on the CPU the wrapper runs its
    plain version, so K1 counts no launch)."""
    import json
    import sys

    client, _sup = planes.of(modal_tpu_torch)
    sb = modal_tpu_torch.Sandbox.create("sleep", "60", gpu="H100", client=client)
    try:
        p = sb.exec(sys.executable, "-m", "modal_tpu_torch.tools.sandbox_forward", "--config", "tiny",
                    "--device", "cpu", "--lengths", "16,32")
        assert p.wait() == 0, p.stderr.read()
        lines = p.stdout.read().splitlines()
        assert lines[0] == "sandbox_forward: started"
        out = json.loads(lines[-1])
    finally:
        sb.terminate()
    assert out["lengths"] == [16, 32] and out["launches_per_call"] == out["launches_per_call_again"] == [0, 0]
    assert out["cuda_visible_devices"] == ""
    assert all(len(out[k]) == 2 for k in ("ms_per_call", "host_ms_per_call", "ms_per_call_again",
                                          "host_ms_per_call_again"))
    g = out["gaps"]
    assert g["kernel_vs_plain"]["max"] == 0.0 and g["kernel_vs_fp32"] == g["plain_vs_fp32"]
    assert 0 < g["plain_vs_fp32"]["max"] < 5e-2
