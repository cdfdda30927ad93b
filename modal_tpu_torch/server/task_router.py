"""The task command router: the worker-served second data plane (port of
modal_tpu/server/task_router.py).

Reference: the worker hosting a sandbox serves a second gRPC service that
clients dial directly: exec, stdio streaming and filesystem ops without a
round trip through the control plane (modal_proto/task_command_router.proto,
MockTaskCommandRouterServicer in the reference's py/test/conftest.py, which
execs local subprocesses with stdin offset bookkeeping and injected
UNAVAILABLE faults). The same service carries the warm pool's handoff
(`PoolAwaitArguments`, `PoolAdoptAck`; server/warm_pool.py).

Semantics the client relies on:
- **Stdio reads resume by byte offset**: output is buffered per (exec, fd);
  `TaskExecStdioRead(offset=N)` streams from byte N, so a dropped connection
  re-reads exactly where it left off.
- **Stdin writes are idempotent by offset**: `TaskExecPutInput(offset=N)`
  with N < acked bytes is deduplicated (retry-safe); the response carries the
  acked total.
- **Exec start is idempotent by exec_id**: a client-supplied exec_id makes
  retried starts return the existing exec.
- **An exec runs in its task's env and cwd**: a sandbox pinned to a card
  registers its `CUDA_VISIBLE_DEVICES`, so every process exec'd into it sees
  the same card.

Fault injection for tests: `FAULTS["stdio_unavailable_every"] = N` aborts
every Nth stdio-read stream with UNAVAILABLE mid-flight (the client resumes).
"""

from __future__ import annotations

import asyncio
import os
import shutil
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

import grpc

from ..proto import api_pb2

# test-only fault injection
FAULTS: dict = {"stdio_unavailable_every": 0, "_stdio_reads": 0}


@dataclass
class ExecState:
    exec_id: str
    task_id: str
    proc: asyncio.subprocess.Process
    stdout: bytearray = field(default_factory=bytearray)
    stderr: bytearray = field(default_factory=bytearray)
    stdout_eof: bool = False
    stderr_eof: bool = False
    stdin_acked: int = 0
    stdin_eof: bool = False
    returncode: Optional[int] = None
    token: str = ""  # inherited from the task at start (task may unregister first)
    condition: asyncio.Condition = field(default_factory=asyncio.Condition)
    pty_master: int = -1  # master fd when this exec runs under a PTY
    # serializes PutInput bodies: a retried RPC racing a blocked pty write
    # must re-check the acked offset AFTER the first write completes, or the
    # dedupe-by-offset protocol breaks and bytes duplicate
    stdin_lock: asyncio.Lock = field(default_factory=asyncio.Lock)

    def buf(self, fd: int) -> bytearray:
        return self.stdout if fd == 1 else self.stderr

    def buf_eof(self, fd: int) -> bool:
        return self.stdout_eof if fd == 1 else self.stderr_eof


@dataclass
class TaskContext:
    """What an exec inherits from its task: the sandbox/container's env+cwd
    (the local backend's equivalent of 'inside the container')."""

    env: dict[str, str]
    cwd: str
    token: str = ""  # per-task bearer token; "" = unauthenticated (tests)


class TaskRouterServicer:
    """Serves TaskCommandRouter RPCs for the tasks on one worker."""

    # finished execs kept addressable for late reads, bounded
    MAX_FINISHED_EXECS = 256

    def __init__(self):
        self._tasks: dict[str, TaskContext] = {}
        self._execs: dict[str, ExecState] = {}
        self._finished_order: list[str] = []
        self._start_locks: dict[str, asyncio.Lock] = {}
        # the warm pool (server/warm_pool.py): set by the owning WorkerAgent
        # so parked interpreters long-poll this plane for their handoffs
        self.pool = None

    # -- worker wiring ------------------------------------------------------

    def register_task(self, task_id: str, env: dict[str, str], cwd: str, token: str = "") -> None:
        self._tasks[task_id] = TaskContext(env=dict(env), cwd=cwd or os.getcwd(), token=token)

    async def _authorize(self, context, token: str) -> None:
        """Require the per-task bearer token issued with the assignment
        (x-task-token metadata). Tasks registered without a token — direct
        servicer use in tests — skip the check. The reference router
        authenticates per task the same way; without this, any process that
        can reach the worker port could exec as the worker user."""
        if not token:
            return
        import secrets as _secrets

        md = dict(context.invocation_metadata() or ())
        if not _secrets.compare_digest(md.get("x-task-token", ""), token):
            await context.abort(grpc.StatusCode.PERMISSION_DENIED, "bad or missing task token")

    def unregister_task(self, task_id: str) -> None:
        self._tasks.pop(task_id, None)
        # exec'd processes die with their sandbox/container
        for st in self._execs.values():
            if st.task_id == task_id and st.proc.returncode is None:
                try:
                    st.proc.kill()
                except ProcessLookupError:
                    pass

    async def shutdown(self) -> None:
        for st in self._execs.values():
            if st.proc.returncode is None:
                try:
                    st.proc.kill()
                except ProcessLookupError:
                    pass

    # -- exec ---------------------------------------------------------------

    async def TaskExecStart(self, request: api_pb2.TaskExecStartRequest, context) -> api_pb2.TaskExecStartResponse:
        task = self._tasks.get(request.task_id)
        if task is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"task {request.task_id} not on this worker")
        await self._authorize(context, task.token)
        exec_id = request.exec_id or f"ex-{uuid.uuid4().hex[:12]}"
        # per-exec_id lock: a retried start racing the original's subprocess
        # spawn must not create a second process
        lock = self._start_locks.setdefault(exec_id, asyncio.Lock())
        # held across the spawn by design: the idempotency re-check and the
        # subprocess creation must be one atomic step per exec_id
        async with lock:  # lint: disable=lock-across-await
            if exec_id in self._execs:  # idempotent retry
                return api_pb2.TaskExecStartResponse(exec_id=exec_id)
            env = dict(task.env)
            env.update(dict(request.env))
            cwd = request.workdir or task.cwd
            if request.pty:
                st = await self._start_pty_exec(request, exec_id, env, cwd, task)
            else:
                proc = await asyncio.create_subprocess_exec(
                    *request.args,
                    stdin=asyncio.subprocess.PIPE,
                    stdout=asyncio.subprocess.PIPE,
                    stderr=asyncio.subprocess.PIPE,
                    env=env,
                    cwd=cwd or None,
                )
                st = ExecState(exec_id=exec_id, task_id=request.task_id, proc=proc, token=task.token)
            self._execs[exec_id] = st
        if st.pty_master >= 0:
            asyncio.create_task(self._pump_pty(st))
        else:
            asyncio.create_task(self._pump(st, st.proc.stdout, 1))
            asyncio.create_task(self._pump(st, st.proc.stderr, 2))
        asyncio.create_task(self._reap(st, request.timeout_secs or 0))
        return api_pb2.TaskExecStartResponse(exec_id=exec_id)

    async def _start_pty_exec(
        self, request: api_pb2.TaskExecStartRequest, exec_id: str, env: dict, cwd: str, task: TaskContext
    ) -> ExecState:
        """Run the command under a real pseudo-terminal: the child gets the
        PTY slave as its controlling tty on all three fds; stdout/stderr are
        merged onto fd 1 as terminals do (reference _output/pty.py +
        ContainerExec pty=true)."""
        import fcntl
        import pty as _pty
        import struct
        import termios

        master, slave = _pty.openpty()
        rows = request.pty_rows or 24
        cols = request.pty_cols or 80
        fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH", rows, cols, 0, 0))
        env = dict(env)
        env.setdefault("TERM", "xterm-256color")

        def _become_session_leader() -> None:
            # runs in the child after fd redirection: new session + claim
            # the slave (now fd 0) as controlling tty, so job control works
            os.setsid()
            fcntl.ioctl(0, termios.TIOCSCTTY, 0)

        try:
            proc = await asyncio.create_subprocess_exec(
                *request.args,
                stdin=slave,
                stdout=slave,
                stderr=slave,
                env=env,
                cwd=cwd or None,
                preexec_fn=_become_session_leader,
            )
        finally:
            os.close(slave)  # child holds its own copy
        return ExecState(
            exec_id=exec_id,
            task_id=request.task_id,
            proc=proc,
            token=task.token,
            pty_master=master,
        )

    async def _pump_pty(self, st: ExecState) -> None:
        """Read the PTY master into the stdout buffer. EIO on a closed slave
        is the PTY's EOF."""
        loop = asyncio.get_running_loop()

        def _read() -> bytes:
            try:
                return os.read(st.pty_master, 65536)
            except OSError:
                return b""

        while True:
            chunk = await loop.run_in_executor(None, _read)
            async with st.condition:
                if not chunk:
                    st.stdout_eof = True
                    st.stderr_eof = True
                    st.condition.notify_all()
                    try:
                        os.close(st.pty_master)
                    except OSError:
                        pass
                    st.pty_master = -1
                    return
                st.stdout.extend(chunk)
                st.condition.notify_all()

    async def TaskExecPtyResize(
        self, request: api_pb2.TaskExecPtyResizeRequest, context
    ) -> api_pb2.TaskExecPtyResizeResponse:
        st = self._get_exec(request.exec_id)
        if st is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "exec not found")
        await self._authorize(context, st.token)
        if st.pty_master >= 0 and request.rows and request.cols:
            import fcntl
            import struct
            import termios

            try:
                fcntl.ioctl(
                    st.pty_master,
                    termios.TIOCSWINSZ,
                    struct.pack("HHHH", request.rows, request.cols, 0, 0),
                )
            except OSError:
                pass
        return api_pb2.TaskExecPtyResizeResponse()

    async def _pump(self, st: ExecState, stream, fd: int) -> None:
        while True:
            chunk = await stream.read(65536)
            async with st.condition:
                if not chunk:
                    if fd == 1:
                        st.stdout_eof = True
                    else:
                        st.stderr_eof = True
                    st.condition.notify_all()
                    return
                st.buf(fd).extend(chunk)
                st.condition.notify_all()

    async def _reap(self, st: ExecState, timeout_secs: float) -> None:
        try:
            if timeout_secs:
                rc = await asyncio.wait_for(st.proc.wait(), timeout=timeout_secs)
            else:
                rc = await st.proc.wait()
        except asyncio.TimeoutError:
            st.proc.kill()
            rc = await st.proc.wait()
        async with st.condition:
            st.returncode = rc
            st.condition.notify_all()
        # bound memory: evict the oldest finished execs (their full stdio
        # stays buffered for offset-resume until eviction)
        self._finished_order.append(st.exec_id)
        while len(self._finished_order) > self.MAX_FINISHED_EXECS:
            old = self._finished_order.pop(0)
            self._execs.pop(old, None)
            self._start_locks.pop(old, None)

    def _get_exec(self, exec_id: str):
        return self._execs.get(exec_id)

    async def TaskExecStdioRead(self, request: api_pb2.TaskExecStdioReadRequest, context):
        st = self._get_exec(request.exec_id)
        if st is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "exec not found")
        await self._authorize(context, st.token)
        fd = request.file_descriptor or 1
        offset = request.offset
        deadline = time.monotonic() + (request.timeout or 55.0)
        FAULTS["_stdio_reads"] += 1
        fault_stream = (
            FAULTS["stdio_unavailable_every"]
            and FAULTS["_stdio_reads"] % FAULTS["stdio_unavailable_every"] == 0
        )
        sent_one = False
        while True:
            data: Optional[bytes] = None
            eof = False
            # never yield while holding the condition: a slow consumer would
            # block the output pumps
            async with st.condition:
                buf = st.buf(fd)
                if offset < len(buf):
                    data = bytes(buf[offset : offset + 256 * 1024])
                elif st.buf_eof(fd):
                    eof = True
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return  # client re-polls from its offset
                    try:
                        await asyncio.wait_for(st.condition.wait(), timeout=remaining)
                    except asyncio.TimeoutError:
                        pass
                    continue
            if data is not None:
                yield api_pb2.TaskExecStdioChunk(data=data, offset=offset)
                offset += len(data)
                if fault_stream and not sent_one:
                    # injected mid-stream failure: client must resume from
                    # the offset it has acked (reference conftest.py:93-103
                    # UNAVAILABLE injection)
                    await context.abort(grpc.StatusCode.UNAVAILABLE, "injected fault")
                sent_one = True
            elif eof:
                yield api_pb2.TaskExecStdioChunk(offset=offset, eof=True)
                return

    @staticmethod
    def _write_all_fd(fd: int, data: bytes) -> None:
        """Loop os.write to completion: partial writes (pty buffer full,
        EINTR) must not drop bytes that the offset protocol will ack."""
        view = memoryview(data)
        while view:
            n = os.write(fd, view)
            view = view[n:]

    async def TaskExecPutInput(self, request: api_pb2.TaskExecPutInputRequest, context) -> api_pb2.TaskExecPutInputResponse:
        st = self._get_exec(request.exec_id)
        if st is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "exec not found")
        await self._authorize(context, st.token)
        # serialize with any still-blocked write: stdin bytes must land in
        # offset order, so overlapping writers WAIT — that is the contract
        async with st.stdin_lock:  # lint: disable=lock-across-await
            data = request.data
            # offset-dedupe: drop the prefix we've already accepted
            if request.offset < st.stdin_acked:
                overlap = st.stdin_acked - request.offset
                data = data[overlap:] if overlap < len(data) else b""
            elif request.offset > st.stdin_acked:
                await context.abort(
                    grpc.StatusCode.FAILED_PRECONDITION,
                    f"stdin gap: acked {st.stdin_acked}, got offset {request.offset}",
                )
            if data and not st.stdin_eof:
                if st.pty_master >= 0:
                    await asyncio.to_thread(self._write_all_fd, st.pty_master, bytes(data))
                    st.stdin_acked += len(data)
                elif st.proc.stdin is not None:
                    st.proc.stdin.write(data)
                    await st.proc.stdin.drain()
                    st.stdin_acked += len(data)
            if request.eof and not st.stdin_eof:
                st.stdin_eof = True
                if st.pty_master >= 0:
                    # a terminal has no half-close; send EOT so
                    # line-disciplined readers see end-of-input
                    try:
                        await asyncio.to_thread(os.write, st.pty_master, b"\x04")
                    except OSError:
                        pass
                elif st.proc.stdin is not None:
                    st.proc.stdin.close()
            return api_pb2.TaskExecPutInputResponse(acked_offset=st.stdin_acked)

    async def TaskExecWait(self, request: api_pb2.TaskExecWaitRequest, context) -> api_pb2.TaskExecWaitResponse:
        st = self._get_exec(request.exec_id)
        if st is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "exec not found")
        await self._authorize(context, st.token)
        # honor timeout=0 exactly: poll() means "answer immediately"
        deadline = time.monotonic() + request.timeout
        async with st.condition:
            while st.returncode is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0.001:
                    return api_pb2.TaskExecWaitResponse(completed=False)
                try:
                    await asyncio.wait_for(st.condition.wait(), timeout=remaining)
                except asyncio.TimeoutError:
                    pass
            return api_pb2.TaskExecWaitResponse(completed=True, returncode=st.returncode)

    # -- warm-pool handoff (server/warm_pool.py) ----------------------------

    async def PoolAwaitArguments(
        self, request: api_pb2.PoolAwaitRequest, context
    ) -> api_pb2.PoolAwaitResponse:
        """Parked interpreter long-poll: block until the worker hands this
        pool entry a placement (ContainerArguments path + env delta), asks it
        to exit (evict), or the poll window lapses (park again)."""
        from .warm_pool import _EVICT

        if self.pool is None:
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION, "no warm pool on this worker")
        entry = self.pool.entry_for(request.pool_id, request.token)
        if entry is None:
            # unknown/stale entry (worker restarted, entry evicted while the
            # RPC was in flight): tell the interpreter to exit
            return api_pb2.PoolAwaitResponse(evict=True)
        from .warm_pool import AWAIT_POLL_CAP_S

        self.pool.note_parked(entry, request.generation)
        timeout = min(request.timeout or (AWAIT_POLL_CAP_S - 5.0), AWAIT_POLL_CAP_S)
        try:
            payload = await asyncio.wait_for(entry.handoff_q.get(), timeout=timeout)
        except asyncio.TimeoutError:
            return api_pb2.PoolAwaitResponse()  # park again
        if payload is _EVICT:
            return api_pb2.PoolAwaitResponse(evict=True)
        return payload

    async def PoolAdoptAck(
        self, request: api_pb2.PoolAdoptAckRequest, context
    ) -> api_pb2.PoolAdoptAckResponse:
        """Delivery commit: the interpreter holds the payload and is about to
        run it. Only now does the worker's adoption succeed — a kill between
        handoff and ack leaves the ack unset and the placement falls back."""
        if self.pool is None:
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION, "no warm pool on this worker")
        entry = self.pool.entry_for(request.pool_id, request.token)
        if entry is None or not self.pool.ack(entry, request.handoff_id):
            await context.abort(grpc.StatusCode.NOT_FOUND, "unknown pool entry or stale handoff")
        return api_pb2.PoolAdoptAckResponse()

    # -- filesystem ---------------------------------------------------------

    async def TaskFsOp(self, request: api_pb2.TaskFsOpRequest, context) -> api_pb2.TaskFsOpResponse:
        task = self._tasks.get(request.task_id)
        if task is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"task {request.task_id} not on this worker")
        await self._authorize(context, task.token)
        path = request.path
        if not os.path.isabs(path):
            path = os.path.join(task.cwd, path)
        try:
            return await asyncio.to_thread(self._fs_op_sync, request, path, task)
        except FileNotFoundError as exc:
            await context.abort(grpc.StatusCode.NOT_FOUND, str(exc))
        except (OSError, ValueError) as exc:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"{type(exc).__name__}: {exc}")

    def _fs_op_sync(self, request: api_pb2.TaskFsOpRequest, path: str, task: TaskContext) -> api_pb2.TaskFsOpResponse:
        op = request.op
        resp = api_pb2.TaskFsOpResponse()
        if op == "read":
            with open(path, "rb") as f:
                f.seek(request.offset)
                resp.data = f.read(request.length or -1)
        elif op == "write":
            os.makedirs(os.path.dirname(path) or "/", exist_ok=True)
            with open(path, "wb") as f:
                f.write(request.data)
        elif op == "append":
            with open(path, "ab") as f:
                f.write(request.data)
        elif op == "ls":
            for name in sorted(os.listdir(path)):
                full = os.path.join(path, name)
                try:
                    s = os.lstat(full)  # lstat: a dangling symlink must not
                except OSError:  # fail the whole listing
                    continue
                resp.entries.append(
                    api_pb2.FsEntry(
                        name=name,
                        is_dir=os.path.isdir(full),
                        size=s.st_size,
                        mode=s.st_mode,
                        mtime=s.st_mtime,
                    )
                )
        elif op == "mkdir":
            if request.recursive:
                os.makedirs(path, exist_ok=True)
            else:
                os.mkdir(path)
        elif op == "rm":
            if os.path.isdir(path):
                if request.recursive:
                    shutil.rmtree(path)
                else:
                    os.rmdir(path)
            else:
                os.remove(path)
        elif op == "stat":
            resp.exists = os.path.exists(path)
            if resp.exists:
                s = os.stat(path)
                resp.stat.CopyFrom(
                    api_pb2.FsEntry(
                        name=os.path.basename(path),
                        is_dir=os.path.isdir(path),
                        size=s.st_size,
                        mode=s.st_mode,
                        mtime=s.st_mtime,
                    )
                )
        elif op in ("mv", "cp"):
            dest = request.dest
            if not os.path.isabs(dest):
                dest = os.path.join(task.cwd, dest)
            if op == "mv":
                shutil.move(path, dest)
            elif os.path.isdir(path):
                shutil.copytree(path, dest, dirs_exist_ok=True)
            else:
                shutil.copy2(path, dest)
        else:
            raise ValueError(f"unknown fs op {op!r}")
        return resp
