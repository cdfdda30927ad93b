"""Client of the worker-served task command router, the second data plane
(port of modal_tpu/_utils/router_client.py).

Reference: py/modal/_utils/task_command_router_client.py: a direct gRPC
channel to the worker hosting the sandbox, with a large bounded connect
budget (the worker may still be starting) and resume-offset streaming for
both stdio reads and stdin writes, so a transient UNAVAILABLE never loses or
duplicates bytes.
"""

from __future__ import annotations

import asyncio
from typing import AsyncGenerator, Optional

import grpc

from ..config import logger
from ..proto import api_pb2
from ..proto.rpc import TaskRouterStub
from .grpc_utils import create_channel, retry_transient_errors

# reference: 34 attempts ≈ 310 s total (task_command_router_client.py:42-52)
CONNECT_ATTEMPTS = 34
CONNECT_BASE_DELAY = 0.25
CONNECT_MAX_DELAY = 10.0
STREAMING_STDIN_CHUNK_SIZE = 256 * 1024  # reference task_command_router_client.py:30


class TaskRouterClient:
    """One client per sandbox: resolves router access via the control plane,
    dials the worker directly, and survives reconnects by offset."""

    def __init__(self, control_stub, sandbox_id: str):
        self._control_stub = control_stub
        self.sandbox_id = sandbox_id
        self.task_id: str = ""
        self._metadata: list[tuple[str, str]] = []  # x-task-token bearer auth
        self._channel: Optional[grpc.aio.Channel] = None
        self._stub: Optional[TaskRouterStub] = None
        self._lock = asyncio.Lock()

    async def connect(self) -> TaskRouterStub:
        """Resolve + dial with the bounded retry budget (the sandbox may
        still be scheduling and the worker still booting)."""
        # single-flight by design: one resolve+dial flight, waiters get its stub
        async with self._lock:  # lint: disable=lock-across-await
            if self._stub is not None:
                return self._stub
            delay = CONNECT_BASE_DELAY
            last_exc: Optional[Exception] = None
            for attempt in range(CONNECT_ATTEMPTS):
                try:
                    # control-plane lookup: NOT_FOUND here is PERMANENT (the
                    # sandbox doesn't exist) — fail fast, don't burn the
                    # connect budget. UNAVAILABLE = still scheduling: retry.
                    access = await self._control_stub.SandboxGetCommandRouterAccess(
                        api_pb2.SandboxGetCommandRouterAccessRequest(sandbox_id=self.sandbox_id)
                    )
                    self.task_id = access.task_id
                    self._metadata = (
                        [("x-task-token", access.router_token)] if access.router_token else []
                    )
                    self._channel = create_channel(f"grpc://{access.router_address}")
                    self._stub = TaskRouterStub(self._channel)
                    try:
                        # probe: proves the worker answers and the task is
                        # registered (NOT_FOUND here IS transient — the
                        # worker may not have registered the task yet)
                        await self._stub.TaskFsOp(
                            api_pb2.TaskFsOpRequest(task_id=self.task_id, op="stat", path="."),
                            metadata=self._metadata,
                        )
                    except grpc.aio.AioRpcError as probe_exc:
                        if probe_exc.code() not in (
                            grpc.StatusCode.UNAVAILABLE,
                            grpc.StatusCode.NOT_FOUND,
                            grpc.StatusCode.DEADLINE_EXCEEDED,
                        ):
                            raise
                        last_exc = probe_exc
                        await self._reset_channel()
                        await asyncio.sleep(delay)
                        delay = min(delay * 1.5, CONNECT_MAX_DELAY)
                        continue
                    return self._stub
                except grpc.aio.AioRpcError as exc:
                    last_exc = exc
                    if exc.code() not in (
                        grpc.StatusCode.UNAVAILABLE,
                        grpc.StatusCode.DEADLINE_EXCEEDED,
                    ):
                        raise
                    await self._reset_channel()
                    await asyncio.sleep(delay)
                    delay = min(delay * 1.5, CONNECT_MAX_DELAY)
            raise ConnectionError(
                f"couldn't reach command router for {self.sandbox_id} "
                f"after {CONNECT_ATTEMPTS} attempts"
            ) from last_exc

    async def _reset_channel(self) -> None:
        if self._channel is not None:
            await self._channel.close()
        self._channel = None
        self._stub = None

    async def close(self) -> None:
        await self._reset_channel()

    # -- exec plane ---------------------------------------------------------

    async def exec_start(
        self,
        args: list[str],
        workdir: str = "",
        env: Optional[dict] = None,
        timeout_secs: int = 0,
        pty: bool = False,
        pty_rows: int = 0,
        pty_cols: int = 0,
    ) -> str:
        import uuid

        stub = await self.connect()
        # client-chosen exec_id: a retried start after a lost response is
        # idempotent server-side instead of re-running the command
        exec_id = f"ex-{uuid.uuid4().hex[:12]}"
        resp = await retry_transient_errors(
            stub.TaskExecStart,
            api_pb2.TaskExecStartRequest(
                task_id=self.task_id,
                args=args,
                workdir=workdir,
                env=env or {},
                timeout_secs=timeout_secs,
                exec_id=exec_id,
                pty=pty,
                pty_rows=pty_rows,
                pty_cols=pty_cols,
            ),
            metadata=self._metadata,
        )
        return resp.exec_id

    async def pty_resize(self, exec_id: str, rows: int, cols: int) -> None:
        stub = await self.connect()
        await retry_transient_errors(
            stub.TaskExecPtyResize,
            api_pb2.TaskExecPtyResizeRequest(exec_id=exec_id, rows=rows, cols=cols),
            metadata=self._metadata,
        )

    async def stdio_read(self, exec_id: str, fd: int) -> AsyncGenerator[bytes, None]:
        """Stream a fd to EOF, resuming from the last acked offset across
        dropped streams (the core router-client behavior under test in the
        reference's injected-UNAVAILABLE scenarios)."""
        stub = await self.connect()
        offset = 0
        while True:
            try:
                async for chunk in stub.TaskExecStdioRead(
                    api_pb2.TaskExecStdioReadRequest(
                        exec_id=exec_id, file_descriptor=fd, offset=offset, timeout=55.0
                    ),
                    metadata=self._metadata,
                ):
                    if chunk.data:
                        # server streams from our offset; drop any overlap
                        skip = offset - chunk.offset
                        data = chunk.data[skip:] if 0 < skip < len(chunk.data) else chunk.data
                        if skip >= len(chunk.data):
                            continue
                        offset = chunk.offset + len(chunk.data)
                        yield data
                    if chunk.eof:
                        return
            except grpc.aio.AioRpcError as exc:
                if exc.code() != grpc.StatusCode.UNAVAILABLE:
                    raise
                logger.debug(f"stdio stream dropped at offset {offset}; resuming")
                await asyncio.sleep(0.1)
            # stream ended without EOF (long-poll window): re-poll from offset

    async def put_input(self, exec_id: str, data: bytes, offset: int, eof: bool) -> int:
        stub = await self.connect()
        acked = offset
        sent = 0
        while True:
            chunk = data[sent : sent + STREAMING_STDIN_CHUNK_SIZE]
            is_last = sent + len(chunk) >= len(data)
            resp = await retry_transient_errors(
                stub.TaskExecPutInput,
                api_pb2.TaskExecPutInputRequest(
                    exec_id=exec_id, data=chunk, offset=offset + sent, eof=eof and is_last
                ),
                metadata=self._metadata,
            )
            acked = resp.acked_offset
            sent += len(chunk)
            if is_last:
                return acked

    async def exec_wait(self, exec_id: str, timeout: Optional[float] = None) -> Optional[int]:
        """timeout=None: block to completion; timeout=0: poll (server answers
        immediately — the wait RPC honors a zero window exactly)."""
        stub = await self.connect()
        deadline = None if timeout is None else asyncio.get_event_loop().time() + timeout
        while True:
            window = 55.0
            if deadline is not None:
                window = max(0.0, min(window, deadline - asyncio.get_event_loop().time()))
            resp = await retry_transient_errors(
                stub.TaskExecWait,
                api_pb2.TaskExecWaitRequest(exec_id=exec_id, timeout=window),
                attempt_timeout=window + 10.0,
                metadata=self._metadata,
            )
            if resp.completed:
                return resp.returncode
            if deadline is not None and asyncio.get_event_loop().time() >= deadline:
                return None

    # -- fs plane -----------------------------------------------------------

    async def fs_op(self, **kwargs) -> api_pb2.TaskFsOpResponse:
        stub = await self.connect()
        req = api_pb2.TaskFsOpRequest(task_id=self.task_id, **kwargs)
        op = kwargs.get("op")
        non_idempotent = op in ("append", "mv", "rm") or (
            op == "mkdir" and not kwargs.get("recursive")
        )
        if non_idempotent:
            # a retry after a lost response would append bytes twice, fail a
            # completed mv/rm with NOT_FOUND, or fail a completed mkdir with
            # EEXIST — no transparent retries for these
            return await stub.TaskFsOp(req, metadata=self._metadata)
        return await retry_transient_errors(stub.TaskFsOp, req, metadata=self._metadata)
