"""ContainerProcess: the handle `sandbox.exec(...)` returns (port of
modal_tpu/container_process.py).

Reference: py/modal/container_process.py (_ContainerProcess) over
io_streams: stdout/stderr stream readers, an offset-resumed stdin writer,
wait/poll. Backed by the worker's task command router (the direct data
plane, no round trip through the control plane)."""

from __future__ import annotations

from typing import AsyncGenerator, Optional

from ._utils.async_utils import synchronize_api
from ._utils.router_client import TaskRouterClient
from .exception import InvalidError


class _ExecStreamReader:
    """Streamed stdout/stderr of an exec'd process; resumes by byte offset
    across dropped connections (router client handles the reconnect)."""

    def __init__(self, router: TaskRouterClient, exec_id: str, fd: int, text: bool = True):
        self._router = router
        self._exec_id = exec_id
        self._fd = fd
        self._text = text

    async def read(self):
        parts = []
        async for chunk in self._aiter():
            parts.append(chunk)
        return ("" if self._text else b"").join(parts)

    async def _aiter(self) -> AsyncGenerator:
        async for data in self._router.stdio_read(self._exec_id, self._fd):
            yield data.decode(errors="replace") if self._text else data

    def __aiter__(self):
        return self._aiter()

    def __iter__(self):
        # blocking surface: _aiter() resolves to a bridged sync generator
        # when called off the synchronizer loop
        return self._aiter()


class _ExecStreamWriter:
    """Offset-tracked stdin writer: retried flushes can't duplicate bytes
    (the router dedupes by offset)."""

    def __init__(self, router: TaskRouterClient, exec_id: str):
        self._router = router
        self._exec_id = exec_id
        self._buffer = bytearray()
        self._offset = 0  # bytes acked by the worker
        self._eof = False

    def write(self, data: "bytes | str") -> None:
        if self._eof:
            raise InvalidError("stdin is closed")
        self._buffer.extend(data.encode() if isinstance(data, str) else data)

    def write_eof(self) -> None:
        self._eof = True

    async def drain(self) -> None:
        # buffer stays intact until the worker acks: a failed drain can be
        # retried and the server's offset dedupe handles any overlap
        data = bytes(self._buffer)
        acked = await self._router.put_input(self._exec_id, data, self._offset, self._eof)
        consumed = max(0, acked - self._offset)
        del self._buffer[:consumed]
        self._offset = acked


class _ContainerProcess:
    """A process exec'd inside a running sandbox (reference
    container_process.py; created by `Sandbox.exec`, sandbox.py:1930)."""

    def __init__(self, router: TaskRouterClient, exec_id: str, text: bool = True):
        self._router = router
        self.exec_id = exec_id
        self._text = text
        self._stdout: Optional[_ExecStreamReader] = None
        self._stderr: Optional[_ExecStreamReader] = None
        self._stdin: Optional[_ExecStreamWriter] = None
        self._returncode: Optional[int] = None

    @property
    def stdout(self) -> _ExecStreamReader:
        if self._stdout is None:
            self._stdout = _ExecStreamReader(self._router, self.exec_id, 1, self._text)
        return self._stdout

    @property
    def stderr(self) -> _ExecStreamReader:
        if self._stderr is None:
            self._stderr = _ExecStreamReader(self._router, self.exec_id, 2, self._text)
        return self._stderr

    @property
    def stdin(self) -> _ExecStreamWriter:
        if self._stdin is None:
            self._stdin = _ExecStreamWriter(self._router, self.exec_id)
        return self._stdin

    @property
    def returncode(self) -> Optional[int]:
        return self._returncode

    async def wait(self) -> int:
        rc = await self._router.exec_wait(self.exec_id, timeout=None)
        self._returncode = rc
        return rc

    async def poll(self) -> Optional[int]:
        rc = await self._router.exec_wait(self.exec_id, timeout=0.0)
        if rc is not None:
            self._returncode = rc
        return rc

    async def pty_resize(self, rows: int, cols: int) -> None:
        """Propagate the client terminal's new window size (pty execs)."""
        await self._router.pty_resize(self.exec_id, rows, cols)


ContainerProcess = synchronize_api(_ContainerProcess)
ExecStreamReader = synchronize_api(_ExecStreamReader)
ExecStreamWriter = synchronize_api(_ExecStreamWriter)
