"""Typed filesystem ops in a sandbox and remote file handles (port of
modal_tpu/sandbox_fs.py).

Reference: py/modal/sandbox_fs.py (_SandboxFS) and py/modal/file_io.py
(_FileIO). Backed by the worker's task command router's `TaskFsOp` (the
direct data plane): one polymorphic op on the wire, typed methods on the
surface."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from ._utils.async_utils import synchronize_api
from ._utils.router_client import TaskRouterClient
from .exception import InvalidError


@dataclass
class FsEntry:
    name: str
    is_dir: bool
    size: int
    mode: int
    mtime: float


def _entry(pb) -> FsEntry:
    return FsEntry(name=pb.name, is_dir=pb.is_dir, size=pb.size, mode=pb.mode, mtime=pb.mtime)


class _SandboxFS:
    """Typed FS surface: paths resolve inside the sandbox (relative paths are
    relative to its workdir)."""

    def __init__(self, router: TaskRouterClient):
        self._router = router

    async def read_file(self, path: str, *, offset: int = 0, length: int = 0) -> bytes:
        resp = await self._router.fs_op(op="read", path=path, offset=offset, length=length)
        return resp.data

    async def read_text(self, path: str) -> str:
        return (await self.read_file(path)).decode()

    async def write_file(self, path: str, data: "bytes | str") -> None:
        payload = data.encode() if isinstance(data, str) else data
        await self._router.fs_op(op="write", path=path, data=payload)

    async def append_file(self, path: str, data: "bytes | str") -> None:
        payload = data.encode() if isinstance(data, str) else data
        await self._router.fs_op(op="append", path=path, data=payload)

    async def ls(self, path: str = ".") -> list[FsEntry]:
        resp = await self._router.fs_op(op="ls", path=path)
        return [_entry(e) for e in resp.entries]

    async def mkdir(self, path: str, *, parents: bool = False) -> None:
        await self._router.fs_op(op="mkdir", path=path, recursive=parents)

    async def rm(self, path: str, *, recursive: bool = False) -> None:
        await self._router.fs_op(op="rm", path=path, recursive=recursive)

    async def exists(self, path: str) -> bool:
        resp = await self._router.fs_op(op="stat", path=path)
        return resp.exists

    async def stat(self, path: str) -> Optional[FsEntry]:
        resp = await self._router.fs_op(op="stat", path=path)
        return _entry(resp.stat) if resp.exists else None

    async def mv(self, src: str, dest: str) -> None:
        await self._router.fs_op(op="mv", path=src, dest=dest)

    async def cp(self, src: str, dest: str) -> None:
        await self._router.fs_op(op="cp", path=src, dest=dest)

    async def open(self, path: str, mode: str = "r") -> "_FileIO":
        """Remote file handle (reference file_io.py `Sandbox.open`)."""
        f = _FileIO(self._router, path, mode)
        await f._initialize()
        return f


class _FileIO:
    """A remote file handle emulated over FS ops: reads pull ranged bytes,
    writes buffer locally and flush whole-file or append-only (reference
    file_io.py semantics at the API level)."""

    def __init__(self, router: TaskRouterClient, path: str, mode: str):
        if mode not in ("r", "rb", "w", "wb", "a", "ab"):
            raise InvalidError(f"unsupported mode {mode!r}")
        self._router = router
        self.path = path
        self.mode = mode
        self._text = "b" not in mode
        self._pos = 0
        self._buffer = bytearray()
        self._closed = False

    async def _initialize(self) -> None:
        if self.mode.startswith("r"):
            resp = await self._router.fs_op(op="stat", path=self.path)
            if not resp.exists:
                raise FileNotFoundError(self.path)
        elif self.mode.startswith("w"):
            await self._router.fs_op(op="write", path=self.path, data=b"")

    def _check_open(self) -> None:
        if self._closed:
            raise InvalidError("file is closed")

    async def read(self, size: int = 0):
        self._check_open()
        if not self.mode.startswith("r"):
            raise InvalidError(f"file opened for {self.mode!r}, not reading")
        resp = await self._router.fs_op(op="read", path=self.path, offset=self._pos, length=size)
        self._pos += len(resp.data)
        return resp.data.decode() if self._text else resp.data

    async def write(self, data: "bytes | str") -> int:
        self._check_open()
        if self.mode.startswith("r"):
            raise InvalidError("file opened for reading, not writing")
        payload = data.encode() if isinstance(data, str) else data
        self._buffer.extend(payload)
        return len(payload)

    async def flush(self) -> None:
        self._check_open()
        if self._buffer:
            await self._router.fs_op(op="append", path=self.path, data=bytes(self._buffer))
            self._buffer.clear()

    async def seek(self, pos: int, whence: int = os.SEEK_SET) -> int:
        self._check_open()
        if whence == os.SEEK_SET:
            self._pos = pos
        elif whence == os.SEEK_CUR:
            self._pos += pos
        else:
            resp = await self._router.fs_op(op="stat", path=self.path)
            self._pos = (resp.stat.size if resp.exists else 0) + pos
        return self._pos

    async def close(self) -> None:
        if not self._closed:
            await self.flush()
            self._closed = True

    async def __aenter__(self) -> "_FileIO":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()


SandboxFS = synchronize_api(_SandboxFS)
FileIO = synchronize_api(_FileIO)
