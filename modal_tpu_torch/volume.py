"""Volumes: shared, versioned file systems with commit and reload (port of
modal_tpu/volume.py).

Reference: py/modal/volume.py — `_Volume` (volume.py:351), commit/reload
(volume.py:739,757), batch upload with content-addressed blocks
(`_VolumeUploadContextManager2`, volume.py:1108), parallel block GET
(volume.py:881-948).

A file is a list of 8 MiB sha256 blocks in the plane's block store: a
training run's successive checkpoints upload only the blocks that changed,
and reads stripe over blocks. Reads take the fastest plane that works: a
client beside the store preads the block files in place (the plane
advertises its block dir, checked by opening the first block), else
per-block ranged GETs of the blob server's `/block` route land in the
caller's buffer through `sock_recv_into`, else the whole-file `/volfile`
route in large ranged parts, else VolumeBlockGet over gRPC. So
`read_file_range_into` fills a tensor's host buffer with no intermediate
copy (`models/weights.py` `VolumeSource`). A route that fails its retries
is not tried again by that handle.

Importing this module loads no torch: a container's function path stays
torch-free until its hello.
"""

from __future__ import annotations

import asyncio
import io
import os
from dataclasses import dataclass
from pathlib import Path, PurePosixPath
from typing import AsyncGenerator, BinaryIO, Optional, Union

from ._utils.async_utils import synchronize_api
from ._utils.grpc_utils import retry_transient_errors
from ._utils.hash_utils import BLOCK_SIZE, get_sha256_hex
from .client import _Client
from .exception import InvalidError, NotFoundError
from .object import LoadContext, Resolver, _Object, live_method, live_method_gen
from .proto import api_pb2

# concurrent block uploads and gRPC block reads
BLOCK_PARALLELISM = 16
# part size of the striped whole-file reads (GET /volfile with Range): large
# parts amortize the per-request cost; the server stitches the blocks
VOLFILE_PART_BYTES = 32 * 1024 * 1024
# concurrent per-block GETs received into the caller's buffer: each stream
# moves bytes at kernel speed, so a few saturate; more only thrash the loop
HTTP_BLOCK_PARALLELISM = 8


@dataclass
class FileEntry:
    path: str
    size: int
    mode: int
    mtime: float

    @classmethod
    def _from_proto(cls, p: api_pb2.VolumeFile) -> "FileEntry":
        return cls(path=p.path, size=p.size, mode=p.mode, mtime=p.mtime)


class _Volume(_Object, type_prefix="vo"):
    _metadata: Optional[api_pb2.VolumeMetadata] = None
    # per-plane health: set True after that HTTP route fails its retries so
    # the rest of the session sticks to the remaining planes instead of
    # paying a failed-HTTP round trip per block. Independent flags — a store
    # without /volfile can still serve /block, and vice versa.
    _block_http_down: bool = False
    _volfile_http_down: bool = False

    async def _fetch_block(
        self, sha: str, url_base: str = "", offset: int = 0, length: int = 0
    ) -> bytes:
        """One content block (or a sub-range of it): over the store's HTTP
        Range plane when advertised (no per-block gRPC proto copy; the bytes
        stream chunked from the store's sendfile loop), else VolumeBlockGet.
        `length == 0` means to end-of-block."""
        if url_base and not self._block_http_down:
            from ._utils.blob_utils import _get_range, _get_url
            from .exception import ExecutionError

            url = f"{url_base}/block/{sha}"
            try:
                if offset or length:
                    # open-ended length: blocks are ≤ BLOCK_SIZE, so a
                    # clamped Range to the block bound fetches the tail
                    stop = offset + length if length else BLOCK_SIZE
                    return await _get_range(url, offset, stop)
                return await _get_url(url)
            except ExecutionError:
                # store without the HTTP block plane (or it's unhealthy):
                # fall back to gRPC for the rest of this volume handle
                self._block_http_down = True
        r = await retry_transient_errors(
            self.client.stub.VolumeBlockGet,
            api_pb2.VolumeBlockGetRequest(sha256_hex=sha, offset=offset, length=length),
        )
        return r.data

    def _volfile_url(self, url_base: str, path: str) -> str:
        from urllib.parse import quote

        return f"{url_base}/volfile/{self.object_id}/{quote(path.lstrip('/'))}"

    def _usable_local_block_dir(self, resp, blocks: list, first_block: int) -> str:
        """The store's advertised block dir, IF this process can actually see
        it (co-located with the store): verified by probing the first needed
        block file, so a same-path-different-host coincidence can't serve
        garbage. Empty string = use the network planes."""
        d = getattr(resp, "block_local_dir", "")
        if not d or first_block >= len(blocks):
            return ""
        try:
            if os.path.isfile(os.path.join(d, blocks[first_block])):
                return d
        except OSError:
            pass
        return ""

    async def _read_blocks_local_into(
        self, block_dir: str, blocks: list, block_size: int, offset: int, end: int, dest
    ) -> int:
        """Co-located fast path: pread block files straight into `dest` —
        page cache → caller buffer at memory-bandwidth, no network hop at
        all. Runs in a worker thread so heartbeats never stall on IO."""

        def _run() -> int:
            written = 0
            first = offset // block_size
            last = min((end - 1) // block_size, len(blocks) - 1)
            for i in range(first, last + 1):
                block_lo = i * block_size
                lo = max(offset - block_lo, 0)
                hi = min(end - block_lo, block_size)
                pos = block_lo + lo - offset
                with open(os.path.join(block_dir, blocks[i]), "rb") as f:
                    f.seek(lo)
                    n = f.readinto(dest[pos : pos + hi - lo])
                if n < hi - lo:
                    raise OSError(f"short local block read {blocks[i]}: {n} < {hi - lo}")
                written += n
            return written

        return await asyncio.to_thread(_run)

    async def _read_blocks_http_into(
        self, url_base: str, blocks: list, block_size: int, offset: int, end: int, dest
    ) -> int:
        """Land [offset, end) of a file directly in `dest` (writable
        memoryview covering that range) via per-block sendfile GETs received
        with ``sock_recv_into`` — server and client both move bytes without
        userspace copies. Returns bytes written, or -1 after pinning this
        handle to the gRPC plane (store without the HTTP block routes)."""
        from ._utils.blob_utils import _get_range_into
        from .exception import ExecutionError

        sem = asyncio.Semaphore(HTTP_BLOCK_PARALLELISM)
        first = offset // block_size
        last = min((end - 1) // block_size, len(blocks) - 1)

        async def _one(i: int) -> int:
            block_lo = i * block_size
            lo = max(offset - block_lo, 0)
            hi = min(end - block_lo, block_size)
            pos = block_lo + lo - offset
            async with sem:
                await _get_range_into(
                    f"{url_base}/block/{blocks[i]}", lo, hi, dest[pos : pos + hi - lo]
                )
            return hi - lo

        results = await asyncio.gather(
            *[_one(i) for i in range(first, last + 1)], return_exceptions=True
        )
        errors = [r for r in results if isinstance(r, BaseException)]
        if not errors:
            return sum(results)
        for err in errors:
            if not isinstance(err, ExecutionError):
                raise err
        self._block_http_down = True
        return -1

    async def _read_range_http_striped(
        self, url_base: str, path: str, start: int, stop: int, write
    ) -> bool:
        """Stripe [start, stop) of a volume FILE over the store's whole-file
        Range route in VOLFILE_PART_BYTES parts — the server stitches content
        blocks, so a multi-GiB checkpoint moves with a handful of large GETs.
        `write(data, abs_offset)` lands each part. Returns False (and pins
        this handle to the gRPC block plane) if the route is unavailable."""
        from ._utils.blob_utils import _ByteBudget, _get_range, multipart_byte_budget
        from .exception import ExecutionError

        url = self._volfile_url(url_base, path)
        budget = _ByteBudget(multipart_byte_budget(), max_items=BLOCK_PARALLELISM)

        async def _part(lo: int) -> None:
            hi = min(lo + VOLFILE_PART_BYTES, stop)
            await budget.acquire(hi - lo)
            try:
                data = await _get_range(url, lo, hi)
                if len(data) != hi - lo:
                    raise ExecutionError(f"volfile range [{lo},{hi}) returned {len(data)} bytes")
                await write(data, lo)
            finally:
                await budget.release(hi - lo)

        results = await asyncio.gather(
            *[_part(lo) for lo in range(start, stop, VOLFILE_PART_BYTES)],
            return_exceptions=True,
        )
        errors = [r for r in results if isinstance(r, BaseException)]
        if not errors:
            return True
        for err in errors:
            if not isinstance(err, ExecutionError):
                raise err
        self._volfile_http_down = True  # store without the volfile route
        return False

    def _initialize_from_empty(self) -> None:
        self._metadata = None

    def _hydrate_metadata(self, metadata: Optional[api_pb2.VolumeMetadata]) -> None:
        self._metadata = metadata

    def _get_metadata(self) -> Optional[bytes]:
        return self._metadata.SerializeToString() if self._metadata else b""

    @classmethod
    def _deserialize_metadata(cls, metadata_bytes: bytes) -> Optional[api_pb2.VolumeMetadata]:
        return api_pb2.VolumeMetadata.FromString(metadata_bytes) if metadata_bytes else None

    @staticmethod
    def from_name(
        name: str,
        *,
        environment_name: Optional[str] = None,
        create_if_missing: bool = False,
        version: int = api_pb2.VOLUME_FS_VERSION_V2,
    ) -> "_Volume":
        async def _load(self: "_Volume", resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
            req = api_pb2.VolumeGetOrCreateRequest(
                deployment_name=name,
                environment_name=environment_name or context.environment_name,
                object_creation_type=(
                    api_pb2.OBJECT_CREATION_TYPE_CREATE_IF_MISSING
                    if create_if_missing
                    else api_pb2.OBJECT_CREATION_TYPE_UNSPECIFIED
                ),
                version=version,
            )
            resp = await retry_transient_errors(context.client.stub.VolumeGetOrCreate, req)
            self._hydrate(resp.volume_id, context.client, resp.metadata)

        return _Volume._from_loader(_load, f"Volume.from_name({name!r})", hydrate_lazily=True)

    @classmethod
    async def ephemeral(
        cls,
        client: Optional[_Client] = None,
        environment_name: Optional[str] = None,
    ) -> "_Volume":
        if client is None:
            client = await _Client.from_env()
        req = api_pb2.VolumeGetOrCreateRequest(
            object_creation_type=api_pb2.OBJECT_CREATION_TYPE_EPHEMERAL,
            environment_name=environment_name or "",
            version=api_pb2.VOLUME_FS_VERSION_V2,
        )
        resp = await retry_transient_errors(client.stub.VolumeGetOrCreate, req)
        return cls._new_hydrated_ephemeral(resp.volume_id, client, resp.metadata)

    @staticmethod
    async def lookup(name: str, *, client: Optional[_Client] = None, create_if_missing: bool = False) -> "_Volume":
        obj = _Volume.from_name(name, create_if_missing=create_if_missing)
        await obj.hydrate(client)
        return obj

    @staticmethod
    async def create_deployed(name: str, *, client: Optional[_Client] = None) -> str:
        obj = _Volume.from_name(name, create_if_missing=True)
        await obj.hydrate(client)
        return obj.object_id

    # -- data plane ---------------------------------------------------------

    @live_method
    async def commit(self) -> None:
        """Persist changes made in this container (reference volume.py:739)."""
        await retry_transient_errors(self.client.stub.VolumeCommit, api_pb2.VolumeCommitRequest(volume_id=self.object_id))

    @live_method
    async def reload(self) -> None:
        """See changes committed elsewhere (reference volume.py:757)."""
        await retry_transient_errors(self.client.stub.VolumeReload, api_pb2.VolumeReloadRequest(volume_id=self.object_id))

    @live_method_gen
    async def iterdir(self, path: str = "/", recursive: bool = True) -> AsyncGenerator[FileEntry, None]:
        resp = await retry_transient_errors(
            self.client.stub.VolumeListFiles,
            api_pb2.VolumeListFilesRequest(volume_id=self.object_id, path=path, recursive=recursive),
        )
        for f in resp.files:
            yield FileEntry._from_proto(f)

    @live_method
    async def listdir(self, path: str = "/", recursive: bool = False) -> list[FileEntry]:
        resp = await retry_transient_errors(
            self.client.stub.VolumeListFiles,
            api_pb2.VolumeListFilesRequest(volume_id=self.object_id, path=path, recursive=recursive),
        )
        return [FileEntry._from_proto(f) for f in resp.files]

    async def _get_file_meta(self, path: str) -> api_pb2.VolumeGetFile2Response:
        """Block list + block size for one file; NotFoundError if missing."""
        try:
            resp = await retry_transient_errors(
                self.client.stub.VolumeGetFile2,
                api_pb2.VolumeGetFile2Request(volume_id=self.object_id, path=path),
            )
        except NotFoundError:
            raise NotFoundError(f"file {path!r} not found in volume") from None
        if not resp.file.path:
            raise NotFoundError(f"file {path!r} not found in volume")
        return resp

    @live_method_gen
    async def read_file(self, path: str) -> AsyncGenerator[bytes, None]:
        """Stream a file's content block-by-block with parallel prefetch."""
        resp = await self._get_file_meta(path)
        blocks = list(resp.file.block_sha256_hex)
        url_base = resp.block_url_base

        async def _get(sha: str) -> bytes:
            return await self._fetch_block(sha, url_base)

        # Pipeline: fetch up to BLOCK_PARALLELISM blocks ahead, yield in order.
        pending: list[asyncio.Task] = []
        idx = 0
        while idx < len(blocks) or pending:
            while len(pending) < BLOCK_PARALLELISM and idx < len(blocks):
                pending.append(asyncio.ensure_future(_get(blocks[idx])))
                idx += 1
            data = await pending.pop(0)
            yield data

    @live_method
    async def read_file_into(self, path: str, fileobj: BinaryIO) -> int:
        """Stream a file into a caller-provided buffer/file object.

        Seekable targets get the striped engine: the destination is
        preallocated (truncate) and content blocks are fetched concurrently
        under the shared inflight `_ByteBudget`, each written at its own
        offset — the same parallel machinery `read_file` uses, pointed at a
        file instead of a generator. Non-seekable targets (pipes) fall back
        to the ordered sequential stream."""
        from ._utils.blob_utils import _ByteBudget, multipart_byte_budget

        resp = await self._get_file_meta(path)
        blocks = list(resp.file.block_sha256_hex)
        size = resp.file.size
        block_size = resp.block_size or BLOCK_SIZE
        try:
            seekable = fileobj.seekable()
        except AttributeError:
            seekable = False
        if not seekable or len(blocks) <= 1:
            total = 0
            async for chunk in self.read_file(path):
                fileobj.write(chunk)
                total += len(chunk)
            return total

        base = fileobj.tell()
        # preallocate by EXTENDING only: truncating a destination that
        # already has content past base+size would destroy caller data
        if hasattr(fileobj, "truncate"):
            try:
                cur_end = fileobj.seek(0, os.SEEK_END)
                if cur_end < base + size:
                    fileobj.truncate(base + size)
                fileobj.seek(base)
            except (OSError, io.UnsupportedOperation):
                pass
        budget = _ByteBudget(multipart_byte_budget(), max_items=BLOCK_PARALLELISM)
        url_base = resp.block_url_base
        # real files take lock-free positioned writes (pwrite); buffer-backed
        # file objects (BytesIO) serialize seek+write under the lock
        fd = None
        if hasattr(fileobj, "fileno"):
            try:
                fileobj.flush()
                fd = fileobj.fileno()
            except (OSError, io.UnsupportedOperation):
                fd = None
        lock = asyncio.Lock()  # seek+write must be atomic across part tasks

        async def _write_at(data: bytes, abs_off: int) -> None:
            if fd is not None:
                await asyncio.to_thread(os.pwrite, fd, data, base + abs_off)
            else:
                async with lock:
                    fileobj.seek(base + abs_off)
                    fileobj.write(data)

        # fast paths: real files are mmap'd and blocks land in the mapping —
        # from the co-located store's page cache (pread) or via per-block
        # sendfile GETs + sock_recv_into; other seekable targets stripe the
        # whole-file volfile route with large ranged GETs
        local_dir = self._usable_local_block_dir(resp, blocks, 0)
        http_ok = url_base and (not self._block_http_down or not self._volfile_http_down)
        if (local_dir or http_ok) and size > 0:
            if fd is not None:
                import mmap as _mmap

                done = False
                try:
                    # fails for write-only fds (open "wb") or when the
                    # preallocating truncate didn't stick — the pwrite
                    # paths below handle those fine
                    mm = _mmap.mmap(fd, base + size)
                except (OSError, ValueError):
                    mm = None
                if mm is not None:
                    try:
                        view = memoryview(mm)[base : base + size]
                        try:
                            if local_dir:
                                try:
                                    await self._read_blocks_local_into(
                                        local_dir, blocks, block_size, 0, size, view
                                    )
                                    done = True
                                except OSError:
                                    pass  # racing GC/partial store: use the network
                            if not done and url_base and not self._block_http_down:
                                done = (
                                    await self._read_blocks_http_into(
                                        url_base, blocks, block_size, 0, size, view
                                    )
                                    >= 0
                                )
                        finally:
                            view.release()
                    finally:
                        mm.close()
                if done:
                    fileobj.seek(base + size)
                    return size
            elif url_base and not self._volfile_http_down and await self._read_range_http_striped(
                url_base, path, 0, size, _write_at
            ):
                fileobj.seek(base + size)
                return size

        async def _fetch(i: int, sha: str) -> None:
            nbytes = min(block_size, max(0, size - i * block_size))
            await budget.acquire(nbytes)
            try:
                data = await self._fetch_block(sha, url_base)
                await _write_at(data, i * block_size)
            finally:
                await budget.release(nbytes)

        # settle every task before raising: a straggler pwrite into a file
        # the caller already closed (fd possibly reused) would corrupt data
        results = await asyncio.gather(
            *[_fetch(i, sha) for i, sha in enumerate(blocks)], return_exceptions=True
        )
        for r in results:
            if isinstance(r, BaseException):
                raise r
        fileobj.seek(base + size)
        return size

    @live_method
    async def read_file_range_into(self, path: str, offset: int, length: int, buf) -> int:
        """Fetch `length` bytes at `offset` straight into a caller-provided
        writable buffer (memoryview/bytearray/numpy view) — blocks land at
        their final positions concurrently, so the checkpoint loader fills a
        tensor's host buffer with zero intermediate copies. Returns bytes
        written (clamped at EOF)."""
        if offset < 0 or length < 0:
            raise ValueError(f"negative offset/length ({offset}, {length})")
        resp = await self._get_file_meta(path)
        if length == 0:
            return 0
        dest = memoryview(buf)
        if dest.readonly:
            raise ValueError("read_file_range_into requires a writable buffer")
        dest = dest.cast("B")
        if dest.nbytes < length:
            raise ValueError(f"buffer too small: {dest.nbytes} < {length}")
        block_size = resp.block_size or BLOCK_SIZE
        blocks = list(resp.file.block_sha256_hex)
        first = offset // block_size
        last = min((offset + length - 1) // block_size, len(blocks) - 1)
        if first >= len(blocks):
            return 0

        # fast paths: co-located stores pread into the caller's buffer from
        # page cache; remote ones get per-block sendfile GETs received via
        # sock_recv_into — no proto copies, no joins either way
        stop = min(offset + length, resp.file.size)
        if stop <= offset:
            return 0
        local_dir = self._usable_local_block_dir(resp, blocks, first)
        if local_dir:
            try:
                return await self._read_blocks_local_into(
                    local_dir, blocks, block_size, offset, stop, dest
                )
            except OSError:
                pass  # racing GC/partial store: drop to the network planes
        if resp.block_url_base and not self._block_http_down:
            written_http = await self._read_blocks_http_into(
                resp.block_url_base, blocks, block_size, offset, stop, dest
            )
            if written_http >= 0:
                return written_http

        sem = asyncio.Semaphore(BLOCK_PARALLELISM)
        end = offset + length  # absolute; may exceed EOF (clamped per block)
        url_base = resp.block_url_base
        written = 0

        async def _get(i: int) -> None:
            nonlocal written
            # sub-block range: only the overlapping bytes travel
            block_lo = i * block_size
            lo = max(offset - block_lo, 0)
            hi = min(end - block_lo, block_size)
            async with sem:
                data = await self._fetch_block(blocks[i], url_base, offset=lo, length=hi - lo)
            pos = block_lo + lo - offset
            dest[pos : pos + len(data)] = data
            written += len(data)

        # settle every task before raising: stragglers hold slices of the
        # caller's buffer and must not write into it after we return
        results = await asyncio.gather(
            *[_get(i) for i in range(first, last + 1)], return_exceptions=True
        )
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return written

    @live_method
    async def read_file_range(self, path: str, offset: int, length: int) -> bytes:
        """Read `length` bytes at `offset` fetching ONLY the needed byte
        ranges (sub-block offset/length on the first and last block) — the
        primitive behind checkpoint→device streaming (models/weights.py reads
        one tensor's bytes out of a multi-GiB safetensors shard without
        materializing the file). `length == 0` still validates existence
        (raises NotFoundError) — used as a metadata-only stat.

        Single allocation: blocks land concurrently at their final offsets
        in one preallocated buffer (via the `_into` engine) instead of being
        gathered and joined (which peaked at 2× the range size)."""
        if offset < 0 or length < 0:
            raise ValueError(f"negative offset/length ({offset}, {length})")
        if length == 0:
            await self._get_file_meta(path)  # still validates existence
            return b""
        out = bytearray(length)
        written = await self.read_file_range_into(path, offset, length, out)
        # clamped at EOF: copy the written part, never resize `out`. A view
        # of it the striped read made may still be alive in a reference
        # cycle until the collector runs, and resizing a buffer with a live
        # view raises BufferError (the JAX package's `del out[written:]`
        # does, ROADMAP Queue C 29)
        return bytes(out) if written == length else bytes(out[:written])

    @live_method
    async def remove_file(self, path: str, recursive: bool = False) -> None:
        await retry_transient_errors(
            self.client.stub.VolumeRemoveFile,
            api_pb2.VolumeRemoveFileRequest(volume_id=self.object_id, path=path, recursive=recursive),
        )

    @live_method
    async def copy_files(self, src_paths: list[str], dst_path: str) -> None:
        await retry_transient_errors(
            self.client.stub.VolumeCopyFiles,
            api_pb2.VolumeCopyFilesRequest(volume_id=self.object_id, src_paths=src_paths, dst_path=dst_path),
        )

    def batch_upload(self, force: bool = False) -> "_VolumeUploadContextManager":
        """Batched, block-deduplicated parallel upload (reference
        volume.py:1012 `batch_upload` → `_VolumeUploadContextManager2`)."""
        return _VolumeUploadContextManager(self, force=force)

    @staticmethod
    async def delete(name: str, *, client: Optional[_Client] = None, environment_name: Optional[str] = None) -> None:
        obj = await _Volume.lookup(name, client=client)
        await retry_transient_errors(obj.client.stub.VolumeDelete, api_pb2.VolumeDeleteRequest(volume_id=obj.object_id))

    @staticmethod
    async def rename(old_name: str, new_name: str, *, client: Optional[_Client] = None) -> None:
        obj = await _Volume.lookup(old_name, client=client)
        await retry_transient_errors(
            obj.client.stub.VolumeRename, api_pb2.VolumeRenameRequest(volume_id=obj.object_id, name=new_name)
        )


class _VolumeUploadContextManager:
    """Collects upload specs, then pushes missing blocks in parallel on exit
    (reference _VolumeUploadContextManager2, volume.py:1108: put files → server
    returns missing block hashes → parallel block PUT → re-put)."""

    def __init__(self, volume: _Volume, force: bool = False):
        self._volume = volume
        self._force = force
        self._entries: list[tuple[str, Union[str, Path, bytes]]] = []

    async def __aenter__(self) -> "_VolumeUploadContextManager":
        return self

    def put_file(self, local_file: Union[str, Path, BinaryIO], remote_path: str) -> None:
        self._entries.append((remote_path, local_file))  # type: ignore[arg-type]

    def put_data(self, data: Union[bytes, bytearray, memoryview], remote_path: str) -> None:
        """Queue bytes (any contiguous buffer, held by reference, not
        copied) for upload at exit."""
        self._entries.append((remote_path, data))

    def put_directory(self, local_path: Union[str, Path], remote_path: str, recursive: bool = True) -> None:
        local_path = Path(local_path)
        for p in local_path.rglob("*") if recursive else local_path.glob("*"):
            if p.is_file():
                rel = p.relative_to(local_path)
                self._entries.append((str(PurePosixPath(remote_path) / PurePosixPath(*rel.parts)), p))

    async def __aexit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            return
        client = self._volume.client
        files: list[api_pb2.VolumeFile] = []
        block_data: dict[str, tuple] = {}  # sha -> (source, offset, length)

        from ._utils.hash_utils import get_blocks_sha256

        for remote_path, src in self._entries:
            if isinstance(src, (bytes, bytearray, memoryview)):
                src = memoryview(src).cast("B")
                size = src.nbytes
                mode = 0o644
                # one block's bytes for its VolumeBlockPut
                reader = lambda off, ln, s=src: bytes(s[off : off + ln])
                # hot path (checkpoint put_data): hash all blocks in one call,
                # off the loop (hashlib releases the GIL)
                shas = await asyncio.to_thread(get_blocks_sha256, src, BLOCK_SIZE)
                for i, sha in enumerate(shas):
                    block_data[sha] = (reader, i * BLOCK_SIZE, min(BLOCK_SIZE, max(0, size - i * BLOCK_SIZE)))
                files.append(
                    api_pb2.VolumeFile(path=remote_path.lstrip("/"), size=size, mode=mode, block_sha256_hex=shas)
                )
                continue
            else:
                path = Path(src) if isinstance(src, (str, Path)) else None
                if path is not None:
                    size = path.stat().st_size
                    mode = path.stat().st_mode & 0o7777
                    reader = lambda off, ln, p=path: _read_range(p, off, ln)
                else:  # file object
                    src.seek(0, os.SEEK_END)
                    size = src.tell()
                    src.seek(0)
                    mode = 0o644
                    reader = lambda off, ln, f=src: _read_fileobj_range(f, off, ln)
            if path is not None:
                # whole-file block hashing in one call (native threaded
                # pread engine when opted in — no per-block Python bytes)
                from ._utils.hash_utils import get_file_blocks_sha256

                shas = await asyncio.to_thread(get_file_blocks_sha256, path, BLOCK_SIZE)
                for i, sha in enumerate(shas):
                    off = i * BLOCK_SIZE
                    block_data[sha] = (reader, off, min(BLOCK_SIZE, max(0, size - off)))
            else:
                shas = []
                off = 0
                while off < size or (size == 0 and off == 0):
                    ln = min(BLOCK_SIZE, size - off)
                    data = reader(off, ln)
                    sha = get_sha256_hex(data)
                    shas.append(sha)
                    block_data[sha] = (reader, off, ln)
                    off += BLOCK_SIZE
                    if size == 0:
                        break
            files.append(
                api_pb2.VolumeFile(
                    path=remote_path.lstrip("/"), size=size, mode=mode, block_sha256_hex=shas
                )
            )

        put_req = api_pb2.VolumePutFiles2Request(
            volume_id=self._volume.object_id, files=files, disallow_overwrite_existing_files=not self._force
        )
        resp = await retry_transient_errors(client.stub.VolumePutFiles2, put_req)
        missing = list(resp.missing_blocks)
        if missing:
            sem = asyncio.Semaphore(BLOCK_PARALLELISM)

            async def _put(sha: str) -> None:
                reader, off, ln = block_data[sha]
                async with sem:
                    # the block's read (or copy) off the loop, so the puts overlap
                    data = await asyncio.to_thread(reader, off, ln)
                    await retry_transient_errors(
                        client.stub.VolumeBlockPut, api_pb2.VolumeBlockPutRequest(sha256_hex=sha, data=data)
                    )

            await asyncio.gather(*[_put(sha) for sha in missing])
            resp = await retry_transient_errors(client.stub.VolumePutFiles2, put_req)
            if resp.missing_blocks:
                raise InvalidError(f"blocks still missing after upload: {resp.missing_blocks[:3]}...")


def _read_range(path: Path, offset: int, length: int) -> bytes:
    with open(path, "rb") as f:
        f.seek(offset)
        return f.read(length)


def _read_fileobj_range(f: BinaryIO, offset: int, length: int) -> bytes:
    f.seek(offset)
    return f.read(length)


Volume = synchronize_api(_Volume)
VolumeUploadContextManager = synchronize_api(_VolumeUploadContextManager)
