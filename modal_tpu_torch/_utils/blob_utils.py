"""Blob store client: large payloads move over HTTP, not gRPC (port of
modal_tpu/_utils/blob_utils.py).

Reference: py/modal/_utils/blob_utils.py — 2 MiB inline limit
(MAX_OBJECT_SIZE_BYTES, blob_utils.py:36), multipart over 1 GiB
(blob_utils.py:54), memory-budgeted uploads (`_ByteBudget`, blob_utils.py:66),
`blob_upload`/`blob_download` (blob_utils.py:364).

Zero-copy data plane: uploads accept segment lists (serialization.Payload)
and file objects and stream them to the socket — hashing happens over the
same pass, so a multi-GiB payload is never joined into one bytes object.
Downloads over ``DOWNLOAD_SPILL_BYTES`` spill to a temp file via
parallel HTTP Range part-GETs (bounded by the shared ``_ByteBudget``) and
return an mmap-backed memoryview instead of ``bytes`` — the container-side
args fetch deserializes tensors straight out of the page cache.

Handoff by path: a client beside the blob store (its stub carries the
`blob_local_dir` the server advertised, stat-checked by the client) writes
a payload straight into the store (tmp file, then rename) and reads one in
place, an mmap over the store's file for a large payload: no HTTP hop.
`MODAL_TPU_FASTPATH_BLOB=0` (or `MODAL_TPU_FASTPATH=0`) sends every blob over
HTTP. Both ways land in the same file, so a blob id resolves either way.
"""

from __future__ import annotations

import asyncio
import mmap
import os
import random
import tempfile
from typing import AsyncIterator, BinaryIO, Optional, Union

from ..config import logger
from ..exception import ExecutionError
from ..proto import api_pb2
from .grpc_utils import retry_transient_errors
from .hash_utils import get_upload_hashes

# Inline payload limit: above this, args/results go through the blob store
# (reference blob_utils.py:36).
MAX_OBJECT_SIZE_BYTES = 2 * 1024 * 1024
# Multipart threshold + parallelism (reference blob_utils.py:54,46), and the
# part length the control plane plans (at most 10k parts). The threshold and
# the spill below are read at each call, so a test may lower them.
MULTIPART_THRESHOLD = 1024 * 1024 * 1024
MULTIPART_CONCURRENCY = 20
MULTIPART_PART_BYTES = 64 * 1024 * 1024
# Downloads at/above this spill to disk and come back as an mmap-backed view.
DOWNLOAD_SPILL_BYTES = 32 * 1024 * 1024
# Ranged part-GET fan-out for spilled downloads.
RANGE_PART_BYTES = 16 * 1024 * 1024
RANGE_CONCURRENCY = 8


# Inflight memory budget for map pumping / uploads (reference
# blob_utils.py:57-59: min 256 MiB, max 2 GiB, <=50% of RAM).
DEFAULT_BYTE_BUDGET = 256 * 1024 * 1024
MULTIPART_INFLIGHT_BYTES_MIN = 256 * 1024 * 1024
MULTIPART_INFLIGHT_BYTES_MAX = 2 * 1024**3
MULTIPART_INFLIGHT_MEMORY_FRACTION = 0.5


def multipart_byte_budget() -> int:
    """min 256 MiB, max 2 GiB, at most 50% of system RAM (reference
    blob_utils.py:57-59)."""
    try:
        ram = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        ram = 8 * 1024**3
    return int(
        min(
            MULTIPART_INFLIGHT_BYTES_MAX,
            max(MULTIPART_INFLIGHT_BYTES_MIN, ram * MULTIPART_INFLIGHT_MEMORY_FRACTION),
        )
    )


class _ByteBudget:
    """Async byte-count backpressure (reference _ByteBudget,
    blob_utils.py:66): acquire(n) blocks while the inflight total would
    exceed the budget (or, with max_items, the inflight count reach it);
    release(n) frees it. A single item larger than the whole budget is
    admitted alone rather than deadlocking."""

    def __init__(self, budget: int = DEFAULT_BYTE_BUDGET, max_items: int = 0):
        self._budget = budget
        self._max_items = max_items  # 0 = unlimited
        self._inflight_bytes = 0
        self._inflight_items = 0
        self._condition = asyncio.Condition()

    def would_block(self, nbytes: int) -> bool:
        return (self._inflight_bytes + nbytes > self._budget and self._inflight_items > 0) or bool(
            self._max_items and self._inflight_items >= self._max_items
        )

    async def acquire(self, nbytes: int) -> None:
        async with self._condition:
            while self.would_block(nbytes):
                await self._condition.wait()
            self._inflight_bytes += nbytes
            self._inflight_items += 1

    async def release(self, nbytes: int) -> None:
        async with self._condition:
            self._inflight_bytes -= nbytes
            self._inflight_items -= 1
            self._condition.notify_all()


_http_session: Optional["object"] = None
_http_session_loop = None


def _get_http_session():
    """Lazily create one aiohttp session per event loop (closed at
    interpreter exit to avoid connector leaks)."""
    global _http_session, _http_session_loop
    import aiohttp

    loop = asyncio.get_running_loop()
    if _http_session is None or _http_session_loop is not loop or _http_session.closed:
        _http_session = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=3600, connect=30),
            # multi-MiB payloads: the default 64 KiB read buffer makes the
            # parser run per-64KiB — 4 MiB cuts per-chunk Python overhead
            # to noise on the GB/s streaming paths
            read_bufsize=4 * 1024 * 1024,
            auto_decompress=False,
        )
        _http_session_loop = loop
    return _http_session


def _close_session_at_exit() -> None:
    global _http_session
    if _http_session is not None and not _http_session.closed and _http_session_loop is not None:
        if _http_session_loop.is_running():
            asyncio.run_coroutine_threadsafe(_http_session.close(), _http_session_loop).result(5)
        _http_session = None


import atexit  # noqa: E402

atexit.register(_close_session_at_exit)


def _transient_http_errors() -> tuple:
    import aiohttp

    # aiohttp transient errors (ServerDisconnectedError etc.) are NOT OSError
    # subclasses — they must be caught explicitly or a dropped keep-alive
    # connection fails the call without retry.
    return (OSError, asyncio.TimeoutError, aiohttp.ClientError)


# HTTP statuses worth retrying: overload/unavailable (503, chaos-injected
# included), throttling (429), and transient gateway errors (500/502/504) —
# the store analogue of RETRYABLE_GRPC_STATUS_CODES
RETRYABLE_HTTP_STATUSES = frozenset({429, 500, 502, 503, 504})


async def _retry_sleep(attempt: int) -> None:
    # equal jitter, same rationale as retry_transient_errors: blob clients
    # recovering from one outage must not retry in lockstep
    await asyncio.sleep(0.2 * 2**attempt * (0.5 + random.random() * 0.5))


def _slice_segments(segments: list, offset: int, length: int) -> list[memoryview]:
    """Zero-copy sub-range [offset, offset+length) across a segment list."""
    out: list[memoryview] = []
    pos = 0
    end = offset + length
    for seg in segments:
        n = len(seg)
        if pos + n > offset and pos < end:
            lo = max(0, offset - pos)
            hi = min(n, end - pos)
            out.append(memoryview(seg)[lo:hi])
        pos += n
        if pos >= end:
            break
    return out


async def _segment_stream(segments: list, chunk: int = 1024 * 1024) -> AsyncIterator[bytes]:
    """Feed segments to aiohttp in bounded chunks: large borrowed memoryviews
    stream straight from the source buffer to the socket (chunked encoding),
    the only full-size copy being the kernel write."""
    for seg in segments:
        view = memoryview(seg)
        for off in range(0, view.nbytes, chunk):
            yield view[off : off + chunk]


async def _put_url(url: str, data: Union[bytes, list]) -> None:
    """PUT bytes or a segment list. Segment lists stream (no join); each
    retry attempt restarts the stream from the original segments."""
    session = _get_http_session()
    for attempt in range(4):
        try:
            body = data if isinstance(data, (bytes, bytearray, memoryview)) else _segment_stream(data)
            async with session.put(url, data=body) as resp:
                if resp.status in (200, 204):
                    return
                text = await resp.text()
                if resp.status in RETRYABLE_HTTP_STATUSES and attempt < 3:
                    await _retry_sleep(attempt)
                    continue
                raise ExecutionError(f"blob PUT failed: HTTP {resp.status} {text[:200]}")
        except _transient_http_errors() as exc:
            if attempt == 3:
                raise ExecutionError(f"blob PUT failed after retries: {exc}") from exc
            await _retry_sleep(attempt)


async def _get_url(url: str) -> bytes:
    session = _get_http_session()
    for attempt in range(4):
        try:
            async with session.get(url) as resp:
                if resp.status == 200:
                    return await resp.read()
                body = await resp.text()
                if resp.status in RETRYABLE_HTTP_STATUSES and attempt < 3:
                    await _retry_sleep(attempt)
                    continue
                raise ExecutionError(f"blob GET failed: HTTP {resp.status} {body[:200]}")
        except _transient_http_errors() as exc:
            if attempt == 3:
                raise ExecutionError(f"blob GET failed after retries: {exc}") from exc
            await _retry_sleep(attempt)
    raise ExecutionError("unreachable")


async def _get_range_into(url: str, start: int, stop: int, dest: "memoryview") -> None:
    """Ranged GET that lands the body DIRECTLY in `dest` (writable
    memoryview of len stop-start) via ``sock_recv_into`` — no HTTP parser
    allocations, no intermediate chunk bytes; the kernel copies straight
    into the caller's tensor/file buffer. Retries like _get_range."""
    import socket
    from urllib.parse import urlsplit

    u = urlsplit(url)
    port = u.port or (443 if u.scheme == "https" else 80)
    if u.scheme != "http":
        raise ExecutionError(f"raw ranged GET supports http:// only, got {url}")
    loop = asyncio.get_running_loop()
    want = stop - start
    req = (
        f"GET {u.path or '/'} HTTP/1.1\r\nHost: {u.hostname}:{port}\r\n"
        f"Range: bytes={start}-{stop - 1}\r\nConnection: close\r\n\r\n"
    ).encode()
    for attempt in range(4):
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        try:
            await loop.sock_connect(sock, (u.hostname, port))
            await loop.sock_sendall(sock, req)
            # read until end of headers; the tail after CRLFCRLF is body
            head = bytearray()
            while b"\r\n\r\n" not in head:
                chunk = await loop.sock_recv(sock, 65536)
                if not chunk:
                    # retryable (ConnectionError is in the transient set):
                    # a dropped keep-alive must not look like a missing route
                    raise ConnectionError("connection closed before headers")
                head += chunk
                if len(head) > 65536:
                    raise ExecutionError("oversized response headers")
            header_blob, _, tail = bytes(head).partition(b"\r\n\r\n")
            lines = header_blob.split(b"\r\n")
            status = int(lines[0].split(b" ", 2)[1])
            headers = {
                k.strip().lower(): v.strip()
                for k, v in (ln.split(b":", 1) for ln in lines[1:] if b":" in ln)
            }
            if status in RETRYABLE_HTTP_STATUSES and attempt < 3:
                sock.close()
                await _retry_sleep(attempt)
                continue
            if status not in (200, 206):
                raise ExecutionError(f"blob ranged GET failed: HTTP {status}")
            clen = int(headers.get(b"content-length", b"-1"))
            if clen != want:
                raise ExecutionError(f"ranged GET returned {clen} bytes for [{start},{stop})")
            got = min(len(tail), want)
            dest[:got] = tail[:got]
            while got < want:
                n = await loop.sock_recv_into(sock, dest[got:want])
                if n == 0:
                    # mid-body disconnect: retryable, the next attempt
                    # rewrites dest from the start of the range
                    raise ConnectionError(f"connection closed at {got}/{want} bytes")
                got += n
            return
        except _transient_http_errors() as exc:
            if attempt == 3:
                raise ExecutionError(f"blob ranged GET failed after retries: {exc}") from exc
            await _retry_sleep(attempt)
        finally:
            sock.close()
    raise ExecutionError("unreachable")


async def _get_range(url: str, start: int, stop: int) -> bytes:
    """GET bytes [start, stop) via an HTTP Range request (expects 206)."""
    session = _get_http_session()
    headers = {"Range": f"bytes={start}-{stop - 1}"}
    for attempt in range(4):
        try:
            async with session.get(url, headers=headers) as resp:
                if resp.status == 206:
                    return await resp.read()
                # bounded error peek: a store that ignores Range answers 200
                # with the FULL body — never read (or utf-8 decode) it all
                body = (await resp.content.read(200)).decode("utf-8", "replace")
                if resp.status in RETRYABLE_HTTP_STATUSES and attempt < 3:
                    await _retry_sleep(attempt)
                    continue
                raise ExecutionError(
                    f"blob ranged GET failed: HTTP {resp.status} {body[:200]}"
                )
        except _transient_http_errors() as exc:
            if attempt == 3:
                raise ExecutionError(f"blob ranged GET failed after retries: {exc}") from exc
            await _retry_sleep(attempt)
    raise ExecutionError("unreachable")


def _blob_local_dir(stub) -> str:
    """The co-located blob store the stub carries (the server's ClientHello
    advertisement, or a container's env), when this process can see it and
    the handoff by path is on; "" otherwise."""
    from .local_transport import blob_local_enabled

    if not blob_local_enabled():
        return ""
    path = getattr(stub, "_blob_local_dir", "")
    return path if path and os.path.isdir(path) else ""


async def _blob_local_write(local_dir: str, blob_id: str, source) -> None:
    """Handoff by path: the payload's segments land straight in the
    server's store (tmp file, then rename: the server only ever sees
    complete blobs). `source` is a segment list or a seekable file object."""
    path = os.path.join(local_dir, blob_id)
    tmp = f"{path}.tmp-{os.getpid()}-{id(source):x}"

    def _write() -> None:
        with open(tmp, "wb") as f:
            if isinstance(source, list):
                for seg in source:
                    f.write(seg)
            else:
                import shutil

                source.seek(0)
                shutil.copyfileobj(source, f, 8 * 1024 * 1024)
        os.replace(tmp, path)

    try:
        await asyncio.to_thread(_write)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _note_blob_rung(stub, name: str) -> None:
    from .local_transport import note_rung

    note_rung(stub, name, "blob_local")


async def blob_upload(payload: Union[bytes, bytearray, memoryview, BinaryIO, "object"], stub) -> str:
    """Upload a payload, returning its blob_id (reference blob_utils.py:364).

    Accepts bytes, a seekable file object, or anything with a ``.segments``
    list (serialization.Payload). Segment payloads hash and stream without
    ever being joined; file objects stream part-by-part under the same
    budget. A client beside the store writes the file into it instead of
    PUTting it over HTTP."""
    def _as_byte_seg(seg):
        # memoryviews may carry a multi-byte format (e.g. a float32 array
        # view) where len() counts ELEMENTS; cast to "B" so hashing,
        # content_length, and slicing all agree on bytes
        return memoryview(seg).cast("B") if isinstance(seg, memoryview) else seg

    segments: Optional[list] = None
    if isinstance(payload, (bytes, bytearray, memoryview)):
        segments = [_as_byte_seg(payload)]
    elif hasattr(payload, "segments"):
        segments = [_as_byte_seg(s) for s in payload.segments]
    if segments is not None:
        hashes = get_upload_hashes(segments)
    else:
        hashes = get_upload_hashes(payload)
    req = api_pb2.BlobCreateRequest(
        content_sha256_base64=hashes.sha256_base64, content_length=hashes.content_length
    )
    resp = await retry_transient_errors(stub.BlobCreate, req)
    local_dir = _blob_local_dir(stub)
    if local_dir:
        try:
            await _blob_local_write(local_dir, resp.blob_id, segments if segments is not None else payload)
            _note_blob_rung(stub, "BlobUpload")
            return resp.blob_id
        except OSError as exc:
            # the store is not writable from here after all (permissions, a
            # stale advertisement): HTTP from now on
            logger.warning(f"local blob write failed ({exc}); using HTTP upload")
            stub._blob_local_dir = ""
    which = resp.WhichOneof("upload_type_oneof")
    if which == "multipart":
        await _multipart_upload(payload if segments is None else segments, resp.multipart)
    elif segments is not None:
        await _put_url(resp.upload_url, segments)
    else:
        payload.seek(0)
        await _put_url(resp.upload_url, payload.read())
    return resp.blob_id


async def _multipart_upload(source: Union[BinaryIO, list], mp: api_pb2.MultiPartUpload) -> None:
    """Parallel part PUTs, bounded by BOTH the 20-way concurrency cap and
    the RAM-aware inflight byte budget (reference perform_multipart_upload
    blob_utils.py:166 + _ByteBudget blob_utils.py:57-66). Segment-list
    sources slice zero-copy views per part; file objects read per part under
    a lock."""
    sem = asyncio.Semaphore(MULTIPART_CONCURRENCY)
    budget = _ByteBudget(multipart_byte_budget())
    is_segments = isinstance(source, list)
    lock = asyncio.Lock()  # buf.seek/read must be atomic across part tasks

    async def _part(i: int, url: str) -> None:
        async with sem:
            await budget.acquire(mp.part_length)
            try:
                if is_segments:
                    data: Union[bytes, list] = _slice_segments(source, i * mp.part_length, mp.part_length)
                else:
                    async with lock:
                        source.seek(i * mp.part_length)
                        data = source.read(mp.part_length)
                await _put_url(url, data)
                del data
            finally:
                await budget.release(mp.part_length)

    await asyncio.gather(*[_part(i, url) for i, url in enumerate(mp.upload_urls)])
    if mp.completion_url:
        await _put_url(mp.completion_url, b"")


async def _download_spilled(url: str, size: int) -> memoryview:
    """Parallel ranged part-GETs into a preallocated temp file; returns an
    mmap-backed read-only view. The file is unlinked immediately after
    mapping (pages stay valid; disk space is reclaimed on release), so the
    payload lives in page cache, not anonymous RSS."""
    fd, tmp_path = tempfile.mkstemp(prefix="modal-tpu-blob-")
    try:
        os.ftruncate(fd, size)
        sem = asyncio.Semaphore(RANGE_CONCURRENCY)
        budget = _ByteBudget(multipart_byte_budget())

        async def _part(start: int) -> None:
            stop = min(start + RANGE_PART_BYTES, size)
            async with sem:
                await budget.acquire(stop - start)
                try:
                    data = await _get_range(url, start, stop)
                    if len(data) != stop - start:
                        raise ExecutionError(
                            f"ranged GET returned {len(data)} bytes for [{start},{stop})"
                        )
                    await asyncio.to_thread(os.pwrite, fd, data, start)
                finally:
                    await budget.release(stop - start)

        # settle EVERY part before touching the fd: closing it while a
        # straggler pwrite is in flight would hit EBADF — or, if the fd
        # number got reused, write blob bytes into an unrelated file
        results = await asyncio.gather(
            *[_part(s) for s in range(0, size, RANGE_PART_BYTES)], return_exceptions=True
        )
        for r in results:
            if isinstance(r, BaseException):
                raise r
        mm = mmap.mmap(fd, size, access=mmap.ACCESS_READ)
    finally:
        os.close(fd)
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
    from ..observability.catalog import BLOB_SPILLS

    BLOB_SPILLS.inc()
    return memoryview(mm)


async def _get_url_or_size(url: str, threshold: int) -> Union[bytes, int]:
    """GET the url, but if the response's Content-Length is at/over
    `threshold`, abandon the body and return the size so the caller can
    switch to the parallel ranged spill path. Small payloads complete in
    this single request — no extra HEAD round trip on the hot path."""
    session = _get_http_session()
    for attempt in range(4):
        try:
            async with session.get(url) as resp:
                if resp.status == 200:
                    clen = int(resp.headers.get("Content-Length") or -1)
                    if clen >= threshold:
                        resp.close()  # drop the stream; ranged fetch takes over
                        return clen
                    return await resp.read()
                body = await resp.text()
                if resp.status in RETRYABLE_HTTP_STATUSES and attempt < 3:
                    await _retry_sleep(attempt)
                    continue
                raise ExecutionError(f"blob GET failed: HTTP {resp.status} {body[:200]}")
        except _transient_http_errors() as exc:
            if attempt == 3:
                raise ExecutionError(f"blob GET failed after retries: {exc}") from exc
            await _retry_sleep(attempt)
    raise ExecutionError("unreachable")


async def blob_download(blob_id: str, stub) -> Union[bytes, memoryview]:
    """Download a blob. Payloads at/above the spill threshold stream to disk
    via parallel Range GETs and come back as an mmap-backed memoryview (the
    deserializer reads tensors straight out of it, zero-copy); smaller ones
    return plain bytes as before — in a single request. A client beside the
    store opens the blob's file in place instead, a large one as an mmap
    over the store's own file (a page-cache read, no HTTP bytes)."""
    local_dir = _blob_local_dir(stub)
    if local_dir:
        path = os.path.join(local_dir, blob_id)
        try:
            size = os.path.getsize(path)

            def _read():
                with open(path, "rb") as f:
                    if size >= DOWNLOAD_SPILL_BYTES:
                        return memoryview(mmap.mmap(f.fileno(), size, access=mmap.ACCESS_READ))
                    return f.read()

            data = await asyncio.to_thread(_read)
            _note_blob_rung(stub, "BlobDownload")
            return data
        except OSError:
            pass  # not there or unreadable: the HTTP path below is the truth
    resp = await retry_transient_errors(stub.BlobGet, api_pb2.BlobGetRequest(blob_id=blob_id))
    url = resp.download_url
    got = await _get_url_or_size(url, DOWNLOAD_SPILL_BYTES)
    if isinstance(got, int):
        return await _download_spilled(url, got)
    return got


async def resolve_blob_data(msg, stub) -> Union[bytes, memoryview]:
    """The payload of any message with data/data_blob_id: inline, or fetched
    from the blob store."""
    which = msg.WhichOneof("data_oneof") if hasattr(msg, "WhichOneof") else None
    if which == "data_blob_id" or (which is None and getattr(msg, "data_blob_id", "")):
        return await blob_download(msg.data_blob_id, stub)
    return msg.data
