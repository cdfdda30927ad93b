"""HTTP blob store (port of modal_tpu/server/blob_server.py): payloads over
2 MiB bypass gRPC, as with S3 presigned URLs, and the fleet compile cache
rides the same plane.

Routes: blob PUT and GET (HTTP Range, sendfile), multipart part PUTs and
their completion, the compile cache's entries (`/compile/<key>`), a volume's
content blocks (`/block/<sha256>`, sendfile with Range) and whole volume
files (`/volfile/<volume_id>/<path>`, the blocks stitched on the server,
with Range), and the metrics plane: `/metrics` (the process registry as
Prometheus text, or OpenMetrics with exemplars by `Accept` or
`?format=openmetrics`) and `/metrics/history` (server/history.py's queries,
as the MetricsHistory RPC answers them). At boot the server writes the
scrape URL to `<state_dir>/observability/metrics_url`. The token flow's
browser leg (`/auth/token-flow/<flow_id>?code=...`) approves a pending
TokenFlowCreate.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
from typing import Optional

from aiohttp import web

from ..config import logger
from ..observability.catalog import BLOB_BYTES, BLOB_REQUESTS
from ..observability.metrics import REGISTRY
from .state import ServerState

# streamed chunk size: large enough to amortize syscalls and loop hops, small
# enough that one chunk never monopolizes the loop
CHUNK = 4 * 1024 * 1024


def _file_sha256(path: str) -> str:
    """sha256 of a file, run in a thread (compile-cache integrity sidecar)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(CHUNK):
            h.update(chunk)
    return h.hexdigest()


def _assemble_parts(tmp: str, part_paths: list[str]) -> None:
    """Concatenate multipart pieces into `tmp`, run in a thread so GB-scale
    copies never run on the event loop."""
    with open(tmp, "wb") as out:
        for p in part_paths:
            with open(p, "rb") as f:
                while chunk := f.read(CHUNK):
                    out.write(chunk)


class BlobServer:
    def __init__(self, state: ServerState, host: str = "127.0.0.1", port: int = 0, chaos=None,
                 fleet_root: Optional[str] = None):
        self.state = state
        self.host = host
        self.port = port
        # the root of the sharded fleet this plane is a shard of; None on a
        # monolith
        self.fleet_root = fleet_root
        # the plane's ChaosPolicy (chaos.py): the routes are injected under
        # pseudo-RPC names (BlobPut, BlobGet, ...), so one seeded policy
        # covers the HTTP data plane and the gRPC plane alike
        self.chaos = chaos
        self._runner: Optional[web.AppRunner] = None

    async def _inject(self, route: str) -> Optional[web.Response]:
        if self.chaos is None:
            return None
        return await self.chaos.inject_http(route)

    async def _drain_to_file(self, content, tmp: str) -> int:
        """Stream an HTTP body to disk: the chunk reads stay on the loop,
        the file IO runs in threads, batched into 8 MiB writes (one thread
        hop per batch, not per network chunk)."""
        f = await asyncio.to_thread(open, tmp, "wb")
        received = 0
        buf: list[bytes] = []
        buffered = 0
        try:
            async for chunk in content.iter_chunked(1024 * 1024):
                buf.append(chunk)
                buffered += len(chunk)
                received += len(chunk)
                if buffered >= 8 * 1024 * 1024:
                    data = b"".join(buf)
                    buf.clear()
                    buffered = 0
                    await asyncio.to_thread(f.write, data)
            if buf:
                await asyncio.to_thread(f.write, b"".join(buf))
        finally:
            await asyncio.to_thread(f.close)
        return received

    async def start(self) -> str:
        app = web.Application(client_max_size=8 * 1024 * 1024 * 1024)
        app.router.add_put("/blob/{blob_id}", self._put)
        app.router.add_get("/blob/{blob_id}", self._get)
        app.router.add_put("/blob/{blob_id}/part/{part}", self._put_part)
        app.router.add_put("/blob/{blob_id}/complete/{n_parts}", self._complete)
        # the fleet compile cache: built kernel libraries by content key
        # (co-located containers read the store directory in place)
        app.router.add_put("/compile/{key}", self._compile_put)
        app.router.add_get("/compile/{key}", self._compile_get)
        app.router.add_delete("/compile/{key}", self._compile_delete)
        app.router.add_get("/compile", self._compile_keys)
        # volume content blocks, and whole volume files stitched from their
        # blocks: the striped Volume reads (volume.py) use these instead of
        # a gRPC proto copy per 8 MiB block
        app.router.add_get("/block/{sha256_hex}", self._get_block)
        app.router.add_get("/volfile/{volume_id}/{path:.*}", self._get_volume_file)
        # the metrics plane rides the one HTTP listener the plane runs: the
        # process registry, and the time-series store's history and alerts
        # the token flow's browser leg (reference token_flow.py:1): this
        # plane's "dashboard page"; visiting it with the verification code
        # approves the pending flow
        app.router.add_get("/auth/token-flow/{flow_id}", self._token_flow_approve)
        app.router.add_get("/metrics", self._metrics)
        app.router.add_get("/metrics/history", self._metrics_history)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]
        url = f"http://{self.host}:{self.port}"
        self.state.blob_url_base = url
        # where another process finds this plane's scrape URL
        try:
            obs_dir = os.path.join(self.state.state_dir, "observability")
            os.makedirs(obs_dir, exist_ok=True)
            with open(os.path.join(obs_dir, "metrics_url"), "w") as f:
                f.write(f"{url}/metrics\n")
        except OSError:
            pass
        # a shard of a sharded fleet also writes a breadcrumb of its own
        # under the fleet root (the director owns the root's metrics_url;
        # the federation finds each shard's endpoint from these)
        shard_crumb = self._fleet_shard_breadcrumb()
        if shard_crumb is not None:
            try:
                os.makedirs(os.path.dirname(shard_crumb), exist_ok=True)
                with open(shard_crumb, "w") as f:
                    f.write(f"{url}/metrics\n")
            except OSError:
                pass
        logger.debug(f"blob server at {url}")
        return url

    def _fleet_shard_breadcrumb(self) -> Optional[str]:
        """``<fleet_root>/observability/shards/shard-<i>`` when this plane is
        shard i of a sharded fleet; None for a monolith."""
        if self.fleet_root is None:
            return None
        return os.path.join(self.fleet_root, "observability", "shards", f"shard-{self.state.shard_index}")

    async def _token_flow_approve(self, request: web.Request) -> web.Response:
        flow = self.state.pending_token_flows.get(request.match_info["flow_id"])
        if flow is None or request.query.get("code") != flow["code"]:
            return web.Response(status=404, text="unknown or expired token flow")
        flow["approved"].set()
        return web.Response(content_type="text/html", text=(
            "<html><body><h2>modal-tpu: token granted</h2>"
            "<p>You can close this window and return to the terminal.</p></body></html>"
        ))

    async def _metrics(self, request: web.Request) -> web.Response:
        """Prometheus text by default; OpenMetrics (exemplars, `# EOF`) when
        the scraper asks for it (`Accept: application/openmetrics-text` or
        `?format=openmetrics`)."""
        accept = request.headers.get("Accept", "")
        if "openmetrics" in accept or request.query.get("format") == "openmetrics":
            return web.Response(
                text=REGISTRY.render_openmetrics(),
                content_type="application/openmetrics-text",
                charset="utf-8",
            )
        return web.Response(text=REGISTRY.render_prometheus(), content_type="text/plain", charset="utf-8")

    async def _metrics_history(self, request: web.Request) -> web.Response:
        """History queries (server/history.py): ?query=describe|series|
        quantile|alerts|top|snapshot [&family=...&window_s=...&q=...] → JSON."""
        from .history import history_payload

        try:
            window_s = float(request.query.get("window_s", 0) or 0)
            q = float(request.query.get("q", 0) or 0)
        except ValueError:
            return web.json_response({"error": "window_s/q must be numeric"}, status=400)
        payload = history_payload(
            self.state,
            query=request.query.get("query", "describe"),
            family=request.query.get("family", ""),
            window_s=window_s,
            q=q,
        )
        return web.json_response(payload)

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
        # a clean shutdown drops the discovery file if it still names this
        # server (a crash leaves it behind; a newer plane's is kept)
        crumb = os.path.join(self.state.state_dir, "observability", "metrics_url")
        try:
            with open(crumb) as f:
                if f.read().strip() == f"http://{self.host}:{self.port}/metrics":
                    os.unlink(crumb)
        except OSError:
            pass

    async def _put(self, request: web.Request) -> web.Response:
        if (injected := await self._inject("BlobPut")) is not None:
            BLOB_REQUESTS.inc(route="put", code=str(injected.status))
            return injected
        path = self.state.blob_path(request.match_info["blob_id"])
        tmp = path + ".tmp"
        received = await self._drain_to_file(request.content, tmp)
        os.replace(tmp, path)
        BLOB_BYTES.inc(received, direction="in")
        BLOB_REQUESTS.inc(route="put", code="200")
        return web.Response(status=200)

    async def _put_part(self, request: web.Request) -> web.Response:
        """One multipart part (S3 presigned part PUT)."""
        if (injected := await self._inject("BlobPutPart")) is not None:
            BLOB_REQUESTS.inc(route="put_part", code=str(injected.status))
            return injected
        path = self.state.blob_path(request.match_info["blob_id"]) + f".part{int(request.match_info['part'])}"
        tmp = path + ".tmp"
        received = await self._drain_to_file(request.content, tmp)
        os.replace(tmp, path)
        BLOB_BYTES.inc(received, direction="in")
        BLOB_REQUESTS.inc(route="put_part", code="200")
        return web.Response(status=200)

    async def _complete(self, request: web.Request) -> web.Response:
        """Assemble the parts into the final blob (the completion URL)."""
        if (injected := await self._inject("BlobComplete")) is not None:
            return injected
        final = self.state.blob_path(request.match_info["blob_id"])
        part_paths = [final + f".part{i}" for i in range(int(request.match_info["n_parts"]))]
        missing = [p for p in part_paths if not os.path.exists(p)]
        if missing:
            return web.Response(status=400, text=f"{len(missing)} parts missing")
        tmp = final + ".tmp"
        await asyncio.to_thread(_assemble_parts, tmp, part_paths)
        os.replace(tmp, final)
        for p in part_paths:
            os.unlink(p)
        return web.Response(status=200)

    async def _get(self, request: web.Request) -> web.StreamResponse:
        """Blob GET with HTTP Range support: the client's parallel ranged
        part-downloads of a spilled payload hit this."""
        if (injected := await self._inject("BlobGet")) is not None:
            BLOB_REQUESTS.inc(route="get", code=str(injected.status))
            return injected
        path = self.state.blob_path(request.match_info["blob_id"])
        if not os.path.exists(path):
            BLOB_REQUESTS.inc(route="get", code="404")
            return web.Response(status=404, text="not found")
        return self._serve_sendfile(request, path, "get")

    async def _get_block(self, request: web.Request) -> web.StreamResponse:
        """One volume content block, with the Range semantics of a blob."""
        if (injected := await self._inject("BlockGet")) is not None:
            BLOB_REQUESTS.inc(route="block_get", code=str(injected.status))
            return injected
        path = self.state.block_path(request.match_info["sha256_hex"])
        if not os.path.exists(path):
            BLOB_REQUESTS.inc(route="block_get", code="404")
            return web.Response(status=404, text="not found")
        return self._serve_sendfile(request, path, "block_get")

    async def _get_volume_file(self, request: web.Request) -> web.StreamResponse:
        """A whole volume file with Range: the server stitches its blocks,
        so a client stripes a multi-GiB file with a few large ranged GETs."""
        if (injected := await self._inject("VolumeFileGet")) is not None:
            BLOB_REQUESTS.inc(route="volfile", code=str(injected.status))
            return injected
        from .._utils.hash_utils import BLOCK_SIZE

        vol = self.state.volumes.get(request.match_info["volume_id"])
        f = vol.files.get(request.match_info["path"].lstrip("/")) if vol is not None else None
        if f is None:
            BLOB_REQUESTS.inc(route="volfile", code="404")
            return web.Response(status=404, text="not found")

        def read_block_range(i: int, lo: int, hi: int) -> list[bytes]:
            pieces: list[bytes] = []
            with open(self.state.block_path(f.block_sha256_hex[i]), "rb") as bf:
                bf.seek(lo)
                remaining = hi - lo
                while remaining > 0:
                    piece = bf.read(min(CHUNK, remaining))
                    if not piece:
                        break
                    remaining -= len(piece)
                    pieces.append(piece)
            return pieces

        async def chunks(start: int, stop: int):
            # the disk reads run in threads: a cold multi-GiB stream never
            # stalls the plane's loop
            for i in range(start // BLOCK_SIZE, len(f.block_sha256_hex)):
                block_lo = i * BLOCK_SIZE
                if block_lo >= stop:
                    break
                for piece in await asyncio.to_thread(
                        read_block_range, i, max(start - block_lo, 0), min(stop - block_lo, BLOCK_SIZE)):
                    yield piece

        return await self._serve_ranged(request, "volfile", f.size, chunks)

    async def _serve_ranged(self, request: web.Request, route: str, size: int, chunks) -> web.StreamResponse:
        """Range negotiation and chunked streaming for a file made of several
        on-disk pieces; `chunks(start, stop)` yields the range's bytes."""
        headers = {"Accept-Ranges": "bytes"}
        if request.method == "HEAD":
            BLOB_REQUESTS.inc(route=route, code="200")
            return web.Response(status=200, headers={**headers, "Content-Length": str(size)})
        try:
            rng = request.http_range  # slice(start, stop_exclusive)
        except ValueError:
            BLOB_REQUESTS.inc(route=route, code="416")
            return web.Response(status=416, headers={"Content-Range": f"bytes */{size}"}, text="bad range")
        start, stop = rng.start, rng.stop
        if start is None and stop is None:
            start, stop, status = 0, size, 200
        else:
            if start is None:  # a suffix range: bytes=-N
                start = max(size + (stop if stop is not None and stop < 0 else 0), 0)
            if start < 0:
                start = max(size + start, 0)
            stop = size if stop is None or stop < 0 or stop > size else stop
            if start >= size or start >= stop:
                BLOB_REQUESTS.inc(route=route, code="416")
                return web.Response(status=416, headers={"Content-Range": f"bytes */{size}"},
                                    text="unsatisfiable range")
            status = 206
            headers["Content-Range"] = f"bytes {start}-{stop - 1}/{size}"
        resp = web.StreamResponse(status=status, headers={**headers, "Content-Length": str(stop - start)})
        await resp.prepare(request)
        sent = 0
        async for chunk in chunks(start, stop):
            await resp.write(chunk)
            sent += len(chunk)
        await resp.write_eof()
        BLOB_BYTES.inc(sent, direction="out")
        BLOB_REQUESTS.inc(route=route, code=str(status))
        return resp

    def _serve_sendfile(self, request: web.Request, path: str, route: str) -> web.StreamResponse:
        """One file through aiohttp's FileResponse (kernel sendfile, native
        Range and HEAD). Bytes are counted from the negotiated range up
        front; unsatisfiable ranges are answered here, so the count and the
        response agree."""
        size = os.path.getsize(path)
        try:
            rng = request.http_range
        except ValueError:
            BLOB_REQUESTS.inc(route=route, code="416")
            return web.Response(status=416, headers={"Content-Range": f"bytes */{size}"}, text="bad range")
        start = rng.start or 0
        if start < 0:
            start = max(size + start, 0)
        stop = size if rng.stop is None or rng.stop > size else rng.stop
        partial = rng.start is not None or rng.stop is not None
        if partial and (start >= size or stop <= start):
            BLOB_REQUESTS.inc(route=route, code="416")
            return web.Response(status=416, headers={"Content-Range": f"bytes */{size}"}, text="unsatisfiable range")
        if request.method != "HEAD" and stop > start:
            BLOB_BYTES.inc(stop - start, direction="out")
        BLOB_REQUESTS.inc(route=route, code="206" if partial else "200")
        return web.FileResponse(path, chunk_size=CHUNK)

    # -- fleet compile cache (server/compile_cache.py) ----------------------

    async def _compile_put(self, request: web.Request) -> web.Response:
        """Idempotent content PUT: drain to a tmp file, hash it in a thread,
        move it into place. A body whose digest differs from the client's
        X-Content-SHA256 is refused."""
        if (injected := await self._inject("CompilePut")) is not None:
            BLOB_REQUESTS.inc(route="compile_put", code=str(injected.status))
            return injected
        store = self.state.compile_cache
        key = request.match_info["key"]
        path = store.path(key)
        if path is None:
            BLOB_REQUESTS.inc(route="compile_put", code="400")
            return web.Response(status=400, text="bad key")
        tmp = f"{path}.tmp.{os.getpid()}-{id(request)}"
        received = await self._drain_to_file(request.content, tmp)
        sha = await asyncio.to_thread(_file_sha256, tmp)
        claimed = request.headers.get("X-Content-SHA256", "")
        if claimed and claimed != sha:
            await asyncio.to_thread(os.unlink, tmp)
            BLOB_REQUESTS.inc(route="compile_put", code="422")
            return web.Response(status=422, text="content digest mismatch")
        store.finalize_put(key, tmp, sha)
        BLOB_BYTES.inc(received, direction="in")
        BLOB_REQUESTS.inc(route="compile_put", code="200")
        return web.Response(status=200)

    async def _compile_get(self, request: web.Request) -> web.StreamResponse:
        if (injected := await self._inject("CompileGet")) is not None:
            BLOB_REQUESTS.inc(route="compile_get", code=str(injected.status))
            return injected
        store = self.state.compile_cache
        key = request.match_info["key"]
        path = store.path(key)
        if path is None or not os.path.exists(path):
            BLOB_REQUESTS.inc(route="compile_get", code="404")
            return web.Response(status=404, text="not found")
        resp = self._serve_sendfile(request, path, "compile_get")
        sha = store.digest(key)
        if sha:  # clients verify it and evict a corrupt entry
            resp.headers["X-Content-SHA256"] = sha
        return resp

    async def _compile_delete(self, request: web.Request) -> web.Response:
        """Eviction: a client that caught an integrity mismatch deletes the
        entry; the next producer publishes it again."""
        if (injected := await self._inject("CompileDelete")) is not None:
            BLOB_REQUESTS.inc(route="compile_delete", code=str(injected.status))
            return injected
        code = "200" if self.state.compile_cache.delete(request.match_info["key"]) else "404"
        BLOB_REQUESTS.inc(route="compile_delete", code=code)
        return web.Response(status=int(code))

    async def _compile_keys(self, request: web.Request) -> web.Response:
        keys = await asyncio.to_thread(self.state.compile_cache.keys)
        BLOB_REQUESTS.inc(route="compile_keys", code="200")
        return web.json_response({"keys": keys, "count": len(keys)})
