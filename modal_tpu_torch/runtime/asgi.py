"""Web endpoint runtime: serve ASGI/WSGI apps and plain-function endpoints
from inside a container (port of modal_tpu/runtime/asgi.py).

Reference: py/modal/_runtime/asgi.py (asgi_app_wrapper, lifespan, vendored
a2wsgi). The reference hands requests to the container through the
platform's web layer; the local backend serves HTTP directly from the
container process (an asyncio HTTP/1.1 server speaking ASGI) and registers
the URL with the control plane. The standard library only: no uvicorn, and
`@web_server`'s reverse proxy speaks HTTP/1.1 over asyncio streams.

Supported: HTTP/1.1 request/response with content-length bodies, ASGI
lifespan startup/shutdown, WSGI apps (threaded bridge), and JSON
plain-function endpoints (`@modal_tpu_torch.web_endpoint`). Not supported:
websockets, chunked request bodies.
"""

from __future__ import annotations

import asyncio
import io
import json
import sys
import urllib.parse
from typing import Callable, Optional

from ..config import logger

MAX_BODY_BYTES = 64 * 1024 * 1024


class AsgiHttpServer:
    """Minimal asyncio HTTP/1.1 server driving an ASGI 3 application."""

    def __init__(self, asgi_app: Callable, host: str = "127.0.0.1", port: int = 0):
        self.asgi_app = asgi_app
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._lifespan_task: Optional[asyncio.Task] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def start(self) -> None:
        await self._lifespan("startup")
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.debug(f"web endpoint serving at {self.url}")

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        await self._lifespan("shutdown")

    async def _lifespan(self, phase: str) -> None:
        """Run one ASGI lifespan phase; apps without lifespan support are
        fine (errors are swallowed per spec)."""
        if phase == "startup":
            state: dict = {}
            self._lifespan_state = state
            scope = {"type": "lifespan", "asgi": {"version": "3.0"}, "state": state}
            receive_q: asyncio.Queue = asyncio.Queue()
            self._lifespan_receive = receive_q
            complete: asyncio.Queue = asyncio.Queue()

            async def receive():
                return await receive_q.get()

            async def send(message):
                await complete.put(message)

            async def _run():
                try:
                    await self.asgi_app(scope, receive, send)
                    # app returned without completing the protocol (common:
                    # `if scope["type"] == "lifespan": return`) — unblock the
                    # startup wait instead of eating the 30s timeout
                    await complete.put({"type": "lifespan.exited"})
                except Exception:
                    await complete.put({"type": "lifespan.startup.failed"})

            self._lifespan_task = asyncio.create_task(_run())
            await receive_q.put({"type": "lifespan.startup"})
            try:
                msg = await asyncio.wait_for(complete.get(), timeout=30.0)
                if msg.get("type") == "lifespan.startup.failed":
                    logger.warning(f"ASGI lifespan startup failed: {msg.get('message', '')}")
            except asyncio.TimeoutError:
                logger.debug("ASGI app has no lifespan handler (startup timeout)")
            self._lifespan_complete = complete
        else:
            if self._lifespan_task is None or self._lifespan_task.done():
                return
            await self._lifespan_receive.put({"type": "lifespan.shutdown"})
            try:
                await asyncio.wait_for(self._lifespan_complete.get(), timeout=10.0)
            except asyncio.TimeoutError:
                pass
            self._lifespan_task.cancel()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, ConnectionError):
            writer.close()
            return
        started = {"sent": False}
        try:
            request_line, *header_lines = head.decode("latin-1").split("\r\n")
            method, target, _version = request_line.split(" ", 2)
            headers: list[tuple[bytes, bytes]] = []
            content_length = 0
            for line in header_lines:
                if not line:
                    continue
                name, _, value = line.partition(":")
                headers.append((name.strip().lower().encode(), value.strip().encode()))
                if name.strip().lower() == "content-length":
                    content_length = int(value)
            body = b""
            if content_length:
                if content_length > MAX_BODY_BYTES:
                    writer.write(b"HTTP/1.1 413 Payload Too Large\r\ncontent-length: 0\r\n\r\n")
                    await writer.drain()
                    writer.close()
                    return
                body = await reader.readexactly(content_length)
            path, _, query = target.partition("?")
            scope = {
                "type": "http",
                "asgi": {"version": "3.0", "spec_version": "2.3"},
                "http_version": "1.1",
                "method": method.upper(),
                "scheme": "http",
                "path": urllib.parse.unquote(path),
                "raw_path": path.encode(),
                "query_string": query.encode(),
                "headers": headers,
                "client": writer.get_extra_info("peername"),
                "server": (self.host, self.port),
                "state": getattr(self, "_lifespan_state", {}),
            }
            await self._run_app(scope, body, writer, started)
        except Exception as exc:  # noqa: BLE001 — a bad request must not kill the server
            logger.warning(f"web request failed: {exc}")
            try:
                if not started["sent"]:
                    writer.write(b"HTTP/1.1 500 Internal Server Error\r\ncontent-length: 0\r\n\r\n")
                    await writer.drain()
                # response already started: truncate by closing — appending a
                # second status line would corrupt the stream
            except Exception:
                pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _run_app(
        self, scope: dict, body: bytes, writer: asyncio.StreamWriter, started: dict
    ) -> None:
        received = {"done": False}

        async def receive():
            if received["done"]:
                return {"type": "http.disconnect"}
            received["done"] = True
            return {"type": "http.request", "body": body, "more_body": False}

        async def send(message):
            if message["type"] == "http.response.start":
                status = message["status"]
                writer.write(f"HTTP/1.1 {status} {_reason(status)}\r\n".encode())
                has_length = False
                for name, value in message.get("headers", []):
                    if name.lower() == b"content-length":
                        has_length = True
                    writer.write(name + b": " + value + b"\r\n")
                if not has_length:
                    writer.write(b"transfer-encoding: identity\r\n")
                writer.write(b"connection: close\r\n\r\n")
                started["sent"] = True
            elif message["type"] == "http.response.body":
                writer.write(message.get("body", b""))
                await writer.drain()

        await self.asgi_app(scope, receive, send)
        if not started["sent"]:
            writer.write(b"HTTP/1.1 500 Internal Server Error\r\ncontent-length: 0\r\n\r\n")
        await writer.drain()


def _reason(status: int) -> str:
    import http

    try:
        return http.HTTPStatus(status).phrase
    except ValueError:
        return "Unknown"


# ---------------------------------------------------------------------------
# Adapters
# ---------------------------------------------------------------------------


async def _lifespan_protocol(receive, send) -> None:
    """Politely complete the lifespan protocol for adapters with no
    startup/shutdown work of their own."""
    while True:
        msg = await receive()
        if msg["type"] == "lifespan.startup":
            await send({"type": "lifespan.startup.complete"})
        elif msg["type"] == "lifespan.shutdown":
            await send({"type": "lifespan.shutdown.complete"})
            return


def wsgi_to_asgi(wsgi_app: Callable) -> Callable:
    """Threaded WSGI→ASGI bridge (reference vendored a2wsgi, simplified:
    whole-body buffering, one worker thread per request)."""

    async def app(scope, receive, send):
        if scope["type"] == "lifespan":
            return await _lifespan_protocol(receive, send)
        body = b""
        while True:
            msg = await receive()
            if msg["type"] == "http.request":
                body += msg.get("body", b"")
                if not msg.get("more_body"):
                    break
            else:
                return

        def run_wsgi():
            environ = {
                "REQUEST_METHOD": scope["method"],
                "SCRIPT_NAME": "",
                "PATH_INFO": scope["path"],
                "QUERY_STRING": scope["query_string"].decode(),
                "SERVER_NAME": scope["server"][0],
                "SERVER_PORT": str(scope["server"][1]),
                "SERVER_PROTOCOL": "HTTP/1.1",
                "wsgi.version": (1, 0),
                "wsgi.url_scheme": "http",
                "wsgi.input": io.BytesIO(body),
                "wsgi.errors": sys.stderr,
                "wsgi.multithread": True,
                "wsgi.multiprocess": False,
                "wsgi.run_once": False,
            }
            for name, value in scope["headers"]:
                key = name.decode().upper().replace("-", "_")
                if key == "CONTENT_TYPE":
                    environ["CONTENT_TYPE"] = value.decode()
                elif key == "CONTENT_LENGTH":
                    environ["CONTENT_LENGTH"] = value.decode()
                else:
                    environ["HTTP_" + key] = value.decode()
            result = {"status": 500, "headers": [], "chunks": []}

            def start_response(status_line, headers, exc_info=None):
                if exc_info is not None and result["chunks"]:
                    raise exc_info[1].with_traceback(exc_info[2])  # PEP 3333
                result["status"] = int(status_line.split(" ", 1)[0])
                result["headers"] = [
                    (k.encode(), v.encode()) for k, v in headers
                ]
                return result["chunks"].append  # legacy write() protocol

            chunks = wsgi_app(environ, start_response)
            try:
                for c in chunks:  # extend: write()-protocol bytes come first
                    result["chunks"].append(c)
            finally:
                if hasattr(chunks, "close"):
                    chunks.close()
            return result

        result = await asyncio.to_thread(run_wsgi)
        payload = b"".join(result["chunks"])
        headers = [h for h in result["headers"] if h[0].lower() != b"content-length"]
        headers.append((b"content-length", str(len(payload)).encode()))
        await send({"type": "http.response.start", "status": result["status"], "headers": headers})
        await send({"type": "http.response.body", "body": payload})

    return app


def function_to_asgi(fn: Callable, method: str = "POST") -> Callable:
    """JSON endpoint adapter for a plain function (the reference wraps these
    with fastapi; here a dependency-free equivalent): GET passes query
    params, POST/PUT pass the JSON body as kwargs; the return value is
    JSON-encoded."""
    import inspect

    async def app(scope, receive, send):
        if scope["type"] == "lifespan":
            return await _lifespan_protocol(receive, send)
        body = b""
        while True:
            msg = await receive()
            if msg["type"] == "http.request":
                body += msg.get("body", b"")
                if not msg.get("more_body"):
                    break
            else:
                return

        async def respond(status: int, payload: dict) -> None:
            data = json.dumps(payload).encode()
            await send(
                {
                    "type": "http.response.start",
                    "status": status,
                    "headers": [
                        (b"content-type", b"application/json"),
                        (b"content-length", str(len(data)).encode()),
                    ],
                }
            )
            await send({"type": "http.response.body", "body": data})

        if scope["method"] not in ("GET", method.upper()):
            await respond(405, {"error": f"method {scope['method']} not allowed"})
            return
        kwargs: dict = {}
        try:
            if scope["query_string"]:
                kwargs.update(
                    {k: v[0] for k, v in urllib.parse.parse_qs(scope["query_string"].decode()).items()}
                )
            if body:
                parsed = json.loads(body)
                if not isinstance(parsed, dict):
                    await respond(400, {"error": "JSON body must be an object"})
                    return
                kwargs.update(parsed)
            # bad arguments are the CALLER's fault (400); anything raised
            # inside the handler (including TypeErrors) is a 500
            inspect.signature(fn).bind(**kwargs)
        except json.JSONDecodeError as exc:
            await respond(400, {"error": f"invalid JSON body: {exc}"})
            return
        except TypeError as exc:
            await respond(400, {"error": str(exc)})
            return
        try:
            if inspect.iscoroutinefunction(fn):
                result = await fn(**kwargs)
            else:
                result = await asyncio.to_thread(fn, **kwargs)
            await respond(200, {"result": result})
        except Exception as exc:  # noqa: BLE001 — surface as a 500 payload
            logger.warning(f"web endpoint raised: {exc}")
            await respond(500, {"error": f"{type(exc).__name__}: {exc}"})

    return app


def proxy_to_port(port: int) -> Callable:
    """Reverse-proxy ASGI app for @web_server (reference @modal.web_server):
    every request forwards to the user's own HTTP server on
    127.0.0.1:<port> over a fresh HTTP/1.1 connection (`connection: close`),
    and the response streams back as it arrives, so the platform's web URL
    fronts whatever framework the user launched."""

    async def app(scope, receive, send):
        if scope["type"] == "lifespan":
            return await _lifespan_protocol(receive, send)
        body = b""
        while True:
            msg = await receive()
            if msg["type"] == "http.request":
                body += msg.get("body", b"")
                if not msg.get("more_body"):
                    break
            else:
                return
        qs = scope.get("query_string", b"").decode()
        target = urllib.parse.quote(scope["path"]) + (f"?{qs}" if qs else "")
        started = False
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
        except OSError as exc:
            return await _bad_gateway(send, port, exc)
        try:
            head = [f"{scope['method']} {target} HTTP/1.1", f"host: 127.0.0.1:{port}", "connection: close",
                    f"content-length: {len(body)}"]
            for name, value in scope.get("headers", []):
                if name.lower() not in (b"host", b"content-length", b"connection", b"transfer-encoding"):
                    head.append(f"{name.decode('latin-1')}: {value.decode('latin-1')}")
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body)
            await writer.drain()
            try:
                status_head = await reader.readuntil(b"\r\n\r\n")
            except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, ConnectionError) as exc:
                return await _bad_gateway(send, port, exc)
            status_line, *header_lines = status_head.decode("latin-1").split("\r\n")
            status = int(status_line.split(" ", 2)[1])
            headers, length, chunked = [], None, False
            for line in header_lines:
                if not line:
                    continue
                name, _, value = line.partition(":")
                key, value = name.strip().lower(), value.strip()
                if key == "content-length":
                    length = int(value)
                elif key == "transfer-encoding":
                    chunked = "chunked" in value.lower()
                if key not in ("transfer-encoding", "content-length", "connection"):
                    headers.append((key.encode("latin-1"), value.encode("latin-1")))
            await send({"type": "http.response.start", "status": status, "headers": headers})
            started = True
            async for chunk in _upstream_body(reader, length, chunked):
                await send({"type": "http.response.body", "body": chunk, "more_body": True})
            await send({"type": "http.response.body", "body": b""})
        except (OSError, ValueError, asyncio.IncompleteReadError) as exc:
            if started:
                # the response is underway: ASGI forbids a second start, so
                # end the body; the truncated stream is the error signal
                await send({"type": "http.response.body", "body": b""})
                return
            await _bad_gateway(send, port, exc)
        finally:
            writer.close()

    return app


async def _upstream_body(reader: asyncio.StreamReader, length: Optional[int], chunked: bool):
    """The upstream response's body, de-framed: chunked, by content-length,
    or until the server closes the connection."""
    if chunked:
        while True:
            size = int((await reader.readuntil(b"\r\n")).split(b";")[0], 16)
            if size == 0:
                await reader.readuntil(b"\r\n")
                return
            data = await reader.readexactly(size)
            await reader.readexactly(2)
            yield data
    remaining = length
    while remaining is None or remaining > 0:
        data = await reader.read(64 * 1024 if remaining is None else min(64 * 1024, remaining))
        if not data:
            return
        if remaining is not None:
            remaining -= len(data)
        yield data


async def _bad_gateway(send, port: int, exc: BaseException) -> None:
    data = json.dumps({"error": f"upstream server on :{port} unreachable: {exc}"}).encode()
    await send({"type": "http.response.start", "status": 502,
                "headers": [(b"content-type", b"application/json"), (b"content-length", str(len(data)).encode())]})
    await send({"type": "http.response.body", "body": data})


async def wait_for_port(port: int, timeout: float) -> None:
    """Block until 127.0.0.1:<port> accepts connections (the user's server
    starting up) — @web_server registers its URL only after this."""
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.close()
            return
        except OSError:
            if asyncio.get_event_loop().time() >= deadline:
                raise TimeoutError(f"@web_server port {port} never came up within {timeout}s")
            await asyncio.sleep(0.2)
