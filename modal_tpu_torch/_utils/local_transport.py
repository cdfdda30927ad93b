"""Local fast-path transport: the in-process and Unix-socket rungs (port of
modal_tpu/_utils/local_transport.py).

When client, plane and containers share one host (the default
`LocalSupervisor` deployment), gRPC over TCP is pure overhead. The transport
is a ladder, resolved per call, each rung degradable on its own:

1. **in-process**: when the target server URL is registered in this
   process (`register_local_server`: the supervisor registers its servicer
   once its servers are up), the handler coroutine runs directly through
   the same wrappers the gRPC server uses (`proto/rpc.build_local_handlers`:
   idempotency dedupe, metrics). Requests and responses are copied through
   their bytes, so neither side aliases the other's messages. A caller on
   another event loop hops onto the server's loop with
   `run_coroutine_threadsafe` (the servicer's asyncio primitives are bound
   to it); a caller on the same loop awaits the handler directly.
2. **UDS**: co-located peers in other processes (the containers) dial the
   Unix socket the server advertises (ClientHello, or
   `MODAL_TPU_SERVER_UDS` in a container's env). On UNAVAILABLE the socket
   path is stat'd: gone, the rung breaks and the call re-issues on TCP;
   still there, the error is the server's and goes to the retry engine.
3. **TCP**: always there, and the only rung for a remote peer.

Settings, under the JAX package's names and defaults:

- ``MODAL_TPU_FASTPATH=0``        the whole ladder off (TCP and HTTP only)
- ``MODAL_TPU_FASTPATH_INPROC=0`` the in-process rung off
- ``MODAL_TPU_FASTPATH_UDS=0``    the UDS rung off
- ``MODAL_TPU_FASTPATH_BLOB=0``   the blob handoff by path off
  (`_utils/blob_utils.py`)
"""

from __future__ import annotations

import asyncio
import collections
import os
import time
from typing import Any, Optional

import grpc
import grpc.aio

from ..config import logger

# -- settings -----------------------------------------------------------------


def _on(name: str) -> bool:
    return os.environ.get(name, "1") not in ("0", "false", "no")


def fastpath_enabled() -> bool:
    return _on("MODAL_TPU_FASTPATH")


def inproc_enabled() -> bool:
    return fastpath_enabled() and _on("MODAL_TPU_FASTPATH_INPROC")


def uds_enabled() -> bool:
    return fastpath_enabled() and _on("MODAL_TPU_FASTPATH_UDS")


def blob_local_enabled() -> bool:
    return fastpath_enabled() and _on("MODAL_TPU_FASTPATH_BLOB")


# Unix sockets cap sun_path at ~108 bytes; a state_dir deep enough to blow
# that budget silently gets no UDS rung (TCP still works)
UDS_PATH_MAX = 100


def usable_uds_path(path: str) -> bool:
    return bool(path) and len(path) <= UDS_PATH_MAX


def note_rung(stub: Any, name: str, transport: str) -> None:
    """Count one call served by `transport` (inproc | uds | tcp |
    blob_local): the process-wide counter, and the stub's own tally by
    method when it keeps one (`FastPathStub.rungs`)."""
    from ..observability.catalog import FASTPATH_CALLS

    FASTPATH_CALLS.inc(transport=transport)
    rungs = getattr(stub, "rungs", None)
    if rungs is not None:
        rungs[f"{name}:{transport}"] += 1



def wrap_stub(
    server_url: str,
    tcp_stub: Any,
    uds_path: str = "",
    blob_local_dir: str = "",
    *,
    channels: dict[str, Any],
    metadata: Optional[dict[str, str]] = None,
) -> Any:
    """`tcp_stub` upgraded to the ladder (in process, Unix socket, TCP) when
    a local rung is usable, else `tcp_stub` itself. Co-location is a stat:
    a path the server advertised that this process can see. The socket's
    channel is opened into `channels` (keyed by its URL), which the caller
    owns and closes."""
    if not fastpath_enabled():
        return tcp_stub
    uds_ok = uds_enabled() and usable_uds_path(uds_path) and os.path.exists(uds_path)
    blob_ok = bool(blob_local_dir) and os.path.isdir(blob_local_dir)
    if not (uds_ok or blob_ok or resolve_local_server(server_url) is not None):
        return tcp_stub
    uds_stub = None
    if uds_ok:
        from ..proto.rpc import ModalTPUStub
        from .grpc_utils import create_channel

        uds_url = f"unix://{uds_path}"
        if uds_url not in channels:
            channels[uds_url] = create_channel(uds_url, metadata=metadata)
        uds_stub = ModalTPUStub(channels[uds_url])
    return FastPathStub(
        server_url,
        tcp_stub,
        uds_path=uds_path if uds_ok else "",
        uds_stub=uds_stub,
        base_metadata=metadata,
        blob_local_dir=blob_local_dir if blob_ok else "",
    )


# -- the in-process server registry ------------------------------------------


class LocalServer:
    """One registered in-process gRPC-equivalent endpoint: the wrapped
    handler table plus the event loop the servicer's asyncio primitives are
    bound to."""

    def __init__(self, handler_target: Any, loop: asyncio.AbstractEventLoop):
        from ..proto.rpc import build_local_handlers

        self.handlers = build_local_handlers(handler_target)
        self.loop = loop


_LOCAL_SERVERS: dict[str, LocalServer] = {}


def register_local_server(server_url: str, handler_target: Any) -> None:
    """Make `server_url` resolvable in process. The supervisor calls this
    at start, and again after a crash_restart rebuilds the servicer (the
    latest registration wins)."""
    _LOCAL_SERVERS[server_url] = LocalServer(handler_target, asyncio.get_running_loop())


def unregister_local_server(server_url: str) -> None:
    _LOCAL_SERVERS.pop(server_url, None)


def resolve_local_server(server_url: str) -> Optional[LocalServer]:
    if not inproc_enabled():
        return None
    return _LOCAL_SERVERS.get(server_url)


# -- the fake ServicerContext the local rung hands to handlers ----------------


def local_rpc_error(code: grpc.StatusCode, details: str = "") -> grpc.aio.AioRpcError:
    from grpc.aio import Metadata

    return grpc.aio.AioRpcError(code, Metadata(), Metadata(), details=details, debug_error_string="")


class _AbortError(BaseException):
    """Internal carrier for context.abort — BaseException so user-level
    `except Exception` inside a handler can't swallow an abort, matching
    grpc's own abort semantics."""

    def __init__(self, code: grpc.StatusCode, details: str):
        self.code = code
        self.details = details


class _LocalContext:
    """The slice of grpc.aio.ServicerContext the handlers actually use:
    invocation metadata in, abort out."""

    def __init__(self, metadata: list[tuple[str, str]]):
        self._metadata = tuple(metadata)

    def invocation_metadata(self):
        return self._metadata

    async def abort(self, code: grpc.StatusCode, details: str = "") -> None:
        raise _AbortError(code, details)



# -- the fast-path stub -------------------------------------------------------


class _FastPathCall:
    """One RPC method on a FastPathStub: resolves the transport ladder per
    call. Carries the `_method`/`_breaker_scope` attributes the retry engine
    and circuit breaker key off."""

    def __init__(self, stub: "FastPathStub", name: str, method: Any, tcp_call: Any, uds_call: Any):
        self._stub = stub
        self._name = name
        self._rpc = method
        self._tcp_call = tcp_call
        self._uds_call = uds_call
        self._method = getattr(tcp_call, "_method", method.path)
        self._breaker_scope = getattr(tcp_call, "_breaker_scope", "")

    # .. unary ................................................................

    async def _call_local(self, server: LocalServer, request, metadata, timeout):
        from ..observability import tracing
        from ..observability.catalog import CLIENT_RPC_LATENCY

        method, impl = server.handlers[self._name]
        # proto-copy isolation: the handler must never alias the caller's
        # message (and vice versa) — same ownership rules as the wire
        req = method.request_type.FromString(request.SerializeToString())
        ctx = tracing.current_context()
        md = list(self._stub.base_metadata) + list(metadata or [])
        if ctx is not None:
            md += tracing.context_metadata(ctx)
        local_ctx = _LocalContext(md)

        async def _invoke():
            try:
                return await impl(req, local_ctx)
            except _AbortError as exc:
                raise local_rpc_error(exc.code, exc.details) from None

        async def _run():
            if asyncio.get_running_loop() is server.loop:
                coro = _invoke()
            else:
                # the servicer's conditions/events are bound to ITS loop —
                # hop over instead of corrupting them from this one
                coro = asyncio.wrap_future(asyncio.run_coroutine_threadsafe(_invoke(), server.loop))
            if timeout is not None:
                try:
                    return await asyncio.wait_for(coro, timeout)
                except asyncio.TimeoutError:
                    raise local_rpc_error(
                        grpc.StatusCode.DEADLINE_EXCEEDED, f"local deadline exceeded ({timeout}s)"
                    ) from None
            return await coro

        t0 = time.perf_counter()
        try:
            if ctx is not None:
                # mirror the client tracing interceptor: the in-process rung
                # must not lose the rpc.client attribution segment
                with tracing.span(f"rpc.client.{self._name}", parent=ctx):
                    resp = await _run()
            else:
                resp = await _run()
        finally:
            CLIENT_RPC_LATENCY.observe(
                time.perf_counter() - t0,
                method=self._name,
                exemplar=ctx.trace_id if ctx is not None else None,
            )
        return method.response_type.FromString(resp.SerializeToString())

    async def _call_unary(self, request, metadata=None, timeout=None, **kwargs):
        from ..observability.catalog import FASTPATH_FALLBACKS

        server = resolve_local_server(self._stub.server_url)
        if server is not None and self._name in server.handlers:
            note_rung(self._stub, self._name, "inproc")
            return await self._call_local(server, request, metadata, timeout)
        uds = self._uds_call
        if uds is not None and not self._stub.uds_broken and uds_enabled():
            try:
                resp = await uds(request, metadata=metadata, timeout=timeout, **kwargs)
                note_rung(self._stub, self._name, "uds")
                return resp
            except grpc.aio.AioRpcError as exc:
                if exc.code() == grpc.StatusCode.UNAVAILABLE and not os.path.exists(
                    self._stub.uds_path
                ):
                    # the socket is GONE (server restarted elsewhere, dir
                    # reaped): break the rung and re-issue on TCP —
                    # an UNAVAILABLE with the socket still present is the
                    # server's error and belongs to the normal retry engine
                    self._stub.mark_uds_broken()
                    FASTPATH_FALLBACKS.inc(rung="uds", reason="socket_gone")
                else:
                    raise
        note_rung(self._stub, self._name, "tcp")
        return await self._tcp_call(request, metadata=metadata, timeout=timeout, **kwargs)

    # .. streams ..............................................................

    def _call_stream(self, request, metadata=None, timeout=None, **kwargs):
        server = resolve_local_server(self._stub.server_url)
        if server is not None and self._name in server.handlers:
            try:
                if asyncio.get_running_loop() is server.loop:
                    return self._stream_local(server, request, metadata)
            except RuntimeError:
                pass  # no running loop: let grpc sort it out
        uds = self._uds_call
        if uds is not None and not self._stub.uds_broken and uds_enabled():
            note_rung(self._stub, self._name, "uds")
            return uds(request, metadata=metadata, timeout=timeout, **kwargs)
        note_rung(self._stub, self._name, "tcp")
        return self._tcp_call(request, metadata=metadata, timeout=timeout, **kwargs)

    async def _stream_local(self, server: LocalServer, request, metadata):
        from ..observability import tracing

        method, impl = server.handlers[self._name]
        req = method.request_type.FromString(request.SerializeToString())
        ctx = tracing.current_context()
        md = list(self._stub.base_metadata) + list(metadata or [])
        if ctx is not None:
            md += tracing.context_metadata(ctx)
        note_rung(self._stub, self._name, "inproc")
        gen = impl(req, _LocalContext(md))
        try:
            while True:
                nxt = asyncio.ensure_future(gen.__anext__())
                # registry-epoch watchdog: a socket-served stream dies WITH
                # its server; an in-process generator would survive a
                # crash_restart as a zombie draining the ABANDONED state's
                # queues/conditions. Poll the registration identity while
                # waiting so the stream breaks (UNAVAILABLE, like a closed
                # connection) within ~1 s of the plane being torn down.
                while not nxt.done():
                    await asyncio.wait({nxt}, timeout=1.0)
                    if not nxt.done() and _LOCAL_SERVERS.get(self._stub.server_url) is not server:
                        nxt.cancel()
                        try:
                            await nxt
                        except BaseException:  # noqa: BLE001
                            pass
                        raise local_rpc_error(
                            grpc.StatusCode.UNAVAILABLE, "local server gone (stream severed)"
                        )
                try:
                    item = nxt.result()
                except StopAsyncIteration:
                    return
                yield method.response_type.FromString(item.SerializeToString())
        except _AbortError as exc:
            raise local_rpc_error(exc.code, exc.details) from None
        finally:
            # closing THIS generator must close the handler's too — an
            # abandoned server stream would park a waiter on the call's
            # output condition until process exit
            try:
                await gen.aclose()
            except BaseException:  # noqa: BLE001 — best-effort release
                pass

    def __call__(self, request, metadata=None, timeout=None, **kwargs):
        from ..proto.rpc import Arity

        if self._rpc.arity == Arity.UNARY_STREAM:
            return self._call_stream(request, metadata=metadata, timeout=timeout, **kwargs)
        return self._call_unary(request, metadata=metadata, timeout=timeout, **kwargs)


class FastPathStub:
    """Drop-in replacement for ModalTPUStub that resolves the transport
    ladder (inproc → UDS → TCP) per call. Built by _Client once it learns a
    server's local coordinates (ClientHello / env)."""

    def __init__(
        self,
        server_url: str,
        tcp_stub: Any,
        uds_path: str = "",
        uds_stub: Any = None,
        base_metadata: Optional[dict[str, str]] = None,
        blob_local_dir: str = "",
    ):
        from ..proto.rpc import RPCS

        self.server_url = server_url
        self.tcp_stub = tcp_stub
        self.uds_path = uds_path
        self.uds_stub = uds_stub
        self.uds_broken = False
        self.base_metadata = list((base_metadata or {}).items())
        # co-located blob store (path handoff): blob_utils reads/writes
        # payload files directly instead of round-tripping HTTP
        self._blob_local_dir = blob_local_dir
        # calls by "<method>:<rung>" (note_rung), for an operator to see
        # which rung each RPC of this stub took
        self.rungs: collections.Counter = collections.Counter()
        for name, method in RPCS.items():
            tcp_call = getattr(tcp_stub, name)
            uds_call = getattr(uds_stub, name, None) if uds_stub is not None else None
            setattr(self, name, _FastPathCall(self, name, method, tcp_call, uds_call))

    def mark_uds_broken(self) -> None:
        if not self.uds_broken:
            logger.warning(f"UDS fast path to {self.server_url} broke; falling back to TCP")
            self.uds_broken = True
