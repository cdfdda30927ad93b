"""gRPC channel management + transient-error retry engine (port of
modal_tpu/_utils/grpc_utils.py).

Reference: py/modal/_utils/grpc_utils.py — `retry_transient_errors`
(grpc_utils.py:407), `RETRYABLE_GRPC_STATUS_CODES` (grpc_utils.py:158),
channel creation with metadata injection (grpc_utils.py:325).
"""

from __future__ import annotations

import asyncio
import os
import random
import time
import urllib.parse
import uuid
from typing import Any, Optional

import grpc
import grpc.aio

from ..config import logger
from ..exception import AuthError, ConnectionError as ModalConnectionError

RETRYABLE_GRPC_STATUS_CODES = [
    grpc.StatusCode.DEADLINE_EXCEEDED,
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.CANCELLED,
    grpc.StatusCode.INTERNAL,
    grpc.StatusCode.UNKNOWN,
]


class CircuitBreaker:
    """Per-method circuit breaker for the transient-retry engine.

    After `threshold` CONSECUTIVE failed attempts (across calls) the circuit
    opens for `cooldown_s`. While open, attempts WAIT until the cooldown
    expires instead of hammering a struggling server — the retry contract of
    callers (including max_retries=None loops) is preserved; only the pacing
    changes. The first attempt after the cooldown is the half-open probe: its
    success closes the circuit, its failure re-opens it for another cooldown.
    """

    def __init__(self, method: str, threshold: int, cooldown_s: float):
        self.method = method
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.consecutive_failures = 0
        self.open_until = 0.0
        self.times_opened = 0  # observability

    @property
    def state(self) -> str:
        if time.monotonic() < self.open_until:
            return "open"
        if self.consecutive_failures >= self.threshold:
            return "half_open"
        return "closed"

    async def before_attempt(self, deadline: Optional[float] = None) -> None:
        remaining = self.open_until - time.monotonic()
        if remaining > 0:
            if deadline is not None:
                # never pause past the caller's total-timeout budget
                remaining = min(remaining, max(0.0, deadline - time.monotonic()))
            logger.debug(f"circuit open for {self.method}; pausing {remaining:.2f}s")
            await asyncio.sleep(remaining)

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self.open_until = 0.0

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.consecutive_failures >= self.threshold:
            self.open_until = time.monotonic() + self.cooldown_s
            self.times_opened += 1
            logger.warning(
                f"circuit breaker OPEN for {self.method} after "
                f"{self.consecutive_failures} consecutive failures ({self.cooldown_s}s cooldown)"
            )
            from ..observability import tracing
            from ..observability.catalog import CIRCUIT_BREAKER_OPENS

            CIRCUIT_BREAKER_OPENS.inc(method=self.method.rsplit("/", 1)[-1])
            tracing.add_event(
                "circuit_breaker.open", method=self.method, cooldown_s=self.cooldown_s
            )


_breakers: dict[str, CircuitBreaker] = {}


def _breaker_for(fn: Any) -> Optional[CircuitBreaker]:
    if os.environ.get("MODAL_TPU_CIRCUIT_BREAKER", "1") in ("0", "false", "no"):
        return None
    method = getattr(fn, "_method", None)
    if method is None:
        return None
    if isinstance(method, bytes):
        method = method.decode("utf-8", "replace")
    # scope per channel (stamped by _StubBase): a struggling server must not
    # open the circuit for the same method on every OTHER server the process
    # talks to (control plane vs input plane, or fresh supervisors in tests)
    method = f"{getattr(fn, '_breaker_scope', '')}:{method}"
    breaker = _breakers.get(method)
    if breaker is None:
        if len(_breakers) > 4096:
            # dead channels leave breakers behind (one per channel × method);
            # drop everything not currently open — a channel that died while
            # failing parks its breaker in "half_open" forever, so a
            # closed-only purge would never reclaim anything
            for key in [k for k, b in _breakers.items() if b.state != "open"]:
                del _breakers[key]
        breaker = _breakers[method] = CircuitBreaker(
            method,
            threshold=int(os.environ.get("MODAL_TPU_CIRCUIT_BREAKER_THRESHOLD", "10")),
            cooldown_s=float(os.environ.get("MODAL_TPU_CIRCUIT_BREAKER_COOLDOWN", "1.0")),
        )
    return breaker


def create_channel(server_url: str, metadata: Optional[dict[str, str]] = None) -> grpc.aio.Channel:
    """Create a grpc.aio channel from a modal-style URL (grpc:// | grpcs:// |
    unix://)."""
    o = urllib.parse.urlparse(server_url)
    options = [
        ("grpc.max_receive_message_length", 128 * 1024 * 1024),
        ("grpc.max_send_message_length", 128 * 1024 * 1024),
        ("grpc.keepalive_time_ms", 30_000),
        ("grpc.keepalive_timeout_ms", 10_000),
    ]
    interceptors = [
        _MetadataInterceptorUnary(metadata or {}),
        _MetadataInterceptorStream(metadata or {}),
        _TracingInterceptorUnary(),
        _TracingInterceptorStream(),
    ]
    if o.scheme in ("grpc", "http", ""):
        target = o.netloc or server_url
        return grpc.aio.insecure_channel(target, options=options, interceptors=interceptors)
    elif o.scheme == "unix":
        return grpc.aio.insecure_channel(server_url, options=options, interceptors=interceptors)
    elif o.scheme in ("grpcs", "https"):
        creds = grpc.ssl_channel_credentials()
        return grpc.aio.secure_channel(o.netloc, creds, options=options, interceptors=interceptors)
    else:
        raise ModalConnectionError(f"unknown scheme in server url {server_url}")


class _MetadataInterceptorUnary(grpc.aio.UnaryUnaryClientInterceptor):
    def __init__(self, metadata: dict[str, str]):
        self._metadata = list(metadata.items())

    async def intercept_unary_unary(self, continuation, client_call_details, request):
        details = _with_metadata(client_call_details, self._metadata)
        return await continuation(details, request)


class _MetadataInterceptorStream(grpc.aio.UnaryStreamClientInterceptor):
    def __init__(self, metadata: dict[str, str]):
        self._metadata = list(metadata.items())

    async def intercept_unary_stream(self, continuation, client_call_details, request):
        details = _with_metadata(client_call_details, self._metadata)
        return await continuation(details, request)


class _TracingInterceptorUnary(grpc.aio.UnaryUnaryClientInterceptor):
    """Distributed-tracing client interceptor: when the calling task is inside
    a span (e.g. the `function.call` root a `.remote()` opens), propagate its
    context as gRPC metadata, record a client RPC span, and observe
    client-side latency. Untraced calls still feed the latency metric."""

    async def intercept_unary_unary(self, continuation, client_call_details, request):
        from ..observability import tracing
        from ..observability.catalog import CLIENT_RPC_LATENCY

        method = client_call_details.method
        if isinstance(method, bytes):
            method = method.decode("utf-8", "replace")
        short = method.rsplit("/", 1)[-1]
        ctx = tracing.current_context()
        t0 = time.perf_counter()
        try:
            # `await continuation(...)` only CONSTRUCTS the call — awaiting
            # the call is what runs the RPC, so the response must be awaited
            # in here or the latency metric/span would measure ~0 for every
            # call. Returning the response (not the call) is supported: the
            # interceptor framework wraps it in UnaryUnaryCallResponse.
            if ctx is not None:
                details = _with_metadata(client_call_details, tracing.context_metadata(ctx))
                with tracing.span(f"rpc.client.{short}", parent=ctx):
                    call = await continuation(details, request)
                    return await call
            call = await continuation(client_call_details, request)
            return await call
        finally:
            CLIENT_RPC_LATENCY.observe(
                time.perf_counter() - t0,
                method=short,
                exemplar=ctx.trace_id if ctx is not None else None,
            )


class _TracingInterceptorStream(grpc.aio.UnaryStreamClientInterceptor):
    """Stream RPCs only propagate context (no span: streams outlive the call
    site, and a poll's duration measures patience, not performance)."""

    async def intercept_unary_stream(self, continuation, client_call_details, request):
        from ..observability import tracing

        ctx = tracing.current_context()
        if ctx is not None:
            client_call_details = _with_metadata(
                client_call_details, tracing.context_metadata(ctx)
            )
        return await continuation(client_call_details, request)


def _with_metadata(details: grpc.aio.ClientCallDetails, extra: list[tuple[str, str]]) -> grpc.aio.ClientCallDetails:
    md = list(details.metadata or []) + extra
    return grpc.aio.ClientCallDetails(
        method=details.method,
        timeout=details.timeout,
        metadata=md,
        credentials=details.credentials,
        wait_for_ready=details.wait_for_ready,
    )


async def retry_transient_errors(
    fn: Any,
    *args: Any,
    base_delay: float = 0.1,
    max_delay: float = 1.0,
    delay_factor: float = 2.0,
    max_retries: Optional[int] = 3,
    additional_status_codes: Optional[list] = None,
    attempt_timeout: Optional[float] = None,
    total_timeout: Optional[float] = None,
    metadata: Optional[list[tuple[str, str]]] = None,
    jitter: bool = True,
) -> Any:
    """Call a unary-unary multicallable with retries on transient gRPC errors.

    Mirrors reference `retry_transient_errors` (grpc_utils.py:407): idempotency
    key metadata, exponential backoff, optional per-attempt and total deadlines.
    Hardened: backoff is jittered (equal-jitter, so N clients recovering from
    one outage don't re-synchronize their retries) and a per-method circuit
    breaker paces attempts once a method fails many times in a row.
    """
    delay = base_delay
    n_retries = 0
    status_codes = RETRYABLE_GRPC_STATUS_CODES + (additional_status_codes or [])
    idempotency_key = str(uuid.uuid4())
    t0 = time.monotonic()
    breaker = _breaker_for(fn)

    while True:
        md = [
            ("x-idempotency-key", idempotency_key),
            ("x-retry-attempt", str(n_retries)),
        ] + (metadata or [])
        if breaker is not None:
            await breaker.before_attempt(
                deadline=(t0 + total_timeout) if total_timeout is not None else None
            )
        # budget AFTER the breaker pause: the pause consumes wall clock, so
        # computing the attempt timeout first would let the RPC overrun
        # total_timeout by up to a full cooldown
        timeout = attempt_timeout
        if total_timeout is not None:
            remaining = total_timeout - (time.monotonic() - t0)
            if remaining <= 0:
                raise asyncio.TimeoutError(f"total timeout {total_timeout}s exceeded")
            timeout = min(timeout, remaining) if timeout is not None else remaining
        try:
            result = await fn(*args, metadata=md, timeout=timeout)
            if breaker is not None:
                breaker.record_success()
            return result
        except grpc.aio.AioRpcError as exc:
            code = exc.code()
            if code == grpc.StatusCode.CANCELLED:
                # grpc.aio surfaces OUR OWN task cancellation as
                # AioRpcError(CANCELLED); retrying it would swallow e.g. the
                # container's SIGTERM drain, and behind max_retries=None it
                # makes the task UNCANCELLABLE (teardown hangs forever on
                # gather). Task.cancelling() is 3.11+ — on 3.10 there is no
                # reliable way to tell our own cancel from a server-side
                # one, so treat every CANCELLED as cancellation: aborting a
                # rare server-side cancel is benign, an immortal task is not.
                current = asyncio.current_task()
                cancelling = getattr(current, "cancelling", None)
                if current is None or cancelling is None or cancelling():
                    raise asyncio.CancelledError() from exc
            if code == grpc.StatusCode.UNAUTHENTICATED:
                raise AuthError(exc.details()) from None
            if code == grpc.StatusCode.NOT_FOUND:
                from ..exception import NotFoundError

                raise NotFoundError(exc.details()) from None
            if code == grpc.StatusCode.ALREADY_EXISTS:
                from ..exception import AlreadyExistsError

                raise AlreadyExistsError(exc.details()) from None
            if code not in status_codes:
                raise
            if breaker is not None:
                breaker.record_failure()
            if max_retries is not None and n_retries >= max_retries:
                raise
            if total_timeout is not None and (time.monotonic() - t0 + delay) > total_timeout:
                raise
            n_retries += 1
            logger.debug(f"retrying {getattr(fn, '_method', fn)} after {code} (attempt {n_retries})")
            # retries become span events + a counter: a chaos soak's tail
            # latency is then attributable to specific injected faults
            from ..observability import tracing
            from ..observability.catalog import CLIENT_RPC_RETRIES

            _method_label = getattr(fn, "_method", "")
            if isinstance(_method_label, bytes):
                _method_label = _method_label.decode("utf-8", "replace")
            _method_label = str(_method_label).rsplit("/", 1)[-1]
            CLIENT_RPC_RETRIES.inc(method=_method_label)
            tracing.add_event("rpc.retry", method=_method_label, code=code.name, attempt=n_retries)
            # equal jitter: sleep in [delay/2, delay] so a fleet of clients
            # recovering from the same outage doesn't retry in lockstep
            await asyncio.sleep(delay * (0.5 + random.random() * 0.5) if jitter else delay)
            delay = min(delay * delay_factor, max_delay)


def get_proto_oneof(message: Any, oneof_group: str) -> Optional[Any]:
    which = message.WhichOneof(oneof_group)
    if which is None:
        return None
    return getattr(message, which)


def find_free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
