"""Spans for the serving engine's per-request timeline, the SDK client's
RPCs, the control plane's handlers and placements, and a container's boot.

The span model is the JAX package's (trace_id/span_id/parent_id, name,
start/end wall-clock seconds, attrs, timestamped events), and so are the
gRPC metadata keys that carry a caller's context to the server. Finished
spans go to ``spans-<pid>.jsonl`` under the directory given to
`configure(trace_dir)`; a supervisor configures `<state_dir>/traces` and
its workers export it to their containers (`maybe_configure_from_env`).
Without it, spans still carry ids (so children stitch under their parent)
but nothing is written. In-process observers registered with
`add_span_tap` see every finished span, sink or no sink.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional


# gRPC metadata keys of a propagated span context (the JAX package's)
TRACE_ID_METADATA_KEY = "x-modal-tpu-trace-id"
SPAN_ID_METADATA_KEY = "x-modal-tpu-span-id"
# what a worker exports to its containers: the span sink's directory, the
# launching input's context ("trace_id:span_id") and the wall-clock time of
# the spawn decision, where a container's boot span starts
TRACE_DIR_ENV = "MODAL_TPU_TRACE_DIR"
TRACE_CONTEXT_ENV = "MODAL_TPU_TRACE_CONTEXT"
TRACE_T0_ENV = "MODAL_TPU_TRACE_T0"


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass(frozen=True)
class SpanContext:
    trace_id: str
    span_id: str


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: str
    name: str
    start: float
    end: float = 0.0
    attrs: dict[str, Any] = field(default_factory=dict)
    status: str = "ok"
    events: list[dict] = field(default_factory=list)

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def add_event(self, name: str, **attrs: Any) -> None:
        self.events.append({"name": name, "t": time.time(), **attrs})

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "status": self.status,
            "attrs": self.attrs,
            "events": self.events,
        }


_sink_lock = threading.Lock()
_sink_file = None
_sink_dir: Optional[str] = None


def configure(trace_dir: str) -> None:
    """Append finished spans as JSON lines under `trace_dir`."""
    global _sink_file, _sink_dir
    os.makedirs(trace_dir, exist_ok=True)
    with _sink_lock:
        if _sink_file is not None:
            _sink_file.close()
        _sink_file = open(os.path.join(trace_dir, f"spans-{os.getpid()}.jsonl"), "a", buffering=1)
        _sink_dir = trace_dir


def maybe_configure_from_env() -> None:
    """Container side: adopt the span sink the worker exported."""
    if os.environ.get(TRACE_DIR_ENV):
        configure(os.environ[TRACE_DIR_ENV])


def trace_dir() -> Optional[str]:
    return _sink_dir


def read_spans(trace_dir_path: str) -> list[dict]:
    """Every span written under `trace_dir_path`, across the processes'
    files; a torn last line (a process killed mid-write) is skipped."""
    spans: list[dict] = []
    for name in sorted(os.listdir(trace_dir_path)):
        if not (name.startswith("spans-") and name.endswith(".jsonl")):
            continue
        with open(os.path.join(trace_dir_path, name)) as f:
            for line in f:
                try:
                    spans.append(json.loads(line))
                except ValueError:
                    continue
    return spans


_span_taps: list = []


def add_span_tap(tap) -> None:
    """Call `tap(span)` for every finished span (before the file sink)."""
    if tap not in _span_taps:
        _span_taps.append(tap)


def remove_span_tap(tap) -> None:
    if tap in _span_taps:
        _span_taps.remove(tap)


def _write(span: Span) -> None:
    for tap in list(_span_taps):
        tap(span)
    if _sink_file is None:
        return
    line = json.dumps(span.to_dict(), default=str)
    with _sink_lock:
        if _sink_file is not None:
            _sink_file.write(line + "\n")


_current_span: ContextVar[Optional[Span]] = ContextVar("modal_tpu_torch_span", default=None)


def current_context() -> Optional[SpanContext]:
    span = _current_span.get()
    return span.context if span is not None else None


def add_event(name: str, **attrs: Any) -> None:
    """Attach an event to the current span, if any (client retries, circuit
    breaker opens); a no-op outside a span."""
    span = _current_span.get()
    if span is not None:
        span.add_event(name, **attrs)


def context_metadata(ctx: Optional[SpanContext] = None) -> list[tuple[str, str]]:
    """The gRPC metadata that carries `ctx` (default: the current span's) to
    a server; empty outside a span."""
    ctx = ctx or current_context()
    if ctx is None:
        return []
    return [(TRACE_ID_METADATA_KEY, ctx.trace_id), (SPAN_ID_METADATA_KEY, ctx.span_id)]


def extract_metadata(metadata: Any) -> Optional[SpanContext]:
    """The caller's span context from gRPC invocation metadata, if any."""
    if not metadata:
        return None
    md = dict(metadata)
    trace_id = md.get(TRACE_ID_METADATA_KEY, "")
    if not trace_id:
        return None
    return SpanContext(str(trace_id), str(md.get(SPAN_ID_METADATA_KEY, "")))


def format_context(ctx: Optional[SpanContext]) -> str:
    """`"trace_id:span_id"`: the one-string form an input carries to its
    container (FunctionGetInputsItem.trace_context, MODAL_TPU_TRACE_CONTEXT)."""
    return "" if ctx is None else f"{ctx.trace_id}:{ctx.span_id}"


def parse_context(value: Optional[str]) -> Optional[SpanContext]:
    if not value or ":" not in value:
        return None
    trace_id, _, span_id = value.partition(":")
    return SpanContext(trace_id, span_id) if trace_id else None


def context_from_env() -> Optional[SpanContext]:
    return parse_context(os.environ.get(TRACE_CONTEXT_ENV, ""))


def _child(name: str, parent: Optional[SpanContext], start: Optional[float], attrs) -> Span:
    ctx = parent or current_context()
    return Span(
        trace_id=ctx.trace_id if ctx else new_trace_id(),
        span_id=new_span_id(),
        parent_id=ctx.span_id if ctx else "",
        name=name,
        start=start if start is not None else time.time(),
        attrs=dict(attrs or {}),
    )


@contextmanager
def span(
    name: str,
    attrs: Optional[dict] = None,
    parent: Optional[SpanContext] = None,
) -> Iterator[Span]:
    """Open a span as the current one; written on exit."""
    sp = _child(name, parent, None, attrs)
    token = _current_span.set(sp)
    try:
        yield sp
    except BaseException as exc:
        sp.status = "error"
        sp.attrs.setdefault("error", f"{type(exc).__name__}: {exc}"[:300])
        raise
    finally:
        _current_span.reset(token)
        sp.end = time.time()
        _write(sp)


def open_span(
    name: str,
    parent: Optional[SpanContext] = None,
    start: Optional[float] = None,
    attrs: Optional[dict] = None,
) -> Span:
    """Manually managed span (close with `close_span`)."""
    return _child(name, parent, start, attrs)


def close_span(span: Span, status: str = "ok") -> None:
    span.end = time.time()
    span.status = status
    _write(span)


def record_span(
    name: str,
    start: float,
    end: float,
    parent: Optional[SpanContext] = None,
    attrs: Optional[dict] = None,
) -> None:
    """Record a retroactive span under `parent` (or the current span); a
    no-op with neither."""
    ctx = parent or current_context()
    if ctx is None:
        return
    _write(
        Span(
            trace_id=ctx.trace_id,
            span_id=new_span_id(),
            parent_id=ctx.span_id,
            name=name,
            start=start,
            end=end,
            attrs=dict(attrs or {}),
        )
    )
