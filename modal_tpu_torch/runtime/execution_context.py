"""Execution context: contextvars for the currently-running input (port of
modal_tpu/runtime/execution_context.py).

Reference: py/modal/_runtime/execution_context.py — `is_local`
(execution_context.py:13), `current_input_id`/`current_function_call_id`
(execution_context.py:40).
"""

from __future__ import annotations

from contextvars import ContextVar
from typing import Optional

_current_input_id: ContextVar[Optional[str]] = ContextVar("input_id", default=None)
_current_function_call_id: ContextVar[Optional[str]] = ContextVar("function_call_id", default=None)
_is_container: ContextVar[bool] = ContextVar("is_container", default=False)

_container_process = False


def _set_container_process() -> None:
    global _container_process
    _container_process = True


def is_local() -> bool:
    """True when running on the user's machine, False inside a container."""
    return not _container_process


def current_input_id() -> Optional[str]:
    return _current_input_id.get()


def current_trace_context() -> Optional[str]:
    """The distributed-trace context ("trace_id:span_id") of the current
    execution, for correlating user logs and metrics with the platform
    trace. Resolution: the active span (inside a
    container, the user.execute span of the current input; on the client,
    the function.call root) → the input's delivered context → the container
    boot context from MODAL_TPU_TRACE_CONTEXT → None."""
    from ..observability import tracing

    ctx = tracing.current_context()
    if ctx is not None:
        return tracing.format_context(ctx)
    input_id = _resolve_input_id()
    if input_id is not None:
        from .io_manager import ContainerIOManager

        io = ContainerIOManager.singleton()
        if io is not None and io.input_trace_contexts.get(input_id):
            return io.input_trace_contexts[input_id]
    return tracing.format_context(tracing.context_from_env()) or None


def current_function_call_id() -> Optional[str]:
    return _current_function_call_id.get()


def _set_current_context_ids(input_id: Optional[str], function_call_id: Optional[str]):
    t1 = _current_input_id.set(input_id)
    t2 = _current_function_call_id.set(function_call_id)

    def reset() -> None:
        _current_input_id.reset(t1)
        _current_function_call_id.reset(t2)

    return reset


def _resolve_input_id() -> Optional[str]:
    """The current input id, tolerating contexts that don't propagate the
    ContextVar (sync user code on the main-thread executor): with exactly one
    input in flight, it's unambiguous."""
    input_id = _current_input_id.get()
    if input_id is not None:
        return input_id
    from .io_manager import ContainerIOManager

    io = ContainerIOManager.singleton()
    if io is not None and len(io.current_input_ids) == 1:
        return next(iter(io.current_input_ids))
    return None


def resume_token() -> Optional[str]:
    """The resume token a prior preempted attempt of THIS input recorded via
    `set_resume_token` (redelivered with the input) — None on a fresh attempt.
    User code restarts from the checkpoint the token names instead of from
    scratch:

        start = int(execution_context.resume_token() or 0)
        for step in range(start, total_steps):
            ...
            execution_context.set_resume_token(str(step + 1))
    """
    from .io_manager import ContainerIOManager

    io = ContainerIOManager.singleton()
    input_id = _resolve_input_id()
    if io is None or input_id is None:
        return None
    return io.delivered_resume_tokens.get(input_id) or None


def set_resume_token(token: str) -> None:
    """Record the current input's resume token (e.g. a Volume checkpoint
    path, or a serialized progress cursor). If the worker is preempted
    mid-execution, the container flushes the latest token to the control
    plane (ContainerCheckpoint) inside the grace window, and the requeued
    attempt is redelivered with it. Cheap: a local dict write — call it at
    every checkpoint boundary. No-op outside a container."""
    from .io_manager import ContainerIOManager

    io = ContainerIOManager.singleton()
    input_id = _resolve_input_id()
    if io is None or input_id is None:
        return
    io.recorded_resume_tokens[input_id] = token
