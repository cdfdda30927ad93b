"""Decorator flag algebra for methods and lifecycle hooks (port of
modal_tpu/partial_function.py).

Reference: py/modal/_partial_function.py — `_PartialFunction`
(_partial_function.py:116), `_PartialFunctionFlags` (_partial_function.py:29),
decorators `_method/_enter/_exit/_batched/_concurrent/_clustered`
(_partial_function.py:283,589,617,640,701,780).

A `PartialFunction` wraps a user function inside a class body (or a bare
function for `@batched`, `@concurrent` and the web decorators) and records
*how* it should run: as a callable method, a lifecycle hook, batched,
with input concurrency, or as a web endpoint. The App writes the batching,
concurrency and webhook parameters into the function definition; the
container runtime reads the flags off a serialized class
(runtime/user_code.py). `@clustered(size)` makes a function a gang: `size`
containers per call, each rank on its own cards, meeting in a
torch.distributed process group before the user's code runs
(runtime/clustered.py).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable, Optional

from .exception import InvalidError


class _PartialFunctionFlags(enum.IntFlag):
    FUNCTION = 1
    ENTER_PRE_SNAPSHOT = 2
    ENTER_POST_SNAPSHOT = 4
    EXIT = 8
    BATCHED = 16
    CONCURRENT = 32
    CLUSTERED = 64
    WEB_ENDPOINT = 128

    @staticmethod
    def all() -> "_PartialFunctionFlags":
        return ~_PartialFunctionFlags(0)


@dataclass
class _PartialFunctionParams:
    is_generator: Optional[bool] = None
    batch_max_size: Optional[int] = None
    batch_wait_ms: Optional[int] = None
    max_concurrent_inputs: Optional[int] = None
    target_concurrent_inputs: Optional[int] = None
    # web endpoints (reference @modal.asgi_app/wsgi_app/web_endpoint)
    webhook_type: Optional[int] = None  # api_pb2.WebEndpointType
    web_method: Optional[str] = None  # plain-function endpoints: HTTP method
    # @web_server: the in-container port the user's server binds
    web_server_port: Optional[int] = None
    web_server_startup_timeout: Optional[float] = None
    # @clustered: the gang's size, whether each input reaches every rank,
    # and the ranks that must share one fabric
    cluster_size: Optional[int] = None
    broadcast_inputs: bool = True
    fabric_size: Optional[int] = None

    def update(self, other: "_PartialFunctionParams") -> None:
        for f in self.__dataclass_fields__:
            v = getattr(other, f)
            if v is not None and v != self.__dataclass_fields__[f].default:
                setattr(self, f, v)


class _PartialFunction:
    """Intermediate decorator state (reference _partial_function.py:116)."""

    def __init__(
        self,
        raw_f: Callable,
        flags: _PartialFunctionFlags,
        params: Optional[_PartialFunctionParams] = None,
    ):
        self.raw_f = raw_f
        self.flags = flags
        self.params = params or _PartialFunctionParams()
        self.wrapped = False  # set when consumed by @app.cls / @app.function
        self.registered = False

    @property
    def name(self) -> str:
        return self.raw_f.__name__

    def add_flags(self, flags: _PartialFunctionFlags, params: Optional[_PartialFunctionParams] = None):
        import dataclasses

        # The inner partial is consumed by the new one: mark it wrapped so its
        # __del__ doesn't warn, and copy params so stacked decorators don't
        # share mutable state.
        self.wrapped = True
        new = _PartialFunction(self.raw_f, self.flags | flags, dataclasses.replace(self.params))
        if params:
            new.params.update(params)
        return new

    def __get__(self, obj: Any, objtype: Optional[type] = None) -> Any:
        # Accessing an un-wrapped partial method on an instance: return the
        # raw function bound, so local calls still work.
        if obj is None:
            return self
        return self.raw_f.__get__(obj, objtype)

    def __del__(self) -> None:
        if not self.wrapped and not self.registered:
            import warnings

            try:
                warnings.warn(
                    f"method {self.name} was decorated but never attached to an app class"
                )
            except Exception:
                pass


def method(
    _warn_parentheses_missing: Any = None,
    *,
    is_generator: Optional[bool] = None,
) -> Callable[[Callable], _PartialFunction]:
    """Mark an `@app.cls` method as remotely callable (reference
    _partial_function.py:283)."""
    if _warn_parentheses_missing is not None:
        raise InvalidError("Use @modal_tpu_torch.partial_function.method() with parentheses.")

    def wrapper(raw_f: Callable) -> _PartialFunction:
        if isinstance(raw_f, _PartialFunction):
            return raw_f.add_flags(
                _PartialFunctionFlags.FUNCTION, _PartialFunctionParams(is_generator=is_generator)
            )
        return _PartialFunction(
            raw_f, _PartialFunctionFlags.FUNCTION, _PartialFunctionParams(is_generator=is_generator)
        )

    return wrapper


def enter(
    _warn_parentheses_missing: Any = None,
    *,
    snap: bool = False,
) -> Callable:
    """Lifecycle hook run at container start (reference
    _partial_function.py:617). With ``snap=True`` the hook runs *before* the
    warm-state snapshot is taken (weights load etc.), and a boot that
    restores the snapshot skips it (runtime/snapshot.py)."""
    if _warn_parentheses_missing is not None:
        raise InvalidError("Use @modal_tpu_torch.partial_function.enter() with parentheses.")
    flag = _PartialFunctionFlags.ENTER_PRE_SNAPSHOT if snap else _PartialFunctionFlags.ENTER_POST_SNAPSHOT

    def wrapper(raw_f: Callable):
        if isinstance(raw_f, _PartialFunction):
            return raw_f.add_flags(flag)
        return _PartialFunction(raw_f, flag)

    return wrapper


def exit(_warn_parentheses_missing: Any = None) -> Callable:  # noqa: A001
    """Lifecycle hook run at container shutdown (reference
    _partial_function.py:640)."""
    if _warn_parentheses_missing is not None:
        raise InvalidError("Use @modal_tpu_torch.partial_function.exit() with parentheses.")

    def wrapper(raw_f: Callable):
        if isinstance(raw_f, _PartialFunction):
            return raw_f.add_flags(_PartialFunctionFlags.EXIT)
        return _PartialFunction(raw_f, _PartialFunctionFlags.EXIT)

    return wrapper


def batched(
    _warn_parentheses_missing: Any = None,
    *,
    max_batch_size: int,
    wait_ms: int,
) -> Callable:
    """Dynamic input batching (reference _partial_function.py:701): inputs are
    grouped up to `max_batch_size` or until `wait_ms` lingers, then the user
    function receives lists: the mechanism that keeps a card's tensor cores
    fed with one call per batch."""
    if _warn_parentheses_missing is not None:
        raise InvalidError("Use @modal_tpu_torch.batched() with parentheses.")
    if max_batch_size < 1:
        raise InvalidError("max_batch_size must be >= 1")
    if wait_ms < 0:
        raise InvalidError("wait_ms must be >= 0")

    def wrapper(raw_f: Callable):
        params = _PartialFunctionParams(batch_max_size=max_batch_size, batch_wait_ms=wait_ms)
        if isinstance(raw_f, _PartialFunction):
            return raw_f.add_flags(_PartialFunctionFlags.BATCHED, params)
        return _PartialFunction(raw_f, _PartialFunctionFlags.FUNCTION | _PartialFunctionFlags.BATCHED, params)

    return wrapper


def concurrent(
    _warn_parentheses_missing: Any = None,
    *,
    max_inputs: int,
    target_inputs: Optional[int] = None,
) -> Callable:
    """Input concurrency within one container (reference
    _partial_function.py:640 `_concurrent`)."""
    if _warn_parentheses_missing is not None:
        raise InvalidError("Use @modal_tpu_torch.concurrent() with parentheses.")
    if target_inputs and target_inputs > max_inputs:
        raise InvalidError("target_inputs must be <= max_inputs")

    def wrapper(raw_f: Callable):
        params = _PartialFunctionParams(
            max_concurrent_inputs=max_inputs, target_concurrent_inputs=target_inputs or max_inputs
        )
        if isinstance(raw_f, _PartialFunction):
            return raw_f.add_flags(_PartialFunctionFlags.CONCURRENT, params)
        return _PartialFunction(raw_f, _PartialFunctionFlags.FUNCTION | _PartialFunctionFlags.CONCURRENT, params)

    return wrapper


def clustered(
    size: int,
    broadcast_inputs: bool = True,
    tpu_slice: Optional[str] = None,
    fabric_size: Optional[int] = None,
    require_single_slice: bool = False,
) -> Callable:
    """Gang-schedule `size` containers per call (reference
    `@modal.experimental.clustered(size, broadcast, rdma, fabric_size)`,
    _partial_function.py:780-827). The plane places every rank before any
    starts, each on the cards its `gpu=` asks for, and hands out ranks and a
    coordinator at TaskClusterHello; the container joins a torch.distributed
    process group there before the user's code runs. With
    `broadcast_inputs` every rank receives each input and rank 0's result is
    the call's. `tpu_slice=` and `require_single_slice=` place TPU pod
    slices, which the port does not: ask for cards with gpu=."""
    if size < 1:
        raise InvalidError("cluster size must be >= 1")
    if tpu_slice or require_single_slice:
        raise InvalidError("tpu_slice= and require_single_slice= place TPU pod slices, which the port does not: "
                           "ask for cards with gpu=")

    def wrapper(raw_f: Callable):
        params = _PartialFunctionParams(cluster_size=size, broadcast_inputs=broadcast_inputs, fabric_size=fabric_size)
        if isinstance(raw_f, _PartialFunction):
            if not (raw_f.flags & _PartialFunctionFlags.FUNCTION):
                raise InvalidError("@clustered must wrap a function or @method")
            return raw_f.add_flags(_PartialFunctionFlags.CLUSTERED, params)
        return _PartialFunction(raw_f, _PartialFunctionFlags.FUNCTION | _PartialFunctionFlags.CLUSTERED, params)

    return wrapper


def find_partial_methods_for_user_cls(user_cls: type, flags: int) -> dict[str, _PartialFunction]:
    """Grab all partial methods matching `flags` from a user class body
    (reference _partial_function.py find_partial_methods_for_user_cls)."""
    out: dict[str, _PartialFunction] = {}
    for parent_cls in reversed(user_cls.__mro__):
        if parent_cls is object:
            continue
        for k, v in vars(parent_cls).items():
            if isinstance(v, _PartialFunction) and (v.flags & flags):
                v.registered = True
                out[k] = v
    return out


def find_callables_for_obj(user_obj: Any, flags: int) -> dict[str, Callable]:
    """Bound callables for lifecycle hook execution."""
    user_cls = type(user_obj)
    return {
        k: pf.raw_f.__get__(user_obj)
        for k, pf in find_partial_methods_for_user_cls(user_cls, flags).items()
    }


def _web_decorator(webhook_type_name: str, method: Optional[str] = None):
    """Shared factory for the web decorators (they differ only in
    webhook_type and the optional HTTP-method param)."""
    from .proto import api_pb2

    def wrapper(raw_f: Callable) -> _PartialFunction:
        # fresh params per decorated function — no shared mutable state
        params = _PartialFunctionParams(
            webhook_type=getattr(api_pb2, webhook_type_name), web_method=method
        )
        if isinstance(raw_f, _PartialFunction):
            if raw_f.params.webhook_type is not None:
                raise InvalidError(f"{raw_f.name} already has a web decorator")
            return raw_f.add_flags(_PartialFunctionFlags.WEB_ENDPOINT, params)
        return _PartialFunction(raw_f, _PartialFunctionFlags.WEB_ENDPOINT, params)

    return wrapper


def web_endpoint(
    _warn_parentheses_missing: Any = None,
    *,
    method: str = "POST",
) -> Callable[[Callable], _PartialFunction]:
    """Expose a plain function as a JSON HTTP endpoint (the reference wraps
    these with fastapi, reference _partial_function.py web_endpoint; here a
    dependency-free JSON adapter, runtime/asgi.py function_to_asgi)."""
    if _warn_parentheses_missing is not None:
        raise InvalidError("Use @modal_tpu_torch.web_endpoint() with parentheses.")
    return _web_decorator("WEB_ENDPOINT_TYPE_FUNCTION", method=method)


def fastapi_endpoint(
    _warn_parentheses_missing: Any = None,
    *,
    method: str = "POST",
) -> Callable[[Callable], _PartialFunction]:
    """Alias of web_endpoint matching the reference's current decorator name
    (modal.fastapi_endpoint): a dependency-free JSON adapter rather than a
    fastapi wrapper, with the same request/response contract."""
    return web_endpoint(_warn_parentheses_missing, method=method)


def web_server(
    _warn_parentheses_missing: Any = None,
    *,
    port: int,
    startup_timeout: float = 60.0,
) -> Callable[[Callable], _PartialFunction]:
    """Expose a server the function starts on `port` (reference
    @modal.web_server): the decorated function launches its own HTTP server
    (subprocess or thread) and returns; the container reverse-proxies the
    web URL to 127.0.0.1:port once it accepts connections."""
    if _warn_parentheses_missing is not None:
        raise InvalidError("Use @modal_tpu_torch.web_server() with parentheses.")
    if port < 1 or port > 65535:
        raise InvalidError(f"invalid port {port}")

    def wrapper(raw_f: Callable) -> _PartialFunction:
        from .proto import api_pb2

        params = _PartialFunctionParams(
            webhook_type=api_pb2.WEB_ENDPOINT_TYPE_WEB_SERVER,
            web_server_port=port,
            web_server_startup_timeout=startup_timeout,
        )
        if isinstance(raw_f, _PartialFunction):
            if raw_f.params.webhook_type is not None:
                raise InvalidError(f"{raw_f.name} already has a web decorator")
            return raw_f.add_flags(_PartialFunctionFlags.WEB_ENDPOINT, params)
        return _PartialFunction(raw_f, _PartialFunctionFlags.WEB_ENDPOINT, params)

    return wrapper


def asgi_app(
    _warn_parentheses_missing: Any = None,
) -> Callable[[Callable], _PartialFunction]:
    """The decorated function RETURNS an ASGI app, served from the container
    (reference @modal.asgi_app, _runtime/asgi.py)."""
    if _warn_parentheses_missing is not None:
        raise InvalidError("Use @modal_tpu_torch.asgi_app() with parentheses.")
    return _web_decorator("WEB_ENDPOINT_TYPE_ASGI_APP")


def wsgi_app(
    _warn_parentheses_missing: Any = None,
) -> Callable[[Callable], _PartialFunction]:
    """The decorated function RETURNS a WSGI app (flask-style), served via
    the threaded WSGI bridge (reference @modal.wsgi_app / vendored a2wsgi)."""
    if _warn_parentheses_missing is not None:
        raise InvalidError("Use @modal_tpu_torch.wsgi_app() with parentheses.")
    return _web_decorator("WEB_ENDPOINT_TYPE_WSGI_APP")
