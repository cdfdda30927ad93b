"""Remote classes: `@app.cls()` with lifecycle hooks and bound methods (port
of modal_tpu/cls.py).

Reference: py/modal/cls.py — `_Cls` (cls.py:447), `_Obj` (cls.py:142),
method binding through a single "service function" (`use_function_id` /
`use_method_name` on the Function proto), parameter binding via
FunctionBindParams, `with_options` (cls.py:722).

A class compiles to ONE service function (is_class=True) carrying the
serialized class; each `@method` is invoked by setting `method_name` on the
input. Instances with constructor parameters bind via FunctionBindParams so
parameterized warm pools keep separate containers (and separate warm state
on the card — weights stay resident per parameterization). A method's
`@batched` or `@concurrent` settings go to the service function, and so do
the webhook parameters of the one method that may carry a web decorator:
its container then serves HTTP (with the `@enter`-loaded state) instead of
polling the input queue, and `get_web_url` long-polls for its URL.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import typing
from typing import Any, Callable, Optional, Sequence

from ._utils.async_utils import synchronize_api
from ._utils.function_utils import FunctionInfo
from ._utils.grpc_utils import retry_transient_errors
from .client import _Client
from .exception import ExecutionError, InvalidError
from .functions import _Function, _Invocation, traced_call
from .object import LoadContext, Resolver, _Object
from .partial_function import (
    _PartialFunction,
    _PartialFunctionFlags,
    _PartialFunctionParams,
    find_partial_methods_for_user_cls,
)
from .proto import api_pb2
from .serialization import serialize

if typing.TYPE_CHECKING:
    from .app import _App


class _NoDefault:
    def __repr__(self) -> str:  # pragma: no cover — repr only
        return "<no default>"


_no_default = _NoDefault()


class _Parameter:
    """Marker returned by `modal_tpu_torch.parameter()` (reference cls.py:947)."""

    def __init__(self, default: Any, init: bool):
        self.default = default
        self.init = init


def parameter(*, default: Any = _no_default, init: bool = True) -> Any:
    """Declare a class parameter dataclass-field-style (reference
    modal.parameter, cls.py:947):

        @app.cls()
        class Model:
            name: str = modal_tpu_torch.parameter(default="tiny")
            cache: dict = modal_tpu_torch.parameter(init=False)

    A synthesized keyword-only constructor accepts the `init=True` fields;
    `init=False` exists purely to type-annotate state set by lifecycle
    hooks. Returns Any so it is assignable under any annotation."""
    return _Parameter(default=default, init=init)


def _apply_parameter_constructor(user_cls: type) -> None:
    """Synthesize `__init__` from `parameter()` annotations when the class
    declares them and no explicit constructor. Runs BEFORE the class is
    cloudpickled, so the container instantiates through the same synthesized
    constructor without any server-side knowledge of the mechanism."""
    fields: dict[str, _Parameter] = {
        name: value
        for name, value in vars(user_cls).items()
        if isinstance(value, _Parameter)
    }
    if not fields:
        return
    if "__init__" in vars(user_cls):
        raise InvalidError(
            f"class {user_cls.__name__} mixes modal_tpu_torch.parameter() fields with an "
            "explicit __init__ — use one or the other"
        )
    init_fields = {n: p for n, p in fields.items() if p.init}

    def __init__(self, **kwargs: Any) -> None:  # noqa: N807
        unknown = set(kwargs) - set(init_fields)
        if unknown:
            raise TypeError(
                f"{type(self).__name__}() got unexpected parameters {sorted(unknown)} "
                f"(declared: {sorted(init_fields)})"
            )
        for name, param in init_fields.items():
            if name in kwargs:
                setattr(self, name, kwargs[name])
            elif not isinstance(param.default, _NoDefault):
                setattr(self, name, param.default)
            else:
                raise TypeError(f"{type(self).__name__}() missing required parameter {name!r}")
        # init=False fields WITH a default still get it (a default that
        # silently vanished would be a trap); defaultless ones stay unset
        # until a lifecycle hook assigns them
        for name, param in fields.items():
            if not param.init and not isinstance(param.default, _NoDefault):
                setattr(self, name, param.default)

    # a real signature so binding context and docs see the parameter names
    __init__.__signature__ = inspect.Signature(
        [inspect.Parameter("self", inspect.Parameter.POSITIONAL_OR_KEYWORD)]
        + [
            inspect.Parameter(
                name,
                inspect.Parameter.KEYWORD_ONLY,
                default=(
                    inspect.Parameter.empty
                    if isinstance(p.default, _NoDefault)
                    else p.default
                ),
            )
            for name, p in init_fields.items()
        ]
    )
    user_cls.__init__ = __init__
    # the markers must not linger as class attributes (an un-set init=False
    # field should raise AttributeError, not return the marker)
    for name in fields:
        delattr(user_cls, name)


class _Obj:
    """An instance of a remote class: binds constructor params + methods
    (reference _Obj, cls.py:142)."""

    def __init__(self, cls: "_Cls", args: tuple, kwargs: dict):
        self._cls = cls
        self._args = args
        self._kwargs = kwargs
        self._bound_function: Optional[_Function] = None
        self._method_cache: dict[str, _Function] = {}
        # eager parameter validation (reference _Obj validates at creation):
        # a bad parameterization must raise HERE, not as a container init
        # failure minutes later
        user_cls = getattr(cls, "_user_cls", None)
        if user_cls is not None and "__init__" in vars(user_cls):
            try:
                inspect.signature(user_cls.__init__).bind(None, *args, **kwargs)
            except TypeError as exc:
                raise InvalidError(f"invalid parameters for {user_cls.__name__}: {exc}") from None

    async def _get_bound_function(self) -> _Function:
        if self._bound_function is not None:
            return self._bound_function
        service = self._cls._service_function
        assert service is not None
        if not service.is_hydrated:
            await service.hydrate()
        options = self._cls._options
        if not self._args and not self._kwargs and options is None:
            self._bound_function = service
        else:
            req = api_pb2.FunctionBindParamsRequest(
                function_id=service.object_id,
                serialized_params=(
                    serialize((self._args, self._kwargs)) if (self._args or self._kwargs) else b""
                ),
            )
            if options is not None:
                req.options.CopyFrom(options)
            resp = await retry_transient_errors(service.client.stub.FunctionBindParams, req)
            bound = _Function._new_hydrated(resp.bound_function_id, service.client, resp.handle_metadata)
            self._bound_function = bound
        return self._bound_function

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._cls._method_partials:
            return _BoundMethod(self, name)
        # non-method attribute: construct locally for local access
        if self._cls._user_cls is not None and hasattr(self._cls._user_cls, name):
            raise InvalidError(
                f"{name} is not a @method; only methods can be accessed on remote class instances"
            )
        raise AttributeError(name)


class _BoundMethod:
    """Callable handle for `instance.method` supporting .remote/.local/.spawn/.map."""

    def __init__(self, obj: _Obj, method_name: str):
        self._obj = obj
        self._method_name = method_name

    async def _invoke(self, args: tuple, kwargs: dict, invocation_type: int) -> Any:
        fn = await self._obj._get_bound_function()
        invocation = await _Invocation.create(
            fn, args, kwargs, client=fn.client, invocation_type=invocation_type, method_name=self._method_name
        )
        return invocation

    async def remote(self, *args: Any, **kwargs: Any) -> Any:
        """The method's call, under the `function.call` root span that a
        function's `.remote()` opens (functions.py), so `app trace` and `app
        attribute` see method calls too; the JAX package's method calls open
        no root span."""
        fn = await self._obj._get_bound_function()
        return await traced_call(
            {"function_id": fn.object_id or "", "function": f"{fn.tag}.{self._method_name}"},
            functools.partial(self._invoke, args, kwargs, api_pb2.FUNCTION_CALL_INVOCATION_TYPE_SYNC),
        )

    async def remote_gen(self, *args: Any, **kwargs: Any):
        invocation = await self._invoke(args, kwargs, api_pb2.FUNCTION_CALL_INVOCATION_TYPE_SYNC)
        async for item in invocation.run_generator():
            yield item

    async def spawn(self, *args: Any, **kwargs: Any):
        from .functions import _FunctionCall

        invocation = await self._invoke(args, kwargs, api_pb2.FUNCTION_CALL_INVOCATION_TYPE_ASYNC)
        fn = await self._obj._get_bound_function()
        return _FunctionCall._new_hydrated(invocation.function_call_id, fn.client, None)

    def local(self, *args: Any, **kwargs: Any) -> Any:
        cls = self._obj._cls
        if cls._user_cls is None:
            raise ExecutionError("class has no local definition")
        instance = cls._user_cls(*self._obj._args, **self._obj._kwargs)
        raw_f = cls._method_partials[self._method_name].raw_f
        return raw_f(instance, *args, **kwargs)

    def map(self, *input_iterators, kwargs={}, order_outputs=True, return_exceptions=False):
        from .parallel_map import _map_sync

        # the bound function from the caller's thread (its blocking surface),
        # as a handle whose inputs name this method
        fn = self._obj._get_bound_function().clone()
        fn._use_method_name = self._method_name
        return _map_sync(
            fn, *input_iterators, kwargs=kwargs, order_outputs=order_outputs, return_exceptions=return_exceptions
        )


class _Cls(_Object, type_prefix="cs"):
    _user_cls: Optional[type] = None
    _service_function: Optional[_Function] = None
    _method_partials: dict[str, _PartialFunction] = {}
    _app: Optional["_App"] = None
    _name: Optional[str] = None
    _options: Optional[api_pb2.FunctionOptions] = None

    def _initialize_from_empty(self) -> None:
        self._user_cls = None
        self._service_function = None
        self._method_partials = {}
        self._options = None

    def _hydrate_metadata(self, metadata: Optional[api_pb2.ClassHandleMetadata]) -> None:
        pass

    @staticmethod
    def from_local(user_cls: type, app: "_App", **function_kwargs: Any) -> "_Cls":
        """Compile a user class into a service function + method table
        (reference cls.py from_local/_Cls)."""
        _apply_parameter_constructor(user_cls)
        method_partials = find_partial_methods_for_user_cls(user_cls, _PartialFunctionFlags.FUNCTION)
        for pf in method_partials.values():
            pf.wrapped = True
        # lifecycle partials get marked too so __del__ doesn't warn
        for pf in find_partial_methods_for_user_cls(user_cls, _PartialFunctionFlags.all()).values():
            pf.wrapped = True
        # ONE method may carry @asgi_app/@wsgi_app/@web_endpoint/@web_server:
        # the class's service function adopts its webhook params, so the
        # container serves HTTP (with @enter-loaded state) instead of
        # polling the input queue
        web_partials = find_partial_methods_for_user_cls(user_cls, _PartialFunctionFlags.WEB_ENDPOINT)
        if len(web_partials) > 1:
            raise InvalidError(
                f"class {user_cls.__name__} has multiple web-endpoint methods "
                f"({sorted(web_partials)}); a class serves at most one"
            )
        web_method_name, web_pf = next(iter(web_partials.items()), (None, None))
        # batched/concurrent settings of the methods go to the one service
        # function
        merged = _PartialFunctionParams()
        for pf in method_partials.values():
            merged.update(pf.params)
        info = FunctionInfo(None, serialized=True, user_cls=user_cls)
        # the service function goes through the app.function machinery to
        # share its parameter validation; classes always serialize
        function_kwargs.pop("serialized", None)
        function_kwargs.pop("name", None)
        service_stub: Any = _class_service_stub(user_cls)
        if web_pf is not None:
            # the web method's webhook params reach app.function through the
            # partial-function vehicle it already reads
            service_stub = _PartialFunction(
                service_stub,
                _PartialFunctionFlags.FUNCTION | _PartialFunctionFlags.WEB_ENDPOINT,
                dataclasses.replace(web_pf.params),
            )
        service_function = app.function(serialized=True, name=user_cls.__name__, **function_kwargs)(service_stub)
        spec = service_function.spec
        if web_method_name is not None:
            spec.experimental_options["web_method_name"] = web_method_name
            # the web method rides the method table, so the container can
            # resolve its bound callable (runtime/user_code.py)
            method_partials = {**method_partials, web_method_name: web_pf}
        spec.batch_max_size = merged.batch_max_size or 0
        spec.batch_wait_ms = merged.batch_wait_ms or 0
        spec.max_concurrent_inputs = merged.max_concurrent_inputs or 0
        spec.target_concurrent_inputs = merged.target_concurrent_inputs or 0

        # Patch the loader inputs: mark as class + attach serialized class.
        service_function._info = info
        class_ser = serialize(user_cls)

        async def _load(self: "_Cls", resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
            await resolver.load(service_function, context)
            # class object id derives from the service function id
            self._hydrate("cs-" + service_function.object_id.split("-", 1)[1], context.client, None)

        cls_obj = _Cls._from_loader(_load, f"Cls({user_cls.__name__})", deps=lambda: [service_function])
        cls_obj._user_cls = user_cls
        cls_obj._service_function = service_function
        cls_obj._method_partials = method_partials
        cls_obj._app = app
        cls_obj._name = user_cls.__name__

        _mark_function_as_class(service_function, user_cls, class_ser, method_partials)
        return cls_obj

    @staticmethod
    def from_name(app_name: str, name: str, *, environment_name: Optional[str] = None) -> "_Cls":
        async def _load(self: "_Cls", resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
            service = _Function.from_name(app_name, name)
            await resolver.load(service, context)
            self._service_function = service
            self._hydrate("cs-" + service.object_id.split("-", 1)[1], context.client, None)
            # remote classes expose methods listed in metadata
            self._method_partials = {}

        obj = _Cls._from_loader(_load, f"Cls.from_name({app_name!r}, {name!r})", hydrate_lazily=True)
        return obj

    @staticmethod
    async def lookup(app_name: str, name: str, *, client: Optional[_Client] = None) -> "_Cls":
        obj = _Cls.from_name(app_name, name)
        await obj.hydrate(client)
        return obj

    def with_options(
        self,
        *,
        min_containers: Optional[int] = None,
        max_containers: Optional[int] = None,
        buffer_containers: Optional[int] = None,
        scaledown_window: Optional[int] = None,
        timeout: Optional[int] = None,
        gpu: Optional[str] = None,
        retries: Optional[Any] = None,
        max_concurrent_inputs: Optional[int] = None,
        secrets: Sequence[Any] = (),
    ) -> "_Cls":
        """A variant of this class with rebinding-time overrides (reference
        cls.py:722 `with_options`): instances bind through FunctionBindParams
        carrying the overrides, so the variant gets its own containers with
        the adjusted autoscaler/card ask/timeout/retries/secrets."""
        import copy

        from .functions import build_function_options

        new_cls = copy.copy(self)
        new_cls._options = build_function_options(
            min_containers=min_containers,
            max_containers=max_containers,
            buffer_containers=buffer_containers,
            scaledown_window=scaledown_window,
            timeout=timeout,
            gpu=gpu,
            retries=retries,
            max_concurrent_inputs=max_concurrent_inputs,
            secrets=secrets,
        )
        return new_cls

    def __call__(self, *args: Any, **kwargs: Any) -> _Obj:
        """Instantiate: returns an _Obj binding constructor params."""
        return _Obj(self, args, kwargs)

    async def get_web_url(self, timeout: float = 60.0) -> str:
        """URL of the class's web-endpoint method (the service function's
        web URL: one per class)."""
        if self._service_function is None:
            raise ExecutionError("class has no service function (not hydrated?)")
        return await self._service_function.get_web_url(timeout)


def _class_service_stub(user_cls: type) -> Callable:
    """Placeholder callable the service function wraps; the container
    runtime replaces it with real class dispatch."""

    def _service(*args: Any, **kwargs: Any) -> Any:
        raise ExecutionError(f"class service function for {user_cls.__name__} must run in a container")

    _service.__name__ = user_cls.__name__
    return _service


def _mark_function_as_class(
    fn: _Function, user_cls: type, class_serialized: bytes, method_partials: dict[str, _PartialFunction]
) -> None:
    """Wrap the function's loader so FunctionCreate carries class info."""
    inner_load = fn._load

    async def _load(self: _Function, resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
        # intercept the FunctionCreate call by monkey-wrapping the stub? No —
        # re-issue with class fields via experimental_options is cleaner.
        self._spec.experimental_options["is_class"] = "1"
        self._spec.experimental_options["methods"] = ",".join(sorted(method_partials.keys()))
        gen_methods = [
            name
            for name, pf in method_partials.items()
            if pf.params.is_generator
            or inspect.isgeneratorfunction(pf.raw_f)
            or inspect.isasyncgenfunction(pf.raw_f)
        ]
        self._spec.experimental_options["generator_methods"] = ",".join(sorted(gen_methods))
        self._class_serialized_bytes = class_serialized
        await inner_load(self, resolver, context, existing_object_id)

    fn._load = _load


Cls = synchronize_api(_Cls)
Obj = synchronize_api(_Obj)
BoundMethod = synchronize_api(_BoundMethod)
