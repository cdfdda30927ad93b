"""User code import + service abstraction (port of
modal_tpu/runtime/user_code.py).

Reference: py/modal/_runtime/user_code_imports.py — `Service`
(user_code_imports.py:118), `import_single_function_service` /
`import_class_service` (user_code_imports.py:473,571), lifecycle hook
collection.

A container gets a serialized function or class (the port's cloudpickle
payload in `function_serialized` / `class_serialized`), or a plain function
or class by module and name. The JAX package also unwraps its `Function`
and `Cls` handles found at that name; the port's come with its App slice
(ROADMAP Queue A 4c).
"""

from __future__ import annotations

import importlib
import importlib.util
import inspect
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..exception import ExecutionError
from ..partial_function import _PartialFunction, _PartialFunctionFlags, find_callables_for_obj
from ..proto import api_pb2
from ..serialization import deserialize


@dataclass
class Service:
    """What the entrypoint needs to run inputs: the target callable(s) plus
    lifecycle hooks."""

    user_callable: Optional[Callable] = None  # plain function
    user_instance: Any = None  # class instance (for method dispatch)
    method_callables: dict[str, Callable] = field(default_factory=dict)
    generator_methods: set[str] = field(default_factory=set)
    enter_pre_snapshot: list[Callable] = field(default_factory=list)
    enter_post_snapshot: list[Callable] = field(default_factory=list)
    exit_hooks: list[Callable] = field(default_factory=list)
    is_generator: bool = False

    def get_callable(self, method_name: str = "") -> Callable:
        if method_name:
            if method_name not in self.method_callables:
                raise ExecutionError(f"method {method_name!r} not found on service")
            return self.method_callables[method_name]
        if self.user_callable is None:
            raise ExecutionError("service has no callable")
        return self.user_callable

    def is_gen(self, method_name: str = "") -> bool:
        if method_name:
            return method_name in self.generator_methods
        return self.is_generator


def _import_module_from_path(module_name: str, file_path: str):
    spec = importlib.util.spec_from_file_location(module_name, file_path)
    if spec is None or spec.loader is None:
        raise ExecutionError(f"can't import user module from {file_path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def _resolve_attr(module: Any, qualname: str) -> Any:
    obj = module
    for part in qualname.split("."):
        if part == "<locals>":
            raise ExecutionError(f"can't import local function {qualname}; serialize it instead")
        obj = getattr(obj, part)
    return obj


def _plain_object(obj: Any, name: str) -> Any:
    """A module attribute the port can run: a plain function or class (or a
    partial function's raw function). The JAX package's Function and Cls
    handles come with the port's App slice."""
    if isinstance(obj, _PartialFunction):
        return obj.raw_f
    if not (inspect.isfunction(obj) or inspect.isclass(obj)):
        raise ExecutionError(
            f"{name} is a {type(obj).__name__}: a container of the port runs plain functions and classes, "
            "or serialized ones; Function and Cls handles come with its App slice (ROADMAP Queue A 4c)"
        )
    return obj


def import_function(function_def: api_pb2.Function, client: Any) -> Callable:
    """The raw callable of a plain function."""
    if function_def.definition_type == "serialized":
        if not function_def.function_serialized:
            raise ExecutionError("serialized function has no payload")
        return deserialize(function_def.function_serialized, client)
    module_name = function_def.module_name
    main_path = function_def.experimental_options.get("main_file_path", "")
    if module_name == "__main__" and main_path:
        module = _import_module_from_path("__modal_tpu_main__", main_path)
    else:
        module = importlib.import_module(module_name)
    return _plain_object(_resolve_attr(module, function_def.function_name), function_def.function_name)


def import_single_function_service(function_def: api_pb2.Function, client: Any) -> Service:
    return Service(
        user_callable=import_function(function_def, client),
        is_generator=function_def.function_type == api_pb2.FUNCTION_TYPE_GENERATOR,
    )


def import_class_service(function_def: api_pb2.Function, client: Any, bound_params: Optional[tuple] = None) -> Service:
    """Instantiate the user class and wire its lifecycle hooks and method
    table: the methods named in `experimental_options["methods"]`, the
    generators among them in `["generator_methods"]`."""
    if function_def.class_serialized:
        user_cls = deserialize(function_def.class_serialized, client)
    else:
        module = importlib.import_module(function_def.module_name)
        attr = function_def.function_name.split(".")[0]
        user_cls = _plain_object(_resolve_attr(module, attr), attr)

    args, kwargs = bound_params if bound_params else ((), {})
    user_instance = user_cls(*args, **kwargs)

    method_names = [m for m in function_def.experimental_options.get("methods", "").split(",") if m]
    generator_methods = {m for m in function_def.experimental_options.get("generator_methods", "").split(",") if m}
    method_callables: dict[str, Callable] = {}
    for name in method_names:
        pf = getattr(user_cls, name, None)
        if isinstance(pf, _PartialFunction):
            method_callables[name] = pf.raw_f.__get__(user_instance)
        elif callable(pf):
            method_callables[name] = pf.__get__(user_instance) if inspect.isfunction(pf) else pf
        else:
            bound = getattr(user_instance, name, None)
            if bound is None:
                raise ExecutionError(f"method {name!r} not found on {user_cls.__name__}")
            method_callables[name] = bound

    return Service(
        user_instance=user_instance,
        method_callables=method_callables,
        generator_methods=generator_methods,
        enter_pre_snapshot=list(
            find_callables_for_obj(user_instance, _PartialFunctionFlags.ENTER_PRE_SNAPSHOT).values()
        ),
        enter_post_snapshot=list(
            find_callables_for_obj(user_instance, _PartialFunctionFlags.ENTER_POST_SNAPSHOT).values()
        ),
        exit_hooks=list(find_callables_for_obj(user_instance, _PartialFunctionFlags.EXIT).values()),
    )
