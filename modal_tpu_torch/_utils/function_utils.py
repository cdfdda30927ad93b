"""Function introspection: how a user function is found again in a container
(port of modal_tpu/_utils/function_utils.py).

Reference: py/modal/_utils/function_utils.py — `FunctionInfo` (module/qualname
resolution, serialized-vs-file definition types), `OUTPUTS_TIMEOUT`
(function_utils.py:474).
"""

from __future__ import annotations

import inspect
import os
import sys
from typing import Callable, Optional

from ..exception import InvalidError
from ..proto import api_pb2

# Long-poll window for output fetching (reference function_utils.py:474-475).
OUTPUTS_TIMEOUT = 55.0
ATTEMPT_TIMEOUT_GRACE_PERIOD = 5.0


class FunctionInfo:
    """Resolves a user callable to (module_name, qualname, definition_type).

    definition_type "file": the container re-imports `module_name` and walks
    `qualname`. definition_type "serialized": the callable is cloudpickled
    into the Function proto (used for notebooks, closures, and tests).
    """

    def __init__(
        self,
        f: Optional[Callable],
        serialized: bool = False,
        name_override: Optional[str] = None,
        user_cls: Optional[type] = None,
    ):
        self.raw_f = f
        self.user_cls = user_cls
        self._serialized = serialized

        if name_override is not None:
            self.function_name = name_override
        elif f is None and user_cls is not None:
            self.function_name = user_cls.__name__
        elif user_cls is not None:
            self.function_name = f"{user_cls.__name__}.{f.__name__}"
        else:
            assert f is not None
            self.function_name = f.__qualname__

        target = user_cls if user_cls is not None else f
        module = inspect.getmodule(target) if target is not None else None

        if serialized:
            self.module_name = None
            self.file_path = None
        elif module is None or module.__name__ == "__main__":
            # __main__ scripts can't be re-imported by name in the container;
            # record the file path so the runtime can import it by path.
            self.module_name = "__main__"
            try:
                self.file_path = os.path.abspath(inspect.getfile(target)) if target is not None else None
            except (TypeError, OSError):
                self.file_path = None
            if self.file_path is None:
                self._serialized = True
        else:
            self.module_name = module.__name__
            try:
                self.file_path = os.path.abspath(module.__file__) if module.__file__ else None
            except (TypeError, AttributeError):
                self.file_path = None

    @property
    def is_serialized(self) -> bool:
        return self._serialized

    @property
    def definition_type(self) -> str:
        return "serialized" if self._serialized else "file"

    def get_globals_path(self) -> Optional[str]:
        """Directory to put on sys.path in the container for file imports."""
        if self.file_path:
            if self.module_name and self.module_name not in (None, "__main__") and "." in self.module_name:
                # package module: path entries above the package root
                depth = self.module_name.count(".") + 1
                p = self.file_path
                for _ in range(depth):
                    p = os.path.dirname(p)
                return p
            return os.path.dirname(self.file_path)
        return None

    def get_schema(self) -> api_pb2.FunctionSchema:
        schema = api_pb2.FunctionSchema(defined=False)
        if self.raw_f is not None:
            try:
                sig = inspect.signature(self.raw_f)
                schema.defined = True
                for name, param in sig.parameters.items():
                    if name == "self":
                        continue
                    schema.params.append(
                        api_pb2.FunctionSchema.Param(
                            name=name, has_default=param.default is not inspect.Parameter.empty
                        )
                    )
            except (ValueError, TypeError):
                pass
        return schema


def is_async_fn(f: Callable) -> bool:
    return inspect.iscoroutinefunction(f) or inspect.isasyncgenfunction(f)


def is_generator_fn(f: Callable) -> bool:
    return inspect.isgeneratorfunction(f) or inspect.isasyncgenfunction(f)


def check_valid_function(f: Callable) -> None:
    if not callable(f):
        raise InvalidError(f"{f!r} is not callable")
    if isinstance(f, staticmethod) or isinstance(f, classmethod):
        raise InvalidError("static/class methods can't be used as remote functions directly")
