"""Reference-string import machinery: resolve "file.py::app.func" to runnable
objects (port of modal_tpu/cli/import_refs.py; reference:
py/modal/cli/import_refs.py:401 import_and_filter)."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import os
import sys
from typing import Any, Union

from ..app import _App, _LocalEntrypoint
from ..cls import _Cls
from ..exception import InvalidError
from ..functions import _Function


@dataclasses.dataclass
class ImportRef:
    file_or_module: str
    object_path: str  # e.g. "app.main" or "main" or ""


def parse_import_ref(ref: str) -> ImportRef:
    if "::" in ref:
        file_or_module, object_path = ref.split("::", 1)
    else:
        file_or_module, object_path = ref, ""
    return ImportRef(file_or_module, object_path)


def import_file_or_module(file_or_module: str) -> Any:
    if file_or_module.endswith(".py") or os.sep in file_or_module:
        path = os.path.abspath(file_or_module)
        if not os.path.exists(path):
            raise InvalidError(f"no such file: {file_or_module}")
        sys.path.insert(0, os.path.dirname(path))
        module_name = os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(module_name, path)
        assert spec is not None and spec.loader is not None
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module
        spec.loader.exec_module(module)
        return module
    return importlib.import_module(file_or_module)


def _walk_path(obj: Any, object_path: str) -> Any:
    for part in object_path.split("."):
        if isinstance(obj, _App) and part in obj.registered_functions:
            obj = obj.registered_functions[part]
        elif isinstance(obj, _App) and part in obj.registered_entrypoints:
            obj = obj.registered_entrypoints[part]
        elif isinstance(obj, _App) and part in obj.registered_classes:
            obj = obj.registered_classes[part]
        else:
            try:
                obj = getattr(obj, part)
            except AttributeError:
                candidates = []
                if isinstance(obj, _App):
                    candidates = sorted(obj.registered_entrypoints) + sorted(obj.registered_functions)
                elif hasattr(obj, "__name__"):
                    candidates = sorted(
                        k for k, v in vars(obj).items() if isinstance(v, (_App, _Function, _LocalEntrypoint))
                    )
                hint = f"; available: {', '.join(candidates)}" if candidates else ""
                raise InvalidError(f"no object {part!r} in {object_path!r}{hint}") from None
    return obj


def find_app(module: Any) -> _App:
    """Locate the App in a module: prefer a variable named `app`, else the
    single App instance."""
    app = getattr(module, "app", None)
    if isinstance(app, _App):
        return app
    apps = [v for v in vars(module).values() if isinstance(v, _App)]
    if len(apps) == 1:
        return apps[0]
    if not apps:
        raise InvalidError(f"module {module.__name__} has no modal_tpu_torch.App")
    raise InvalidError(
        f"module {module.__name__} has {len(apps)} Apps; name one `app` or use file.py::<appvar>"
    )


@dataclasses.dataclass
class Runnable:
    app: _App
    target: Union[_Function, _LocalEntrypoint, _Cls, None]  # None = whole app


def import_and_filter(ref: ImportRef) -> Runnable:
    """Resolve the import ref to (app, runnable target).

    With no object path: whole app (for deploy/serve) or, for `run`, the sole
    local entrypoint / function if unambiguous.
    """
    module = import_file_or_module(ref.file_or_module)
    if ref.object_path:
        obj = _walk_path(module, ref.object_path)
        if isinstance(obj, _App):
            return Runnable(obj, None)
        if isinstance(obj, _Function):
            return Runnable(obj.app, obj)
        if isinstance(obj, _LocalEntrypoint):
            return Runnable(obj.app, obj)
        if isinstance(obj, _Cls):
            return Runnable(obj._app, obj)
        raise InvalidError(f"{ref.object_path} is not a function, entrypoint, class, or app")
    app = find_app(module)
    return Runnable(app, None)


def pick_runnable_for_run(runnable: Runnable) -> Union[_Function, _LocalEntrypoint]:
    if runnable.target is not None:
        if isinstance(runnable.target, _Cls):
            raise InvalidError("can't `run` a class; use file.py::Cls.method")
        return runnable.target
    app = runnable.app
    entrypoints = app.registered_entrypoints
    if len(entrypoints) == 1:
        return next(iter(entrypoints.values()))
    functions = app.registered_functions
    if len(entrypoints) == 0 and len(functions) == 1:
        return next(iter(functions.values()))
    names = sorted(entrypoints) + sorted(functions)
    raise InvalidError(
        f"multiple runnable targets; pick one with ::name — candidates: {', '.join(names)}"
    )
