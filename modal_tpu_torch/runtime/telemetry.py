"""Import telemetry: per-module load tracing for cold-start attribution
(the port's own copy of modal_tpu/runtime/telemetry.py; standard library
only, so a boot can install it before `import torch`).

`ImportInterceptor` sits first on `sys.meta_path`, delegates to the real
finders and times each module's exec. Events land in a JSONL file
(`MODAL_TPU_TELEMETRY_PATH`, set by the worker when import tracing is on),
so slow imports, the other half of cold start besides kernel builds, are
attributable per container.

Event shape per line (the JAX package's): {"event": "module_load_end",
"module": str, "duration_s": float, "depth": int, "t": float}. Durations
are cumulative (include child imports); depth lets a viewer compute
self-time. `summarize` lists the slowest top-level imports.
"""

from __future__ import annotations

import atexit
import importlib.abc
import importlib.machinery
import json
import sys
import threading
import time
from typing import Optional


class ImportInterceptor(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """meta_path[0] finder that delegates to the real finders and times each
    module's exec."""

    def __init__(self, emit):
        self._emit = emit
        self._local = threading.local()
        self._lock = threading.Lock()

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    def find_spec(self, fullname, path=None, target=None):
        # delegate to every finder after us; wrap the winning loader
        for finder in sys.meta_path:
            if finder is self:
                continue
            try:
                spec = finder.find_spec(fullname, path, target)
            except (ImportError, AttributeError):
                continue
            if spec is None or spec.loader is None or isinstance(spec.loader, _TimedLoader):
                if spec is not None:
                    return spec
                continue
            spec.loader = _TimedLoader(spec.loader, self, fullname)
            return spec
        return None

    def _record(self, module: str, duration_s: float) -> None:
        event = {
            "event": "module_load_end",
            "module": module,
            "duration_s": round(duration_s, 6),
            "depth": self._depth(),
            "t": time.time(),
        }
        with self._lock:
            self._emit(event)


class _TimedLoader(importlib.abc.Loader):
    def __init__(self, inner, interceptor: ImportInterceptor, fullname: str):
        self._inner = inner
        self._interceptor = interceptor
        self._fullname = fullname

    def create_module(self, spec):
        return self._inner.create_module(spec)

    def exec_module(self, module):
        local = self._interceptor._local
        local.depth = getattr(local, "depth", 0) + 1
        t0 = time.perf_counter()
        try:
            self._inner.exec_module(module)
        finally:
            duration = time.perf_counter() - t0
            # record at the module's own depth (top-level imports = 1),
            # THEN pop the frame
            self._interceptor._record(self._fullname, duration)
            local.depth -= 1

    def __getattr__(self, name):  # is_package, get_code, resource APIs...
        return getattr(self._inner, name)


_installed: Optional[ImportInterceptor] = None
_telemetry_file = None


def _close_telemetry_file() -> None:
    """Flush and close the JSONL sink (registered atexit, so events buffered
    at interpreter teardown are not lost)."""
    global _telemetry_file
    if _telemetry_file is not None:
        try:
            _telemetry_file.flush()
            _telemetry_file.close()
        except (OSError, ValueError):
            pass
        _telemetry_file = None


def instrument_imports(output_path: str) -> None:
    """Install the interceptor writing JSONL events to `output_path`."""
    global _installed, _telemetry_file
    if _installed is not None:
        return
    _telemetry_file = open(output_path, "a", buffering=1)
    atexit.register(_close_telemetry_file)

    def emit(event: dict) -> None:
        f = _telemetry_file
        if f is None:
            return  # sink already closed at exit; drop late events
        try:
            f.write(json.dumps(event) + "\n")
        except (OSError, ValueError):
            pass

    _installed = ImportInterceptor(emit)
    sys.meta_path.insert(0, _installed)


def retarget_imports(output_path: str) -> None:
    """Send the import trace to `output_path` from now on (a warm-pool
    interpreter's placement writes into its own task's file), installing
    the interceptor on first use."""
    global _telemetry_file
    if _installed is None:
        instrument_imports(output_path)
        return
    _close_telemetry_file()
    _telemetry_file = open(output_path, "a", buffering=1)


def maybe_instrument_from_env() -> None:
    """Hook point for a container entrypoint's first lines: trace imports
    into `MODAL_TPU_TELEMETRY_PATH` when it is set."""
    import os

    path = os.environ.get("MODAL_TPU_TELEMETRY_PATH")
    if path:
        try:
            instrument_imports(path)
        except OSError:
            pass


def summarize(path: str, top: int = 15) -> list[dict]:
    """Slowest top-level imports from a telemetry file (depth==1 events are
    roots: their durations include children)."""
    events = []
    with open(path) as f:
        for line in f:
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    # malformed events (torn writes at kill, foreign lines) must not raise:
    # a viewer skips them instead of dying on a KeyError
    roots = [
        e
        for e in events
        if isinstance(e, dict)
        and e.get("depth") == 1
        and isinstance(e.get("duration_s"), (int, float))
    ]
    roots.sort(key=lambda e: -e["duration_s"])
    return roots[:top]
