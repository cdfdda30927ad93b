"""Build the CUDA kernels in `modal_tpu_torch/csrc/` at first use.

Each `.cu` file is compiled by its own `nvcc` into a shared library with a
plain C interface (no PyTorch headers: seconds, not minutes), loaded with
`ctypes`. Libraries land in `modal_tpu_torch/_build/` under a name that
hashes the source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source never loads a stale build;
a finished build is moved into place atomically, so concurrent processes
can race on the same target safely. Nothing here falls back: no `nvcc`, a
failed compile or a failed load raises.

Every C entry point returns `cudaGetLastError()` after its launch; callers
raise on a non-zero code. `LAUNCHES` counts successful launches per kernel
(the only place they are counted), so a run can show which kernels its
main path went through. A launch made while a CUDA graph is being captured
runs nothing: `recording_launches()` collects it for the graph instead, and
`CountedGraph.replay` adds the graph's launches to `LAUNCHES` per replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Iterable, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = {
    "paged_decode": "paged_decode.cu",
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd_dq": "flash_bwd_dq.cu",
    "flash_bwd_dkv": "flash_bwd_dkv.cu",
}

LAUNCHES: dict[str, int] = {name: 0 for name in SOURCES}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_capture = threading.local()  # .launches: the dict a capture in this thread records into


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """One launch of `name`: into `LAUNCHES`, or, while this thread captures
    a graph, into the capture's record (a captured launch runs nothing)."""
    recording = getattr(_capture, "launches", None)
    if recording is not None:
        recording[name] = recording.get(name, 0) + 1
        return
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{name} launched into a CUDA graph outside recording_launches()")
    LAUNCHES[name] += 1


@contextlib.contextmanager
def recording_launches():
    """Collect this thread's launches into the yielded dict instead of
    `LAUNCHES`: wrap a CUDA graph's capture in it."""
    prev = getattr(_capture, "launches", None)
    record: dict[str, int] = {}
    _capture.launches = record
    try:
        yield record
    finally:
        _capture.launches = prev


class CountedGraph:
    """A captured CUDA graph and the kernel launches its capture recorded;
    each replay adds those to `LAUNCHES`, as the launches themselves would."""

    def __init__(self, graph, launches: dict[str, int]):
        self.graph = graph
        self.launches = dict(launches)

    def replay(self) -> None:
        self.graph.replay()
        for name, n in self.launches.items():
            LAUNCHES[name] += n


def nvcc_path() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")
    return path


def library_path(name: str) -> str:
    """The build's path, named by a hash of the source, the shared headers
    (`csrc/*.cuh`) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None, verbose: bool = False) -> dict[str, dict]:
    """Compile the named kernels (default: all), one `nvcc` per source, all
    started together. Returns {name: {"seconds", "cached", "log"}}; `log`
    holds ptxas' register/shared-memory report when `verbose`."""
    names = list(names or SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    report: dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            report[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        tmp = f"{target}.tmp{os.getpid()}"
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, target)
    failures = []
    for name, (proc, tmp, target) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failures.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        report[name] = {"seconds": time.perf_counter() - t0, "cached": False, "log": log}
    if failures:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(library_path(name))
        return lib


def entry(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point with its argument types set (every pointer and the
    stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise on a non-zero cudaError_t returned by a launch; count it otherwise."""
    if err != 0:
        describe = getattr(load(name), f"{name}_error_string")
        describe.restype = ctypes.c_char_p
        describe.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: {describe(err).decode()} (cudaError {err})")
    count_launch(name)
