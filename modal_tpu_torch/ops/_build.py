"""Build the CUDA kernels in `modal_tpu_torch/csrc/` at first use.

Each `.cu` file is compiled by its own `nvcc` into a shared library with a
plain C interface (no PyTorch headers: seconds, not minutes), loaded with
`ctypes`. Libraries land in the build directory, `$TORCH_EXTENSIONS_DIR`
when it is set (as the JAX package honours `JAX_COMPILATION_CACHE_DIR`),
else `modal_tpu_torch/_build/`, under a name that carries the library's
key (`_utils/compile_keys.compile_cache_key`: the source, the shared
headers `csrc/*.cuh`, the flags, the arch, the CUDA version torch was
built for and the image builder's epoch), so an edited source never loads
a stale build. The key asks no compiler, as the JAX package's keys ask
none: a container without the CUDA toolkit finds a library it can load.
Beside each library nvcc builds lies its metadata, the full `nvcc
--version` output (`<library>.nvcc`, and `<key>.nvcc` in the fleet store).
A machine whose nvcc disagrees with a library's metadata does not load
it: it builds under a key that also names its own nvcc (`library_key`).
A finished build is moved into place atomically, so concurrent processes
can race on the same target safely.

The fleet tier (`runtime/compile_client.install_fleet_cache`) sits under
the build as the JAX package's `TieredJaxCache` sits under jax's cache: a
library missing from the build directory is first asked of the fleet store
by its key, and a library `nvcc` had to build is published to it. The tier
only changes where a library comes from. Nothing here falls back: a
library that is nowhere with no `nvcc` to build it raises and names its
key, a failed compile or a failed load raises, and a fleet failure means a
local build.

`report_compile` feeds the compile telemetry (`nvcc`, `local` and `fleet`
per library, `cache_miss` per build-directory miss, `graph_capture` from
`models/paged_kv.DecodeGraph`) to the listeners that
`observability.device_telemetry.install_compile_hooks` registers.

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
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Iterable, Optional

import torch

from .._utils.compile_keys import META_SUFFIX, compile_cache_key, tmp_suffix

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
DEFAULT_BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = "sm_90a"
NVCC_FLAGS = (
    "-gencode", f"arch=compute_90a,code={ARCH}",
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
_nvcc_versions: dict[str, str] = {}  # nvcc path -> its `--version` output
# the fleet tier (runtime/compile_client.install_fleet_cache) and the compile
# listeners (observability/device_telemetry.install_compile_hooks): process
# wide, as jax's cache object and jax.monitoring's listeners are
_fleet = None
_compile_listeners: list[Callable[[str, float], None]] = []


def set_fleet_tier(fleet) -> None:
    """Put a `FleetCompileCache` (or None) under the build."""
    global _fleet
    _fleet = fleet


def fleet_tier():
    return _fleet


def add_compile_listener(fn: Callable[[str, float], None]) -> None:
    _compile_listeners.append(fn)


def report_compile(event: str, seconds: float = 0.0) -> None:
    """Tell the compile listeners; a listener that raises is ignored (the
    build never fails for telemetry)."""
    for fn in list(_compile_listeners):
        try:
            fn(event, seconds)
        except Exception:  # noqa: BLE001 — telemetry must never break a build
            pass


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


def find_nvcc() -> Optional[str]:
    """nvcc on PATH, else under `$CUDA_HOME/bin`; None when neither has it."""
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    return path if os.path.isfile(path) else None


def nvcc_version(nvcc: str) -> str:
    """The full `nvcc --version` output (the metadata beside each library it
    builds), asked once per process and nvcc; this compiles nothing."""
    if nvcc not in _nvcc_versions:
        out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
        if out.returncode != 0:
            raise RuntimeError(f"{nvcc} --version failed (exit {out.returncode}): {out.stderr.strip()}")
        _nvcc_versions[nvcc] = out.stdout
    return _nvcc_versions[nvcc]


def build_dir() -> str:
    return os.environ.get("TORCH_EXTENSIONS_DIR") or DEFAULT_BUILD_DIR


def toolchain() -> str:
    """What a library's key names besides its sources, flags and arch: the
    CUDA version torch was built for and the image builder's epoch, which
    pins the torch stack. It asks no compiler."""
    from ..config import config

    return f"torch.version.cuda={torch.version.cuda} builder={config['image_builder_version']}"


def cache_key(name: str, compiler: str = "") -> str:
    """The library's key, in the fleet store and in its file name. With
    `compiler` (an `nvcc --version` output), the key of that nvcc's build
    where the library under the plain key came from another nvcc."""
    headers = []
    for fname in sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")):
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            headers.append((fname, f.read()))
    with open(os.path.join(CSRC_DIR, SOURCES[name]), "rb") as f:
        source = f.read()
    ident = toolchain() + (f"\n{compiler}" if compiler else "")
    return compile_cache_key(source, headers, NVCC_FLAGS, ident, ARCH)


def _built_by(name: str, key: str) -> Optional[str]:
    """The metadata of the library under `key`: the build directory's copy,
    else the fleet's; None when neither holds the library ("" for a local
    library without metadata, which no nvcc then claims)."""
    local = os.path.join(build_dir(), f"{name}-{key}.so")
    if os.path.exists(local):
        try:
            with open(local + META_SUFFIX) as f:
                return f.read()
        except OSError:
            return ""
    return _fleet.get_meta(key) if _fleet is not None else None


def library_key(name: str) -> str:
    """The key this process finds `name` under: `cache_key(name)`, unless
    this machine has nvcc and the library under that key was built by
    another nvcc; then the key that also names this nvcc, so the other
    build is never loaded here."""
    key = cache_key(name)
    nvcc = find_nvcc()
    if nvcc is None:
        return key
    built_by = _built_by(name, key)
    if built_by is None or built_by == nvcc_version(nvcc):
        return key
    return cache_key(name, nvcc_version(nvcc))


def library_path(name: str, key: Optional[str] = None) -> str:
    return os.path.join(build_dir(), f"{name}-{key or library_key(name)}.so")


def _write(path: str, data: bytes) -> None:
    tmp = path + tmp_suffix()
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except OSError:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _fetch(key: str, target: str) -> bool:
    """Place the fleet's copy of `key` and its metadata at `target`; False
    when there is no tier, no entry, the copy cannot be written, or this
    machine has nvcc and the entry's metadata does not name it (an entry
    without metadata included: this machine builds and publishes a pair)."""
    if _fleet is None:
        return False
    meta = _fleet.get_meta(key)
    nvcc = find_nvcc()
    if nvcc is not None and meta != nvcc_version(nvcc):
        return False
    data = _fleet.get(key)
    if data is None:
        return False
    try:
        _write(target + META_SUFFIX, (meta or "").encode())
        _write(target, data)
    except OSError:
        return False
    return True


def _publish(key: str, target: str) -> None:
    """Offer a library nvcc just built, its metadata first, to the fleet; a
    failed put only means the next container builds it too."""
    if _fleet is None:
        return
    try:
        with open(target + META_SUFFIX) as f:
            meta = f.read()
        with open(target, "rb") as f:
            data = f.read()
    except OSError:
        return
    if _fleet.put_meta(key, meta):
        _fleet.put(key, data)


def build(names: Optional[Iterable[str]] = None, verbose: bool = False) -> dict[str, dict]:
    """Compile the named kernels (default: all), one `nvcc` per source, all
    started together; a library already in the build directory is kept, and
    one the fleet tier holds is fetched instead of built. Returns {name:
    {"seconds", "source", "log"}}: `source` is "local", "fleet" or "nvcc";
    `log` holds ptxas' register/shared-memory report when nvcc ran
    `verbose`."""
    names = list(names or SOURCES)
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    report: dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        t_name = time.perf_counter()
        key = library_key(name)
        target = library_path(name, key)
        if os.path.exists(target):
            source = "local"
        else:
            report_compile("cache_miss")
            source = "fleet" if _fetch(key, target) else "nvcc"
        if source != "nvcc":
            seconds = time.perf_counter() - t_name
            report[name] = {"seconds": seconds, "source": source, "log": ""}
            report_compile(source, seconds)
            continue
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(f"{name}: no library under key {key} in {build_dir()} or the fleet store, and "
                               "no nvcc (PATH, $CUDA_HOME/bin) to build it")
        _write(target + META_SUFFIX, nvcc_version(nvcc).encode())
        tmp = target + tmp_suffix()
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, target, key)
    failures = []
    for name, (proc, tmp, target, key) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failures.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        seconds = time.perf_counter() - t0
        report[name] = {"seconds": seconds, "source": "nvcc", "log": log}
        report_compile("nvcc", seconds)
        _publish(key, target)
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
