"""The native (C++) block hasher, loaded with ctypes (port of
modal_tpu/_native/__init__.py).

Content addressing hashes every 8 MiB block of checkpoint and Volume
traffic. `hash_blocks` hashes all blocks of a buffer in one call, and
`hash_file_blocks` all blocks of a file, preading through private buffers,
both on a pool of C++ threads (one per core unless `n_threads` says
otherwise), so no block becomes Python bytes and the GIL is never held.

The source is the port's own copy, `modal_tpu_torch/csrc/blockhash.cpp`.
At first use `g++ -O3 -shared -fPIC -pthread` builds it into
`modal_tpu_torch/_build/blockhash-<key>.so`, the key a digest of the
source, the flags and `g++ --version` (as ops/_build.py keys the kernel
libraries), under a per-process and per-thread temporary name moved into
place atomically, so processes racing on a first use cannot clobber one
another. The JAX package's `modal_tpu/_native/_blockhash.so` is never
loaded.

Hashing goes native only when asked (`MODAL_TPU_NATIVE_HASH=1`,
_utils/hash_utils.py); hashlib (OpenSSL, SHA extensions) gives the same
digests on one core. Where the JAX package falls back to hashlib silently
when the build fails, the port raises: a user who set the knob gets the
native hasher or an error (ROADMAP Queue C 52).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

from .._utils.compile_keys import compile_cache_key, tmp_suffix

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "blockhash.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


class NativeHashError(RuntimeError):
    """The native hasher could not be built or loaded, or a file changed
    while it was hashed."""


def _compiler_version() -> str:
    try:
        out = subprocess.run([CXX, "--version"], capture_output=True, text=True, timeout=60)
    except OSError as exc:
        raise NativeHashError(f"{CXX} not found: cannot build the native block hasher ({exc})") from None
    if out.returncode != 0:
        raise NativeHashError(f"{CXX} --version failed (exit {out.returncode}): {out.stderr.strip()}")
    return out.stdout


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        source = f.read()
    key = compile_cache_key(source, [], CXX_FLAGS, _compiler_version(), "host")
    return os.path.join(BUILD_DIR, f"blockhash-{key}.so")


def _build(target: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = target + tmp_suffix()
    try:
        out = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise NativeHashError(f"building {SOURCE} failed (exit {out.returncode}):\n{out.stderr[-2000:]}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    """The hasher's library, built at first use; raises NativeHashError."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not os.path.exists(target):
            _build(target)
        try:
            lib = ctypes.CDLL(target)
        except OSError as exc:
            raise NativeHashError(f"loading {target} failed: {exc}") from None
        lib.mtpu_hash_blocks.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int]
        lib.mtpu_hash_blocks.restype = None
        lib.mtpu_hash_file_blocks.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_int,
        ]
        lib.mtpu_hash_file_blocks.restype = ctypes.c_int64
        _lib = lib
    return _lib


def native_available() -> bool:
    """True when the library builds and loads here (never raises)."""
    try:
        load()
    except NativeHashError:
        return False
    return True


def _n_blocks(size: int, block_size: int) -> int:
    return 1 if size == 0 else (size + block_size - 1) // block_size


def _address(data) -> tuple[int, int, object]:
    """(address, length, keep-alive) of a bytes-like object's contiguous
    bytes, read-only buffers included, without a copy."""
    import numpy as np

    arr = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    return arr.ctypes.data, arr.nbytes, arr


def hashlib_blocks(data, block_size: int) -> list[str]:
    """Per-block hashing with hashlib (the route when the knob is unset)."""
    view = memoryview(data).cast("B")
    return [
        hashlib.sha256(view[i * block_size : (i + 1) * block_size]).hexdigest()
        for i in range(_n_blocks(len(view), block_size))
    ]


def hash_blocks(data, block_size: int, n_threads: int = 0) -> list[str]:
    """SHA-256 hex digest of each `block_size` block of `data` (bytes,
    bytearray or memoryview; empty data is one empty block), hashed on
    `n_threads` threads (0: one per core)."""
    lib = load()
    addr, size, keep = _address(data)
    n_blocks = _n_blocks(size, block_size)
    out = ctypes.create_string_buffer(n_blocks * 32)
    lib.mtpu_hash_blocks(addr, size, block_size, out, n_threads)
    del keep
    raw = out.raw
    return [raw[i * 32 : (i + 1) * 32].hex() for i in range(n_blocks)]


def sha256_hex(data) -> str:
    """SHA-256 hex digest of `data` as one block, by the native library
    (the JAX package's falls back to hashlib where its library does not
    load; this one raises NativeHashError, as every native route here)."""
    return hash_blocks(data, max(1, memoryview(data).nbytes), n_threads=1)[0]


def hash_file_blocks(path: str, block_size: int, n_threads: int = 0) -> list[str]:
    """SHA-256 hex digest of each `block_size` block of a file, hashed by
    worker threads preading through private buffers: the file never
    becomes Python bytes. Raises OSError when the file cannot be read and
    NativeHashError when it changed size while it was hashed."""
    lib = load()
    size = os.stat(path).st_size
    n_blocks = _n_blocks(size, block_size)
    out = ctypes.create_string_buffer(n_blocks * 32)
    # the C side re-checks the block count against `n_blocks` and writes
    # nothing on a mismatch (the file grew or shrank between stat and hash)
    got = lib.mtpu_hash_file_blocks(os.fsencode(path), block_size, out, n_blocks, n_threads)
    if got == -1:
        raise OSError(f"native file hashing could not read {path!r}")
    if got != n_blocks:
        raise NativeHashError(f"{path!r} changed while it was hashed ({got} blocks, {n_blocks} expected)")
    raw = out.raw
    return [raw[i * 32 : (i + 1) * 32].hex() for i in range(n_blocks)]
