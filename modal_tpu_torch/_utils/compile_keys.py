"""Fleet compile-cache key scheme of the port (counterpart of
modal_tpu/_utils/compile_keys.py), shared by the store
(`server/compile_cache.py`), the client (`runtime/compile_client.py`) and
the kernel build (`ops/_build.py`), which must agree byte for byte on a
key's canonical form or lookups silently miss.

The port's compiled artefacts are the shared libraries `nvcc` builds from
`csrc/`. :func:`compile_cache_key` names one by a length-prefixed sha256
over everything that makes it reusable: the `.cu` source, the shared
headers (by file name, never by path), the flags, the toolchain's identity
and the target arch. The kernels' builder (`ops/_build.py`) names the
toolchain without asking a compiler, and keeps the `nvcc --version` of
each build beside its library as metadata (`META_SUFFIX`); the native
hasher names its `g++ --version`. Keys carry their own prefix, ``tc-``, so
they never collide with the JAX package's (``xc-`` or jax's own cache
names) in a store both packages share.
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
from typing import Iterable

# keys land on a shared filesystem: one flat namespace, no separators
_KEY_UNSAFE = re.compile(r"[^A-Za-z0-9._=-]")
_MAX_KEY_LEN = 240  # under common 255-byte filename limits with sidecar suffix

KEY_PREFIX = "tc-"
# a library's metadata: `<library>.nvcc` beside it, `<key>.nvcc` in the store
META_SUFFIX = ".nvcc"


def sanitize_key(key: str) -> str:
    """Filesystem/URL-safe canonical form of a cache key; '' for keys that
    sanitize to nothing (those can never round-trip → treated as misses)."""
    safe = _KEY_UNSAFE.sub("_", str(key))[:_MAX_KEY_LEN]
    return "" if safe.strip("._") == "" else safe


def compile_cache_key(
    source: bytes,
    headers: Iterable[tuple[str, bytes]],
    flags: Iterable[str],
    nvcc_version: str,
    arch: str,
) -> str:
    """Content digest of one kernel library's build inputs. `headers` are
    (file name, bytes) pairs; they are hashed in name order, and a name
    with a directory in it is refused, so no absolute path can enter a key
    and two checkouts at different paths agree."""
    parts: list = [source]
    for name, data in sorted(headers):
        if "/" in name or "\\" in name:
            raise ValueError(f"header {name!r}: give the file name, not a path")
        parts += [name, data]
    parts += [" ".join(flags), nvcc_version, arch]
    h = hashlib.sha256()
    for part in parts:
        data = part if isinstance(part, bytes) else str(part).encode()
        # length-prefix each field so ("ab","c") can't collide with ("a","bc")
        h.update(len(data).to_bytes(8, "big"))
        h.update(data)
    return f"{KEY_PREFIX}{h.hexdigest()}"


def entry_digest(data: bytes) -> str:
    """The integrity digest stored in the store's ``<key>.sha256`` sidecar
    and echoed on GETs as ``X-Content-SHA256``."""
    return hashlib.sha256(data).hexdigest()


def tmp_suffix() -> str:
    """A temporary file's suffix unique to this process AND thread: writers
    racing one key from threads of one process must not share a temporary
    (a per-process name let one thread's replace move another's file away,
    failing its put)."""
    return f".tmp.{os.getpid()}.{threading.get_ident()}"
