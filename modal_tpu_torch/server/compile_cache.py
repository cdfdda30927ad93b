"""Content-addressed fleet compile-cache store (port of
modal_tpu/server/compile_cache.py, on the same on-disk layout).

One flat directory of compiled artefacts keyed by digest: the port's
``tc-<sha256>`` kernel libraries (`_utils/compile_keys.py`) and, in a store
the JAX package shares, its own keys beside them. Either package's store
reads a directory the other wrote. It is reached three ways:

- the JAX package's blob server routes ``GET/PUT/DELETE /compile/<key>``;
- the co-located local-dir fast path: containers on this host get the
  store dir via ``MODAL_TPU_COMPILE_CACHE_DIR`` and read entries in place;
- :meth:`publish_dir`: a whole build directory pushed in at image-build
  time (key = file name).

Integrity: every entry carries a ``<key>.sha256`` sidecar written AFTER
the body lands (tmp + os.replace both). Readers verify body-vs-sidecar and
treat a mismatch as corrupt → evict + miss, so a torn write degrades to
one rebuild instead of a poisoned fleet. Concurrent PUTs of one key are
idempotent: both writers replace the final path with identical content.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

from .._utils.compile_keys import sanitize_key, tmp_suffix


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class CompileCacheStore:
    def __init__(self, root_dir: str):
        self.root_dir = root_dir
        os.makedirs(root_dir, exist_ok=True)

    def path(self, key: str) -> Optional[str]:
        """On-disk path for a key; None for keys that don't sanitize (those
        can never have been stored, so routes answer 404/400)."""
        safe = sanitize_key(key)
        if not safe or safe != key:
            # only serve keys in canonical form: a traversal-y or truncated
            # key must not alias a different entry
            return None
        return os.path.join(self.root_dir, safe)

    def has(self, key: str) -> bool:
        p = self.path(key)
        return bool(p) and os.path.exists(p)

    def digest(self, key: str) -> str:
        """The stored sidecar digest ('' when absent — pre-sidecar entries
        still serve, clients just skip verification)."""
        p = self.path(key)
        if not p:
            return ""
        try:
            with open(p + ".sha256") as f:
                return f.read().strip()
        except OSError:
            return ""

    def finalize_put(self, key: str, tmp_path: str, sha256_hex: str) -> bool:
        """Move a fully-drained upload into place: body first, sidecar
        second (a crash between the two leaves a verifiable-by-recompute
        entry, never a sidecar pointing at missing bytes)."""
        p = self.path(key)
        if not p:
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
            return False
        os.replace(tmp_path, p)
        side_tmp = f"{p}.sha256{tmp_suffix()}"
        with open(side_tmp, "w") as f:
            f.write(sha256_hex)
        os.replace(side_tmp, p + ".sha256")
        return True

    def put_bytes(self, key: str, data: bytes) -> bool:
        """In-process put (prewarm publisher, tests) — same atomic layout as
        the HTTP route."""
        p = self.path(key)
        if not p:
            return False
        tmp = f"{p}{tmp_suffix()}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            return self.finalize_put(key, tmp, _digest(data))
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False

    def get_bytes(self, key: str) -> Optional[bytes]:
        """Verified read: corrupt entries are evicted and read as a miss."""
        p = self.path(key)
        if not p:
            return None
        try:
            with open(p, "rb") as f:
                data = f.read()
        except OSError:
            return None
        expect = self.digest(key)
        if expect and _digest(data) != expect:
            self.delete(key)
            return None
        return data

    def delete(self, key: str) -> bool:
        p = self.path(key)
        if not p:
            return False
        existed = False
        for suffix in ("", ".sha256"):
            try:
                os.unlink(p + suffix)
                existed = True
            except OSError:
                pass
        return existed

    def keys(self) -> list[str]:
        try:
            names = os.listdir(self.root_dir)
        except OSError:
            return []
        return sorted(
            n for n in names if not n.endswith(".sha256") and ".tmp." not in n
        )

    def publish_dir(self, src_dir: str) -> int:
        """Publish every cache entry file under ``src_dir`` (a baked build
        or compilation-cache directory) into the store, key = filename.
        Existing identical keys are skipped; returns entries published."""
        published = 0
        try:
            names = os.listdir(src_dir)
        except OSError:
            return 0
        for name in sorted(names):
            if name.endswith((".sha256", "-atime")) or ".tmp." in name:
                # sidecars, in-flight temporaries and jax's LRU stamps
                # (-atime) are per-filesystem state, not shareable content
                continue
            src = os.path.join(src_dir, name)
            if not os.path.isfile(src):
                continue
            key = sanitize_key(name)
            if not key:
                continue
            try:
                with open(src, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            if self.has(key) and self.digest(key) == _digest(data):
                continue
            if self.put_bytes(key, data):
                published += 1
        return published
