"""Fleet compile-cache client (port of modal_tpu/runtime/compile_client.py:
65-424): a tier under the kernel build (`ops/_build.py`) that makes
"build once anywhere, load everywhere" true for the whole fleet.

The build directory is per filesystem: a container whose directory
lacks a kernel library pays the `nvcc` build alone, and its successor on
another host pays it again. This module puts a second tier under the
build, backed by the content-addressed compile store
(`server/compile_cache.py`, the same layout as the JAX package's), reached
two ways:

- **local-dir fast path** (``MODAL_TPU_COMPILE_CACHE_DIR``): co-located
  containers read the store's files in place;
- **HTTP** (``MODAL_TPU_COMPILE_CACHE_URL``): ``GET/PUT/DELETE
  /compile/<key>`` on the blob plane (the JAX package's blob server), for
  containers on other hosts.

The JAX package wraps jax's persistent-cache object (`TieredJaxCache`); the
port's counterpart is `ops/_build`'s fleet tier: asked before `nvcc` runs,
given every library `nvcc` built. Keys are `_utils/compile_keys`'s
``tc-<sha256>`` over the build's inputs, which hold no absolute path (the
counterpart of `normalize_cache_keys`), so two checkouts at different paths
share entries.

Degradation: every failure is silent and counted, never raised. Knob off,
no coordinates, an unreachable service or a corrupt entry all leave the
local build alone. A corrupt entry (integrity sidecar mismatch) is evicted
(DELETE / unlink) so one torn write cannot poison the fleet. After
``_MAX_CONSECUTIVE_ERRORS`` transport failures the HTTP tier stops trying
for ``_ERROR_COOLDOWN_S``, so a dead service costs one timeout, not one per
build.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from .._utils.compile_keys import compile_cache_key, entry_digest, sanitize_key, tmp_suffix

__all__ = [
    "ENV_DIR",
    "ENV_GATE",
    "ENV_URL",
    "FleetCompileCache",
    "compile_cache_key",
    "entry_digest",
    "fleet_cache_enabled",
    "install_fleet_cache",
    "sanitize_key",
    "uninstall_fleet_cache",
]

ENV_GATE = "MODAL_TPU_COMPILE_CACHE"  # 0 → local-only builds (feature gate)
ENV_URL = "MODAL_TPU_COMPILE_CACHE_URL"  # blob-plane base url (http://host:port)
ENV_DIR = "MODAL_TPU_COMPILE_CACHE_DIR"  # co-located store dir (fast path)

_MAX_CONSECUTIVE_ERRORS = 3
_ERROR_COOLDOWN_S = 30.0
_HTTP_TIMEOUT_S = 5.0

_install_lock = threading.Lock()


def fleet_cache_enabled() -> bool:
    """The feature gate: ``MODAL_TPU_COMPILE_CACHE=0`` disables the fleet
    tier entirely (the build directory only)."""
    return os.environ.get(ENV_GATE, "1").strip().lower() not in ("0", "false", "no", "off")


def _count(event: str, source: str) -> None:
    """Feed both counter planes: the compile-events family (source=fleet
    hits and misses) and the compile-cache families by transport."""
    try:
        from ..observability.catalog import (
            COMPILE_CACHE_HITS,
            COMPILE_CACHE_MISSES,
            COMPILE_CACHE_PUTS,
            COMPILE_EVENTS,
        )

        if event == "hit":
            COMPILE_CACHE_HITS.inc(source=source)
            COMPILE_EVENTS.inc(event="cache_hit", source="fleet")
        elif event == "miss":
            COMPILE_CACHE_MISSES.inc(source=source)
            COMPILE_EVENTS.inc(event="cache_miss", source="fleet")
        elif event == "put":
            COMPILE_CACHE_PUTS.inc(source=source)
    except Exception:  # noqa: BLE001 — metrics must never break the build
        pass


def _count_error(kind: str) -> None:
    try:
        from ..observability.catalog import COMPILE_CACHE_ERRORS

        COMPILE_CACHE_ERRORS.inc(kind=kind)
    except Exception:  # noqa: BLE001
        pass


class FleetCompileCache:
    """The fleet tier: get/put bytes by key against the shared store, local
    dir first, HTTP second, silence on every failure. Pure stdlib."""

    def __init__(self, url: str = "", local_dir: str = "", timeout_s: float = _HTTP_TIMEOUT_S):
        self.url = url.rstrip("/")
        self.local_dir = local_dir
        self.timeout_s = timeout_s
        self._consecutive_errors = 0
        self._cooldown_until = 0.0
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls) -> Optional["FleetCompileCache"]:
        """None when the gate is off or no coordinates are configured: the
        kernel build then works from its build directory alone."""
        if not fleet_cache_enabled():
            return None
        url = os.environ.get(ENV_URL, "").strip()
        local_dir = os.environ.get(ENV_DIR, "").strip()
        if local_dir and not os.path.isdir(local_dir):
            # stat-verify like the blob fast path: a stale env var from a
            # dead supervisor must not break every lookup
            local_dir = ""
        if not url and not local_dir:
            return None
        return cls(url=url, local_dir=local_dir)

    # -- transport error budget ------------------------------------------

    def _http_usable(self) -> bool:
        return bool(self.url) and time.monotonic() >= self._cooldown_until

    def _note_http_error(self) -> None:
        with self._lock:
            self._consecutive_errors += 1
            if self._consecutive_errors >= _MAX_CONSECUTIVE_ERRORS:
                self._cooldown_until = time.monotonic() + _ERROR_COOLDOWN_S
                self._consecutive_errors = 0
        _count_error("unreachable")

    def _note_http_ok(self) -> None:
        with self._lock:
            self._consecutive_errors = 0

    # -- local-dir fast path ---------------------------------------------

    def _local_get(self, key: str) -> Optional[bytes]:
        path = os.path.join(self.local_dir, key)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        expect = self._local_sidecar(key)
        if expect and entry_digest(data) != expect:
            # torn/corrupt entry: evict so the fleet heals instead of
            # serving the same bad bytes forever
            self._local_evict(key)
            _count_error("corrupt")
            return None
        return data

    def _local_sidecar(self, key: str) -> str:
        try:
            with open(os.path.join(self.local_dir, key + ".sha256")) as f:
                return f.read().strip()
        except OSError:
            return ""

    def _local_evict(self, key: str) -> None:
        for suffix in ("", ".sha256"):
            try:
                os.unlink(os.path.join(self.local_dir, key + suffix))
            except OSError:
                pass

    def _local_put(self, key: str, data: bytes) -> bool:
        # same atomic tmp+replace discipline as the server store: concurrent
        # identical PUTs race to an identical final state (idempotent)
        path = os.path.join(self.local_dir, key)
        tmp = path + tmp_suffix()
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
            with open(path + ".sha256" + tmp_suffix(), "w") as f:
                f.write(entry_digest(data))
            os.replace(path + ".sha256" + tmp_suffix(), path + ".sha256")
            return True
        except OSError:
            return False

    # -- HTTP path --------------------------------------------------------

    def _http_get(self, key: str) -> Optional[bytes]:
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(
                f"{self.url}/compile/{key}", timeout=self.timeout_s
            ) as resp:
                data = resp.read()
                expect = resp.headers.get("X-Content-SHA256", "")
        except urllib.error.HTTPError as exc:
            exc.close()
            self._note_http_ok()  # the service answered; 404 is a clean miss
            return None
        except Exception:  # noqa: BLE001 — conn refused/timeout/reset
            self._note_http_error()
            return None
        self._note_http_ok()
        if expect and entry_digest(data) != expect:
            self._http_evict(key)
            _count_error("corrupt")
            return None
        return data

    def _http_evict(self, key: str) -> None:
        import urllib.request

        try:
            req = urllib.request.Request(f"{self.url}/compile/{key}", method="DELETE")
            urllib.request.urlopen(req, timeout=self.timeout_s).close()
        except Exception:  # noqa: BLE001 — eviction is best-effort
            pass

    def _http_put(self, key: str, data: bytes) -> bool:
        import urllib.request

        try:
            req = urllib.request.Request(
                f"{self.url}/compile/{key}",
                data=data,
                method="PUT",
                headers={"X-Content-SHA256": entry_digest(data)},
            )
            urllib.request.urlopen(req, timeout=self.timeout_s).close()
        except Exception:  # noqa: BLE001
            self._note_http_error()
            return False
        self._note_http_ok()
        return True

    # -- public api --------------------------------------------------------

    def get(self, key: str) -> Optional[bytes]:
        key = sanitize_key(key)
        if not key:
            return None
        if self.local_dir:
            data = self._local_get(key)
            if data is not None:
                _count("hit", "local_dir")
                return data
        if self._http_usable():
            data = self._http_get(key)
            if data is not None:
                _count("hit", "http")
                if self.local_dir:
                    self._local_put(key, data)  # warm the co-located store
                return data
        _count("miss", "local_dir" if self.local_dir else "http")
        return None

    def put(self, key: str, data: bytes) -> bool:
        key = sanitize_key(key)
        if not key or not isinstance(data, (bytes, bytearray, memoryview)):
            return False
        data = bytes(data)
        ok = False
        if self.local_dir and self._local_put(key, data):
            _count("put", "local_dir")
            ok = True
        # the local dir IS the supervisor's store (worker exports the state
        # sibling): when it took the write, skip the redundant HTTP round trip
        if not ok and self._http_usable() and self._http_put(key, data):
            _count("put", "http")
            ok = True
        return ok


def install_fleet_cache() -> bool:
    """Put the fleet tier under `ops/_build` (idempotent). A no-op (False)
    when the gate is off, no fleet coordinates are set, or torch has not
    been imported yet: this must never be the call that pays the torch
    import bill (a no-op container's heartbeat calls it). Called from the
    container's boot (`device_telemetry.maybe_install_fleet_cache`), the
    heartbeat report and the AOT warm-up (`runtime/aot.py`)."""
    from ..config import torch_imported

    fleet = FleetCompileCache.from_env()
    if fleet is None or not torch_imported():
        return False
    from ..ops import _build

    with _install_lock:
        if not isinstance(_build.fleet_tier(), FleetCompileCache):
            _build.set_fleet_tier(fleet)
    return True


def uninstall_fleet_cache() -> None:
    """Take the fleet tier out from under the kernel build (tests)."""
    from ..ops import _build

    with _install_lock:
        _build.set_fleet_tier(None)
