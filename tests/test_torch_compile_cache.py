"""The port's fleet compile cache, mirroring tests/test_compile_cache.py:
the key scheme (`_utils/compile_keys.py`), the store
(`server/compile_cache.py`, on the JAX package's layout: each package's
store reads a directory the other wrote), the client
(`runtime/compile_client.py`: local-dir fast path, HTTP tier against the
JAX package's blob server, silent degradation and its counters), and the
tier under the kernel builds (`ops/_build.py`).

No `nvcc` exists on the CPU: a stub `nvcc` on PATH logs every call,
answers `--version` and writes its `-o` target. With it, a second, empty
build directory over a filled store builds with zero compiles (the cold
fleet rollout), a new toolkit version mints new keys, and a failed build
or load still raises."""

import hashlib
import os
import stat
import threading
import urllib.error
import urllib.request

import pytest

from modal_tpu.server.compile_cache import CompileCacheStore as JaxStore
from modal_tpu_torch._utils.compile_keys import compile_cache_key, entry_digest, sanitize_key
from modal_tpu_torch.observability import catalog
from modal_tpu_torch.ops import _build
from modal_tpu_torch.runtime import aot, compile_client
from modal_tpu_torch.runtime.compile_client import FleetCompileCache
from modal_tpu_torch.server.compile_cache import CompileCacheStore

# -- key scheme ----------------------------------------------------------------


def test_sanitize_key_blocks_traversal_and_preserves_names():
    name = "paged_decode-tc-" + "a" * 64
    assert sanitize_key(name) == name
    assert "/" not in sanitize_key("../../etc/passwd")
    assert sanitize_key("..") == ""
    assert sanitize_key("") == ""
    assert len(sanitize_key("x" * 1000)) <= 240


KEY_BASE = dict(
    source=b"__global__ void k() {}",
    headers=[("hopper.cuh", b"#pragma once"), ("common.cuh", b"// common")],
    flags=("-O3", "-gencode", "arch=compute_90a,code=sm_90a"),
    nvcc_version="Cuda compilation tools, release 12.8, V12.8.93",
    arch="sm_90a",
)


@pytest.mark.parametrize("field, other", [
    ("source", b"__global__ void k2() {}"),
    ("headers", [("hopper.cuh", b"#pragma once // edited"), ("common.cuh", b"// common")]),
    ("headers", [("hopper.cuh", b"#pragma once")]),
    ("flags", ("-O2", "-gencode", "arch=compute_90a,code=sm_90a")),
    ("nvcc_version", "Cuda compilation tools, release 12.9, V12.9.41"),
    ("arch", "sm_100a"),
])
def test_compile_cache_key_is_scoped_by_every_build_input(field, other):
    """A toolkit upgrade, an edited source or header, other flags or another
    arch MUST mint a new key: serving another build's library is the one
    unrecoverable failure of a shared cache. Keys carry their own prefix, so
    they never collide with the JAX package's (``xc-`` or jax's names)."""
    k0 = compile_cache_key(**KEY_BASE)
    assert k0.startswith("tc-") and k0 == compile_cache_key(**KEY_BASE)
    assert sanitize_key(k0) == k0
    assert compile_cache_key(**{**KEY_BASE, field: other}) != k0


def test_compile_cache_key_takes_header_names_never_paths():
    """No absolute path enters a key (the counterpart of JAX's
    normalize_cache_keys): header order does not matter, a path is refused."""
    flipped = {**KEY_BASE, "headers": list(reversed(KEY_BASE["headers"]))}
    assert compile_cache_key(**flipped) == compile_cache_key(**KEY_BASE)
    with pytest.raises(ValueError, match="file name"):
        compile_cache_key(**{**KEY_BASE, "headers": [("/abs/csrc/hopper.cuh", b"")]})


def test_stale_version_never_served(tmp_path):
    store = CompileCacheStore(str(tmp_path))
    old = compile_cache_key(**{**KEY_BASE, "nvcc_version": "release 12.4"})
    new = compile_cache_key(**{**KEY_BASE, "nvcc_version": "release 12.8"})
    assert store.put_bytes(old, b"old-library")
    assert store.get_bytes(new) is None
    assert store.get_bytes(old) == b"old-library"


# -- the store -----------------------------------------------------------------


def test_store_roundtrip_sidecar_and_keys(tmp_path):
    store = CompileCacheStore(str(tmp_path))
    assert store.put_bytes("k1", b"payload")
    assert store.get_bytes("k1") == b"payload"
    assert store.digest("k1") == entry_digest(b"payload")
    assert store.keys() == ["k1"]
    assert store.put_bytes("../evil", b"x") is False
    assert store.get_bytes("missing") is None


def test_store_corrupt_entry_evicted_on_read(tmp_path):
    store = CompileCacheStore(str(tmp_path))
    store.put_bytes("k", b"good-bytes")
    (tmp_path / "k").write_bytes(b"torn!")
    assert store.get_bytes("k") is None
    assert not (tmp_path / "k").exists() and not (tmp_path / "k.sha256").exists()
    assert store.put_bytes("k", b"fresh") and store.get_bytes("k") == b"fresh"


@pytest.mark.parametrize("writer", ["store", "fleet"])
def test_store_concurrent_puts_idempotent(tmp_path, writer):
    """Writers racing one key on threads of one process (the store's put and
    the client's local-dir put): every put succeeds and the survivor
    verifies. Each thread writes its own temporary; with one per process,
    a thread's replace moved another's file away and failed its put."""
    if writer == "store":
        puts = [CompileCacheStore(str(tmp_path)).put_bytes for _ in range(8)]
    else:
        puts = [FleetCompileCache(local_dir=str(tmp_path)).put for _ in range(8)]
    results = []
    threads = [threading.Thread(target=lambda put=put: results.append(put("k", b"same-library" * 1000)))
               for put in puts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert results == [True] * 8
    store = CompileCacheStore(str(tmp_path))
    assert store.get_bytes("k") == b"same-library" * 1000
    assert store.digest("k") == entry_digest(b"same-library" * 1000)
    assert store.keys() == ["k"]


def test_store_publish_dir_skips_bookkeeping_and_is_idempotent(tmp_path):
    src = tmp_path / "baked"
    src.mkdir()
    (src / "tc-cafe01").write_bytes(b"lib-1")
    (src / "tc-cafe02").write_bytes(b"lib-2")
    (src / "tc-cafe01-atime").write_bytes(b"lru")
    (src / "tc-cafe01.sha256").write_text("not-content")
    (src / "tc-cafe03.tmp.77").write_bytes(b"in flight")
    store = CompileCacheStore(str(tmp_path / "store"))
    assert store.publish_dir(str(src)) == 2
    assert store.keys() == ["tc-cafe01", "tc-cafe02"]
    assert store.get_bytes("tc-cafe01") == b"lib-1"
    assert store.publish_dir(str(src)) == 0


@pytest.mark.parametrize("writer, reader", [(CompileCacheStore, JaxStore), (JaxStore, CompileCacheStore)])
def test_each_packages_store_reads_the_others(tmp_path, writer, reader):
    """One layout: body plus `<key>.sha256`, verified on read; a corrupt
    entry written by one is evicted by the other."""
    key = compile_cache_key(**KEY_BASE)
    w = writer(str(tmp_path))
    assert w.put_bytes(key, b"kernel-library") and w.put_bytes("xc-" + "b" * 64, b"jax-executable")
    r = reader(str(tmp_path))
    assert r.keys() == sorted([key, "xc-" + "b" * 64])
    assert r.get_bytes(key) == b"kernel-library" and r.digest(key) == entry_digest(b"kernel-library")
    (tmp_path / key).write_bytes(b"rot")
    assert r.get_bytes(key) is None and not w.has(key)


# -- the client: gate, coordinates, local-dir fast path ------------------------


def _counter(name, **labels):
    return getattr(catalog, name).value(**labels)


def test_gate_off_disables_fleet_tier(tmp_path, monkeypatch):
    monkeypatch.setenv("MODAL_TPU_COMPILE_CACHE", "0")
    monkeypatch.setenv("MODAL_TPU_COMPILE_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("MODAL_TPU_COMPILE_CACHE_URL", "http://127.0.0.1:1")
    assert FleetCompileCache.from_env() is None
    assert compile_client.install_fleet_cache() is False
    assert _build.fleet_tier() is None


def test_no_coordinates_disables_fleet_tier(tmp_path, monkeypatch):
    monkeypatch.setenv("MODAL_TPU_COMPILE_CACHE", "1")
    monkeypatch.delenv("MODAL_TPU_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.delenv("MODAL_TPU_COMPILE_CACHE_URL", raising=False)
    assert FleetCompileCache.from_env() is None
    monkeypatch.setenv("MODAL_TPU_COMPILE_CACHE_DIR", str(tmp_path / "gone"))  # stat-verified
    assert FleetCompileCache.from_env() is None


def test_local_dir_fast_path_hit_and_counters(tmp_path):
    CompileCacheStore(str(tmp_path)).put_bytes("k", b"library-bytes")
    fleet = FleetCompileCache(local_dir=str(tmp_path))
    h0 = _counter("COMPILE_CACHE_HITS", source="local_dir")
    e0 = _counter("COMPILE_EVENTS", event="cache_hit", source="fleet")
    assert fleet.get("k") == b"library-bytes"
    assert _counter("COMPILE_CACHE_HITS", source="local_dir") == h0 + 1
    assert _counter("COMPILE_EVENTS", event="cache_hit", source="fleet") == e0 + 1
    m0 = _counter("COMPILE_CACHE_MISSES", source="local_dir")
    assert fleet.get("absent") is None
    assert _counter("COMPILE_CACHE_MISSES", source="local_dir") == m0 + 1
    p0 = _counter("COMPILE_CACHE_PUTS", source="local_dir")
    assert fleet.put("k2", b"built") and CompileCacheStore(str(tmp_path)).get_bytes("k2") == b"built"
    assert _counter("COMPILE_CACHE_PUTS", source="local_dir") == p0 + 1


def test_local_corrupt_entry_degrades_and_evicts(tmp_path):
    CompileCacheStore(str(tmp_path)).put_bytes("k", b"good")
    (tmp_path / "k").write_bytes(b"rot")
    fleet = FleetCompileCache(local_dir=str(tmp_path))
    c0 = _counter("COMPILE_CACHE_ERRORS", kind="corrupt")
    assert fleet.get("k") is None
    assert _counter("COMPILE_CACHE_ERRORS", kind="corrupt") == c0 + 1
    assert not (tmp_path / "k").exists()


def test_unreachable_service_degrades_silently_with_cooldown():
    fleet = FleetCompileCache(url="http://127.0.0.1:9", timeout_s=0.2)
    u0 = _counter("COMPILE_CACHE_ERRORS", kind="unreachable")
    for _ in range(3):
        assert fleet.get("k") is None
    assert _counter("COMPILE_CACHE_ERRORS", kind="unreachable") == u0 + 3
    assert not fleet._http_usable(), "3 consecutive errors must open the cooldown"
    assert fleet.get("k") is None
    assert _counter("COMPILE_CACHE_ERRORS", kind="unreachable") == u0 + 3
    assert fleet.put("k", b"x") is False


# -- the HTTP tier against the JAX package's blob server -----------------------


def test_http_tier_roundtrip_against_blob_server(supervisor, tmp_path):
    base = supervisor.state.blob_url_base
    fleet = FleetCompileCache(url=base)
    key = compile_cache_key(**KEY_BASE)
    p0 = _counter("COMPILE_CACHE_PUTS", source="http")
    h0 = _counter("COMPILE_CACHE_HITS", source="http")
    assert fleet.put(key, b"kernel-library")
    assert fleet.get(key) == b"kernel-library"
    assert _counter("COMPILE_CACHE_PUTS", source="http") == p0 + 1
    assert _counter("COMPILE_CACHE_HITS", source="http") == h0 + 1
    assert supervisor.state.compile_cache.get_bytes(key) == b"kernel-library"
    local = tmp_path / "warm"
    local.mkdir()
    assert FleetCompileCache(url=base, local_dir=str(local)).get(key) == b"kernel-library"
    assert CompileCacheStore(str(local)).get_bytes(key) == b"kernel-library"  # the http hit warmed it


def test_http_corrupt_entry_is_verified_and_evicted(supervisor):
    store = supervisor.state.compile_cache
    key = compile_cache_key(**{**KEY_BASE, "arch": "sm_90"})
    store.put_bytes(key, b"pristine")
    with open(store.path(key), "wb") as f:
        f.write(b"bitrot")
    c0 = _counter("COMPILE_CACHE_ERRORS", kind="corrupt")
    assert FleetCompileCache(url=supervisor.state.blob_url_base).get(key) is None
    assert _counter("COMPILE_CACHE_ERRORS", kind="corrupt") == c0 + 1
    assert not store.has(key), "the client's DELETE must evict the rotten entry"


def test_http_put_with_wrong_digest_rejected(supervisor):
    """The server recomputes the digest of what arrived: mangled bytes get a
    422, nothing is stored, and the port's client then reads a clean miss."""
    base = supervisor.state.blob_url_base
    key = compile_cache_key(**{**KEY_BASE, "source": b"mangled"})
    req = urllib.request.Request(
        f"{base}/compile/{key}", data=b"these-bytes", method="PUT",
        headers={"X-Content-SHA256": hashlib.sha256(b"other-bytes").hexdigest()},
    )
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(req, timeout=5.0)
    assert exc_info.value.code == 422
    assert not supervisor.state.compile_cache.has(key)
    assert FleetCompileCache(url=base).get(key) is None


# -- the tier under the kernel builds ------------------------------------------

STUB_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
if [ "$1" = "--version" ]; then echo "nvcc: stub, {version}"; exit 0; fi
if [ -n "{fail}" ]; then echo "error: stub refuses" >&2; exit 1; fi
while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then shift; echo "not a shared library" > "$1"; fi; shift; done
"""


def _stub_nvcc(tmp_path, monkeypatch, version="release 12.8", fail=False):
    """A stub nvcc first on PATH; returns a function giving its calls."""
    bindir = tmp_path / f"bin-{version.replace(' ', '_')}-{int(fail)}"
    bindir.mkdir()
    log = tmp_path / "nvcc-calls.log"
    script = bindir / "nvcc"
    script.write_text(STUB_NVCC.format(log=log, version=version, fail="1" if fail else ""))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "_nvcc_versions", {})
    return lambda: log.read_text().splitlines() if log.exists() else []


def _compiles(calls):
    return [c for c in calls if "-o" in c.split()]


@pytest.fixture
def no_fleet(monkeypatch):
    monkeypatch.setattr(_build, "_fleet", None)


def test_library_key_changes_with_the_nvcc_version(tmp_path, monkeypatch, no_fleet):
    """The key asks no compiler, and each build keeps its full `--version`
    output beside the library: a machine whose nvcc disagrees with it never
    loads that library, and builds under a key that names its own nvcc."""
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", str(tmp_path / "build"))
    calls = _stub_nvcc(tmp_path, monkeypatch, "release 12.8")
    assert _build.build(["paged_decode"])["paged_decode"]["source"] == "nvcc"
    old = _build.library_path("paged_decode")
    assert old == _build.library_path("paged_decode", _build.cache_key("paged_decode"))
    with open(old + ".nvcc") as f:
        assert "release 12.8" in f.read()
    _stub_nvcc(tmp_path, monkeypatch, "release 12.9")
    new = _build.library_path("paged_decode")
    assert old != new and os.path.dirname(old) == str(tmp_path / "build")
    assert os.path.basename(new).startswith("paged_decode-tc-")
    assert _build.build(["paged_decode"])["paged_decode"]["source"] == "nvcc"
    assert len(_compiles(calls())) == 2 and os.path.exists(new)
    monkeypatch.delenv("TORCH_EXTENSIONS_DIR")
    assert os.path.dirname(_build.library_path("paged_decode")) == _build.DEFAULT_BUILD_DIR


def test_a_library_is_found_by_its_key_with_no_nvcc(tmp_path, monkeypatch, no_fleet):
    """A container with the torch stack and no CUDA toolkit: its key needs
    no compiler, so it finds the library the fleet store holds under that
    key and runs no subprocess. With no library anywhere, it raises and
    names the key it looked for (nothing falls back)."""
    import subprocess

    bare = tmp_path / "bin-bare"
    bare.mkdir()
    monkeypatch.setenv("PATH", str(bare))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    assert _build.find_nvcc() is None

    def no_subprocess(*a, **k):
        raise AssertionError(f"a subprocess ran: {a}")

    monkeypatch.setattr(subprocess, "run", no_subprocess)
    monkeypatch.setattr(subprocess, "Popen", no_subprocess)
    key = _build.cache_key("paged_decode")
    assert _build.library_key("paged_decode") == key
    fleet = FleetCompileCache(local_dir=str(tmp_path / "fleet"))
    os.makedirs(fleet.local_dir)
    assert fleet.put_meta(key, "nvcc: release 12.8") and fleet.put(key, b"the library")
    monkeypatch.setattr(_build, "_fleet", fleet)
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", str(tmp_path / "build"))
    assert _build.build(["paged_decode"])["paged_decode"]["source"] == "fleet"
    with open(_build.library_path("paged_decode"), "rb") as f:
        assert f.read() == b"the library"
    with open(_build.library_path("paged_decode") + ".nvcc") as f:
        assert f.read() == "nvcc: release 12.8"
    os.makedirs(tmp_path / "fleet-empty")
    monkeypatch.setattr(_build, "_fleet", FleetCompileCache(local_dir=str(tmp_path / "fleet-empty")))
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", str(tmp_path / "build-empty"))
    with pytest.raises(RuntimeError, match=f"no library under key {key}.*no nvcc"):
        _build.build(["paged_decode"])


def test_cold_fleet_rollout_builds_with_zero_compiles(tmp_path, monkeypatch, no_fleet):
    """Container 1 (its own empty build dir) compiles K4 and publishes it;
    container 2 (another empty build dir, the same store) asks the fleet and
    runs nvcc only for `--version`: zero compiles, one fleet hit, the same
    bytes. Then a local hit needs neither."""
    calls = _stub_nvcc(tmp_path, monkeypatch)
    store = tmp_path / "fleet"
    store.mkdir()
    monkeypatch.setenv("MODAL_TPU_COMPILE_CACHE_DIR", str(store))
    monkeypatch.delenv("MODAL_TPU_COMPILE_CACHE_URL", raising=False)
    monkeypatch.delenv("MODAL_TPU_COMPILE_CACHE", raising=False)
    assert compile_client.install_fleet_cache() and compile_client.install_fleet_cache()
    try:
        monkeypatch.setenv("TORCH_EXTENSIONS_DIR", str(tmp_path / "build-a"))
        first = _build.build(["paged_decode"])["paged_decode"]
        assert first["source"] == "nvcc"
        assert len(_compiles(calls())) == 1
        key = _build.cache_key("paged_decode")
        assert CompileCacheStore(str(store)).keys() == [key, key + ".nvcc"]
        monkeypatch.setenv("TORCH_EXTENSIONS_DIR", str(tmp_path / "build-b"))
        h0 = catalog.COMPILE_CACHE_HITS.total()
        before = len(calls())
        second = _build.build(["paged_decode"])["paged_decode"]
        assert second["source"] == "fleet"
        assert calls()[before:] == [] or all(c == "--version" for c in calls()[before:])
        assert len(_compiles(calls())) == 1, "the second container compiled"
        assert catalog.COMPILE_CACHE_HITS.total() == h0 + 1
        with open(_build.library_path("paged_decode"), "rb") as f:
            assert f.read() == CompileCacheStore(str(store)).get_bytes(key)
        assert _build.build(["paged_decode"])["paged_decode"]["source"] == "local"
    finally:
        compile_client.uninstall_fleet_cache()
    assert _build.fleet_tier() is None


def test_failed_build_or_load_still_raises(tmp_path, monkeypatch, no_fleet):
    """The fleet tier only changes where a library comes from: a failed
    compile raises, a library that does not load raises (nothing falls
    back), and a dead fleet service only means a local build."""
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", str(tmp_path / "build"))
    _stub_nvcc(tmp_path, monkeypatch, fail=True)
    with pytest.raises(RuntimeError, match="CUDA kernel build failed"):
        _build.build(["paged_decode"])
    _stub_nvcc(tmp_path, monkeypatch)
    monkeypatch.setattr(_build, "_fleet", FleetCompileCache(url="http://127.0.0.1:9", timeout_s=0.2))
    assert _build.build(["paged_decode"])["paged_decode"]["source"] == "nvcc"
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(OSError):
        _build.load("paged_decode")  # the stub's output is not a shared library
    assert "paged_decode" not in _build._libs


def test_maybe_aot_lower_installs_the_tier_and_publishes(tmp_path, monkeypatch, no_fleet):
    """The AOT warm-up puts the fleet tier under the builds first, so the
    kernels it builds land in the store for the next container."""
    calls = _stub_nvcc(tmp_path, monkeypatch)
    store = tmp_path / "fleet"
    store.mkdir()
    monkeypatch.setenv("MODAL_TPU_COMPILE_CACHE_DIR", str(store))
    monkeypatch.delenv("MODAL_TPU_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", str(tmp_path / "build"))
    monkeypatch.setenv(aot.AOT_ENV, "decode,cfg=tiny")
    try:
        out = aot.maybe_aot_lower()
        assert isinstance(_build.fleet_tier(), FleetCompileCache)
    finally:
        compile_client.uninstall_fleet_cache()
    assert out["decode"]["kernels"] == ["paged_decode"] and "errors" not in out
    assert len(_compiles(calls())) == 1
    key = _build.cache_key("paged_decode")
    assert CompileCacheStore(str(store)).keys() == [key, key + ".nvcc"]
