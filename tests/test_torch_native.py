"""The port's native block hasher (modal_tpu_torch/_native, built from its
own copy of the source in modal_tpu_torch/csrc/) against hashlib and the
JAX package's hasher, on the CPU: the same digests on the same seeded
bytes (ragged tails, an exact multiple, empty data, an empty file), a
Volume upload through both planes with `MODAL_TPU_NATIVE_HASH=1`, a build
that fails raising where JAX falls back, and the ThreadSanitizer job on
the port's copy (`slow`, as JAX's is)."""

import hashlib
import os
import subprocess
import tempfile

import numpy as np
import pytest

from modal_tpu import _native as jnative
from modal_tpu_torch import _native as tnative
from modal_tpu_torch._utils import hash_utils as thash

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "modal_tpu_torch", "csrc")


def _seeded(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


def _hashlib(data: bytes, block: int) -> list[str]:
    return [hashlib.sha256(data[off : off + block]).hexdigest() for off in range(0, max(len(data), 1), block)]


@pytest.mark.parametrize("size,block", [(0, 4096), (1, 4096), (4096 * 3, 4096), (4096 * 3 + 17, 4096),
                                        (1_000_003, 65536)])
def test_block_digests_equal_hashlib_and_jax(size, block):
    data = _seeded(size, seed=size)
    want = _hashlib(data, block)
    assert tnative.hash_blocks(data, block) == want
    assert tnative.hash_blocks(memoryview(data), block, n_threads=3) == want
    assert tnative.hashlib_blocks(data, block) == want
    assert jnative.hash_blocks(data, block) == want


@pytest.mark.parametrize("size", [0, 1, 4096 * 3 + 17])
def test_sha256_hex_equals_hashlib_and_jax(size):
    data = _seeded(size, seed=size)
    want = hashlib.sha256(data).hexdigest()
    assert tnative.sha256_hex(data) == jnative.sha256_hex(data) == want
    assert tnative.sha256_hex(memoryview(data)) == want


@pytest.mark.parametrize("size", [0, 8192 * 4, 8192 * 4 + 11])
def test_file_digests_equal_hashlib_and_jax(tmp_path, monkeypatch, size):
    block = 8192
    data = _seeded(size, seed=7 + size)
    path = tmp_path / "payload.bin"
    path.write_bytes(data)
    want = _hashlib(data, block)
    assert tnative.hash_file_blocks(str(path), block) == want
    assert jnative.hash_file_blocks(str(path), block) == want
    monkeypatch.setenv("MODAL_TPU_NATIVE_HASH", "1")
    assert thash.get_file_blocks_sha256(path, block) == want
    assert thash.get_blocks_sha256(data, block) == want
    monkeypatch.delenv("MODAL_TPU_NATIVE_HASH")
    assert thash.get_file_blocks_sha256(path, block) == want
    assert thash.get_blocks_sha256(data, block) == want


def test_a_missing_file_raises_and_the_library_is_the_ports_own(tmp_path):
    with pytest.raises(OSError):
        tnative.hash_file_blocks(str(tmp_path / "ghost"), 4096)
    path = tnative.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "modal_tpu_torch", "_build")
    assert os.path.basename(path).startswith("blockhash-tc-") and os.path.exists(path)
    assert tnative.native_available()


def test_the_knob_routes_hashing_and_a_failed_build_raises(tmp_path, monkeypatch):
    """With MODAL_TPU_NATIVE_HASH=1 and no compiler the port raises (the
    JAX package would hash with hashlib); unset, hashlib answers as in JAX."""
    data = _seeded(50_000, seed=3)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setenv("MODAL_TPU_NATIVE_HASH", "1")
    with pytest.raises(tnative.NativeHashError, match="cannot build"):
        thash.get_blocks_sha256(data, 8192)
    path = tmp_path / "f.bin"
    path.write_bytes(data)
    with pytest.raises(tnative.NativeHashError):
        thash.get_file_blocks_sha256(path, 8192)
    assert not tnative.native_available()
    monkeypatch.delenv("MODAL_TPU_NATIVE_HASH")
    assert thash.get_blocks_sha256(data, 8192) == thash.get_file_blocks_sha256(path, 8192) == _hashlib(data, 8192)


def test_a_broken_source_raises_the_compilers_error(tmp_path, monkeypatch):
    broken = tmp_path / "blockhash.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "SOURCE", str(broken))
    with pytest.raises(tnative.NativeHashError, match="failed"):
        tnative.hash_blocks(b"x", 1)
    assert os.listdir(tmp_path / "build") == []  # the temporary is gone


def test_a_volume_upload_hashes_natively_through_both_planes(monkeypatch):
    """`MODAL_TPU_NATIVE_HASH=1`: both packages' uploads hash the file's
    blocks with their native hasher, and the bytes come back equal."""
    from tests.test_torch_app import CONTAINER_ENV, Planes

    calls = {"jax": 0, "port": 0}
    for name, mod in (("jax", jnative), ("port", tnative)):
        real = mod.hash_file_blocks

        def spy(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(mod, "hash_file_blocks", spy)
    monkeypatch.setenv("MODAL_TPU_NATIVE_HASH", "1")
    for k, v in CONTAINER_ENV.items():
        monkeypatch.setenv(k, v)
    data = _seeded(3 * 1024 * 1024 + 17, seed=11)
    root = tempfile.mkdtemp(prefix="native-", dir="/tmp")
    src = os.path.join(root, "blob.bin")
    with open(src, "wb") as f:
        f.write(data)
    planes = Planes(root)
    try:
        def scenario(m, client, sup):
            vol = m.Volume.from_name("native-hash-vol", create_if_missing=True)
            vol.hydrate(client=client)
            with vol.batch_upload() as batch:
                batch.put_file(src, "blob.bin")
            return b"".join(vol.read_file("blob.bin")) == data

        got = planes.both(scenario)
    finally:
        planes.close()
    assert got == {"jax": True, "port": True}
    assert calls["jax"] >= 1 and calls["port"] >= 1, calls


@pytest.mark.slow
def test_the_ports_blockhash_under_thread_sanitizer(tmp_path):
    """The port's copy built with -fsanitize=thread and hammered with 16
    threads over adjacent output slots: TSAN stays silent and the parallel
    digests equal the serial ones."""
    binary = str(tmp_path / "blockhash_tsan")
    build = subprocess.run(
        ["g++", "-O1", "-g", "-fsanitize=thread", "-pthread", "-o", binary,
         os.path.join(CSRC, "blockhash_tsan_test.cpp"), os.path.join(CSRC, "blockhash.cpp")],
        capture_output=True, text=True, timeout=180,
    )
    if build.returncode != 0 and "tsan" in (build.stderr or "").lower():
        pytest.skip(f"toolchain lacks TSAN runtime: {build.stderr[-200:]}")
    assert build.returncode == 0, build.stderr
    run = subprocess.run([binary], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "TSAN_OPTIONS": "halt_on_error=1"})
    assert "WARNING: ThreadSanitizer" not in run.stderr, run.stderr[-2000:]
    assert run.returncode == 0, (run.stdout, run.stderr[-2000:])
    assert "TSAN_OK" in run.stdout
