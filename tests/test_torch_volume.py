"""The port's Volumes (`modal_tpu_torch/volume.py`, the plane's Volume*
handlers and the blob server's /block and /volfile routes) against the JAX
package's, on the CPU.

Counterparts of tests/test_dataplane.py's volume cases and
tests/test_weights.py's Volume cases, each run through both packages on the
module's two planes (`tests/test_torch_app.Planes`) and compared: a file of
2.5 blocks (20 MiB + 123 bytes from a seed) read whole into every kind of
target, ranged reads over the three block planes (the store's files in
place, HTTP recv_into, gRPC) with their EOF clamp, the /volfile Range
route, the file operations (list, copy, remove, rename, delete), the
weights loader's buffer fill, an llama `tiny` checkpoint exported to a
Volume (shards byte-equal to JAX's) and loaded back, and a function with a
Volume mounted whose writes its container commits at exit. Every
comparison is exact."""

import io
import os
import tempfile

import numpy as np
import pytest
import torch

import modal_tpu
import modal_tpu_torch
from modal_tpu._utils.async_utils import synchronizer as jsync
from modal_tpu_torch._utils.async_utils import synchronizer as tsync
from tests.test_torch_app import CONTAINER_ENV, Planes

BLOCK = 8 * 1024 * 1024
DATA = np.random.default_rng(3).integers(0, 256, size=20 * 1024 * 1024 + 123, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def planes():
    saved = {k: os.environ.get(k) for k in CONTAINER_ENV}
    os.environ.update(CONTAINER_ENV)
    p = Planes(tempfile.mkdtemp(prefix="vol-", dir="/tmp"))
    try:
        yield p
    finally:
        p.close()
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)


def _volume(m, client, name: str):
    vol = m.Volume.from_name(name, create_if_missing=True)
    vol.hydrate(client)
    return vol


@pytest.fixture(scope="module")
def multiblock(planes):
    """{package name: volume} each holding DATA at ckpt/data.bin."""
    out = {}
    for name, m in (("jax", modal_tpu), ("port", modal_tpu_torch)):
        vol = _volume(m, planes.of(m)[0], "multiblock")
        with vol.batch_upload(force=True) as batch:
            batch.put_data(DATA, "ckpt/data.bin")
        out[name] = vol
    return out


def _into_file(vol, mode: str) -> bytes:
    with tempfile.NamedTemporaryFile(delete=False) as tmp:
        path = tmp.name
    try:
        with open(path, mode) as f:
            assert vol.read_file_into("ckpt/data.bin", f) == len(DATA)
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


def _into_bytesio(vol, trailing: int) -> bytes:
    buf = io.BytesIO(b"x" * (len(DATA) + trailing) if trailing else b"")
    buf.seek(0)
    assert vol.read_file_into("ckpt/data.bin", buf) == len(DATA)
    return buf.getvalue()


@pytest.mark.parametrize("target", ["r+b file", "wb file", "BytesIO", "BytesIO with trailing content"])
def test_read_file_into_every_target(multiblock, target):
    """The striped engine into a file (mmap'd), a write-only file (the
    pwrite fallback), a BytesIO, and the middle of a longer buffer (its
    tail left as it was)."""
    read = {
        "r+b file": lambda v: _into_file(v, "r+b"),
        "wb file": lambda v: _into_file(v, "wb"),
        "BytesIO": lambda v: _into_bytesio(v, 0),
        "BytesIO with trailing content": lambda v: _into_bytesio(v, 1000),
    }[target]
    got = {name: read(vol) for name, vol in multiblock.items()}
    want = DATA + (b"x" * 1000 if target.endswith("content") else b"")
    assert got["port"] == got["jax"] == want


def test_read_file_range_into_lands_the_same_bytes_over_every_plane(multiblock):
    """A range straddling blocks 0 and 1 through the store's files in place,
    HTTP recv_into (the local dir hidden) and gRPC (HTTP marked down)."""
    offset, length = BLOCK - 1000, 2000

    def planes_of(vol) -> list:
        def read() -> bytes:
            buf = bytearray(length)
            assert vol.read_file_range_into("ckpt/data.bin", offset, length, buf) == length
            return bytes(buf)

        out = [read()]
        orig = vol._usable_local_block_dir
        vol._usable_local_block_dir = lambda *a, **k: ""
        try:
            out.append(read())
            vol._block_http_down = True
            out.append(read())
        finally:
            vol._usable_local_block_dir = orig
            vol._block_http_down = False
        return out

    got = {name: planes_of(vol) for name, vol in multiblock.items()}
    assert got["port"] == got["jax"] == [DATA[offset:offset + length]] * 3


@pytest.mark.parametrize("offset,length", [(BLOCK - 100, 200), (2 * BLOCK - 10, 10_000), (0, 0),
                                           (len(DATA) - 100, 500), (len(DATA) + 50, 10),
                                           (len(DATA) + 3 * BLOCK, 10)])
def test_read_file_range_clamps_at_eof(multiblock, offset, length):
    """Ranges across blocks, running past EOF (clamped) and past it
    entirely. The JAX package's clamped read can raise BufferError: it
    resizes its buffer while a view of it from the striped read may still
    live in a reference cycle (ROADMAP Queue C 29; the port copies the
    written part instead). Its answer is then read again after a
    collection."""
    import gc

    port = multiblock["port"].read_file_range("ckpt/data.bin", offset, length)
    try:
        jax = multiblock["jax"].read_file_range("ckpt/data.bin", offset, length)
    except BufferError:
        gc.collect()
        jax = multiblock["jax"].read_file_range("ckpt/data.bin", offset, length)
    assert port == jax == DATA[offset:offset + length]


def test_read_file_range_refuses_negative_and_stats_at_length_zero(planes):
    def scenario(m, client, sup):
        vol = _volume(m, client, "range-neg")
        with vol.batch_upload(force=True) as batch:
            batch.put_data(b"hello", "f.bin")
        out = []
        for args in ((-5, 10), (0, -1)):
            with pytest.raises(ValueError):
                vol.read_file_range("f.bin", *args)
            out.append("ValueError")
        out.append(vol.read_file_range("f.bin", 0, 0))
        with pytest.raises(m.exception.NotFoundError):
            vol.read_file_range("missing.bin", 0, 0)
        return out

    got = planes.both(scenario)
    assert got["port"] == got["jax"] == ["ValueError", "ValueError", b""]


@pytest.mark.parametrize("lo,hi", [(BLOCK - 10, BLOCK + 10), (0, 5), (2 * BLOCK, len(DATA))])
def test_the_volfile_route_stitches_blocks_under_range(planes, multiblock, lo, hi):
    from modal_tpu._utils.blob_utils import _get_range as jget
    from modal_tpu_torch._utils.blob_utils import _get_range as tget

    got = {}
    for (name, vol), sync, get, sup in (("jax", multiblock["jax"]), jsync, jget, planes.jsup), \
                                        (("port", multiblock["port"]), tsync, tget, planes.tsup):
        url = f"{sup.state.blob_url_base}/volfile/{vol.object_id}/ckpt/data.bin"
        got[name] = sync.run(get(url, lo, hi))
    assert got["port"] == got["jax"] == DATA[lo:hi]


def test_the_block_route_and_a_missing_file_answer_as_jax_does(planes, multiblock):
    import aiohttp

    async def status(url: str, rng: str) -> tuple:
        async with aiohttp.ClientSession() as s:
            async with s.get(url, headers={"Range": rng} if rng else {}) as r:
                return r.status, len(await r.read())

    got = {}
    for name, sync, sup in (("jax", jsync, planes.jsup), ("port", tsync, planes.tsup)):
        vol = multiblock[name]
        entry = vol.listdir("ckpt")[0]
        base = sup.state.blob_url_base
        first = list(sup.state.volumes[vol.object_id].files["ckpt/data.bin"].block_sha256_hex)[0]
        got[name] = [sync.run(status(f"{base}/block/{first}", "bytes=10-19")),
                     sync.run(status(f"{base}/block/{first}", "")),
                     sync.run(status(f"{base}/volfile/{vol.object_id}/nope.bin", "")),
                     sync.run(status(f"{base}/volfile/{vol.object_id}/ckpt/data.bin", f"bytes={len(DATA)}-")),
                     entry.size]
    assert got["port"] == got["jax"] == [(206, 10), (200, BLOCK), (404, 9), (416, 19), len(DATA)]


def test_file_operations_match_jax(planes):
    """put, listdir (flat and recursive), iterdir, copy_files into a dir and
    onto a name, remove_file (a file, a tree), rename, VolumeList, delete."""

    def scenario(m, client, sup):
        vol = _volume(m, client, "ops")
        with vol.batch_upload() as batch:
            batch.put_data(b"a" * 10, "d/a.bin")
            batch.put_data(b"b" * 20, "d/e/b.bin")
            batch.put_data(b"", "empty")
        out = {"flat": sorted(f.path for f in vol.listdir("/")),
               "recursive": sorted((f.path, f.size) for f in vol.listdir("/", recursive=True)),
               "iter": sorted(f.path for f in vol.iterdir("d", recursive=False))}
        with pytest.raises(Exception) as exc:  # batch_upload refuses to overwrite unless forced
            with vol.batch_upload() as batch:
                batch.put_data(b"x", "d/a.bin")
        out["overwrite"] = type(exc.value).__name__
        vol.copy_files(["d/a.bin", "d/e/b.bin"], "c/")
        vol.copy_files(["d/a.bin"], "renamed.bin")
        out["copied"] = sorted(f.path for f in vol.listdir("/", recursive=True))
        out["copy_bytes"] = b"".join(vol.read_file("renamed.bin"))
        vol.remove_file("d", recursive=True)
        vol.remove_file("empty")
        with pytest.raises(m.exception.NotFoundError):
            vol.remove_file("empty")
        out["after_rm"] = sorted(f.path for f in vol.listdir("/", recursive=True))
        vol.commit()
        vol.reload()
        m.Volume.rename("ops", "ops2", client=client)
        out["listed"] = sorted(v.name for v in sup.state.volumes.values() if v.name.startswith("ops"))
        with pytest.raises(m.exception.NotFoundError):
            m.Volume.lookup("ops", client=client)
        m.Volume.delete("ops2", client=client)
        out["deleted"] = sorted(v.name for v in sup.state.volumes.values() if v.name.startswith("ops"))
        return out

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"]["copied"] == ["c/a.bin", "c/b.bin", "d/a.bin", "d/e/b.bin", "empty", "renamed.bin"]


def test_the_weights_loader_fills_its_buffer_from_a_volume(multiblock):
    from modal_tpu.models.weights import VolumeSource as JaxSource
    from modal_tpu_torch.models.weights import VolumeSource

    jbuf, tbuf = bytearray(4096), bytearray(4096)
    assert jsync.run(JaxSource(multiblock["jax"], "ckpt").read_into("data.bin", 1000, 4096, jbuf)) == 4096
    src = VolumeSource(multiblock["port"], "ckpt")
    assert src.read_into("data.bin", 1000, 4096, tbuf) == 4096
    assert bytes(tbuf) == bytes(jbuf) == DATA[1000:5096]
    assert src.exists("data.bin") and not src.exists("nope.bin")
    assert src.read_all("data.bin") == DATA


def test_a_checkpoint_exported_to_a_volume_is_jax_s_and_loads_back(planes):
    """llama `tiny` (fp32, PRNGKey(0)) exported by both packages into their
    Volumes in 256 KiB shards: the same files byte for byte; the port loads
    its Volume's checkpoint bit-equal, and a second export to the prefix
    (one file) leaves no stale index behind."""
    import jax

    from modal_tpu.models import llama as jllama
    from modal_tpu.models import weights as jweights
    from modal_tpu_torch.models import llama as tllama
    from modal_tpu_torch.models import weights as tweights
    from modal_tpu_torch.models.convert import params_from_jax

    jcfg = jllama.get_config("tiny")
    tcfg = tllama.get_config("tiny", dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jvol = _volume(modal_tpu, planes.jclient, "weights")
    tvol = _volume(modal_tpu_torch, planes.tclient, "weights")
    jindex = jweights.export_checkpoint(jparams, jcfg, (jvol, "llama/tiny"), max_shard_bytes=256 * 1024)
    tindex = tweights.export_checkpoint(tparams, tcfg, (tvol, "llama/tiny"), max_shard_bytes=256 * 1024)
    assert tindex == jindex and len(set(tindex["weight_map"].values())) > 1
    files = {}
    for name, vol in (("jax", jvol), ("port", tvol)):
        files[name] = {f.path: b"".join(vol.read_file(f.path)) for f in vol.listdir("llama/tiny")}
    assert files["port"] == files["jax"]
    loaded = tweights.load_params((tvol, "llama/tiny"), tcfg, device="cpu")
    for key in ("embed", "final_norm", "lm_head"):
        assert torch.equal(loaded[key], tparams[key]), key
    for key, t in tparams["layers"].items():
        assert torch.equal(loaded["layers"][key], t), key
    tweights.export_checkpoint(tparams, tcfg, (tvol, "llama/tiny"))
    assert [f.path for f in tvol.listdir("llama/tiny")] == ["llama/tiny/model.safetensors"]
    assert torch.equal(tweights.load_params((tvol, "llama/tiny"), tcfg, device="cpu")["embed"], tparams["embed"])


def test_a_mounted_volume_is_committed_by_the_container(planes):
    """`volumes={"/data": vol}`: the definition carries the mount, the
    container writes through the Volume, and its exit (scaled down when
    idle) commits it: the committed version moves."""

    def scenario(m, client, sup):
        app = m.App("vol-mount")
        vol = _volume(m, client, "mounted")

        def writer(pkg, n):
            import importlib

            v = importlib.import_module(pkg).Volume.from_name("mounted")
            v.hydrate()
            with v.batch_upload(force=True) as batch:
                batch.put_data(bytes(range(n)), "out.bin")
            return n

        f = app.function(serialized=True, volumes={"/data": vol}, scaledown_window=2)(writer)
        from tests.test_torch_app import _wait_tasks_finished

        with app.run(client=client):
            assert f.remote(m.__name__, 7) == 7
            mounts = dict(sup.state.functions[f.object_id].definition.volume_mounts)
            # the idle container exits on its own (scaledown), through its
            # exit path
            _wait_tasks_finished(sup, app.app_id)
        state = sup.state.volumes[vol.object_id]
        return {"mounts": mounts == {"/data": vol.object_id}, "data": b"".join(vol.read_file("out.bin")),
                "committed": state.committed_version}

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"]["mounts"] and got["port"]["data"] == bytes(range(7)) and got["port"]["committed"] >= 1
