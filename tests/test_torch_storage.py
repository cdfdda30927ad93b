"""The port's storage mounts (`network_file_system.py`,
`cloud_bucket_mount.py`, `_utils/s3.py`, `runtime/bucket_mounts.py`)
against the JAX package's, on the CPU.

Counterparts of tests/test_storage_extra.py's NFS and bucket-mount cases,
each run through both packages on the module's two planes
(`tests/test_torch_app.Planes`) against one S3 emulator of the port's own
(ListObjectsV2, GET and PUT on the port's synchronizer loop), and
compared: a bucket prefix synced into the container before its code runs,
the files it writes there uploaded at exit, nothing uploaded from a
read-only mount, and the SigV4 signature of a signed request."""

import os
import tempfile
import time

import pytest

import modal_tpu
import modal_tpu_torch
from tests.test_torch_app import CONTAINER_ENV, Planes


@pytest.fixture(scope="module")
def planes():
    saved = {k: os.environ.get(k) for k in CONTAINER_ENV}
    os.environ.update(CONTAINER_ENV)
    p = Planes(tempfile.mkdtemp(prefix="storage-", dir="/tmp"))
    try:
        yield p
    finally:
        p.close()
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)


@pytest.fixture(scope="module")
def s3():
    """A minimal S3-compatible server: {bucket: {key: bytes}} and its URL."""
    from aiohttp import web

    from modal_tpu_torch._utils.async_utils import synchronizer

    store: dict[str, dict[str, bytes]] = {}

    async def start():
        async def handle_bucket(request):
            prefix = request.query.get("prefix", "")
            keys = sorted(k for k in store.get(request.match_info["bucket"], {}) if k.startswith(prefix))
            contents = "".join(f"<Contents><Key>{k}</Key></Contents>" for k in keys)
            return web.Response(text=f'<?xml version="1.0"?><ListBucketResult><IsTruncated>false</IsTruncated>'
                                     f"{contents}</ListBucketResult>", content_type="application/xml")

        async def handle_get(request):
            data = store.get(request.match_info["bucket"], {}).get(request.match_info["key"])
            return web.Response(status=404) if data is None else web.Response(body=data)

        async def handle_put(request):
            store.setdefault(request.match_info["bucket"], {})[request.match_info["key"]] = await request.read()
            return web.Response()

        app = web.Application()
        app.router.add_get("/{bucket}", handle_bucket)
        app.router.add_get("/{bucket}/{key:.+}", handle_get)
        app.router.add_put("/{bucket}/{key:.+}", handle_put)
        runner = web.AppRunner(app, access_log=None)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        return runner, f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"

    runner, url = synchronizer.run(start())
    try:
        yield store, url
    finally:
        synchronizer.run(runner.cleanup())


def test_a_network_file_system_is_a_v1_volume_under_its_name(planes):
    def scenario(m, client, sup):
        nfs = m.NetworkFileSystem.from_name("shared", create_if_missing=True)
        nfs.hydrate(client)
        with nfs.batch_upload() as b:
            b.put_data(b"legacy data", "f.txt")
        state = sup.state.volumes[nfs.object_id]
        return [f.path for f in nfs.listdir("/")], state.name, state.version, b"".join(nfs.read_file("f.txt"))

    got = planes.both(scenario)
    assert got["port"] == got["jax"] == (["f.txt"], "nfs:shared", modal_tpu_torch.proto.api_pb2.VOLUME_FS_VERSION_V1,
                                         b"legacy data")


def test_a_cloud_bucket_mount_is_validated_and_serialized_as_jax_s():
    from modal_tpu.cloud_bucket_mount import CloudBucketMount as J
    from modal_tpu_torch.cloud_bucket_mount import CloudBucketMount as T

    kw = dict(bucket_endpoint_url="http://e", key_prefix="p/", read_only=True)
    assert T("bucket", **kw).serialize() == J("bucket", **kw).serialize()
    with pytest.raises(ValueError, match="end with"):
        T("bucket", key_prefix="nope")
    with pytest.raises(ValueError, match="requester_pays"):
        T("bucket", requester_pays=True)


def test_a_signed_request_carries_jax_s_signature(monkeypatch):
    """The same credentials, clock and request give the same SigV4 headers."""
    import datetime

    from modal_tpu._utils import s3 as js3
    from modal_tpu_torch._utils import s3 as ts3

    class _Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return datetime.datetime(2026, 1, 2, 3, 4, 5, tzinfo=tz)

    for mod in (js3, ts3):
        monkeypatch.setattr(mod.datetime, "datetime", _Clock)
    args = dict(bucket="b", endpoint_url="http://127.0.0.1:9", region="eu-west-1", access_key="AK", secret_key="SK",
                session_token="TOK")
    url = "http://127.0.0.1:9/b/some%20key?list-type=2&prefix=a"
    got = ts3._sigv4_headers(ts3.S3Config(**args), "GET", url, ts3.EMPTY_SHA256)
    want = js3._sigv4_headers(js3.S3Config(**args), "GET", url, js3.EMPTY_SHA256)
    assert got == want and got["authorization"].startswith("AWS4-HMAC-SHA256 Credential=AK/20260102/eu-west-1/s3/")


def test_a_bucket_is_synced_in_and_written_back(planes, s3, tmp_path):
    """The container reads the seeded objects at its mount path and what it
    writes there lands in the bucket at its exit."""
    store, url = s3

    def scenario(m, client, sup):
        bucket = f"weights-{m.__name__}"
        store[bucket] = {"ckpt/model.bin": b"fake-weights-bytes", "ckpt/config.json": b"{}"}
        app = m.App("bucket-e2e")
        mnt = str(tmp_path / f"mnt-{m.__name__}")

        def use_bucket():
            import os

            with open(f"{mnt}/model.bin", "rb") as f:
                data = f.read()
            with open(f"{mnt}/output.txt", "w") as f:
                f.write("produced-by-container")
            return len(data), sorted(os.listdir(mnt))

        mount = m.CloudBucketMount(bucket, bucket_endpoint_url=url, key_prefix="ckpt/")
        f = app.function(serialized=True, volumes={mnt: mount}, scaledown_window=2)(use_bucket)
        with app.run(client=client):
            out = f.remote()
        deadline = time.monotonic() + 30
        while "ckpt/output.txt" not in store[bucket] and time.monotonic() < deadline:
            time.sleep(0.2)
        return out, sorted(store[bucket].items())

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0] == (18, ["config.json", "model.bin", "output.txt"])
    assert ("ckpt/output.txt", b"produced-by-container") in got["port"][1]


def test_a_read_only_bucket_is_never_written_back(planes, s3, tmp_path):
    store, url = s3

    def scenario(m, client, sup):
        bucket = f"ro-{m.__name__}"
        store[bucket] = {"data.txt": b"readable"}
        app = m.App("bucket-ro")
        mnt = str(tmp_path / f"ro-{m.__name__}")

        def peek():
            open(f"{mnt}/extra.txt", "w").write("should not upload")
            return open(f"{mnt}/data.txt").read()

        mount = m.CloudBucketMount(bucket, bucket_endpoint_url=url, read_only=True)
        f = app.function(serialized=True, volumes={mnt: mount}, scaledown_window=2)(peek)
        with app.run(client=client):
            out = f.remote()
            from tests.test_torch_app import _wait_tasks_finished

            _wait_tasks_finished(sup, app.app_id)
        return out, sorted(store[bucket])

    got = planes.both(scenario)
    assert got["port"] == got["jax"] == ("readable", ["data.txt"])
