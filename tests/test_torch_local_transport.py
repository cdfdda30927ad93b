"""The port's local fast path (`modal_tpu_torch/_utils/local_transport.py`,
the client's `_wrap_fastpath`, the blob handoff by path in
`_utils/blob_utils.py`) on a port `LocalSupervisor`: which rung each call
takes (in process, then the plane's Unix socket, then TCP) under each of the
JAX package's settings, the rungs a container's RPCs take, a blob handed
over by path byte-equal to one fetched over HTTP both ways, and the falls to
TCP and HTTP when a path is not there for this process. State dirs live
under /tmp so the socket path stays under the ~107-byte cap; every call is
bounded by its own timeout."""

import asyncio
import os
import shutil
import tempfile
import time

import pytest

from modal_tpu_torch._utils import async_utils as tasync
from modal_tpu_torch._utils import blob_utils, local_transport
from modal_tpu_torch._utils.grpc_utils import retry_transient_errors
from modal_tpu_torch.client import _Client
from modal_tpu_torch.proto import api_pb2
from modal_tpu_torch.proto.rpc import ModalTPUStub
from modal_tpu_torch.serialization import deserialize, serialize
from modal_tpu_torch.server.supervisor import LocalSupervisor

FASTPATH_ENV = ("MODAL_TPU_FASTPATH", "MODAL_TPU_FASTPATH_INPROC", "MODAL_TPU_FASTPATH_UDS",
                "MODAL_TPU_FASTPATH_BLOB", "MODAL_TPU_SERVER_UDS", "MODAL_TPU_BLOB_LOCAL_DIR")


def _run(coro, timeout: float = 60.0):
    return tasync.synchronizer.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(scope="module")
def plane():
    saved = {k: os.environ.pop(k, None) for k in FASTPATH_ENV}
    saved["MODAL_TPU_HEARTBEAT_INTERVAL"] = os.environ.get("MODAL_TPU_HEARTBEAT_INTERVAL")
    os.environ["MODAL_TPU_HEARTBEAT_INTERVAL"] = "3"
    root = tempfile.mkdtemp(prefix="fp-", dir="/tmp")
    sup = LocalSupervisor(num_workers=1, state_dir=os.path.join(root, "s"), worker_gpus=1,
                          worker_gpu_type="local-sim")
    _run(sup.start())
    try:
        yield sup
    finally:
        _run(sup.stop())
        shutil.rmtree(root, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture
def fastpath_env(monkeypatch):
    for k in FASTPATH_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _client(sup, hello: bool = True) -> _Client:
    client = _Client(sup.server_url)
    client._open()  # blocking: synchronize_api wrapped the client's coroutines
    if hello:
        client.hello()  # blocking too; bounded by retry_transient_errors' retries
    return client


def _hello_rung(client) -> str:
    """The rung one ClientHello took on this client's stub."""
    stub = client.stub
    rungs = getattr(stub, "rungs", None)
    if rungs is None:
        _run(retry_transient_errors(stub.ClientHello, api_pb2.ClientHelloRequest()))
        return "tcp (plain stub)"
    before = dict(rungs)
    _run(retry_transient_errors(stub.ClientHello, api_pb2.ClientHelloRequest()))
    (taken,) = [k for k in rungs if rungs[k] != before.get(k, 0)]
    return taken.split(":", 1)[1]


@pytest.mark.parametrize("env,rung", [
    ({}, "inproc"),
    ({"MODAL_TPU_FASTPATH_INPROC": "0"}, "uds"),
    ({"MODAL_TPU_FASTPATH_INPROC": "0", "MODAL_TPU_FASTPATH_UDS": "0"}, "tcp"),
    ({"MODAL_TPU_FASTPATH_UDS": "0"}, "inproc"),
    ({"MODAL_TPU_FASTPATH": "0"}, "tcp (plain stub)"),
])
def test_the_ladder_takes_the_first_rung_each_setting_allows(plane, fastpath_env, env, rung):
    for k, v in env.items():
        fastpath_env.setenv(k, v)
    client = _client(plane)
    try:
        assert _hello_rung(client) == rung
        # the same RPC answers alike on every rung
        resp = _run(retry_transient_errors(client.stub.ClientHello, api_pb2.ClientHelloRequest()))
        assert resp.uds_path == plane.uds_path and resp.blob_local_dir == plane.state.blob_dir
        assert os.path.basename(plane.uds_path) == "control.sock"
    finally:
        client._close()


def test_a_path_this_process_cannot_see_stays_on_tcp(plane, fastpath_env, tmp_path):
    fastpath_env.setenv("MODAL_TPU_FASTPATH_INPROC", "0")
    client = _client(plane, hello=False)
    try:
        tcp = ModalTPUStub(client._channel)
        missing = str(tmp_path / "no-such" / "control.sock")
        assert client._wrap_fastpath(plane.server_url, tcp, uds_path=missing) is tcp
        assert client._wrap_fastpath(plane.server_url, tcp, blob_local_dir=str(tmp_path / "no-such")) is tcp
        too_long = "/tmp/" + "d" * 120 + "/control.sock"
        assert not local_transport.usable_uds_path(too_long)
        assert client._wrap_fastpath(plane.server_url, tcp, uds_path=too_long) is tcp
    finally:
        client._close()


def test_a_socket_that_is_gone_falls_to_tcp(plane, fastpath_env, tmp_path):
    """UNAVAILABLE on a socket path that no longer exists breaks the rung
    and re-issues the call on TCP."""
    from modal_tpu_torch.observability.catalog import FASTPATH_FALLBACKS

    fastpath_env.setenv("MODAL_TPU_FASTPATH_INPROC", "0")
    client = _client(plane, hello=False)
    try:
        ghost = tempfile.mktemp(prefix="gone-", suffix=".sock", dir="/tmp")
        open(ghost, "w").close()  # stat-able when the stub is built

        async def wrap():  # grpc.aio channels are made on the loop that uses them
            return client._wrap_fastpath(plane.server_url, ModalTPUStub(client._channel), uds_path=ghost)

        stub = _run(wrap())
        os.unlink(ghost)
        before = FASTPATH_FALLBACKS.value(rung="uds", reason="socket_gone")
        resp = _run(stub.ClientHello(api_pb2.ClientHelloRequest(), timeout=10))
        assert resp.uds_path == plane.uds_path
        assert stub.uds_broken and dict(stub.rungs) == {"ClientHello:tcp": 1}
        assert FASTPATH_FALLBACKS.value(rung="uds", reason="socket_gone") == before + 1
    finally:
        client._close()


@pytest.mark.parametrize("nbytes", [3 * 1024 * 1024, 5 * 1024 * 1024])
def test_a_blob_by_path_equals_the_blob_over_http(plane, fastpath_env, monkeypatch, nbytes):
    """Uploaded by path and fetched over HTTP, and the other way round: the
    same bytes, the same blob ids resolving both ways. Past the spill
    threshold the path read is an mmap view over the store's file."""
    monkeypatch.setattr(blob_utils, "DOWNLOAD_SPILL_BYTES", 4 * 1024 * 1024)
    data = os.urandom(nbytes)
    client = _client(plane)
    try:
        stub = client.stub
        assert blob_utils._blob_local_dir(stub) == plane.state.blob_dir
        by_path = _run(blob_utils.blob_upload(data, stub))
        assert stub.rungs["BlobUpload:blob_local"] == 1
        assert os.path.getsize(os.path.join(plane.state.blob_dir, by_path)) == nbytes
        fastpath_env.setenv("MODAL_TPU_FASTPATH_BLOB", "0")
        assert blob_utils._blob_local_dir(stub) == ""
        over_http = _run(blob_utils.blob_upload(data, stub))
        from_http = _run(blob_utils.blob_download(by_path, stub))
        fastpath_env.delenv("MODAL_TPU_FASTPATH_BLOB")
        from_path = _run(blob_utils.blob_download(over_http, stub))
        assert stub.rungs["BlobDownload:blob_local"] == 1 and stub.rungs["BlobUpload:blob_local"] == 1
        assert bytes(from_http) == bytes(from_path) == data
        assert isinstance(from_path, memoryview) == (nbytes >= 4 * 1024 * 1024)
    finally:
        client._close()


def test_a_blob_dir_this_process_cannot_see_goes_over_http(plane, fastpath_env, tmp_path):
    client = _client(plane)
    try:
        stub = client.stub
        stub._blob_local_dir = str(tmp_path / "elsewhere")  # advertised, but not on this host
        data = os.urandom(3 * 1024 * 1024)
        blob_id = _run(blob_utils.blob_upload(data, stub))
        assert bytes(_run(blob_utils.blob_download(blob_id, stub))) == data
        assert not any(k.endswith(":blob_local") for k in stub.rungs)
    finally:
        client._close()


def test_a_container_takes_the_socket_and_the_path(plane, fastpath_env):
    """A container learns the plane's socket and blob dir from its env: its
    RPCs go over the Unix socket and its large result lands by path; the
    result reads back equal over HTTP."""

    def probe(n):
        import os as _os

        from modal_tpu_torch.client import _Client as _C

        stub = _C._client_from_env.stub
        return {"rungs": dict(stub.rungs), "uds": stub.uds_path, "blob_dir": stub._blob_local_dir,
                "env_uds": _os.environ.get("MODAL_TPU_SERVER_UDS"), "pad": b"\x05" * n}

    client = _client(plane)
    try:
        call = lambda name, req: _run(retry_transient_errors(getattr(client.stub, name), req))  # noqa: E731
        app_id = call("AppCreate", api_pb2.AppCreateRequest(description="fastpath")).app_id
        fdef = api_pb2.Function(function_name="probe", definition_type="serialized", function_serialized=serialize(probe))
        fdef.autoscaler_settings.scaledown_window = 60
        fn_id = call("FunctionCreate", api_pb2.FunctionCreateRequest(app_id=app_id, function=fdef, tag="probe")
                     ).function_id
        size = 3 * 1024 * 1024
        item = api_pb2.FunctionPutInputsItem(idx=0, input=api_pb2.FunctionInput(args=serialize(((size,), {}))))
        call_id = call("FunctionMap", api_pb2.FunctionMapRequest(function_id=fn_id, pipelined_inputs=[item])
                       ).function_call_id
        deadline, outs = time.monotonic() + 90, []
        while not outs:
            assert time.monotonic() < deadline, "no output in 90 s"
            outs = call("FunctionGetOutputs", api_pb2.FunctionGetOutputsRequest(
                function_call_id=call_id, timeout=10, clear_on_success=True)).outputs
        result = outs[0].result
        assert result.status == api_pb2.GENERIC_STATUS_SUCCESS, result.traceback
        blob_file = os.path.join(plane.state.blob_dir, result.data_blob_id)
        assert os.path.exists(blob_file)
        fastpath_env.setenv("MODAL_TPU_FASTPATH_BLOB", "0")
        got = deserialize(_run(blob_utils.resolve_blob_data(result, client.stub)))
        assert got["pad"] == b"\x05" * size
        assert got["uds"] == got["env_uds"] == plane.uds_path and got["blob_dir"] == plane.state.blob_dir
        assert got["rungs"].get("ContainerHello:uds") == 1 and got["rungs"].get("FunctionExchange:uds", 0) >= 1
        assert not [k for k in got["rungs"] if k.endswith(":tcp")], got["rungs"]
        call("AppStop", api_pb2.AppStopRequest(app_id=app_id))
    finally:
        client._close()
