"""The port's SDK client (`modal_tpu_torch/client.py` over its own gRPC
utils, synchronizer and wire contract) against the JAX package's control
plane: the `supervisor` fixture, a real in-process server on localhost
gRPC that runs on the JAX package's synchronizer loop.

The port's client runs on the port's own synchronizer thread; the two meet
only over TCP. It says hello and gets an input-plane token, writes state
that the JAX client reads back (and reads what the JAX client wrote),
survives the fixture's fault knobs through `retry_transient_errors`, opens
and closes its circuit breaker, serves the blocking and `.aio` surfaces
of `synchronize_api`, and its `Resolver` loads an object once under
concurrent loads."""

import asyncio
import socket
import threading
import time

import numpy as np
import pytest

import modal_tpu
from modal_tpu._utils.async_utils import synchronizer as jsync
from modal_tpu._utils.jwt_utils import verify_jwt
from modal_tpu.client import _Client as JClient
from modal_tpu.serialization import deserialize as jdeserialize
from modal_tpu.serialization import serialize as jserialize
from modal_tpu_torch import client as tclient
from modal_tpu_torch import config as tconfig
from modal_tpu_torch import object as tobject
from modal_tpu_torch._utils import async_utils as tasync
from modal_tpu_torch._utils import grpc_utils as tgrpc
from modal_tpu_torch.exception import ConnectionError as TConnectionError
from modal_tpu_torch.exception import NotFoundError
from modal_tpu_torch.proto import api_pb2
from modal_tpu_torch.serialization import deserialize, serialize


@pytest.fixture
def port_client(supervisor):
    """The port's env client, pointed at the fixture's server by the same
    MODAL_TPU_SERVER_URL the JAX client reads; closed on the port's loop."""
    tclient._Client.set_env_client(None)
    client = tclient.Client.from_env()
    try:
        yield client
    finally:
        client._close()  # blocking: synchronize_api wrapped the client's coroutines
        tclient._Client.set_env_client(None)


def _run(coro):
    return tasync.synchronizer.run(coro)


def test_hello_and_an_input_plane_token(supervisor, port_client):
    assert port_client.server_url == f"grpc://127.0.0.1:{supervisor.port}"
    assert port_client.image_builder_version == "2026.07"  # learned at hello()
    md = port_client.get_input_plane_metadata()
    (key, token), = md
    assert key == "x-modal-tpu-auth-token"
    claims = verify_jwt(token, supervisor.state.auth_secret)  # the JAX server signed it
    assert claims is not None and claims["sub"] == "input-plane" and claims["exp"] > time.time()
    assert port_client.get_input_plane_metadata() == md  # cached until refresh-ahead
    # the two SDKs keep their own loop threads
    assert tasync.synchronizer._thread is not jsync._thread
    assert tasync.synchronizer._thread.name == "modal-tpu-torch-synchronizer"


def test_stateful_rpcs_read_back_through_the_jax_client(supervisor, port_client):
    stub = port_client.stub
    created = _run(tgrpc.retry_transient_errors(stub.DictGetOrCreate, api_pb2.DictGetOrCreateRequest(
        deployment_name="port-dict", object_creation_type=api_pb2.OBJECT_CREATION_TYPE_CREATE_IF_MISSING)))
    assert created.dict_id.startswith("di-")
    value = {"ids": np.arange(70000, dtype=np.int64), "scale": (lambda k: lambda x: x * k)(3)}
    _run(tgrpc.retry_transient_errors(stub.DictUpdate, api_pb2.DictUpdateRequest(
        dict_id=created.dict_id,
        updates=[api_pb2.DictEntry(key=serialize("weights"), value=serialize(value)),
                 api_pb2.DictEntry(key=serialize(7), value=serialize("seven"))])))
    # the JAX SDK's public Dict reads what the port wrote (same key bytes)
    jdict = modal_tpu.Dict.from_name("port-dict")
    got = jdict.get("weights")
    assert np.array_equal(got["ids"], value["ids"]) and got["scale"](2) == 6
    assert jdict.get(7) == "seven" and jdict.len() == 2
    # and the port reads what the JAX client wrote
    jdict.put("from-jax", {"t": (1, 2.5)})
    resp = _run(tgrpc.retry_transient_errors(stub.DictGet, api_pb2.DictGetRequest(
        dict_id=created.dict_id, key=jserialize("from-jax"))))
    assert resp.found and deserialize(resp.value) == {"t": (1, 2.5)}
    # an app the port created is the JAX client's to list
    app = _run(tgrpc.retry_transient_errors(stub.AppCreate, api_pb2.AppCreateRequest(description="port-app")))
    jclient = JClient.from_env()  # blocking, on the JAX package's loop

    async def app_list():
        return await jclient.stub.AppList(modal_tpu.proto.api_pb2.AppListRequest())

    apps = jsync.run(app_list())
    assert app.app_id in [a.app_id for a in apps.apps]
    assert jdeserialize(serialize([1, "x"])) == [1, "x"]


def test_retries_survive_the_fault_knobs(supervisor, port_client):
    stub = port_client.stub
    request = api_pb2.FunctionGetOutputsRequest(function_call_id="fc-missing", timeout=0.0)
    supervisor.servicer.fail_get_outputs = 2
    # two injected UNAVAILABLEs are retried; the third attempt reaches the handler
    with pytest.raises(NotFoundError, match="fc-missing"):
        _run(tgrpc.retry_transient_errors(stub.FunctionGetOutputs, request, base_delay=0.01))
    assert supervisor.servicer.fail_get_outputs == 0
    supervisor.servicer.fail_get_outputs = 3
    import grpc

    with pytest.raises(grpc.aio.AioRpcError) as exc:
        _run(tgrpc.retry_transient_errors(stub.FunctionGetOutputs, request, base_delay=0.01, max_retries=1))
    assert exc.value.code() == grpc.StatusCode.UNAVAILABLE
    assert supervisor.servicer.fail_get_outputs == 1
    supervisor.servicer.fail_get_outputs = 0


def test_the_circuit_breaker_opens_and_closes(supervisor, port_client, monkeypatch):
    import grpc

    monkeypatch.setenv("MODAL_TPU_CIRCUIT_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("MODAL_TPU_CIRCUIT_BREAKER_COOLDOWN", "0.3")
    stub = tclient.ModalTPUStub(port_client._channel)  # a fresh breaker scope
    breaker = tgrpc._breaker_for(stub.ClientHello)
    hello = api_pb2.ClientHelloRequest(client_version="0.1.0")
    supervisor.chaos.error_rates["ClientHello"] = 1.0
    try:
        with pytest.raises(grpc.aio.AioRpcError):
            _run(tgrpc.retry_transient_errors(stub.ClientHello, hello, base_delay=0.01, max_retries=2))
    finally:
        supervisor.chaos.error_rates["ClientHello"] = 0.0
    assert breaker.state == "open" and breaker.times_opened >= 1
    t0 = time.monotonic()
    resp = _run(tgrpc.retry_transient_errors(stub.ClientHello, hello))
    assert resp.server_version == "0.1.0"
    assert breaker.state == "closed" and breaker.consecutive_failures == 0
    assert time.monotonic() - t0 <= 1.0  # paused for the cooldown, not longer


class _Counter:
    """An async implementation, wrapped into the blocking + `.aio` surface."""

    def __init__(self):
        self.n = 0

    async def bump(self, by: int = 1) -> int:
        self.n += by
        return self.n

    async def count_up(self, k: int):
        for i in range(k):
            yield i

    async def __aenter__(self):
        self.n += 100
        return self

    async def __aexit__(self, *exc):
        self.n -= 100


Counter = tasync.synchronize_api(_Counter)


def test_synchronize_api_serves_blocking_and_aio():
    c = Counter()
    assert c.bump() == 1 and c.bump(2) == 3
    assert list(c.count_up(3)) == [0, 1, 2]

    async def from_a_foreign_loop():
        assert await c.bump.aio(10) == 13
        assert [i async for i in c.count_up.aio(2)] == [0, 1]
        async with c:
            assert c.n == 113
        return threading.current_thread().name

    assert asyncio.run(from_a_foreign_loop()) == "MainThread"
    with c:
        assert c.n == 113
    assert c.n == 13
    with pytest.raises(RuntimeError, match="aio"):
        tasync.synchronizer.run(_call_blocking_inside_the_loop())


async def _call_blocking_inside_the_loop():
    inner = asyncio.sleep(0)
    try:
        return tasync.synchronizer.run(inner)
    finally:
        inner.close()


class Pool(tobject._Object, type_prefix="di"):
    """A handle whose loader creates an ephemeral Dict on the JAX server."""


def test_resolver_dedups_concurrent_loads(supervisor, port_client):
    calls = []

    async def load(obj, resolver, context, existing_object_id):
        calls.append(obj.local_uuid)
        await asyncio.sleep(0.05)
        resp = await tgrpc.retry_transient_errors(context.client.stub.DictGetOrCreate, api_pb2.DictGetOrCreateRequest(
            object_creation_type=api_pb2.OBJECT_CREATION_TYPE_EPHEMERAL))
        obj._hydrate(resp.dict_id, context.client, None)

    async def dedup_key():
        return "shared-pool"

    async def scenario():
        ctx = tobject.LoadContext(port_client)
        resolver = tobject.Resolver()
        a = Pool._from_loader(load, "Pool(a)")
        b = Pool._from_loader(load, "Pool(b)", deduplication_key=dedup_key)
        c = Pool._from_loader(load, "Pool(c)", deduplication_key=dedup_key)
        got = await asyncio.gather(*[resolver.load(a, ctx) for _ in range(5)])
        await resolver.load(b, ctx)
        await resolver.load(c, ctx)
        return a, b, c, got, resolver

    a, b, c, got, resolver = _run(scenario())
    assert all(g is a for g in got) and a.is_hydrated and a.object_id.startswith("di-")
    assert len(calls) == 2  # a once; b and c share one load by their key
    assert c.object_id == b.object_id != a.object_id and c.client is port_client
    assert {o.object_id for o in resolver.objects} == {a.object_id, b.object_id}


def test_a_refused_default_url_raises_connection_error(monkeypatch):
    """Where the JAX client would boot a LocalSupervisor, the port raises;
    with auto_local_server off it connects lazily, as the JAX client does."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"grpc://127.0.0.1:{port}"  # nothing listens there
    monkeypatch.setitem(tconfig._SETTINGS, "server_url", tconfig._Setting(url))
    monkeypatch.delenv("MODAL_TPU_SERVER_URL", raising=False)
    monkeypatch.setenv("MODAL_TPU_AUTO_LOCAL_SERVER", "1")
    tclient._Client.set_env_client(None)
    with pytest.raises(TConnectionError, match="no control plane listening"):
        tclient.Client.from_env()
    monkeypatch.setenv("MODAL_TPU_AUTO_LOCAL_SERVER", "0")
    client = tclient.Client.from_env()
    try:
        assert client.server_url == url and client.image_builder_version is None
    finally:
        client._close()  # blocking: synchronize_api wrapped the client's coroutines
        tclient._Client.set_env_client(None)


def test_config_reads_env_then_profile_then_default(tmp_path, monkeypatch):
    path = tmp_path / "cfg.toml"
    monkeypatch.setenv("MODAL_TPU_CONFIG_PATH", str(path))
    for key in ("PROFILE", "TOKEN_ID", "AUTO_LOCAL_SERVER"):
        monkeypatch.delenv("MODAL_TPU_" + key, raising=False)
    assert tconfig.config["token_id"] is None and tconfig.config["auto_local_server"] is True
    path.write_text('[other]\ntoken_id = "ak-other"\n\n'
                    '[dev]\nactive = true\ntoken_id = "ak-\\"1\\""\nauto_local_server = false\n')
    assert tconfig.config["token_id"] == 'ak-"1"' and tconfig.config["auto_local_server"] is False
    monkeypatch.setenv("MODAL_TPU_PROFILE", "other")
    assert tconfig.config["token_id"] == "ak-other" and tconfig.config["auto_local_server"] is True
    monkeypatch.setenv("MODAL_TPU_TOKEN_ID", "ak-env")
    monkeypatch.setenv("MODAL_TPU_AUTO_LOCAL_SERVER", "0")
    assert tconfig.config["token_id"] == "ak-env" and tconfig.config["auto_local_server"] is False
