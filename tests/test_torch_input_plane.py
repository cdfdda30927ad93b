"""The input plane (server/input_plane.py) and its client half in both
packages: AttemptStart/Await/Retry and MapStartOrContinue/MapAwait on a
JWT-checked gRPC server of their own.

The JAX package's tests/test_input_plane.py, each case run against a JAX
`LocalSupervisor` and the port's (`worker_gpu_type="local-sim"`, one plane
per package for the module), each driven by its own package's client after
its hello, so `.remote()` and `.map()` take the input plane. Then the same
user function gives the same results through both input planes, the port
gives the same results with MODAL_TPU_DISABLE_INPUT_PLANE=1 through its
control plane, and the port's input plane keeps its port and socket across
a crash_restart, where an awaited attempt resumes.

Reference: _InputPlaneInvocation (py/modal/_functions.py:394), the map
variant (py/modal/parallel_map.py:620), token refresh-ahead
(py/modal/_utils/auth_token_manager.py:14).
"""

from __future__ import annotations

import asyncio
import importlib
import os
import tempfile
import time

import grpc
import pytest

import modal_tpu
import modal_tpu_torch

CONTAINER_ENV = {"MODAL_TPU_HEARTBEAT_INTERVAL": "3"}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class _Plane:
    """One package's plane and its client, after the client's hello."""

    def __init__(self, m):
        self.m = m
        self.pkg = m.__name__
        sup_cls = _mod(self.pkg, "server.supervisor").LocalSupervisor
        state = tempfile.mkdtemp(prefix=f"ip-{self.pkg}-", dir="/tmp")
        if m is modal_tpu:
            self.sup = sup_cls(num_workers=1, state_dir=state, worker_chips=8, worker_tpu_type="local-sim")
        else:
            self.sup = sup_cls(num_workers=1, state_dir=state, worker_gpus=8, worker_gpu_type="local-sim")
        self.sync = _mod(self.pkg, "_utils.async_utils").synchronizer
        self.sync.run(self.sup.start())
        self.client = _mod(self.pkg, "client")._Client(self.sup.server_url)
        self.client._open()
        self.client.hello()
        assert self.client.input_plane_url == self.sup.state.input_plane_url != ""

    @property
    def counts(self) -> dict:
        return dict(self.sup.input_plane.servicer.rpc_counts)

    def close(self):
        self.client._close()
        self.sync.run(self.sup.stop())


@pytest.fixture(scope="module")
def planes():
    saved = {k: os.environ.get(k) for k in CONTAINER_ENV}
    os.environ.update(CONTAINER_ENV)
    made = {}
    try:
        for m in (modal_tpu, modal_tpu_torch):
            made[m.__name__] = _Plane(m)
        yield made
    finally:
        for p in made.values():
            p.close()
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)


@pytest.fixture(params=["modal_tpu", "modal_tpu_torch"], ids=["jax", "port"])
def plane(request, planes):
    return planes[request.param]


def _make_app(m, name="ip-test"):
    app = m.App(name)

    def double(x: int) -> int:
        return x * 2

    return app, app.function(serialized=True)(double)


def _delta(after: dict, before: dict, name: str) -> int:
    return after.get(name, 0) - before.get(name, 0)


def test_remote_routes_through_input_plane(plane):
    app, double = _make_app(plane.m)
    before = plane.counts
    with app.run(client=plane.client):
        assert double.remote(21) == 42
    after = plane.counts
    assert _delta(after, before, "AttemptStart") + _delta(after, before, "AttemptStartBatch") >= 1
    assert _delta(after, before, "AttemptAwait") >= 1


def test_map_routes_through_input_plane(plane):
    app, double = _make_app(plane.m)
    before = plane.counts
    with app.run(client=plane.client):
        assert list(double.map(range(10))) == [x * 2 for x in range(10)]
    after = plane.counts
    assert _delta(after, before, "MapStartOrContinue") >= 2  # the call and a batch
    assert _delta(after, before, "MapAwait") >= 1


def test_input_plane_disable_env(plane, monkeypatch):
    """MODAL_TPU_DISABLE_INPUT_PLANE=1 pins the control plane's path."""
    monkeypatch.setenv("MODAL_TPU_DISABLE_INPUT_PLANE", "1")
    app, double = _make_app(plane.m)
    before = plane.counts
    with app.run(client=plane.client):
        assert double.remote(5) == 10
        assert list(double.map(range(3))) == [0, 2, 4]
    assert plane.counts == before


def test_input_plane_requires_auth(plane):
    """An RPC with no JWT, or a forged one, is UNAUTHENTICATED."""
    create_channel = _mod(plane.pkg, "_utils.grpc_utils").create_channel
    api_pb2 = _mod(plane.pkg, "proto.api_pb2")
    ModalTPUStub = _mod(plane.pkg, "proto.rpc").ModalTPUStub
    url = plane.sup.state.input_plane_url

    async def call(metadata):
        channel = create_channel(url)
        try:
            await ModalTPUStub(channel).AttemptStart(api_pb2.AttemptStartRequest(function_id="fu-x"),
                                                     metadata=metadata)
        finally:
            await channel.close()

    failures = plane.sup.input_plane.servicer.auth_failures
    for metadata in (None, [("x-modal-tpu-auth-token", "aaa.bbb.ccc")]):
        with pytest.raises(grpc.aio.AioRpcError) as exc_info:
            plane.sync.run(call(metadata))
        assert exc_info.value.code() == grpc.StatusCode.UNAUTHENTICATED
    assert plane.sup.input_plane.servicer.auth_failures == failures + 2


def test_attempt_retry_user_policy(plane, tmp_path):
    """A function that fails until its third attempt succeeds through
    AttemptRetry under the user's retry policy."""
    m = plane.m
    app = m.App("ip-retry")
    marker = str(tmp_path / "attempts.txt")

    def flaky(marker_path: str) -> int:
        import os

        n = 1
        if os.path.exists(marker_path):
            n = int(open(marker_path).read()) + 1
        with open(marker_path, "w") as f:
            f.write(str(n))
        if n < 3:
            raise RuntimeError(f"attempt {n} fails")
        return n

    f = app.function(serialized=True, retries=m.Retries(max_retries=3, initial_delay=0.1))(flaky)
    before = plane.counts
    with app.run(client=plane.client):
        assert f.remote(marker) == 3
    assert _delta(plane.counts, before, "AttemptRetry") >= 2


def test_map_retry_through_input_plane(plane, tmp_path):
    """A map's failed attempt is submitted again with its attempt token."""
    m = plane.m
    app = m.App("ip-map-retry")
    marker_dir = str(tmp_path)

    def flaky_item(x: int, marker_dir: str) -> int:
        import os

        p = os.path.join(marker_dir, f"m{x}.txt")
        n = int(open(p).read()) + 1 if os.path.exists(p) else 1
        with open(p, "w") as f:
            f.write(str(n))
        if x == 2 and n < 2:
            raise RuntimeError("first attempt of item 2 fails")
        return x * 10

    f = app.function(serialized=True, retries=m.Retries(max_retries=2, initial_delay=0.1))(flaky_item)
    with app.run(client=plane.client):
        assert list(f.map(range(4), kwargs={"marker_dir": marker_dir})) == [0, 10, 20, 30]


def test_map_retry_keeps_done_count_truthful(plane, tmp_path):
    """A map's re-submission takes its input out of num_done before the
    retry runs: num_unfinished_inputs never goes negative."""
    m = plane.m
    app = m.App("ip-count")
    marker = str(tmp_path / "m.txt")

    def once_flaky(x: int, marker_path: str) -> int:
        import os

        if x == 1 and not os.path.exists(marker_path):
            with open(marker_path, "w") as f:
                f.write("1")
            raise RuntimeError("first attempt fails")
        return x

    f = app.function(serialized=True, retries=m.Retries(max_retries=2, initial_delay=0.1))(once_flaky)
    with app.run(client=plane.client):
        assert sorted(f.map(range(3), kwargs={"marker_path": marker})) == [0, 1, 2]
    for call in plane.sup.state.function_calls.values():
        assert call.num_done <= call.num_inputs, (call.function_call_id, call.num_done, call.num_inputs)


@pytest.mark.parametrize("pkg", ["modal_tpu", "modal_tpu_torch"], ids=["jax", "port"])
def test_auth_token_manager_states(pkg):
    """The three states of a cached token (reference
    auth_token_manager.py:28): valid (no fetch), expired (fetch), and one
    fetch for concurrent first callers."""
    atm = _mod(pkg, "_utils.auth_token_manager")
    encode_jwt = _mod(pkg, "_utils.jwt_utils").encode_jwt
    api_pb2 = _mod(pkg, "proto.api_pb2")
    calls = []

    class FakeStub:
        def __init__(self, ttl):
            self.ttl = ttl

        async def AuthTokenGet(self, request):
            calls.append(time.time())
            return api_pb2.AuthTokenGetResponse(token=encode_jwt({}, b"k", ttl_s=self.ttl))

    async def scenario():
        mgr = atm.AuthTokenManager(FakeStub(3600))
        assert await mgr.get_token() == await mgr.get_token() and len(calls) == 1
        mgr2 = atm.AuthTokenManager(FakeStub(-10))
        await mgr2.get_token()
        await mgr2.get_token()
        assert len(calls) == 3
        calls.clear()
        mgr3 = atm.AuthTokenManager(FakeStub(3600))
        await asyncio.gather(*[mgr3.get_token() for _ in range(10)])
        assert len(calls) == 1

    _mod(pkg, "_utils.async_utils").synchronizer.run(scenario())


def test_token_expiry_refresh_e2e(plane, monkeypatch):
    """Tokens that expire at once (inside the refresh window) are fetched
    again for every call, and the calls succeed."""
    if plane.m is modal_tpu:
        monkeypatch.setenv("MODAL_TPU_AUTH_TOKEN_TTL", "2")
    else:
        monkeypatch.setattr(_mod(plane.pkg, "server.services"), "AUTH_TOKEN_TTL_S", 2.0)
    app, double = _make_app(plane.m)
    plane.client._auth_token_manager = None
    with app.run(client=plane.client):
        assert double.remote(1) == 2
        assert double.remote(2) == 4


# -- the two packages and the two paths give the same results -----------------


def _scenario(m, client):
    app = m.App("ip-same")

    def work(x: int, y: int = 1) -> dict:
        return {"sum": x + y, "sq": [x * x] * (x % 3), "s": f"{x}:{y}"}

    f = app.function(serialized=True)(work)
    with app.run(client=client):
        return {
            "remote": [f.remote(i, y=i + 1) for i in range(3)],
            "map": list(f.map(range(6), kwargs={"y": 4})),
            "starmap": list(f.starmap([(1, 2), (3, 4)])),
            "unordered": sorted(r["sum"] for r in f.map(range(5), order_outputs=False)),
        }


def test_the_same_function_gives_the_same_results_through_both_input_planes(planes):
    before = {k: p.counts for k, p in planes.items()}
    got = {k: _scenario(p.m, p.client) for k, p in planes.items()}
    assert got["modal_tpu_torch"] == got["modal_tpu"]
    for k, p in planes.items():
        after = p.counts
        assert _delta(after, before[k], "AttemptAwait") >= 3 and _delta(after, before[k], "MapAwait") >= 3, k


def test_the_port_gives_the_same_results_with_the_input_plane_off(planes, monkeypatch):
    port = planes["modal_tpu_torch"]
    on = _scenario(port.m, port.client)
    monkeypatch.setenv("MODAL_TPU_DISABLE_INPUT_PLANE", "1")
    before = port.counts
    off = _scenario(port.m, port.client)
    assert off == on and port.counts == before


def test_the_input_plane_keeps_its_port_and_resumes_an_attempt_across_crash_restart(monkeypatch):
    """The port's input plane binds the same TCP port and socket after a
    crash_restart, its JWT secret survives, and an attempt token awaited
    across the restart resolves (its `attempt` record replayed)."""
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.client import _Client
    from modal_tpu_torch.proto import api_pb2
    from modal_tpu_torch.server.supervisor import LocalSupervisor

    sup = LocalSupervisor(num_workers=1, state_dir=tempfile.mkdtemp(prefix="ip-crash-", dir="/tmp"),
                          worker_gpus=1, worker_gpu_type="local-sim")
    synchronizer.run(sup.start())
    client = _Client(sup.server_url)
    client._open()
    client.hello()
    try:
        url, uds = sup.state.input_plane_url, sup.state.input_plane_uds
        assert uds.endswith("input_plane.sock") and os.path.exists(uds)
        app, double = _make_app(modal_tpu_torch, "ip-crash")
        with app.run(client=client):
            assert double.remote(3) == 6
            (token,) = [t for t, (cid, _i, _ts) in sup.state.attempts.items()
                        if sup.state.function_calls[cid].function_id == double.object_id]
            report = synchronizer.run(sup.crash_restart())
            assert (sup.state.input_plane_url, sup.state.input_plane_uds) == (url, uds)
            assert token in sup.state.attempts and report["records_skipped"] == 0

            async def await_attempt():
                stub = await client.get_stub(url)
                md = await client.get_input_plane_metadata()
                return await stub.AttemptAwait(api_pb2.AttemptAwaitRequest(attempt_token=token, timeout=5.0),
                                               metadata=md)

            resp = synchronizer.run(await_attempt())
            assert resp.HasField("output") and resp.output.result.status == api_pb2.GENERIC_STATUS_SUCCESS
            assert double.remote(4) == 8
    finally:
        client._close()
        synchronizer.run(sup.stop())


@pytest.mark.parametrize("coalesce", ["1", "0"])
def test_concurrent_remotes_coalesce_into_attempt_start_batch(plane, coalesce, monkeypatch):
    """Sixteen concurrent `.remote()`s share AttemptStartBatch RPCs on the
    input plane; MODAL_TPU_DISPATCH_COALESCE=0 sends one AttemptStart each
    (JAX tests/test_dispatch.py's two input-plane cases)."""
    monkeypatch.setenv("MODAL_TPU_DISPATCH_COALESCE", coalesce)
    app, double = _make_app(plane.m, f"ip-coalesce-{coalesce}")
    with app.run(client=plane.client):
        double.remote(0)  # the container is up
        before = plane.counts

        async def wave():
            return await asyncio.gather(*(double.remote.aio(i) for i in range(16)))

        assert plane.sync.run(wave()) == [2 * i for i in range(16)]
    after = plane.counts
    if coalesce == "1":
        assert _delta(after, before, "AttemptStartBatch") >= 1
        assert _delta(after, before, "AttemptStartBatch") + _delta(after, before, "AttemptStart") < 16
    else:
        assert (_delta(after, before, "AttemptStartBatch"), _delta(after, before, "AttemptStart")) == (0, 16)


def test_an_input_plane_map_across_crash_restart_delivers_every_index_once():
    """chaos `supervisor_crash` mid-map with an in-process client on the
    input plane: the stopped input plane wakes the MapAwait parked on the
    abandoned state, and the client's next poll reaches the rebuilt plane,
    well inside one poll window."""
    from modal_tpu_torch import chaos as tchaos
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch._utils.function_utils import OUTPUTS_TIMEOUT
    from modal_tpu_torch.client import _Client
    from modal_tpu_torch.server.supervisor import LocalSupervisor

    policy = tchaos.ChaosPolicy(seed=0, events=[tchaos.ChaosEvent(kind="supervisor_crash", after_outputs=3)])
    sup = LocalSupervisor(num_workers=1, state_dir=tempfile.mkdtemp(prefix="ip-map-crash-", dir="/tmp"),
                          worker_gpus=8, worker_gpu_type="local-sim", chaos=policy)
    synchronizer.run(sup.start())
    client = _Client(sup.server_url)
    client._open()
    client.hello()
    try:
        app = modal_tpu_torch.App("ip-map-crash")

        def square(x):
            import time as _t

            _t.sleep(0.3)
            return x * x

        f = app.function(serialized=True, max_containers=1)(square)
        t0 = time.monotonic()
        with app.run(client=client):
            assert list(f.map(range(8))) == [x * x for x in range(8)]
        assert policy.events[0].fired and sup.recovery_report is not None
        assert time.monotonic() - t0 < OUTPUTS_TIMEOUT
        assert sup.input_plane.servicer.rpc_counts.get("MapAwait", 0) >= 1  # the rebuilt plane served the rest
    finally:
        client._close()
        synchronizer.run(sup.stop())
