"""Partitioned ids and shard routing in both packages: `make_id`,
`partition_of_id` and `bump_id_counter` (server/state.py),
`partition_for_name` and `partition_for_request`
(_utils/shard_routing.py), the chaos policy's shard knobs, and the
client's `ShardRouterStub` (_utils/shard_router.py). The JAX package's
routing units of tests/test_shards.py run against both packages; then the
two agree exactly on seeded names, requests and ids, and partition 0 mints
the ids it always did."""

from __future__ import annotations

import asyncio
import importlib

import grpc
import pytest

PACKAGES = ("modal_tpu", "modal_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(params=PACKAGES, ids=["jax", "port"])
def pkg(request):
    return request.param


def test_partition_embedded_ids_roundtrip(pkg):
    server_state = _mod(pkg, "server.state")
    for namespace in (0, 1, 2, 7):
        obj_id = server_state.make_id("fu", namespace=namespace)
        assert server_state.partition_of_id(obj_id) == namespace
    # partition 0's ids keep the unsharded shape: a monolith's journal
    # replays into shard 0 unchanged
    assert server_state.partition_of_id("fu-00000012") == 0
    assert server_state.partition_of_id("not-an-id") is None
    assert server_state.partition_of_id("") is None


def test_partition_for_request_id_fields_win(pkg):
    routing = _mod(pkg, "_utils.shard_routing")
    api_pb2 = _mod(pkg, "proto.api_pb2")
    stride = _mod(pkg, "server.state").PARTITION_STRIDE

    fn_id = f"fu-{2 * stride + 7:08d}"
    req = api_pb2.FunctionPutInputsRequest(function_id=fn_id)
    assert routing.partition_for_request(req, 3) == 2
    named = api_pb2.AppCreateRequest(description="route-me")
    assert routing.partition_for_request(named, 3) == routing.partition_for_name("route-me", 3)
    both = api_pb2.FunctionCreateRequest(app_id=f"ap-{1 * stride + 3:08d}")
    both.function.function_name = "shadowed"
    assert routing.partition_for_request(both, 3) == 1
    wide = api_pb2.FunctionPutInputsRequest(function_id=f"fu-{7 * stride + 1:08d}")
    assert routing.partition_for_request(wide, 3) == 7 % 3
    assert routing.partition_for_request(api_pb2.ClientHelloRequest(), 3) is None
    assert routing.partition_for_request(req, 1) == 0


def test_chaos_shard_knobs_parse(pkg, monkeypatch):
    ChaosPolicy = _mod(pkg, "chaos").ChaosPolicy
    monkeypatch.setenv("MODAL_TPU_CHAOS", "1")
    monkeypatch.setenv("MODAL_TPU_CHAOS_SHARD_KILL_AFTER", "1:50,2:200")
    monkeypatch.setenv("MODAL_TPU_CHAOS_SHARD_PARTITION", "2:100:5.5")
    policy = ChaosPolicy.from_env()
    kills = [e for e in policy.events if e.kind == "shard_kill"]
    parts = [e for e in policy.events if e.kind == "shard_partition"]
    assert [(e.shard_index, e.after_outputs) for e in kills] == [(1, 50), (2, 200)]
    assert [(e.shard_index, e.after_outputs, e.duration_s) for e in parts] == [(2, 100, 5.5)]


def test_chaos_shard_knobs_off_by_default(pkg, monkeypatch):
    ChaosPolicy = _mod(pkg, "chaos").ChaosPolicy
    monkeypatch.delenv("MODAL_TPU_CHAOS", raising=False)
    monkeypatch.setenv("MODAL_TPU_CHAOS_SHARD_KILL_AFTER", "1:50")
    assert ChaosPolicy.from_env() is None
    monkeypatch.setenv("MODAL_TPU_CHAOS", "1")
    monkeypatch.delenv("MODAL_TPU_CHAOS_SHARD_KILL_AFTER", raising=False)
    monkeypatch.setenv("MODAL_TPU_CHAOS_SHARD_PARTITION", "")
    policy = ChaosPolicy.from_env()
    assert policy is not None and [e for e in policy.events if e.kind.startswith("shard_")] == []


def test_chaos_shard_knobs_malformed_tokens_ignored(pkg, monkeypatch):
    ChaosPolicy = _mod(pkg, "chaos").ChaosPolicy
    monkeypatch.setenv("MODAL_TPU_CHAOS", "1")
    monkeypatch.setenv("MODAL_TPU_CHAOS_SHARD_KILL_AFTER", "nope:x,1:25")
    monkeypatch.setenv("MODAL_TPU_CHAOS_SHARD_PARTITION", ":::")
    policy = ChaosPolicy.from_env()  # a typo'd knob does not stop the boot
    kills = [e for e in policy.events if e.kind == "shard_kill"]
    assert [(e.shard_index, e.after_outputs) for e in kills] == [(1, 25)]
    assert [e for e in policy.events if e.kind == "shard_partition"] == []
    monkeypatch.setenv("MODAL_TPU_CHAOS_SHARD_KILL_AFTER", "40")
    monkeypatch.setenv("MODAL_TPU_CHAOS_SHARD_PARTITION", "")
    (ev,) = [e for e in ChaosPolicy.from_env().events if e.kind == "shard_kill"]
    assert (ev.shard_index, ev.after_outputs) == (1, 40)


def test_bump_id_counter_is_namespace_aware(pkg):
    """Replaying a partition's ids moves that partition's counter only, and
    never backwards."""
    server_state = _mod(pkg, "server.state")
    stride = server_state.PARTITION_STRIDE
    prefix = f"zz{pkg[-5:]}"
    server_state.bump_id_counter(f"{prefix}-{2 * stride + 40:08d}")
    assert server_state.make_id(prefix, namespace=2) == f"{prefix}-{2 * stride + 41:08d}"
    server_state.bump_id_counter(f"{prefix}-{2 * stride + 5:08d}")  # behind: no move
    assert server_state.make_id(prefix, namespace=2) == f"{prefix}-{2 * stride + 42:08d}"
    assert server_state.make_id(prefix, namespace=0) == f"{prefix}-00000001"
    server_state.bump_id_counter("blob-sha256hash")  # not an id: ignored
    assert server_state.make_id(prefix, namespace=1) == f"{prefix}-{stride + 1:08d}"


# -- the two packages agree exactly ---------------------------------------------


def _names(seed: int, n: int) -> list[str]:
    import numpy as np

    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghijklmnopqrstuvwxyz0123456789-_.é")
    return ["".join(rng.choice(alphabet, size=int(rng.integers(1, 40)))) for _ in range(n)]


@pytest.mark.parametrize("partitions", [1, 2, 3, 5, 16])
def test_partition_for_name_agrees_on_seeded_names(partitions):
    j = _mod("modal_tpu", "_utils.shard_routing")
    t = _mod("modal_tpu_torch", "_utils.shard_routing")
    names = _names(partitions, 500)
    assert [t.partition_for_name(n, partitions) for n in names] == [j.partition_for_name(n, partitions) for n in names]


def _requests(pkg: str, seed: int) -> list:
    """Seeded requests of every id field and name field the router reads."""
    import numpy as np

    api_pb2 = _mod(pkg, "proto.api_pb2")
    routing = _mod(pkg, "_utils.shard_routing")
    stride = _mod(pkg, "server.state").PARTITION_STRIDE
    rng = np.random.default_rng(seed)
    names = _names(seed + 1, 200)
    out = []
    for name in sorted(api_pb2.DESCRIPTOR.message_types_by_name):
        if not name.endswith("Request"):
            continue
        cls = getattr(api_pb2, name)
        fields = {f.name: f for f in cls.DESCRIPTOR.fields}
        for field in routing.ID_FIELDS + routing.NAME_FIELDS:
            f = fields.get(field)
            if f is None or f.type != f.TYPE_STRING or f.is_repeated:
                continue
            if field in routing.ID_FIELDS:
                value = f"xx-{int(rng.integers(0, 9)) * stride + int(rng.integers(1, 10**6)):08d}"
            else:
                value = names[int(rng.integers(0, len(names)))]
            out.append(cls(**{field: value}))
        out.append(cls())
    return out


@pytest.mark.parametrize("partitions", [1, 3, 4])
def test_partition_for_request_agrees_on_seeded_requests(partitions):
    j = _mod("modal_tpu", "_utils.shard_routing")
    t = _mod("modal_tpu_torch", "_utils.shard_routing")
    jreqs, treqs = _requests("modal_tpu", 7), _requests("modal_tpu_torch", 7)
    assert len(jreqs) == len(treqs) > 100
    assert [t.partition_for_request(r, partitions) for r in treqs] == [
        j.partition_for_request(r, partitions) for r in jreqs
    ]
    assert (j.ID_FIELDS, j.NAME_FIELDS) == (t.ID_FIELDS, t.NAME_FIELDS)


def test_make_id_and_partition_of_id_agree(tmp_path):
    """The same sequence of mints gives the same ids, and the same ids the
    same partitions; partition 0's ids are the 8-digit ids of an unsharded
    plane."""
    import numpy as np

    js, ts = _mod("modal_tpu", "server.state"), _mod("modal_tpu_torch", "server.state")
    assert js.PARTITION_STRIDE == ts.PARTITION_STRIDE == 10**8
    rng = np.random.default_rng(3)
    seq = [(f"q{int(p)}", int(n)) for p, n in zip(rng.integers(0, 4, 300), rng.integers(0, 5, 300))]
    jids = [js.make_id(p, namespace=n) for p, n in seq]
    tids = [ts.make_id(p, namespace=n) for p, n in seq]
    assert tids == jids
    assert [ts.partition_of_id(i) for i in tids] == [js.partition_of_id(i) for i in jids] == [n for _, n in seq]
    fresh = [ts.make_id("p0fresh") for _ in range(3)]
    assert fresh == ["p0fresh-00000001", "p0fresh-00000002", "p0fresh-00000003"]
    assert ts.ServerState(str(tmp_path), shard_index=0).make_id("p0fresh") == "p0fresh-00000004"


def test_a_partition_zero_journal_replays_into_the_same_ids(tmp_path):
    """A journal a monolith wrote (partition 0) replays into shard 0 of the
    port with its ids intact, and the counters move past them, so the next
    mint continues the sequence."""
    from modal_tpu_torch.server.journal import IdempotencyCache, Journal, recover_state
    from modal_tpu_torch.server.state import ServerState, make_id

    j = Journal(str(tmp_path))
    j.append("app", app_id="ap-00000417", description="p0", name="")
    j.close()
    state = ServerState(str(tmp_path / "replay"), shard_index=0)
    state.idempotency = IdempotencyCache(journal=None)
    recover_state(state, Journal(str(tmp_path)))
    assert list(state.apps) == ["ap-00000417"]
    assert int(state.make_id("ap").split("-")[1]) > 417 and len(make_id("ap").split("-")[1]) == 8


# -- the client's router ------------------------------------------------------


class _FakeStub:
    def __init__(self, name: str, log: list, fail: bool = False):
        self.name, self.log, self.fail = name, log, fail

    def __getattr__(self, rpc):
        async def call(request, timeout=None, metadata=None, **kw):
            self.log.append((self.name, rpc))
            if self.fail:
                from modal_tpu_torch._utils.local_transport import local_rpc_error

                raise local_rpc_error(grpc.StatusCode.UNAVAILABLE, "dead shard")
            return self.name

        return call


def test_the_router_dials_the_owner_and_refreshes_after_a_dead_shard():
    """A routable unary RPC goes to its partition's owner; streams and
    unroutable RPCs go to the director; UNAVAILABLE from an owner refreshes
    the map at the director and retries once on the new owner; a stale map
    never rolls routing back."""
    import json

    from modal_tpu_torch._utils.shard_router import ShardRouterStub
    from modal_tpu_torch.proto import api_pb2
    from modal_tpu_torch.server.state import PARTITION_STRIDE

    log: list = []
    shards = {"s0": _FakeStub("s0", log), "s1": _FakeStub("s1", log, fail=True), "s2": _FakeStub("s2", log)}
    new_map = {"epoch": 2, "urls": ["s0", "s2", "s2"]}

    class _Director(_FakeStub):
        async def ClientHello(self, request, timeout=None, metadata=None, **kw):
            log.append(("director", "ClientHello"))
            return api_pb2.ClientHelloResponse(shard_map_json=json.dumps(new_map))

    class _Client:
        async def get_stub(self, url):
            return shards[url]

    router = ShardRouterStub(_Client(), _Director("director", log), {"epoch": 1, "urls": ["s0", "s1", "s2"]})

    async def run():
        out = [await router.FunctionMap(api_pb2.FunctionMapRequest(function_id=f"fu-{2 * PARTITION_STRIDE + 1:08d}"))]
        out.append(await router.ClientHello(api_pb2.ClientHelloRequest()))
        out.append(await router.FunctionMap(api_pb2.FunctionMapRequest(function_id=f"fu-{PARTITION_STRIDE + 1:08d}")))
        return out

    got = asyncio.run(run())
    assert got[0] == "s2" and got[2] == "s2"
    assert log == [("s2", "FunctionMap"), ("director", "ClientHello"), ("s1", "FunctionMap"),
                   ("director", "ClientHello"), ("s2", "FunctionMap")]
    assert router.epoch == 2 and router.shard_urls == ["s0", "s2", "s2"]
    router.update_map({"epoch": 1, "urls": ["s1", "s1", "s1"]})
    assert router.shard_urls == ["s0", "s2", "s2"]
    assert asyncio.run(router.FunctionStreamOutputs(api_pb2.FunctionGetOutputsRequest(
        function_call_id=f"fc-{2 * PARTITION_STRIDE + 1:08d}"))) == "director"
    assert log[-1] == ("director", "FunctionStreamOutputs")


def test_monolith_hello_has_no_shard_map(tmp_path):
    """A LocalSupervisor (one shard) sends no shard map: the client keeps its
    fast-path stub."""
    import tempfile

    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.client import _Client
    from modal_tpu_torch.server.supervisor import LocalSupervisor

    sup = LocalSupervisor(num_workers=0, state_dir=tempfile.mkdtemp(prefix="mono-", dir="/tmp"))
    synchronizer.run(sup.start())
    client = _Client(sup.server_url)
    try:
        client._open()
        client.hello()
        assert type(client._stub).__name__ != "ShardRouterStub"
        assert client.input_plane_url == sup.state.input_plane_url != ""
    finally:
        client._close()
        synchronizer.run(sup.stop())
