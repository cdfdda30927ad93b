"""The port's coalesced dispatch against the JAX package's, on the CPU: the
`MicroBatcher`, FunctionMapBatch from concurrent `.remote()` calls, the
MODAL_TPU_DISPATCH_COALESCE kill switch, per-item failure inside a batch,
coalesced claims in the container's input loop, `@batched` and
`@concurrent` (the counterparts of tests/test_cls.py::test_cls_batched and
::test_function_concurrent_inputs), and a FunctionMapBatch replayed by its
idempotency key.

Plane-side scenarios run on the module's two planes
(`tests/test_torch_app.Planes`); each package's plane counts the RPCs it
served in its own registry (`modal_tpu_rpc_total{method,code}`)."""

import asyncio
import importlib
import os
import tempfile

import pytest

from modal_tpu._utils import coalescer as jcoalescer
from modal_tpu.observability import catalog as jcatalog
from modal_tpu_torch._utils import coalescer as tcoalescer
from modal_tpu_torch._utils.async_utils import synchronizer as tsync
from modal_tpu_torch.observability import catalog as tcatalog
from modal_tpu_torch.proto import api_pb2
from tests.test_torch_app import CONTAINER_ENV, Planes


@pytest.fixture(scope="module")
def planes():
    saved = {k: os.environ.get(k) for k in CONTAINER_ENV}
    os.environ.update(CONTAINER_ENV)
    p = Planes(tempfile.mkdtemp(prefix="dispatch-", dir="/tmp"))
    try:
        yield p
    finally:
        p.close()
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)


def _mod(m, name: str):
    """Module `name` of package `m` (either package)."""
    return importlib.import_module(f"{m.__name__}.{name}")


def _rpcs(m, method: str) -> float:
    catalog = jcatalog if m.__name__ == "modal_tpu" else tcatalog
    return catalog.RPC_TOTAL.value(method=method, code="ok")


# -- the MicroBatcher ---------------------------------------------------------


def _batcher_run(coalescer, pattern: list) -> dict:
    """Submit `pattern` (a list of waves; each wave's items submitted in one
    tick) through one MicroBatcher whose flush doubles ints, returns a
    ValueError for the item "bad" and raises for a batch holding "boom".
    Returns the flushed batches and each item's outcome."""
    batches = []

    async def flush(items):
        batches.append(list(items))
        await asyncio.sleep(0.01)  # an RPC in flight: later submits pile up
        if "boom" in items:
            raise RuntimeError("flush failed")
        return [ValueError("bad item") if x == "bad" else x * 2 for x in items]

    async def main():
        b = coalescer.MicroBatcher(flush, max_batch=3, label="test")
        tasks = []
        for wave in pattern:
            tasks += [asyncio.ensure_future(b.submit(x)) for x in wave]
            await asyncio.sleep(0)
        outs = []
        for t in tasks:
            try:
                outs.append(await t)
            except Exception as exc:  # noqa: BLE001 — the outcome is compared
                outs.append(f"{type(exc).__name__}: {exc}")
        return outs, b.flushes, b.items_flushed

    outs, flushes, items = asyncio.run(main())
    return {"batches": batches, "outs": outs, "flushes": flushes, "items": items}


@pytest.mark.parametrize("pattern", [
    [[1]],
    [[1, 2, 3, 4, 5]],
    [[1, 2], [3], [4, 5, 6, 7]],
    [[1, "bad", 3], [4]],
    [[1, 2], ["boom", 3], [4]],
], ids=["one", "max_batch", "waves", "per_item_error", "flush_error"])
def test_micro_batcher_conflates_and_propagates_errors_as_jax(pattern):
    """The same submissions give the same batches and outcomes through the
    JAX coalescer and the port's: same-tick submits share a flush (up to
    max_batch), submits during an in-flight flush wait for the next one, a
    returned exception fails its own item, a raised one every item of its
    batch."""
    got = _batcher_run(tcoalescer, pattern)
    assert got == _batcher_run(jcoalescer, pattern)
    assert all(len(b) <= 3 for b in got["batches"]) and got["items"] == sum(len(w) for w in pattern)


def test_batcher_registry_is_per_loop_and_kill_switch(monkeypatch):
    """One MicroBatcher per (event loop, label); MODAL_TPU_DISPATCH_COALESCE
    reads as JAX's does."""
    reg = tcoalescer.BatcherRegistry()

    async def get(label):
        return reg.get(label, lambda xs: xs)

    a1, a2 = asyncio.run(get("A")), asyncio.run(get("A"))
    assert a1 is not a2  # two asyncio.run calls: two loops

    async def same():
        return reg.get("A", lambda xs: xs) is reg.get("A", lambda xs: xs), reg.get("B", lambda xs: xs).label

    assert asyncio.run(same()) == (True, "B")
    for value, want in (("1", True), ("0", False), ("false", False), ("no", False), ("yes", True)):
        monkeypatch.setenv("MODAL_TPU_DISPATCH_COALESCE", value)
        assert tcoalescer.coalescing_enabled() is jcoalescer.coalescing_enabled() is want


# -- the plane ----------------------------------------------------------------


def _concurrent_remotes(m, client, sup, n: int = 8) -> dict:
    app = m.App("coalesce")

    def square(x):
        return x * x

    f = app.function(serialized=True)(square)
    with app.run(client=client):
        f.remote(0)  # the container is up: the timed wave is dispatch only
        before = {name: _rpcs(m, name) for name in ("FunctionMap", "FunctionMapBatch")}
        sync = _mod(m, "_utils.async_utils").synchronizer

        async def wave():
            return await asyncio.gather(*(f.remote.aio(i) for i in range(n)))

        results = sync.run(wave())
        after = {name: _rpcs(m, name) - before[name] for name in before}
    return {"results": list(results), **after}


def test_concurrent_remotes_coalesce_into_function_map_batch(planes):
    """Eight concurrent `.remote()` calls from one loop reach the plane in
    fewer than eight RPCs, FunctionMapBatch among them (a window that
    happens to hold one call sends a plain FunctionMap), on both planes,
    and each caller gets its own result."""
    got = planes.both(_concurrent_remotes)
    for name in ("jax", "port"):
        r = got[name]
        assert r["results"] == [i * i for i in range(8)], (name, r)
        assert r["FunctionMapBatch"] >= 1 and r["FunctionMap"] + r["FunctionMapBatch"] < 8, (name, r)


def test_the_kill_switch_sends_one_function_map_per_call(planes, monkeypatch):
    """MODAL_TPU_DISPATCH_COALESCE=0: every call is its own FunctionMap,
    on both planes."""
    monkeypatch.setenv("MODAL_TPU_DISPATCH_COALESCE", "0")
    got = planes.both(_concurrent_remotes)
    assert got["port"] == got["jax"] == {"results": [i * i for i in range(8)], "FunctionMap": 8,
                                         "FunctionMapBatch": 0}


def test_one_bad_sub_request_fails_only_its_caller(planes):
    """A FunctionMapBatch naming a missing function is refused before
    anything runs (NOT_FOUND); the flush then sends each item alone, so only
    the stale caller fails and the good one's call is created once."""

    def scenario(m, client, sup):
        functions, pb = _mod(m, "functions"), _mod(m, "proto.api_pb2")
        sync = _mod(m, "_utils.async_utils").synchronizer
        app = m.App("bad-sub")

        def echo(x):
            return x

        f = app.function(serialized=True)(echo)
        with app.run(client=client):
            good = pb.FunctionMapRequest(function_id=f.object_id,
                                         function_call_type=pb.FUNCTION_CALL_TYPE_UNARY)
            bad = pb.FunctionMapRequest(function_id="fu-missing", function_call_type=pb.FUNCTION_CALL_TYPE_UNARY)
            calls_before = len(sup.state.function_calls)
            out = sync.run(functions._flush_function_maps(client, [good, bad]))
            created = len(sup.state.function_calls) - calls_before
        return {"good": bool(out[0].function_call_id), "bad": type(out[1]).__name__, "created": created}

    got = planes.both(scenario)
    assert got["port"] == got["jax"] == {"good": True, "bad": "NotFoundError", "created": 1}


def test_a_function_map_batch_replays_by_its_idempotency_key(planes):
    """The same FunctionMapBatch sent twice under one idempotency key
    answers the same call ids and creates its calls once (the journal's
    idempotency cache, IDEMPOTENT_RPCS)."""
    import modal_tpu_torch

    client, sup = planes.tclient, planes.tsup
    app = modal_tpu_torch.App("replay")

    def echo(x):
        return x

    f = app.function(serialized=True)(echo)
    with app.run(client=client):
        req = api_pb2.FunctionMapBatchRequest(requests=[
            api_pb2.FunctionMapRequest(function_id=f.object_id, function_call_type=api_pb2.FUNCTION_CALL_TYPE_UNARY)
            for _ in range(3)])
        md = [("x-idempotency-key", "batch-key-1")]
        before = len(sup.state.function_calls)
        first = tsync.run(client.stub.FunctionMapBatch(req, metadata=md))
        second = tsync.run(client.stub.FunctionMapBatch(req, metadata=md))
        created = len(sup.state.function_calls) - before
    ids = [r.function_call_id for r in first.responses]
    assert len(set(ids)) == 3 and ids == [r.function_call_id for r in second.responses]
    assert created == 3


# -- the container's input loop ----------------------------------------------


class _FakeStub:
    """FunctionExchange / FunctionGetInputs that hand out every queued input
    a claim asks for, recording each claim's max_values."""

    def __init__(self, pb, serialize, n: int):
        self.pb = pb
        self.claims: list = []
        self.queue = [pb.FunctionGetInputsItem(
            input_id=f"in-{i}", function_call_id="fc-1", idx=i,
            input=pb.FunctionInput(args=serialize(((i,), {})), data_format=pb.DATA_FORMAT_PICKLE))
            for i in range(n)]

    async def _give(self, get):
        self.claims.append(get.max_values)
        items, self.queue = self.queue[:get.max_values], self.queue[get.max_values:]
        return self.pb.FunctionGetInputsResponse(inputs=items)

    async def FunctionExchange(self, req, **_kw):
        return await self._give(req.get)

    async def FunctionGetInputs(self, req, **_kw):
        return await self._give(req)


def _claims(pkg: str, monkeypatch, coalesce: str) -> list:
    monkeypatch.setenv("MODAL_TPU_DISPATCH_COALESCE", coalesce)
    io_mod = importlib.import_module(f"{pkg}.runtime.io_manager")
    pb = importlib.import_module(f"{pkg}.proto.api_pb2")
    serialize = importlib.import_module(f"{pkg}.serialization").serialize
    stub = _FakeStub(pb, serialize, 4)

    class Client:
        pass

    client = Client()
    client.stub = stub
    fdef = pb.Function(max_concurrent_inputs=4)

    async def main():
        io = io_mod.ContainerIOManager(client, "ta-1", fdef)
        io._function_id = "fu-1"
        got = []
        gen = io.generate_inputs()
        while len(got) < 4:
            got.append(await gen.__anext__())
        await gen.aclose()
        return [c.inputs[0][0][0] for c in got]

    values = asyncio.run(main())
    assert values == [0, 1, 2, 3]
    return stub.claims


def test_claims_coalesce_in_the_input_loop(monkeypatch):
    """A container with 4 free slots of a @concurrent function claims all
    4 inputs in one long-poll (max_values 4), as JAX's input loop does;
    with the kill switch it claims one at a time."""
    assert _claims("modal_tpu_torch", monkeypatch, "1") == _claims("modal_tpu", monkeypatch, "1") == [4]
    assert _claims("modal_tpu_torch", monkeypatch, "0") == _claims("modal_tpu", monkeypatch, "0") == [1, 1, 1, 1]


def test_batched_and_concurrent_match_jax(planes):
    """@batched(max_batch_size=4, wait_ms=300) on a class method gets the 4
    spawned inputs as one list call; @concurrent(max_inputs=4) runs 4
    one-second inputs in one container at once: all four run together
    (every input starts before any ends), where tests/test_cls.py:101 bounds
    the wall time (tests/test_cls.py:40 and :101)."""

    def scenario(m, client, sup):
        app = m.App("batched")

        def make():
            @app.cls(serialized=True)
            class Batcher:
                @m.batched(max_batch_size=4, wait_ms=300)
                def embed(self, xs):
                    assert isinstance(xs, list)
                    return [x * 10 + len(xs) for x in xs]

            @app.function(serialized=True)
            @m.concurrent(max_inputs=4)
            def slow_echo(x):
                import os
                import time as _t

                t0 = _t.time()
                _t.sleep(1.0)
                return x, os.getpid(), t0, _t.time()

            return Batcher, slow_echo

        Batcher, slow_echo = make()
        with app.run(client=client):
            b = Batcher()
            batched = [c.get() for c in [b.embed.spawn(i) for i in range(4)]]
            results = list(slow_echo.map(range(4), order_outputs=True))
            fdef = sup.state.functions[slow_echo.object_id].definition
        return {"batched": batched, "values": [r[0] for r in results], "pids": len({r[1] for r in results}),
                "together": max(r[2] for r in results) < min(r[3] for r in results),
                "max_concurrent_inputs": fdef.max_concurrent_inputs}

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == {"batched": [i * 10 + 4 for i in range(4)], "values": [0, 1, 2, 3], "pids": 1,
                           "together": True, "max_concurrent_inputs": 4}
