"""The port's durable control plane against the JAX package's, through the
raw-RPC harness of tests/test_torch_control_plane.py: the same script runs
against a JAX `LocalSupervisor` and the port's, each with its journal on (the
default).

Each plane serves an open map of a small unary function whose later inputs
wait on a gate file; the plane is `crash_restart`ed while the first two
outputs are taken and the third input runs, then the gate opens. Every
output arrives exactly once, and both planes recover the same counts: apps,
functions, calls, requeued inputs, workers awaiting re-adoption. A retry
storm of one FunctionMap under one idempotency key, across a restart,
creates one call on both. State dirs live under /tmp so the plane's Unix
socket path stays under the ~107-byte cap."""

import os
import shutil
import tempfile
import time

import pytest

from modal_tpu._utils.async_utils import synchronizer as jsync
from modal_tpu.server.supervisor import LocalSupervisor as JaxSupervisor
from modal_tpu_torch._utils import async_utils as tasync
from modal_tpu_torch._utils.grpc_utils import retry_transient_errors
from modal_tpu_torch.client import _Client
from modal_tpu_torch.proto import api_pb2
from modal_tpu_torch.serialization import deserialize, serialize
from modal_tpu_torch.server.supervisor import LocalSupervisor

CONTAINER_ENV = {"MODAL_TPU_HEARTBEAT_INTERVAL": "3"}
N_INPUTS = 4
GATED_FROM = 2  # inputs at or past this idx wait for the gate file
# bounds of the waits on a loaded host: the gated input's claim, and the
# outputs after a restart (a fresh container's boot, its framework imported)
CLAIM_TIMEOUT_S = 120.0
RESTART_TAKE_TIMEOUT_S = 240.0


def _run(coro, timeout: float = 120.0):
    """Run on the port's synchronizer thread, bounded: a hung plane fails
    the test instead of hanging the run."""
    import asyncio

    return tasync.synchronizer.run(asyncio.wait_for(coro, timeout))


def _gated(gate: str):
    """The map's function, by value: idx < GATED_FROM returns at once, the
    others once `gate` exists."""

    def unary(x):
        import os as _os
        import time as _time

        if x >= GATED_FROM:
            while not _os.path.exists(gate):
                _time.sleep(0.05)
        return {"x": x, "square": x * x}

    return unary


async def _bounded(coro, timeout: float = 120.0):
    import asyncio

    return await asyncio.wait_for(coro, timeout)


class _Side:
    """One package's supervisor in a fresh /tmp state dir, and the port's
    client talking to it."""

    def __init__(self, name: str):
        self.name = name
        self.root = tempfile.mkdtemp(prefix=f"rec-{name}-", dir="/tmp")
        self.gate = os.path.join(self.root, "gate")
        state_dir = os.path.join(self.root, "s")
        if name == "jax":
            self.sup = JaxSupervisor(num_workers=1, state_dir=state_dir, worker_chips=1, worker_tpu_type="local-sim")
            self.sync = lambda coro: jsync.run(_bounded(coro))
        else:
            self.sup = LocalSupervisor(num_workers=1, state_dir=state_dir, worker_gpus=1,
                                       worker_gpu_type="local-sim")
            self.sync = _run
        self.sync(self.sup.start())
        self.client = _Client(self.sup.server_url)
        self.client._open()  # blocking: synchronize_api wrapped the client's coroutines

    def call(self, method: str, request):
        return _run(retry_transient_errors(getattr(self.client.stub, method), request))

    def crash_restart(self) -> dict:
        return self.sync(self.sup.crash_restart())

    def function(self, fn) -> str:
        app_id = self.call("AppCreate", api_pb2.AppCreateRequest(description="recovery")).app_id
        fdef = api_pb2.Function(function_name="unary", definition_type="serialized", function_serialized=serialize(fn))
        fdef.autoscaler_settings.scaledown_window = 600
        fdef.autoscaler_settings.max_containers = 1
        return self.call("FunctionCreate", api_pb2.FunctionCreateRequest(app_id=app_id, function=fdef, tag="unary")
                         ).function_id

    def take(self, call_id: str, n: int, timeout: float = 120.0) -> list:
        got, deadline = [], time.monotonic() + timeout
        while len(got) < n:
            assert time.monotonic() < deadline, f"{self.name}: {len(got)}/{n} outputs after {timeout}s"
            got += list(self.call("FunctionGetOutputs", api_pb2.FunctionGetOutputsRequest(
                function_call_id=call_id, timeout=5, clear_on_success=True)).outputs)
        return got

    def counts(self) -> dict:
        s = self.sup.state
        return {"apps": len(s.apps), "functions": len(s.functions), "calls": len(s.function_calls),
                "inputs": len(s.inputs), "workers": len(s.workers)}

    def close(self):
        try:
            self.client._close()
        finally:
            self.sync(self.sup.stop())
            shutil.rmtree(self.root, ignore_errors=True)


@pytest.fixture
def sides(monkeypatch):
    for k, v in CONTAINER_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MODAL_TPU_JOURNAL", raising=False)
    out = {}
    try:
        for name in ("jax", "port"):
            out[name] = _Side(name)
        yield out
    finally:
        for side in out.values():
            side.close()


def test_a_crash_restart_mid_map_delivers_every_output_once(sides):
    reports, delivered = {}, {}
    for name, side in sides.items():
        fn_id = side.function(_gated(side.gate))
        items = [api_pb2.FunctionPutInputsItem(idx=i, input=api_pb2.FunctionInput(args=serialize(((i,), {}))))
                 for i in range(N_INPUTS)]
        call_id = side.call("FunctionMap", api_pb2.FunctionMapRequest(
            function_id=fn_id, function_call_type=api_pb2.FUNCTION_CALL_TYPE_MAP, pipelined_inputs=items)
        ).function_call_id
        before = side.take(call_id, GATED_FROM)
        # the third input is claimed and blocked on the gate, the fourth
        # queued. The claim comes with the container's next exchange, which
        # under a loaded host (the tier-1 run's six workers) took past the
        # 30 s this wait had: it waits as long as a take does
        deadline = time.monotonic() + CLAIM_TIMEOUT_S
        while not any(i.status == "claimed" for i in side.sup.state.inputs.values()):
            assert time.monotonic() < deadline, f"{name}: no input claimed past the first two"
            time.sleep(0.05)
        reports[name] = side.crash_restart()
        recovered = side.counts()
        open(side.gate, "w").close()
        # a new container boots after the restart (the old one died with it)
        after = side.take(call_id, N_INPUTS - GATED_FROM, timeout=RESTART_TAKE_TIMEOUT_S)
        extra = side.call("FunctionGetOutputs", api_pb2.FunctionGetOutputsRequest(
            function_call_id=call_id, timeout=1, clear_on_success=True)).outputs
        outs = before + after + list(extra)
        assert sorted(o.idx for o in outs) == list(range(N_INPUTS)), (name, [o.idx for o in outs])
        values = {o.idx: deserialize(o.result.data) for o in outs}
        assert values == {i: {"x": i, "square": i * i} for i in range(N_INPUTS)}, name
        delivered[name] = recovered
    for name in ("jax", "port"):
        r = reports[name]
        assert r["records_skipped"] == 0 and r["inputs_requeued"] == N_INPUTS - GATED_FROM, (name, r)
        assert r["open_calls"] == 1 and r["workers_pending_adoption"] == 1, (name, r)
    assert delivered["port"] == delivered["jax"] == {"apps": 1, "functions": 1, "calls": 1, "inputs": N_INPUTS,
                                                     "workers": 1}
    assert reports["port"]["skipped_by_type"] == {}


def test_a_function_map_retry_storm_is_exactly_once_across_a_restart(sides):
    """One FunctionMap sent five times under one `x-idempotency-key` (what a
    reconnect storm of retry_transient_errors sends), a crash_restart
    between the third and the fourth: every answer names one call, and the
    plane holds one call of the function."""
    for name, side in sides.items():
        fn_id = side.function(_gated(side.gate))
        req = api_pb2.FunctionMapRequest(function_id=fn_id, function_call_type=api_pb2.FUNCTION_CALL_TYPE_MAP)
        md = [("x-idempotency-key", f"storm-{name}")]
        answers = []
        for i in range(5):
            if i == 3:
                side.crash_restart()
            answers.append(_run(side.client.stub.FunctionMap(req, metadata=md)).function_call_id)
        assert len(set(answers)) == 1, (name, answers)
        calls = [c for c in side.sup.state.function_calls.values() if c.function_id == fn_id]
        assert [c.function_call_id for c in calls] == answers[:1], name
        # a new key is a new call
        other = _run(side.client.stub.FunctionMap(req, metadata=[("x-idempotency-key", f"other-{name}")]))
        assert other.function_call_id != answers[0], name
