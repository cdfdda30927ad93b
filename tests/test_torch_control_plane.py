"""The port's control plane, worker and container runtime against the JAX
package's, through the same raw-RPC script.

The script is driven by the port's client (its stub, `retry_transient_errors`
and blob client on the port's synchronizer thread) and runs once against a
JAX `LocalSupervisor` (JAX containers, CPU jax) and once against the port's
(`worker_gpus=8, worker_gpu_type="local-sim"`, containers of
`modal_tpu_torch.runtime.container_entrypoint`). Each plane serves one
serialized unary function and one serialized generator, created once per
module; both must give the same outputs for a map of several inputs, the
same exception text with the user's frame in its traceback, one task for 3
sequential inputs, the same generator items, a 3 MiB result through
BlobCreate/BlobGet, multipart uploads planned alike and spilled downloads,
the same unsatisfiable-placement reason, and a running
sync input interrupted by FunctionCallCancel (SIGUSR1 in the container)."""

import os
import time

import pytest

from modal_tpu._utils.async_utils import synchronizer as jsync
from modal_tpu.server.supervisor import LocalSupervisor as JaxSupervisor
from modal_tpu_torch._utils import async_utils as tasync
from modal_tpu_torch._utils.blob_utils import resolve_blob_data
from modal_tpu_torch._utils.grpc_utils import retry_transient_errors
from modal_tpu_torch.client import _Client
from modal_tpu_torch.proto import api_pb2
from modal_tpu_torch.serialization import deserialize, serialize
from modal_tpu_torch.server.supervisor import LocalSupervisor

BIG = 3 * 1024 * 1024
# the containers of both planes read these at spawn: heartbeats every 1 s
# (cancellation rides the heartbeat), and no CUDA context for a local-sim task
CONTAINER_ENV = {"MODAL_TPU_HEARTBEAT_INTERVAL": "3"}


def _run(coro):
    return tasync.synchronizer.run(coro)


def _functions(marker_dir: str):
    """The unary function and the generator both planes serve, by value."""

    def unary(x):
        import os as _os
        import time as _time

        if x == "boom":
            raise ValueError(f"boom from {x!r}")
        if x == "big":
            return b"\x07" * (3 * 1024 * 1024)
        if x == "sleep":
            open(_os.path.join(marker_dir, f"sleeping-{_os.getpid()}"), "w").close()
            _time.sleep(60)
            return "slept"
        return {"x": x, "square": x * x, "pid": _os.getpid()}

    def gen(n):
        for i in range(n):
            yield {"i": i, "tag": "g" * i}

    return unary, gen


class Plane:
    """One control plane, driven over raw RPCs by the port's client."""

    def __init__(self, url: str, marker_dir: str):
        self.client = _Client(url)
        self.client._open()  # blocking: synchronize_api wrapped the client's coroutines
        self.app_id = self.call("AppCreate", api_pb2.AppCreateRequest(description="parity")).app_id
        unary, gen = _functions(marker_dir)
        self.unary = self.create("unary", unary)
        self.gen = self.create("gen", gen, generator=True)

    def call(self, method: str, request):
        return _run(retry_transient_errors(getattr(self.client.stub, method), request))

    def create(self, tag: str, fn, generator: bool = False, **resources) -> str:
        fdef = api_pb2.Function(
            function_name=tag,
            definition_type="serialized",
            function_serialized=serialize(fn),
            function_type=api_pb2.FUNCTION_TYPE_GENERATOR if generator else api_pb2.FUNCTION_TYPE_FUNCTION,
        )
        fdef.autoscaler_settings.scaledown_window = 600
        for key, value in resources.items():
            getattr(fdef, key).CopyFrom(value)
        req = api_pb2.FunctionCreateRequest(app_id=self.app_id, function=fdef, tag=tag)
        return self.call("FunctionCreate", req).function_id

    def submit(self, fn_id: str, args: list) -> str:
        items = [
            api_pb2.FunctionPutInputsItem(
                idx=i, input=api_pb2.FunctionInput(args=serialize(((a,), {})), data_format=api_pb2.DATA_FORMAT_PICKLE)
            )
            for i, a in enumerate(args)
        ]
        return self.call("FunctionMap", api_pb2.FunctionMapRequest(function_id=fn_id, pipelined_inputs=items)).function_call_id

    def outputs(self, call_id: str, n: int, timeout: float = 120.0) -> list:
        got, deadline = [], time.monotonic() + timeout
        while len(got) < n:
            assert time.monotonic() < deadline, f"{len(got)}/{n} outputs after {timeout}s"
            resp = self.call(
                "FunctionGetOutputs",
                api_pb2.FunctionGetOutputsRequest(function_call_id=call_id, timeout=10, clear_on_success=True),
            )
            got += list(resp.outputs)
        return sorted(got, key=lambda o: o.idx)

    def value(self, output):
        return deserialize(_run(resolve_blob_data(output.result, self.client.stub)))

    def map(self, fn_id: str, args: list) -> list:
        return [self.value(o) for o in self.outputs(self.submit(fn_id, args), len(args))]

    def tasks_of(self, tag: str) -> list:
        tasks = self.call("TaskList", api_pb2.TaskListRequest(include_finished=True)).tasks
        return [t for t in tasks if t.app_id == self.app_id and t.function_tag == tag]

    def close(self):
        self.client._close()


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    root = tmp_path_factory.mktemp("planes")
    saved = {k: os.environ.get(k) for k in CONTAINER_ENV}
    os.environ.update(CONTAINER_ENV)
    jsup = JaxSupervisor(num_workers=1, state_dir=str(root / "jax"), worker_chips=8, worker_tpu_type="local-sim")
    tsup = LocalSupervisor(num_workers=1, state_dir=str(root / "port"), worker_gpus=8, worker_gpu_type="local-sim")
    jsync.run(jsup.start())
    _run(tsup.start())
    out = {}
    try:
        out = {"jax": Plane(jsup.server_url, str(root)), "port": Plane(tsup.server_url, str(root))}
        out["root"] = str(root)
        yield out
    finally:
        for name in ("jax", "port"):
            if name in out:
                out[name].close()
        _run(tsup.stop())
        jsync.run(jsup.stop())
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_a_map_gives_the_same_outputs(planes):
    args = [3, 5, 7, 11]
    results = {name: planes[name].map(planes[name].unary, args) for name in ("jax", "port")}
    for name, res in results.items():
        assert [(r["x"], r["square"]) for r in res] == [(a, a * a) for a in args], name
    assert [{k: v for k, v in r.items() if k != "pid"} for r in results["port"]] == [
        {k: v for k, v in r.items() if k != "pid"} for r in results["jax"]
    ]


def test_an_exception_comes_back_the_same(planes):
    got = {}
    for name in ("jax", "port"):
        plane = planes[name]
        (out,) = plane.outputs(plane.submit(plane.unary, ["boom"]), 1)
        assert out.result.status == api_pb2.GENERIC_STATUS_FAILURE, name
        exc = deserialize(out.result.data)
        assert type(exc) is ValueError and str(exc) == "boom from 'boom'", name
        assert "in unary" in out.result.traceback and "raise ValueError" in out.result.traceback, name
        got[name] = out.result.exception
    assert got["port"] == got["jax"] == "ValueError(\"boom from 'boom'\")"


def test_sequential_inputs_reuse_one_task(planes):
    """3 sequential inputs to a fresh function: one task serves them all."""
    for name in ("jax", "port"):
        plane = planes[name]
        unary, _gen = _functions(planes["root"])
        fn_id = plane.create("reuse", unary)
        pids = {plane.map(fn_id, [i])[0]["pid"] for i in range(3)}
        assert len(pids) == 1, name
        tasks = plane.tasks_of("reuse")
        assert len(tasks) == 1 and tasks[0].state == api_pb2.TASK_STATE_ACTIVE, (name, tasks)
    (task,) = planes["port"].tasks_of("reuse")
    assert list(task.gpu_ids) == [] and list(task.tpu_chip_ids) == []  # a CPU task pins nothing


def test_a_generator_streams_its_items(planes):
    items = {}
    for name in ("jax", "port"):
        plane = planes[name]
        call_id = plane.submit(plane.gen, [4])

        async def read(stub=plane.client.stub, call_id=call_id):
            chunks = []
            async for chunk in stub.FunctionCallGetData(api_pb2.FunctionCallGetDataRequest(function_call_id=call_id)):
                chunks.append(chunk)
                if chunk.data_format == api_pb2.DATA_FORMAT_GENERATOR_DONE:
                    break
            return chunks

        chunks = _run(read())
        assert chunks[-1].data_format == api_pb2.DATA_FORMAT_GENERATOR_DONE, name
        assert api_pb2.GeneratorDone.FromString(chunks[-1].data).items_total == 4
        items[name] = [deserialize(c.data) for c in chunks[:-1]]
        (out,) = plane.outputs(call_id, 1)
        assert out.result.data_format == api_pb2.DATA_FORMAT_GENERATOR_DONE
    assert items["port"] == items["jax"] == [{"i": i, "tag": "g" * i} for i in range(4)]


def test_a_3mib_result_goes_through_the_blob_store(planes):
    for name in ("jax", "port"):
        plane = planes[name]
        (out,) = plane.outputs(plane.submit(plane.unary, ["big"]), 1)
        assert out.result.data_blob_id and not out.result.data, name
        get = plane.call("BlobGet", api_pb2.BlobGetRequest(blob_id=out.result.data_blob_id))
        assert get.download_url.endswith("/blob/" + out.result.data_blob_id)
        assert plane.value(out) == b"\x07" * BIG, name


def test_multipart_upload_and_spilled_download_through_both_planes(planes, monkeypatch):
    """With the multipart threshold, the part length and the download spill
    at 1 MiB (JAX's plane reads its threshold and part length from the
    environment per BlobCreate, the port's from `blob_utils`; the port's
    client reads the spill), a 3.5 MiB payload is planned as the same parts
    by both planes, uploads in parts, and comes back byte-equal as an
    mmap-backed view."""
    from modal_tpu_torch._utils import blob_utils as tblob
    from modal_tpu_torch._utils.blob_utils import blob_download, blob_upload, get_upload_hashes
    from modal_tpu_torch.observability.catalog import BLOB_SPILLS

    monkeypatch.setenv("MODAL_TPU_MULTIPART_THRESHOLD", str(1024 * 1024))
    monkeypatch.setenv("MODAL_TPU_MULTIPART_PART_LEN", str(1024 * 1024))
    for name in ("MULTIPART_THRESHOLD", "MULTIPART_PART_BYTES", "DOWNLOAD_SPILL_BYTES"):
        monkeypatch.setattr(tblob, name, 1024 * 1024)
    data = os.urandom(7 * 512 * 1024)
    hashes = get_upload_hashes([data])
    plans = {}
    for name in ("jax", "port"):
        plane = planes[name]
        plan = plane.call("BlobCreate", api_pb2.BlobCreateRequest(
            content_sha256_base64=hashes.sha256_base64, content_length=hashes.content_length))
        assert plan.WhichOneof("upload_type_oneof") == "multipart", name
        plans[name] = (plan.multipart.part_length, len(plan.multipart.upload_urls))
        spills = BLOB_SPILLS.value()
        blob_id = _run(blob_upload(data, plane.client.stub))
        back = _run(blob_download(blob_id, plane.client.stub))
        assert isinstance(back, memoryview) and BLOB_SPILLS.value() == spills + 1, name
        assert bytes(back) == data, name
    assert plans["port"] == plans["jax"] == (1024 * 1024, 4)


def test_an_unsatisfiable_ask_fails_with_the_same_reason(planes):
    """A region no worker carries, with a card ask (a chip ask to JAX's):
    both planes fail the call after the grace window with one formatter's
    reason. The port refuses a chip ask at FunctionCreate."""
    reasons = {}
    for name in ("jax", "port"):
        plane = planes[name]
        placement = api_pb2.SchedulerPlacement(regions=["mars-north1"])
        if name == "port":
            resources = api_pb2.Resources(gpu_config=api_pb2.GPUConfig(gpu_type="H100", count=1))
        else:
            resources = api_pb2.Resources(tpu_config=api_pb2.TPUConfig(tpu_type="v5e-1"))
        fn_id = plane.create(f"far-{name}", lambda: 1, scheduler_placement=placement, resources=resources)
        t0 = time.monotonic()
        (out,) = plane.outputs(plane.submit(fn_id, [None]), 1, timeout=60)
        assert time.monotonic() - t0 >= 4.0, name  # PLACEMENT_UNSAT_GRACE_S, less a tick
        assert out.result.status == api_pb2.GENERIC_STATUS_FAILURE, name
        reasons[name] = out.result.exception.replace(f"far-{name}", "far")
    assert reasons["port"] == reasons["jax"]
    assert reasons["port"].startswith("unsatisfiable placement for far: regions=['mars-north1']")
    chips = api_pb2.Resources(tpu_config=api_pb2.TPUConfig(tpu_type="v5e-1"))
    with pytest.raises(Exception, match=r"InvalidError: tpu_config \('v5e-1'\) asks for TPU chips"):
        planes["port"].create("chips", lambda: 1, resources=chips)


def test_cancel_interrupts_a_running_sync_input(planes):
    for name in ("jax", "port"):
        plane = planes[name]
        before = set(os.listdir(planes["root"]))
        call_id = plane.submit(plane.unary, ["sleep"])
        deadline = time.monotonic() + 60
        while not {f for f in os.listdir(planes["root"]) if f.startswith("sleeping-")} - before:
            assert time.monotonic() < deadline, f"{name}: the input never started"
            time.sleep(0.1)
        t0 = time.monotonic()
        plane.call("FunctionCallCancel", api_pb2.FunctionCallCancelRequest(function_call_id=call_id))
        (out,) = plane.outputs(call_id, 1, timeout=30)
        assert out.result.status == api_pb2.GENERIC_STATUS_TERMINATED and out.result.exception == "input cancelled"
        assert time.monotonic() - t0 < 20, name  # interrupted, not slept out
        # the container survives the cancel and serves the next input
        assert plane.map(plane.unary, [2])[0]["square"] == 4, name


@pytest.mark.parametrize("rpc,request_msg", [
    ("DictGetOrCreate", api_pb2.DictGetOrCreateRequest(
        deployment_name="d", object_creation_type=api_pb2.OBJECT_CREATION_TYPE_CREATE_IF_MISSING)),
    ("ContainerExec", api_pb2.ContainerExecRequest(task_id="ta-1", command=["true"])),
    ("MetricsHistory", api_pb2.MetricsHistoryRequest()),
    ("TaskGetTimeline", api_pb2.TaskGetTimelineRequest(task_id="ta-1")),
])
def test_an_rpc_the_port_has_not_taken_answers_unimplemented(planes, rpc, request_msg):
    """The JAX plane answers; the port's says UNIMPLEMENTED (never a made-up
    reply) until the sub-slice that brings the RPC."""
    import grpc

    if rpc == "DictGetOrCreate":
        assert planes["jax"].call(rpc, request_msg).dict_id
    with pytest.raises(grpc.aio.AioRpcError) as err:
        planes["port"].call(rpc, request_msg)
    assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
