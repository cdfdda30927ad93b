"""The port's worker and container runtime (`modal_tpu_torch/server/worker.py`,
`modal_tpu_torch/runtime/`) on the CPU.

- A container's card pinning: `CUDA_VISIBLE_DEVICES` (PCI bus order) for a
  task with cards, empty for a CPU task and on a `local-sim` host; the
  inventory parser on nvidia-smi lines (one H100; eight mixed cards) and
  the probe through a stub `nvidia-smi`.
- The wire fields the slice adds, held both ways in bytes against the JAX
  package's messages: a JAX reader sees them as unknown fields, never as
  chips, and keeps them.
- The slice as a whole: a serialized serving function runs the port's tiny
  llama engine (fp32, CPU) through the port's control plane, worker and
  container; a serialized JAX serving function runs the JAX engine at the
  same weights (carried across by `models/convert.py`) through the JAX
  supervisor. Both give the same greedy token streams, and the port's
  logits equal the same function called in this process.
- A serialized class with `@enter(snap=True)` and
  `enable_memory_snapshot=True` (as tests/test_snapshot.py:8 for the JAX
  package): the first container runs the hook and saves, the second
  restores, skips the hook and answers the same.
"""

import os
import stat
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modal_tpu.models import llama as jllama
from modal_tpu.proto import api_pb2 as japi
from modal_tpu_torch._utils import async_utils as tasync
from modal_tpu_torch._utils.blob_utils import resolve_blob_data
from modal_tpu_torch._utils.grpc_utils import retry_transient_errors
from modal_tpu_torch.client import _Client
from modal_tpu_torch.partial_function import (
    _PartialFunctionFlags,
    enter,
    find_partial_methods_for_user_cls,
    method,
)
from modal_tpu_torch.proto import api_pb2 as tapi
from modal_tpu_torch.serialization import deserialize, serialize
from modal_tpu_torch.server import worker as tworker
from modal_tpu_torch.server.supervisor import LocalSupervisor

H100 = "NVIDIA H100 80GB HBM3"
ONE_H100 = "0, NVIDIA H100 80GB HBM3, 81559 MiB\n"
EIGHT_MIXED = "".join(
    f"{i}, {name}, {mem} MiB\n"
    for i, (name, mem) in enumerate(
        [(H100, 81559)] * 3 + [("NVIDIA A100-SXM4-80GB", 81920)] * 2 + [(H100, 81559)] * 3
    )
)
GEOMETRY = dict(max_slots=4, num_pages=32, page_size=8, pages_per_slot=8, prefill_chunk=16)
PROMPTS = [[5, 6, 7, 8], list(range(20, 45)), [9] * 11]
NEW_TOKENS = 12


def _run(coro):
    return tasync.synchronizer.run(coro)


# -- the container's cards -------------------------------------------------------


def test_a_task_with_cards_sees_exactly_them():
    assert tworker.container_gpu_env([1], [0, 1, 2, 3], H100) == {
        "CUDA_VISIBLE_DEVICES": "1", "CUDA_DEVICE_ORDER": "PCI_BUS_ID"}
    # the scheduler's ids are positions among the host's cards of its type
    assert tworker.container_gpu_env([3, 4], [0, 1, 2, 5, 6, 7], H100)["CUDA_VISIBLE_DEVICES"] == "5,6"
    assert tworker.container_gpu_env([], [0, 1], H100) == {"CUDA_VISIBLE_DEVICES": ""}
    assert tworker.container_gpu_env([0, 1], [0, 1], "local-sim") == {"CUDA_VISIBLE_DEVICES": ""}


def test_the_container_env(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")  # the worker's own view never leaks
    agent = tworker.WorkerAgent("grpc://127.0.0.1:1", state_dir=str(tmp_path), compile_cache_url="http://127.0.0.1:2",
                                compile_cache_dir=str(tmp_path))
    agent.gpu_type, agent.card_indices = H100, [0, 1, 2, 3]
    assignment = tapi.TaskAssignment(task_id="ta-7", gpu_ids=[1])
    assignment.container_arguments.env["MODAL_TPU_BOUND_PARAMS"] = "00"
    env = agent.container_env(assignment, str(tmp_path / "ta-7"), "/args.pb", 1.5)
    assert (env["CUDA_VISIBLE_DEVICES"], env["CUDA_DEVICE_ORDER"]) == ("1", "PCI_BUS_ID")
    assert env["TORCH_EXTENSIONS_DIR"] == str(tmp_path / "ta-7" / "kernels")  # an empty build dir per task
    assert env["MODAL_TPU_COMPILE_CACHE_DIR"] == str(tmp_path)
    assert env["MODAL_TPU_COMPILE_CACHE_URL"] == "http://127.0.0.1:2"
    assert env["MODAL_TPU_TASK_ID"] == "ta-7" and env["MODAL_TPU_CONTAINER_ARGS_PATH"] == "/args.pb"
    assert env["MODAL_TPU_BOUND_PARAMS"] == "00" and env["MODAL_TPU_TRACE_T0"] == "1.5"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert env["PYTHONPATH"].split(os.pathsep)[0] == repo
    agent.gpu_type = "local-sim"
    assert agent.container_env(assignment, str(tmp_path), "/a", 0.0)["CUDA_VISIBLE_DEVICES"] == ""
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", "/shared/build")  # an explicit build dir wins
    assert agent.container_env(assignment, str(tmp_path), "/a", 0.0)["TORCH_EXTENSIONS_DIR"] == "/shared/build"


def test_the_inventory_parser():
    assert tworker.parse_gpu_inventory(ONE_H100) == (H100, [0])
    assert tworker.parse_gpu_inventory(EIGHT_MIXED) == (H100, [0, 1, 2, 5, 6, 7])
    assert tworker.parse_gpu_inventory("") == ("", [])
    two_each = "0, NVIDIA L4, 23034 MiB\n1, NVIDIA L40S, 46068 MiB\n"
    assert tworker.parse_gpu_inventory(two_each) == ("NVIDIA L4", [0])  # a tie: the lowest index's type


def test_the_probe_reads_nvidia_smi(tmp_path, monkeypatch):
    fake = tmp_path / "nvidia-smi"
    fake.write_text(f"#!/bin/sh\necho \"$@\" > {tmp_path}/argv\nprintf '{EIGHT_MIXED.replace(chr(10), chr(92) + 'n')}'\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.delenv("MODAL_TPU_WORKER_GPU_TYPE", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert tworker.detect_gpu_inventory() == (H100, [0, 1, 2, 5, 6, 7])
    assert (tmp_path / "argv").read_text().split() == tworker.NVIDIA_SMI_QUERY[1:]
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert tworker.detect_gpu_inventory() == ("", [])  # no nvidia-smi: no card
    monkeypatch.setenv("MODAL_TPU_WORKER_GPU_TYPE", "local-sim")
    monkeypatch.setenv("MODAL_TPU_WORKER_NUM_GPUS", "2")
    assert tworker.detect_gpu_inventory() == ("local-sim", [0, 1])


# -- the wire fields ---------------------------------------------------------------


@pytest.mark.parametrize("msg,fields,jax_empty", [
    ("WorkerRegisterRequest", {"gpu_type": H100, "num_gpus": 8, "worker_id": "wk-1"}, ("tpu_type", "num_chips")),
    ("TaskAssignment", {"task_id": "ta-1", "gpu_ids": [1, 3]}, ("tpu_chip_ids",)),
    ("TaskInfo", {"task_id": "ta-1", "gpu_ids": [0]}, ("tpu_chip_ids",)),
])
def test_the_gpu_fields_cross_both_ways_and_are_never_chips(msg, fields, jax_empty):
    port = getattr(tapi, msg)(**fields)
    wire = port.SerializeToString()
    jax_msg = getattr(japi, msg).FromString(wire)
    for name in jax_empty:
        assert not getattr(jax_msg, name), name  # never read as chips
    # what the JAX reader sees: the shared fields only; the cards ride as unknown
    assert {f.name for f, _ in jax_msg.ListFields()} == {k for k in fields if k not in ("gpu_type", "num_gpus", "gpu_ids")}
    assert jax_msg.SerializeToString() == wire  # a JAX hop keeps them, byte for byte
    assert getattr(tapi, msg).FromString(jax_msg.SerializeToString()) == port
    # and the JAX package's chip fields reach the port as chips, not cards
    jax_only = getattr(japi, msg)(**{k: v for k, v in fields.items() if not k.startswith(("gpu", "num_gpus"))})
    if msg == "WorkerRegisterRequest":
        jax_only.tpu_type, jax_only.num_chips = "v5e-8", 8
    else:
        jax_only.tpu_chip_ids.extend([2])
    back = getattr(tapi, msg).FromString(jax_only.SerializeToString())
    assert not getattr(back, "gpu_ids", None) and not getattr(back, "num_gpus", 0) and not getattr(back, "gpu_type", "")


def test_the_field_numbers_are_new():
    numbers = {(m, f): tapi.DESCRIPTOR.message_types_by_name[m].fields_by_name[f].number
               for m, f in (("WorkerRegisterRequest", "gpu_type"), ("WorkerRegisterRequest", "num_gpus"),
                            ("TaskAssignment", "gpu_ids"), ("TaskInfo", "gpu_ids"))}
    assert numbers == {("WorkerRegisterRequest", "gpu_type"): 15, ("WorkerRegisterRequest", "num_gpus"): 16,
                       ("TaskAssignment", "gpu_ids"): 7, ("TaskInfo", "gpu_ids"): 13}
    for (m, _f), n in numbers.items():
        assert n not in {f.number for f in japi.DESCRIPTOR.message_types_by_name[m].fields}


# -- the slice as a whole ---------------------------------------------------------------


def _port_serving_fn():
    """The port's serving function, by value: the tiny llama at the given
    fp32 weights (a numpy tree in JAX's layout), greedy, driven iteration by
    iteration; returns the streams, the last decode step's logits and the
    container's card env."""

    def serve(tree):
        import os as _os

        import torch as _torch

        from modal_tpu_torch.models import llama as llama_
        from modal_tpu_torch.models.convert import params_from_jax
        from modal_tpu_torch.serving import ServingEngine
        from modal_tpu_torch.serving import engine as engine_mod

        cfg = llama_.get_config("tiny", dtype=_torch.float32)
        eng = ServingEngine(params_from_jax(tree, device="cpu"), cfg, device="cpu", **GEOMETRY)
        step, last = engine_mod.paged_decode_step, {}

        def keep(*args):
            out = step(*args)
            last["logits"] = out[0].clone()
            return out

        engine_mod.paged_decode_step = keep
        try:
            reqs = [eng.submit(p, NEW_TOKENS) for p in PROMPTS]
            for _ in range(500):
                if all(r.done for r in reqs):
                    break
                eng.run_once()
            eng.stop()
        finally:
            engine_mod.paged_decode_step = step
        return {"streams": [r.result(timeout=0) for r in reqs], "logits": last["logits"],
                "cuda_visible_devices": _os.environ.get("CUDA_VISIBLE_DEVICES")}

    return serve


def _jax_serving_fn():
    def serve():
        import jax as jax_
        import jax.numpy as jnp_

        from modal_tpu.models import llama as llama_
        from modal_tpu.serving.engine import ServingEngine

        cfg = llama_.get_config("tiny", dtype=jnp_.float32)
        eng = ServingEngine(llama_.init_params(cfg, jax_.random.PRNGKey(0)), cfg, **GEOMETRY)
        reqs = [eng.submit(p, NEW_TOKENS) for p in PROMPTS]
        for _ in range(500):
            if all(r.done for r in reqs):
                break
            eng._admit()
            eng._prefill_one()
            eng._decode_step()
        eng.stop()
        return {"streams": [r.result(timeout=0) for r in reqs]}

    return serve


class _Driver:
    """Raw RPCs from the port's client: one app, functions on it, calls."""

    def __init__(self, url):
        self.client = _Client(url)
        self.client._open()
        self.app_id = self.call("AppCreate", tapi.AppCreateRequest(description="slice")).app_id

    def call(self, name, req):
        return _run(retry_transient_errors(getattr(self.client.stub, name), req))

    def create(self, fdef: tapi.Function, tag: str) -> str:
        fdef.autoscaler_settings.scaledown_window = 600
        return self.call("FunctionCreate", tapi.FunctionCreateRequest(app_id=self.app_id, function=fdef, tag=tag)).function_id

    def remote(self, fn_id, *args, method_name="", timeout=240.0):
        inp = tapi.FunctionInput(args=serialize((args, {})), data_format=tapi.DATA_FORMAT_PICKLE, method_name=method_name)
        call_id = self.call("FunctionMap", tapi.FunctionMapRequest(
            function_id=fn_id, pipelined_inputs=[tapi.FunctionPutInputsItem(idx=0, input=inp)])).function_call_id
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            resp = self.call("FunctionGetOutputs", tapi.FunctionGetOutputsRequest(
                function_call_id=call_id, timeout=10, clear_on_success=True))
            if resp.outputs:
                result = resp.outputs[0].result
                assert result.status == tapi.GENERIC_STATUS_SUCCESS, (result.exception, result.traceback[-3000:])
                return deserialize(_run(resolve_blob_data(result, self.client.stub)))
        raise AssertionError(f"no output after {timeout}s")

    def close(self):
        self.client._close()


@pytest.fixture(scope="module")
def port_plane(tmp_path_factory):
    sup = LocalSupervisor(num_workers=1, state_dir=str(tmp_path_factory.mktemp("port-plane")), worker_gpus=2,
                          worker_gpu_type="local-sim")
    _run(sup.start())
    try:
        yield sup
    finally:
        _run(sup.stop())


def test_the_serving_function_equals_the_jax_stack(port_plane, supervisor):
    jcfg = jllama.get_config("tiny", dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    port, jaxp = _Driver(port_plane.server_url), _Driver(supervisor.server_url)
    try:
        fdef = tapi.Function(function_name="serve", definition_type="serialized",
                             function_serialized=serialize(_port_serving_fn()))
        fdef.resources.gpu_config.CopyFrom(tapi.GPUConfig(gpu_type="H100", count=1))  # a local-sim card
        got = port.remote(port.create(fdef, "serve"), tree)
        jdef = tapi.Function(function_name="serve", definition_type="serialized",
                             function_serialized=serialize(_jax_serving_fn()))
        want = jaxp.remote(jaxp.create(jdef, "serve"))
        (task,) = [t for t in port.call("TaskList", tapi.TaskListRequest()).tasks if t.app_id == port.app_id]
    finally:
        port.close()
        jaxp.close()
    assert [len(s) for s in got["streams"]] == [NEW_TOKENS] * len(PROMPTS)
    assert got["streams"] == want["streams"]
    assert list(task.gpu_ids) == [0] and got["cuda_visible_devices"] == ""  # pinned, and simulated
    # the same function called here: the same streams, the same logits
    local = _port_serving_fn()(tree)
    assert local["streams"] == got["streams"]
    assert got["logits"].dtype == torch.float32 and got["logits"].shape == local["logits"].shape
    torch.testing.assert_close(got["logits"], local["logits"], rtol=0, atol=1e-5)


def _snapshot_class(marker: str):
    class Model:
        @enter(snap=True)
        def load(self):
            import torch as _torch

            with open(marker, "a") as f:
                f.write("x")
            self.w = _torch.arange(8.0)
            self.meta = {"name": "m", "n": 8}
            self.scale = lambda k: k * 2  # a lambda in the state: cloudpickle keeps it

        @method()
        def total(self, k):
            return float(self.w.sum()) * self.scale(k) + self.meta["n"]

    find_partial_methods_for_user_cls(Model, _PartialFunctionFlags.all())  # what a class decorator registers
    return Model


def test_a_snapshot_saved_by_one_container_is_restored_by_the_next(port_plane, tmp_path, monkeypatch):
    monkeypatch.setenv("MODAL_TPU_SNAPSHOT_DIR", str(tmp_path / "snapshots"))  # the containers read it at spawn
    marker = str(tmp_path / "enter_count.txt")
    fdef = tapi.Function(function_name="Model", definition_type="serialized", is_class=True,
                         class_serialized=serialize(_snapshot_class(marker)), enable_memory_snapshot=True)
    fdef.experimental_options["methods"] = "total"
    answers = []
    for _ in range(2):  # two apps: each boots its own container
        driver = _Driver(port_plane.server_url)
        try:
            answers.append(driver.remote(driver.create(fdef, "Model"), 3, method_name="total"))
            driver.call("AppStop", tapi.AppStopRequest(app_id=driver.app_id))
        finally:
            driver.close()
        if len(answers) == 1:
            assert os.path.getsize(marker) == 1  # the fresh boot ran the hook and saved
            assert len(os.listdir(tmp_path / "snapshots")) == 1
    assert answers == [28.0 * 6 + 8] * 2
    assert os.path.getsize(marker) == 1, "snap-enter must not run on a warm-snapshot boot"


def _resumable_fn(marker: str):
    def work(total):
        import sys as _sys
        import time as _time

        ec = _sys.modules["modal_tpu_torch.runtime.execution_context"]  # the container's
        start = int(ec.resume_token() or 0)
        with open(marker, "a") as f:
            f.write(f"start={start}\n")
        for step in range(start, total):
            ec.set_resume_token(str(step))
            _time.sleep(0.25)
        return start

    return work


def test_a_preempted_input_resumes_on_another_worker(tmp_path):
    """A worker's preemption notice (as the JAX package's
    tests/test_preemption.py drives it): the control plane drains the host,
    the container flushes its input's resume token (SIGUSR2) and stops, and
    the input, requeued without consuming retries (the function has none),
    resumes from the token on the other worker."""
    sup = LocalSupervisor(num_workers=2, state_dir=str(tmp_path / "state"), worker_gpus=1, worker_gpu_type="local-sim")
    _run(sup.start())
    marker = str(tmp_path / "progress.txt")
    try:
        driver = _Driver(sup.server_url)
        try:
            fdef = tapi.Function(function_name="work", definition_type="serialized",
                                 function_serialized=serialize(_resumable_fn(marker)))
            fn_id = driver.create(fdef, "work")
            inp = tapi.FunctionInput(args=serialize(((40,), {})), data_format=tapi.DATA_FORMAT_PICKLE)
            call_id = driver.call("FunctionMap", tapi.FunctionMapRequest(
                function_id=fn_id, pipelined_inputs=[tapi.FunctionPutInputsItem(idx=0, input=inp)])).function_call_id
            deadline = time.monotonic() + 60
            while not os.path.exists(marker):
                assert time.monotonic() < deadline, "the input never started"
                time.sleep(0.1)
            time.sleep(2.5)  # ~10 steps of progress
            (task,) = sup.state.tasks.values()
            first = [w.worker_id for w in sup.workers].index(task.worker_id)
            _run(sup.preempt_worker(first, grace_s=5.0))
            deadline = time.monotonic() + 90
            outputs = []
            while not outputs:
                assert time.monotonic() < deadline, "no output after the preemption"
                outputs = driver.call("FunctionGetOutputs", tapi.FunctionGetOutputsRequest(
                    function_call_id=call_id, timeout=10, clear_on_success=True)).outputs
        finally:
            driver.close()
    finally:
        _run(sup.stop())
    (out,) = outputs
    assert out.result.status == tapi.GENERIC_STATUS_SUCCESS, out.result.exception
    assert out.retry_count == 0  # the free requeue, not the retry budget
    with open(marker) as f:
        starts = [int(line.split("=")[1]) for line in f]
    assert len(starts) == 2 and starts[0] == 0 and starts[1] > 0, starts
    assert deserialize(out.result.data) == starts[1]
    tasks = sorted(sup.state.tasks.values(), key=lambda t: t.created_at)
    assert tasks[0].state == tapi.TASK_STATE_PREEMPTED and tasks[1].worker_id != tasks[0].worker_id
