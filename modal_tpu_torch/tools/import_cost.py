"""What a container's `import torch` costs, and whether its place in the
boot changes that: the same import in five places, in turns, on one host.

    python -m modal_tpu_torch.tools.import_cost [--rounds 3] [--out PATH]

- ``bare``: a fresh interpreter that imports torch and nothing else: no
  event loop, no other thread, the interpreter's 5 ms switch interval.
  A container that imports torch before its hello does it so.
- ``container``: the body of a CPU function in a container of the port's
  worker (a `LocalSupervisor` in this process). The entrypoint has sent its
  hello and set its 1 ms switch interval (`config.SWITCH_INTERVAL_S`), its
  loop runs the heartbeat on the synchronizer thread, and the body runs on
  the main-thread executor, where the entrypoint loads torch for a
  function that asks for a card.
- ``container_5ms``: the same body after `sys.setswitchinterval(0.005)`.
- ``container_traced``: the ``container`` body with the import trace on
  (`MODAL_TPU_IMPORT_TRACE=1`: `runtime/telemetry.py` times every module
  the import loads), as `chip_smoke.py`'s worker phase runs its containers.
- ``container_thread``: the ``container`` body importing from a thread of
  its own, as code in the loop's pool threads would (the AOT warm-up, the
  enter hooks and the restore run there).

Each body records a `container.import_torch` span around its import (with
the thread, the switch interval and whether the import trace was on) and
fails if torch was loaded before it.
Printed per place: the import's median [min, max] over the rounds; for the
containers also spawn → ContainerHello and FunctionMap → output, which is
what a CPU container that imports torch costs end to end. Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

PLACES = ("bare", "container", "container_5ms", "container_traced", "container_thread")
BARE = "import time\nt0 = time.perf_counter()\nimport torch\nprint(time.perf_counter() - t0)\n"


def _import_body(switch_interval: float, in_thread: bool):
    """The function a container runs, by value: torch imported once, under
    a span."""

    def body() -> dict:
        import sys as _sys
        import threading
        import time as _time

        from modal_tpu_torch.observability import tracing

        if "torch" in _sys.modules:
            raise RuntimeError("torch was loaded before the function's body")
        if switch_interval:
            _sys.setswitchinterval(switch_interval)
        interval = _sys.getswitchinterval()
        where: dict = {}

        def load() -> None:
            where["thread"] = threading.current_thread().name
            import torch  # noqa: F401

        t0 = _time.time()
        if in_thread:
            thread = threading.Thread(target=load, name="import-torch")
            thread.start()
            thread.join()
        else:
            load()
        t1 = _time.time()
        attrs = {"task_id": os.environ.get("MODAL_TPU_TASK_ID", ""), "switch_interval": interval,
                 "thread": where["thread"], "import_trace": bool(os.environ.get("MODAL_TPU_TELEMETRY_PATH"))}
        # under the boot's parent: the call's context, which the plane
        # carried to the container's env
        tracing.record_span("container.import_torch", start=t0, end=t1, parent=tracing.context_from_env(),
                            attrs=attrs)
        return {"import_s": t1 - t0, **attrs}

    return body


class _Plane:
    """Raw RPCs from the port's client to the port's plane: one app per
    container, so each call boots a new one and no other stays up."""

    def __init__(self, sup):
        from modal_tpu_torch.client import _Client

        self.sup = sup
        self.client = _Client(sup.server_url)
        self.client._open()

    def call(self, name: str, req):
        from modal_tpu_torch._utils.async_utils import synchronizer
        from modal_tpu_torch._utils.grpc_utils import retry_transient_errors

        return synchronizer.run(retry_transient_errors(getattr(self.client.stub, name), req))

    def run_once(self, place: str, timeout: float = 300.0) -> dict:
        from modal_tpu_torch._utils.async_utils import synchronizer
        from modal_tpu_torch._utils.blob_utils import resolve_blob_data
        from modal_tpu_torch.observability import tracing
        from modal_tpu_torch.proto import api_pb2
        from modal_tpu_torch.serialization import deserialize, serialize

        app_id = self.call("AppCreate", api_pb2.AppCreateRequest(description="import_cost")).app_id
        body = _import_body(0.005 if place == "container_5ms" else 0.0, place == "container_thread")
        fdef = api_pb2.Function(function_name="body", definition_type="serialized", function_serialized=serialize(body))
        fn_id = self.call("FunctionCreate", api_pb2.FunctionCreateRequest(app_id=app_id, function=fdef,
                                                                          tag="body")).function_id
        inp = api_pb2.FunctionInput(args=serialize(((), {})), data_format=api_pb2.DATA_FORMAT_PICKLE)
        t_map = time.time()
        # the worker reads the import-trace setting when it spawns the container
        traced = place == "container_traced"
        saved = os.environ.get("MODAL_TPU_IMPORT_TRACE")
        os.environ["MODAL_TPU_IMPORT_TRACE"] = "1" if traced else "0"
        try:
            with tracing.span("import_cost.remote"):  # the container's spans join this call's trace
                call_id = self.call("FunctionMap", api_pb2.FunctionMapRequest(
                    function_id=fn_id, pipelined_inputs=[api_pb2.FunctionPutInputsItem(idx=0, input=inp)])
                ).function_call_id
            (task,) = _wait_for_task(self.sup, app_id, timeout)
        finally:
            os.environ.pop("MODAL_TPU_IMPORT_TRACE", None)
            if saved is not None:
                os.environ["MODAL_TPU_IMPORT_TRACE"] = saved
        deadline = time.monotonic() + timeout
        outputs = []
        while not outputs:
            if time.monotonic() > deadline:
                raise RuntimeError(f"import_cost: no output of {fn_id} in {timeout}s")
            outputs = self.call("FunctionGetOutputs", api_pb2.FunctionGetOutputsRequest(
                function_call_id=call_id, timeout=30, clear_on_success=True)).outputs
        t_out = time.time()
        result = outputs[0].result
        if result.status != api_pb2.GENERIC_STATUS_SUCCESS:
            raise RuntimeError(f"import_cost: the container failed: {result.exception}\n{result.traceback}")
        out = deserialize(synchronizer.run(resolve_blob_data(result, self.client.stub)))
        if out["import_trace"] != traced:
            raise RuntimeError(f"import_cost: {place}'s container ran with import_trace={out['import_trace']}")
        self.call("AppStop", api_pb2.AppStopRequest(app_id=app_id))
        while not task.finished_at:  # the next round starts on a quiet host
            if time.monotonic() > deadline:
                raise RuntimeError(f"import_cost: {task.task_id} did not finish")
            time.sleep(0.1)
        out["task_id"] = task.task_id
        out["map_to_output_s"] = t_out - t_map
        out["started_at"] = task.started_at
        return out

    def close(self) -> None:
        self.client._close()


def _wait_for_task(sup, app_id: str, timeout: float) -> list:
    """The app's task, once the worker has spawned its container."""
    deadline = time.monotonic() + timeout
    while True:
        tasks = [t for t in sup.state.tasks.values() if t.app_id == app_id and t.started_at]
        if tasks:
            return tasks
        if time.monotonic() > deadline:
            raise RuntimeError(f"import_cost: no container of {app_id} said hello in {timeout}s")
        time.sleep(0.05)


def _bare() -> dict:
    proc = subprocess.run([sys.executable, "-c", BARE], capture_output=True, text=True, check=True)
    return {"import_s": float(proc.stdout.strip().splitlines()[-1])}


def _summary(xs: list) -> str:
    return f"{statistics.median(xs):.3f} s [{min(xs):.3f}, {max(xs):.3f}]"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3, help="rounds of the five places, in turns")
    ap.add_argument("--out", default="", help="write the measurements as JSON here")
    args = ap.parse_args(argv)

    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.observability import tracing
    from modal_tpu_torch.server.supervisor import LocalSupervisor

    root = tempfile.mkdtemp(prefix="import-cost-")
    runs: dict = {place: [] for place in PLACES}
    sup = LocalSupervisor(num_workers=1, state_dir=root)
    synchronizer.run(sup.start())
    plane = _Plane(sup)
    try:
        n = len(PLACES)
        for r in range(args.rounds):
            for place in PLACES[r % n:] + PLACES[:r % n]:
                runs[place].append(_bare() if place == "bare" else plane.run_once(place))
        spans = tracing.read_spans(tracing.trace_dir())
        boots = {s["attrs"]["task_id"]: s for s in spans if s["name"] == "container.boot"}
        imports = {s["attrs"]["task_id"]: s for s in spans if s["name"] == "container.import_torch"}
        for place in PLACES[1:]:
            for run in runs[place]:
                if run["task_id"] not in imports:
                    raise RuntimeError(f"import_cost: {run['task_id']} wrote no container.import_torch span")
                run["spawn_to_hello_s"] = run.pop("started_at") - boots[run["task_id"]]["start"]
    finally:
        plane.close()
        synchronizer.run(sup.stop())
        shutil.rmtree(root, ignore_errors=True)

    for place, rs in runs.items():
        line = f"[import_cost] {place}: import torch {_summary([r['import_s'] for r in rs])}"
        if place != "bare":
            line += (f" (thread {rs[0]['thread']}, switch interval {rs[0]['switch_interval'] * 1e3:g} ms, "
                     f"import trace {'on' if rs[0]['import_trace'] else 'off'}); "
                     f"spawn → ContainerHello {_summary([r['spawn_to_hello_s'] for r in rs])}; "
                     f"FunctionMap → output {_summary([r['map_to_output_s'] for r in rs])}")
        print(line + f"; {len(rs)} rounds in turns", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    return runs


if __name__ == "__main__":
    main()
