"""A container whose boot raises reports `GENERIC_STATUS_INIT_FAILURE`, so
the plane fails the function's backlog after two such boots and the call
raises. This is the port's own rule: the JAX package's container reports
FAILURE (`modal_tpu/runtime/container_entrypoint.py:587`), and its plane
respawns the class without end. A SIGTERM during `@enter` stays TERMINATED,
and an error in the user's function body stays a FAILURE of that input.

One plane of the port for the module (`worker_gpu_type="local-sim"`); each
case builds its own app, and its user classes are defined inside the test so
cloudpickle takes them by value."""

import os
import tempfile
import time

import pytest

import modal_tpu_torch as m
from modal_tpu_torch._utils.async_utils import synchronizer
from modal_tpu_torch.client import _Client
from modal_tpu_torch.exception import RemoteError
from modal_tpu_torch.proto import api_pb2
from modal_tpu_torch.server.supervisor import LocalSupervisor


@pytest.fixture(scope="module")
def plane():
    root = tempfile.mkdtemp(prefix="initfail-", dir="/tmp")
    sup = LocalSupervisor(num_workers=1, state_dir=root, worker_gpus=1, worker_gpu_type="local-sim")
    synchronizer.run(sup.start())
    client = _Client(sup.server_url)
    client._open()
    try:
        yield sup, client, root
    finally:
        client._close()
        synchronizer.run(sup.stop())


def _tasks(sup, app_id: str) -> list:
    return [t for t in list(sup.state.tasks.values()) if t.app_id == app_id]


def _wait_finished(sup, app_id: str, timeout: float = 30.0) -> list:
    deadline = time.monotonic() + timeout
    while any(not t.finished_at for t in _tasks(sup, app_id)):
        assert time.monotonic() < deadline, f"the tasks of {app_id} did not finish in {timeout}s"
        time.sleep(0.1)
    return _tasks(sup, app_id)


def test_a_class_whose_enter_raises_fails_its_call_after_two_boots(plane):
    sup, client, _root = plane
    app = m.App("enter-raises")

    @app.cls(serialized=True)
    class Broken:
        @m.enter()
        def load(self):
            raise RuntimeError("no weights here")

        @m.method()
        def predict(self, x):
            return x

    with app.run(client=client):
        t0 = time.monotonic()
        with pytest.raises(RemoteError, match="RuntimeError: no weights here"):
            Broken().predict.remote(1)
        seconds = time.monotonic() - t0
        app_id = app.app_id
    assert seconds < 30.0
    tasks = _wait_finished(sup, app_id)
    assert len(tasks) == 2
    assert [t.result.status for t in tasks] == [api_pb2.GENERIC_STATUS_INIT_FAILURE] * 2
    assert all("no weights here" in t.result.exception for t in tasks)


def test_a_sigterm_during_enter_stays_terminated(plane):
    sup, client, root = plane
    app = m.App("enter-stopped")
    marker = os.path.join(root, "entered")

    @app.cls(serialized=True)
    class Slow:
        @m.enter()
        def load(self):
            import time as _time

            open(marker, "w").close()
            _time.sleep(120)

        @m.method()
        def predict(self, x):
            return x

    with app.run(client=client):
        Slow().predict.spawn(1)
        deadline = time.monotonic() + 30
        while not os.path.exists(marker):
            assert time.monotonic() < deadline, "@enter never started"
            time.sleep(0.1)
        app_id = app.app_id
    tasks = _wait_finished(sup, app_id)
    assert len(tasks) == 1
    assert tasks[0].result.status == api_pb2.GENERIC_STATUS_TERMINATED


def test_an_error_in_the_function_body_stays_a_failure(plane):
    sup, client, _root = plane
    app = m.App("body-raises")

    @app.cls(serialized=True)
    class Model:
        @m.enter()
        def load(self):
            self.scale = 2

        @m.method()
        def predict(self, x):
            if x < 0:
                raise ValueError(f"negative {x}")
            return self.scale * x

    with app.run(client=client):
        model = Model()
        with pytest.raises(ValueError, match="negative -1"):
            model.predict.remote(-1)
        assert model.predict.remote(3) == 6
        app_id = app.app_id
    tasks = _wait_finished(sup, app_id)
    assert len(tasks) == 1
    assert tasks[0].result.status != api_pb2.GENERIC_STATUS_INIT_FAILURE
    fn = sup.state.functions[tasks[0].function_id]
    assert fn.init_failures == 0
