"""Every example under modal_tpu_torch/examples/ runs, as the JAX package's
examples do in tests/test_examples.py: each as a user would run it, a
script in a subprocess, against a port plane that this file starts
(`LocalSupervisor` with simulated cards). Those that touch a tensor are
asked for the CPU by the means each offers: 02 through its local
entrypoint's `device` (the class's `parameter()`), 04 by `--device cpu`.
06 serves on the card only: its case holds the App it defines."""

import importlib.util
import os
import subprocess
import sys
import tempfile

import pytest

from modal_tpu_torch._utils.async_utils import synchronizer
from modal_tpu_torch.server.supervisor import LocalSupervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "modal_tpu_torch", "examples")


@pytest.fixture(scope="module")
def plane():
    sup = LocalSupervisor(num_workers=1, state_dir=tempfile.mkdtemp(prefix="examples-", dir="/tmp"), worker_gpus=8,
                          worker_gpu_type="local-sim")
    synchronizer.run(sup.start())
    try:
        yield sup
    finally:
        synchronizer.run(sup.stop())


def _run_example(name: str, plane, *args: str) -> str:
    env = dict(os.environ)
    env.update({"MODAL_TPU_SERVER_URL": plane.server_url,
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    out = subprocess.run([sys.executable, os.path.join(EXAMPLES, name), *args], capture_output=True, text=True,
                         timeout=240, env=env)
    assert out.returncode == 0, f"{name} failed:\n{out.stdout}\n{out.stderr[-2000:]}"
    return out.stdout


def test_example_hello_world(plane):
    out = _run_example("01_hello_world.py", plane)
    assert "square(12) = 144" in out
    assert "[0, 1, 4, 9, 16]" in out


@pytest.mark.slow  # as JAX's decode example (tests/test_examples.py)
def test_example_gpu_decode(plane):
    out = _run_example("02_gpu_decode.py", plane, "cpu")
    assert "decoded tokens:" in out and "decode wall time:" in out


def test_example_clustered(plane):
    out = _run_example("03_clustered_training.py", plane)
    assert "'world': 2" in out and "'sum': 1.0" in out and "'backend': 'gloo'" in out


def test_example_volumes(plane):
    out = _run_example("04_volumes_and_checkpoints.py", plane, "--device", "cpu")
    assert "exported" in out and "restored param leaves:" in out and "on cpu" in out


def test_example_sandbox(plane):
    out = _run_example("05_sandbox_and_sidecars.py", plane)
    assert "hello-from-sandbox" in out
    assert "via shared fs: sidecar-wrote-this" in out


def test_example_serving_defines_its_service_on_a_card():
    """06 builds its service when imported and serves on the card only:
    the class it registers, its options and its `gpu`."""
    spec = importlib.util.spec_from_file_location("example_06_serving", os.path.join(EXAMPLES, "06_serving.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.app.name == "example-serving"
    assert list(mod.app.registered_classes) == ["TinyLLM"]
    spec_ = mod.Service._service_function.spec
    assert str(spec_.gpu) == "H100"
    assert (spec_.min_containers, spec_.max_containers) == (1, 4)
    assert (spec_.target_ttft_ms, spec_.target_tokens_per_replica) == (500, 2000)
