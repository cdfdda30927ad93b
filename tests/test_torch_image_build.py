"""The port's image builder (modal_tpu_torch/server/image_builder.py and
builder/) against the JAX package's: tests/test_image_build.py's ten cases
run on the port's plane (a pip layer importable in the container and not
here, env and workdir, a loud failure, one build reused across functions,
run_function, the epochs known and pinned, the epoch in the chain hash, the
pin on a bare `pip install`, an unknown epoch failing, the epoch's env in
the container); the pure functions give the JAX package's answers on the
same inputs; a #PREWARM layer builds the kernels into the image (a stub
`nvcc` on the CPU), and on a card the prewarmed K4 loads with no build.

One port plane for the module (`worker_gpus=8, worker_gpu_type="local-sim"`):
images with the same layers share one content-addressed build across the
tests. User functions are defined inside each test, so cloudpickle takes
them by value.
"""

import json
import os
import stat
import sys
import tempfile

import pytest

import modal_tpu_torch
from modal_tpu.proto import api_pb2 as japi
from modal_tpu.server import image_builder as jib
from modal_tpu_torch import builder as epochs
from modal_tpu_torch._utils.async_utils import synchronizer as tsync
from modal_tpu_torch.client import _Client
from modal_tpu_torch.proto import api_pb2
from modal_tpu_torch.server import image_builder as tib
from modal_tpu_torch.server.supervisor import LocalSupervisor

HOST = f"{sys.version_info.major}.{sys.version_info.minor}"

# a stub nvcc: `--version` answers, a build writes its -o target and logs it
STUB_NVCC = """#!/bin/sh
if [ "$1" = "--version" ]; then echo "nvcc: stub, release 12.8"; exit 0; fi
echo "$@" >> "{log}"
while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then shift; echo "not a shared library" > "$1"; fi; shift; done
"""


class Plane:
    def __init__(self, root: str, simulated: bool = True):
        self.root = root
        # simulated cards, or the host's own (the worker probes nvidia-smi)
        cards = {"worker_gpus": 8, "worker_gpu_type": "local-sim"} if simulated else {}
        self.sup = LocalSupervisor(num_workers=1, state_dir=os.path.join(root, "port"), **cards)
        tsync.run(self.sup.start())
        self.client = _Client(self.sup.server_url)
        self.client._open()
        self.client.hello()
        _Client.set_env_client(self.client)
        self.pkg = _write_local_package(root, "modal_tpu_torch_img_probe", 41)

    def close(self):
        _Client.set_env_client(None)
        self.client._close()
        tsync.run(self.sup.stop())


def _write_local_package(root: str, name: str, value: int) -> str:
    """A minimal installable package (installed with --no-index
    --no-build-isolation against the host's setuptools: no network)."""
    pkg_root = os.path.join(root, f"{name}-src")
    os.makedirs(os.path.join(pkg_root, name))
    with open(os.path.join(pkg_root, name, "__init__.py"), "w") as f:
        f.write(f"VALUE = {value}\n")
    with open(os.path.join(pkg_root, "setup.py"), "w") as f:
        f.write(f"from setuptools import setup\nsetup(name={name!r}, version='0.1', packages=[{name!r}])\n")
    return pkg_root


@pytest.fixture(scope="module")
def plane():
    saved = os.environ.get("MODAL_TPU_HEARTBEAT_INTERVAL")
    os.environ["MODAL_TPU_HEARTBEAT_INTERVAL"] = "3"
    p = Plane(tempfile.mkdtemp(prefix="img-", dir="/tmp"))
    try:
        yield p
    finally:
        p.close()
        if saved is None:
            os.environ.pop("MODAL_TPU_HEARTBEAT_INTERVAL", None)
        else:
            os.environ["MODAL_TPU_HEARTBEAT_INTERVAL"] = saved


def _pip_image(plane):
    return modal_tpu_torch.Image.debian_slim().pip_install(plane.pkg, extra_options="--no-build-isolation --no-index")


# -- tests/test_image_build.py's cases on the port's plane -----------------------


def test_pip_install_materializes_in_container(plane):
    """A pip layer is importable in the container and stays absent from this
    process: the container runs the image's own python."""
    app = modal_tpu_torch.App("img-pip")

    def probe():
        import sys as _sys

        import modal_tpu_torch_img_probe

        return modal_tpu_torch_img_probe.VALUE, _sys.executable

    f = app.function(image=_pip_image(plane), serialized=True)(probe)
    with app.run(client=plane.client):
        value, python = f.remote()
    assert value == 41
    assert python.startswith(os.path.join(plane.sup.state_dir, "images")) and python.endswith("venv/bin/python")
    with pytest.raises(ImportError):
        import modal_tpu_torch_img_probe  # noqa: F401  (not in this environment)


def test_image_env_and_workdir(plane):
    image = modal_tpu_torch.Image.debian_slim().env({"IMG_FLAVOR": "gpu"}).workdir("/img-wd")
    app = modal_tpu_torch.App("img-env")

    def probe():
        import os as _os

        return {"flavor": _os.environ.get("IMG_FLAVOR"), "cwd_tail": _os.getcwd().split("/")[-1],
                "root": _os.environ.get("MODAL_TPU_IMAGE_ROOT", "")}

    f = app.function(image=image, serialized=True)(probe)
    with app.run(client=plane.client):
        out = f.remote()
    assert out["flavor"] == "gpu"
    assert out["cwd_tail"] == "img-wd"  # made under the image's rootfs
    assert out["root"].endswith("rootfs")


def test_image_build_failure_is_loud(plane):
    """A layer that cannot be honored fails the call with the build error
    and the log's tail: the function never runs in the worker's own
    environment."""
    marker = os.path.join(plane.root, "ran-anyway")
    image = modal_tpu_torch.Image.debian_slim().run_commands("echo building-the-layer && exit 3")
    app = modal_tpu_torch.App("img-fail")

    def probe():
        open(marker, "w").close()
        return 1

    f = app.function(image=image, serialized=True)(probe)
    with app.run(client=plane.client):
        with pytest.raises(Exception, match="image build failed") as exc_info:
            f.remote()
    assert "rc=3" in str(exc_info.value) and "building-the-layer" in str(exc_info.value)
    assert not os.path.exists(marker)
    failed = [t for t in plane.sup.state.tasks.values() if t.function_id == f.object_id]
    assert failed and all(t.result is not None and t.result.status == api_pb2.GENERIC_STATUS_INIT_FAILURE
                          for t in failed)


def test_image_build_cached_across_functions(plane):
    """The same layer chain is one content-addressed build, reused."""
    app = modal_tpu_torch.App("img-cache")

    def probe_a():
        import sys as _sys

        import modal_tpu_torch_img_probe

        return modal_tpu_torch_img_probe.VALUE, _sys.executable

    def probe_b():
        import sys as _sys

        import modal_tpu_torch_img_probe

        return modal_tpu_torch_img_probe.VALUE * 2, _sys.executable

    fa = app.function(image=_pip_image(plane), serialized=True)(probe_a)
    fb = app.function(image=_pip_image(plane), serialized=True)(probe_b)
    with app.run(client=plane.client):
        (a, python_a), (b, python_b) = fa.remote(), fb.remote()
    assert (a, b) == (41, 82) and python_a == python_b
    key = python_a.split(os.sep)[-4]
    with open(os.path.join(plane.sup.state_dir, "images", key, "build.log")) as f:
        assert f.read().count("creating venv") == 1


def test_run_function_build_step(plane):
    """run_function runs at build time with the image's python, and what it
    writes is there for the container (reference _image.py:2175)."""
    marker = os.path.join(plane.root, "built-marker.txt")

    def bake():
        import sys as _sys

        with open(marker, "w") as f:
            f.write(f"baked by {_sys.prefix}")

    image = modal_tpu_torch.Image.debian_slim().run_function(bake)
    app = modal_tpu_torch.App("img-runfn")

    def probe():
        import sys as _sys

        with open(marker) as f:
            return f.read(), _sys.prefix

    f = app.function(image=image, serialized=True)(probe)
    with app.run(client=plane.client):
        text, prefix = f.remote()
    assert text == f"baked by {prefix}" and prefix.endswith("venv")


def test_builder_epochs_known_and_pinned():
    from modal_tpu import builder as jepochs

    versions = epochs.known_versions()
    assert versions == jepochs.known_versions() == ("2026.04", "2026.07")
    pins = epochs.load_requirements("2026.07")
    assert pins["torch"].startswith("torch==") and pins["numpy"].startswith("numpy==")
    assert not {"jax", "flax", "optax", "orbax-checkpoint"} & set(pins)
    assert set(epochs.base_image_config("2026.07")) == {"python", "cuda_env"}
    assert HOST in epochs.base_image_config("2026.07")["python"]
    with pytest.raises(epochs.UnknownBuilderVersion):
        epochs.load_requirements("1999.01")
    # the image DSL's versions are the epoch files
    from modal_tpu_torch import image

    assert image._BUILDER_VERSIONS == list(versions)


def test_epoch_changes_image_chain_hash():
    """The same definition under two epochs hashes differently: the pin set
    is part of the content address, so an epoch bump rebuilds."""

    def chain(version):
        return [api_pb2.Image(dockerfile_commands=["FROM python:3.12"], version=version)]

    assert tib.chain_hash(chain("2026.04")) != tib.chain_hash(chain("2026.07"))
    assert tib.chain_hash(chain("2026.07")) == tib.chain_hash(chain("2026.07"))
    assert tib.chain_version(chain("2026.04")) == "2026.04"


def test_pip_install_gets_epoch_pin():
    from modal_tpu.builder import constrain_pip_install as jconstrain

    out = epochs.constrain_pip_install("/v/bin/python -m pip install einops requests", "2026.07")
    assert "einops==0.8.2" in out
    assert "requests" in out and "requests==" not in out  # unpinned passes through
    # einops is pinned alike in both packages' epoch: the same rewrite
    assert out == jconstrain("/v/bin/python -m pip install einops requests", "2026.07")
    assert "torch==" in epochs.constrain_pip_install("/v/bin/python -m pip install torch", "2026.07")
    # explicit constraints are the user's business
    assert "einops==0.7.0" in epochs.constrain_pip_install("/v/bin/python -m pip install einops==0.7.0", "2026.07")


def test_unknown_epoch_fails_build_loudly(plane, monkeypatch):
    # the client's configured epoch stamps every layer (image.py _load)
    monkeypatch.setenv("MODAL_TPU_IMAGE_BUILDER_VERSION", "1999.01")
    image = modal_tpu_torch.Image.debian_slim().env({"X": "1"})
    app = modal_tpu_torch.App("img-bad-epoch")

    def probe(x):
        return x

    f = app.function(image=image, serialized=True)(probe)
    with app.run(client=plane.client):
        with pytest.raises(Exception, match="1999.01"):
            f.remote(1)


def test_epoch_env_lands_in_container(plane):
    """The epoch's cuda_env is applied to built images (a real layer forces
    a build; a trivial chain runs in the worker's environment untouched)."""
    image = modal_tpu_torch.Image.debian_slim().env({"IMG_MARK": "1"})
    app = modal_tpu_torch.App("img-epoch-env")

    def read_env():
        import os as _os

        return _os.environ.get("CUDA_MODULE_LOADING", ""), _os.environ.get("IMG_MARK")

    f = app.function(image=image, serialized=True)(read_env)
    with app.run(client=plane.client):
        loading, mark = f.remote()
    assert mark == "1"
    assert loading == epochs.base_image_config("2026.07")["cuda_env"]["CUDA_MODULE_LOADING"]


def test_publish_base_images_runs_a_probe_on_each_base(plane):
    """global_objects: the epoch's python minors this host can build, as
    the JAX package computes them, and a probe function run on each base
    image through the real path."""
    from modal_tpu import global_objects as jglobal
    from modal_tpu_torch import global_objects

    for version in epochs.known_versions():
        assert global_objects.supported_python_versions(version) == jglobal.supported_python_versions(version)
    ids = global_objects.publish_base_images("2026.07", client=plane.client)
    assert len(ids) == 1 and ids[0].startswith("im-")
    assert plane.sup.state.images[ids[0]].definition.version == "2026.07"
    assert "MODAL_TPU_IMAGE_BUILDER_VERSION" not in os.environ


# -- the pure functions against the JAX package's ---------------------------------

RUN_COMMANDS = [
    "python -m pip install numpy",
    "pip install einops==0.8.2 'requests>=2'",
    "uv pip install --system torch --index-url https://download.pytorch.org/whl/cu128",
    "uv pip install rich",
    "python -c 'print(1)'",
    "python3 -c 'print(1)'",
    "echo python -m pip install nothing",
    "apt-get install -y curl",
    "pythonic --flag",
]


@pytest.mark.parametrize("cmd", RUN_COMMANDS)
def test_rewrite_run_equals_jax(cmd):
    for python_bin in ("/img/venv/bin/python", "/path with space/venv/bin/python"):
        assert tib._rewrite_run(cmd, python_bin) == jib._rewrite_run(cmd, python_bin)


@pytest.mark.parametrize("value", ["plain", "'quoted value'", '"double quoted"', "two words", "'unbalanced",
                                   "  padded  ", "", "a=b"])
def test_unquote_equals_jax(value):
    assert tib._unquote(value) == jib._unquote(value)


def _chains() -> list[list[api_pb2.Image]]:
    other = "3.11" if HOST != "3.11" else "3.12"
    return [
        [api_pb2.Image(dockerfile_commands=[f"FROM python:{HOST}-slim-bookworm"])],
        [api_pb2.Image(dockerfile_commands=[f"FROM python:{other}-slim-bookworm"])],
        [api_pb2.Image(dockerfile_commands=[f"FROM python:{HOST}-slim-bookworm", "#MOUNT_PYTHON_SOURCE pkg"])],
        [api_pb2.Image(dockerfile_commands=[f"FROM python:{HOST}"]),
         api_pb2.Image(dockerfile_commands=["FROM im-00000001", "ENV A=1"])],
        [api_pb2.Image(dockerfile_commands=[f"FROM python:{HOST}"]),
         api_pb2.Image(dockerfile_commands=["FROM im-00000001", "#PREWARM"], build_function_serialized=b"fn")],
        [api_pb2.Image(dockerfile_commands=["FROM nvidia/cuda:12.4.1-devel-ubuntu22.04"])],
        [api_pb2.Image(dockerfile_commands=["", f"FROM python:{HOST}", "FROM im-00000002"])],
        [api_pb2.Image(fs_snapshot_blob_id="bl-1")],
    ]


@pytest.mark.parametrize("i", range(8))
def test_is_trivial_equals_jax(i):
    """The same chains, parsed from the same bytes in both packages."""
    chain = _chains()[i]
    jchain = [japi.Image.FromString(im.SerializeToString()) for im in chain]
    assert tib._is_trivial(chain) == jib._is_trivial(jchain)


# -- #PREWARM ---------------------------------------------------------------------


@pytest.fixture
def stub_nvcc(plane, monkeypatch):
    """A stub nvcc first on PATH of this process, the worker's build
    subprocesses and the containers; returns a function giving its builds."""
    from modal_tpu_torch.ops import _build

    bindir = tempfile.mkdtemp(prefix="nvcc-", dir=plane.root)
    log = os.path.join(bindir, "builds.log")
    script = os.path.join(bindir, "nvcc")
    with open(script, "w") as f:
        f.write(STUB_NVCC.format(log=log))
    os.chmod(script, os.stat(script).st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "_nvcc_versions", {})

    def builds() -> list[str]:
        if not os.path.exists(log):
            return []
        with open(log) as f:
            return f.read().splitlines()

    return builds


def _prewarm_probe(marker: str):
    def bake():
        import json as _json
        import os as _os

        _os.environ["MODAL_TPU_AOT_LOWER"] = "decode,cfg=tiny"
        from modal_tpu_torch.runtime.aot import maybe_aot_lower

        report = maybe_aot_lower()
        with open(marker, "w") as f:
            _json.dump({"report": report, "env": {k: _os.environ.get(k, "") for k in (
                "TORCH_EXTENSIONS_DIR", "MODAL_TPU_PREWARM_BUILD", "MODAL_TPU_IMAGE_ROOT", "MODAL_TPU_IMAGE_BUILD")}},
                f)

    def serve():
        import os as _os

        _os.environ["MODAL_TPU_AOT_LOWER"] = "decode,cfg=tiny"
        from modal_tpu_torch.observability.catalog import COMPILE_EVENTS
        from modal_tpu_torch.runtime.aot import maybe_aot_lower

        report = maybe_aot_lower()
        return {"build_dir": _os.environ.get("TORCH_EXTENSIONS_DIR", ""),
                "root": _os.environ.get("MODAL_TPU_IMAGE_ROOT", ""),
                "sources": report["decode"]["sources"], "events": COMPILE_EVENTS.snapshot()}

    return bake, serve


def test_prewarm_builds_the_kernels_into_the_image(plane, stub_nvcc):
    """A #PREWARM layer runs its function with the kernel build dir under
    the image's rootfs and records it as image env: the bake's builds count
    as COMPILE_EVENTS{source="prewarm"}, merged into the plane's registry,
    and are published to the fleet store; a container of the image finds
    the library in its build dir ("local") and builds nothing."""
    from modal_tpu_torch.observability.catalog import COMPILE_EVENTS
    from modal_tpu_torch.ops import _build

    marker = os.path.join(plane.root, "prewarm.json")
    bake, serve = _prewarm_probe(marker)
    before = COMPILE_EVENTS.snapshot()
    image = modal_tpu_torch.Image.debian_slim().env({"IMG_PREWARM": "1"}).prewarm(bake)
    app = modal_tpu_torch.App("img-prewarm")
    f = app.function(image=image, serialized=True)(serve)
    with app.run(client=plane.client):
        out = f.remote()
    with open(marker) as fh:
        baked = json.load(fh)
    build_dir = baked["env"]["TORCH_EXTENSIONS_DIR"]
    assert build_dir == os.path.join(baked["env"]["MODAL_TPU_IMAGE_ROOT"], "cache", "kernels")
    assert baked["env"]["MODAL_TPU_PREWARM_BUILD"] == "1" and baked["env"]["MODAL_TPU_IMAGE_BUILD"] == "1"
    assert baked["report"]["decode"]["sources"] == {"paged_decode": "nvcc"}
    assert len(stub_nvcc()) == 1  # one build, at build time
    after = COMPILE_EVENTS.snapshot()
    for event in ("compile,prewarm", "cache_miss,prewarm"):
        assert after.get(event, 0) - before.get(event, 0) == 1, (event, before, after)
    # the container: the image's build dir, the library there, nothing built
    assert out["build_dir"] == build_dir and out["root"] == baked["env"]["MODAL_TPU_IMAGE_ROOT"]
    assert out["sources"] == {"paged_decode": "local"}
    assert not any(k.startswith(("compile,", "cache_miss,")) for k in out["events"]), out["events"]
    assert len(stub_nvcc()) == 1
    # published to the fleet store under the library's key
    libs = [n for n in os.listdir(build_dir) if n.endswith(".so")]
    assert len(libs) == 1 and libs[0].startswith("paged_decode-tc-")
    key = libs[0][len("paged_decode-"):-len(".so")]
    assert plane.sup.state.compile_cache.has(key)
    assert key == _build.cache_key("paged_decode")


@pytest.mark.cuda
def test_a_prewarmed_k4_loads_in_the_container_with_no_build():
    """On a card: a prewarm builds K4 with the real nvcc into the image, and
    a container of the image launches it with no cache_miss and no nvcc
    run, its library loaded from under the image's rootfs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    p = Plane(tempfile.mkdtemp(prefix="img-cuda-", dir="/tmp"), simulated=False)
    try:
        def bake():
            import os as _os

            _os.environ["MODAL_TPU_AOT_LOWER"] = "decode,cfg=tiny"
            from modal_tpu_torch.runtime.aot import maybe_aot_lower

            assert "errors" not in maybe_aot_lower()

        def launch():
            import os as _os

            import torch as _torch

            from modal_tpu_torch.observability.catalog import COMPILE_EVENTS
            from modal_tpu_torch.observability.device_telemetry import install_compile_hooks
            from modal_tpu_torch.ops import _build
            from modal_tpu_torch.ops.paged_attention import paged_decode_attention

            install_compile_hooks()
            q = _torch.randn(2, 2, 2, 64, device="cuda", dtype=_torch.bfloat16)
            k = _torch.randn(9, 16, 2, 64, device="cuda", dtype=_torch.bfloat16)
            pt = _torch.tensor([[1, 2], [3, 4]], dtype=_torch.int32, device="cuda")
            lens = _torch.tensor([20, 7], dtype=_torch.int32, device="cuda")
            paged_decode_attention(q, k, k, pt, lens)
            _torch.cuda.synchronize()
            return {"events": COMPILE_EVENTS.snapshot(), "lib": _build._libs["paged_decode"]._name,
                    "root": _os.environ["MODAL_TPU_IMAGE_ROOT"], "launches": _build.LAUNCHES["paged_decode"]}

        app = modal_tpu_torch.App("img-cuda")
        f = app.function(image=modal_tpu_torch.Image.debian_slim().prewarm(bake), serialized=True, gpu="H100")(launch)
        with app.run(client=p.client):
            out = f.remote()
        assert out["launches"] == 1 and out["lib"].startswith(os.path.join(out["root"], "cache", "kernels"))
        assert not any(k.startswith(("compile,", "cache_miss,")) for k in out["events"]), out["events"]
    finally:
        p.close()
