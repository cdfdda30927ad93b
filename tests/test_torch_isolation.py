"""The PyTorch port stands alone: it imports neither `jax`, `optax` nor the
JAX package, serves, trains and snapshots without them, and its entry
points default to CUDA. The cold-start modules (runtime, observability,
the compile store and keys) also import none of the SDK core's network
packages (grpc, protobuf, aiohttp); they may pickle with cloudpickle, and
importing the package loads neither grpc nor protobuf."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "modal_tpu_torch")


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "modal_tpu", "flax", "optax", "ml_dtypes")


def test_no_source_of_the_port_imports_jax_or_modal_tpu():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert len(_port_sources()) > 10
    assert not offenders, offenders


def _imports_of(source: str, where: str) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(source, where)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("prewarm", [False, True], ids=["run_function", "prewarm"])
def test_the_image_builders_runner_script_imports_no_jax_or_modal_tpu(prewarm):
    """The script a build function runs in, under the image's python (the
    image builder writes it at build time, so the file scan cannot see it),
    imports the port's serialization and telemetry, never jax or the JAX
    package."""
    from modal_tpu_torch.server.image_builder import runner_script

    source = runner_script("/x/build_fn.pkl", REPO, "/x/events.json" if prewarm else "")
    names = _imports_of(source, "build_fn.py")
    assert "modal_tpu_torch.serialization" in names
    assert ("modal_tpu_torch.observability.catalog" in names) == prewarm
    assert not [n for n in names if _forbidden(n)], names


# the network packages of the SDK core, which the cold-start modules do not need
SDK_PACKAGES = ("grpc", "google.protobuf", "aiohttp")
COLD_START_MODULES = ("runtime", "observability", os.path.join("server", "compile_cache.py"),
                      os.path.join("_utils", "compile_keys.py"))


def test_cold_start_modules_import_no_sdk_package():
    offenders, scanned = [], 0
    for rel in COLD_START_MODULES:
        path = os.path.join(PKG, rel)
        files = [path] if path.endswith(".py") else [
            os.path.join(path, n) for n in sorted(os.listdir(path)) if n.endswith(".py")]
        for f in files:
            scanned += 1
            with open(f) as fh:
                tree = ast.parse(fh.read(), f)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                offenders += [f"{os.path.relpath(f, REPO)}:{node.lineno} {n}" for n in names
                              if any(n == p or n.startswith(p + ".") for p in SDK_PACKAGES)]
    assert scanned >= 12
    assert not offenders, offenders


def test_port_serves_with_jax_and_modal_tpu_unimportable(tmp_path):
    """Serve, speculate, ship, train (a dense and a tiny-moe step, and an
    fsdp step in 2 spawned gloo ranks, which re-run the script's top level
    and so refuse the same imports), checkpoint, quantize, sample, and save
    and restore a debug-1l snapshot with the fleet compile cache and its
    telemetry installed and a lambda in its state, grpc, protobuf and aiohttp
    unimportable too."""
    header = textwrap.dedent(
        """
        import sys
        for name in ("jax", "jaxlib", "modal_tpu", "optax", "ml_dtypes", "grpc", "google.protobuf",
                     "aiohttp"):
            sys.modules[name] = None  # any import of them raises ImportError


        def fsdp_rank(rank, world):
            from modal_tpu_torch.parallel.train import train_demo

            m = train_demo("tiny", {"fsdp": 2}, steps=1, seq_len=32, device="cpu")
            leaked = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "modal_tpu", "optax") and sys.modules[n] is not None)
            assert not leaked, leaked
            if rank == 0:
                print("fsdp step", m["loss"], flush=True)
        """
    )
    body = textwrap.dedent(
        """
        import modal_tpu_torch
        from modal_tpu_torch.models.llama import get_config, init_params
        from modal_tpu_torch.serving import ServingEngine

        cfg = get_config("debug-1l")
        params = init_params(cfg, seed=0, device="cpu")
        engine = ServingEngine(params, cfg, max_slots=2, num_pages=9, page_size=8,
                               pages_per_slot=4, prefill_chunk=16, device="cpu").start()
        try:
            outs = [engine.submit([1, 2, 3 + i], 5).result(timeout=120) for i in range(2)]
        finally:
            engine.stop()
        assert [len(o) for o in outs] == [5, 5], outs
        print("served", outs)

        from modal_tpu_torch.serving import shipment
        geometry = dict(max_slots=2, num_pages=9, page_size=8, pages_per_slot=4, prefill_chunk=16,
                        device="cpu")
        spec = ServingEngine(params, cfg, draft=(params, cfg), spec_k=2, **geometry).start()
        pre = ServingEngine(params, cfg, role="prefill", **geometry).start()
        try:
            assert len(spec.submit([1, 2, 3], 6).result(timeout=120)) == 6
            req = pre.prefill_export(list(range(1, 12)))
            req.result(timeout=120)
            bundle = shipment.decode(shipment.encode(req.shipment))
            got = spec.submit_prefilled(list(range(1, 12)), bundle, 4).result(timeout=120)
        finally:
            spec.stop()
            pre.stop()
        assert len(got) == 4 and spec.stats()["remote_prefills"] == 1
        print("speculated and shipped")

        from modal_tpu_torch.parallel.train import TrainConfig, create_state
        import torch
        state, train_step = create_state(get_config("tiny"), TrainConfig(), seed=0, device="cpu")
        state, metrics = train_step(state, torch.randint(0, 512, (1, 128)))
        assert metrics["step"] == 1 and float(metrics["loss"]) > 0, metrics
        print("trained", float(metrics["loss"]))
        state, train_step = create_state(get_config("tiny-moe"), TrainConfig(), seed=0, device="cpu")
        state, metrics = train_step(state, torch.randint(0, 512, (1, 64)))
        assert metrics["step"] == 1 and float(metrics["loss"]) > 0, metrics
        from modal_tpu_torch.parallel.mesh import spawn
        spawn(fsdp_rank, 2)
        print("trained moe and fsdp")

        import tempfile
        from modal_tpu_torch.models import quant, sampling, weights
        from modal_tpu_torch.models.llama import init_params_abstract
        from modal_tpu_torch.runtime import aot
        tiny = get_config("tiny")
        with tempfile.TemporaryDirectory() as ckpt:
            weights.export_checkpoint(init_params(tiny, seed=0, device="cpu"), tiny, ckpt, max_shard_bytes=1 << 18)
            state, _step = create_state(tiny, TrainConfig(), device="cpu", checkpoint=ckpt)
            loaded = weights.load_params(ckpt, tiny, device="cpu")
        assert torch.equal(state.params["layers"][0]["wq"], loaded["layers"]["wq"][0])
        qparams = quant.init_params_quantized(tiny, fast_host_init=True, device="cpu")
        assert quant.quantized_bytes(qparams) < quant.quantized_bytes(init_params_abstract(tiny))
        out = sampling.sample_generate(loaded, tiny, torch.tensor([[1, 2, 3]]), 4,
                                       generator=torch.Generator().manual_seed(0), top_k=5, cache_len=16)
        assert out.shape == (1, 7)
        assert aot.parse_aot_spec("decode,cfg=tiny") == (["decode"], {**aot._DEFAULTS, "cfg": "tiny"})
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "modal_tpu", "optax") and sys.modules[m] is not None)
        assert not leaked, leaked
        print("checkpointed, quantized, sampled")

        import os
        from modal_tpu_torch.observability import device_telemetry
        from modal_tpu_torch.runtime import snapshot

        class Replica:
            pass

        with tempfile.TemporaryDirectory() as state:
            os.environ["MODAL_TPU_SNAPSHOT_DIR"] = os.path.join(state, "snapshots")
            os.environ["MODAL_TPU_COMPILE_CACHE_DIR"] = state
            assert device_telemetry.install_compile_hooks() and device_telemetry.maybe_install_fleet_cache()
            rep = Replica()
            rep.params, rep.cfg = init_params(cfg, seed=0, device="cpu"), cfg
            rep.post = lambda toks: toks[:2]
            assert snapshot.save_snapshot(b"debug-1l replica", rep)
            got = Replica()
            assert snapshot.restore_snapshot(b"debug-1l replica", got)
            assert got.cfg == cfg and torch.equal(got.params["layers"]["wq"], rep.params["layers"]["wq"])
            assert got.post([7, 8, 9]) == [7, 8]
            assert device_telemetry.container_report()
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "modal_tpu", "optax", "grpc", "aiohttp") and sys.modules[m] is not None)
        assert not leaked, leaked
        print("snapshot saved and restored")
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["PYTHONPATH"] = REPO
    # the spawned ranks re-run the file's top level: the body runs in main() only
    script = header + "\n\ndef main():\n" + textwrap.indent(body, "    ") + "\n\nif __name__ == '__main__':\n    main()\n"
    path = tmp_path / "port_alone.py"
    path.write_text(script)
    proc = subprocess.run(
        [sys.executable, str(path)], cwd=REPO, env=env, capture_output=True, text=True, timeout=240
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "served" in proc.stdout and "trained" in proc.stdout
    assert "trained moe and fsdp" in proc.stdout and "fsdp step" in proc.stdout
    assert "speculated and shipped" in proc.stdout
    assert "checkpointed, quantized, sampled" in proc.stdout
    assert "snapshot saved and restored" in proc.stdout


def test_the_control_plane_serves_a_container_with_jax_and_modal_tpu_unimportable(tmp_path):
    """The port's supervisor, worker and a container answer an input with
    jax, optax and the JAX package unimportable in the parent and in the
    container alike (a `sitecustomize` on PYTHONPATH blocks them in every
    interpreter the worker spawns): once over raw RPCs, once through
    `App.run()` and `.remote()`."""
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'modal_tpu', 'optax', 'ml_dtypes'):\n"
        "    sys.modules[name] = None  # any import of them raises ImportError\n"
    )
    code = textwrap.dedent(
        """
        import sys, time
        from modal_tpu_torch._utils.async_utils import synchronizer
        from modal_tpu_torch._utils.grpc_utils import retry_transient_errors
        from modal_tpu_torch.client import _Client
        from modal_tpu_torch.proto import api_pb2
        from modal_tpu_torch.serialization import deserialize, serialize
        from modal_tpu_torch.server.supervisor import LocalSupervisor

        def probe(x):
            import sys as _sys
            import modal_tpu_torch.runtime.container_entrypoint  # noqa: F401 — already loaded
            try:
                import jax  # noqa: F401
                blocked = False
            except ImportError:
                blocked = True
            leaked = sorted(m for m in _sys.modules if m.split(".")[0] in ("jax", "modal_tpu")
                            and _sys.modules[m] is not None)
            return {"x": x + 1, "blocked": blocked, "leaked": leaked}

        sup = LocalSupervisor(num_workers=1, state_dir=sys.argv[1], worker_gpus=1, worker_gpu_type="local-sim")
        synchronizer.run(sup.start())
        client = _Client(sup.server_url)
        client._open()

        def call(name, req):
            return synchronizer.run(retry_transient_errors(getattr(client.stub, name), req))

        try:
            app = call("AppCreate", api_pb2.AppCreateRequest())
            fdef = api_pb2.Function(function_name="probe", definition_type="serialized",
                                    function_serialized=serialize(probe))
            fn = call("FunctionCreate", api_pb2.FunctionCreateRequest(app_id=app.app_id, function=fdef))
            item = api_pb2.FunctionPutInputsItem(idx=0, input=api_pb2.FunctionInput(args=serialize(((41,), {}))))
            fc = call("FunctionMap", api_pb2.FunctionMapRequest(function_id=fn.function_id, pipelined_inputs=[item]))
            for _ in range(12):
                out = call("FunctionGetOutputs", api_pb2.FunctionGetOutputsRequest(
                    function_call_id=fc.function_call_id, timeout=10, clear_on_success=True)).outputs
                if out:
                    break
            result = out[0].result
            assert result.status == api_pb2.GENERIC_STATUS_SUCCESS, result.traceback
            print("container", deserialize(result.data))
            import modal_tpu_torch

            app = modal_tpu_torch.App("isolated")
            f = app.function(serialized=True)(probe)
            with app.run(client=client):
                print("app", f.remote(1))
        finally:
            client._close()
            synchronizer.run(sup.stop())
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "modal_tpu") and sys.modules[m] is not None)
        assert not leaked, leaked
        print("parent clean")
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["PYTHONPATH"] = os.pathsep.join([str(block), REPO])
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "state")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "container {'x': 42, 'blocked': True, 'leaked': []}" in proc.stdout
    assert "app {'x': 2, 'blocked': True, 'leaked': []}" in proc.stdout
    assert "parent clean" in proc.stdout


def test_every_module_of_the_port_is_scanned():
    """The modules of each slice, this one's included, are among the sources
    the import scan reads (a new module cannot slip past it)."""
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in ("models/weights.py", "models/quant.py", "models/sampling.py", "runtime/aot.py",
                "runtime/__init__.py", "serving/api.py", "ops/_build.py", "tools/profile_serving.py",
                "tools/import_cost.py",
                "parallel/mesh.py", "parallel/sharding.py", "parallel/spmd.py", "parallel/moe.py",
                "parallel/pipeline.py", "parallel/ring_attention.py", "runtime/snapshot.py",
                "runtime/compile_client.py", "runtime/telemetry.py", "server/compile_cache.py",
                "_utils/compile_keys.py", "observability/device_telemetry.py", "exception.py",
                "gpu_config.py", "retries.py", "client.py", "object.py", "serialization.py", "_logs.py",
                "_output.py", "proto/rpc.py", "proto/regen.py", "proto/api_pb2.py", "_utils/async_utils.py",
                "_utils/grpc_utils.py", "_utils/hash_utils.py", "_utils/cbor.py", "_utils/jwt_utils.py",
                "_utils/auth_token_manager.py", "_utils/traceback_utils.py", "_utils/blob_utils.py",
                "partial_function.py", "server/state.py", "server/scheduler.py", "server/services.py",
                "server/blob_server.py", "server/worker.py", "server/supervisor.py", "server/__main__.py",
                "runtime/execution_context.py", "runtime/main_thread_exec.py", "runtime/io_manager.py",
                "runtime/user_code.py", "runtime/container_entrypoint.py", "server/journal.py",
                "_utils/local_transport.py", "app.py", "functions.py", "cls.py", "runner.py", "parallel_map.py",
                "running_app.py", "image.py", "mount.py", "secret.py", "schedule.py", "file_pattern_matcher.py",
                "_utils/function_utils.py", "_utils/type_manager.py", "server/cron.py",
                "_utils/coalescer.py", "runtime/asgi.py", "serving/service.py", "serving/router.py",
                "serving/reload.py", "cli/__init__.py", "cli/import_refs.py", "server/task_router.py",
                "server/warm_pool.py", "server/fs_snapshot.py", "_utils/router_client.py", "_utils/pty_shell.py",
                "sandbox.py", "sandbox_fs.py", "container_process.py", "snapshot.py", "tunnel.py",
                "volume.py", "checkpoint.py", "network_file_system.py", "cloud_bucket_mount.py", "_utils/s3.py",
                "runtime/bucket_mounts.py", "runtime/clustered.py", "observability/quantile.py",
                "observability/timeseries.py", "observability/slo.py", "observability/profiler.py",
                "server/history.py", "builder/__init__.py", "server/image_builder.py", "global_objects.py",
                "dict.py", "queue.py", "proxy.py", "environments.py", "workspace.py", "cli/entry_point.py",
                "cli/__main__.py", "chaos.py", "observability/critical_path.py",
                "observability/flight_recorder.py", "server/input_plane.py", "server/replication.py",
                "server/shards.py", "_utils/shard_router.py", "_utils/shard_routing.py",
                "observability/federation.py", "tools/compare_smoke.py", "analysis/__init__.py",
                "analysis/core.py", "analysis/concurrency.py", "analysis/donation.py", "analysis/jit_purity.py",
                "analysis/knob_catalog.py", "analysis/knobs.py", "experimental/__init__.py",
                "experimental/flash.py", "_native/__init__.py", "docs_gen/__init__.py", "docs_gen/__main__.py",
                "examples/__init__.py", "examples/01_hello_world.py", "examples/02_gpu_decode.py",
                "examples/03_clustered_training.py", "examples/04_volumes_and_checkpoints.py",
                "examples/05_sandbox_and_sidecars.py", "examples/06_serving.py"):
        assert os.path.join("modal_tpu_torch", rel) in scanned, rel


@pytest.mark.parametrize("module", ["modal_tpu_torch.client", "modal_tpu_torch.server.supervisor",
                                    "modal_tpu_torch.server.worker",
                                    "modal_tpu_torch.runtime.container_entrypoint", "modal_tpu_torch.app",
                                    "modal_tpu_torch.functions", "modal_tpu_torch.cls", "modal_tpu_torch.runner",
                                    "modal_tpu_torch.parallel_map", "modal_tpu_torch.serving",
                                    "modal_tpu_torch.serving.service", "modal_tpu_torch.serving.router",
                                    "modal_tpu_torch.runtime.asgi", "modal_tpu_torch.cli.import_refs",
                                    "modal_tpu_torch.server.task_router", "modal_tpu_torch.server.warm_pool",
                                    "modal_tpu_torch.sandbox", "modal_tpu_torch.container_process",
                                    "modal_tpu_torch.sandbox_fs", "modal_tpu_torch.tunnel",
                                    "modal_tpu_torch.volume", "modal_tpu_torch.checkpoint",
                                    "modal_tpu_torch.runtime.clustered", "modal_tpu_torch.network_file_system",
                                    "modal_tpu_torch.cloud_bucket_mount", "modal_tpu_torch.runtime.bucket_mounts",
                                    "modal_tpu_torch.server.history", "modal_tpu_torch.observability.slo",
                                    "modal_tpu_torch.observability.timeseries",
                                    "modal_tpu_torch.observability.profiler",
                                    "modal_tpu_torch.server.image_builder", "modal_tpu_torch.dict",
                                    "modal_tpu_torch.queue", "modal_tpu_torch.proxy",
                                    "modal_tpu_torch.workspace", "modal_tpu_torch.global_objects",
                                    "modal_tpu_torch.cli.entry_point", "modal_tpu_torch.chaos",
                                    "modal_tpu_torch.observability.critical_path",
                                    "modal_tpu_torch.observability.flight_recorder",
                                    "modal_tpu_torch.server.input_plane", "modal_tpu_torch.server.replication",
                                    "modal_tpu_torch.server.shards", "modal_tpu_torch._utils.shard_router",
                                    "modal_tpu_torch._utils.shard_routing",
                                    "modal_tpu_torch.observability.federation", "modal_tpu_torch.analysis",
                                    "modal_tpu_torch.experimental", "modal_tpu_torch._native",
                                    "modal_tpu_torch._utils.hash_utils", "modal_tpu_torch.docs_gen"])
def test_the_function_path_loads_no_torch_at_import(module):
    """The client, the App layer, the control plane, the worker, its router
    and warm pool, the sandbox client, Volumes and their checkpointer, the
    storage mounts, the gang runtime, the metrics plane, the command line,
    chaos, the flight recorder, the input plane, the shard fleet with its
    replication, routing and federation, the static analysis, Flash, the
    native block hasher, the docs generator, and a container's entrypoint import no torch:
    a container sends its hello before torch loads (a `gpu=` function's
    container loads it after the hello, a warm-pool interpreter while
    parked), and a user's file that builds an App loads none."""
    code = f"import sys, {module}\nassert 'torch' not in sys.modules, 'torch loaded'\nprint('clean')\n"
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-3000:]


def test_importing_the_package_and_its_pickler_loads_no_grpc_or_protobuf():
    """`import modal_tpu_torch` stays free of the SDK's network stack, and so
    does the serialization module a snapshot pickles with (the wire
    contract loads only when a data-format function asks for it)."""
    code = textwrap.dedent(
        """
        import sys

        def network():
            return sorted(m for m in sys.modules if m.split(".")[0] in ("grpc", "aiohttp")
                          or m == "google.protobuf" or m.startswith("google.protobuf."))

        import modal_tpu_torch
        assert not network() and "torch" not in sys.modules, network()
        from modal_tpu_torch import serialization
        serialization.deserialize(serialization.serialize({"f": lambda x: x}))
        assert not network(), network()
        from modal_tpu_torch.proto import api_pb2
        assert serialization.deserialize_data_format(
            serialization.serialize_data_format([1, "a"], api_pb2.DATA_FORMAT_CBOR), api_pb2.DATA_FORMAT_CBOR
        ) == [1, "a"]
        print("clean")
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-3000:]


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is satisfied here")
    from modal_tpu_torch import resolve_device
    from modal_tpu_torch.models.llama import KVCache, get_config, init_params
    from modal_tpu_torch.models.paged_kv import PagedKVCache
    from modal_tpu_torch.models.quant import init_params_quantized
    from modal_tpu_torch.models.weights import load_params
    from modal_tpu_torch.parallel.train import train_demo
    from modal_tpu_torch.serving import ServingEngine

    cfg = get_config("debug-1l")
    for call in (
        lambda: resolve_device(),
        lambda: train_demo("debug-1l"),
        lambda: init_params(cfg),
        lambda: KVCache.create(cfg, 1, 8),
        lambda: PagedKVCache.create(cfg, 2, 4),
        lambda: ServingEngine(init_params(cfg, device="cpu"), cfg),
        lambda: init_params_quantized(cfg),
        lambda: load_params("/nonexistent-checkpoint", cfg),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_lint_flash_and_the_native_hasher_run_with_jax_and_modal_tpu_unimportable(tmp_path):
    """`python -m modal_tpu_torch.cli lint --json` is clean over the port,
    Flash imports, and the native hasher builds and agrees with hashlib, in
    processes where jax and the JAX package cannot be imported."""
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(
        "import sys\nfor name in ('jax', 'jaxlib', 'modal_tpu'):\n    sys.modules[name] = None\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["PYTHONPATH"] = os.pathsep.join([str(blocker), REPO])
    lint = subprocess.run([sys.executable, "-m", "modal_tpu_torch.cli", "lint", "--json"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert lint.returncode == 0, lint.stderr[-3000:] + lint.stdout[-3000:]
    payload = json.loads(lint.stdout)
    assert payload["counts"]["total"] == 0 and payload["modules_scanned"] > 140
    code = textwrap.dedent("""
        import hashlib, os, sys
        from modal_tpu_torch.experimental import FlashAutoscaler, flash_forward, flash_get_pool
        from modal_tpu_torch._native import hash_blocks, hashlib_blocks
        data = os.urandom(300_001)
        assert hash_blocks(data, 65536) == hashlib_blocks(data, 65536)
        leaked = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "modal_tpu") and sys.modules[n] is not None)
        assert not leaked, leaked
        print("clean")
        """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-3000:]
