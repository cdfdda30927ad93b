"""The PyTorch port stands alone: it imports neither `jax`, `optax` nor the
JAX package, serves and trains without them, and its entry points default
to CUDA."""

import ast
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
    return top in ("jax", "jaxlib", "modal_tpu", "flax", "optax", "ml_dtypes", "cloudpickle")


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


def test_port_serves_with_jax_and_modal_tpu_unimportable(tmp_path):
    """Serve, speculate, ship, train (a dense and a tiny-moe step, and an
    fsdp step in 2 spawned gloo ranks, which re-run the script's top level
    and so refuse the same imports), checkpoint, quantize and sample."""
    header = textwrap.dedent(
        """
        import sys
        for name in ("jax", "jaxlib", "modal_tpu", "optax", "ml_dtypes", "cloudpickle"):
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


def test_every_module_of_the_port_is_scanned():
    """The modules of each slice, this one's included, are among the sources
    the import scan reads (a new module cannot slip past it)."""
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in ("models/weights.py", "models/quant.py", "models/sampling.py", "runtime/aot.py",
                "runtime/__init__.py", "serving/api.py", "ops/_build.py", "tools/profile_serving.py",
                "parallel/mesh.py", "parallel/sharding.py", "parallel/spmd.py", "parallel/moe.py",
                "parallel/pipeline.py", "parallel/ring_attention.py"):
        assert os.path.join("modal_tpu_torch", rel) in scanned, rel


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
