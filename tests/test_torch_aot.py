"""The port's `runtime/aot.py` (env-gated warm-up), the meta-device
`init_params_abstract`, and the CUDA-graph decode's plumbing: launch counts
recorded at capture and added per replay, the K4 workspace a graph owns,
and the engine's `cuda_graphs` switch.

On the CPU: the spec parser against the JAX package's on a table of
strings, the warm-up with a stubbed kernel build, the abstract tree against
`jax.eval_shape`, the launch accounting with a stub graph, and the switch.
The `cuda`-marked cases capture and replay real decode graphs on the card
and hold them against eager decoding."""

import jax
import numpy as np
import pytest
import torch

from modal_tpu.models import llama as jllama
from modal_tpu.runtime import aot as jaot
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.models import paged_kv as tpk
from modal_tpu_torch.models.quant import quantized_bytes
from modal_tpu_torch.ops import _build
from modal_tpu_torch.ops import paged_attention as tpa
from modal_tpu_torch.runtime import aot as taot
from modal_tpu_torch.serving import ServingEngine

SPECS = [
    None, "", "0", "off", "  FALSE ", "1", "all", "on", "true", "decode", "prefill,decode",
    "decode,decode,verify", "sample,bogus,train", "bogus", "cfg=llama3-8b", "decode,cfg=llama3-8b",
    "all,slots=8,num_pages=128,page_size=16", "verify,spec_k=3,seq=128,batch=2", "decode,slots=eight",
    "decode,max_context=4096,unknown=5", " Decode , CFG=Tiny ,", "train,,sample", "prefill,=3,cfg=",
]


@pytest.mark.parametrize("raw", SPECS)
def test_parse_aot_spec_equals_jax(raw, monkeypatch):
    """Entries, options and the off states as the JAX parser gives them,
    malformed tokens and cfg= included; None reads the env."""
    if raw is None:
        monkeypatch.setenv(taot.AOT_ENV, "verify,cfg=debug-1l")
    assert taot.AOT_ENV == jaot.AOT_ENV and taot.ENTRY_POINTS == jaot.ENTRY_POINTS
    assert taot.parse_aot_spec(raw) == jaot.parse_aot_spec(raw)


def test_run_aot_lowering_builds_each_entrys_kernels(monkeypatch):
    """Each entry builds the kernels it launches (train K1-K3, decode K4) and
    reports the params' bytes from the meta tree; a failing entry lands
    under "errors" and the others still run."""
    built = []

    def fake_build(names):
        if "flash_bwd_dq" in names:
            raise RuntimeError("nvcc exit 1")
        built.append(tuple(names))
        return {}

    monkeypatch.setattr(_build, "build", fake_build)
    out = taot.run_aot_lowering(["decode", "prefill", "train", "sample", "nope"], {"cfg": "llama3-8b"})
    assert built == [("paged_decode",)]
    assert set(out) == {"decode", "prefill", "sample", "errors"}
    assert out["errors"] == {"train": "nvcc exit 1"}
    assert out["decode"]["executables"] == 1 and out["decode"]["kernels"] == ["paged_decode"]
    assert out["prefill"]["executables"] == 0
    assert out["decode"]["param_bytes"] == tllama.get_config("llama3-8b").param_count() * 2


def test_maybe_aot_lower_is_env_gated_and_never_raises(monkeypatch):
    monkeypatch.setattr(_build, "build", lambda names: {})
    monkeypatch.delenv(taot.AOT_ENV, raising=False)
    assert taot.maybe_aot_lower() is None
    monkeypatch.setenv(taot.AOT_ENV, "decode,verify,cfg=tiny")
    assert set(taot.maybe_aot_lower()) == {"decode", "verify"}
    monkeypatch.setenv(taot.AOT_ENV, "all,cfg=no-such-model")
    assert taot.maybe_aot_lower() is None


@pytest.mark.parametrize("name", ["tiny", "llama3-8b", "llama3-1b-proxy"])
def test_init_params_abstract_matches_jax_eval_shape(name):
    """Meta tensors (no memory) with the shapes and dtypes of JAX's
    `init_params_abstract`, leaf for leaf."""
    want = jllama.init_params_abstract(jllama.get_config(name))
    got = tllama.init_params_abstract(tllama.get_config(name))
    flat_want = {jax.tree_util.keystr(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(want)}
    flat_got = {}
    for key, leaf in got.items():
        for sub, t in (leaf.items() if isinstance(leaf, dict) else [(None, leaf)]):
            flat_got[f"['{key}']" + (f"['{sub}']" if sub else "")] = t
    assert sorted(flat_got) == sorted(flat_want)
    for path, spec in flat_want.items():
        t = flat_got[path]
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(spec.shape) and str(t.dtype).split(".")[-1] == str(spec.dtype), path
    assert quantized_bytes(got) == sum(int(np.prod(s.shape)) * s.dtype.itemsize for s in flat_want.values())


def test_recorded_launches_count_per_replay(monkeypatch):
    """A capture records its launches instead of counting them (nothing ran);
    each replay of the graph adds them, as the launches themselves would."""
    monkeypatch.setattr(_build, "LAUNCHES", {name: 0 for name in _build.SOURCES})
    with _build.recording_launches() as outer:
        _build.count_launch("paged_decode")
        with _build.recording_launches() as inner:
            _build.count_launch("paged_decode")
            _build.count_launch("flash_fwd")
        _build.count_launch("paged_decode")
    _build.count_launch("paged_decode")  # an eager launch after the capture
    assert outer == {"paged_decode": 2} and inner == {"paged_decode": 1, "flash_fwd": 1}
    assert _build.LAUNCHES["paged_decode"] == 1

    class StubGraph:
        replays = 0

        def replay(self):
            StubGraph.replays += 1

    graph = _build.CountedGraph(StubGraph(), {"paged_decode": 32})
    for _ in range(3):
        graph.replay()
    assert StubGraph.replays == 3
    assert _build.LAUNCHES == {**{n: 0 for n in _build.SOURCES}, "paged_decode": 1 + 3 * 32}


def test_graph_workspace_is_the_graphs_own():
    """Outside a graph a workspace is bound to the stream of its first call;
    inside `graph_workspaces(store)` calls take the store's, which is neither
    shared with the streams' nor bound to one."""
    dev = torch.device("cpu")
    key = (2, 2, 4, 32, 3)
    eager = tpa._decode_workspace(dev, key, stream=11)
    with pytest.raises(RuntimeError, match="bound to stream"):
        tpa._decode_workspace(dev, key, stream=12)
    store: dict = {}
    with tpa.graph_workspaces(store):
        mine = tpa._decode_workspace(dev, key, stream=12)
        assert tpa._decode_workspace(dev, key, stream=13)[1] is mine[1]
    assert list(store) == [(dev, *key)]
    assert mine[1] is not eager[1] and mine[0].data_ptr() != eager[0].data_ptr()
    assert int(mine[1].abs().sum()) == 0 and mine[0].shape == (2, 2, 3, 4 * 34)
    tpa._WORKSPACES.pop((dev, *key))


@pytest.fixture(scope="module")
def tiny_bf16():
    cfg = tllama.get_config("tiny")
    return tllama.init_params(cfg, seed=0, device="cpu"), cfg


def test_cuda_graphs_switch_on_the_cpu(tiny_bf16):
    """None means eager on the CPU (there is no capture there); True asks for
    a card and raises without one; False is eager; a DecodeGraph refuses a
    CPU cache."""
    params, cfg = tiny_bf16
    geometry = dict(max_slots=2, num_pages=9, page_size=16, pages_per_slot=4, device="cpu")
    for choice in (None, False):
        engine = ServingEngine(params, cfg, cuda_graphs=choice, **geometry)
        assert engine.decode_graph is None and engine.stats()["cuda_graphs"] is False
    with pytest.raises(ValueError, match="cuda_graphs=True needs a CUDA device"):
        ServingEngine(params, cfg, cuda_graphs=True, **geometry)
    cache = tpk.PagedKVCache.create(cfg, 2, 9, 16, 4, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tpk.DecodeGraph(params, cfg, cache)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _traffic(engine, prompts, new_tokens):
    engine.start()
    try:
        reqs = [engine.submit(p, new_tokens, temperature=0.8 if i == 1 else 0.0, top_p=0.9, seed=7 + i)
                for i, p in enumerate(prompts)]
        return [r.result(timeout=300) for r in reqs], engine.stats()
    finally:
        engine.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True])
def test_graphed_decode_equals_eager_with_exact_launches(cuda_device, spec):
    """The same requests through a graphed and an eager engine (bf16 `tiny`,
    K4 at hd 32, n_rep 2): equal streams (the same kernels in the same
    order), and K4 counted exactly n_layers per step (the draft's k + 1 steps
    per dispatch in speculative mode) with replays counted."""
    cfg = tllama.get_config("tiny")
    params = tllama.init_params(cfg, seed=0, device=cuda_device)
    kw = dict(max_slots=4, num_pages=33, page_size=16, pages_per_slot=8, prefill_chunk=32, device=cuda_device)
    if spec:
        kw.update(draft=(tllama.init_params(cfg, seed=1, device=cuda_device), cfg), spec_k=2)
    prompts = [list(range(3 + i, 30 + 5 * i)) for i in range(3)]
    results = {}
    for graphs in (True, False):
        engine = ServingEngine(params, cfg, cuda_graphs=graphs, **kw)
        assert (engine.decode_graph is not None) is graphs
        if graphs:
            assert engine.decode_graph.graph.launches == {"paged_decode": cfg.n_layers}
        _build.reset_launches()
        outs, stats = _traffic(engine, prompts, 12)
        launches = _build.LAUNCHES["paged_decode"]
        want = cfg.n_layers * (stats["spec_dispatches"] * 3 if spec else stats["steps"])
        assert launches == want and want > 0, (graphs, launches, want)
        results[graphs] = outs
    assert results[True] == results[False]


@pytest.mark.cuda
def test_eager_calls_beside_a_graph_keep_their_own_workspace(cuda_device):
    """After a capture, an eager K4 call with the graph's shapes on the
    default stream neither raises nor shares the graph's counters, and the
    graph's counters are back at zero after each replay."""
    cfg = tllama.get_config("tiny")
    params = tllama.init_params(cfg, seed=0, device=cuda_device)
    cache = tpk.PagedKVCache.create(cfg, 4, 33, 16, 8, device=cuda_device)
    for slot in range(4):
        tpk.assign_pages(cache, slot, 0, list(range(1 + 8 * slot, 9 + 8 * slot)))
    graph = tpk.DecodeGraph(params, cfg, cache)
    tokens = torch.tensor([5, 6, 7, 8], device=cuda_device)
    active = torch.ones(4, dtype=torch.bool, device=cuda_device)
    cache.seq_lens.fill_(100)
    logits, _next = graph(tokens, active)
    graph_logits = logits.clone()
    cache.seq_lens.fill_(100)
    eager, _n, _c = tpk.paged_decode_step(params, cfg, tokens, cache, active, "kernel")
    torch.cuda.synchronize()
    assert torch.equal(graph_logits, eager)
    for _partials, counters in (v[1:] for v in graph.workspaces.values()):
        assert int(counters.abs().sum()) == 0
    assert graph.pool_bytes >= 0 and graph.capture_s > 0


@pytest.mark.cuda
def test_capture_streams_are_reused_not_leaked(cuda_device):
    """cuBLAS keeps a workspace per stream for the life of the process, so a
    graph's capture stream goes back to the free list when the graph dies
    and the next graph takes it: building graphs one after another does not
    grow the allocated memory."""
    import gc

    cfg = tllama.get_config("tiny")
    params = tllama.init_params(cfg, seed=0, device=cuda_device)
    cache = tpk.PagedKVCache.create(cfg, 2, 9, 16, 4, device=cuda_device)
    graph = tpk.DecodeGraph(params, cfg, cache)
    del graph
    gc.collect()
    torch.cuda.synchronize()
    free = tpk._FREE_CAPTURE_STREAMS[cache.device]  # cuda:N, as the graph keys it
    streams, base = list(free), torch.cuda.memory_allocated()
    for _ in range(3):
        graph = tpk.DecodeGraph(params, cfg, cache)
        assert len(free) == len(streams) - 1  # one stream lent out
        del graph
        gc.collect()
    torch.cuda.synchronize()
    assert sorted(map(id, free)) == sorted(map(id, streams))
    assert torch.cuda.memory_allocated() <= base + (1 << 20)
