"""The port's int8 init (`quant.init_params_quantized`, `quantized_bytes`)
against the JAX package's, on the CPU.

`fast_host_init` tiles the same `np.random.default_rng(0)` block in both
packages, so every int8 leaf, every scale and every norm gain must be equal
bit for bit, through the small-tensor path and through the chunked stream
(made to run at tiny sizes by shrinking both packages' chunk thresholds the
same way). The generator path draws from `torch.Generator`s, so only its
structure, dtypes and bytes are held to JAX's."""

import jax
import numpy as np
import pytest
import torch

from modal_tpu.models import llama as jllama
from modal_tpu.models import quant as jquant
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.models import quant as tquant


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (JAX arrays or torch tensors)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _bits(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.contiguous().view(torch.uint8).numpy() if leaf.dim() else leaf.reshape(1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(leaf)).view(np.uint8)


def _assert_same_tree(got, want, values=True):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)  # JAX trees sort their dict keys
    for path, ref in want.items():
        mine = got[path]
        assert tuple(mine.shape) == tuple(ref.shape), path
        assert str(mine.dtype).split(".")[-1] == str(ref.dtype), path
        if values:
            assert np.array_equal(_bits(mine).reshape(-1), _bits(ref).reshape(-1)), path


@pytest.mark.parametrize("name", ["tiny", "debug-1l"])
def test_fast_host_init_is_bit_equal_to_jax(name):
    want = jquant.init_params_quantized(jllama.get_config(name), jax.random.PRNGKey(0), fast_host_init=True)
    got = tquant.init_params_quantized(tllama.get_config(name), fast_host_init=True, device="cpu")
    _assert_same_tree(got, want)
    assert tquant.quantized_bytes(got) == jquant.quantized_bytes(want)
    assert got["layers"]["wq"]["q"].dtype == torch.int8 and got["embed"]["s"].dtype == torch.bfloat16


def test_chunked_stream_is_bit_equal_to_jax(monkeypatch):
    """Thresholds cut so tiny's stacked weights take the chunked path, with
    chunks that restart the tile mid-tensor and a short last chunk."""
    for mod in (jquant, tquant):
        monkeypatch.setattr(mod, "_CHUNKED_INIT_BYTES", 40_000)
        monkeypatch.setattr(mod, "_CHUNK_BYTES", 70_000)
    want = jquant.init_params_quantized(jllama.get_config("tiny"), jax.random.PRNGKey(0), fast_host_init=True)
    got = tquant.init_params_quantized(tllama.get_config("tiny"), fast_host_init=True, device="cpu")
    _assert_same_tree(got, want)
    host_tile = np.random.default_rng(0).integers(-127, 128, size=1 << 20, dtype=np.int8)
    for shape in ((7, 300), (3, 5, 4001), (2, 1)):
        ref = np.asarray(jquant._fill_int8_chunked(shape, host_tile))
        mine = tquant._fill_int8_chunked(shape, host_tile, torch.device("cpu"))
        np.testing.assert_array_equal(mine.numpy(), ref)


@pytest.mark.parametrize("size", [0, 5, 1 << 20, (1 << 20) + 7, 3 * (1 << 20) - 1])
def test_tile_to_equals_jax(size):
    host_tile = np.random.default_rng(0).integers(-127, 128, size=1 << 20, dtype=np.int8)
    np.testing.assert_array_equal(tquant._tile_to(host_tile, size), jquant._tile_to(host_tile, size))


def test_generator_init_matches_jax_structure_and_is_seeded():
    """Values come from a torch.Generator keyed by (seed, leaf name): the same
    tree, shapes, dtypes and bytes as JAX's; reproducible from the seed; two
    leaves of one shape differ; every int8 value in [-127, 127]."""
    cfg = tllama.get_config("tiny")
    want = jquant.init_params_quantized(jllama.get_config("tiny"), jax.random.PRNGKey(0))
    got = tquant.init_params_quantized(cfg, seed=0, device="cpu")
    _assert_same_tree(got, want, values=False)
    assert tquant.quantized_bytes(got) == jquant.quantized_bytes(want)
    again = tquant.init_params_quantized(cfg, seed=0, device="cpu")
    other = tquant.init_params_quantized(cfg, seed=1, device="cpu")
    q = got["layers"]["w_gate"]["q"]
    assert torch.equal(q, again["layers"]["w_gate"]["q"])
    assert not torch.equal(q, other["layers"]["w_gate"]["q"])
    assert not torch.equal(q, got["layers"]["w_up"]["q"])  # same shape, another name
    assert int(q.min()) >= -127 and int(q.max()) <= 127


def test_quantized_params_run_the_forward():
    """The int8 tree drops into the forward (qmm / qembed) and gives finite
    logits; quantized_bytes counts meta tensors by their shapes."""
    cfg = tllama.get_config("tiny")
    params = tquant.init_params_quantized(cfg, fast_host_init=True, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 16), generator=torch.Generator().manual_seed(0))
    logits = tllama.forward(params, cfg, tokens, attn_impl=tllama.attention)[0]
    assert logits.shape == (1, 16, cfg.vocab_size) and torch.isfinite(logits).all()
    abstract = tllama.init_params_abstract(cfg)
    assert tquant.quantized_bytes(abstract) == cfg.param_count() * 2
