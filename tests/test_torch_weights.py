"""The port's safetensors checkpoints (`models/weights.py`) against the JAX
package's, on the CPU, in both directions.

`tiny` params from PRNGKey(0), carried across with `params_from_jax` in
fp32 and bf16. Both exporters must write the same files byte for byte, each
package must load what the other exported bit for bit, and the loaded
params must give the exporter's logits (fp32: within 1e-5, the gap between
the two frameworks' forwards on identical params)."""

import filecmp
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modal_tpu.models import llama as jllama
from modal_tpu.models import weights as jweights
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.models import weights as tweights
from modal_tpu_torch.models.convert import params_from_jax, unstack_layers
from modal_tpu_torch.observability import catalog as tcatalog
from modal_tpu_torch.parallel import train as ttrain

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# ~6 tiny tensors a shard: 11 shards, an index, tensors never split
SMALL_SHARDS = 200_000
LOGITS_ATOL = 1e-5  # fp32: the two frameworks' forwards on identical params


def _models(dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg = jllama.get_config("tiny", dtype=jdt)
    tcfg = tllama.get_config("tiny", dtype=tdt)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _assert_port_params_equal(got, want):
    for key in ("embed", "final_norm", "lm_head"):
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    assert set(got["layers"]) == set(want["layers"])
    for key, t in want["layers"].items():
        assert got["layers"][key].dtype == t.dtype and torch.equal(got["layers"][key], t), key


def _tokens(cfg):
    return np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_export_writes_the_jax_package_files(dtype, tmp_path):
    """Small shards force several files: the shard names, the index JSON and
    every shard's bytes equal the JAX exporter's."""
    jcfg, jparams, tcfg, tparams = _models(dtype)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jindex = jweights.export_checkpoint(jparams, jcfg, str(jdir), max_shard_bytes=SMALL_SHARDS)
    tindex = tweights.export_checkpoint(tparams, tcfg, str(tdir), max_shard_bytes=SMALL_SHARDS)
    assert tindex == jindex
    assert len(set(tindex["weight_map"].values())) > 1
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names and tweights.INDEX_FILE in names
    for name in names:
        assert filecmp.cmp(jdir / name, tdir / name, shallow=False), name
    with open(tdir / tweights.INDEX_FILE) as f:
        assert json.load(f) == jindex


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_jax_export_loads_bit_equal_in_the_port(dtype, tmp_path):
    jcfg, jparams, tcfg, tparams = _models(dtype)
    jweights.export_checkpoint(jparams, jcfg, str(tmp_path), max_shard_bytes=SMALL_SHARDS)
    loaded = tweights.load_params(str(tmp_path), tcfg, device="cpu")
    _assert_port_params_equal(loaded, tparams)
    if dtype == "fp32":
        tokens = _tokens(tcfg)
        want = np.asarray(jllama.forward(jparams, jcfg, jnp.asarray(tokens))[0])
        got = tllama.forward(loaded, tcfg, torch.from_numpy(tokens).long(), attn_impl=tllama.attention)[0]
        np.testing.assert_allclose(got.detach().numpy(), want, atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_export_loads_bit_equal_in_jax(dtype, tmp_path):
    jcfg, jparams, tcfg, tparams = _models(dtype)
    tweights.export_checkpoint(tparams, tcfg, str(tmp_path), max_shard_bytes=SMALL_SHARDS)
    loaded = jweights.load_params(str(tmp_path), jcfg)
    want, got = jax.tree_util.tree_leaves_with_path(jparams), jax.tree_util.tree_leaves_with_path(loaded)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_p, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), jax.tree_util.keystr(path)
    if dtype == "fp32":
        tokens = _tokens(tcfg)
        want_logits = tllama.forward(tparams, tcfg, torch.from_numpy(tokens).long(), attn_impl=tllama.attention)[0]
        got_logits = np.asarray(jllama.forward(loaded, jcfg, jnp.asarray(tokens))[0])
        np.testing.assert_allclose(got_logits, want_logits.detach().numpy(), atol=LOGITS_ATOL, rtol=0)


def test_single_file_export_and_stale_shards_removed(tmp_path):
    """A sharded export followed by a single-file one at the same place must
    leave only the single file (the loader would prefer a stale index), as
    in the JAX package; the single-file checkpoint loads."""
    _jc, _jp, tcfg, tparams = _models("fp32")
    tweights.export_checkpoint(tparams, tcfg, str(tmp_path), max_shard_bytes=SMALL_SHARDS)
    (tmp_path / "notes.txt").write_text("kept")
    index = tweights.export_checkpoint(tparams, tcfg, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["model.safetensors", "notes.txt"]
    assert set(index["weight_map"].values()) == {"model.safetensors"}
    _assert_port_params_equal(tweights.load_params(str(tmp_path), tcfg, device="cpu"), tparams)


def test_parse_safetensors_header_agrees_with_jax(tmp_path):
    tensors = {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16),
        "c": torch.arange(-3, 3, dtype=torch.int8),
        "d": torch.tensor(7, dtype=torch.int64),
    }
    path = tmp_path / "x.safetensors"
    header = tweights.build_safetensors(tensors, str(path), {"format": "modal_tpu", "n": 3})
    raw = path.read_bytes()
    got = tweights.parse_safetensors_header(raw)
    assert got == jweights.parse_safetensors_header(raw)
    assert got[0] == header and got[1] == 8 + struct.unpack("<Q", raw[:8])[0]
    # every tensor's bytes sit where the header says, as the JAX reader reads them
    idx = tweights._CheckpointIndex()
    for name, meta in header.items():
        if name != "__metadata__":
            a, b = meta["data_offsets"]
            idx.tensors[name] = ("x.safetensors", tweights._ST_DTYPES[meta["dtype"]], tuple(meta["shape"]),
                                 got[1] + a, got[1] + b)
    src = tweights.LocalSource(str(tmp_path))
    for name, t in tensors.items():
        assert torch.equal(tweights._fetch_tensor(src, idx, name), t), name


@pytest.mark.parametrize("name", ["llama3-8b", "tiny"])
def test_hf_key_map_equals_jax(name):
    """Every key of the config's tree maps to the JAX package's HF name and
    transpose flag."""
    tcfg, jcfg = tllama.get_config(name), jllama.get_config(name)
    abstract = tllama.init_params_abstract(tcfg)
    for key in ("embed", "final_norm", "lm_head"):
        assert tweights.hf_key(key) == jweights.hf_key(key)
    assert tweights.layer_map(tcfg) == jweights.layer_map(jcfg)
    assert set(tweights.layer_map(tcfg)) == set(abstract["layers"])
    for layer in (0, tcfg.n_layers - 1):
        for key in abstract["layers"]:
            assert tweights.hf_key(key, layer, cfg=tcfg) == jweights.hf_key(key, layer, cfg=jcfg)


def test_per_layer_load_and_train_state_from_a_checkpoint(tmp_path):
    """layout="per_layer" gives the training layout without a stacked copy,
    equal to unstack_layers of the stacked load; create_state starts from it."""
    _jc, _jp, tcfg, tparams = _models("fp32")
    tweights.export_checkpoint(tparams, tcfg, str(tmp_path))
    per_layer = tweights.load_params(str(tmp_path), tcfg, device="cpu", layout="per_layer")
    want = unstack_layers(tparams)
    assert isinstance(per_layer["layers"], list) and len(per_layer["layers"]) == tcfg.n_layers
    for got_layer, want_layer in zip(per_layer["layers"], want["layers"]):
        assert got_layer.keys() == want_layer.keys()
        assert all(torch.equal(got_layer[k], want_layer[k]) for k in want_layer)
    state, _step = ttrain.create_state(tcfg, ttrain.TrainConfig(), device="cpu", checkpoint=str(tmp_path))
    assert torch.equal(state.params["layers"][1]["w_down"], want["layers"][1]["w_down"])
    assert all(p.requires_grad for p in ttrain.tree_leaves(state.params))


def test_tied_lm_head_and_dtype_cast(tmp_path):
    """A checkpoint without lm_head.weight takes embed.T (Llama-3.2 style),
    and `dtype=` casts on the host, as in the JAX package."""
    _jc, _jp, tcfg, tparams = _models("fp32")
    tweights.export_checkpoint(tparams, tcfg, str(tmp_path))
    src = tweights.LocalSource(str(tmp_path))
    idx = tweights._CheckpointIndex.build(src)
    tensors = {name: tweights._fetch_tensor(src, idx, name) for name in idx.tensors if name != "lm_head.weight"}
    tied = tmp_path / "tied"
    tied.mkdir()
    tweights.build_safetensors(tensors, str(tied / "model.safetensors"))
    loaded = tweights.load_params(str(tied), tcfg, device="cpu", dtype=torch.bfloat16)
    assert loaded["lm_head"].dtype == torch.bfloat16
    assert torch.equal(loaded["lm_head"], tparams["embed"].T.to(torch.bfloat16))
    assert torch.equal(loaded["layers"]["wq"], tparams["layers"]["wq"].to(torch.bfloat16))


def test_load_refuses_what_it_cannot_do(tmp_path):
    """A mesh's shardings and Volumes wait for later queue items; a missing
    checkpoint and a config whose shapes differ raise."""
    _jc, _jp, tcfg, tparams = _models("fp32")
    with pytest.raises(FileNotFoundError):
        tweights.load_params(str(tmp_path), tcfg, device="cpu")
    tweights.export_checkpoint(tparams, tcfg, str(tmp_path))
    with pytest.raises(NotImplementedError, match="Queue A 5"):
        tweights.load_params(str(tmp_path), tcfg, device="cpu", shardings={})
    with pytest.raises(NotImplementedError, match="Queue A 4"):
        tweights.load_params((object(), "ckpt"), tcfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tweights.load_params(str(tmp_path), tllama.get_config("tiny", dim=64, dtype=torch.float32), device="cpu")
    with pytest.raises(ValueError, match="layout"):
        tweights.load_params(str(tmp_path), tcfg, device="cpu", layout="sharded")


def test_load_records_the_jax_package_metrics(tmp_path):
    """The loader's metric families carry the JAX catalog's names and help
    texts; a load adds its bytes and sets the GB/s and peak-RSS gauges."""
    from modal_tpu.observability import catalog as jcatalog

    for name in ("WEIGHTS_LOADED_BYTES", "WEIGHTS_LOAD_GBPS", "PEAK_RSS_BYTES"):
        mine, ref = getattr(tcatalog, name), getattr(jcatalog, name)
        assert (mine.name, mine.help) == (ref.name, ref.help)
    _jc, _jp, tcfg, tparams = _models("bf16")
    index = tweights.export_checkpoint(tparams, tcfg, str(tmp_path))
    before = tcatalog.WEIGHTS_LOADED_BYTES.value()
    tweights.load_params(str(tmp_path), tcfg, device="cpu")
    assert tcatalog.WEIGHTS_LOADED_BYTES.value() - before == index["metadata"]["total_size"]
    assert tcatalog.WEIGHTS_LOAD_GBPS.value() > 0 and tcatalog.PEAK_RSS_BYTES.value() > 0
