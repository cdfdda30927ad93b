"""Each count of the yardstick against a hand-worked shape."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark import models, roofline

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def model(name: str) -> models.Model:
    return models.load(CONFIGS / f"{name}.json")[0]


def test_flash_forward_at_s2048():
    # B1 S2048 H32 D128: 4·32·128·(2048·2049/2) = 34.39 GFLOP; q, k, v, out bf16 + lse fp32
    flops, nbytes = roofline.flash_fwd(1, 2048, 32, 128)
    assert flops == 4 * 32 * 128 * 2098176 == 34_376_515_584
    assert nbytes == 4 * 2048 * 32 * 128 * 2 + 32 * 2048 * 4
    assert roofline.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.03476, rel=1e-3)  # ops-bound


def test_flash_backward_counts():
    f2, b2 = roofline.flash_bwd_dq(1, 1024, 8, 64)
    f3, b3 = roofline.flash_bwd_dkv(1, 1024, 8, 64)
    pairs = 1024 * 1025 // 2
    assert f2 == 3 * 2 * 8 * 64 * pairs and f3 == 4 * 2 * 8 * 64 * pairs
    tile = 1024 * 8 * 64 * 2
    assert b2 == 5 * tile + 2 * 8 * 1024 * 4 and b3 == 6 * tile + 2 * 8 * 1024 * 4


def test_paged_decode_bytes():
    # Mistral: 8 KV heads of 128, bf16: 4 KiB of K and V a token a layer
    assert roofline.paged_decode_kv_bytes(1000, 8, 128) == 1000 * 4096
    assert roofline.paged_decode_io_bytes(32, 32, 128, 256) == 2 * 32 * 32 * 128 * 2 + 32 * 256 * 4 + 32 * 4
    assert roofline.paged_decode_flops(1000, 32, 128) == 4 * 1000 * 32 * 128
    assert roofline.share(0, 3.35e9, 1e-3) == pytest.approx(100.0)
    assert roofline.share(0, 1e9, 0.0) is None


def test_model_sizes_as_published():
    assert model("mistral-7b-v0.3").params == 7_248_023_552
    assert model("deepseek-llm-7b-base").params == 6_910_365_696
    assert model("mistral-7b-v0.3").kv_bytes_per_token * 32 == 128 * 1024
    assert model("deepseek-llm-7b-base").kv_bytes_per_token * 30 == 480 * 1024


def test_train_step_and_token_counts():
    m = model("mistral-7b-v0.3")
    n = m.params - m.vocab_size * m.hidden_size
    attn = 4 * 32 * 128 * (4096 * 4097 // 2) * 32
    assert roofline.train_step_flops(m, 1, 4096) == 6 * n * 4096 + 3 * attn
    assert roofline.decode_token_flops(m, 100) == 2 * n + 4 * 32 * 32 * 128 * 100
    head = m.vocab_size * m.hidden_size
    layers = 2 * (m.params - 2 * head) * 128
    assert roofline.prefill_chunk_flops(m, 256, 128) == layers + 4 * 32 * 32 * 128 * (128 * 256 + 128 * 129 // 2) + 2 * head


def test_configs_hold_the_published_sizes():
    raw = json.loads((CONFIGS / "mistral-7b-v0.3.json").read_text())
    assert raw["reduced"]["max_position_embeddings"]["published"] == 32768
    assert (raw["vocab_size"], raw["num_key_value_heads"], raw["rope_theta"]) == (32768, 8, 1e6)
    raw = json.loads((CONFIGS / "deepseek-llm-7b-base.json").read_text())
    assert (raw["vocab_size"], raw["num_hidden_layers"], raw["num_key_value_heads"]) == (102400, 30, 32)
    assert raw["reduced"] == {}


def test_k4_reader_counts_a_shared_document_once_a_call():
    """Two decode steps, three slots: two slots read one document's 32 full
    pages (of its 520 tokens, 512 are in full pages), one slot reads none."""
    import types

    from benchmark import spec
    from benchmark.stats import Record
    from benchmark.tests.tiny import REPO
    from benchmark.trace import Trace

    m = model("deepseek-llm-7b-base")
    recs = [Record(0, 530, 8, True, 0.0, arrivals=[0.5, 1.0, 1.03], shared_prefix=0),
            Record(1, 540, 8, True, 0.0, arrivals=[0.5, 1.001, 1.031], shared_prefix=0),
            Record(2, 100, 8, True, 0.0, arrivals=[0.5, 1.002, 1.032])]
    calls = [("paged_decode_kernel<128, 1>", 2.0 + i, 2.0 + i + 1e-3) for i in range(2 * 30)]
    trace = Trace(ops=calls, host=[], t0=0.9, t1=1.1, window_s=0.2)
    serve = types.SimpleNamespace(records=recs, engine_info={"max_slots": 3, "pages_per_slot": 256,
                                                             "page_size": 16})
    run = types.SimpleNamespace(serve=serve, trace=trace, model=m,
                                mix={"shared_prefix": {"count": 1, "tokens": 520}})
    per_token = 30 * 2 * 32 * 128 * 2  # K and V, every layer
    contexts = [(531, 532), (541, 542), (101, 102)]
    kv = 2 * 512 * per_token + sum(c - (512 if i < 2 else 0) for i, pair in enumerate(contexts) for c in pair) * per_token
    io = 60 * roofline.paged_decode_io_bytes(3, 32, 128, 256)
    flops = sum(30 * roofline.paged_decode_flops(c, 32, 128) for pair in contexts for c in pair)
    want = roofline.share(flops, kv + io, 60 * 1e-3)
    assert spec.reader(REPO, "k4_roofline.serve")(run) == pytest.approx(want)
