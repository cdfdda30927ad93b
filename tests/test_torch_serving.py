"""The port's serving engine against the JAX package's, on the CPU.

Both engines get the same converted fp32 `tiny` params, the same geometry
and the same request schedule, and are driven iteration by iteration (no
engine thread), so the schedule itself is deterministic. fp32 keeps the two
frameworks' logits within ~1e-6, far from the argmax near-ties a random-init
model has under bf16."""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modal_tpu.models import llama as jllama
from modal_tpu.serving.engine import ServingEngine as JaxEngine
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.models.convert import params_from_jax
from modal_tpu_torch.serving import ServingEngine, asgi_request, serving_asgi_app

GEOMETRY = dict(max_slots=4, num_pages=12, page_size=8, pages_per_slot=8, prefill_chunk=16)


@pytest.fixture(scope="module")
def fp32_tiny():
    jcfg = jllama.get_config("tiny", dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jparams, jcfg, tparams, tllama.get_config("tiny", dtype=torch.float32)


def _drive(engine, requests, run_once):
    for _ in range(2000):
        if all(r.done for r in requests):
            return [r.result(timeout=0) for r in requests]
        run_once()
    raise AssertionError("engine did not finish its requests")


def _serve(engine, run_once):
    """A system prompt served alone (it lands in the prefix cache), then a
    follower sharing it (a hit) plus two companions that overflow the pool
    together (preemption)."""
    rng = np.random.default_rng(21)
    system = rng.integers(0, 512, size=16).tolist()
    first = _drive(engine, [engine.submit(system + [1, 2], 10)], run_once)
    burst = [
        engine.submit(system + [3, 4, 5], 20),
        engine.submit(rng.integers(0, 512, size=12).tolist(), 30),
        engine.submit(rng.integers(0, 512, size=12).tolist(), 30),
    ]
    outs = first + _drive(engine, burst, run_once)
    stats = engine.stats()
    engine.stop()
    return outs, stats


def test_engine_greedy_streams_match_jax_engine(fp32_tiny):
    jparams, jcfg, tparams, tcfg = fp32_tiny
    jeng = JaxEngine(jparams, jcfg, **GEOMETRY)

    def jax_once():
        jeng._admit()
        jeng._prefill_one()
        jeng._decode_step()

    want, jstats = _serve(jeng, jax_once)
    teng = ServingEngine(tparams, tcfg, device="cpu", **GEOMETRY)
    got, tstats = _serve(teng, teng.run_once)
    assert [len(o) for o in got] == [10, 20, 30, 30]
    assert got == want
    for key in ("preemptions", "prefix_cache_hits", "kv_pages_cow_copies", "steps"):
        assert tstats[key] == jstats[key], key
    assert tstats["preemptions"] > 0 and tstats["prefix_cache_hits"] > 0
    assert teng.allocator.free_pages == GEOMETRY["num_pages"] - 1  # nothing leaked


def test_asgi_generate_round_trip(fp32_tiny):
    _jp, _jc, tparams, tcfg = fp32_tiny
    engine = ServingEngine(tparams, tcfg, device="cpu", **GEOMETRY).start()
    app = serving_asgi_app(engine)

    async def exchange():
        ok = await asgi_request(app, "POST", "/v1/generate", {"prompt": [5, 6, 7], "max_new_tokens": 6})
        sse = await asgi_request(
            app, "POST", "/v1/generate", {"prompt": [5, 6, 7], "max_new_tokens": 4, "stream": True}
        )
        bad = await asgi_request(app, "POST", "/v1/generate", {"prompt": [5], "top_p": 0})
        result = await asgi_request(app, "GET", f"/v1/result/{json.loads(ok[1])['request_id']}")
        stats = await asgi_request(app, "GET", "/v1/stats")
        health = await asgi_request(app, "GET", "/healthz")
        missing = await asgi_request(app, "GET", "/v1/no-such-route")
        return ok, sse, bad, result, stats, health, missing

    try:
        ok, sse, bad, result, stats, health, missing = asyncio.run(exchange())
    finally:
        engine.stop()
    assert ok[0] == 200
    body = json.loads(ok[1])
    assert body["num_tokens"] == 6 and body["tokens"] == engine.requests[body["request_id"]].tokens
    events = [blk for blk in sse[1].decode().split("\n\n") if blk.startswith("event:")]
    kinds = [blk.splitlines()[0] for blk in events]
    assert kinds == ["event: start"] + ["event: token"] * 4 + ["event: done"]
    tokens = [json.loads(blk.splitlines()[-1][len("data: "):])["token"] for blk in events[1:5]]
    assert tokens == body["tokens"][:4]  # greedy: the same prompt gives the same stream
    assert bad[0] == 400 and b"top_p" in bad[1]
    assert result[0] == 200 and json.loads(result[1])["tokens"] == body["tokens"]
    assert stats[0] == 200 and json.loads(stats[1])["requests_completed"] == 2
    assert health[0] == 200 and missing[0] == 404


def test_engine_refuses_what_this_slice_lacks(fp32_tiny):
    """The JAX engine's refusals, raised at construction or submit: a draft
    of another vocabulary, an MoE draft, bad sampling knobs, a request past
    the context limit (which a draft shortens by spec_k)."""
    _jp, _jc, tparams, tcfg = fp32_tiny
    with pytest.raises(ValueError, match="draft vocab"):
        ServingEngine(tparams, tcfg, device="cpu", draft=(tparams, tllama.get_config("debug-1l")))
    with pytest.raises(ValueError, match="MoE draft"):
        ServingEngine(tparams, tcfg, device="cpu", draft=(tparams, tllama.get_config("tiny-moe")))
    spec = ServingEngine(tparams, tcfg, device="cpu", draft=(tparams, tcfg), spec_k=3, **GEOMETRY)
    with pytest.raises(ValueError, match=r"context limit \(61 = .* spec_k \(3\)"):
        spec.submit([1] * 60, 2)
    engine = ServingEngine(tparams, tcfg, device="cpu", **GEOMETRY)  # not started
    for bad in (float("nan"), -0.1, float("inf")):
        with pytest.raises(ValueError, match="temperature"):
            engine.submit([1, 2], 2, temperature=bad)
    with pytest.raises(ValueError, match="top_k"):
        engine.submit([1, 2], 2, top_k=-1)
    with pytest.raises(ValueError, match="context limit"):
        engine.submit([1] * 60, 10)
