"""The port's serving engine against the JAX package's, on the CPU.

Both engines get the same converted fp32 `tiny` params, the same geometry
and the same request schedule, and are driven iteration by iteration (no
engine thread), so the schedule itself is deterministic. fp32 keeps the two
frameworks' logits within ~1e-6, far from the argmax near-ties a random-init
model has under bf16."""

import asyncio
import json
import os

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


def test_moe_target_and_draft_are_refused_with_value_error(fp32_tiny):
    """Paged serving is dense-only, as in the JAX engine, which raises
    ValueError for an MoE target (modal_tpu/serving/engine.py:373-374) as
    well as for an MoE draft."""
    jparams, jcfg, tparams, tcfg = fp32_tiny
    moe = tllama.get_config("tiny-moe")
    with pytest.raises(ValueError, match="MoE"):
        ServingEngine(tparams, moe, device="cpu", **GEOMETRY)
    with pytest.raises(ValueError, match="MoE"):
        JaxEngine(jparams, jllama.get_config("tiny-moe"), **GEOMETRY)
    with pytest.raises(ValueError, match="MoE draft"):
        ServingEngine(tparams, tcfg, device="cpu", draft=(tparams, moe), **GEOMETRY)


class _StrictSend:
    """An ASGI server's send: a second http.response.start, or any message
    after the response ended, raises (as uvicorn's does)."""

    def __init__(self):
        self.messages = []
        self.started = self.ended = False

    async def __call__(self, msg):
        if self.ended or (msg["type"] == "http.response.start" and self.started):
            raise RuntimeError(f"unexpected ASGI message {msg['type']!r}")
        self.started = self.started or msg["type"] == "http.response.start"
        self.ended = msg["type"] == "http.response.body" and not msg.get("more_body", False)
        self.messages.append(msg)


def _scope(method, path):
    return {"type": "http", "method": method, "path": path, "headers": []}


def _receive_once(body: dict):
    payload = json.dumps(body).encode()
    sent = False

    async def receive():
        nonlocal sent
        if not sent:
            sent = True
            return {"type": "http.request", "body": payload, "more_body": False}
        await asyncio.sleep(3600)
        return {"type": "http.disconnect"}

    return receive


def test_handler_failing_mid_stream_does_not_raise_out_of_the_app(fp32_tiny, monkeypatch):
    """Once an SSE stream has started, the 500 reply cannot be sent (a second
    http.response.start). The JAX app swallows that (modal_tpu/serving/
    api.py:532-536); so must the port's: the app returns, the stream just ends
    without its done event."""
    from modal_tpu_torch.serving import api as tapi

    _jp, _jc, tparams, tcfg = fp32_tiny
    engine = ServingEngine(tparams, tcfg, device="cpu", **GEOMETRY).start()
    app = serving_asgi_app(engine)

    def broken_payload(req, vocab_size):
        raise RuntimeError("payload failed after the stream began")

    monkeypatch.setattr(tapi, "_result_payload", broken_payload)
    send = _StrictSend()
    try:
        asyncio.run(app(_scope("POST", "/v1/generate"),
                        _receive_once({"prompt": [5, 6, 7], "max_new_tokens": 3, "stream": True}), send))
    finally:
        engine.stop()
    starts = [m for m in send.messages if m["type"] == "http.response.start"]
    assert [m["status"] for m in starts] == [200]
    body = b"".join(m.get("body", b"") for m in send.messages if m["type"] == "http.response.body")
    assert body.count(b"event: token") == 3 and b"event: done" not in body


def test_ship_put_http_exception_degrades_to_a_local_file(fp32_tiny, monkeypatch, tmp_path):
    """Any failure of the blob-plane PUT degrades the prefill leg to the
    shared-file handoff, never to a 500 (modal_tpu/serving/api.py:404), an
    http.client.HTTPException (neither OSError nor ValueError) included."""
    import http.client
    import tempfile

    from modal_tpu_torch.serving import api as tapi

    def failing_put(base, name, payload):
        raise http.client.HTTPException("malformed status line from the blob plane")

    monkeypatch.delenv("MODAL_TPU_BLOB_LOCAL_DIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("MODAL_TPU_KV_SHIP_URL", "http://blob-plane.invalid:8000")
    monkeypatch.setattr(tapi, "_ship_put_http", failing_put)
    _jp, _jc, tparams, tcfg = fp32_tiny
    engine = ServingEngine(tparams, tcfg, device="cpu", **GEOMETRY).start()
    app = serving_asgi_app(engine)
    prompt = list(range(3, 21))

    async def exchange():
        ship = await asgi_request(app, "POST", "/v1/prefill", {"prompt": prompt})
        ref = json.loads(ship[1])
        out = await asgi_request(app, "POST", "/v1/prefilled",
                                 {"prompt": prompt, "kv_ref": ref.get("kv_ref", ""), "max_new_tokens": 5})
        return ship[0], ref, out

    try:
        status, ref, out = asyncio.run(exchange())
        stats = engine.stats()
    finally:
        engine.stop()
    assert status == 200, ref
    assert ref["kv_ref"].startswith(str(tmp_path)) and os.path.exists(ref["kv_ref"])
    assert out[0] == 200 and len(json.loads(out[1])["tokens"]) == 5
    assert stats["remote_prefills"] == 1


async def _stream_until_reset(app, body: dict):
    """Drive one streaming /v1/generate through an ASGI app; returns (the
    bytes sent, whether the app cut the stream with ConnectionResetError)."""
    send = _StrictSend()
    try:
        await app(_scope("POST", "/v1/generate"), _receive_once(body), send)
        cut = False
    except ConnectionResetError:
        cut = True
    body_bytes = b"".join(m.get("body", b"") for m in send.messages if m["type"] == "http.response.body")
    return body_bytes, cut


def test_chaos_stream_resets_cut_exactly_budget_streams_like_jax(fp32_tiny, monkeypatch):
    """MODAL_TPU_CHAOS_SERVING_STREAM_RESETS=2 over three streams: the first
    two are cut after their first token event with ConnectionResetError and
    the bytes the JAX app sends on the same budget; the third runs to its
    done event. Every cut request still finishes in its engine, and its
    buffer holds the whole stream."""
    from modal_tpu.serving import api as japi
    from modal_tpu.serving.api import serving_asgi_app as jax_app
    from modal_tpu_torch.observability.catalog import SERVING_STREAM_EVENTS
    from modal_tpu_torch.serving import api as tapi

    jparams, jcfg, tparams, tcfg = fp32_tiny
    monkeypatch.setenv(tapi.STREAM_RESET_ENV, "2")
    assert tapi.STREAM_RESET_ENV == japi.STREAM_RESET_ENV
    results = {}
    engines = {"jax": JaxEngine(jparams, jcfg, **GEOMETRY), "port": ServingEngine(tparams, tcfg, device="cpu", **GEOMETRY)}
    apps = {"jax": jax_app(engines["jax"]), "port": serving_asgi_app(engines["port"])}
    resets0 = SERVING_STREAM_EVENTS.value(event="reset")
    try:
        for name, module in (("jax", japi), ("port", tapi)):
            module._reset_chaos_for_tests()
            engines[name].start()

            async def streams(app=apps[name], tag=name):
                return [
                    await _stream_until_reset(app, {"prompt": [9, 8, 7, i], "max_new_tokens": 6, "stream": True,
                                                    "request_id": f"chaos-{i}"})
                    for i in range(3)
                ]

            results[name] = asyncio.run(streams())
            for i in range(3):
                req = engines[name].get(f"chaos-{i}")
                assert req.result(timeout=60) and len(req.tokens) == 6 and req.error is None
    finally:
        for name, module in (("jax", japi), ("port", tapi)):
            engines[name].stop()
            module._reset_chaos_for_tests()
    assert [cut for _b, cut in results["port"]] == [True, True, False]
    assert [cut for _b, cut in results["jax"]] == [True, True, False]
    for (mine, _c), (ref, _r) in zip(results["port"][:2], results["jax"][:2]):
        assert mine == ref and mine.count(b"event: token") == 1 and b"event: done" not in mine
    assert results["port"][2][0].count(b"event: token") == 6 and b"event: done" in results["port"][2][0]
    assert SERVING_STREAM_EVENTS.value(event="reset") - resets0 == 2
