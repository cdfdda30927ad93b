"""The port's prefill/decode disaggregation against the JAX package's, on
the CPU: KV-page export and import, the shipment wire format, the
decode-role admission with its degrade rules, the /v1/prefill and
/v1/prefilled routes over a shared dir and over HTTP, and the metrics and
spans of the new paths.

fp32 `tiny` configs (target PRNGKey(0), draft PRNGKey(1)) carried across
with `params_from_jax`, in the geometry of tests/test_serving_fleet.py. Each
test names the JAX test it mirrors."""

import asyncio
import http.server
import json
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modal_tpu.models import llama as jllama
from modal_tpu.models import paged_kv as jpk
from modal_tpu.observability import catalog as jcatalog
from modal_tpu.serving.engine import ServingEngine as JaxEngine
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.models import paged_kv as tpk
from modal_tpu_torch.models.convert import params_from_jax
from modal_tpu_torch.observability import catalog as tcatalog
from modal_tpu_torch.observability import tracing
from modal_tpu_torch.serving import ServingEngine, asgi_request, serving_asgi_app
from modal_tpu_torch.serving import engine as tengine
from modal_tpu_torch.serving import shipment as wire

SLOTS, PAGES, PAGE, PAGES_PER_SLOT = 4, 25, 16, 8
GEOMETRY = dict(max_slots=SLOTS, num_pages=PAGES, page_size=PAGE, pages_per_slot=PAGES_PER_SLOT,
                prefill_chunk=32)
PROMPT = list(range(40, 77))  # 37 tokens = 2 full pages + a partial


@pytest.fixture(scope="module")
def models():
    """(JAX target, port target, port draft), each (params, cfg)."""
    jcfg = jllama.get_config("tiny", dtype=jnp.float32)
    tcfg = tllama.get_config("tiny", dtype=torch.float32)
    jt = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    jd = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    port = [params_from_jax(jax.tree_util.tree_map(np.asarray, p), device="cpu") for p in (jt, jd)]
    return (jt, jcfg), (port[0], tcfg), (port[1], tcfg)


def _engine(model, **overrides):
    return ServingEngine(*model, device="cpu", **{**GEOMETRY, **overrides})


def _drive(requests, run_once):
    for _ in range(3000):
        if all(r.done for r in requests):
            return [r.result(timeout=0) for r in requests]
        run_once()
    raise AssertionError("engine did not finish its requests")


def _one(eng, req):
    return _drive([req], eng.run_once)[0]


def _export(eng, prompt=PROMPT, **sampling):
    req = eng.prefill_export(prompt, **sampling)
    _one(eng, req)
    return req.shipment


def test_export_import_pages_match_jax(models):
    """Mirrors models/paged_kv.py's export_pages / import_pages: the same
    pool contents export to the same page values, as CPU tensors in the pool
    dtype; an import of JAX's numpy export lands the same bytes."""
    (jparams, jcfg), (tparams, tcfg), _td = models
    jcache = jpk.PagedKVCache.create(jcfg, 2, 10, 8, 4)
    tcache = tpk.PagedKVCache.create(tcfg, 2, 10, 8, 4, device="cpu")
    prompt = np.arange(3, 22, dtype=np.int32)  # 19 tokens over 3 pages
    padded = np.zeros((32,), np.int32)
    padded[: len(prompt)] = prompt
    pages = [4, 7, 2]
    jcache = jpk.assign_pages(jcache, 1, 0, jnp.asarray(pages, jnp.int32))
    tpk.assign_pages(tcache, 1, 0, pages)
    _l, _t, jcache = jpk.paged_prefill(jparams, jcfg, jnp.asarray(padded), jnp.int32(len(prompt)),
                                        jcache, jnp.int32(1), jnp.int32(0))
    tpk.paged_prefill(tparams, tcfg, torch.from_numpy(padded.astype(np.int64)), len(prompt), tcache, 1, 0)
    jdata = jpk.export_pages(jcache, pages)
    tdata = tpk.export_pages(tcache, pages)
    for name in ("k", "v"):
        assert tdata[name].device.type == "cpu" and tdata[name].dtype == torch.float32
        assert tdata[name].shape == (tcfg.n_layers, 3, 8, tcfg.n_kv_heads, tcfg.head_dim)
        np.testing.assert_allclose(tdata[name].numpy(), np.asarray(jdata[name]), atol=1e-5, rtol=0)
    other = tpk.PagedKVCache.create(tcfg, 2, 10, 8, 4, device="cpu")
    tpk.import_pages(other, [9, 1, 5], {"k": np.asarray(jdata["k"]), "v": np.asarray(jdata["v"])})
    back = tpk.export_pages(other, [9, 1, 5])
    assert np.array_equal(back["k"].numpy(), np.asarray(jdata["k"]))
    assert np.array_equal(back["v"].numpy(), np.asarray(jdata["v"]))
    bf16 = tpk.PagedKVCache.create(tllama.get_config("tiny"), 2, 10, 8, 4, device="cpu")
    tpk.import_pages(bf16, [3], {"k": tdata["k"][:, :1], "v": tdata["v"][:, :1]})
    assert torch.equal(tpk.export_pages(bf16, [3])["k"], tdata["k"][:, :1].to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_shipment_wire_format_round_trips(dtype):
    rng = np.random.default_rng(3)
    k, v = (torch.from_numpy(rng.standard_normal((2, 3, 16, 2, 32)).astype(np.float32)).to(dtype)
            for _ in range(2))
    bundle = {"prompt": [5, 6, 7], "first_token": 11, "n_tokens": 3, "k": k, "v": v}
    back = wire.decode(wire.encode(bundle))
    assert back["prompt"] == [5, 6, 7] and back["first_token"] == 11 and back["n_tokens"] == 3
    for name in ("k", "v"):
        assert back[name].dtype == dtype and torch.equal(back[name], bundle[name])
    with pytest.raises(ValueError, match="dict"):
        wire.decode(wire.encode([1, 2]))


def test_kv_shipment_roundtrip_token_identity_and_prefix_publish(models):
    """Mirrors tests/test_serving_fleet.py::test_kv_shipment_roundtrip_token_identity_and_prefix_publish:
    a prompt prefilled on one engine and decoded on another emits the
    all-in-one engine's stream; the imported pages then serve the decode
    engine's own prefix cache."""
    _jt, tt, _td = models
    ref_eng, pre_eng, dec_eng = _engine(tt), _engine(tt, role="prefill"), _engine(tt, role="decode")
    try:
        ref = _one(ref_eng, ref_eng.submit(PROMPT, 12))
        r = pre_eng.prefill_export(PROMPT)
        assert _one(pre_eng, r) == ref[:1]
        ship = r.shipment
        assert ship is not None and ship["k"].shape[1] == 3  # ceil(37/16) pages
        st = pre_eng.stats()
        assert st["kv_pages_shipped"] == 3 and st["role"] == "prefill" and st["steps"] == 0
        assert _one(dec_eng, dec_eng.submit_prefilled(PROMPT, ship, 12)) == ref
        st = dec_eng.stats()
        assert st["remote_prefills"] == 1 and st["role"] == "decode"
        assert _one(dec_eng, dec_eng.submit(PROMPT, 12)) == ref
        st = dec_eng.stats()
        assert st["prefix_cache_hits"] >= 1 and len(st["prefix_digests"]) >= 1
    finally:
        for e in (ref_eng, pre_eng, dec_eng):
            e.stop()
    assert dec_eng.allocator.free_pages == PAGES - 1


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "sampled"])
def test_jax_exported_shipment_decodes_in_the_port(models, temperature):
    """A shipment exported by the JAX engine (fp32 numpy k/v), submitted to
    the port's decode engine, decodes to the JAX all-in-one engine's stream.
    Greedy only is token-for-token: the port's sampled tokens come from its
    own generators; for a sampled request the first (JAX-sampled) token is
    the JAX one and the stream has its length."""
    (jparams, jcfg), tt, _td = models
    jeng = JaxEngine(jparams, jcfg, **GEOMETRY).start()
    try:
        want = jeng.submit(PROMPT, 12, temperature=temperature, seed=5).result(timeout=120)
        r = jeng.prefill_export(PROMPT, temperature=temperature, seed=5)
        r.result(timeout=120)
        ship = r.shipment
    finally:
        jeng.stop()
    assert isinstance(ship["k"], np.ndarray) and ship["k"].dtype == np.float32
    dec = _engine(tt, role="decode")
    try:
        got = _one(dec, dec.submit_prefilled(PROMPT, ship, 12, temperature=temperature, seed=5))
    finally:
        dec.stop()
    assert dec.stats()["remote_prefills"] == 1
    if temperature == 0.0:
        assert got == want
    else:
        assert got[0] == want[0] and len(got) == 12


def test_chaos_kv_ship_drop_falls_back_to_local_prefill(models, monkeypatch):
    """Mirrors tests/test_serving_fleet.py::test_chaos_kv_ship_drop_falls_back_to_local_prefill."""
    _jt, tt, _td = models
    pre_eng, eng = _engine(tt), _engine(tt)
    try:
        ship = _export(pre_eng)
        ref = _one(pre_eng, pre_eng.submit(PROMPT, 12))
        monkeypatch.setenv("MODAL_TPU_CHAOS_KV_SHIP_DROP", "1")
        tengine._reset_kv_ship_chaos_for_tests()
        assert _one(eng, eng.submit_prefilled(PROMPT, ship, 12)) == ref
        st = eng.stats()
        assert st["kv_ship_drops"] == 1 and st["remote_prefills"] == 0
        monkeypatch.setenv("MODAL_TPU_CHAOS_KV_SHIP_DROP", "0")
        tengine._reset_kv_ship_chaos_for_tests()
        assert _one(eng, eng.submit_prefilled(list(PROMPT), ship, 12)) == ref
        st = eng.stats()
        assert st["kv_ship_drops"] == 1 and st["remote_prefills"] == 1
    finally:
        tengine._reset_kv_ship_chaos_for_tests()
        pre_eng.stop()
        eng.stop()


def test_mismatched_shipment_is_rejected_not_imported(models):
    """Mirrors tests/test_serving_fleet.py::test_mismatched_shipment_is_rejected_not_imported,
    plus a shipment of another head geometry."""
    _jt, tt, _td = models
    pre_eng, eng = _engine(tt), _engine(tt)
    try:
        ship = _export(pre_eng)
        with pytest.raises(ValueError, match="shipment"):
            eng.submit_prefilled(PROMPT + [1], ship, 4)  # wrong prompt
        with pytest.raises(ValueError, match="shipment"):
            eng.submit_prefilled(PROMPT, dict(ship, k=ship["k"][:, :1]), 4)  # wrong page count
        with pytest.raises(ValueError, match="shipment"):
            eng.submit_prefilled(PROMPT, dict(ship, v=ship["v"][..., :8]), 4)  # wrong head dim
        assert not eng.waiting
    finally:
        pre_eng.stop()
        eng.stop()


def test_serving_role_knob_resolution(models, monkeypatch):
    """Mirrors tests/test_serving_fleet.py::test_serving_role_knob_resolution."""
    _jt, tt, _td = models
    monkeypatch.delenv("MODAL_TPU_SERVING_ROLE", raising=False)
    assert tengine.resolve_role() == "both"
    assert _engine(tt).role == "both"
    monkeypatch.setenv("MODAL_TPU_SERVING_ROLE", "prefill")
    assert tengine.resolve_role() == "prefill"
    assert _engine(tt).role == "prefill"
    assert tcatalog.SERVING_ROLE.value() == float(tengine.ROLE_GAUGE_VALUES["prefill"])
    assert _engine(tt, role="decode").role == "decode"
    assert tcatalog.SERVING_ROLE.value() == 2.0
    monkeypatch.setenv("MODAL_TPU_SERVING_ROLE", "bogus")
    assert tengine.resolve_role() == "both"
    assert tengine.ROLE_GAUGE_NAMES[2] == "decode"


def test_remote_prefill_into_spec_engine_token_identity(models):
    """Mirrors tests/test_serving_fleet.py::test_remote_prefill_into_spec_engine_token_identity:
    the target side imports, the draft prefills locally, and the stream is
    the spec engine's own local one."""
    _jt, tt, td = models
    pre_eng = _engine(tt, role="prefill")
    spec_a = _engine(tt, draft=td, spec_k=2)
    spec_b = _engine(tt, draft=td, spec_k=2, role="decode")
    try:
        ref = _one(spec_a, spec_a.submit(PROMPT, 10))
        out = _one(spec_b, spec_b.submit_prefilled(PROMPT, _export(pre_eng), 10))
        assert out == ref
        assert spec_b.stats()["remote_prefills"] == 1
    finally:
        for e in (pre_eng, spec_a, spec_b):
            e.stop()


def test_prefill_endpoint_ships_and_prefilled_decodes(models, tmp_path, monkeypatch):
    """Mirrors tests/test_serving_fleet.py::test_prefill_endpoint_ships_and_prefilled_decodes,
    through the ASGI app in process with a shared dir."""
    monkeypatch.setenv("MODAL_TPU_BLOB_LOCAL_DIR", str(tmp_path / "blobs"))
    _jt, tt, _td = models
    engine = _engine(tt).start()
    app = serving_asgi_app(engine)

    async def exchange():
        async def post(path, body):
            status, raw = await asgi_request(app, "POST", path, body)
            return status, json.loads(raw)

        direct = await post("/v1/generate", {"prompt": PROMPT, "max_new_tokens": 8})
        ship = await post("/v1/prefill", {"prompt": PROMPT})
        out = await post("/v1/prefilled", {"prompt": PROMPT, "kv_ref": ship[1]["kv_ref"],
                                           "max_new_tokens": 8})
        garbage = await post("/v1/prefilled", {"prompt": PROMPT, "kv_ref": str(tmp_path / "nope.bin"),
                                               "max_new_tokens": 8})
        missing = await post("/v1/prefilled", {"prompt": PROMPT, "max_new_tokens": 8})
        bad = await post("/v1/prefill", {"prompt": PROMPT, "top_p": 0})
        return direct, ship, out, garbage, missing, bad

    try:
        direct, ship, out, garbage, missing, bad = asyncio.run(exchange())
        stats = engine.stats()
    finally:
        engine.stop()
    assert direct[0] == ship[0] == out[0] == garbage[0] == 200
    assert ship[1]["n_tokens"] == len(PROMPT) and ship[1]["first_token"] == direct[1]["tokens"][0]
    assert str(tmp_path / "blobs") in ship[1]["kv_ref"] and os.path.exists(ship[1]["kv_ref"])
    assert out[1]["tokens"] == direct[1]["tokens"]
    assert garbage[1]["tokens"] == direct[1]["tokens"]  # unreadable: a local prefill, same tokens
    assert stats["remote_prefills"] == 1
    assert missing[0] == 400 and "kv_ref" in missing[1]["error"]
    assert bad[0] == 400


class _BlobHandler(http.server.BaseHTTPRequestHandler):
    """A blob plane in miniature: PUT stores the body under the path, GET
    returns it."""

    store: dict = {}

    def do_PUT(self):  # noqa: N802 — http.server's naming
        self.store[self.path] = self.rfile.read(int(self.headers["Content-Length"]))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self):  # noqa: N802
        data = self.store.get(self.path)
        self.send_response(200 if data is not None else 404)
        self.send_header("Content-Length", str(len(data or b"")))
        self.end_headers()
        self.wfile.write(data or b"")

    def log_message(self, *args):
        pass


def test_kv_ship_over_http_plane_no_shared_fs(models, monkeypatch):
    """Mirrors tests/test_serving_fleet.py::test_kv_ship_over_blob_http_plane_no_shared_fs,
    against an http.server on 127.0.0.1: /v1/prefill PUTs the shipment and
    answers an http kv_ref, /v1/prefilled on another engine GETs it."""
    monkeypatch.delenv("MODAL_TPU_BLOB_LOCAL_DIR", raising=False)
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _BlobHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    monkeypatch.setenv("MODAL_TPU_KV_SHIP_URL", base)
    _jt, tt, _td = models
    eng_a, eng_b = _engine(tt, role="prefill").start(), _engine(tt, role="decode").start()
    app_a, app_b = serving_asgi_app(eng_a), serving_asgi_app(eng_b)

    async def exchange():
        direct = await asgi_request(app_b, "POST", "/v1/generate", {"prompt": PROMPT, "max_new_tokens": 8})
        ship = json.loads((await asgi_request(app_a, "POST", "/v1/prefill", {"prompt": PROMPT}))[1])
        out = await asgi_request(app_b, "POST", "/v1/prefilled",
                                 {"prompt": PROMPT, "kv_ref": ship["kv_ref"], "max_new_tokens": 8})
        return json.loads(direct[1]), ship, json.loads(out[1])

    try:
        direct, ship, out = asyncio.run(exchange())
        stats = eng_b.stats()
    finally:
        eng_a.stop()
        eng_b.stop()
        server.shutdown()
        server.server_close()
        thread.join(10)
    assert ship["kv_ref"].startswith(f"{base}/blob/kvship-"), ship["kv_ref"]
    assert out["tokens"] == direct["tokens"]
    assert stats["remote_prefills"] == 1


def test_kv_ship_url_unreachable_degrades_to_local_file(models, monkeypatch, tmp_path):
    """Mirrors tests/test_serving_fleet.py::test_kv_ship_url_unreachable_degrades_to_local_file:
    a dead blob plane must not fail the prefill leg."""
    monkeypatch.delenv("MODAL_TPU_BLOB_LOCAL_DIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("MODAL_TPU_KV_SHIP_URL", "http://127.0.0.1:9")  # discard port: refused
    _jt, tt, _td = models
    engine = _engine(tt).start()
    app = serving_asgi_app(engine)

    async def exchange():
        ship = json.loads((await asgi_request(app, "POST", "/v1/prefill", {"prompt": PROMPT}))[1])
        out = await asgi_request(app, "POST", "/v1/prefilled",
                                 {"prompt": PROMPT, "kv_ref": ship["kv_ref"], "max_new_tokens": 8})
        return ship, json.loads(out[1])

    try:
        ship, out = asyncio.run(exchange())
        stats = engine.stats()
    finally:
        engine.stop()
    assert ship["kv_ref"].startswith(str(tmp_path)) and os.path.exists(ship["kv_ref"])
    assert len(out["tokens"]) == 8 and stats["remote_prefills"] == 1


def test_fleet_metrics_and_spans(models):
    """Mirrors tests/test_serving_fleet.py::test_fleet_metrics_and_spans_are_cataloged:
    the four families carry the JAX catalog's names, help texts and buckets,
    and a speculative round and a shipment record serving.spec_verify and
    serving.kv_ship (export and import sides) under their requests."""
    for name in ("SERVING_SPEC_ACCEPT_RATIO", "SERVING_ROLE", "KV_PAGES_SHIPPED", "KV_SHIP_SECONDS"):
        mine, ref = getattr(tcatalog, name), getattr(jcatalog, name)
        assert (type(mine).__name__, mine.name, mine.help) == (type(ref).__name__, ref.name, ref.help)
        assert getattr(mine, "buckets", None) == getattr(ref, "buckets", None)
    _jt, tt, td = models
    spans = []
    tracing.add_span_tap(spans.append)
    ship_obs_before = tcatalog.KV_SHIP_SECONDS.totals()[1]
    pre_eng, dec_eng = _engine(tt, role="prefill"), _engine(tt, draft=td, spec_k=2, role="decode")
    try:
        ship = _export(pre_eng)
        req = dec_eng.submit_prefilled(PROMPT, ship, 6)
        _one(dec_eng, req)
    finally:
        tracing.remove_span_tap(spans.append)
        pre_eng.stop()
        dec_eng.stop()
    by_name = {}
    for sp in spans:
        by_name.setdefault(sp.name, []).append(sp)
    sides = sorted(sp.attrs["side"] for sp in by_name["serving.kv_ship"])
    assert sides == ["export", "import"]
    assert all(sp.attrs["pages"] == 3 for sp in by_name["serving.kv_ship"])
    verify = by_name["serving.spec_verify"]
    assert verify and all(sp.trace_id == req.trace_context.trace_id for sp in verify)
    assert sum(sp.attrs["proposed"] for sp in verify) == 2 * dec_eng.stats()["spec_rounds"]
    assert pre_eng.stats()["kv_pages_shipped"] == 3
    assert tcatalog.KV_SHIP_SECONDS.totals()[1] == ship_obs_before + 1
    assert tcatalog.SERVING_SPEC_ACCEPT_RATIO.value() >= 0.0
