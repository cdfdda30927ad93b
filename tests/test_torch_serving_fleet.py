"""The port's fleet router and the KV shipment over the blob HTTP plane
against the JAX package's, on the CPU (the counterparts of
tests/test_serving_fleet.py).

Router cases drive JAX's `ServingRouter` and the port's through the same
call sequence (`route`, `pick`, `mark_dead`, `refresh_from_stats`) over
fake transports and compare every pick, every transport call and the final
stats. The shipment cases run two port engines of the fp32 `tiny` config
(PRNGKey(0), carried across with `params_from_jax`) behind the port's
`AsgiHttpServer`, shipping through the port's `LocalSupervisor` blob
server, and hold their tokens to the JAX engine's on the same weights."""

import asyncio
import json
import os
import tempfile
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modal_tpu.models import llama as jllama
from modal_tpu.serving import router as jrouter
from modal_tpu.serving.engine import ServingEngine as JaxEngine
from modal_tpu_torch._utils.async_utils import synchronizer as tsync
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.models.convert import params_from_jax
from modal_tpu_torch.observability import catalog as tcatalog
from modal_tpu_torch.observability import tracing
from modal_tpu_torch.runtime.asgi import AsgiHttpServer
from modal_tpu_torch.serving import ServingEngine, serving_asgi_app
from modal_tpu_torch.serving import router as trouter
from modal_tpu_torch.server.supervisor import LocalSupervisor

PAGE = 16
GEOMETRY = dict(max_slots=4, num_pages=25, page_size=PAGE, pages_per_slot=8, prefill_chunk=32)
PROMPT = list(range(40, 77))  # 37 tokens = 2 full pages + a partial


class _FakeReplica:
    """Transport double: records calls, optionally dies (ConnectionError)."""

    def __init__(self, name: str):
        self.name = name
        self.calls: list = []
        self.dead = False

    def __call__(self, path: str, body: dict):
        if self.dead:
            raise ConnectionError(f"{self.name} unreachable")
        self.calls.append((path, dict(body)))
        if path == "/v1/prefill":
            return {"kv_ref": f"/tmp/{self.name}.bin", "first_token": 7, "n_tokens": len(body["prompt"]),
                    "request_id": body.get("request_id", "")}
        return {"request_id": body.get("request_id", ""), "replica": self.name}


def _fleet(router_mod, n: int = 3, **kw):
    reps = {f"r{i}": _FakeReplica(f"r{i}") for i in range(n)}
    return router_mod.ServingRouter(dict(reps), page_size=PAGE, **kw), reps


def _script(router_mod, **kw) -> list:
    """One fixed call sequence through a fleet of 4 fake replicas: cold
    picks of 40 prompts, routed requests and followers, sessions, a stats
    refresh, a death mid-session, a second death, the two-leg path and
    its degrade. Returns every observable outcome in order."""
    router, reps = _fleet(router_mod, 4, prefill_replicas=("r3",), seed=11, **kw)
    log = []
    for base in range(0, 400, 10):
        log.append(("pick", router.pick(list(range(base, base + PAGE + base % 7)))))
    for i in range(6):
        prompt = PROMPT if i % 2 else list(range(100 + i, 140 + i))
        log.append(("route", router.route({"prompt": prompt, "request_id": f"q{i}"})["replica"]))
        log.append(("follow", router.pick(prompt + [1, 2, 3])))
    log.append(("route-s", router.route({"prompt": PROMPT, "request_id": "s-1"}, session="s1")["replica"]))
    router.refresh_from_stats("r2", {"prefix_digests": [router_mod.prefix_digest(list(range(7, 7 + PAGE)))]})
    log.append(("refreshed", router.pick(list(range(7, 7 + PAGE + 5)))))
    log.append(("affinity", router.pick([9] * 40, session="s1")))
    pinned = router.pick(PROMPT, session="s1")[0]
    reps[pinned].dead = True
    log.append(("reroute", router.route({"prompt": PROMPT, "request_id": "s-2"}, session="s1")["replica"]))
    log.append(("after-death", router.pick(PROMPT, session="s1")))
    router.mark_dead("r1")
    log.append(("split", router.route({"prompt": PROMPT, "request_id": "d-1"}, split_prefill=True)))
    reps["r3"].dead = True
    log.append(("degrade", router.route({"prompt": PROMPT, "request_id": "d-2"}, split_prefill=True)))
    log.append(("calls", {n: r.calls for n, r in reps.items()}))
    log.append(("stats", router.stats()))
    return log


@pytest.mark.parametrize("enabled", ["1", "0"], ids=["router", "seeded_random"])
def test_the_same_calls_pick_the_same_replicas_as_jax(monkeypatch, enabled):
    """Prefix map, cold ring, session affinity with re-pin on death, the
    stats refresh, mark_dead, the two-leg split and its degrade: the port's
    router makes JAX's every pick and transport call; with
    MODAL_TPU_SERVING_ROUTER=0 both fall back to the same seeded-random
    choices."""
    monkeypatch.setenv(trouter.ROUTER_ENV, enabled)
    got, want = _script(trouter), _script(jrouter)
    assert got == want
    stats = dict(got)["stats"]
    assert stats["enabled"] is (enabled == "1") and "r1" not in stats["replicas"]
    if enabled == "1":  # the pinned replica's death re-routed exactly once
        assert stats["reroutes"] == 1


def test_router_disaggregated_two_legs_and_degrade():
    """split_prefill drives /v1/prefill on the prefill tier, then
    /v1/prefilled with its kv_ref on the decode pick; a dead prefill
    replica degrades the SAME request to a direct /v1/generate
    (tests/test_serving_fleet.py:176), and the routing counter and span
    record each route under the caller's span."""
    spans = []
    tracing.add_span_tap(spans.append)
    before = tcatalog.SERVING_ROUTER_ROUTED.total()
    try:
        with tracing.span("test.routes"):
            router, reps = _fleet(trouter, 3, prefill_replicas=("r0",))
            router.route({"prompt": PROMPT, "max_new_tokens": 4, "request_id": "dq-1"}, split_prefill=True)
            reps["r0"].dead = True
            out = router.route({"prompt": PROMPT, "request_id": "dq-2"}, split_prefill=True)
    finally:
        tracing.remove_span_tap(spans.append)
    assert "/v1/prefill" in [p for p, _b in reps["r0"].calls]
    dec = [(n, p, b) for n, r in reps.items() for p, b in r.calls if p == "/v1/prefilled"]
    assert len(dec) == 1 and dec[0][2]["kv_ref"] == "/tmp/r0.bin" and dec[0][2]["request_id"] == "dq-1"
    assert out["request_id"] == "dq-2"
    gen = [b for n, r in reps.items() for p, b in r.calls if p == "/v1/generate"]
    assert any(b["request_id"] == "dq-2" for b in gen)
    assert router.prefill_fallbacks == 1
    assert tcatalog.SERVING_ROUTER_ROUTED.total() - before == 2
    routed = [s for s in spans if s.name == "serving.route"]
    assert [s.attrs["request_id"] for s in routed] == ["dq-1", "dq-2"] and all(s.attrs["split"] for s in routed)


# -- the KV shipment over the blob HTTP plane ----------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.get_config("tiny", dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return (jparams, jcfg), (tparams, tllama.get_config("tiny", dtype=torch.float32))


@pytest.fixture(scope="module")
def blob_plane():
    sup = LocalSupervisor(num_workers=0, state_dir=tempfile.mkdtemp(prefix="fleet-", dir="/tmp"))
    tsync.run(sup.start())
    try:
        yield sup
    finally:
        tsync.run(sup.stop())


def _post(url: str, path: str, body: dict) -> dict:
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(), method="POST",
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


class _Servers:
    """Port engines behind the port's AsgiHttpServer, on one serving loop."""

    def __init__(self, engines):
        self.loop = asyncio.new_event_loop()
        threading.Thread(target=self.loop.run_forever, daemon=True).start()
        self.engines = [e.start() for e in engines]
        self.servers = [AsgiHttpServer(serving_asgi_app(e)) for e in self.engines]
        for srv in self.servers:
            asyncio.run_coroutine_threadsafe(srv.start(), self.loop).result(30)

    def close(self):
        for srv in self.servers:
            asyncio.run_coroutine_threadsafe(srv.stop(), self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        for e in self.engines:
            e.stop()


def _jax_tokens(jmodel, n: int) -> list:
    eng = JaxEngine(*jmodel, **GEOMETRY).start()
    try:
        return eng.submit(PROMPT, n).result(timeout=120)
    finally:
        eng.stop()


def test_kv_ship_over_the_blob_http_plane_no_shared_fs(models, blob_plane, monkeypatch):
    """Two port engines that share no filesystem: /v1/prefill on the
    prefill replica PUTs the shipment to the port's blob server and answers
    an http kv_ref; /v1/prefilled on the decode replica GETs it and decodes
    the JAX engine's tokens (tests/test_serving_fleet.py:578). A
    ServingRouter over HTTP transports drives the same two legs with no
    prefill fallback."""
    monkeypatch.delenv("MODAL_TPU_BLOB_LOCAL_DIR", raising=False)
    blob_url = blob_plane.state.blob_url_base
    assert blob_url
    monkeypatch.setenv("MODAL_TPU_KV_SHIP_URL", blob_url)
    jmodel, tmodel = models
    want = _jax_tokens(jmodel, 8)
    servers = _Servers([ServingEngine(*tmodel, device="cpu", role=role, **GEOMETRY) for role in ("prefill", "decode")])
    pre, dec = (srv.url for srv in servers.servers)
    try:
        ship = _post(pre, "/v1/prefill", {"prompt": PROMPT})
        assert ship["kv_ref"].startswith(f"{blob_url}/blob/"), ship["kv_ref"]
        out = _post(dec, "/v1/prefilled", {"prompt": PROMPT, "kv_ref": ship["kv_ref"], "max_new_tokens": 8})
        assert out["tokens"] == want
        transports = {name: (lambda url: (lambda path, body: _post(url, path, body)))(url)
                      for name, url in (("pre", pre), ("dec", dec))}
        router = trouter.ServingRouter(transports, page_size=PAGE, prefill_replicas=("pre",))
        routed = router.route({"prompt": PROMPT, "max_new_tokens": 8}, split_prefill=True)
        assert routed["tokens"] == want and router.prefill_fallbacks == 0
        assert servers.engines[1].stats()["remote_prefills"] == 2
        assert servers.engines[0].stats()["steps"] == 0
    finally:
        servers.close()


def test_an_unreachable_ship_url_degrades_to_a_local_file(models, monkeypatch):
    """A dead blob plane does not fail the prefill leg: the shipment falls
    back to a local file and the decode leg still lands it
    (tests/test_serving_fleet.py:622)."""
    monkeypatch.delenv("MODAL_TPU_BLOB_LOCAL_DIR", raising=False)
    monkeypatch.setenv("MODAL_TPU_KV_SHIP_URL", "http://127.0.0.1:9")  # the discard port
    servers = _Servers([ServingEngine(*models[1], device="cpu", **GEOMETRY)])
    url = servers.servers[0].url
    try:
        ship = _post(url, "/v1/prefill", {"prompt": PROMPT})
        assert not ship["kv_ref"].startswith("http") and os.path.exists(ship["kv_ref"])
        out = _post(url, "/v1/prefilled", {"prompt": PROMPT, "kv_ref": ship["kv_ref"], "max_new_tokens": 8})
        assert len(out["tokens"]) == 8 and servers.engines[0].stats()["remote_prefills"] == 1
    finally:
        servers.close()


def test_export_pages_stages_a_cpu_pool_bit_equal(models):
    """`export_pages` returns the named pages bit-equal to the pool's (the
    staged copy is for a card's pool; a CPU pool's pages are copied
    plainly), and an import lands them bit-equal."""
    from modal_tpu_torch.models import paged_kv as tpk

    params, cfg = models[1]
    eng = ServingEngine(params, cfg, device="cpu", **GEOMETRY)
    gen = torch.Generator().manual_seed(3)
    for pages in (eng.cache.k_pages, eng.cache.v_pages):
        pages.copy_(torch.randn(pages.shape, generator=gen, dtype=pages.dtype))
    ids = [3, 1, 7]
    out = tpk.export_pages(eng.cache, ids)
    assert torch.equal(out["k"], eng.cache.k_pages[:, ids]) and torch.equal(out["v"], eng.cache.v_pages[:, ids])
    other = ServingEngine(params, cfg, device="cpu", **GEOMETRY)
    tpk.import_pages(other.cache, [2, 4, 5], out)
    assert torch.equal(other.cache.k_pages[:, [2, 4, 5]], out["k"])


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
def test_export_pages_from_the_card_is_pinned_and_bit_equal():
    """On a card, `export_pages` copies into pinned host memory and lands
    bit-equal to a plain `.cpu()` of the same pages, export after export."""
    from modal_tpu_torch.models import paged_kv as tpk

    cfg = tllama.get_config("tiny", dtype=torch.bfloat16)
    cache = tpk.PagedKVCache.create(cfg, 2, 64, page_size=PAGE, pages_per_slot=16, device="cuda")
    for pages in (cache.k_pages, cache.v_pages):
        pages.copy_(torch.randn(pages.shape, device="cuda", dtype=pages.dtype))
    for ids in (list(range(1, 40, 3)), [5], list(range(63, 0, -2))):
        out = tpk.export_pages(cache, ids)
        idx = torch.tensor(ids, device="cuda")
        assert out["k"].is_pinned() and out["v"].is_pinned()
        assert torch.equal(out["k"], cache.k_pages.index_select(1, idx).cpu())
        assert torch.equal(out["v"], cache.v_pages.index_select(1, idx).cpu())
