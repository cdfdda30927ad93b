"""The port's speculative decoding against the JAX package's, on the CPU.

fp32 `tiny` configs: the target from PRNGKey(0), a distinct draft from
PRNGKey(1), both carried across with `params_from_jax`, in the geometry of
tests/test_serving_fleet.py. fp32 keeps the multi-token verify and the
one-token decode within ~1e-6 of each other and of JAX, far from the argmax
near-ties a random-init model has under bf16. Engines are driven iteration
by iteration (no engine thread), so each schedule is deterministic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modal_tpu.models import llama as jllama
from modal_tpu.models import paged_kv as jpk
from modal_tpu.serving.engine import ServingEngine as JaxEngine
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.models import paged_kv as tpk
from modal_tpu_torch.models.convert import params_from_jax
from modal_tpu_torch.serving import ServingEngine

SLOTS, PAGES, PAGE, PAGES_PER_SLOT = 4, 25, 16, 8
GEOMETRY = dict(max_slots=SLOTS, num_pages=PAGES, page_size=PAGE, pages_per_slot=PAGES_PER_SLOT,
                prefill_chunk=32)
PROMPT = list(range(40, 77))  # 37 tokens = 2 full pages + a partial


@pytest.fixture(scope="module")
def models():
    """(JAX target, JAX draft, port target, port draft), each (params, cfg)."""
    jcfg = jllama.get_config("tiny", dtype=jnp.float32)
    tcfg = tllama.get_config("tiny", dtype=torch.float32)
    out = []
    for seed in (0, 1):
        jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
        tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        out.append(((jparams, jcfg), (tparams, tcfg)))
    (jt, tt), (jd, td) = out
    return jt, jd, tt, td


def _engine(model, **overrides):
    return ServingEngine(*model, device="cpu", **{**GEOMETRY, **overrides})


def _jax_once(eng):
    eng._admit()
    eng._prefill_one()
    eng._decode_step()


def _drive(requests, run_once):
    for _ in range(3000):
        if all(r.done for r in requests):
            return [r.result(timeout=0) for r in requests]
        run_once()
    raise AssertionError("engine did not finish its requests")


def _run(eng, prompts, n, run_once=None, **sampling):
    try:
        reqs = [eng.submit(p, n, **sampling) for p in prompts]
        return _drive(reqs, run_once or eng.run_once), eng.stats()
    finally:
        eng.stop()


def _prompts(count, lo=10, length=21):
    return [list(range(lo + j, lo + j + length)) for j in range(count)]


def test_paged_verify_step_matches_jax(models):
    """Every position's logits of a 4-token verify over two prefilled
    slots, one idle slot: within 1e-4 of JAX's; the KV it wrote at
    seq_lens + [0..3] matches, and seq_lens does not move."""
    (jparams, jcfg), _jd, (tparams, tcfg), _td = models
    jcache = jpk.PagedKVCache.create(jcfg, 3, 16, 8, 4)
    tcache = tpk.PagedKVCache.create(tcfg, 3, 16, 8, 4, device="cpu")
    rng = np.random.default_rng(5)
    rows = {0: [1, 2, 3, 4], 1: [5, 6, 7, 8]}
    for slot, pages in rows.items():
        jcache = jpk.assign_pages(jcache, slot, 0, jnp.asarray(pages, jnp.int32))
        tpk.assign_pages(tcache, slot, 0, pages)
        prompt = rng.integers(0, jcfg.vocab_size, size=11 + 6 * slot).astype(np.int32)
        padded = np.zeros((32,), np.int32)
        padded[: len(prompt)] = prompt
        _l, _t, jcache = jpk.paged_prefill(
            jparams, jcfg, jnp.asarray(padded), jnp.int32(len(prompt)), jcache, jnp.int32(slot),
            jnp.int32(0),
        )
        tpk.paged_prefill(tparams, tcfg, torch.from_numpy(padded.astype(np.int64)), len(prompt),
                          tcache, slot, 0)
    tokens = rng.integers(0, jcfg.vocab_size, size=(3, 4)).astype(np.int32)
    active = np.array([True, True, False])
    jlogits, jcache = jpk.paged_verify_step(jparams, jcfg, jnp.asarray(tokens), jcache, jnp.asarray(active))
    lens_before = tcache.seq_lens.clone()
    tlogits, _c = tpk.paged_verify_step(tparams, tcfg, torch.from_numpy(tokens.astype(np.int64)),
                                        tcache, torch.from_numpy(active))
    assert tlogits.shape == (3, 4, tcfg.vocab_size) and tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits[:2].numpy(), np.asarray(jlogits)[:2], atol=1e-4, rtol=0)
    assert torch.equal(tcache.seq_lens, lens_before)
    for slot, pages in rows.items():
        written = np.asarray(jpk.export_pages(jcache, pages)["k"])
        np.testing.assert_allclose(tpk.export_pages(tcache, pages)["k"].numpy(), written, atol=1e-5)


@pytest.mark.parametrize("draft", ["distinct", "self"])
def test_spec_engine_matches_jax_spec_engine(models, draft):
    """The port's spec engine emits JAX's greedy streams, in as many rounds,
    at the same acceptance ratio: with the distinct draft (which random
    weights make reject nearly everything) and with the target as its own
    draft (which accepts nearly everything). The fifth request waits for a
    slot and follows the first's prompt: a prefix hit in both pools."""
    jt, jd, tt, td = models
    prompts = [PROMPT] + _prompts(SLOTS - 1) + [PROMPT + [9, 9]]
    jdraft, tdraft = (jd, td) if draft == "distinct" else (jt, tt)
    jeng = JaxEngine(*jt, draft=jdraft, spec_k=2, **GEOMETRY)
    want, jstats = _run(jeng, prompts, 12, run_once=lambda: _jax_once(jeng))
    got, tstats = _run(_engine(tt, draft=tdraft, spec_k=2), prompts, 12)
    assert got == want
    assert set(jstats) <= set(tstats)  # every stat the JAX engine reports
    for key in ("spec_rounds", "spec_accept_ratio", "steps", "tokens_generated",
                "prefix_cache_hits", "draft_prefix_cache_hits"):
        assert tstats[key] == jstats[key], key
    assert tstats["spec_rounds"] > 0 and tstats["spec_dispatches"] > tstats["spec_rounds"]
    assert tstats["prefix_cache_hits"] >= 1 and tstats["draft_prefix_cache_hits"] >= 1


def test_self_draft_streams_equal_nonspec_streams(models):
    """Mirrors tests/test_serving.py::test_speculative_decoding_exact_vs_nonspec:
    with the target as its own draft, greedy and sampled spec streams equal
    the non-speculative ones, nearly every proposal is accepted, rounds
    batch tokens, and both pools drain back to full."""
    _jt, _jd, tt, _td = models
    rng = np.random.default_rng(16)
    prompt = rng.integers(0, 512, size=9).tolist()
    base = _engine(tt, prefix_cache=False)
    base_greedy, _ = _run(base, [prompt], 24)
    base_sampled, _ = _run(_engine(tt, prefix_cache=False), [prompt], 24, temperature=0.9, seed=3)
    spec = _engine(tt, draft=tt, spec_k=3)
    spec_greedy, st = _run(spec, [prompt], 24)
    spec2 = _engine(tt, draft=tt, spec_k=3)
    spec_sampled, st2 = _run(spec2, [prompt], 24, temperature=0.9, seed=3)
    assert spec_greedy == base_greedy
    assert spec_sampled == base_sampled
    for s in (st, st2):
        assert s["spec_rounds"] > 0 and s["spec_accept_ratio"] > 0.8, s
        assert s["steps"] < s["tokens_generated"]
    for eng in (spec, spec2):
        assert eng.allocator.free_pages == PAGES - 1
        assert eng.draft_allocator.free_pages == PAGES - 1


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_spec_overlap_streams_byte_identical_to_sequential(models, monkeypatch, temperature):
    """Mirrors tests/test_serving_fleet.py::test_spec_overlap_streams_byte_identical_to_sequential:
    the overlapped round (two slot groups queued before either is read back)
    emits the same tokens as MODAL_TPU_SPEC_OVERLAP=0, and both equal the
    non-speculative engine."""
    _jt, _jd, tt, td = models
    prompts = _prompts(SLOTS)
    outs = {}
    for overlap in ("0", "1"):
        monkeypatch.setenv("MODAL_TPU_SPEC_OVERLAP", overlap)
        eng = _engine(tt, draft=td, spec_k=2)
        assert eng.spec_overlap is (overlap == "1")
        outs[overlap], st = _run(eng, prompts, 10, temperature=temperature, seed=7)
        # overlap: every round with >= 2 decoding slots dispatches 2 groups
        assert (st["spec_dispatches"] > st["spec_rounds"]) is (overlap == "1")
    plain, _ = _run(_engine(tt), prompts, 10, temperature=temperature, seed=7)
    assert outs["1"] == outs["0"] == plain


def test_spec_mode_keeps_the_prefix_cache_and_reuses_draft_pages(models):
    """Mirrors tests/test_serving_fleet.py::test_spec_mode_keeps_the_prefix_cache_and_reuses_draft_pages:
    both pools cache prefixes (the draft full pages only) and a repeated
    prompt hits both."""
    _jt, _jd, tt, td = models
    eng = _engine(tt, draft=td, spec_k=2)
    assert eng.prefix_cache is not None and eng.draft_prefix_cache is not None
    try:
        a = _drive([eng.submit(PROMPT, 10)], eng.run_once)
        b = _drive([eng.submit(PROMPT, 10)], eng.run_once)
        st = eng.stats()
    finally:
        eng.stop()
    assert a == b
    assert st["prefix_cache_hits"] >= 1
    assert st["draft_prefix_cache_entries"] >= 1 and st["draft_prefix_cache_hits"] >= 1
    assert eng.draft_allocator.free_pages == PAGES - 1  # stop() released the draft entries


def test_spec_context_slack_boundary(models):
    """Spec mode reserves spec_k positions of context: a verify round on a
    request's last token writes k positions past it, and past the page table
    torch indexing would write into a clamped, live page (JAX drops such
    writes). The request at the limit runs to its end; one more token is
    refused at submit."""
    _jt, _jd, tt, td = models
    max_ctx = PAGES_PER_SLOT * PAGE
    eng = _engine(tt, draft=td, spec_k=3)
    with pytest.raises(ValueError, match="context limit"):
        eng.submit([1] * 10, max_new_tokens=max_ctx - 3 - 10 + 1)
    out, st = _run(eng, [[1] * 10], max_ctx - 3 - 10)
    assert len(out[0]) == max_ctx - 3 - 10
    assert st["spec_rounds"] > 0
    plain = _engine(tt)
    plain.submit([1] * 10, max_new_tokens=max_ctx - 10)  # the non-spec engine keeps the whole context
    plain.stop()


def test_spec_engine_under_pool_pressure_matches_jax(models):
    """Both pools run dry mid-decode: the youngest slot is preempted, its
    target and draft pages freed together, and it re-prefills later. The
    port's streams, preemptions and rounds equal the JAX spec engine's, the
    streams equal the non-speculative engine's, and both allocators drain
    back to full."""
    jt, jd, tt, td = models
    prompts = _prompts(SLOTS, lo=100)
    tight = dict(GEOMETRY, num_pages=17)  # 16 usable pages; 4 requests grow to 5 each
    jeng = JaxEngine(*jt, draft=jd, spec_k=2, **tight)
    want, jstats = _run(jeng, prompts, 48, run_once=lambda: _jax_once(jeng))
    eng = ServingEngine(*tt, device="cpu", draft=td, spec_k=2, **tight)
    got, tstats = _run(eng, prompts, 48)
    assert got == want
    for key in ("preemptions", "spec_rounds", "spec_accept_ratio", "steps"):
        assert tstats[key] == jstats[key], key
    assert tstats["preemptions"] > 0
    plain, _ = _run(_engine(tt, num_pages=17), prompts, 48)
    assert got == plain
    assert eng.allocator.free_pages == eng.draft_allocator.free_pages == 16
