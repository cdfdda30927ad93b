"""The port's per-row sampling against the JAX package (CPU).

JAX's `fold_in` bits cannot be reproduced in torch, so sampled tokens are
not compared across the two; what is compared is the filtering (exactly the
same kept set and values) and the properties the engine relies on: greedy
rows are the exact argmax, and a sampled row's token depends only on its own
(seed, index, logits), never on its batch companions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modal_tpu.models import llama as jllama
from modal_tpu.models import sampling as jsampling
from modal_tpu.models.sampling import filter_logits_batched as jax_filter
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.models import sampling as tsampling
from modal_tpu_torch.models.convert import params_from_jax
from modal_tpu_torch.models.sampling import filter_logits_batched, row_seed, sample_step

V = 97


def _logits(n, seed):
    return np.random.default_rng(seed).standard_normal((n, V)).astype(np.float32) * 3


@pytest.mark.parametrize(
    "temps,top_ks,top_ps",
    [
        ([1.0, 0.5, 2.0, 0.8], [0, 5, 0, 20], [1.0, 1.0, 0.9, 0.5]),
        ([0.0, 1e-3, 1.3, 0.7], [1, 0, 96, 3], [0.3, 1.0, 1.0, 0.95]),
    ],
)
def test_filter_logits_batched_matches_jax(temps, top_ks, top_ps):
    logits = _logits(4, 1)
    want = np.asarray(jax_filter(
        jnp.asarray(logits), jnp.asarray(temps, jnp.float32), jnp.asarray(top_ks, jnp.int32),
        jnp.asarray(top_ps, jnp.float32),
    ))
    got = filter_logits_batched(
        torch.from_numpy(logits), torch.tensor(temps), torch.tensor(top_ks), torch.tensor(top_ps)
    ).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    kept = ~np.isinf(want)
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=1e-6)


def _step(logits, seeds, indices, temps, top_ks=None, top_ps=None):
    n = len(seeds)
    return sample_step(
        torch.from_numpy(logits), seeds, indices, temps,
        top_ks if top_ks is not None else [0] * n, top_ps if top_ps is not None else [1.0] * n,
    ).tolist()


def test_greedy_rows_are_exact_argmax():
    logits = _logits(6, 2)
    out = _step(logits, [1] * 6, [0] * 6, [0.0, 0.9, 0.0, -1.0, 0.0, 0.5])
    for i in (0, 2, 3, 4):
        assert out[i] == int(logits[i].argmax())


def test_sampled_row_ignores_its_batch_companions():
    logits = _logits(4, 3)
    alone = _step(logits[1:2], [42], [7], [0.8], [0], [0.9])[0]
    companions = _logits(4, 4)
    companions[1] = logits[1]
    batched = _step(companions, [5, 42, 9, 1], [0, 7, 3, 2], [1.0, 0.8, 0.0, 2.0],
                    [10, 0, 0, 0], [1.0, 0.9, 1.0, 1.0])[1]
    assert batched == alone
    # the same request at the next index draws new noise: streams vary
    draws = {_step(logits[1:2], [42], [i], [1.5])[0] for i in range(40)}
    assert len(draws) > 5


def test_sampled_tokens_respect_top_k_and_follow_the_distribution():
    logits = _logits(1, 5)
    top3 = set(np.argsort(logits[0])[-3:].tolist())
    picks = [_step(logits, [3], [i], [1.0], [3])[0] for i in range(200)]
    assert set(picks) <= top3
    # temperature 1, no cuts: empirical frequency of the argmax tracks its probability
    probs = torch.softmax(torch.from_numpy(logits[0]), -1)
    best = int(probs.argmax())
    freq = np.mean([_step(logits, [11], [i], [1.0])[0] == best for i in range(600)])
    assert abs(freq - float(probs[best])) < 0.08


def test_row_seed_is_deterministic_and_spreads():
    assert row_seed(1, 2) == row_seed(1, 2)
    seeds = {row_seed(s, i) for s in range(8) for i in range(8)}
    assert len(seeds) == 64 and all(0 <= x < 2**63 for x in seeds)


# -- the generation helpers (decode_tokens, sample_tokens, sample_generate) ------
# fp32 `tiny` from PRNGKey(0) in both packages: fp32 keeps the two
# frameworks' logits ~1e-6 apart, far from argmax near-ties, so greedy and
# top-1 streams are compared token for token.


@pytest.fixture(scope="module")
def fp32_tiny():
    jcfg = jllama.get_config("tiny", dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jparams, jcfg, tparams, tllama.get_config("tiny", dtype=torch.float32)


def _prompt(seed=7, batch=2, length=10):
    return np.random.default_rng(seed).integers(0, 512, size=(batch, length)).astype(np.int32)


def test_decode_tokens_matches_jax(fp32_tiny):
    """The emitted tokens include the first token and exclude the final one,
    and both equal the JAX scan's."""
    jparams, jcfg, tparams, tcfg = fp32_tiny
    prompt = _prompt()
    jcache = jllama.KVCache.create(jcfg, 2, 64)
    jlogits, jcache = jsampling.prefill(jparams, jcfg, jnp.asarray(prompt), jcache)
    jfirst = jnp.argmax(jlogits, axis=-1, keepdims=True).astype(jnp.int32)
    jtoks, jfinal, _ = jsampling.decode_tokens(jparams, jcfg, jfirst, jcache, 9)
    tcache = tllama.KVCache.create(tcfg, 2, 64, device="cpu")
    tlogits, tcache = tsampling.prefill(tparams, tcfg, torch.from_numpy(prompt).long(), tcache)
    tfirst = tlogits.argmax(dim=-1, keepdim=True)
    ttoks, tfinal, tcache = tsampling.decode_tokens(tparams, tcfg, tfirst, tcache, 9)
    assert ttoks.shape == (2, 9) and tcache.length == 10 + 9
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tfinal.numpy(), np.asarray(jfinal))
    assert torch.equal(ttoks[:, :1], tfirst)


def test_sample_generate_top1_matches_jax(fp32_tiny):
    """top_k=1 leaves one token per row, so the draw is exact whatever the
    PRNG: the stream equals JAX's sample_generate and both greedy decodes.
    (Temperature 0 is not pinned: JAX divides by 1e-6 and still draws.)"""
    jparams, jcfg, tparams, tcfg = fp32_tiny
    prompt = _prompt(seed=8)
    want = np.asarray(jsampling.sample_generate(
        jparams, jcfg, jnp.asarray(prompt), 12, key=jax.random.PRNGKey(3), temperature=0.7, top_k=1, cache_len=64
    ))
    got = tsampling.sample_generate(
        tparams, tcfg, torch.from_numpy(prompt).long(), 12,
        generator=torch.Generator().manual_seed(3), temperature=0.7, top_k=1, cache_len=64,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = tsampling.greedy_generate(tparams, tcfg, torch.from_numpy(prompt).long(), 12, cache_len=64)
    assert torch.equal(got, greedy)
    np.testing.assert_array_equal(
        want, np.asarray(jsampling.greedy_generate(jparams, jcfg, jnp.asarray(prompt), 12, cache_len=64))
    )
    with pytest.raises(ValueError, match="cache_len"):
        tsampling.sample_generate(tparams, tcfg, torch.from_numpy(prompt).long(), 60,
                                  generator=torch.Generator(), cache_len=64)


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.6, 5), (2.5, 1), (1e-3, 50), (0.0, 3)])
def test_filter_logits_matches_jax(temperature, top_k):
    """Within 1e-6 (fp32, the same division) on seeded logits, with the same
    masked set."""
    logits = _logits(5, 9)
    want = np.asarray(jsampling._filter_logits(jnp.asarray(logits), temperature, top_k))
    got = tsampling._filter_logits(torch.from_numpy(logits), temperature, top_k).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    kept = ~np.isinf(want)
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=1e-6)
    if top_k:
        assert (kept.sum(axis=-1) == top_k).all()


def test_sampled_streams_follow_the_generator_and_the_filter(fp32_tiny):
    """A seeded generator reproduces the stream, another seed changes it, and
    every sampled token lies in `_filter_logits`' support (the top 3 of the
    model's logits at its position)."""
    _jp, _jc, tparams, tcfg = fp32_tiny
    prompt = torch.from_numpy(_prompt(seed=9)).long()

    def run(seed):
        return tsampling.sample_generate(tparams, tcfg, prompt, 16, generator=torch.Generator().manual_seed(seed),
                                         temperature=1.5, top_k=3, cache_len=64)

    out = run(5)
    assert torch.equal(out, run(5))
    assert not torch.equal(out, run(6))
    logits = tllama.forward(tparams, tcfg, out, attn_impl=tllama.attention)[0]
    s = prompt.shape[1]
    for pos in range(s - 1, out.shape[1] - 1):
        support = tsampling._filter_logits(logits[:, pos], 1.5, 3)
        assert torch.isfinite(support.gather(1, out[:, pos + 1 : pos + 2])).all(), pos


def test_host_sync_waits_for_cuda_leaves_only():
    """On the CPU there is nothing to wait for; nested trees are walked."""
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), (torch.ones(1), 3)], "c": None}
    assert tsampling.host_sync(tree) is None
    assert tsampling.host_sync(torch.ones(1)) is None
