"""The port's per-row sampling against the JAX package (CPU).

JAX's `fold_in` bits cannot be reproduced in torch, so sampled tokens are
not compared across the two; what is compared is the filtering (exactly the
same kept set and values) and the properties the engine relies on: greedy
rows are the exact argmax, and a sampled row's token depends only on its own
(seed, index, logits), never on its batch companions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modal_tpu.models.sampling import filter_logits_batched as jax_filter
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
