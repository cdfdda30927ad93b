"""The traffic generator: the same seed gives the same requests; every seed
gives the same multiset of sizes, in its own order; each block of the
order holds one size from each stratum."""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import pytest
import torch

from benchmark import workload

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def mix(name: str) -> dict:
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["chat", "docqa"])
def test_same_seed_same_requests(name):
    a = workload.requests(mix(name), 32768, 2**31 + 17)
    b = workload.requests(mix(name), 32768, 2**31 + 17)
    assert [(r.prompt, r.max_new_tokens, r.temperature, r.seed) for r in a] == \
           [(r.prompt, r.max_new_tokens, r.temperature, r.seed) for r in b]


@pytest.mark.parametrize("name", ["chat", "docqa"])
def test_seeds_change_order_and_ids_not_sizes(name):
    m = mix(name)
    a = workload.requests(m, 32768, 11)
    b = workload.requests(m, 32768, 12)
    assert [r.prompt for r in a] != [r.prompt for r in b]
    for key in (lambda r: len(r.prompt), lambda r: r.max_new_tokens, lambda r: r.greedy,
                lambda r: r.shared_prefix):
        assert Counter(map(key, a)) == Counter(map(key, b))


def test_chat_sizes_follow_the_mix():
    m = mix("chat")
    reqs = workload.requests(m, 32768, 5)
    prompts = sorted(len(r.prompt) for r in reqs)
    outs = sorted(r.max_new_tokens for r in reqs)
    assert prompts[0] >= 32 and prompts[-1] <= 2048 and outs[0] >= 16 and outs[-1] <= 768
    assert 240 <= prompts[len(prompts) // 2] <= 272 and 180 <= outs[len(outs) // 2] <= 204
    assert sum(not r.greedy for r in reqs) == len(reqs) // 2
    assert all(r.temperature == 0.8 and r.top_p == 0.95 for r in reqs if not r.greedy)
    assert max(len(r.prompt) + r.max_new_tokens for r in reqs) <= 2816


@pytest.mark.parametrize("name", ["chat", "docqa"])
def test_sizes_cycle_with_fresh_ids(name):
    m = mix(name)
    reqs = workload.requests(m, 32768, 77, count=3 * m["requests"])
    n = m["requests"]
    first, second = reqs[:n], reqs[n:2 * n]
    assert [(len(a.prompt), a.max_new_tokens, a.greedy) for a in first] == \
           [(len(b.prompt), b.max_new_tokens, b.greedy) for b in second]
    tails = [tuple(r.prompt[-len(r.prompt) + (3080 if r.shared_prefix >= 0 else 0):]) for r in reqs]
    assert len(set(tails)) == len(tails)


def test_docqa_requests_start_with_a_shared_document():
    m = mix("docqa")
    docs = workload.documents(m, 102400, 8)
    assert len(docs) == 8 and all(len(d) == 3080 for d in docs)
    for r in workload.requests(m, 102400, 8):
        assert r.prompt[:3080] == docs[r.shared_prefix] and 32 <= len(r.prompt) - 3080 <= 128
        assert r.greedy and 32 <= r.max_new_tokens <= 512


def test_every_block_holds_one_size_from_each_stratum():
    m = mix("chat")
    n, block = m["requests"], m.get("block", 8)
    sizes = sorted(workload.lengths(m["prompt_tokens"], n))
    reqs = workload.requests(m, 32768, 99)
    per = n // block
    for b in range(0, n, block):
        strata = sorted(sizes.index(len(r.prompt)) // per for r in reqs[b:b + block])
        assert len(set(strata)) >= block - 1  # ties at a stratum's edge may share its neighbour's value


def test_warmup_covers_every_chunk_size_and_sampling():
    reqs = workload.warmup_requests(mix("chat"), 32768)
    assert sorted({len(r.prompt) for r in reqs}) == [16, 32, 64, 128]
    assert {r.greedy for r in reqs} == {True, False}


def test_training_rows_differ_by_step_and_repeat_by_seed():
    a = workload.train_row(3, 0, 1, 64, 512, "cpu")
    assert torch.equal(a, workload.train_row(3, 0, 1, 64, 512, "cpu"))
    assert not torch.equal(a, workload.train_row(3, 1, 1, 64, 512, "cpu"))
    assert not torch.equal(a, workload.train_row(4, 0, 1, 64, 512, "cpu"))
