"""The port's paged KV cache against the JAX package: chunked prefill plus
decode steps across a page boundary, the block allocator, the prefix cache
and copy-on-write pages (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modal_tpu.models import llama as jllama
from modal_tpu.models import paged_kv as jpkv
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.models import paged_kv as tpkv
from modal_tpu_torch.models.convert import params_from_jax
from modal_tpu_torch.ops import _build

SLOTS, PAGES, PAGE, PAGES_PER_SLOT = 4, 25, 16, 8


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.get_config("tiny")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jparams, jcfg, tparams, tllama.get_config("tiny")


def test_chunked_prefill_then_decode_across_a_page_boundary_matches_jax_kernel(tiny):
    """Port of test_pallas_paged_attention_interpret_parity: two prefill
    chunks, then 8 decode steps through the decode kernel's path (positions
    10..17 cross from page 0 into page 1), each step's logits held against
    JAX's `paged_decode_step(..., "kernel_interpret")`."""
    jparams, jcfg, tparams, tcfg = tiny
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab_size, size=10).astype(np.int32)

    jcache = jpkv.PagedKVCache.create(jcfg, SLOTS, PAGES, PAGE, PAGES_PER_SLOT)
    tcache = tpkv.PagedKVCache.create(tcfg, SLOTS, PAGES, PAGE, PAGES_PER_SLOT, device="cpu")
    pages = tpkv.PageAllocator(PAGES, PAGE).alloc(3)
    jcache = jpkv.assign_pages(jcache, 0, 0, jnp.asarray(pages, jnp.int32))
    tpkv.assign_pages(tcache, 0, 0, pages)
    for start, stop in ((0, 6), (6, 10)):
        padded = np.zeros((16,), np.int32)
        padded[: stop - start] = prompt[start:stop]
        jl, _jt, jcache = jpkv.paged_prefill(
            jparams, jcfg, jnp.asarray(padded), jnp.int32(stop - start), jcache,
            jnp.int32(0), jnp.int32(start),
        )
        tl, _tt, tcache = tpkv.paged_prefill(
            tparams, tcfg, torch.from_numpy(padded), stop - start, tcache, 0, start
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=3e-2, rtol=0)
    assert tcache.seq_lens.tolist() == np.asarray(jcache.seq_lens).tolist() == [10, 0, 0, 0]

    tok = int(np.asarray(jl).argmax())
    launches = _build.LAUNCHES["paged_decode"]
    for step in range(8):
        jtoks = jnp.zeros((SLOTS,), jnp.int32).at[0].set(tok)
        active = np.zeros((SLOTS,), bool)
        active[0] = True
        jl, _jn, jcache = jpkv.paged_decode_step(
            jparams, jcfg, jtoks, jcache, jnp.asarray(active), "kernel_interpret"
        )
        tl, _tn, tcache = tpkv.paged_decode_step(
            tparams, tcfg, torch.tensor(np.asarray(jtoks)), tcache,
            torch.from_numpy(active), "kernel",
        )
        np.testing.assert_allclose(
            tl[0].numpy(), np.asarray(jl[0]), atol=3e-2, rtol=0,
            err_msg=f"port diverged from the JAX kernel path at decode step {step}",
        )
        tok = int(np.asarray(jl[0]).argmax())
    assert tcache.seq_lens.tolist() == np.asarray(jcache.seq_lens).tolist() == [18, 0, 0, 0]
    assert _build.LAUNCHES["paged_decode"] == launches  # CPU tensors: the plain version
    k_port = tcache.k_pages[:, pages].float().numpy()
    k_jax = np.asarray(jcache.k_pages[:, jnp.asarray(pages)], np.float32)
    np.testing.assert_allclose(k_port[:, :, :2], k_jax[:, :, :2], atol=3e-2, rtol=0)


def test_kernel_and_gather_paths_agree(tiny):
    """Same cache state, one decode step each way (the kernel path's plain
    version on the CPU vs the gather + einsum path): the logits agree."""
    _jp, _jc, tparams, tcfg = tiny
    cache = tpkv.PagedKVCache.create(tcfg, SLOTS, PAGES, PAGE, PAGES_PER_SLOT, device="cpu")
    alloc = tpkv.PageAllocator(PAGES, PAGE)
    for slot, n in ((0, 20), (2, 5)):
        tpkv.assign_pages(cache, slot, 0, alloc.alloc(2))
        toks = torch.arange(1, n + 1) % tcfg.vocab_size
        padded = torch.zeros((32,), dtype=torch.int64)
        padded[:n] = toks
        tpkv.paged_prefill(tparams, tcfg, padded, n, cache, slot, 0)
    active = torch.tensor([True, False, True, False])
    toks = torch.tensor([7, 0, 9, 0])
    lens = cache.seq_lens.clone()
    lk, _nk, _ = tpkv.paged_decode_step(tparams, tcfg, toks, cache, active, "kernel")
    cache.seq_lens.copy_(lens)
    lg, _ng, _ = tpkv.paged_decode_step(tparams, tcfg, toks, cache, active, "gather")
    np.testing.assert_allclose(lk[[0, 2]].numpy(), lg[[0, 2]].numpy(), atol=3e-2, rtol=0)
    assert cache.seq_lens.tolist() == [21, 0, 6, 0]


def test_page_allocator_churn_and_refcounts():
    """Alloc/free churn strands nothing; share() adds holders, free() drops
    one, and over-freeing fails loudly — as in the JAX allocator."""
    rng = np.random.default_rng(0)
    for alloc in (tpkv.PageAllocator(33, 16), jpkv.PageAllocator(33, 16)):
        held = []
        for _ in range(200):
            if held and (rng.random() < 0.5 or not alloc.can_alloc(4)):
                alloc.free(held.pop(rng.integers(len(held))))
            else:
                held.append(alloc.alloc(int(rng.integers(1, 5))))
        for pages in held:
            alloc.free(pages)
        assert alloc.free_pages == 32 and alloc.allocated_pages == 0
    mine, ref = tpkv.PageAllocator(9, 16), jpkv.PageAllocator(9, 16)
    for alloc in (mine, ref):
        a = alloc.alloc(2)
        alloc.share(a)
        assert alloc.refcount(a[0]) == 2 and alloc.shared(a[0])
        alloc.free(a)
        assert alloc.free_pages == 6 and not alloc.shared(a[0])
        alloc.free(a)
        with pytest.raises(ValueError, match="double free"):
            alloc.free([a[0]])
        with pytest.raises(ValueError, match="share of unallocated"):
            alloc.share([a[0]])
        with pytest.raises(tpkv.PagePoolExhausted if alloc is mine else jpkv.PagePoolExhausted):
            alloc.alloc(9)
    assert mine.high_water == ref.high_water == 2


def test_prefix_cache_lookup_insert_evict_matches_jax():
    """Same operations on both prefix caches give the same pages, coverage
    and refcounts (page-granular keys, token-granular partial extension)."""
    prompt = list(range(100, 140))  # 40 tokens = 2 full pages + 8
    results = []
    for mod in (tpkv, jpkv):
        alloc = mod.PageAllocator(17, 16)
        cache = mod.PrefixCache(alloc)
        pages = alloc.alloc(3)
        assert cache.insert(prompt, pages) and not cache.insert(prompt, pages)
        follower = prompt[:36] + [7, 7, 7]
        pages_hit, covered, entry = cache.lookup(follower)
        cache.commit_use(entry)
        no_partial = cache.lookup(follower, allow_partial=False)
        miss = cache.lookup([1, 2, 3] * 10)
        refs = [alloc.refcount(p) for p in pages]
        alloc.free(no_partial[0])
        released = cache.evict_lru()
        results.append((pages_hit, covered, no_partial[1], miss, refs, released,
                        cache.hits, len(cache), alloc.free_pages))
    assert results[0] == results[1]
    assert results[0][1] == 36 and results[0][2] == 32


def test_copy_page_set_seq_lens_and_release_slot(tiny):
    _jp, _jc, _tparams, tcfg = tiny
    cache = tpkv.PagedKVCache.create(tcfg, SLOTS, PAGES, PAGE, PAGES_PER_SLOT, device="cpu")
    cache.k_pages[:, 3] = torch.randn(cache.k_pages[:, 3].shape).to(cache.k_pages.dtype)
    cache.v_pages[:, 3] = 2.0
    tpkv.assign_pages(cache, 1, 0, [5, 3])
    before = cache.k_pages[:, 3].clone()
    tpkv.copy_page(cache, 1, 1, 7)
    assert torch.equal(cache.k_pages[:, 7], before) and torch.equal(cache.k_pages[:, 3], before)
    assert bool((cache.v_pages[:, 7] == 2.0).all())
    assert cache.page_table[1, :3].tolist() == [5, 7, 0]
    tpkv.set_seq_lens(cache, [4, 9, 9, 9], [False, True, False, True])
    assert cache.seq_lens.tolist() == [0, 9, 0, 9]
    tpkv.release_slot(cache, 1)
    assert cache.page_table[1].abs().sum().item() == 0 and cache.seq_lens[1].item() == 0


@pytest.mark.parametrize(
    "env,device,want",
    [(None, "cpu", "gather"), (None, "cuda", "kernel"), ("gather", "cuda", "gather"),
     ("0", "cuda", "gather"), ("kernel", "cpu", "kernel"), ("1", "cuda", "kernel")],
)
def test_resolve_attn_impl(monkeypatch, env, device, want):
    if env is None:
        monkeypatch.delenv(tpkv.PAGED_KERNEL_ENV, raising=False)
    else:
        monkeypatch.setenv(tpkv.PAGED_KERNEL_ENV, env)
    assert tpkv.resolve_attn_impl(device) == want


def test_prefill_buckets_match_jax():
    for n in (1, 16, 17, 100, 128, 129, 5000):
        assert tpkv.prefill_bucket(n, 4096) == jpkv.prefill_bucket(n, 4096)
