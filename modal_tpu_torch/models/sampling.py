"""Decode on the dense cache, and per-row sampling for the serving engine
(port of modal_tpu/models/sampling.py).

`prefill`, `decode_step`, `decode_tokens`, `greedy_generate`,
`sample_tokens`, `sample_generate` and `benchmark_decode` are the dense path
(`llama.KVCache`); the tests hold the paged path against them. The JAX
package fuses a generation into one `lax.scan` dispatch; here it is a loop
of eager steps. `filter_logits_batched` and `sample_step` are what the
engine samples with.

JAX derives row i's key as `fold_in(PRNGKey(seeds[i]), indices[i])`; those
bits cannot be reproduced in torch. Here each sampled row draws its noise
from its own `torch.Generator` seeded from `(seed, index)`, which keeps the
property that matters: a row's token depends only on its own seed, index
and logits, never on its batch companions. Rows with temperature <= 0 take
the exact argmax. Where JAX takes a `key`, `sample_tokens` and
`sample_generate` take a `torch.Generator`: only draws that the filter
makes deterministic (top_k=1) can match the JAX package's.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..config import host_to_device
from .llama import KVCache, LlamaConfig, forward, params_device


@torch.no_grad()
def prefill(params: dict, cfg: LlamaConfig, tokens: torch.Tensor, cache: KVCache):
    """Run the prompt through the model, filling the cache in place.
    Returns (last_token_logits [B, V], cache)."""
    logits, cache = forward(params, cfg, tokens, cache=cache)
    return logits[:, -1, :], cache


@torch.no_grad()
def decode_step(params: dict, cfg: LlamaConfig, token: torch.Tensor, cache: KVCache):
    """One token in, one distribution out. token: [B, 1]."""
    logits, cache = forward(params, cfg, token, cache=cache)
    return logits[:, -1, :], cache


@torch.no_grad()
def decode_tokens(params: dict, cfg: LlamaConfig, first_token: torch.Tensor, cache: KVCache, num_tokens: int):
    """Generate `num_tokens` greedily from `first_token` [B, 1]. Returns
    (tokens [B, num_tokens], final_token [B, 1], cache): the emitted tokens
    include `first_token` and exclude the final one, as the JAX scan's do."""
    tok = first_token
    out = []
    for _ in range(num_tokens):
        out.append(tok)
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = logits.argmax(dim=-1, keepdim=True).to(first_token.dtype)
    return torch.cat(out, dim=1), tok, cache


@torch.no_grad()
def greedy_generate(
    params: dict,
    cfg: LlamaConfig,
    prompt: torch.Tensor,  # [B, S] int
    max_new_tokens: int,
    cache_len: Optional[int] = None,
) -> torch.Tensor:
    """Greedy decode, one step at a time (PyTorch runs eagerly: the JAX
    package's fixed-size fused chunks have no counterpart to pay for).
    Returns [B, S + max_new_tokens]."""
    b, s = prompt.shape
    cache_len = cache_len or cfg.max_seq_len
    if s + max_new_tokens > cache_len:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds cache_len ({cache_len})"
        )
    cache = KVCache.create(cfg, b, cache_len, device=prompt.device)
    logits, cache = prefill(params, cfg, prompt, cache)
    tok = logits.argmax(dim=-1, keepdim=True)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = logits.argmax(dim=-1, keepdim=True)
        out.append(tok)
    return torch.cat([prompt, torch.cat(out, dim=1).to(prompt.dtype)], dim=1)


def host_sync(tree) -> None:
    """Wait until every CUDA device holding a tensor of `tree` (a tensor, or
    a dict/list/tuple of them) has finished its queued work; CPU tensors
    are already done. Timing must not trust an enqueue: a CUDA call returns
    before the device finishes, so a host clock read without this measures
    the launch, not the work."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            host_sync(leaf)
        return
    if isinstance(tree, torch.Tensor) and tree.device.type == "cuda":
        torch.cuda.synchronize(tree.device)


@torch.no_grad()
def benchmark_decode(
    params: dict,
    cfg: LlamaConfig,
    batch: int = 1,
    prompt_len: int = 128,
    gen_len: int = 128,
    cache_len: int = 1024,
) -> dict:
    """Time prefill and step-by-step greedy decode on the params' device
    (host clock around work that ends in a device synchronise)."""
    dev = params_device(params)
    prompt = torch.ones((batch, prompt_len), dtype=torch.int64, device=dev)

    def run_prefill():
        cache = KVCache.create(cfg, batch, cache_len, device=dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, prompt, cache)
        host_sync(logits)
        return time.perf_counter() - t0, logits, cache

    first_prefill_s, _l, _c = run_prefill()  # warm-up: kernel builds, allocator
    prefill_s, logits, cache = run_prefill()
    tok = logits.argmax(dim=-1, keepdim=True)
    t0 = time.perf_counter()
    for _ in range(gen_len):
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = logits.argmax(dim=-1, keepdim=True)
    host_sync(tok)
    decode_s = time.perf_counter() - t0
    return {
        "device": str(dev),
        "first_prefill_s": first_prefill_s,
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": batch * prompt_len / prefill_s,
        "decode_s": decode_s,
        "decode_tokens_per_s": batch * gen_len / decode_s,
        "ms_per_token": decode_s / gen_len * 1000,
    }


def _filter_logits(logits: torch.Tensor, temperature: float, top_k: int) -> torch.Tensor:
    """Temperature scale and top-k mask (the first token of `sample_generate`
    and every step of `sample_tokens` sample the same distribution)."""
    logits = logits / max(temperature, 1e-6)
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    return logits


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits) ([B, V] → [B, 1])."""
    return torch.multinomial(torch.softmax(logits.float(), dim=-1), 1, generator=generator)


@torch.no_grad()
def sample_tokens(
    params: dict,
    cfg: LlamaConfig,
    first_token: torch.Tensor,  # [B, 1]
    cache: KVCache,
    num_tokens: int,
    generator: torch.Generator,
    temperature: float = 1.0,
    top_k: int = 0,
):
    """Temperature / top-k sampling, step by step like `decode_tokens`, each
    draw from `generator`. Returns (tokens [B, num_tokens], final_token
    [B, 1], cache)."""
    tok = first_token
    out = []
    for _ in range(num_tokens):
        out.append(tok)
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = _categorical(_filter_logits(logits, temperature, top_k), generator).to(first_token.dtype)
    return torch.cat(out, dim=1), tok, cache


@torch.no_grad()
def sample_generate(
    params: dict,
    cfg: LlamaConfig,
    prompt: torch.Tensor,  # [B, S] int
    max_new_tokens: int,
    *,
    generator: torch.Generator,
    temperature: float = 1.0,
    top_k: int = 0,
    cache_len: Optional[int] = None,
) -> torch.Tensor:
    """Stochastic decode (temperature + optional top-k), every draw from
    `generator` (on the prompt's device), so a seeded generator reproduces
    the stream. Returns [B, S + max_new_tokens]."""
    b, s = prompt.shape
    cache_len = cache_len or cfg.max_seq_len
    if s + max_new_tokens > cache_len:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds cache_len "
            f"({cache_len}) — the KV cache would overflow"
        )
    cache = KVCache.create(cfg, b, cache_len, device=prompt.device)
    logits, cache = prefill(params, cfg, prompt, cache)
    first = _categorical(_filter_logits(logits, temperature, top_k), generator).to(prompt.dtype)
    toks, _final, _cache = sample_tokens(params, cfg, first, cache, max_new_tokens, generator, temperature, top_k)
    return torch.cat([prompt, toks], dim=1)


# -- batched per-row sampling (serving engine) ---------------------------------


def filter_logits_batched(
    logits: torch.Tensor,  # [N, V] float32
    temperature: torch.Tensor,  # [N] float — 0 = greedy (handled by the caller)
    top_k: torch.Tensor,  # [N] int — 0 = no top-k cut
    top_p: torch.Tensor,  # [N] float — 1.0 = no nucleus cut
) -> torch.Tensor:
    """Per-row temperature / top-k / top-p filtering with every knob as data.
    One descending sort serves both cuts; rows with top_k=0 / top_p=1 pass
    through untouched."""
    n, v = logits.shape
    dev = logits.device
    scaled = logits / torch.clamp(temperature.to(dev).float(), min=1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    rows = torch.arange(n, device=dev)
    top_k = top_k.to(dev).long()
    k_eff = torch.clamp(torch.where(top_k > 0, top_k, v), 1, v)
    kth = sorted_desc[rows, k_eff - 1]
    # top-p: the cutoff logit is where the cumulative softmax first crosses top_p
    top_p = top_p.to(dev).float()
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    cut_idx = torch.argmax((cum >= top_p[:, None]).to(torch.int8), dim=-1)  # first crossing
    pth = torch.where(top_p < 1.0, sorted_desc[rows, cut_idx], float("-inf"))
    thresh = torch.maximum(kth, pth)
    return torch.where(scaled < thresh[:, None], float("-inf"), scaled)


_MASK64 = (1 << 64) - 1


def row_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed from (seed, index): two rounds of the
    splitmix64 finaliser, so neighbouring indices get unrelated streams."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(index) & 0xFFFFFFFF)) & _MASK64
    for _ in range(2):
        z = (z + 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z & 0x7FFFFFFFFFFFFFFF


@torch.no_grad()
def sample_step(
    logits: torch.Tensor,  # [N, V] float32 — one position's logits per row
    seeds,  # [N] int — per-request seed
    indices,  # [N] int — the sampled token's index in its stream
    temperature,  # [N] float
    top_k,  # [N] int
    top_p,  # [N] float
) -> torch.Tensor:
    """Sample one token per row ([N] int64 on logits' device). Sampled rows
    take the Gumbel-max of their filtered logits with noise from a generator
    seeded by `row_seed(seed, index)`; temperature <= 0 rows take the argmax.
    The per-row knobs are host arrays: nothing here reads the device, so a
    caller can queue the call behind other work without a sync."""
    dev = logits.device
    n, v = logits.shape
    seeds = torch.as_tensor(seeds).tolist()
    indices = torch.as_tensor(indices).tolist()
    temperature = torch.as_tensor(temperature, dtype=torch.float32)
    out = logits.argmax(dim=-1)
    rows = [i for i in range(n) if float(temperature[i]) > 0.0]
    if not rows:
        return out
    sel = host_to_device(rows, dev, torch.int64)
    filtered = filter_logits_batched(
        logits[sel],
        host_to_device(temperature[rows], dev),
        host_to_device(torch.as_tensor(top_k)[rows], dev),
        host_to_device(torch.as_tensor(top_p, dtype=torch.float32)[rows], dev),
    )
    noise = torch.empty((len(rows), v), dtype=torch.float32, device=dev)
    for j, i in enumerate(rows):
        gen = torch.Generator(device=dev)
        gen.manual_seed(row_seed(seeds[i], indices[i]))
        noise[j].uniform_(generator=gen)
    gumbel = -torch.log(-torch.log(noise.clamp_(1e-20, 1.0 - 1e-7)))
    out[sel] = (filtered + gumbel).argmax(dim=-1)
    return out
