"""The one generator of every traffic mix: it reads a mix's parameters
(`benchmark/traffic/<mix>.json`) and a seed, and makes the requests or the
training rows.

Sizes are quantiles, not draws: `n` requests take the lengths at the
quantiles (i + 0.5) / n of the mix's distribution, so every seed sends the
same multiset of prompt and output lengths (and the same number of sampled
requests and of requests per document). The seed orders them, pairs them
and draws the token ids. The order is stratified: each run of `block`
consecutive requests holds one length from each of `block` equal strata
of the distribution; and the `n` sizes repeat as a cycle, `n` chosen
below what one window serves, so a window serves whole cycles and a part
of one. Two seeds then differ in order and content, never in the amount
of work."""

from __future__ import annotations

import dataclasses
import hashlib
import math
import statistics

import numpy as np


# Every key a mix may hold, each read by this generator or by the cell's
# runner (`benchmark/serve.py`, a closed loop of `clients`, or
# `benchmark/train.py`); `mix_errors` refuses any other key, so no knob of a
# mix goes unread.
SERVE_KEYS = {"kind", "clients", "engine", "requests", "block", "prompt_tokens", "output_tokens",
              "sampled_share", "temperature", "top_p", "top_k", "shared_prefix", "preroll_completions",
              "check_requests", "why"}
TRAIN_KEYS = {"kind", "batch", "seq_len", "train_config", "check_steps", "why"}
ENGINE_KEYS = {"max_slots", "page_size", "prefill_chunk", "num_pages"}
LENGTH_KEYS = {"lognormal": {"dist", "median", "sigma", "min", "max"}, "uniform": {"dist", "min", "max"}}


def mix_errors(mix: dict) -> list[str]:
    """What in `mix` this generator and the cell's runner would not honour."""
    errs = []
    kind = mix.get("kind")
    if kind not in ("serve", "train"):
        return [f"kind {kind!r}"]
    allowed = SERVE_KEYS if kind == "serve" else TRAIN_KEYS
    errs += [f"key {k!r} is read by nothing" for k in sorted(set(mix) - allowed)]
    if kind == "train":
        return errs
    errs += [f"engine key {k!r} is read by nothing" for k in sorted(set(mix.get("engine", {})) - ENGINE_KEYS)]
    for key in ("prompt_tokens", "output_tokens"):
        spec = mix.get(key, {})
        if set(spec) != LENGTH_KEYS.get(spec.get("dist"), set()):
            errs.append(f"{key} {spec}")
    if mix.get("shared_prefix") and set(mix["shared_prefix"]) != {"count", "tokens"}:
        errs.append(f"shared_prefix {mix['shared_prefix']}")
    return errs


@dataclasses.dataclass
class Request:
    index: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0
    shared_prefix: int = -1  # index of the document it starts with, -1 for none

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def lengths(spec: dict, n: int) -> list[int]:
    """The n quantile lengths of `spec`: {"dist": "lognormal", "median",
    "sigma", "min", "max"} or {"dist": "uniform", "min", "max"} (whole
    numbers, both ends included)."""
    lo, hi = int(spec["min"]), int(spec["max"])
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            z = statistics.NormalDist().inv_cdf(u)
            x = round(math.exp(math.log(spec["median"]) + spec["sigma"] * z))
        elif spec["dist"] == "uniform":
            x = lo + math.floor(u * (hi - lo + 1))
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
        out.append(min(hi, max(lo, int(x))))
    return out


def stratified(values: list, r: np.random.Generator, block: int) -> list:
    """`values` in an order whose every aligned run of `block` holds one
    value of each of `block` strata (the sorted values cut into equal
    parts), each run shuffled."""
    n = len(values)
    if n % block:
        raise ValueError(f"{n} requests do not split into blocks of {block}")
    per = n // block
    ordered = sorted(values)
    strata = [r.permutation(ordered[j * per:(j + 1) * per]).tolist() for j in range(block)]
    out = []
    for b in range(per):
        out.extend(r.permutation([strata[j][b] for j in range(block)]).tolist())
    return out


def rng(seed: int, stream: str) -> np.random.Generator:
    """A generator of its own for each use of the seed."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:16], "little"))


def documents(mix: dict, vocab: int, seed: int) -> list[list[int]]:
    """The shared prefixes every request of the mix starts with (none
    without `shared_prefix`)."""
    spec = mix.get("shared_prefix")
    if not spec:
        return []
    r = rng(seed, "documents")
    return [r.integers(0, vocab, size=int(spec["tokens"])).tolist() for _ in range(int(spec["count"]))]


class Stream:
    """The requests of a mix in the order the clients send them. The sizes
    repeat in a cycle of the mix's `requests` entries; every request sent
    gets fresh token ids (and a fresh sampling seed), so a size that comes
    round again is never a prompt the engine has seen. A prompt is the
    request's document (if the mix shares prefixes) and then
    `prompt_tokens` fresh ids."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        n, block = int(mix["requests"]), int(mix.get("block", 8))
        order = rng(seed, "order")
        self.mix, self.vocab, self.n = mix, vocab, n
        self.prompt_lens = stratified(lengths(mix["prompt_tokens"], n), order, block)
        self.output_lens = stratified(lengths(mix["output_tokens"], n), order, block)
        n_sampled = round(n * float(mix.get("sampled_share", 0.0)))
        self.sampled = stratified([i < n_sampled for i in range(n)], order, block)
        self.docs = documents(mix, vocab, seed)
        self.doc_of = stratified([i % len(self.docs) for i in range(n)], order, block) if self.docs else [-1] * n
        self.ids = rng(seed, "prompts")
        self.sent = 0

    def next(self) -> Request:
        i, j = self.sent, self.sent % self.n
        self.sent += 1
        doc, sampled, mix = int(self.doc_of[j]), bool(self.sampled[j]), self.mix
        fresh = self.ids.integers(0, self.vocab, size=int(self.prompt_lens[j])).tolist()
        return Request(
            index=i,
            prompt=(self.docs[doc] if doc >= 0 else []) + fresh,
            max_new_tokens=int(self.output_lens[j]),
            temperature=float(mix.get("temperature", 0.0)) if sampled else 0.0,
            top_p=float(mix.get("top_p", 1.0)) if sampled else 1.0,
            top_k=int(mix.get("top_k", 0)) if sampled else 0,
            seed=int(self.ids.integers(0, 2**31 - 1)),
            shared_prefix=doc,
        )


def requests(mix: dict, vocab: int, seed: int, count: int = 0) -> list[Request]:
    """The first `count` requests sent (one cycle by default)."""
    stream = Stream(mix, vocab, seed)
    return [stream.next() for _ in range(count or stream.n)]


def warmup_requests(mix: dict, vocab: int) -> list[Request]:
    """One short request per prefill size the mix's chunks can take, half
    of them sampled if the mix samples, each decoding 2 tokens: what set-up
    runs before the clients start, so no chunk size or sampling path meets
    its first call inside the window."""
    chunk = int(mix["engine"]["prefill_chunk"])
    sizes, size = [], 16
    while size < chunk:
        sizes.append(size)
        size *= 2
    sizes.append(chunk)
    r = rng(0, "warmup")
    sample = float(mix.get("sampled_share", 0.0)) > 0
    out = []
    for i, s in enumerate(sizes):
        for sampled in ((False, True) if sample else (False,)):
            out.append(Request(
                index=-1 - len(out), prompt=r.integers(0, vocab, size=s).tolist(), max_new_tokens=2,
                temperature=float(mix.get("temperature", 0.0)) if sampled else 0.0,
                top_p=float(mix.get("top_p", 1.0)) if sampled else 1.0, seed=i,
            ))
    return out


def train_row(seed: int, step: int, batch: int, seq_len: int, vocab: int, device):
    """Step `step`'s token rows [batch, seq_len], made on the device; every
    step's rows differ."""
    import torch

    gen = torch.Generator(device=device)
    digest = hashlib.sha256(f"{int(seed)}:row:{int(step)}".encode()).digest()
    gen.manual_seed(int.from_bytes(digest[:8], "little") & ((1 << 63) - 1))
    return torch.randint(0, vocab, (batch, seq_len), generator=gen, device=device)
