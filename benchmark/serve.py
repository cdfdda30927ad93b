"""A serving cell: the program's `ServingEngine` on its own loop thread,
driven by a closed loop of clients on one asyncio loop in the main thread.

Set-up builds the engine over the benchmark's weights (its decode step is
captured as a CUDA graph there), runs one short request per prefill size
and sampling path, prefills the mix's shared documents through the engine
(so its prefix cache holds them), and starts the clients. The window opens
once `preroll_completions` requests have completed, so it measures the
loop in its steady state and not the first burst of admissions. Each
client sends its next request the moment its last one completed, taking
requests in the seed's order from one shared stream; a client's clock
stamps each submit and each token as it reaches the client
(`GenRequest.wait_new_async`)."""

from __future__ import annotations

import asyncio
import gc
import time

from . import stats, workload
from .stats import Record


PREROLL_TIMEOUT_S = 240.0


class ServeRun:
    """What a serving run leaves for the check and the per-layer readers."""

    def __init__(self):
        self.records: list[Record] = []
        self.t0 = self.t1 = 0.0  # the window, client clock (perf_counter)
        self.wall0 = self.wall1 = 0.0  # the same instants on the wall clock (spans)
        self.counters: dict = {}  # engine counters at t0 and t1
        self.launches: dict = {}  # kernel launches inside the window
        self.spans: list = []  # finished spans (traced runs only)
        self.trace = None
        self.engine_info: dict = {}


async def _client(engine, stream, records, state):
    while not state["stop"]:
        req = stream.next()
        rec = Record(index=req.index, prompt_tokens=len(req.prompt), max_new_tokens=req.max_new_tokens,
                     greedy=req.greedy, submitted=time.perf_counter(), prompt=req.prompt,
                     shared_prefix=req.shared_prefix)
        records.append(rec)
        try:
            handle = engine.submit(req.prompt, req.max_new_tokens, temperature=req.temperature,
                                   top_k=req.top_k, top_p=req.top_p, seed=req.seed)
        except Exception as exc:  # noqa: BLE001 — a refused request counts as failed
            rec.error = f"{type(exc).__name__}: {exc}"
            rec.finished = time.perf_counter()
            await asyncio.sleep(0.01)
            continue
        while True:
            new, done = await handle.wait_new_async(len(rec.tokens), timeout=5.0)
            now = time.perf_counter()
            rec.tokens.extend(new)
            rec.arrivals.extend([now] * len(new))
            if done:
                rec.finished = now
                rec.error = handle.error
                break
        if rec.error is None:
            state["completed"] += 1
            if state["completed"] >= state["preroll"] and not state["open"].is_set():
                state["open"].set()


def _counters(engine) -> dict:
    return {"tokens_generated": engine.tokens_generated, "step_count": engine.step_count,
            "requests_completed": engine.requests_completed, "preemptions": engine.preemptions}


def run(model, mix: dict, weights: dict, seed: int, seconds: float, device, trace: bool,
        trace_seconds: float, tracer_cls) -> tuple[ServeRun, dict]:
    """Set up, measure for `seconds`, stop. Returns the run and the engine
    (stopped) so the caller can read memory before freeing it."""
    from modal_tpu_torch.observability import tracing
    from modal_tpu_torch.ops import _build
    from modal_tpu_torch.serving.engine import ServingEngine

    from .models import llama_config

    cfg = llama_config(model)
    eng = mix["engine"]
    engine = ServingEngine(weights, cfg, max_slots=int(eng["max_slots"]), num_pages=int(eng["num_pages"]),
                           page_size=int(eng["page_size"]), prefill_chunk=int(eng["prefill_chunk"]),
                           device=device)
    engine.start()
    out = ServeRun()
    out.engine_info = {"attn_impl": engine.attn_impl, "cuda_graphs": engine.decode_graph is not None,
                       "pages_per_slot": engine.pages_per_slot, "max_slots": engine.max_slots,
                       "page_size": engine.page_size}
    def tap(span) -> None:
        out.spans.append((span.name, span.start, span.end, dict(span.attrs)))

    if trace:
        tracing.add_span_tap(tap)
        tracer_cls.warm()
    for req in workload.warmup_requests(mix, model.vocab_size):
        engine.submit(req.prompt, req.max_new_tokens, temperature=req.temperature, top_p=req.top_p,
                      seed=req.seed).result(timeout=600)
    docs = workload.documents(mix, model.vocab_size, seed)
    handles = [engine.submit(doc, 1) for doc in docs]
    for h in handles:
        h.result(timeout=600)
    stream = workload.Stream(mix, model.vocab_size, seed)

    async def drive():
        state = {"stop": False, "completed": 0, "preroll": int(mix["preroll_completions"]),
                 "open": asyncio.Event()}
        tasks = [asyncio.create_task(_client(engine, stream, out.records, state))
                 for _ in range(int(mix["clients"]))]
        # a pre-roll that never completes (an engine that fails every
        # request) ends the run instead of hanging it
        await asyncio.wait_for(state["open"].wait(), PREROLL_TIMEOUT_S)
        out.t0, out.wall0 = time.perf_counter(), time.time()
        launches0 = dict(_build.LAUNCHES)
        out.counters["t0"] = _counters(engine)
        tracer = None
        if trace:
            await asyncio.sleep(max(0.0, out.t0 + seconds - trace_seconds - time.perf_counter()))
            tracer = tracer_cls()
            tracer.start()
        await asyncio.sleep(max(0.0, out.t0 + seconds - time.perf_counter()))
        out.t1, out.wall1 = out.t0 + seconds, time.time()
        out.counters["t1"] = _counters(engine)
        out.launches = {k: v - launches0.get(k, 0) for k, v in _build.LAUNCHES.items()}
        state["stop"] = True
        if tracer is not None:
            out.trace = tracer.stop()
        return tasks

    loop = asyncio.new_event_loop()
    try:
        tasks = loop.run_until_complete(drive())
        engine.stop()
        loop.run_until_complete(asyncio.gather(*tasks, return_exceptions=True))
    finally:
        loop.close()
    tracing.remove_span_tap(tap)
    return out, engine


def metrics(run: ServeRun) -> dict:
    return stats.serving_metrics(run.records, run.t0, run.t1)


def attempted_failed(run: ServeRun) -> tuple[int, int]:
    inside = [r for r in run.records if run.t0 <= r.submitted < run.t1]
    failed = [r for r in inside if r.error is not None and (r.finished or 0) < run.t1]
    return len(inside), len(failed)


def free(engine) -> None:
    engine.params = None
    engine.cache = None
    engine.decode_graph = None
    gc.collect()


def sample_for_check(run: ServeRun, n: int, seed: int) -> list[Record]:
    """Greedy requests that finished inside the window: the longest of them
    and then others drawn with the seed, `n` in all."""
    done = [r for r in run.records
            if r.greedy and r.error is None and r.finished is not None and run.t0 <= r.finished < run.t1
            and len(r.tokens) == r.max_new_tokens]
    if not done:
        return []
    longest = max(done, key=lambda r: r.prompt_tokens + len(r.tokens))
    rest = [r for r in done if r is not longest]
    order = workload.rng(seed, "check").permutation(len(rest))
    return [longest] + [rest[i] for i in order[: max(0, n - 1)]]

