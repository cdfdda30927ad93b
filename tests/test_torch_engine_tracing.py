"""The serving loop's `serving.step` span (serving/step_trace.py) on the CPU:
its phases tile the iteration, its counts match what the iteration did, it
reaches every tap but the file sink at most once a second, it opens no
profiler range, and with nothing reading spans the engine builds none."""

import json
import os

import numpy as np
import pytest
import torch

from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.observability import catalog, tracing
from modal_tpu_torch.serving import ServingEngine, step_trace
from modal_tpu_torch.serving.step_trace import PHASES

GEOMETRY = dict(max_slots=4, num_pages=40, page_size=8, pages_per_slot=8, prefill_chunk=16)


@pytest.fixture(scope="module")
def tiny():
    cfg = tllama.get_config("tiny", dtype=torch.float32)
    return tllama.init_params(cfg, seed=3, device="cpu"), cfg


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    """No sink and no tap from elsewhere in the process."""
    monkeypatch.setattr(tracing, "_span_taps", [])
    monkeypatch.setattr(tracing, "_sink_file", None)
    monkeypatch.setattr(step_trace, "_sunk_at", float("-inf"))


@pytest.fixture
def spans():
    got: list = []
    tracing.add_span_tap(got.append)
    try:
        yield got
    finally:
        tracing.remove_span_tap(got.append)


def _engine(tiny):
    params, cfg = tiny
    return ServingEngine(params, cfg, device="cpu", **GEOMETRY)


def _prompts(n, length, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=length).tolist() for _ in range(n)]


def _steps(spans):
    return [s for s in spans if s.name == "serving.step"]


def test_each_iteration_is_one_step_span_whose_phases_tile_it(tiny, spans):
    eng = _engine(tiny)
    reqs = [eng.submit(p, 6) for p in _prompts(3, 20)]
    n_iter = 0
    while not all(r.done for r in reqs):
        before = len(_steps(spans))
        decoding = sum(1 for s in eng.slots if s is not None and s.state == "decode")
        to_prefill = bool(eng.waiting) or any(s is not None and s.state == "prefill" for s in eng.slots)
        eng.run_once()
        n_iter += 1
        steps = _steps(spans)
        assert len(steps) == before + 1
        sp = steps[-1]
        a = sp.attrs
        length_ms = (sp.end - sp.start) * 1e3
        total = sum(a[f"{p}_ms"] for p in PHASES)
        assert total == pytest.approx(length_ms, rel=0.01)
        assert 0.0 <= a["prefill_sync_ms"] <= a["prefill_ms"]
        # the oldest prefilling slot advances one chunk of at most 16 tokens
        assert (a["prefill_tokens"] > 0) == to_prefill
        assert a["prefill_tokens"] <= GEOMETRY["prefill_chunk"]
        # a slot whose prefill completes this iteration decodes in it too
        assert a["batch"] >= decoding
        assert set(a) == {f"{p}_ms" for p in PHASES} | {"prefill_sync_ms", "batch", "prefill_tokens",
                                                         "finished", "replay_at_ms"}
        assert (a["replay_at_ms"] is not None) == (a["batch"] > 0)
        assert sp.parent_id == ""
        assert n_iter < 200
    steps = _steps(spans)
    assert sum(s.attrs["finished"] for s in steps) == 3
    # every token after a request's first comes from a decode step
    assert sum(s.attrs["batch"] for s in steps) == sum(len(r.tokens) - 1 for r in reqs)
    prompts = sum(len(r.prompt) for r in reqs)
    assert sum(s.attrs["prefill_tokens"] for s in steps) == prompts
    eng.stop()


def test_prefill_chunk_spans_are_written_at_the_hosts_enqueue(tiny, spans):
    eng = _engine(tiny)
    req = eng.submit(_prompts(1, 40)[0], 3)
    sizes = []
    while not req.done:
        eng.run_once()
        step = _steps(spans)[-1]
        chunks = [s for s in spans if s.name == "serving.prefill_chunk"]
        # the iteration's chunk is written by the time its step span is
        assert [c.attrs["chunk_tokens"] for c in chunks][len(sizes):] == (
            [step.attrs["prefill_tokens"]] if step.attrs["prefill_tokens"] else [])
        sizes = [c.attrs["chunk_tokens"] for c in chunks]
        assert all(step.start <= c.start <= c.end <= step.end for c in chunks[-1:] if step.attrs["prefill_tokens"])
    assert sizes == [16, 16, 8]
    chunks = [s for s in spans if s.name == "serving.prefill_chunk"]
    assert all(c.trace_id == req.trace_context.trace_id for c in chunks)
    assert all("device_ms" not in c.attrs for c in chunks)
    eng.stop()


def test_with_nothing_reading_spans_the_engine_builds_none(tiny, monkeypatch):
    assert not tracing.active()
    built = []
    real = tracing._child

    def counting(*args, **kwargs):
        built.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(tracing, "_child", counting)
    eng = _engine(tiny)
    reqs = [eng.submit(p, 5) for p in _prompts(6, 18)]
    while not all(r.done for r in reqs):
        eng.run_once()
    assert all(len(r.tokens) == 5 for r in reqs)
    assert built == []
    eng.stop()
    # a tap turns them on again
    got: list = []
    tracing.add_span_tap(got.append)
    try:
        eng2 = _engine(tiny)
        r = eng2.submit(_prompts(1, 10)[0], 2)
        while not r.done:
            eng2.run_once()
        eng2.stop()
    finally:
        tracing.remove_span_tap(got.append)
    assert "serving.step" in built and "serving.request" in built
    assert {s.name for s in got} >= {"serving.step", "serving.request", "serving.prefill_chunk"}


def test_the_file_sink_takes_one_step_span_a_second(tiny, spans, tmp_path, monkeypatch):
    monkeypatch.setattr(tracing, "_sink_dir", None)
    tracing.configure(str(tmp_path))
    clock = [1000.0]
    monkeypatch.setattr(step_trace, "_clock", lambda: clock[0])
    try:
        eng = _engine(tiny)
        reqs = [eng.submit(p, 30) for p in _prompts(4, 12)]
        n = 0
        while not all(r.done for r in reqs):
            eng.run_once()
            n += 1
            if n == 20:
                clock[0] += 1.0  # one second passes in the middle of the flood
        eng.stop()
    finally:
        tracing._shutdown()
    assert len(_steps(spans)) == n > 20
    with open(os.path.join(tmp_path, f"spans-{os.getpid()}.jsonl")) as f:
        written = [json.loads(line) for line in f]
    assert sum(1 for w in written if w["name"] == "serving.step") == 2
    # the request timelines are all written
    assert sum(1 for w in written if w["name"] == "serving.request") == 4


def test_serving_step_is_a_declared_port_span():
    assert catalog.SPAN_CATALOG["serving.step"].startswith("the port's: ")
    assert "host enqueue" in catalog.SPAN_CATALOG["serving.prefill_chunk"]


def test_step_seconds_get_no_sample_without_cuda(tiny):
    before = catalog.STEP_SECONDS.totals(kind="decode"), catalog.STEP_SECONDS.totals(kind="prefill")
    eng = _engine(tiny)
    r = eng.submit(_prompts(1, 20)[0], 4)
    while not r.done:
        eng.run_once()
    eng.stop()
    after = catalog.STEP_SECONDS.totals(kind="decode"), catalog.STEP_SECONDS.totals(kind="prefill")
    assert after == before


def test_the_step_opens_no_profiler_range(tiny, spans):
    """A profiler on the loop's own thread sees the engine's ops but no
    range of the step's: its phases are on the span alone."""
    eng = _engine(tiny)
    r = eng.submit(_prompts(1, 20)[0], 4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        while not r.done:
            eng.run_once()
    eng.stop()
    names = {e.name for e in prof.events()}
    assert _steps(spans) and any(n.startswith("aten::") for n in names)
    assert not [n for n in names if n.startswith("serving.")]
