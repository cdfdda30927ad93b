"""The port's critical-path attribution (observability/critical_path.py)
and the rest of its span store (tracing.py: find_traces, the sink's size
cap and rotation, gc) against the JAX package's: the same span lists go
through both modules and the results must be exactly equal. Then a no-op
`.remote()` through the port's plane must leave at most 10% of its wall
time unattributed (`gap`), the JAX package's own bar."""

import json
import os
import tempfile
import time

import numpy as np
import pytest
from click.testing import CliRunner

from modal_tpu.cli.entry_point import cli as jcli
from modal_tpu.observability import critical_path as jcp
from modal_tpu.observability import tracing as jtracing
from modal_tpu_torch.cli.entry_point import cli as tcli
from modal_tpu_torch.observability import critical_path as tcp
from modal_tpu_torch.observability import tracing as ttracing


def _span(name, start, end, span_id, parent_id="", trace_id="t1", **attrs):
    return {"trace_id": trace_id, "span_id": span_id, "parent_id": parent_id, "name": name, "start": start,
            "end": end, "status": "ok", "attrs": attrs, "events": []}


# the span lists of tests/test_attribution.py, and more
PRIORITIES = [
    _span("function.call", 0.0, 1.0, "root"),
    _span("rpc.client.FunctionGetOutputs", 0.1, 0.9, "poll", "root"),
    _span("user.execute", 0.3, 0.6, "exec", "root"),
    _span("scheduler.queue_wait", 0.1, 0.2, "qw", "root"),
]
SKEWED = [
    _span("rpc.server.FunctionMap", 0.995, 1.2, "child", "parent"),
    _span("rpc.client.FunctionMap", 1.0, 1.3, "parent", "root"),
    _span("function.call", 1.0, 2.0, "root"),
    _span("user.execute", 1.5, 1.9, "exec", "root"),
]
COLD = [
    _span("function.call", 10.0, 14.0, "root"),
    _span("client.prepare", 10.0, 10.01, "prep", "root"),
    _span("rpc.client.FunctionMap", 10.001, 10.009, "map", "prep"),
    _span("rpc.server.FunctionMap", 10.002, 10.008, "smap", "map"),
    _span("scheduler.queue_wait", 10.008, 10.02, "qw", "root"),
    _span("scheduler.place", 10.02, 10.03, "pl", "root"),
    _span("worker.launch_task", 10.03, 10.05, "wl", "pl"),
    _span("container.boot", 10.05, 12.5, "boot", "wl"),
    _span("container.import_torch", 10.2, 11.9, "it", "boot"),
    _span("container.imports", 11.9, 12.3, "imp", "boot"),
    _span("container.enter_hooks", 12.3, 12.5, "enter", "boot"),
    _span("container.input_deliver", 12.5, 12.52, "del", "root"),
    _span("user.execute", 12.52, 13.9, "exec", "root"),
    _span("client.await_output", 10.01, 14.0, "await", "root"),
    _span("client.stream_outputs", 10.02, 13.99, "stream", "await"),
    _span("recovery.crash_restart", 11.0, 11.4, "rec", ""),
    _span("dispatch.coalesce", 10.0, 10.004, "co", "prep"),
]
SERVING = [
    _span("serving.request", 0.0, 2.0, "req", trace_id="s1"),
    _span("serving.admit", 0.0, 0.1, "adm", "req", trace_id="s1"),
    _span("serving.prefill", 0.1, 0.6, "pf", "req", trace_id="s1"),
    _span("serving.prefill_chunk", 0.15, 0.35, "pc", "pf", trace_id="s1"),
    _span("serving.decode", 0.6, 1.6, "dec", "req", trace_id="s1"),
    _span("serving.preempt", 1.0, 1.1, "pre", "req", trace_id="s1"),
    _span("serving.stream", 0.0, 1.9, "st", "req", trace_id="s1"),
]
NAMES = [r[0].rstrip("*") + ("Any" if r[0].endswith("*") else "") for r in jcp.SEGMENT_RULES] + ["unknown.span"]


def _random_trace(seed: int) -> list:
    """A random call tree over the rule names, seeded with numpy."""
    rng = np.random.default_rng(seed)
    t0 = float(rng.uniform(0, 100))
    total = float(rng.uniform(0.01, 5.0))
    spans = [_span("function.call", t0, t0 + total, "root", trace_id=f"r{seed}")]
    for i in range(int(rng.integers(3, 25))):
        a, b = sorted(rng.uniform(t0 - 0.05 * total, t0 + 1.05 * total, size=2))
        parent = spans[int(rng.integers(0, len(spans)))]["span_id"]
        spans.append(_span(str(rng.choice(NAMES)), float(a), float(b), f"s{i}", parent, trace_id=f"r{seed}"))
    return spans


CASES = {"priorities": PRIORITIES, "skewed": SKEWED, "cold": COLD,
         **{f"random{seed}": _random_trace(seed) for seed in range(8)}}


def test_the_rules_and_constants_are_the_jax_packages():
    assert tcp.SEGMENT_RULES == jcp.SEGMENT_RULES
    assert tcp.SERVING_SEGMENT_RULES == jcp.SERVING_SEGMENT_RULES
    assert (tcp.ROOT_SPAN, tcp.SERVING_ROOT_SPAN, tcp.GAP) == (jcp.ROOT_SPAN, jcp.SERVING_ROOT_SPAN, jcp.GAP)
    assert tcp.SEGMENT_ORDER == jcp.SEGMENT_ORDER
    from modal_tpu_torch import observability

    assert observability.critical_path is tcp


@pytest.mark.parametrize("case", sorted(CASES))
def test_attribution_of_a_call_is_the_jax_packages(case):
    spans = CASES[case]
    got, want = tcp.attribute_trace(spans), jcp.attribute_trace(spans)
    assert got == want and got is not None
    assert sum(v for k, v in got.items() if k != "total") == pytest.approx(got["total"])
    assert tcp.order_spans(spans) == jcp.order_spans(spans)
    assert tcp.normalize_starts(spans) == jcp.normalize_starts(spans)
    assert tcp.span_depth(spans) == jcp.span_depth(spans)


def test_priorities_and_the_gap_match_the_jax_tests_numbers():
    attr = tcp.attribute_trace(PRIORITIES)
    assert attr["user.execute"] == pytest.approx(0.3) and attr["queue_wait"] == pytest.approx(0.1)
    assert attr["output_deliver"] == pytest.approx(0.4) and attr["gap"] == pytest.approx(0.2)
    ordered = [s["span_id"] for s in tcp.order_spans(SKEWED)]
    assert ordered.index("root") < ordered.index("parent") < ordered.index("child") < ordered.index("exec")


@pytest.mark.parametrize("spans", [[], [_span("user.execute", 1.0, 1.0, "x")]], ids=["empty", "zero_length"])
def test_no_root_no_attribution(spans):
    assert tcp.attribute_trace(spans) is None and jcp.attribute_trace(spans) is None


def test_the_serving_ruleset_is_the_jax_packages():
    kw = dict(rules=tcp.SERVING_SEGMENT_RULES, root_span=tcp.SERVING_ROOT_SPAN)
    got = tcp.attribute_trace(SERVING, **kw)
    assert got == jcp.attribute_trace(SERVING, rules=jcp.SERVING_SEGMENT_RULES, root_span=jcp.SERVING_ROOT_SPAN)
    assert got["requeue"] == pytest.approx(0.1) and got["gap"] == pytest.approx(0.1)  # [1.9, 2.0) uncovered


def test_aggregate_and_table_are_the_jax_packages():
    per_trace = [jcp.attribute_trace(CASES[c]) for c in sorted(CASES)]
    per_trace += [{"user.execute": 0.1, "gap": 0.0, "total": 0.1}, {}]
    got, want = tcp.aggregate_attributions(per_trace), jcp.aggregate_attributions(per_trace)
    assert got == want and got["calls"] == len(CASES) + 1
    assert tcp.format_attribution_table(got) == jcp.format_attribution_table(want)


def _write_store(store: str, traces: list) -> None:
    os.makedirs(store, exist_ok=True)
    with open(os.path.join(store, "spans-1.jsonl"), "w") as f:
        for spans in traces:
            for s in spans:
                f.write(json.dumps(s) + "\n")
        f.write('{"torn": \n')  # a line torn by a crash mid-write


@pytest.mark.parametrize("needle,last,serving", [("", 0, False), ("r3", 0, False), ("", 3, False),
                                                 ("", 0, True), ("no-such", 0, False)])
def test_attribute_store_and_find_traces_are_the_jax_packages(tmp_path, needle, last, serving):
    store = str(tmp_path / "traces")
    traces = [CASES[c] for c in sorted(CASES)] + [SERVING]
    _write_store(store, traces)
    assert ttracing.find_traces(store, needle) == jtracing.find_traces(store, needle)
    got = tcp.attribute_store(store, needle, last=last, serving=serving)
    assert got == jcp.attribute_store(store, needle, last=last, serving=serving)


def test_the_sink_rotates_at_its_cap(tmp_path, monkeypatch):
    """The port's sink rotates as the JAX package's: at MODAL_TPU_TRACE_MAX_BYTES
    the live file becomes spans-<pid>.jsonl.1 and readers see both."""
    monkeypatch.setenv(ttracing.TRACE_MAX_BYTES_ENV, "20000")
    store = str(tmp_path / "tr")
    saved = ttracing.trace_dir()
    ttracing.configure(store)
    try:
        assert ttracing.enabled()
        for i in range(100):
            ttracing.record_span("scheduler.place", start=1.0, end=2.0,
                                 parent=ttracing.SpanContext("t" * 32, "s" * 16), attrs={"filler": "x" * 64, "i": i})
        live = os.path.join(store, f"spans-{os.getpid()}.jsonl")
        assert os.path.exists(live + ".1") and os.path.getsize(live) < 20000
        assert len(ttracing.read_spans(store)) == 100 == len(jtracing.read_spans(store))
    finally:
        ttracing._shutdown()
        if saved:
            ttracing.configure(saved)


def test_gc_and_the_trace_gc_command_are_the_jax_packages(tmp_path):
    reports, outputs = [], []
    for mod, cli in ((jtracing, jcli), (ttracing, tcli)):
        store = tmp_path / mod.__name__ / "state" / "traces"
        store.mkdir(parents=True)
        old = store / "spans-111.jsonl"
        old.write_text("x" * 1000)
        os.utime(old, (time.time() - 10 * 24 * 3600,) * 2)
        (store / "spans-222.jsonl.1").write_text("y" * 5000)
        (store / "spans-333.jsonl").write_text("z" * 100)
        reports.append(mod.gc_trace_dir(str(store), max_total_bytes=1024, max_age_s=7 * 24 * 3600))
        (store / "spans-9.jsonl").write_text('{"trace_id": "t"}\n' * 10)
        result = CliRunner().invoke(cli, ["trace", "gc", "--state-dir", str(store.parent), "--max-mb", "1"])
        assert result.exit_code == 0, result.output
        outputs.append(result.output)
    assert reports[0] == reports[1] and reports[1]["removed"] == 2 and reports[1]["kept"] == 1
    assert outputs[0] == outputs[1] and "kept 2" in outputs[1]


def test_a_no_op_remote_through_the_ports_plane_is_attributed(tmp_path):
    """A no-op `.remote()` through the port's plane: every call's
    attribution sums to its wall time and leaves at most 10% of it as
    `gap`; `app attribute` reads the same."""
    import modal_tpu_torch
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.client import _Client
    from modal_tpu_torch.server.supervisor import LocalSupervisor

    state = tempfile.mkdtemp(prefix="attr-", dir="/tmp")
    sup = LocalSupervisor(num_workers=1, state_dir=state, worker_gpus=1, worker_gpu_type="local-sim")
    synchronizer.run(sup.start())
    client = _Client(sup.server_url)
    client._open()
    try:
        app = modal_tpu_torch.App("noop")

        def noop(x):
            return x

        f = app.function(serialized=True)(noop)
        with app.run(client=client):
            assert [f.remote(i) for i in range(6)] == list(range(6))
    finally:
        client._close()
        synchronizer.run(sup.stop())
    store = os.path.join(state, "traces")
    agg, per_trace = tcp.attribute_store(store, f.object_id)
    calls = [a for a in per_trace if a]
    assert agg["calls"] == 6 == len(calls)
    for a in calls:
        assert sum(v for k, v in a.items() if k != "total") == pytest.approx(a["total"])
    warm = calls[1:]  # the first call also boots the container
    assert all(a["gap"] <= 0.10 * a["total"] for a in warm), [(a["gap"], a["total"]) for a in warm]
    assert calls[0]["gap"] <= 0.10 * calls[0]["total"]
    result = CliRunner().invoke(tcli, ["app", "attribute", f.object_id, "--state-dir", state, "--json"])
    assert result.exit_code == 0 and json.loads(result.output) == agg
