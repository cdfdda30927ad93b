"""The port's device and compile telemetry (`observability/
device_telemetry.py`, `metrics.py`) and import tracing
(`runtime/telemetry.py`) against the JAX package's, on the CPU.

A container's heartbeat report is JSON in the JAX package's schema, so the
port's report merges through JAX's `merge_container_report` and JAX's
through the port's, counters and histograms by delta, device gauges scoped
per task. `telemetry_summary` keeps JAX's keys; the compile hooks turn the
kernel build's and the graph captures' reports into the JAX families; import
traces summarize the same way under both packages."""

import importlib
import json
import sys
import textwrap

import pytest

from modal_tpu.observability import catalog as jcatalog
from modal_tpu.observability import device_telemetry as jdt
from modal_tpu.observability import metrics as jmetrics
from modal_tpu.runtime import telemetry as jtelemetry
from modal_tpu_torch.observability import catalog as tcatalog
from modal_tpu_torch.observability import device_telemetry as tdt
from modal_tpu_torch.observability import metrics as tmetrics
from modal_tpu_torch.ops import _build
from modal_tpu_torch.runtime import telemetry as ttelemetry


def _events(catalog, **labels):
    return catalog.COMPILE_EVENTS.value(**labels)


def test_compile_hooks_turn_build_reports_into_the_jax_families(monkeypatch):
    """nvcc → compile, a build-directory hit → cache_hit, a miss →
    cache_miss, a capture → graph_capture (source: runtime, or prewarm
    during an image bake); seconds land under their phase. A fleet fetch
    adds only its seconds: the fleet tier counts its own hit."""
    assert tdt.install_compile_hooks() and tdt.install_compile_hooks()
    before = {e: _events(tcatalog, event=e, source="runtime")
              for e in ("compile", "cache_hit", "cache_miss", "graph_capture")}
    secs = {p: tcatalog.COMPILE_SECONDS.totals(phase=p) for p in ("nvcc", "local", "fleet", "graph_capture")}
    for event, seconds in (("cache_miss", 0.0), ("nvcc", 9.5), ("local", 0.001), ("fleet", 0.02),
                           ("graph_capture", 0.7)):
        _build.report_compile(event, seconds)
    after = {e: _events(tcatalog, event=e, source="runtime") for e in before}
    assert {e: after[e] - before[e] for e in before} == {
        "compile": 1, "cache_hit": 1, "cache_miss": 1, "graph_capture": 1}
    for phase, s in (("nvcc", 9.5), ("local", 0.001), ("fleet", 0.02), ("graph_capture", 0.7)):
        total, count = tcatalog.COMPILE_SECONDS.totals(phase=phase)
        assert count == secs[phase][1] + 1 and total == pytest.approx(secs[phase][0] + s)
    monkeypatch.setenv("MODAL_TPU_PREWARM_BUILD", "1")
    p0 = _events(tcatalog, event="compile", source="prewarm")
    _build.report_compile("nvcc", 1.0)
    assert _events(tcatalog, event="compile", source="prewarm") == p0 + 1


def test_a_failing_listener_never_breaks_a_build(monkeypatch):
    monkeypatch.setattr(_build, "_compile_listeners", [lambda e, s: 1 / 0])
    _build.report_compile("nvcc", 1.0)


def _port_samples():
    tdt.install_compile_hooks()
    _build.report_compile("nvcc", 4.0)
    tcatalog.COMPILE_CACHE_HITS.inc(source="local_dir")
    tcatalog.STEP_SECONDS.observe(0.011, kind="decode")
    tcatalog.SERVING_TOKENS.inc(64)


def _jax_samples():
    jcatalog.DEVICE_MEMORY_BYTES.set(2.5e9, device="tpu:0", kind="bytes_in_use")
    jcatalog.COMPILE_EVENTS.inc(event="compile", source="runtime")
    jcatalog.COMPILE_SECONDS.observe(4.0, phase="backend_compile")
    jcatalog.COMPILE_CACHE_HITS.inc(source="local_dir")
    jcatalog.STEP_SECONDS.observe(0.011, kind="decode")
    jcatalog.SERVING_TOKENS.inc(64)


def _totals(catalog):
    return {
        "compile": catalog.COMPILE_EVENTS.value(event="compile", source="runtime"),
        "hits": catalog.COMPILE_CACHE_HITS.value(source="local_dir"),
        "steps": catalog.STEP_SECONDS.count_total(),
        "tokens": catalog.SERVING_TOKENS.value(),
    }


@pytest.mark.parametrize("direction", ["port→jax", "jax→port"])
def test_each_packages_worker_merges_the_others_report(direction):
    """The report of one package merges into the other's registry: counter
    and histogram deltas apply once (a repeated push of the same totals
    adds nothing), the device gauges arrive scoped by the task id and are
    dropped with the task."""
    if direction == "port→jax":
        _port_samples()
        report, merge, sink, drop = tdt.container_report(), jdt.merge_container_report, jcatalog, jdt
    else:
        _jax_samples()
        report, merge, sink, drop = jdt.container_report(), tdt.merge_container_report, tcatalog, tdt
    parsed = json.loads(report)
    assert "modal_tpu_device_memory_bytes" in parsed and "modal_tpu_compile_events_total" in parsed
    pushed = parsed["modal_tpu_compile_events_total"]["series"]["compile,runtime"]
    steps = sum(series["count"] for series in parsed["modal_tpu_step_seconds"]["series"].values())
    before = _totals(sink)
    prev = merge(report, "", task_id="task-x")
    assert prev == report
    after = _totals(sink)
    assert after["compile"] - before["compile"] == pushed
    assert after["steps"] - before["steps"] == steps
    assert after["tokens"] - before["tokens"] == parsed["modal_tpu_serving_tokens_total"]["series"][""]
    merge(report, prev, task_id="task-x")
    assert _totals(sink) == after, "a repeated push of the same totals double counted"
    scoped = [k for k in sink.DEVICE_MEMORY_BYTES._series if str(k[0]).startswith("task-x/")]
    assert scoped
    assert drop.drop_task_device_series("task-x") == len(scoped)
    assert merge("{not json", prev, task_id="task-x") == ""


def test_pushed_gauge_reads_what_jax_reads():
    report = {"modal_tpu_serving_ttft_p95_seconds": {"kind": "gauge", "series": {"": 0.25}},
              "modal_tpu_kv_pages_free": {"kind": "gauge", "series": {"a": 3, "b": "x", "c": 4.5}},
              "broken": {"series": [1, 2]}}
    for name in (*report, "absent"):
        assert tdt.pushed_gauge(report, name) == jdt.pushed_gauge(report, name), name


def test_telemetry_summary_keys_are_jaxs(monkeypatch):
    # each package's step histogram holds only this test's samples: other test
    # files sharing the worker process observe train and decode steps into the
    # process-wide registries, so their p50s would compare those histories
    for catalog, metrics in ((tcatalog, tmetrics), (jcatalog, jmetrics)):
        step = catalog.STEP_SECONDS
        monkeypatch.setattr(catalog, "STEP_SECONDS",
                            metrics.Histogram(step.name, step.help, step.labelnames, buckets=step.buckets))
    _port_samples()
    _jax_samples()
    tcatalog.COMPILE_CACHE_PUTS.inc(source="local_dir")
    jcatalog.COMPILE_CACHE_PUTS.inc(source="local_dir")
    port, jax_summary = tdt.telemetry_summary(), jdt.telemetry_summary()
    assert set(port) == set(jax_summary) == {"compile_events", "compile_cache", "compile_p50_s", "step_p50_s"}
    assert set(port["compile_cache"]) == set(jax_summary["compile_cache"]) == {"hits", "misses", "puts"}
    assert port["step_p50_s"] == jax_summary["step_p50_s"]  # same buckets, same bucket quantile


def test_export_families_matches_jax_shape():
    """Same family names, kinds and series encodings as JAX's exporter."""
    from modal_tpu.observability.metrics import export_families as jexport
    from modal_tpu_torch.observability.metrics import export_families as texport

    _port_samples()
    _jax_samples()
    names = ("modal_tpu_compile_events_total", "modal_tpu_step_seconds", "modal_tpu_serving_tokens_total")
    port, jax_report = texport(names), jexport(names)
    assert set(port) == set(jax_report) == set(names)
    for name in names:
        assert port[name]["kind"] == jax_report[name]["kind"]
    assert "compile,runtime" in port["modal_tpu_compile_events_total"]["series"]
    hist = port["modal_tpu_step_seconds"]["series"]["decode"]
    assert set(hist) == {"counts", "sum", "count"}
    assert len(hist["counts"]) == len(jax_report["modal_tpu_step_seconds"]["series"]["decode"]["counts"])


@pytest.fixture
def fresh_package(tmp_path, monkeypatch):
    """A package never imported before, on sys.path: pkg (imports pkg.child)."""
    root = tmp_path / "src"
    (root / "coldpkg").mkdir(parents=True)
    (root / "coldpkg" / "__init__.py").write_text("from . import child\nVALUE = child.X + 1\n")
    (root / "coldpkg" / "child.py").write_text(textwrap.dedent("""
        import time
        time.sleep(0.02)
        X = 41
    """))
    (root / "coldpkg_other.py").write_text("Y = 1\n")
    monkeypatch.syspath_prepend(str(root))
    yield
    for name in ("coldpkg", "coldpkg.child", "coldpkg_other"):
        sys.modules.pop(name, None)


def _trace(interceptor_cls, path):
    lines = []
    interceptor = interceptor_cls(lambda event: lines.append(json.dumps(event)))
    sys.meta_path.insert(0, interceptor)
    try:
        importlib.import_module("coldpkg")
        importlib.import_module("coldpkg_other")
    finally:
        sys.meta_path.remove(interceptor)
        for name in ("coldpkg", "coldpkg.child", "coldpkg_other"):
            sys.modules.pop(name, None)
    path.write_text("\n".join(lines) + "\n{torn")
    return [json.loads(ln) for ln in lines]


def test_import_trace_lines_summarize_like_jaxs(tmp_path, fresh_package):
    """The same imports traced by each package's interceptor give events of
    one shape (modules, depths, keys), and each package's `summarize` reads
    the other's file the same way (a torn last line is skipped)."""
    port = _trace(ttelemetry.ImportInterceptor, tmp_path / "port.jsonl")
    jax_events = _trace(jtelemetry.ImportInterceptor, tmp_path / "jax.jsonl")
    shape = lambda events: [(e["event"], e["module"], e["depth"], sorted(e)) for e in events]  # noqa: E731
    assert shape(port) == shape(jax_events)
    assert [e["module"] for e in port] == ["coldpkg.child", "coldpkg", "coldpkg_other"]
    for path in (tmp_path / "port.jsonl", tmp_path / "jax.jsonl"):
        got = ttelemetry.summarize(str(path), top=5)
        assert got == jtelemetry.summarize(str(path), top=5)
        assert [e["module"] for e in got] == ["coldpkg", "coldpkg_other"]
        assert got[0]["duration_s"] >= 0.02


def test_importing_the_tracer_imports_no_torch():
    """A boot installs the tracer before `import torch`: the package, its
    runtime package and the tracer must not pull torch in themselves."""
    import subprocess

    code = ("import sys; import modal_tpu_torch.runtime.telemetry as t; "
            "print('torch' in sys.modules, hasattr(t, 'instrument_imports'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "True"]
