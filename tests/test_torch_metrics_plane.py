"""The port's metrics plane against the JAX package's: the text expositions
(`render_prometheus`, `render_openmetrics`), the tracing helpers the plane
uses, the sampling profiler's folded files, the history queries and the
plane's surfaces: `/metrics` and `/metrics/history` on the blob server,
MetricsHistory, ProfileControl, AppListProfiles and TaskGetTimeline, an
SLO alert that survives `crash_restart`, and `runtime_debug=True`'s
torch.profiler trace. After the JAX package's tests/test_observability.py
and tests/test_attribution.py."""

import asyncio
import importlib
import json
import os
import tempfile
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import modal_tpu_torch
from tests.test_torch_app import CONTAINER_ENV, Planes

PKGS = ("modal_tpu", "modal_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# -- the text expositions -------------------------------------------------------


def _filled_registry(pkg: str, seed: int):
    """A fresh registry of each metric kind, fed the same seeded
    observations (label values that need escaping, exemplars on some
    histogram observations)."""
    metrics = _mod(pkg, "observability.metrics")
    rng = np.random.default_rng(seed)
    reg = metrics.MetricsRegistry()
    c = reg.counter("modal_tpu_demo_requests_total", 'Requests "served" \\ by\nmethod.', ("method", "code"))
    g = reg.gauge("modal_tpu_demo_queue_depth", "Queue depth.", ("pool",))
    h = reg.histogram("modal_tpu_demo_latency_seconds", "Latency.", ("route",), buckets=(0.01, 0.1, 1.0, 10.0))
    reg.counter("modal_tpu_demo_untouched_total", "Never incremented: renders its header only.")
    bare = reg.histogram("modal_tpu_demo_bare_seconds", "Unlabelled.")
    methods = ["Get", 'say "hi"', "back\\slash", "new\nline"]
    for i in range(40):
        c.inc(float(rng.integers(1, 4)), method=methods[int(rng.integers(0, 4))], code=str(int(rng.integers(0, 3))))
        g.set(float(rng.uniform(0, 50)), pool=f"p{int(rng.integers(0, 3))}")
        g.inc(1.5, pool="p0")
        v = float(rng.lognormal(-2.0, 2.0))
        h.observe(v, exemplar=f"trace{i:04d}" if i % 3 else None, route=f"/r{int(rng.integers(0, 2))}")
        bare.observe(v)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_expositions_are_byte_equal_to_the_jax_registry(seed):
    clock = types.SimpleNamespace(time=lambda: 1700000000.123456)
    out = {}
    for pkg in PKGS:
        metrics = _mod(pkg, "observability.metrics")
        real = metrics.time
        metrics.time = clock  # the exemplars' timestamps
        try:
            reg = _filled_registry(pkg, seed)
        finally:
            metrics.time = real
        out[pkg] = (reg.render_prometheus(), reg.render_openmetrics(), reg.names(), reg.snapshot())
    assert out["modal_tpu_torch"] == out["modal_tpu"]
    prom, om, _names, _snap = out["modal_tpu_torch"]
    assert '# TYPE modal_tpu_demo_requests counter' in om and "modal_tpu_demo_requests_total{" in om
    assert om.endswith("# EOF\n") and not prom.endswith("# EOF\n")
    assert ' # {trace_id="trace0' in om and "trace_id" not in prom
    assert "# HELP modal_tpu_demo_untouched_total Never incremented" in prom
    assert 'method="new\\nline"' in prom and 'method="say \\"hi\\""' in prom


def test_reset_names_and_bench_summary_equal_the_jax_registry():
    out = {}
    for pkg in PKGS:
        metrics = _mod(pkg, "observability.metrics")
        reg = metrics.MetricsRegistry()
        lat = reg.histogram("modal_tpu_rpc_latency_seconds", "rpc", ("method",))
        disp = reg.histogram("modal_tpu_dispatch_latency_seconds", "dispatch")
        reg.counter("modal_tpu_blob_bytes_total", "blob").inc(12345.678)
        reg.gauge("modal_tpu_weights_load_gbps", "gbps").set(1.23456)
        for i in range(25):
            lat.observe(0.001 * (i + 1), method="A" if i % 2 else "B")
            disp.observe(0.01 * i)
        summary = reg.bench_summary()
        names = reg.names()
        reg.reset()
        out[pkg] = (summary, names, reg.render_prometheus())
    assert out["modal_tpu_torch"] == out["modal_tpu"]
    assert out["modal_tpu_torch"][0]["rpc_count"] == 25


def test_the_port_catalog_names_the_plane_families_as_jax_does():
    jcat, tcat = _mod("modal_tpu", "observability.catalog"), _mod("modal_tpu_torch", "observability.catalog")
    for name in ("SLO_BURN_RATE", "SLO_ALERTS_FIRING", "SLO_ALERT_TRANSITIONS", "TIMESERIES_SAMPLES",
                 "TIMESERIES_SAMPLE_SECONDS", "TIMESERIES_POINTS", "PROFILER_SAMPLES", "PROFILER_RUNNING"):
        j, t = getattr(jcat, name), getattr(tcat, name)
        assert (t.name, t.help, t.kind, t.labelnames) == (j.name, j.help, j.kind, j.labelnames), name
        assert getattr(t, "buckets", None) == getattr(j, "buckets", None), name


# -- tracing helpers -----------------------------------------------------------


def test_current_span_set_attr_and_remote_context():
    from modal_tpu_torch.observability import tracing

    assert tracing.current_span() is None and tracing.current_context() is None
    tracing.set_attr("ignored", 1)  # a no-op outside a span
    remote = tracing.SpanContext("t" * 32, "s" * 16)
    with tracing.remote_context(remote):
        assert tracing.current_context() == remote
        with tracing.span("child") as sp:
            assert tracing.current_span() is sp and sp.trace_id == remote.trace_id and sp.parent_id == remote.span_id
            tracing.set_attr("k", "v")
        assert sp.attrs == {"k": "v"}
    with tracing.remote_context(None):
        assert tracing.current_context() is None


def test_gc_trace_dir_and_span_dirs_equal_jax(tmp_path):
    """The same span store pruned by either package: the same report and
    the same survivors; a sibling shard's sink is read with the root's."""
    jtr, ttr = _mod("modal_tpu", "observability.tracing"), _mod("modal_tpu_torch", "observability.tracing")
    now = time.time()
    layout = [("spans-1.jsonl", 3000, now - 10 * 86400), ("spans-2.jsonl.1", 5000, now - 7200),
              ("spans-3.jsonl", 4000, now - 3600), ("spans-4.jsonl", 2000, now - 60), ("other.txt", 10, now - 99999)]
    reports = {}
    for pkg, tr in (("jax", jtr), ("port", ttr)):
        d = tmp_path / pkg / "traces"
        d.mkdir(parents=True)
        for name, size, mtime in layout:
            p = d / name
            p.write_text(json.dumps({"trace_id": "ab", "name": name}) + "\n" + "x" * size)
            os.utime(p, (mtime, mtime))
        shard = tmp_path / pkg / "shard-1" / "traces"
        shard.mkdir(parents=True)
        (shard / "spans-9.jsonl").write_text(json.dumps({"trace_id": "cd", "name": "shard"}) + "\n")
        dirs = [os.path.relpath(x, tmp_path / pkg) for x in tr.span_dirs(str(d))]
        names = sorted(s["name"] for s in tr.read_spans(str(d)))
        report = tr.gc_trace_dir(str(d), max_total_bytes=7000)
        reports[pkg] = (report, sorted(os.listdir(d)), dirs, names)
    assert reports["port"] == reports["jax"]
    assert reports["port"][0]["removed"] == 2 and "spans-4.jsonl" in reports["port"][1]


# -- the sampling profiler -----------------------------------------------------


def test_folded_files_round_trip_and_top_tables_equal_jax(tmp_path):
    jprof, tprof = _mod("modal_tpu", "observability.profiler"), _mod("modal_tpu_torch", "observability.profiler")
    rng = np.random.default_rng(0)
    frames = [f"mod{i}.py:fn{i}" for i in range(8)]
    stacks = {}
    for _ in range(30):
        depth = int(rng.integers(1, 6))
        stacks[";".join(rng.choice(frames, size=depth))] = int(rng.integers(1, 50))
    paths = []
    for i in range(2):
        p = tmp_path / f"profile-{100 + i}-t.folded"
        p.write_text("".join(f"{s} {c}\n" for s, c in stacks.items()) + "torn line without count\n")
        paths.append(str(p))
    assert tprof.read_folded(paths[0]) == jprof.read_folded(paths[0])
    merged = tprof.merge_folded(paths)
    assert merged == jprof.merge_folded(paths) and sum(merged.values()) == 2 * sum(stacks.values())
    assert tprof.top_table(merged, 5) == jprof.top_table(merged, 5)
    assert tprof.list_profiles(str(tmp_path)) == jprof.list_profiles(str(tmp_path)) == sorted(paths)


def test_a_profiler_writes_what_it_sampled(tmp_path):
    from modal_tpu_torch.observability import profiler

    prof = profiler.SamplingProfiler(str(tmp_path), tag="t", hz=200)
    prof.start()
    deadline = time.monotonic() + 10
    while prof.n_samples < 5:
        assert time.monotonic() < deadline
        sum(i * i for i in range(10000))
    path = prof.stop()
    assert path == str(tmp_path / f"profile-{os.getpid()}-t.folded") and not prof.running
    stacks = profiler.read_folded(path)
    assert stacks and sum(stacks.values()) >= 5
    assert any("test_a_profiler_writes_what_it_sampled" in s for s in stacks)


@pytest.mark.parametrize("value", ["", "0", "off", "False", "0.0", "-3", "1", "2", "7.5", "on", "yes", "junk"])
def test_the_env_switch_reads_as_jax_reads_it(monkeypatch, value):
    """`MODAL_TPU_PROFILE`: the same values start the same rate in both
    packages (the start itself stubbed)."""
    monkeypatch.setenv("MODAL_TPU_PROFILE", value)
    monkeypatch.delenv("MODAL_TPU_PROFILE_DIR", raising=False)
    seen = {}
    for pkg in PKGS:
        prof = _mod(pkg, "observability.profiler")
        calls = []
        monkeypatch.setattr(prof, "start", lambda out_dir, tag, hz, calls=calls: calls.append((out_dir, tag, hz)))
        seen[pkg] = (prof.maybe_start_from_env("/d", "tag"), calls)
    assert seen["modal_tpu_torch"] == seen["modal_tpu"]


# -- history queries on bare states ---------------------------------------------


def _history_state(pkg: str, tmp_path):
    """A bare state of each package with a store, an evaluator and two
    replicas' raw heartbeat pushes."""
    api = _mod(pkg, "proto.api_pb2")
    st = _mod(pkg, "server.state")
    metrics, ts = _mod(pkg, "observability.metrics"), _mod(pkg, "observability.timeseries")
    slo = _mod(pkg, "observability.slo")
    state = st.ServerState(str(tmp_path / pkg))
    reg = metrics.MetricsRegistry()
    h = reg.histogram("modal_tpu_serving_ttft_seconds", "ttft", buckets=(0.05, 0.1, 0.5, 1.0, 5.0))
    g = reg.gauge("modal_tpu_serving_tokens_per_second", "tps")
    state.timeseries = ts.TimeSeriesStore(registry=reg, families=["modal_tpu_serving_ttft_seconds",
                                                                  "modal_tpu_serving_tokens_per_second"],
                                          interval_s=1.0)
    state.slo = slo.SLOEvaluator(state.timeseries, rules=[slo.SLORule(
        name="ttft", description="d", family="modal_tpu_serving_ttft_seconds", kind="hist_quantile",
        threshold=0.2, fast_window_s=1e9, slow_window_s=1e9)], alerts=state.alerts)
    fn = st.FunctionState(function_id="fu-1", app_id="ap-1", tag="Svc", definition=api.Function(function_name="Svc"))
    state.functions["fu-1"] = fn
    for i, (ttft, tps) in enumerate(((0.4, 120.0), (0.05, 80.0))):
        task = st.TaskState_(task_id=f"ta-{i}", function_id="fu-1", app_id="ap-1", state=api.TASK_STATE_ACTIVE)
        task.telemetry_prev_json = json.dumps({
            "modal_tpu_serving_ttft_p95_seconds": {"kind": "gauge", "series": {"": ttft}},
            "modal_tpu_serving_tokens_per_second": {"kind": "gauge", "series": {"": tps}},
            "modal_tpu_serving_batch_occupancy": {"kind": "histogram",
                                                 "series": {"": {"counts": [1], "sum": 3.0, "count": 2}}},
            "modal_tpu_device_memory_bytes": {"kind": "gauge", "series": {"0,bytes_in_use": 1e9}},
        })
        state.tasks[task.task_id] = task
    return state, h, g


def test_history_payloads_equal_jax_on_bare_states(tmp_path):
    history = {pkg: _mod(pkg, "server.history") for pkg in PKGS}
    built = {pkg: _history_state(pkg, tmp_path) for pkg in PKGS}
    now = time.time()
    for pkg, (state, h, g) in built.items():
        state.timeseries.sample(now=now - 3)
        for v in (0.03, 0.3, 0.3, 2.0):
            h.observe(v)
        g.set(77.0)
        state.timeseries.sample(now=now - 2)
        state.slo.evaluate(now=now - 2)

    def scrub(x):
        """Drop the wall-clock fields (time, since, age, last_eval_at)."""
        if isinstance(x, dict):
            return {k: scrub(v) for k, v in x.items() if k not in ("time", "since", "age_s", "last_eval_at")}
        if isinstance(x, list):
            return [scrub(v) for v in x]
        return x

    queries = [("describe", "", 0, 0), ("series", "modal_tpu_serving_ttft_seconds", 60, 0),
               ("quantile", "modal_tpu_serving_ttft_seconds", 60, 0.95), ("alerts", "", 0, 0),
               ("top", "", 0, 0), ("snapshot", "", 600, 0), ("nope", "", 0, 0)]
    for query, family, window_s, q in queries:
        got = {pkg: scrub(history[pkg].history_payload(built[pkg][0], query, family, window_s, q)) for pkg in PKGS}
        assert got["modal_tpu_torch"] == got["modal_tpu"], query
    top = history["modal_tpu_torch"].top_payload(built["modal_tpu_torch"][0])
    assert [r["ttft_p95_s"] for r in top["replicas"]] == [0.4, 0.05] and top["fleet"]["ttft_p95_s"] == 5.0
    alerts = history["modal_tpu_torch"].history_payload(built["modal_tpu_torch"][0], "alerts")
    assert alerts["alerts"]["ttft"]["state"] == "firing"
    # no store and no evaluator: the journaled alerts still answer
    for pkg in PKGS:
        state = built[pkg][0]
        state.timeseries, state.slo = None, None
    got = {pkg: scrub(history[pkg].history_payload(built[pkg][0], q)) for pkg in PKGS for q in ("describe",)}
    assert got["modal_tpu_torch"] == got["modal_tpu"]
    assert set(history["modal_tpu_torch"].history_payload(built["modal_tpu_torch"][0], "alerts")["alerts"]) == {"ttft"}


# -- ProfileControl and the heartbeat's command, in memory ---------------------


class _AbortCtx:
    async def abort(self, code, details):
        raise RuntimeError(f"{code.name}: {details}")


def test_profile_control_start_status_stop_and_the_heartbeat_command(tmp_path, monkeypatch):
    from modal_tpu_torch.observability import profiler
    from modal_tpu_torch.proto import api_pb2
    from modal_tpu_torch.server import services, state as tstate

    svc = services.ModalTPUServicer(tstate.ServerState(str(tmp_path)))
    task = tstate.TaskState_(task_id="ta-1", function_id="fu-1", app_id="ap-1", state=api_pb2.TASK_STATE_ACTIVE)
    svc.s.tasks["ta-1"] = task

    def beat():
        return asyncio.run(svc.ContainerHeartbeat(api_pb2.ContainerHeartbeatRequest(task_id="ta-1"), _AbortCtx()))

    def control(action, hz=0.0):
        return asyncio.run(svc.ProfileControl(api_pb2.ProfileControlRequest(action=action, hz=hz), _AbortCtx()))

    try:
        assert beat().profile_command == "" and not control("status").running
        started = control("start", hz=97)
        assert started.running and started.supervisor_profile_path.endswith("-supervisor.folded")
        assert beat().profile_command == "start:97" == svc.s.profile_command
        time.sleep(0.2)
        assert control("status").n_samples > 0
        stopped = control("stop")
        assert not stopped.running and stopped.supervisor_profile_path in stopped.profile_paths
        assert os.path.dirname(stopped.supervisor_profile_path) == str(tmp_path / "observability" / "profiles")
        assert beat().profile_command == "stop"
        # a stop rides the beats for PROFILE_STOP_TTL_S, then expires
        svc.s.profile_command_set_at -= services.PROFILE_STOP_TTL_S + 1
        assert beat().profile_command == "" == svc.s.profile_command
        with pytest.raises(RuntimeError, match="INVALID_ARGUMENT: unknown profile action 'pause'"):
            control("pause")
    finally:
        profiler.stop()


# -- the planes -----------------------------------------------------------------

PLANE_ENV = {**CONTAINER_ENV, "MODAL_TPU_TS_INTERVAL": "0.5"}


@pytest.fixture(scope="module")
def planes():
    saved = {k: os.environ.get(k) for k in PLANE_ENV}
    os.environ.update(PLANE_ENV)
    p = Planes(tempfile.mkdtemp(prefix="mp-", dir="/tmp"))
    try:
        yield p
    finally:
        p.close()
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)


def _http(url: str, accept: str = ""):
    req = urllib.request.Request(url, headers={"Accept": accept} if accept else {})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.headers.get("Content-Type", ""), resp.read().decode()


def test_metrics_and_history_on_the_blob_server(planes):
    """`/metrics` in both formats and `/metrics/history` on each plane's
    blob server; the port's history answers as its MetricsHistory RPC and
    the JAX plane's do."""
    from modal_tpu_torch.proto import api_pb2

    out = {}
    for pkg, sup in (("jax", planes.jsup), ("port", planes.tsup)):
        base = sup.state.blob_url_base
        with open(os.path.join(sup.state.state_dir, "observability", "metrics_url")) as f:
            assert f.read().strip() == base + "/metrics"
        deadline = time.monotonic() + 30
        while sup.state.timeseries.samples_taken < 2:
            assert time.monotonic() < deadline, f"{pkg}: the sampler took no samples"
            time.sleep(0.1)
        ct, prom = _http(base + "/metrics")
        assert ct.startswith("text/plain") and "# TYPE modal_tpu_timeseries_samples_total counter" in prom
        ct, om = _http(base + "/metrics", accept="application/openmetrics-text")
        assert ct.startswith("application/openmetrics-text") and om.endswith("# EOF\n")
        assert _http(base + "/metrics?format=openmetrics")[1].endswith("# EOF\n")
        q = "?query=quantile&family=modal_tpu_rpc_latency_seconds&window_s=3600&q=0.5"
        out[pkg] = json.loads(_http(base + "/metrics/history" + q)[1])
        alerts = json.loads(_http(base + "/metrics/history?query=alerts")[1])
        assert [r["rule"] for r in alerts["rules"]] == ["serving_ttft_p95", "dispatch_p50", "call_error_rate"]
        with pytest.raises(urllib.error.HTTPError) as bad:
            _http(base + "/metrics/history?window_s=x")
        assert bad.value.code == 400 and json.loads(bad.value.read()) == {"error": "window_s/q must be numeric"}
    assert set(out["port"]) == set(out["jax"]) == {"family", "q", "window_s", "value"}
    assert out["port"]["value"] is not None and out["jax"]["value"] is not None
    rpc = planes.tclient.stub.MetricsHistory
    from modal_tpu_torch._utils.async_utils import synchronizer

    resp = synchronizer.run(rpc(api_pb2.MetricsHistoryRequest(query="describe")))
    payload = json.loads(resp.payload_json)
    assert payload["interval_s"] == 0.5 and [t["interval_s"] for t in payload["tiers"]] == [0.5, 3.0, 30.0]
    assert "modal_tpu_rpc_latency_seconds" in payload["families"]


def test_task_timelines_match_on_both_planes(planes):
    def scenario(m, client, sup):
        app = m.App(f"timeline-{m.__name__}")

        def double(x):
            return 2 * x

        f = app.function(serialized=True)(double)
        with app.run(client=client):
            fc = f.spawn(21)
            assert fc.get(timeout=60) == 42
            tl = fc.get_timeline()
        return tl

    got = planes.both(scenario)
    for name, tl in got.items():
        assert len(tl.tasks) == 1, name
        t = tl.tasks[0]
        assert 0 < t.created_at <= t.started_at <= t.first_input_at <= t.first_output_at, (name, t)
        assert 0 < tl.call_created_at <= tl.call_first_output_at, name
    fields = {name: sorted(f.name for f, _ in tl.tasks[0].ListFields()) for name, tl in got.items()}
    assert fields["port"] == fields["jax"]


def test_profile_control_reaches_a_live_container(planes):
    """ProfileControl("start") on the port's plane: the plane's process
    samples, and a container that beats while it runs applies the command
    and writes its own folded file; "stop" ends both."""
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.observability import profiler
    from modal_tpu_torch.proto import api_pb2

    stub = planes.tclient.stub
    profiles = os.path.join(planes.tsup.state.state_dir, "observability", "profiles")
    app = modal_tpu_torch.App("profiled")

    def busy(seconds):
        import time as _t

        end = _t.monotonic() + seconds
        n = 0
        while _t.monotonic() < end:
            n += sum(i * i for i in range(2000))
        return n > 0

    f = app.function(serialized=True)(busy)
    try:
        with app.run(client=planes.tclient):
            started = synchronizer.run(stub.ProfileControl(api_pb2.ProfileControlRequest(action="start")))
            assert started.running
            assert f.remote(4.0) is True
            tasks = [t.task_id for t in planes.tsup.state.tasks.values() if t.app_id == app.app_id]
            stopped = synchronizer.run(stub.ProfileControl(api_pb2.ProfileControlRequest(action="stop")))
    finally:
        profiler.stop()
    assert not stopped.running and stopped.n_samples > 0
    container_files = [p for p in stopped.profile_paths if any(p.endswith(f"-{t}.folded") for t in tasks)]
    assert container_files and all(os.path.dirname(p) == profiles for p in container_files), stopped.profile_paths
    stacks = profiler.merge_folded(container_files)
    assert any(":busy" in s for s in stacks), list(stacks)[:5]


def test_runtime_debug_writes_a_trace_that_app_list_profiles_lists(planes):
    """A `runtime_debug=True` function on the port's plane, on the CPU: its
    input runs under torch.profiler, the Chrome trace lands in the task's
    dir, and AppListProfiles counts it (`*.pt.trace.json`)."""
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.proto import api_pb2

    app = modal_tpu_torch.App("debugged")

    def matmul(n):
        import torch

        x = torch.ones(n, n)
        return float((x @ x).sum())

    f = app.function(serialized=True, runtime_debug=True)(matmul)
    with app.run(client=planes.tclient):
        assert f.remote(8) == 512.0
        assert f.remote(4) == 64.0
        listed = synchronizer.run(planes.tclient.stub.AppListProfiles(
            api_pb2.AppListProfilesRequest(app_id=app.app_id))).profiles
    assert len(listed) == 1 and listed[0].num_traces == 2 and listed[0].size_bytes > 0, listed
    traces = sorted(n for n in os.listdir(listed[0].path) if n.endswith(".pt.trace.json"))
    assert len(traces) == 2
    with open(os.path.join(listed[0].path, traces[0])) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# -- an SLO alert across crash_restart, on both planes ------------------------------

SLO_ENV = {"MODAL_TPU_HEARTBEAT_INTERVAL": "3", "MODAL_TPU_TS_INTERVAL": "0.2",
           "MODAL_TPU_SLO_FAST_WINDOW_S": "1.5", "MODAL_TPU_SLO_SLOW_WINDOW_S": "3",
           "MODAL_TPU_SLO_TTFT_P95_S": "0.1"}


def test_a_firing_alert_survives_crash_restart_on_both_planes(monkeypatch):
    """TTFT observations over the objective fire `serving_ttft_p95` on each
    plane; the transition is journaled; after crash_restart the rebuilt
    evaluator holds the alert firing through silence and resolves it only
    on post-restart samples under the objective."""
    from tests.test_torch_recovery import _Side

    for k, v in SLO_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MODAL_TPU_JOURNAL", raising=False)
    ttft = {"jax": _mod("modal_tpu", "observability.catalog").SERVING_TTFT,
            "port": _mod("modal_tpu_torch", "observability.catalog").SERVING_TTFT}
    sides = {}

    def wait_state(side, want, feed=None, timeout=30.0):
        deadline = time.monotonic() + timeout
        while side.sup.state.alerts.get("serving_ttft_p95", {}).get("state") != want:
            assert time.monotonic() < deadline, (side.name, want, side.sup.state.alerts)
            if feed is not None:
                ttft[side.name].observe(feed)
            time.sleep(0.05)

    try:
        for name in ("jax", "port"):
            sides[name] = _Side(name)
        out = {}
        for name, side in sides.items():
            wait_state(side, "firing", feed=2.0)
            # the replay, not the old state, rebuilds the alert
            report = side.crash_restart()
            alert = side.sup.state.alerts["serving_ttft_p95"]
            assert side.sup.state.slo.alerts is side.sup.state.alerts, name
            time.sleep(1.0)  # five sampler ticks of silence: still firing
            held = side.sup.state.alerts["serving_ttft_p95"]["state"]
            wait_state(side, "resolved", feed=0.01)
            out[name] = (report["records_skipped"], alert["state"], alert["rule"], held)
        assert out["port"] == out["jax"] == (0, "firing", "serving_ttft_p95", "firing")
    finally:
        for side in sides.values():
            side.close()
