"""Fleet federation (observability/federation.py) in both packages.

The JAX package's tests/test_federation.py, each unit case run against the
JAX modules and the port's (`pk`): the merged-series math, the
shared-registry mode, labeled partial answers, the fleet SLO that fires
when no single shard crosses its threshold, the fleet alert journal across
a restart, the span readers and `trace gc` over every shard's sink, and the
stale-breadcrumb error that names the shard topology. Then the same shard
payloads merge into the same counters, histograms and gauges in both. Then
the port's fleet: the federation and flight recorder off switches, the
breadcrumb layout, the federated history endpoint with `top --once`, the
director.route span stitched across the forward, and (slow, as in the JAX
package) a three-process fleet with a shard killed mid-query and its
debug bundle. The flight recorder's own cases are in
tests/test_torch_flight_recorder.py.
"""

from __future__ import annotations

import importlib
import json
import os
import tempfile
import time
import types

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("modal_tpu", "modal_tpu_torch")


def _ns(pkg: str) -> types.SimpleNamespace:
    fed = importlib.import_module(f"{pkg}.observability.federation")
    slo = importlib.import_module(f"{pkg}.observability.slo")
    return types.SimpleNamespace(
        MergedSnapshot=fed.MergedSnapshot,
        FederatedHistory=fed.FederatedHistory,
        SLOEvaluator=slo.SLOEvaluator,
        SLORule=slo.SLORule,
        synchronizer=importlib.import_module(f"{pkg}._utils.async_utils").synchronizer,
        FEDERATION_PARTIAL_ANSWERS=importlib.import_module(f"{pkg}.observability.catalog").FEDERATION_PARTIAL_ANSWERS,
        tracing=importlib.import_module(f"{pkg}.observability.tracing"),
        cli_root=importlib.import_module(f"{pkg}.cli.entry_point").cli,
    )


@pytest.fixture(params=PACKAGES, ids=["jax", "port"])
def pk(request):
    return _ns(request.param)


TTFT_FAMILY = "modal_tpu_serving_ttft_seconds"
TTFT_BOUNDS = [0.5, 1.0, 2.5, 5.0, 10.0]


def _hist_point(t: float, by_bucket: dict[int, int], value_s: float) -> list:
    """One wire-shaped histogram delta point: [t, [d_counts], d_sum, d_count]."""
    counts = [0] * len(TTFT_BOUNDS)
    total = 0
    sum_ = 0.0
    for bucket, n in by_bucket.items():
        counts[bucket] += n
        total += n
        sum_ += n * value_s
    return [t, counts, sum_, total]


def _ttft_snapshot(points: list[list], extra_families: dict | None = None) -> dict:
    families = {
        TTFT_FAMILY: {
            "family": TTFT_FAMILY,
            "kind": "histogram",
            "bounds": TTFT_BOUNDS,
            "series": {"": points},
        }
    }
    families.update(extra_families or {})
    return {"time": time.time(), "families": families, "replicas": [], "alerts": {}}


def _ttft_rule(pk):
    return pk.SLORule(
        name="serving_ttft_p95",
        description="serving p95 TTFT",
        family=TTFT_FAMILY,
        kind="hist_quantile",
        q=0.95,
        threshold=2.5,
        fast_window_s=60.0,
        slow_window_s=600.0,
    )


# -- merged-series math ----------------------------------------------------


def test_merged_counter_histogram_gauge_math(pk):

    now = time.time()
    counter_fam = "modal_tpu_task_results_total"
    gauge_fam = "modal_tpu_scheduler_queue_depth"

    def snap(counter_deltas, gauge_last, slow_obs):
        return {
            "families": {
                counter_fam: {
                    "kind": "counter",
                    "series": {'status="SUCCESS"': [[now - 10, d] for d in counter_deltas]},
                },
                gauge_fam: {
                    "kind": "gauge",
                    "series": {"": [[now - 5, gauge_last, gauge_last, gauge_last]]},
                },
                TTFT_FAMILY: {
                    "kind": "histogram",
                    "bounds": TTFT_BOUNDS,
                    "series": {"": [_hist_point(now - 10, {3: slow_obs, 0: 100}, 4.0)]},
                },
            }
        }

    merged = pk.MergedSnapshot({0: snap([3.0, 2.0], 4.0, 10), 1: snap([5.0], 7.0, 30)})
    # delta counters merge by summation across shard-namespaced series
    assert merged.counter_sum(counter_fam, 60.0, now) == pytest.approx(10.0)
    assert merged.counter_rate(counter_fam, 60.0, now) == pytest.approx(10.0 / 60.0)
    # gauges stay per-shard series; gauge_stats sums `last` (fleet queue depth)
    stats = merged.gauge_stats(gauge_fam, 60.0, now)
    assert stats["last"] == pytest.approx(11.0) and stats["series"] == 2
    # histogram buckets merge before the quantile: 40/240 slow observations
    # puts the fleet p95 in the (2.5, 5] bucket
    q = merged.hist_quantile(TTFT_FAMILY, 0.95, 60.0, now)
    assert q is not None and q > 2.5
    # series keys are shard-namespaced so nothing collides
    keys = set(merged.window_points(counter_fam, 60.0, now))
    assert keys == {'shard0|status="SUCCESS"', 'shard1|status="SUCCESS"'}
    desc = merged.describe()
    assert desc["federated"] is True and desc["shards"] == [0, 1]


def test_shared_registry_mode_counts_series_once(pk):

    now = time.time()
    fam = "modal_tpu_task_results_total"
    snap = {
        "families": {fam: {"kind": "counter", "series": {"": [[now - 1, 6.0]]}}},
        "replicas": [{"task_id": "ta-1"}],
    }
    # in-process fleets share one registry: every shard's store holds the
    # same series, so only one shard may contribute SERIES to the merge
    merged = pk.MergedSnapshot({0: snap, 1: snap, 2: snap}, series_shards={0})
    assert merged.counter_sum(fam, 60.0, now) == pytest.approx(6.0)
    # replicas still merge from every shard (they are per-shard rows)
    assert len(merged.replica_rows()) == 3


# -- partial answers -------------------------------------------------------


def _fed(pk, tmp_path, snaps_by_shard, topology=None, **kwargs):

    topo = topology or [{"index": i, "url": f"u{i}", "dead": False} for i in snaps_by_shard]

    async def fetch(shard, query, window_s):
        idx = int(shard["index"])
        snap = snaps_by_shard[idx]
        if isinstance(snap, Exception):
            raise snap
        return snap

    return pk.FederatedHistory(
        str(tmp_path), topology=lambda: topo, fetch=fetch, **kwargs
    )


def test_partial_answer_is_labeled_and_counted(pk, tmp_path):

    now = time.time()
    good = _ttft_snapshot([_hist_point(now - 5, {0: 10}, 0.1)])
    fed = _fed(
        pk,
        tmp_path,
        {0: good, 1: RuntimeError("shard unreachable"), 2: good},
        topology=[
            {"index": 0, "url": "u0", "dead": False},
            {"index": 1, "url": "u1", "dead": False},
            {"index": 2, "url": "u2", "dead": False},
            {"index": 3, "url": "", "dead": True},
        ],
    )
    before = pk.FEDERATION_PARTIAL_ANSWERS.value()
    payload = pk.synchronizer.run(fed.payload("top"))
    meta = payload["federation"]
    assert meta["partial"] is True
    assert meta["missing"] == [1] and meta["dead"] == [3]
    assert meta["shards"] == [0, 2]
    states = {r["shard"]: r["state"] for r in payload["shards"]}
    assert states == {0: "live", 1: "missing", 2: "live", 3: "dead"}
    assert pk.FEDERATION_PARTIAL_ANSWERS.value() == before + 1
    # merged math runs over the shards that DID answer — the answer degrades
    # to an explicit partial, never a silent truncation or an error
    assert payload["store"]["shards"] == [0, 2]

    # all shards answering -> not partial, counter untouched
    fed_ok = _fed(pk, tmp_path, {0: good, 1: good})
    payload = pk.synchronizer.run(fed_ok.payload("describe"))
    assert payload["federation"]["partial"] is False
    assert pk.FEDERATION_PARTIAL_ANSWERS.value() == before + 1


# -- fleet-scope SLO -------------------------------------------------------


def test_fleet_alert_fires_when_no_single_shard_crosses(pk, tmp_path):
    """The acceptance construction: violation spread across time AND shards.
    Shard A's slow observations are all old (fast window empty -> its own
    evaluator can never fire). Shard B has a few recent slow observations
    (fast burn >= 1) but its own slow window is diluted by hundreds of fast
    ones (slow burn < 1). Only the MERGED series burns both windows."""

    now = time.time()
    # shard A: 50 slow (4s) observations, 100..300s ago — old, sustained
    snap_a = _ttft_snapshot(
        [_hist_point(now - 100 - i * 4, {3: 1}, 4.0) for i in range(50)]
    )
    # shard B: 10 slow observations in the last minute, 500 fast (0.1s) ones
    # spread over its slow window
    snap_b = _ttft_snapshot(
        [_hist_point(now - 5 - i * 5, {3: 1}, 4.0) for i in range(10)]
        + [_hist_point(now - 70 - i, {0: 2}, 0.1) for i in range(250)]
    )

    # neither shard alone fires
    for snap in (snap_a, snap_b):
        solo = pk.SLOEvaluator(store=pk.MergedSnapshot({0: snap}), rules=[_ttft_rule(pk)], alerts={})
        assert solo.evaluate(now=now) == [], "a single shard fired on its own"

    # sanity on the construction itself
    a_only = pk.MergedSnapshot({0: snap_a})
    assert a_only.hist_quantile(TTFT_FAMILY, 0.95, 60.0, now) is None  # empty fast window
    b_only = pk.MergedSnapshot({1: snap_b})
    assert b_only.hist_quantile(TTFT_FAMILY, 0.95, 600.0, now) < 2.5  # diluted slow window

    fed = _fed(pk, tmp_path, {0: snap_a, 1: snap_b}, rules=[_ttft_rule(pk)])
    transitions = pk.synchronizer.run(fed.evaluate_fleet())
    assert [(t["rule"], t["state"]) for t in transitions] == [("serving_ttft_p95", "firing")]
    assert fed.alerts["serving_ttft_p95"]["state"] == "firing"

    # the alerts query surfaces the fleet alert + namespaced per-shard alerts
    payload = pk.synchronizer.run(fed.payload("alerts"))
    assert payload["alerts"]["serving_ttft_p95"]["state"] == "firing"
    assert payload["federation"]["partial"] is False


def test_fleet_alert_journal_survives_restart(pk, tmp_path):
    """Transitions are journaled to observability/fleet_alerts.jsonl and
    replayed at construction — a firing fleet alert survives the director
    restarting or a takeover re-homing the director role."""

    now = time.time()
    snap_a = _ttft_snapshot(
        [_hist_point(now - 100 - i * 4, {3: 1}, 4.0) for i in range(50)]
    )
    snap_b = _ttft_snapshot([_hist_point(now - 5 - i * 5, {3: 1}, 4.0) for i in range(10)])
    fed = _fed(pk, tmp_path, {0: snap_a, 1: snap_b}, rules=[_ttft_rule(pk)])
    (tr,) = pk.synchronizer.run(fed.evaluate_fleet())
    assert tr["state"] == "firing"
    journal_path = os.path.join(str(tmp_path), "observability", "fleet_alerts.jsonl")
    assert os.path.exists(journal_path)

    # a FRESH federation (director restarted) adopts the journaled state; an
    # empty store cannot resolve it — silence is not recovery
    reborn = pk.FederatedHistory(
        str(tmp_path), topology=lambda: [], fetch=None, rules=[_ttft_rule(pk)]
    )
    assert reborn.alerts["serving_ttft_p95"]["state"] == "firing"
    assert reborn.evaluator.alerts is reborn.alerts
    payload = pk.synchronizer.run(reborn.payload("alerts"))
    assert payload["alerts"]["serving_ttft_p95"]["state"] == "firing"


# -- trace readers + gc across shard span sinks ----------------------------


def test_span_dirs_and_read_spans_merge_shard_sinks(pk, tmp_path):

    root = tmp_path / "state"
    director_dir = root / "traces"
    shard_dir = root / "shard-0" / "traces"
    for d, name in ((director_dir, "director.route"), (shard_dir, "rpc.server.Foo")):
        os.makedirs(d)
        with open(d / "spans-1.jsonl", "w") as f:
            f.write(json.dumps({"trace_id": "t" * 32, "span_id": "s" * 16,
                                "name": name, "start": 1.0, "end": 2.0}) + "\n")
    dirs = pk.tracing.span_dirs(str(director_dir))
    assert [os.path.relpath(d, root) for d in dirs] == ["traces", "shard-0/traces"]
    names = {s["name"] for s in pk.tracing.read_spans(str(director_dir))}
    assert names == {"director.route", "rpc.server.Foo"}


def test_trace_gc_cli_prunes_every_shard_sink(pk, tmp_path):
    from click.testing import CliRunner


    root = tmp_path / "state"
    old = time.time() - 30 * 24 * 3600
    for d in (root / "traces", root / "shard-0" / "traces", root / "shard-1" / "traces"):
        os.makedirs(d)
        stale = d / "spans-old.jsonl"
        stale.write_text("{}\n")
        os.utime(stale, (old, old))
        fresh = d / "spans-new.jsonl"
        fresh.write_text("{}\n")
    result = CliRunner().invoke(
        pk.cli_root,
        ["trace", "gc", "--state-dir", str(root), "--max-age-hours", "1"],
    )
    assert result.exit_code == 0, result.output
    assert "3 span dir(s)" in result.output
    for d in (root / "traces", root / "shard-0" / "traces", root / "shard-1" / "traces"):
        assert not (d / "spans-old.jsonl").exists(), f"stale file survived in {d}"
        assert (d / "spans-new.jsonl").exists(), f"fresh file pruned in {d}"


# -- stale breadcrumb names the shard topology -----------------------------


def test_stale_breadcrumb_error_names_shard_topology(pk, tmp_path):
    from click.testing import CliRunner


    root = tmp_path / "state"
    os.makedirs(root / "observability")
    # a breadcrumb pointing at a port nothing listens on
    (root / "observability" / "metrics_url").write_text("http://127.0.0.1:9/metrics\n")
    with open(root / "shards.json", "w") as f:
        json.dump(
            {
                "shards": [
                    {"index": 0, "url": "grpc://127.0.0.1:7001", "dead": False},
                    {"index": 1, "url": "grpc://127.0.0.1:7002", "dead": True},
                ]
            },
            f,
        )
    result = CliRunner().invoke(pk.cli_root, ["alerts", "--state-dir", str(root)])
    assert result.exit_code != 0
    assert "sharded fleet root (2 shards" in result.output
    assert "shard 1 grpc://127.0.0.1:7002 [dead]" in result.output
    assert "observability/shards" in result.output


# -- the same shard payloads merge the same in both packages -----------------


def _seeded_snapshots(seed: int, now: float) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    snaps = {}
    for shard in range(3):
        fams = {
            "modal_tpu_task_results_total": {
                "kind": "counter",
                "series": {f'status="{s}"': [[now - float(rng.uniform(1, 900)), float(rng.integers(0, 9))]
                                               for _ in range(int(rng.integers(1, 30)))]
                           for s in ("SUCCESS", "FAILURE")},
            },
            "modal_tpu_scheduler_queue_depth": {
                "kind": "gauge",
                "series": {"": [[now - float(t), float(v), float(v) - 1, float(v) + 2]
                                for t, v in sorted(zip(rng.uniform(1, 900, 20), rng.integers(0, 40, 20)),
                                                   reverse=True)]},
            },
            TTFT_FAMILY: {
                "kind": "histogram",
                "bounds": TTFT_BOUNDS,
                "series": {"": [_hist_point(now - float(rng.uniform(1, 900)),
                                            {int(rng.integers(0, 5)): int(rng.integers(1, 20))},
                                            float(rng.uniform(0.05, 9.0))) for _ in range(40)]},
            },
        }
        snaps[shard] = {"time": now, "families": fams, "replicas": [{"task_id": f"ta-{shard}"}], "alerts": {}}
    return snaps


@pytest.mark.parametrize("shared", [False, True])
def test_the_same_shard_payloads_merge_the_same(shared, tmp_path):
    now = 1_800_000_000.0
    out = {}
    for pkg in PACKAGES:
        ns = _ns(pkg)
        snaps = _seeded_snapshots(11, now)
        merged = ns.MergedSnapshot(snaps, series_shards={0} if shared else None)
        row = {"describe": merged.describe(), "replicas": merged.replica_rows()}
        for w in (60.0, 300.0, 900.0):
            row[w] = (
                merged.counter_sum("modal_tpu_task_results_total", w, now),
                merged.counter_rate("modal_tpu_task_results_total", w, now, label_filter="SUCCESS"),
                merged.gauge_stats("modal_tpu_scheduler_queue_depth", w, now),
                [merged.hist_quantile(TTFT_FAMILY, q, w, now) for q in (0.5, 0.95, 0.99)],
                merged.hist_stats(TTFT_FAMILY, w, now),
                merged.series_payload(TTFT_FAMILY, w, now),
            )
        fed = ns.FederatedHistory(str(tmp_path / pkg), topology=lambda: [{"index": i} for i in range(3)],
                                  fetch=_fetcher(snaps), shared_registry=shared, clock=lambda: now)
        for query in ("describe", "series", "quantile", "alerts", "snapshot"):
            payload = ns.synchronizer.run(fed.payload(query, family=TTFT_FAMILY, window_s=300.0, q=0.9))
            payload.pop("time", None)  # the evaluator's wall clock, not the federation's
            row[query] = payload
        out[pkg] = row
    assert out["modal_tpu_torch"] == out["modal_tpu"]
    assert out["modal_tpu"][300.0][0] > 0 and out["modal_tpu"][300.0][3][1] is not None


def _fetcher(snaps):
    async def fetch(shard, query, window_s):
        return snaps[int(shard["index"])]

    return fetch


# -- the port's fleet ---------------------------------------------------------


def _boot_fleet(**kw):
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.server.shards import ShardedSupervisor

    root = os.path.join(tempfile.mkdtemp(prefix="fed-", dir="/tmp"), "state")
    kw = {"num_shards": 3, "num_workers": 3, "health_interval_s": 0.2, **kw}
    sup = ShardedSupervisor(state_dir=root, worker_gpus=8, worker_gpu_type="local-sim", **kw)
    synchronizer.run(sup.start())
    return sup


@pytest.fixture
def fleet(monkeypatch):
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.client import _Client

    monkeypatch.setenv("MODAL_TPU_TS_INTERVAL", "0.5")
    sup = _boot_fleet()
    monkeypatch.setenv("MODAL_TPU_SERVER_URL", sup.server_url)
    _Client.set_env_client(None)
    try:
        yield sup
    finally:
        env_client = _Client._client_from_env
        if env_client is not None and not env_client._closed:
            env_client._close()
        _Client.set_env_client(None)
        synchronizer.run(sup.stop())


def test_federation_and_flight_recorder_off_toggles(monkeypatch):
    """MODAL_TPU_FEDERATION=0 and MODAL_TPU_FLIGHT_RECORDER=0 each turn their
    part off: the sharded plane boots with no federation server, no fleet SLO
    loop, no recorder and no root breadcrumb."""
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.observability import federation, flight_recorder

    monkeypatch.setenv("MODAL_TPU_FEDERATION", "0")
    monkeypatch.setenv("MODAL_TPU_FLIGHT_RECORDER", "0")
    assert federation.enabled() is False and flight_recorder.enabled() is False
    sup = _boot_fleet(num_shards=2, num_workers=2, health_interval_s=5.0)
    try:
        assert sup.federation is None and sup.federation_server is None and sup.flight_recorder is None
        assert all(shard.flight_recorder is None for shard in sup.shards)
        assert not os.path.exists(os.path.join(sup.state_dir, "observability", "metrics_url"))
    finally:
        synchronizer.run(sup.stop())
    monkeypatch.setenv("MODAL_TPU_FEDERATION", "1")
    monkeypatch.setenv("MODAL_TPU_FLIGHT_RECORDER", "1")
    assert federation.enabled() is True and flight_recorder.enabled() is True


def test_fleet_breadcrumb_layout(fleet):
    """The director owns the root metrics_url; each shard's endpoint is its
    own breadcrumb under observability/shards/."""
    root = fleet.state_dir
    with open(os.path.join(root, "observability", "metrics_url")) as f:
        root_crumb = f.read().strip()
    assert root_crumb == f"{fleet.federation_server.url}/metrics"
    shard_urls = set()
    for i in range(3):
        with open(os.path.join(root, "observability", "shards", f"shard-{i}")) as f:
            url = f.read().strip()
        assert url.endswith("/metrics") and url != root_crumb
        shard_urls.add(url)
    assert len(shard_urls) == 3


def test_a_monolith_in_a_dir_named_like_a_shard_writes_no_fleet_breadcrumb(tmp_path):
    """A shard's breadcrumb goes under the fleet root its supervisor was
    given, never under a parent that the state dir's name suggests: a
    monolith in `<dir>/shard-0` writes its metrics_url and nothing above."""
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.server.supervisor import LocalSupervisor

    sup = LocalSupervisor(num_workers=1, state_dir=str(tmp_path / "shard-0"), worker_gpus=1,
                          worker_gpu_type="local-sim")
    synchronizer.run(sup.start())
    try:
        assert sup.fleet_root is None and sup.blob_server._fleet_shard_breadcrumb() is None
        assert os.path.exists(tmp_path / "shard-0" / "observability" / "metrics_url")
        assert not os.path.exists(tmp_path / "observability")
    finally:
        synchronizer.run(sup.stop())


def test_federated_history_endpoint_and_top_cli(fleet):
    import urllib.request

    from click.testing import CliRunner

    from modal_tpu_torch.cli.entry_point import cli as cli_root

    time.sleep(1.5)  # each shard's sampler ticks at least once
    url = f"{fleet.federation_server.url}/metrics/history?query=top"
    payload = json.loads(urllib.request.urlopen(url, timeout=10).read())
    meta = payload["federation"]
    assert meta["partial"] is False and meta["shards"] == [0, 1, 2] and meta["mode"] == "shared-registry"
    assert {r["shard"] for r in payload["shards"]} == {0, 1, 2}
    assert all(r["state"] == "live" for r in payload["shards"])
    result = CliRunner().invoke(cli_root, ["top", "--once", "--state-dir", fleet.state_dir])
    assert result.exit_code == 0, result.output
    assert "fleet-merged (3 shards)" in result.output and "PARTIAL" not in result.output
    # the MetricsHistory RPC answers federated too: the router sends it to
    # the director, which merges
    result = CliRunner().invoke(cli_root, ["alerts", "--state-dir", fleet.state_dir, "--json"])
    assert result.exit_code == 0, result.output
    assert "federation" in json.loads(result.output)


def test_director_route_span_stitches_across_forward(fleet):
    """A traced call through the director is one trace: the director's
    rpc.server span, its director.route child, and the shard's rpc.server
    span under the route."""
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch._utils.grpc_utils import create_channel
    from modal_tpu_torch.observability import tracing
    from modal_tpu_torch.proto import api_pb2
    from modal_tpu_torch.proto.rpc import ModalTPUStub

    async def traced_create():
        channel = create_channel(fleet.server_url)
        try:
            stub = ModalTPUStub(channel)
            with tracing.span("test.root") as root:
                await stub.AppCreate(api_pb2.AppCreateRequest(description="fed-stitch"), timeout=10)
                return root.context.trace_id
        finally:
            await channel.close()

    trace_id = synchronizer.run(traced_create())
    spans = [s for s in tracing.read_spans(os.path.join(fleet.state_dir, "traces")) if s["trace_id"] == trace_id]
    by_name: dict = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    (route,) = by_name["director.route"]
    assert route["attrs"]["rpc"] == "AppCreate"
    server_spans = by_name.get("rpc.server.AppCreate") or []
    assert route["parent_id"] in {s["span_id"] for s in server_spans}
    assert any(s["parent_id"] == route["span_id"] for s in server_spans)


def test_untraced_calls_open_no_route_span(fleet):
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch._utils.grpc_utils import create_channel
    from modal_tpu_torch.observability import tracing
    from modal_tpu_torch.proto import api_pb2
    from modal_tpu_torch.proto.rpc import ModalTPUStub

    async def untraced_create():
        channel = create_channel(fleet.server_url)
        try:
            await ModalTPUStub(channel).AppCreate(api_pb2.AppCreateRequest(description="no-trace"), timeout=10)
        finally:
            await channel.close()

    synchronizer.run(untraced_create())
    routes = [s for s in tracing.read_spans(os.path.join(fleet.state_dir, "traces")) if s["name"] == "director.route"]
    assert not [s for s in routes if s["attrs"].get("rpc") == "AppCreate"]


@pytest.mark.slow
def test_subprocess_fleet_federation_kill_and_debug_bundle(tmp_path, monkeypatch):
    """A fleet of three shard processes: the federated top merges three
    registries, a kill mid-query is a labeled partial, the takeover dumps a
    postmortem, and `debug bundle` renders its phases."""
    import urllib.request

    from click.testing import CliRunner

    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.cli.entry_point import cli as cli_root
    from modal_tpu_torch.server.shards import ShardedSupervisor

    root = str(tmp_path / "state")
    monkeypatch.setenv("MODAL_TPU_WORKER_GPU_TYPE", "local-sim")
    monkeypatch.setenv("MODAL_TPU_WORKER_NUM_GPUS", "1")
    monkeypatch.setenv("PYTHONPATH", REPO_ROOT)
    sup = ShardedSupervisor(num_shards=3, num_workers=3, state_dir=root, subprocess_shards=True,
                            health_interval_s=0.3)
    synchronizer.run(sup.start())
    try:
        crumbs = [os.path.join(root, "observability", "shards", f"shard-{i}") for i in range(3)]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not all(os.path.exists(c) for c in crumbs):
            time.sleep(0.25)
        assert all(os.path.exists(c) for c in crumbs)
        time.sleep(2.0)

        def top():
            url = f"{sup.federation_server.url}/metrics/history?query=top"
            return json.loads(urllib.request.urlopen(url, timeout=10).read())

        meta = top()["federation"]
        assert meta["mode"] == "fanout" and meta["shards"] == [0, 1, 2] and not meta["partial"]
        synchronizer.run(sup.kill_shard(1))
        payload = top()
        assert payload["federation"]["partial"] is True
        states = {r["shard"]: r["state"] for r in payload["shards"]}
        assert states[1] in ("missing", "dead") and states[0] == states[2] == "live"
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not sup.takeover_log:
            time.sleep(0.25)
        assert set(sup.takeover_log[0]["phases"]) >= {"start", "fence", "adopt", "remap", "rehome"}
        out_path = str(tmp_path / "bundle.json")
        result = CliRunner().invoke(cli_root, ["debug", "bundle", "--state-dir", root, "--out", out_path])
        assert result.exit_code == 0, result.output
        for phase in ("fence", "adopt", "remap", "rehome"):
            assert phase in result.output
        assert "postmortem takeover" in result.output
        with open(out_path) as f:
            bundle = json.load(f)
        assert bundle["takeovers"] and bundle["postmortems"]
        assert any(e["source"] == "director" for e in bundle["timeline"])
    finally:
        synchronizer.run(sup.stop())
