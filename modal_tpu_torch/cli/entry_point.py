"""The command line of modal_tpu_torch: `python -m modal_tpu_torch.cli`
(port of modal_tpu/cli/entry_point.py; reference py/modal/cli/entry_point.py
— run/deploy/serve, app/volume/secret/dict/queue/config management).

The command tree, option names, exit codes and output formats are the JAX
package's. Where the port differs:

- `shell`, `launch python` and `launch jupyter` take `--gpu` (a card, e.g.
  H100) where the JAX package takes `--tpu`; `--tpu` is refused with the
  message a `tpu=` decorator argument gets.
- `container list` shows a task's cards (`cards=[...]`) where the JAX
  package shows its TPU chips.
- `lint` keeps its options and refuses: the static analysis (`analysis/`)
  waits for its sub-slice (ROADMAP Queue A).
- `journal compact` of a sharded root installs each shard's fresh snapshot
  in its siblings' replica streams under the journal's own snapshot name
  (`snapshot-<seq:012d>.jsonl`); the JAX command names the file without the
  zero padding and so replicates nothing (ROADMAP Queue C 44).

A command that does not touch a card (`app list`, `volume ls`, `metrics`,
`top --once`, `debug bundle`, `journal status`, ...) never imports torch:
every command imports what it needs when it runs.
"""

from __future__ import annotations

import asyncio
import datetime
import inspect
import json
import os
import sys
import time
from typing import Optional

import click

from .._utils.async_utils import synchronizer
from ..config import _store_user_config, config, config_set_active_profile, config_profiles
from ..exception import Error


@click.group()
@click.version_option("0.1.0", prog_name="modal-tpu-torch")
def cli() -> None:
    """modal_tpu_torch: serverless on NVIDIA cards — run, deploy, and manage apps."""


def _refuse_tpu(ctx: click.Context, param: click.Parameter, value: Optional[str]) -> None:
    """`--tpu` is refused as a `tpu=` decorator argument is (app.py)."""
    if value:
        from ..app import TPU_REFUSAL

        raise click.UsageError(TPU_REFUSAL, ctx=ctx)


_refuse_tpu_option = click.option(
    "--tpu", default=None, hidden=True, expose_value=False, callback=_refuse_tpu, help="Refused: use --gpu."
)


# ---------------------------------------------------------------------------
# run / deploy / serve / server
# ---------------------------------------------------------------------------


@cli.command(context_settings=dict(ignore_unknown_options=True, allow_extra_args=True))
@click.argument("ref")
@click.option("--detach", is_flag=True, help="Keep the app running after the client exits.")
@click.option("--env", default=None, help="Environment name.")
@click.pass_context
def run(ctx: click.Context, ref: str, detach: bool, env: Optional[str]) -> None:
    """Run a function or local entrypoint: python -m modal_tpu_torch.cli run file.py::main [args...]

    Extra arguments are passed to the entrypoint (strings; ints parsed when
    the parameter annotation says so). With MODAL_TPU_TRACE_DIR set (a
    plane's `<state_dir>/traces`), the client's spans go there, so the
    plane's `app trace` and `app attribute` see each call's root span.
    """
    from .._output import enable_output
    from ..app import _LocalEntrypoint
    from ..observability import tracing
    from .import_refs import import_and_filter, parse_import_ref, pick_runnable_for_run

    tracing.maybe_configure_from_env()
    runnable = import_and_filter(parse_import_ref(ref))
    target = pick_runnable_for_run(runnable)
    args = _parse_entrypoint_args(target, ctx.args)

    with enable_output(), _AppRunBlocking(runnable.app, detach=detach, environment_name=env):
        if isinstance(target, _LocalEntrypoint):
            target(*args)
        else:
            result = target.remote(*args)  # type: ignore[union-attr]
            if result is not None:
                click.echo(repr(result))


class _AppRunBlocking:
    """Blocking app-run context with live log streaming."""

    def __init__(self, app, **kwargs):
        from ..runner import _AppRun

        self._run = _AppRun(app, **kwargs)
        self._log_task = None

    def __enter__(self):
        import asyncio

        from .._logs import stream_app_logs

        app = synchronizer.run(self._run.__aenter__())

        async def _start_logs():
            return asyncio.ensure_future(stream_app_logs(app._client, app.app_id))

        self._log_task = synchronizer.run(_start_logs())
        return app

    def __exit__(self, *exc):
        import time

        time.sleep(0.3)  # let trailing logs arrive
        if self._log_task is not None:

            async def _stop(t):
                t.cancel()

            synchronizer.run(_stop(self._log_task))
        return synchronizer.run(self._run.__aexit__(*exc))


def _parse_entrypoint_args(target, raw_args: list[str]) -> list:
    fn = None
    if hasattr(target, "raw_f"):
        fn = target.raw_f
    elif hasattr(target, "info") and target.info is not None:
        fn = target.info.raw_f
    if fn is None:
        return raw_args
    sig = inspect.signature(fn)
    parsed = []
    for value, (name, param) in zip(raw_args, sig.parameters.items()):
        ann = param.annotation
        if ann in (int, float):
            parsed.append(ann(value))
        else:
            parsed.append(value)
    return parsed


@cli.command()
@click.argument("ref")
@click.option("--name", default=None, help="Deployment name (defaults to app name).")
@click.option("--env", default=None, help="Environment name.")
@click.option("--tag", default="", help="Deployment tag.")
def deploy(ref: str, name: Optional[str], env: Optional[str], tag: str) -> None:
    """Deploy an app durably: python -m modal_tpu_torch.cli deploy file.py"""
    from ..runner import deploy_app
    from .._output import enable_output
    from .import_refs import import_and_filter, parse_import_ref

    runnable = import_and_filter(parse_import_ref(ref))
    with enable_output():
        url = deploy_app(runnable.app, name=name, environment_name=env, tag=tag)
    click.echo(f"deployed: {url}")


@cli.command()
@click.option("--cmd", "-c", "command", default=None, help="Run one command instead of an interactive shell.")
@click.option("--gpu", default=None, help="Card for the shell sandbox, e.g. H100.")
@_refuse_tpu_option
@click.option("--no-pty", is_flag=True, help="Force the line-based fallback even on a tty.")
def shell(command: Optional[str], gpu: Optional[str], no_pty: bool) -> None:
    """Open a shell (or run one command) in a fresh sandbox (reference
    cli/shell.py). On a real terminal this is a full PTY session (raw-mode
    passthrough, window-size forwarding); piped stdin falls back to a
    line-based loop."""
    from ..sandbox import Sandbox

    def run_and_echo(sb, line: str) -> int:
        p = sb.exec("sh", "-c", line)
        rc = p.wait()
        out = p.stdout.read()
        err = p.stderr.read()
        if out:
            sys.stdout.write(out)
            sys.stdout.flush()
        if err:
            sys.stderr.write(err)
            sys.stderr.flush()
        return rc

    # timeout matches the keep-alive sleep: the default 600s would kill an
    # interactive session mid-use
    sb = Sandbox.create("sleep", "86400", gpu=gpu, timeout=86400)
    try:
        if command:
            raise SystemExit(run_and_echo(sb, command))
        if sys.stdin.isatty() and not no_pty:
            from .._utils.pty_shell import run_pty_session

            user_shell = os.environ.get("SHELL") or "/bin/bash"
            raise SystemExit(run_pty_session(sb, [user_shell, "-i"]))
        click.echo("modal-tpu-torch shell (line-based; 'exit' to quit)", err=True)
        while True:
            try:
                line = input("$ ")
            except (EOFError, KeyboardInterrupt):
                break
            if line.strip() in ("exit", "quit"):
                break
            if not line.strip():
                continue
            run_and_echo(sb, line)
    finally:
        sb.terminate()


@cli.command()
@click.argument("ref")
@click.option("--name", default=None)
def serve(ref: str, name: Optional[str]) -> None:
    """Deploy + hot-reload on file changes."""
    from ..serving import serve_app
    from .import_refs import parse_import_ref

    import_ref = parse_import_ref(ref)
    try:
        asyncio.run(serve_app(import_ref.file_or_module, ref, name))
    except KeyboardInterrupt:
        click.echo("stopped")


@cli.command()
@click.option("--port", default=9900)
@click.option("--workers", default=1)
@click.option("--state-dir", default=None)
def server(port: int, workers: int, state_dir: Optional[str]) -> None:
    """Start the local control plane + workers."""
    from ..server.supervisor import serve_forever

    try:
        asyncio.run(serve_forever(port=port, num_workers=workers, state_dir=state_dir))
    except KeyboardInterrupt:
        pass


# ---------------------------------------------------------------------------
# lint: the static-analysis suite, which waits for its sub-slice
# ---------------------------------------------------------------------------

LINT_WAITS = (
    "lint waits for the analysis sub-slice of modal_tpu_torch (ROADMAP Queue A: "
    "analysis/ with lint, the next sub-slice); the port has no static-analysis suite yet"
)


@cli.command("lint")
@click.option("--json", "as_json", is_flag=True, help="Machine-readable dump (shape pinned by tests; bench.py parses it).")
@click.option("--rule", "rules", multiple=True, help="Run only this rule id (repeatable; default: all).")
@click.option(
    "--update-baseline",
    is_flag=True,
    help="Rewrite tools/analysis_baseline.json: keep live entries, add current "
    "findings as TODO-justified, prune stale keys. Requires the full rule set.",
)
@click.option("--src-root", default=None, help="Package dir to analyze (default: the installed package).")
def lint_cmd(as_json: bool, rules: tuple[str, ...], update_baseline: bool, src_root: Optional[str]) -> None:
    """The concurrency and contract static-analysis suite. Refused: it waits
    for the analysis sub-slice (ROADMAP Queue A)."""
    raise click.ClickException(LINT_WAITS)


# ---------------------------------------------------------------------------
# app
# ---------------------------------------------------------------------------


@cli.group("app")
def app_group() -> None:
    """Manage apps."""


def _client():
    from ..client import Client

    return Client.from_env()


def _fmt_ts(ts: float) -> str:
    if not ts:
        return "-"
    return datetime.datetime.fromtimestamp(ts).strftime("%Y-%m-%d %H:%M:%S")


@app_group.command("list")
@click.option("--env", default="")
def app_list(env: str) -> None:
    from ..proto import api_pb2
    from .._utils.grpc_utils import retry_transient_errors

    client = _client()

    async def go(c):
        return await retry_transient_errors(
            c.stub.AppList, api_pb2.AppListRequest(environment_name=env)
        )

    resp = synchronizer.run(go(client))
    state_names = {v: k.replace("APP_STATE_", "").lower() for k, v in api_pb2.AppState.items()}
    for app in resp.apps:
        click.echo(
            f"{app.app_id}  {state_names.get(app.state, '?'):12s} {app.n_running_tasks:3d} tasks  "
            f"{_fmt_ts(app.created_at)}  {app.name or app.description}"
        )


@app_group.command("profile")
@click.argument("app_id")
def app_profile(app_id: str) -> None:
    """List the profiler traces recorded by runtime_debug functions of an
    app."""
    from .._utils.grpc_utils import retry_transient_errors
    from ..proto import api_pb2

    client = _client()

    async def go(c):
        return await retry_transient_errors(
            c.stub.AppListProfiles, api_pb2.AppListProfilesRequest(app_id=app_id)
        )

    resp = synchronizer.run(go(client))
    if not resp.profiles:
        click.echo("no profiles recorded (run the function with runtime_debug=True)")
        return
    for p in resp.profiles:
        click.echo(f"{p.task_id}  {p.num_traces:3d} traces  {p.size_bytes / 1e6:8.2f} MB  {p.path}")


@app_group.command("stop")
@click.argument("app_id")
def app_stop(app_id: str) -> None:
    from ..proto import api_pb2
    from .._utils.grpc_utils import retry_transient_errors

    client = _client()

    async def go(c):
        await retry_transient_errors(
            c.stub.AppStop, api_pb2.AppStopRequest(app_id=app_id, source=api_pb2.APP_STOP_SOURCE_CLI)
        )

    synchronizer.run(go(client))
    click.echo(f"stopped {app_id}")


@app_group.command("logs")
@click.argument("app_id")
@click.option("--follow", "-f", is_flag=True, help="Keep following after the backfill.")
@click.option("--task", "task_id", default="", help="Filter to one container.")
@click.option("--since", type=float, default=0.0, help="Unix timestamp: only entries at/after this.")
@click.option("--until", type=float, default=0.0, help="Unix timestamp: only entries before this.")
def app_logs(app_id: str, follow: bool, task_id: str, since: float, until: float) -> None:
    """Print an app's log history (backfill), optionally following. With a
    --since/--until window the bucketed fetch pages only dense ranges."""
    from .._logs import print_app_logs

    client = _client()
    try:
        synchronizer.run(
            print_app_logs(
                client._impl_obj if hasattr(client, "_impl_obj") else client,
                app_id,
                follow=follow,
                task_id=task_id,
                min_timestamp=since,
                max_timestamp=until,
            )
        )
    except KeyboardInterrupt:
        pass


@app_group.command("imports")
@click.argument("task_id")
@click.option("--top", default=15, help="Show the N slowest top-level imports.")
@click.option(
    "--state-dir",
    default=None,
    help="Worker state dir holding the trace (defaults to the local config "
    "state_dir — this command reads worker-LOCAL files, so point it at the "
    "server's --state-dir when that differs).",
)
def app_imports(task_id: str, top: int, state_dir: Optional[str]) -> None:
    """Slowest imports of a container (cold-start attribution; requires
    MODAL_TPU_IMPORT_TRACE=1 when the app ran)."""
    import os

    from ..config import config as _config
    from ..runtime.telemetry import summarize

    root = state_dir or _config["state_dir"]
    path = os.path.join(root, "tasks", task_id, "imports.jsonl")
    if not os.path.exists(path):
        raise click.ClickException(
            f"no import trace at {path} (run with MODAL_TPU_IMPORT_TRACE=1; "
            "pass --state-dir if the server uses a different state dir)"
        )
    for event in summarize(path, top=top):
        click.echo(f"{event['duration_s']*1000:10.1f} ms  {event['module']}")


def _trace_store(state_dir: Optional[str]) -> tuple[str, str]:
    """(state_root, span_store_dir) resolution shared by the trace commands."""
    from ..config import config as _config

    root = state_dir or _config["state_dir"]
    # a plane of the port always writes its spans to <state_dir>/traces
    return root, os.path.join(root, "traces")


@app_group.command("trace")
@click.argument("needle")
@click.option(
    "--state-dir",
    default=None,
    help="Supervisor state dir (same meaning as `app imports --state-dir`): "
    "spans are read from <state-dir>/traces, import details from "
    "<state-dir>/tasks/<task-id>/imports.jsonl.",
)
@click.option("--last", default=1, help="Render only the N most recent matching traces.")
@click.option(
    "--critical-path",
    is_flag=True,
    help="Append each trace's per-segment critical-path attribution table.",
)
def app_trace(needle: str, state_dir: Optional[str], last: int, critical_path: bool) -> None:
    """Render the distributed-trace waterfall for an app / call / input /
    task / trace id: where every input spent its time — client RPC, queue
    wait, placement, worker launch, container boot + imports, user code.

    NEEDLE matches a trace-id prefix or any span's app_id /
    function_call_id / input_id / task_id attribute.
    """
    from ..observability import tracing

    root, store = _trace_store(state_dir)
    traces = tracing.find_traces(store, needle)
    if not traces:
        raise click.ClickException(
            f"no trace matching {needle!r} under {store} "
            "(pass --state-dir if the supervisor uses a different state dir)"
        )
    ordered = sorted(traces.items(), key=lambda kv: min(s["start"] for s in kv[1]))
    for trace_id, spans in ordered[-max(1, last):]:
        _render_waterfall(trace_id, spans, root)
        if critical_path:
            _render_critical_path(spans)


def _render_critical_path(spans: list) -> None:
    from ..observability import critical_path as cp

    attr = cp.attribute_trace(spans)
    if attr is None:
        click.echo("  (no function.call root span — cannot attribute)")
        return
    agg = cp.aggregate_attributions([attr])
    click.echo("critical path:")
    for line in cp.format_attribution_table(agg).splitlines():
        click.echo(f"  {line}")


@app_group.command("attribute")
@click.argument("needle")
@click.option("--state-dir", default=None, help="Supervisor state dir (see `app trace`).")
@click.option("--last", default=0, help="Aggregate only the N most recent matching traces (0 = all).")
@click.option("--json", "as_json", is_flag=True, help="Machine-readable aggregate.")
@click.option(
    "--serving",
    is_flag=True,
    help="Serving-timeline ruleset: decompose each request's TTFT and "
    "per-token latency into queue/prefill/decode/stream (+ requeue) with "
    "explicit gap residue (traces root at serving.request).",
)
def app_attribute(
    needle: str, state_dir: Optional[str], last: int, as_json: bool, serving: bool
) -> None:
    """Aggregate critical-path attribution across every matching `.remote()`:
    p50/p95/p99 per segment (queue_wait, place, handoff, serialize, rpc,
    user.execute, output delivery) plus the unaccounted `gap` share —
    the honest answer to "where does dispatch latency go?".
    With --serving, the same sweep over per-request serving timelines.
    """
    from ..observability import critical_path as cp

    _root, store = _trace_store(state_dir)
    agg, _per_trace = cp.attribute_store(store, needle, last=last, serving=serving)
    if not agg.get("calls"):
        root_name = cp.SERVING_ROOT_SPAN if serving else cp.ROOT_SPAN
        raise click.ClickException(
            f"no attributable trace matching {needle!r} under {store} "
            f"(traces need a {root_name} root span; is tracing on?)"
        )
    if as_json:
        click.echo(json.dumps(agg, indent=2, sort_keys=True))
        return
    click.echo(cp.format_attribution_table(agg))


def _render_waterfall(trace_id: str, spans: list, state_dir: str) -> None:
    """One trace as an indented waterfall: offset from trace start, duration,
    and a proportional bar. Boot spans with an import trace on disk expand
    into their slowest modules (the existing `app imports` data).

    Ordering: (normalized start, tree depth, wall start, monotonic stamp) via
    critical_path.order_spans — children never render before their parents
    even when cross-process clock skew or equal timestamps would reorder a
    naive wall-clock sort."""
    from ..observability import critical_path as cp
    from ..runtime.telemetry import summarize

    # one tree reconstruction: sort locally with the same key order_spans
    # uses rather than paying normalize/depth twice
    depths = cp.span_depth(spans)
    norm = cp.normalize_starts(spans)
    spans = sorted(
        spans,
        key=lambda s: (
            norm.get(s.get("span_id", ""), float(s.get("start") or 0.0)),
            depths.get(s.get("span_id", ""), 0),
            float(s.get("start") or 0.0),
            float(s.get("mono") or 0.0),
        ),
    )
    t0 = min(s["start"] for s in spans)
    t_end = max((s.get("end") or s["start"]) for s in spans)
    total = max(t_end - t0, 1e-9)

    width = 28
    click.echo(f"trace {trace_id}  ({total*1000:.1f} ms, {len(spans)} spans)")
    for s in spans:
        start = norm.get(s.get("span_id", ""), s["start"])
        start_ms = (start - t0) * 1000
        dur_ms = max(0.0, ((s.get("end") or s["start"]) - s["start"]) * 1000)
        lo = int(width * (start - t0) / total)
        hi = max(lo + 1, int(width * (max(s.get("end") or s["start"], start) - t0) / total))
        hi = min(hi, width)
        lo = min(lo, hi - 1)
        bar = " " * lo + "▇" * (hi - lo) + " " * (width - hi)
        indent = "  " * depths.get(s.get("span_id", ""), 0)
        flag = " !" if s.get("status") == "error" else ""
        name = f"{indent}{s['name']}"
        click.echo(f"  {name:<42.42} {start_ms:>9.1f}ms +{dur_ms:>9.1f}ms |{bar}|{flag}")
        for ev in s.get("events") or []:
            click.echo(f"  {indent}  · {ev.get('name')} {_fmt_event_attrs(ev)}")
        attrs = s.get("attrs") or {}
        if s["name"] == "container.imports" and attrs.get("task_id") and attrs.get("import_trace"):
            imports_path = os.path.join(state_dir, "tasks", attrs["task_id"], "imports.jsonl")
            if os.path.exists(imports_path):
                for event in summarize(imports_path, top=5):
                    click.echo(
                        f"  {indent}    {event['duration_s']*1000:8.1f} ms  import {event['module']}"
                    )


def _fmt_event_attrs(ev: dict) -> str:
    parts = [f"{k}={v}" for k, v in ev.items() if k not in ("name", "t")]
    return " ".join(parts)


def _discover_metrics_url(
    url: Optional[str], state_dir: Optional[str]
) -> tuple[str, Optional[str]]:
    """The ONE metrics_url breadcrumb discovery, shared by `metrics`,
    `alerts`, and `top`: (resolved_url, breadcrumb_path_or_None). The
    breadcrumb path comes back so callers can distinguish "stale breadcrumb"
    from "bad --url" in their error text."""
    from ..config import config as _config

    if url is not None:
        return url, None
    root = state_dir or _config["state_dir"]
    url_file = os.path.join(root, "observability", "metrics_url")
    if not os.path.exists(url_file):
        raise click.ClickException(
            f"no supervisor metrics endpoint recorded at {url_file} "
            "(is a supervisor running? pass --url to reach one directly)"
        )
    with open(url_file) as f:
        return f.read().strip(), url_file


@cli.command("metrics")
@click.option("--url", default=None, help="Scrape URL (default: the local supervisor's).")
@click.option("--state-dir", default=None, help="Supervisor state dir (metrics_url discovery).")
@click.option("--json", "as_json", is_flag=True, help="Dump the registry snapshot as JSON.")
def metrics_cmd(url: Optional[str], state_dir: Optional[str], as_json: bool) -> None:
    """Dump the metrics registry of the running supervisor (Prometheus text
    from its GET /metrics endpoint; --json for a structured snapshot)."""
    import urllib.error
    import urllib.request

    url, url_file = _discover_metrics_url(url, state_dir)
    try:
        text = urllib.request.urlopen(url, timeout=5).read().decode()
    except (urllib.error.URLError, OSError) as exc:
        if url_file is not None:
            # the breadcrumb exists but nothing answers: the supervisor that
            # wrote it is gone (crashed, or restarted onto another port and
            # hasn't rewritten the file yet) — say so instead of a raw
            # connection error that reads like a CLI bug
            raise click.ClickException(
                f"metrics endpoint {url} is not answering — the breadcrumb at {url_file} "
                f"is stale (supervisor not running, or restarting). Start a supervisor or "
                f"pass --url to scrape one directly. ({exc})"
            )
        raise click.ClickException(f"scrape of {url} failed: {exc}")
    if as_json:
        click.echo(json.dumps(_parse_prometheus(text), indent=2, sort_keys=True))
    else:
        click.echo(text, nl=False)


# ---------------------------------------------------------------------------
# fleet SLO observability: alerts and the live top dashboard over the
# supervisor's time-series store (GET /metrics/history; server/history.py)
# ---------------------------------------------------------------------------


def _history_fetch(url: Optional[str], state_dir: Optional[str], query: str, **params) -> dict:
    """One history query against the supervisor's /metrics/history endpoint,
    discovered via the same metrics_url breadcrumb `modal_tpu metrics` uses
    (shared `_discover_metrics_url`)."""
    import urllib.error
    import urllib.parse
    import urllib.request

    url, url_file = _discover_metrics_url(url, state_dir)
    base = url[: -len("/metrics")] if url.endswith("/metrics") else url.rstrip("/")
    qs = urllib.parse.urlencode({"query": query, **{k: v for k, v in params.items() if v}})
    try:
        raw = urllib.request.urlopen(f"{base}/metrics/history?{qs}", timeout=5).read()
    except (urllib.error.URLError, OSError) as exc:
        if url_file is not None:
            raise click.ClickException(
                f"history endpoint at {base} is not answering — the breadcrumb at "
                f"{url_file} is stale (supervisor not running or restarting), or the "
                f"supervisor was started with MODAL_TPU_TS_INTERVAL=0."
                f"{_shard_topology_hint(url_file)} ({exc})"
            )
        raise click.ClickException(f"history query against {base} failed: {exc}")
    try:
        return json.loads(raw)
    except ValueError as exc:
        raise click.ClickException(f"malformed history payload: {exc}")


def _shard_topology_hint(url_file: str) -> str:
    """When the stale breadcrumb belongs to a sharded fleet root, name the
    topology in the error: the operator learns WHICH shard endpoints exist
    (observability/shards/ breadcrumbs) instead of guessing from one path."""
    root = os.path.dirname(os.path.dirname(url_file))
    try:
        with open(os.path.join(root, "shards.json")) as f:
            shards = json.load(f).get("shards") or []
    except (OSError, ValueError):
        return ""
    if not shards:
        return ""
    rows = ", ".join(
        f"shard {s.get('index')} {s.get('url') or '?'}{' [dead]' if s.get('dead') else ''}"
        for s in shards
    )
    return (
        f" This is a sharded fleet root ({len(shards)} shards: {rows}); the director "
        f"owns the root breadcrumb and per-shard endpoints are recorded under "
        f"{os.path.join(root, 'observability', 'shards')}/."
    )


def _fmt_num(v, unit: str = "", scale: float = 1.0, digits: int = 1) -> str:
    if v is None:
        return "-"
    return f"{v * scale:.{digits}f}{unit}"


@cli.command("alerts")
@click.option("--url", default=None, help="Metrics URL (default: the local supervisor's).")
@click.option("--state-dir", default=None, help="Supervisor state dir (metrics_url discovery).")
@click.option("--json", "as_json", is_flag=True, help="Machine-readable alert dump.")
def alerts_cmd(url: Optional[str], state_dir: Optional[str], as_json: bool) -> None:
    """SLO burn-rate alert states (observability/slo.py): per rule, the
    fast/slow-window values, burn rates, and firing/resolved status. Firing
    and resolving transitions are journaled — a firing alert here survives a
    supervisor crash_restart."""
    payload = _history_fetch(url, state_dir, "alerts")
    if as_json:
        click.echo(json.dumps(payload, indent=2, sort_keys=True))
        return
    rules = payload.get("rules") or []
    alerts = payload.get("alerts") or {}
    if not rules and not alerts:
        click.echo("no SLO rules evaluated yet (sampler warming up?)")
        return
    click.echo(
        f"{'rule':<26} {'state':<9} {'fast':>10} {'slow':>10} {'burn':>7} {'threshold':>10}"
    )
    for r in rules:
        state = r.get("state", "ok")
        burn = r.get("fast_burn")
        click.echo(
            f"{r['rule']:<26} {state:<9} "
            f"{_fmt_num(r.get('fast_value'), digits=4):>10} "
            f"{_fmt_num(r.get('slow_value'), digits=4):>10} "
            f"{_fmt_num(burn, 'x', digits=2):>7} "
            f"{r.get('op', '>')}{r.get('threshold')!s:>9}"
        )
    # journal-recovered alerts for rules the (fresh) evaluator hasn't
    # re-evaluated yet still show — silence is not recovery
    for name, a in sorted(alerts.items()):
        if any(r.get("rule") == name for r in rules):
            continue
        click.echo(f"{name:<26} {a.get('state', '?'):<9} (recovered from journal)")
    firing = [n for n, a in alerts.items() if a.get("state") == "firing"]
    click.echo(f"{len(firing)} firing" + (f": {', '.join(sorted(firing))}" if firing else ""))


_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def _sparkline(points: list, width: int = 30) -> str:
    vals = [p[1] for p in points][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(_SPARK_CHARS[int((v - lo) / span * (len(_SPARK_CHARS) - 1))] for v in vals)


def _render_top_frame(payload: dict) -> str:
    lines: list[str] = []
    fleet = payload.get("fleet") or {}
    alerts = (payload.get("alerts") or {}).get("alerts") or {}
    firing = sorted(n for n, a in alerts.items() if a.get("state") == "firing")
    stamp = datetime.datetime.fromtimestamp(payload.get("time", time.time())).strftime("%H:%M:%S")
    fed = payload.get("federation") or {}
    fed_tag = ""
    if fed:
        answered = fed.get("shards") or []
        n_shards = len(answered) if isinstance(answered, list) else answered
        fed_tag = f"   fleet-merged ({n_shards} shards)"
        if fed.get("partial"):
            # PARTIAL is load-bearing: merged counters/quantiles undercount
            # whatever the missing/dead shards would have contributed
            gone = sorted((fed.get("missing") or []) + (fed.get("dead") or []))
            fed_tag += f" PARTIAL — no answer from shard(s) {gone}"
    lines.append(f"modal_tpu top — {stamp}   alerts firing: {len(firing)}" + (
        f" ({', '.join(firing)})" if firing else ""
    ) + fed_tag)
    lines.append(
        f"  TTFT p50 {_fmt_num(fleet.get('ttft_p50_s'), 's', digits=3)}  "
        f"p95 {_fmt_num(fleet.get('ttft_p95_s'), 's', digits=3)}   "
        f"tokens/s {_fmt_num(fleet.get('tokens_per_s'))}   "
        f"req/s {_fmt_num(fleet.get('requests_per_s'), digits=2)}   "
        f"queue {_fmt_num(fleet.get('queue_depth'), digits=0)}   "
        f"dispatch p50 {_fmt_num(fleet.get('dispatch_p50_s'), 's', digits=3)}"
    )
    lines.append(
        f"  KV pages free {_fmt_num(fleet.get('kv_pages_free'), digits=0)} / "
        f"alloc {_fmt_num(fleet.get('kv_pages_allocated'), digits=0)}   "
        f"batch occupancy p50 {_fmt_num(fleet.get('batch_occupancy_p50'), digits=0)}   "
        f"mem {_fmt_num(fleet.get('device_memory_bytes'), ' MB', scale=1e-6, digits=0)}   "
        f"call err/s {_fmt_num(fleet.get('call_errors_per_s'), digits=2)}"
    )
    if fleet.get("control_shards_active"):
        # sharded control plane row (server/shards.py); absent on a monolith
        lines.append(
            f"  shards active {_fmt_num(fleet.get('control_shards_active'), digits=0)}   "
            f"placement p95 {_fmt_num(fleet.get('placement_p95_s'), 's', digits=4)}   "
            f"reroutes/s {_fmt_num(fleet.get('director_reroutes_per_s'), digits=2)}   "
            f"last takeover {_fmt_num(fleet.get('shard_takeover_s'), 's', digits=3)}"
        )
    spark = _sparkline(payload.get("tokens_sparkline") or [])
    if spark:
        lines.append(f"  tokens/s (10m) {spark}")
    for name, a in sorted(alerts.items()):
        if a.get("state") == "firing":
            lines.append(
                f"  ALERT {name}: burn {_fmt_num(a.get('burn_rate'), 'x', digits=1)} "
                f"value {_fmt_num(a.get('value'), digits=4)} (threshold {a.get('threshold')})"
            )
    shard_rows = payload.get("shards") or []
    if shard_rows:
        lines.append("")
        lines.append(
            f"  {'shard':<7} {'state':<9} {'calls/s':>8} {'req/s':>8} {'ttft p95':>9} "
            f"{'tok/s':>8} {'queue':>6} {'replicas':>9}"
        )
        for s in shard_rows:
            if s.get("state") != "live":
                lines.append(f"  {s.get('shard', '?'):<7} {s.get('state', '?'):<9} (no data)")
                continue
            lines.append(
                f"  {s.get('shard', '?'):<7} {s.get('state', ''):<9} "
                f"{_fmt_num(s.get('calls_per_s'), digits=2):>8} "
                f"{_fmt_num(s.get('requests_per_s'), digits=2):>8} "
                f"{_fmt_num(s.get('ttft_p95_s'), 's', digits=3):>9} "
                f"{_fmt_num(s.get('tokens_per_s')):>8} "
                f"{_fmt_num(s.get('queue_depth'), digits=0):>6} "
                f"{_fmt_num(s.get('replicas'), digits=0):>9}"
            )
    replicas = payload.get("replicas") or []
    lines.append("")
    lines.append(
        f"  {'replica':<14} {'function':<16} {'role':<7} {'occup':>6} {'kv free':>8} {'queue':>6} "
        f"{'ttft p95':>9} {'tok/s':>8} {'pfx hit':>8} {'accept':>7} {'mem MB':>8} {'age':>7}"
    )
    if not replicas:
        lines.append("  (no serving replicas pushing telemetry)")
    for r in replicas:
        lines.append(
            f"  {r.get('task_id', '')[:14]:<14} {str(r.get('function', ''))[:16]:<16} "
            f"{str(r.get('role') or '-'):<7} "
            f"{_fmt_num(r.get('batch_occupancy_mean'), digits=1):>6} "
            f"{_fmt_num(r.get('kv_pages_free'), digits=0):>8} "
            f"{_fmt_num(r.get('queue_depth'), digits=0):>6} "
            f"{_fmt_num(r.get('ttft_p95_s'), 's', digits=3):>9} "
            f"{_fmt_num(r.get('tokens_per_s')):>8} "
            f"{_fmt_num(r.get('prefix_hit_pct'), '%', digits=0):>8} "
            f"{_fmt_num(r.get('spec_accept_ratio'), digits=2):>7} "
            f"{_fmt_num(r.get('memory_bytes'), scale=1e-6, digits=0):>8} "
            f"{_fmt_num(r.get('age_s'), 's', digits=0):>7}"
        )
    return "\n".join(lines)


@cli.command("top")
@click.option("--url", default=None, help="Metrics URL (default: the local supervisor's).")
@click.option("--state-dir", default=None, help="Supervisor state dir (metrics_url discovery).")
@click.option("--interval", default=2.0, help="Refresh interval in seconds.")
@click.option("--once", is_flag=True, help="Render a single frame and exit (no screen control).")
@click.option("--json", "as_json", is_flag=True, help="Dump one raw dashboard payload as JSON.")
def top_cmd(
    url: Optional[str], state_dir: Optional[str], interval: float, once: bool, as_json: bool
) -> None:
    """Live fleet dashboard over the supervisor's time-series history: per-
    replica batch occupancy, KV pool free pages, queue depth, TTFT p50/p95,
    tokens/s, device memory, and active SLO burn rates. Ctrl-C to exit."""
    payload = _history_fetch(url, state_dir, "top")
    if as_json:
        click.echo(json.dumps(payload, indent=2, sort_keys=True))
        return
    if once:
        click.echo(_render_top_frame(payload))
        return
    try:
        while True:
            # ANSI home+clear-to-end keeps the frame flicker-free
            click.echo("\033[H\033[2J" + _render_top_frame(payload), nl=True)
            time.sleep(max(0.2, interval))
            payload = _history_fetch(url, state_dir, "top")
    except KeyboardInterrupt:
        pass


# ---------------------------------------------------------------------------
# trace store maintenance (observability/tracing.py retention)
# ---------------------------------------------------------------------------


@cli.group("trace")
def trace_group() -> None:
    """Maintain the span store (`<state_dir>/traces`)."""


@trace_group.command("gc")
@click.option("--state-dir", default=None, help="Supervisor state dir (default: configured).")
@click.option("--max-mb", default=256, help="Total span-store size cap (MiB).")
@click.option("--max-age-hours", default=168.0, help="Drop span files older than this.")
def trace_gc(state_dir: Optional[str], max_mb: int, max_age_hours: float) -> None:
    """Prune the span store: age out old files, then evict oldest-first
    (rotated generations before live files) until under the size cap. The
    supervisor runs the same prune on every boot; this is the offline knob."""
    from ..observability import tracing

    _root, store = _trace_store(state_dir)
    dirs = [d for d in tracing.span_dirs(store) if os.path.isdir(d)]
    if not dirs:
        raise click.ClickException(f"no span store at {store}")
    # a sharded fleet keeps one span sink per shard (<root>/shard-*/traces)
    # next to the director's; the size cap applies per sink so one chatty
    # shard can't starve the others' retention
    total = {"removed": 0, "removed_bytes": 0, "kept": 0, "kept_bytes": 0}
    for d in dirs:
        report = tracing.gc_trace_dir(
            d, max_total_bytes=max_mb * 1024 * 1024, max_age_s=max_age_hours * 3600.0
        )
        for k in total:
            total[k] += report[k]
    click.echo(
        f"removed {total['removed']} file(s) ({total['removed_bytes']} bytes); "
        f"kept {total['kept']} ({total['kept_bytes']} bytes) across {len(dirs)} span dir(s)"
    )


# ---------------------------------------------------------------------------
# crash forensics (observability/flight_recorder.py)
# ---------------------------------------------------------------------------


@cli.group("debug")
def debug_group() -> None:
    """Crash forensics: flight-recorder postmortems and merged fleet timelines."""


def _timeline_stamp(t: float) -> str:
    return datetime.datetime.fromtimestamp(t).strftime("%H:%M:%S.%f")[:-3]


@debug_group.command("bundle")
@click.option("--state-dir", default=None, help="Fleet/supervisor state dir (default: configured).")
@click.option("--out", default=None, help="Write the full merged bundle JSON to this path.")
@click.option("--json", "as_json", is_flag=True, help="Dump the merged bundle JSON to stdout.")
@click.option(
    "--window",
    default=0.0,
    help="Only keep timeline events from the last N seconds (0 = everything found).",
)
def debug_bundle(
    state_dir: Optional[str], out: Optional[str], as_json: bool, window: float
) -> None:
    """Merge every forensic artifact under a state dir into one timeline:
    flight-recorder postmortem dumps (crash_restart / takeover / fence /
    alert), the director's takeover log with its fence→adopt→remap→rehome
    phase timestamps, and journaled fleet-scope SLO transitions. The point is
    a single time-ordered view of WHAT the fleet did around a crash, without
    hand-correlating per-shard files."""
    from ..config import config as _config
    from ..observability import flight_recorder, tracing

    root = os.path.abspath(state_dir or _config["state_dir"])
    with tracing.span("debug.bundle", attrs={"root": root}):
        postmortems: list[dict] = []
        for path in flight_recorder.find_postmortems(root):
            try:
                with open(path) as f:
                    pm = json.load(f)
            except (OSError, ValueError):
                continue  # torn dump from a crash mid-write: skip, don't abort
            pm["path"] = path
            postmortems.append(pm)

        takeovers: list[dict] = []
        try:
            with open(os.path.join(root, "director.json")) as f:
                takeovers = json.load(f).get("takeovers") or []
        except (OSError, ValueError):
            pass

        fleet_alerts: list[dict] = []
        alerts_path = os.path.join(root, "observability", "fleet_alerts.jsonl")
        try:
            with open(alerts_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        fleet_alerts.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            pass

        events: list[dict] = []
        for pm in postmortems:
            where = (
                f"shard {pm.get('shard_index')}"
                if pm.get("shard_index") is not None
                else pm.get("scope", "?")
            )
            events.append(
                {
                    "t": float(pm.get("t") or 0.0),
                    "source": where,
                    "what": (
                        f"postmortem {pm.get('event')} "
                        f"({len(pm.get('samples') or [])} samples, "
                        f"{len(pm.get('spans') or [])} spans, "
                        f"{len(pm.get('journal_tail') or [])} journal records) "
                        f"-> {pm.get('path')}"
                    ),
                }
            )
        for tk in takeovers:
            phases = tk.get("phases") or {}
            t0 = float(phases.get("start") or 0.0)
            head = (
                f"takeover shard {tk.get('dead_shard')} -> {tk.get('successor')} "
                f"epoch {tk.get('epoch')}"
            )
            if not phases:
                events.append({"t": t0, "source": "director", "what": head})
            for phase in ("start", "fence", "adopt", "remap", "rehome"):
                if phase not in phases:
                    continue
                pt = float(phases[phase])
                events.append(
                    {
                        "t": pt,
                        "source": "director",
                        "what": f"{head}: {phase} (+{pt - t0:.3f}s)",
                    }
                )
        for rec in fleet_alerts:
            events.append(
                {
                    "t": float(rec.get("since") or rec.get("t") or 0.0),
                    "source": "fleet-slo",
                    "what": (
                        f"fleet alert {rec.get('rule')} -> {rec.get('state')} "
                        f"(value {rec.get('value')}, burn {rec.get('burn_rate')})"
                    ),
                }
            )
        if window and window > 0 and events:
            horizon = max(e["t"] for e in events) - window
            events = [e for e in events if e["t"] >= horizon]
        events.sort(key=lambda e: e["t"])

        bundle = {
            "version": 1,
            "root": root,
            "generated_at": time.time(),
            "postmortems": postmortems,
            "takeovers": takeovers,
            "fleet_alerts": fleet_alerts,
            "timeline": events,
        }
        if out:
            with open(out, "w") as f:
                json.dump(bundle, f, indent=2, sort_keys=True)
        if as_json:
            click.echo(json.dumps(bundle, indent=2, sort_keys=True))
            return
        click.echo(
            f"debug bundle for {root}: {len(postmortems)} postmortem(s), "
            f"{len(takeovers)} takeover(s), {len(fleet_alerts)} fleet alert transition(s)"
        )
        if not events:
            click.echo("  (no forensic events found — flight recorder off or nothing crashed)")
        for e in events:
            click.echo(f"  {_timeline_stamp(e['t'])}  {e['source']:<10} {e['what']}")
        if out:
            click.echo(f"wrote {out}")


# ---------------------------------------------------------------------------
# journal (durable control plane, server/journal.py)
# ---------------------------------------------------------------------------


@cli.group("journal")
def journal_group() -> None:
    """Inspect/compact the control plane's write-ahead journal."""


def _shard_dirs(root: str) -> list[str]:
    """Shard state dirs under a sharded-control-plane root (server/shards.py):
    <root>/shard-<i>/ with a journal. Empty for a monolith root."""
    import glob as _glob

    return sorted(
        d
        for d in _glob.glob(os.path.join(root, "shard-*"))
        if os.path.isdir(os.path.join(d, "journal"))
    )


def _open_journal(state_dir: Optional[str]):
    from ..config import config as _config
    from ..server.journal import Journal

    root = state_dir or _config["state_dir"]
    jdir = os.path.join(root, "journal")
    if not os.path.isdir(jdir):
        raise click.ClickException(
            f"no journal at {jdir} (has a supervisor with journaling enabled run against "
            "this state dir? pass --state-dir to point elsewhere)"
        )
    return Journal(root)


@journal_group.command("status")
@click.option("--state-dir", default=None, help="Supervisor state dir (default: configured).")
@click.option("--json", "as_json", is_flag=True, help="Machine-readable status.")
def journal_status(state_dir: Optional[str], as_json: bool) -> None:
    """Journal health: sequence position, snapshot coverage, segment sizes,
    record counts by type, and the replica streams a shard holds for its
    peers (server/replication.py), read off disk. A sharded root
    (<root>/shard-*/) gets a per-shard summary."""
    from ..config import config as _config
    from ..server.journal import Journal
    from ..server.replication import offline_stream_status, quorum_acks_needed, replicas_configured

    root = state_dir or _config["state_dir"]
    shards = _shard_dirs(root)
    replicas = replicas_configured()
    if shards:
        statuses = []
        for sdir in shards:
            j = Journal(sdir)
            st = j.status()
            j.close()
            st["replica_streams"] = offline_stream_status(sdir) if replicas > 0 else []
            statuses.append(st)
        if as_json:
            click.echo(
                json.dumps(
                    {
                        "shards": statuses,
                        "replication": {"replicas": replicas, "quorum_acks_needed": quorum_acks_needed(replicas)},
                    },
                    indent=2,
                    sort_keys=True,
                )
            )
            return
        click.echo(
            f"sharded control plane root {root} ({len(shards)} shard journal(s), "
            f"replication {replicas} follower(s)/writer"
            + (f", quorum {quorum_acks_needed(replicas)} ack(s))" if replicas else " — off)")
        )
        writer_seqs = {}
        for sdir, st in zip(shards, statuses):
            try:
                writer_seqs[int(os.path.basename(sdir).rsplit("-", 1)[1])] = st["seq"]
            except (IndexError, ValueError):
                pass
        for sdir, st in zip(shards, statuses):
            click.echo(f"  {os.path.basename(sdir):<10} seq {st['seq']:<8} "
                       f"snapshot<={st['snapshot_seq']:<8} {st['segments']} segment(s) "
                       f"{st['tail_records']} tail  {st['bytes']} bytes")
            for stream in st["replica_streams"]:
                seal = (
                    f" SEALED@{stream['sealed_epoch']} seq<={stream['sealed_seq']}" if stream.get("sealed_epoch") else ""
                )
                lag = writer_seqs.get(stream["writer"], stream["last_seq"]) - stream["last_seq"]
                click.echo(
                    f"             replica of shard-{stream['writer']}: "
                    f"seq {stream['last_seq']} epoch {stream['epoch']}"
                    f" (lag {max(0, lag)} vs writer journal){seal}"
                )
        return
    j = _open_journal(state_dir)
    st = j.status()
    j.close()
    if replicas > 0:
        st["replica_streams"] = offline_stream_status(root)
    if as_json:
        click.echo(json.dumps(st, indent=2, sort_keys=True))
        return
    click.echo(f"journal {st['dir']}")
    click.echo(f"  seq {st['seq']}  (snapshot covers <= {st['snapshot_seq']})")
    click.echo(f"  {st['segments']} segment(s), {st['tail_records']} tail record(s), {st['bytes']} bytes")
    click.echo(f"  fsync per append: {'on' if st['fsync'] else 'off (page-cache durable)'}")
    for t, n in st["records_by_type"].items():
        click.echo(f"    {t:<20} {n}")
    for stream in st.get("replica_streams") or []:
        seal = f" SEALED@{stream['sealed_epoch']} seq<={stream['sealed_seq']}" if stream.get("sealed_epoch") else ""
        click.echo(f"  replica of shard-{stream['writer']}: seq {stream['last_seq']} epoch {stream['epoch']}{seal}")


@journal_group.command("compact")
@click.option("--state-dir", default=None, help="Supervisor state dir (default: configured).")
@click.option("--force", is_flag=True, help="Compact even if a supervisor looks live.")
def journal_compact(state_dir: Optional[str], force: bool) -> None:
    """Offline compaction: replay the journal into a fresh state, write a
    snapshot, prune covered segments. A LIVE supervisor compacts itself
    periodically — refuse if one appears to be running (its open segment
    would race this tool) unless --force. A sharded root refuses if ANY
    shard is live (a takeover could be replaying a sibling's segments),
    then compacts every shard journal in sequence."""
    from ..config import config as _config

    root = state_dir or _config["state_dir"]
    shards = _shard_dirs(root)
    targets = shards or [root]
    if not force:
        for target in targets:
            url = _live_supervisor_url(target)
            if url is not None:
                what = f"shard {os.path.basename(target)}" if shards else "a live supervisor"
                raise click.ClickException(
                    f"{what} answers at {url} — live planes compact their own journals; "
                    "use --force to compact anyway (risks racing an open segment or a takeover)"
                )
    from ..server.replication import offline_replicate_snapshot, replicas_configured

    for target in targets:
        prefix = f"{os.path.basename(target)}: " if shards else ""
        message, snapshot_path, snapshot_seq = _compact_one(target)
        click.echo(prefix + message)
        if shards and replicas_configured() > 0 and snapshot_seq > 0:
            # a follower must never need the segments this compaction just
            # pruned: the fresh snapshot goes into every sibling's stream
            try:
                writer = int(os.path.basename(target).rsplit("-", 1)[1])
            except (IndexError, ValueError):
                continue
            updated = offline_replicate_snapshot(root, writer, snapshot_path, snapshot_seq)
            if updated:
                click.echo(
                    f"{prefix}snapshot seq<={snapshot_seq} replicated to sibling shard(s) "
                    + ", ".join(str(u) for u in updated)
                )


def _live_supervisor_url(root: str) -> Optional[str]:
    """The supervisor's metrics breadcrumb, iff something still answers it."""
    import urllib.request

    url_file = os.path.join(root, "observability", "metrics_url")
    if not os.path.exists(url_file):
        return None
    with open(url_file) as f:
        url = f.read().strip()
    try:
        urllib.request.urlopen(url, timeout=2).read()
        return url
    except Exception:  # noqa: BLE001 — dead breadcrumb: safe to compact
        return None


def _compact_one(root: str) -> tuple[str, str, int]:
    from ..server.journal import IdempotencyCache, Journal, recover_state, synthesize_records
    from ..server.state import ServerState

    jdir = os.path.join(root, "journal")
    if not os.path.isdir(jdir):
        raise click.ClickException(f"no journal at {jdir}")
    j = Journal(root)
    before = j.status()
    state = ServerState(root)
    state.idempotency = IdempotencyCache(journal=None)
    report = recover_state(state, j)
    snapshot_path = j.write_snapshot(synthesize_records(state))
    after = j.status()
    j.close()
    message = (
        f"compacted: {before['tail_records']} tail record(s) -> snapshot at seq {after['snapshot_seq']} "
        f"({before['bytes']} -> {after['bytes']} bytes); "
        f"replayed {report['records_applied']} record(s), {report['open_calls']} open call(s)"
    )
    return message, snapshot_path, int(after["snapshot_seq"])


def _parse_prometheus(text: str) -> dict:
    """Minimal exposition-format parse for --json (sample name+labels → value).
    OpenMetrics exemplar suffixes (`... # {trace_id="…"} v ts`) are stripped."""
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        line = line.split(" # ", 1)[0]  # drop exemplar
        name_labels, _, value = line.rpartition(" ")
        try:
            out[name_labels] = float(value)
        except ValueError:
            continue
    return out


@app_group.command("history")
@click.argument("app_id")
def app_history(app_id: str) -> None:
    from ..proto import api_pb2
    from .._utils.grpc_utils import retry_transient_errors

    client = _client()

    async def go(c):
        return await retry_transient_errors(
            c.stub.AppDeploymentHistory, api_pb2.AppDeploymentHistoryRequest(app_id=app_id)
        )

    resp = synchronizer.run(go(client))
    for h in resp.history:
        click.echo(f"v{h.version}  {_fmt_ts(h.deployed_at)}  tag={h.deployment_tag or '-'}")


# ---------------------------------------------------------------------------
# volume
# ---------------------------------------------------------------------------


@cli.group("volume")
def volume_group() -> None:
    """Manage volumes."""


@volume_group.command("list")
def volume_list() -> None:
    from ..proto import api_pb2
    from .._utils.grpc_utils import retry_transient_errors

    client = _client()

    async def go(c):
        return await retry_transient_errors(c.stub.VolumeList, api_pb2.VolumeListRequest())

    resp = synchronizer.run(go(client))
    for v in resp.items:
        click.echo(f"{v.volume_id}  {_fmt_ts(v.created_at)}  {v.name}")


@volume_group.command("create")
@click.argument("name")
def volume_create(name: str) -> None:
    from ..volume import Volume

    Volume.create_deployed(name)
    click.echo(f"created volume {name}")


@volume_group.command("delete")
@click.argument("name")
@click.confirmation_option(prompt="Delete this volume and all its data?")
def volume_delete(name: str) -> None:
    from ..volume import Volume

    Volume.delete(name)
    click.echo(f"deleted volume {name}")


@volume_group.command("ls")
@click.argument("name")
@click.argument("path", default="/")
def volume_ls(name: str, path: str) -> None:
    from ..volume import Volume

    vol = Volume.from_name(name)
    for entry in vol.listdir(path, recursive=False):
        click.echo(f"{entry.size:12d}  {_fmt_ts(entry.mtime)}  {entry.path}")


@volume_group.command("put")
@click.argument("name")
@click.argument("local_path")
@click.argument("remote_path", default="/")
@click.option("--force", is_flag=True)
def volume_put(name: str, local_path: str, remote_path: str, force: bool) -> None:
    from ..volume import Volume

    vol = Volume.from_name(name)
    vol.hydrate()
    with vol.batch_upload(force=force) as batch:
        if os.path.isdir(local_path):
            batch.put_directory(local_path, remote_path)
        else:
            dest = remote_path
            if dest.endswith("/"):
                dest = dest + os.path.basename(local_path)
            batch.put_file(local_path, dest)
    click.echo(f"uploaded {local_path} -> {name}:{remote_path}")


@volume_group.command("get")
@click.argument("name")
@click.argument("remote_path")
@click.argument("local_path", default=".")
def volume_get(name: str, remote_path: str, local_path: str) -> None:
    from ..volume import Volume

    vol = Volume.from_name(name)
    dest = local_path
    if os.path.isdir(local_path):
        dest = os.path.join(local_path, os.path.basename(remote_path))
    with open(dest, "wb") as f:
        vol.read_file_into(remote_path, f)
    click.echo(f"downloaded {name}:{remote_path} -> {dest}")


@volume_group.command("rm")
@click.argument("name")
@click.argument("remote_path")
@click.option("-r", "--recursive", is_flag=True)
def volume_rm(name: str, remote_path: str, recursive: bool) -> None:
    from ..volume import Volume

    vol = Volume.from_name(name)
    vol.remove_file(remote_path, recursive=recursive)
    click.echo(f"removed {name}:{remote_path}")


# ---------------------------------------------------------------------------
# secret / dict / queue
# ---------------------------------------------------------------------------


@cli.group("secret")
def secret_group() -> None:
    """Manage secrets."""


@secret_group.command("list")
def secret_list() -> None:
    from ..proto import api_pb2
    from .._utils.grpc_utils import retry_transient_errors

    client = _client()

    async def go(c):
        return await retry_transient_errors(c.stub.SecretList, api_pb2.SecretListRequest())

    resp = synchronizer.run(go(client))
    for s in resp.items:
        click.echo(f"{s.secret_id}  {_fmt_ts(s.created_at)}  {s.label}")


@secret_group.command("create")
@click.argument("name")
@click.argument("keyvalues", nargs=-1)
def secret_create(name: str, keyvalues: tuple[str, ...]) -> None:
    """modal-tpu secret create my-secret KEY1=VALUE1 KEY2=VALUE2"""
    from ..secret import Secret

    env_dict = {}
    for kv in keyvalues:
        if "=" not in kv:
            raise click.UsageError(f"expected KEY=VALUE, got {kv!r}")
        k, v = kv.split("=", 1)
        env_dict[k] = v
    Secret.create_deployed(name, env_dict)
    click.echo(f"created secret {name} ({len(env_dict)} keys)")


@secret_group.command("delete")
@click.argument("name")
def secret_delete(name: str) -> None:
    from ..proto import api_pb2
    from .._utils.grpc_utils import retry_transient_errors

    client = _client()

    async def go(c):
        resp = await retry_transient_errors(
            c.stub.SecretGetOrCreate, api_pb2.SecretGetOrCreateRequest(deployment_name=name)
        )
        await retry_transient_errors(c.stub.SecretDelete, api_pb2.SecretDeleteRequest(secret_id=resp.secret_id))

    synchronizer.run(go(client))
    click.echo(f"deleted secret {name}")


# ---------------------------------------------------------------------------
# proxy (static egress; reference proxy.py:1 — dashboard-provisioned there,
# CLI-provisioned here)
# ---------------------------------------------------------------------------


@cli.group("proxy")
def proxy_group() -> None:
    """Manage static-egress proxies."""


@proxy_group.command("create")
@click.argument("name")
def proxy_create(name: str) -> None:
    from ..proxy import Proxy

    p = Proxy.create(name)
    click.echo(f"created proxy {name} ({p.object_id})")


@proxy_group.command("list")
def proxy_list() -> None:
    from .._utils.grpc_utils import retry_transient_errors
    from ..proto import api_pb2

    client = _client()

    async def go(c):
        return await retry_transient_errors(c.stub.ProxyList, api_pb2.ProxyListRequest())

    resp = synchronizer.run(go(client))
    for p in resp.proxies:
        click.echo(f"{p.proxy_id}  {p.proxy_ip:<15}  {p.name}")


@proxy_group.command("delete")
@click.argument("name")
def proxy_delete(name: str) -> None:
    from ..proxy import Proxy

    Proxy.delete(name)
    click.echo(f"deleted proxy {name}")


@cli.group("dict")
def dict_group() -> None:
    """Manage dicts."""


@dict_group.command("list")
def dict_list() -> None:
    from ..proto import api_pb2
    from .._utils.grpc_utils import retry_transient_errors

    client = _client()

    async def go(c):
        return await retry_transient_errors(c.stub.DictList, api_pb2.DictListRequest())

    resp = synchronizer.run(go(client))
    for d in resp.items:
        click.echo(f"{d.dict_id}  {_fmt_ts(d.created_at)}  {d.name}")


@dict_group.command("clear")
@click.argument("name")
def dict_clear(name: str) -> None:
    from ..dict import Dict

    Dict.from_name(name).clear()
    click.echo(f"cleared dict {name}")


@cli.group("queue")
def queue_group() -> None:
    """Manage queues."""


@queue_group.command("list")
def queue_list() -> None:
    from ..proto import api_pb2
    from .._utils.grpc_utils import retry_transient_errors

    client = _client()

    async def go(c):
        return await retry_transient_errors(c.stub.QueueList, api_pb2.QueueListRequest())

    resp = synchronizer.run(go(client))
    for q in resp.items:
        click.echo(f"{q.queue_id}  {q.total_size:5d} items  {q.num_partitions:3d} partitions  {q.name}")


@queue_group.command("peek")
@click.argument("name")
@click.option("-n", default=5)
def queue_peek(name: str, n: int) -> None:
    from ..queue import Queue

    q = Queue.from_name(name)
    count = 0
    for item in q.iterate():
        click.echo(repr(item))
        count += 1
        if count >= n:
            break


# ---------------------------------------------------------------------------
# config / profile / token
# ---------------------------------------------------------------------------


@cli.group("config")
def config_group() -> None:
    """Inspect configuration."""


@config_group.command("show")
def config_show() -> None:
    click.echo(json.dumps(config.to_dict(), indent=2, default=str))


@cli.group("profile")
def profile_group() -> None:
    """Config profiles (list/activate) + continuous profiling (start/stop/
    show): the sampling profiler in the supervisor and its live containers
    (observability/profiler.py)."""


@profile_group.command("list")
def profile_list() -> None:
    for name in config_profiles():
        click.echo(name)


@profile_group.command("activate")
@click.argument("name")
def profile_activate(name: str) -> None:
    config_set_active_profile(name)
    click.echo(f"activated profile {name}")


def _profile_control(action: str, hz: float = 0.0):
    from .._utils.grpc_utils import retry_transient_errors
    from ..proto import api_pb2

    client = _client()

    async def go(c):
        return await retry_transient_errors(
            c.stub.ProfileControl, api_pb2.ProfileControlRequest(action=action, hz=hz)
        )

    return synchronizer.run(go(client))


@profile_group.command("start")
@click.option("--hz", default=0.0, help="Sampling rate (default 19 Hz; see profiler.py on GIL cost).")
def profile_start(hz: float) -> None:
    """Start continuous profiling: the supervisor samples immediately, and
    every live container picks the command up on its next heartbeat."""
    resp = _profile_control("start", hz)
    click.echo(
        f"profiling started (supervisor: {resp.supervisor_profile_path}); "
        "containers join on their next heartbeat"
    )


@profile_group.command("stop")
def profile_stop() -> None:
    """Stop continuous profiling everywhere and flush folded-stack files."""
    resp = _profile_control("stop")
    click.echo(f"profiling stopped; {len(resp.profile_paths)} profile file(s) on disk")
    for p in resp.profile_paths:
        click.echo(f"  {p}")


@profile_group.command("show")
@click.option("--top", default=20, help="Rows in the top table.")
@click.option("--state-dir", default=None, help="Supervisor state dir (default: configured).")
@click.option(
    "--match", default="", help="Only profiles whose filename contains this (e.g. a task id)."
)
@click.option("--file", "file_", default=None, help="Render ONE folded file instead of the store.")
def profile_show(top: int, state_dir: Optional[str], match: str, file_: Optional[str]) -> None:
    """Render the folded-stack top table (self/cumulative samples per frame)
    from `<state_dir>/observability/profiles/` — live profiles flush every
    couple of seconds, so this works while profiling is still running."""
    from ..config import config as _config
    from ..observability import profiler as obs_profiler

    if file_:
        paths = [file_]
    else:
        root = state_dir or _config["state_dir"]
        profiles_dir = os.path.join(root, "observability", "profiles")
        paths = obs_profiler.list_profiles(profiles_dir)
        if match:
            paths = [p for p in paths if match in os.path.basename(p)]
        if not paths:
            raise click.ClickException(
                f"no profiles under {profiles_dir} (start one: `profile start`, "
                "or set MODAL_TPU_PROFILE=1)"
            )
    stacks = obs_profiler.merge_folded(paths)
    if not stacks:
        raise click.ClickException(f"no samples in {len(paths)} profile file(s) yet")
    click.echo(f"{len(paths)} profile file(s):")
    for p in paths:
        click.echo(f"  {p}")
    click.echo(obs_profiler.format_top_table(stacks, top=top))


# ---------------------------------------------------------------------------
# container / cluster / environment / image / nfs
# (reference cli/entry_point.py:101-134 — the management command groups)
# ---------------------------------------------------------------------------


def _task_state_name(state: int) -> str:
    from ..proto import api_pb2

    return api_pb2.TaskState.Name(state).removeprefix("TASK_STATE_").lower()


@cli.group("container")
def container_group() -> None:
    """Manage running containers (reference cli/container.py)."""


@container_group.command("list")
@click.option("--env", default="", help="Filter to one environment.")
@click.option("--all", "include_finished", is_flag=True, help="Include finished containers.")
def container_list(env: str, include_finished: bool) -> None:
    from .._utils.grpc_utils import retry_transient_errors
    from ..proto import api_pb2

    client = _client()

    async def go(c):
        return await retry_transient_errors(
            c.stub.TaskList,
            api_pb2.TaskListRequest(environment_name=env, include_finished=include_finished),
        )

    resp = synchronizer.run(go(client))
    for t in resp.tasks:
        # the task's cards (its worker's card slots) where the JAX package
        # shows TPU chips
        cards = f" cards={list(t.gpu_ids)}" if t.gpu_ids else ""
        gang = f" gang={t.cluster_id}#{t.rank}" if t.cluster_id else ""
        click.echo(
            f"{t.task_id}  {_task_state_name(t.state):10s} {_fmt_ts(t.created_at)}  "
            f"{t.app_description or t.app_id}::{t.function_tag}{cards}{gang}"
        )


@container_group.command("stop")
@click.argument("task_id")
def container_stop(task_id: str) -> None:
    from .._utils.grpc_utils import retry_transient_errors
    from ..proto import api_pb2

    client = _client()

    async def go(c):
        await retry_transient_errors(
            c.stub.ContainerStop, api_pb2.ContainerStopRequest(task_id=task_id)
        )

    synchronizer.run(go(client))
    click.echo(f"stopping {task_id}")


@container_group.command("logs")
@click.argument("task_id")
def container_logs(task_id: str) -> None:
    """Backfill one container's logs (windowed fetch filtered by task)."""
    from .._utils.grpc_utils import retry_transient_errors
    from ..proto import api_pb2

    client = _client()

    async def go(c):
        tasks = await retry_transient_errors(
            c.stub.TaskList, api_pb2.TaskListRequest(include_finished=True)
        )
        app_id = next((t.app_id for t in tasks.tasks if t.task_id == task_id), None)
        if app_id is None:
            raise Error(f"container {task_id} not found")
        entries = []
        start = 0
        while True:
            resp = await retry_transient_errors(
                c.stub.AppFetchLogs,
                api_pb2.AppFetchLogsRequest(app_id=app_id, task_id=task_id, start_index=start),
            )
            entries.extend(resp.entries)
            # an empty PAGE is normal (500 consecutive entries from other
            # tasks); only stop when the cursor reaches the end or stalls
            if resp.next_index >= resp.total or resp.next_index <= start:
                break
            start = resp.next_index
        return entries

    for entry in synchronizer.run(go(client)):
        click.echo(entry.data, nl=False)


@cli.group("cluster")
def cluster_group() -> None:
    """Inspect gangs of co-scheduled containers (reference cli/cluster.py)."""


@cluster_group.command("list")
def cluster_list() -> None:
    from .._utils.grpc_utils import retry_transient_errors
    from ..proto import api_pb2

    client = _client()

    async def go(c):
        return await retry_transient_errors(c.stub.ClusterList, api_pb2.ClusterListRequest())

    resp = synchronizer.run(go(client))
    for cl in resp.clusters:
        topo = f" topology={cl.topology}" if cl.topology else ""
        click.echo(
            f"{cl.cluster_id}  {cl.function_tag}  size={cl.size} "
            f"ranks_reported={cl.ranks_reported}{topo}"
        )


@cli.group("environment")
def environment_group() -> None:
    """Manage environments (reference cli/environment.py)."""


@environment_group.command("list")
def environment_list() -> None:
    from .._utils.grpc_utils import retry_transient_errors
    from ..proto import api_pb2

    client = _client()

    async def go(c):
        return await retry_transient_errors(c.stub.EnvironmentList, api_pb2.EnvironmentListRequest())

    resp = synchronizer.run(go(client))
    for e in resp.items:
        suffix = f"  {e.webhook_suffix}" if e.webhook_suffix else ""
        click.echo(f"{e.name}{suffix}")


@environment_group.command("create")
@click.argument("name")
def environment_create(name: str) -> None:
    from .._utils.grpc_utils import retry_transient_errors
    from ..proto import api_pb2

    client = _client()

    async def go(c):
        await retry_transient_errors(
            c.stub.EnvironmentCreate, api_pb2.EnvironmentCreateRequest(name=name)
        )

    synchronizer.run(go(client))
    click.echo(f"created environment {name}")


@environment_group.command("rename")
@click.argument("name")
@click.argument("new_name")
def environment_rename(name: str, new_name: str) -> None:
    from .._utils.grpc_utils import retry_transient_errors
    from ..proto import api_pb2

    client = _client()

    async def go(c):
        await retry_transient_errors(
            c.stub.EnvironmentUpdate,
            api_pb2.EnvironmentUpdateRequest(current_name=name, name=new_name),
        )

    synchronizer.run(go(client))
    click.echo(f"renamed environment {name} -> {new_name}")


@environment_group.command("delete")
@click.argument("name")
@click.confirmation_option(prompt="Delete this environment?")
def environment_delete(name: str) -> None:
    from .._utils.grpc_utils import retry_transient_errors
    from ..proto import api_pb2

    client = _client()

    async def go(c):
        await retry_transient_errors(
            c.stub.EnvironmentDelete, api_pb2.EnvironmentDeleteRequest(name=name)
        )

    synchronizer.run(go(client))
    click.echo(f"deleted environment {name}")


@cli.group("image")
def image_group() -> None:
    """Manage built images (reference cli/image.py)."""


@image_group.command("list")
def image_list() -> None:
    from .._utils.grpc_utils import retry_transient_errors
    from ..proto import api_pb2

    client = _client()

    async def go(c):
        return await retry_transient_errors(c.stub.ImageList, api_pb2.ImageListRequest())

    resp = synchronizer.run(go(client))
    for img in resp.images:
        status = "built" if img.built else "pending"
        click.echo(
            f"{img.image_id}  {status:8s} {_fmt_ts(img.created_at)}  "
            f"builder={img.builder_version or '-'} refs={img.ref_count}"
        )


@image_group.command("prune")
@click.option("--yes", is_flag=True, help="Skip the confirmation prompt.")
def image_prune(yes: bool) -> None:
    """Delete image records not referenced by any live container."""
    from .._utils.grpc_utils import retry_transient_errors
    from ..proto import api_pb2

    client = _client()

    async def go(c):
        resp = await retry_transient_errors(c.stub.ImageList, api_pb2.ImageListRequest())
        victims = []
        for img in resp.images:
            if img.ref_count:
                continue
            try:
                await retry_transient_errors(
                    c.stub.ImageDelete, api_pb2.ImageDeleteRequest(image_id=img.image_id)
                )
                victims.append(img.image_id)
            except Exception:  # noqa: BLE001 — pinned between list and delete
                pass
        return victims

    if not yes:
        click.confirm("Delete all unreferenced images?", abort=True)
    victims = synchronizer.run(go(client))
    click.echo(f"pruned {len(victims)} image(s)")


@image_group.command("prebuild")
@click.option("--builder-version", default=None, help="epoch to build bases for (default: active)")
def image_prebuild(builder_version: Optional[str]) -> None:
    """Pre-build the published base images (reference modal_global_objects):
    later apps start on a warm venv instead of building one mid-cold-start."""
    from ..global_objects import publish_base_images

    image_ids = publish_base_images(builder_version)
    for image_id in image_ids:
        click.echo(f"prebuilt {image_id}")


@cli.group("nfs")
def nfs_group() -> None:
    """Manage network file systems (alias of volumes — reference marks NFS
    legacy; ours is a declared thin alias, network_file_system.py)."""


def _alias_volume_command(name: str) -> None:
    src = volume_group.commands[name]
    nfs_group.add_command(
        click.Command(
            name,
            params=src.params,
            callback=src.callback,
            help=src.help,
            short_help=src.short_help,
        )
    )


for _cmd in ("list", "create", "delete", "ls", "put", "get", "rm"):
    _alias_volume_command(_cmd)


@cli.command("curl", context_settings={"ignore_unknown_options": True})
@click.argument("target")
@click.argument("curl_args", nargs=-1, type=click.UNPROCESSED)
def curl_cmd(target: str, curl_args: tuple[str, ...]) -> None:
    """HTTP request against a web endpoint (reference cli/curl.py).

    TARGET is either a full URL or an `app-name/function-name` ref, which
    resolves to the deployed function's web URL (long-polling while its
    serving container boots). Remaining arguments pass through to system
    curl, e.g.:  python -m modal_tpu_torch.cli curl my-app/hello -X POST -d '{"x": 1}'
    """
    import subprocess

    if target.startswith("http://") or target.startswith("https://"):
        url = target
    else:
        app_name, sep, fn_name = target.partition("/")
        if not sep or not fn_name:
            raise click.UsageError("target must be a URL or app-name/function-name")
        from ..functions import Function

        fn = Function.from_name(app_name, fn_name)
        fn.hydrate()
        url = fn.get_web_url()
    raise SystemExit(subprocess.call(["curl", "-sS", url, *curl_args]))


@cli.group("launch")
def launch_group() -> None:
    """Open a prebuilt interactive app (reference cli/launch.py)."""


@launch_group.command("python")
@click.option("--gpu", default=None, help="Card for the REPL's container, e.g. H100.")
@_refuse_tpu_option
def launch_python(gpu: Optional[str]) -> None:
    """Interactive Python REPL inside a fresh (optionally card-pinned)
    container: `torch.cuda.device_count()` in the REPL sees the pinned
    card."""
    from .._utils.pty_shell import run_pty_session
    from ..sandbox import Sandbox

    sb = Sandbox.create("sleep", "86400", gpu=gpu, timeout=86400)
    try:
        if sys.stdin.isatty():
            raise SystemExit(run_pty_session(sb, [sys.executable, "-i"]))
        # piped stdin: run the code through the REPL non-interactively
        code = sys.stdin.read()
        p = sb.exec(sys.executable, "-c", code)
        rc = p.wait()
        sys.stdout.write(p.stdout.read())
        sys.stderr.write(p.stderr.read())
        raise SystemExit(rc)
    finally:
        sb.terminate()


@launch_group.command("jupyter")
@click.option("--gpu", default=None, help="Card for the server's container.")
@_refuse_tpu_option
@click.option("--port", default=8888, help="Port jupyter binds inside the container.")
def launch_jupyter(gpu: Optional[str], port: int) -> None:
    """Jupyter Lab in a container with a tunnel back to this machine
    (reference cli/programs/run_jupyter.py). Requires jupyterlab in the
    container image — fails loudly when absent."""
    from ..sandbox import Sandbox

    # keep-alive entrypoint; jupyter starts via exec AFTER the import probe —
    # probing a dead sandbox (jupyter-as-entrypoint crashing instantly) would
    # bury the real problem under a router error
    sb = Sandbox.create("sleep", "86400", gpu=gpu, timeout=86400, unencrypted_ports=[port])
    try:
        probe = sb.exec(sys.executable, "-c", "import jupyterlab")
        if probe.wait() != 0:
            raise click.ClickException(
                "jupyterlab is not importable in this image — add "
                "`.pip_install('jupyterlab')` to the image (no network egress "
                "in local dev means the base image must already carry it)"
            )
        server = sb.exec(
            sys.executable, "-m", "jupyterlab",
            "--allow-root", "--ip=0.0.0.0", f"--port={port}", "--no-browser",
        )
        tunnels = sb.tunnels()
        url = tunnels[port].url if port in tunnels else "(no tunnel reported)"
        click.echo(f"Jupyter Lab: {url}  (Ctrl-C stops the sandbox)")
        server.wait()
    except KeyboardInterrupt:
        pass
    finally:
        sb.terminate()


@cli.group("workspace")
def workspace_group() -> None:
    """Workspace identity, members, and settings."""


@workspace_group.command("current")
def workspace_current() -> None:
    from ..workspace import Workspace

    ws = Workspace.from_context()
    ws.hydrate()
    click.echo(ws.name or "local")


@workspace_group.command("members")
def workspace_members() -> None:
    from ..workspace import Workspace

    ws = Workspace.from_context()
    ws.hydrate()
    for m in ws.members.list():
        click.echo(f"{m.username}  {m.role:<7}  {_fmt_ts(m.created_at)}")


@workspace_group.command("settings")
def workspace_settings() -> None:
    from ..workspace import Workspace

    ws = Workspace.from_context()
    ws.hydrate()
    settings = ws.settings.list()
    if not settings:
        click.echo("(no workspace settings set)")
    for k, v in sorted(settings.items()):
        click.echo(f"{k} = {v}")


@workspace_group.command("set")
@click.argument("name")
@click.argument("value")
def workspace_set(name: str, value: str) -> None:
    from ..workspace import Workspace

    ws = Workspace.from_context()
    ws.hydrate()
    ws.settings.set(name, value)
    click.echo(f"set {name} = {value}")


@cli.group("token")
def token_group() -> None:
    """Manage credentials."""


@token_group.command("set")
@click.option("--token-id", required=True)
@click.option("--token-secret", required=True)
@click.option("--profile", default=None)
def token_set(token_id: str, token_secret: str, profile: Optional[str]) -> None:
    _store_user_config({"token_id": token_id, "token_secret": token_secret}, profile)
    click.echo("token stored")


@token_group.command("new")
@click.option("--profile", default=None)
@click.option("--no-browser", is_flag=True, help="print the auth URL instead of opening a browser")
@click.option("--headless", is_flag=True, help="skip the browser leg entirely (local immediate grant)")
@click.option("--timeout", default=300.0, help="seconds to wait for browser approval")
def token_new(profile: Optional[str], no_browser: bool, headless: bool, timeout: float) -> None:
    """Issue new credentials via the browser flow (reference token_flow.py:1):
    opens the control plane's auth page; the CLI polls until the page is
    visited with the verification code, then stores the granted token."""
    from .._utils.grpc_utils import retry_transient_errors
    from ..proto import api_pb2

    client = _client()

    async def create(c):
        return await retry_transient_errors(c.stub.TokenFlowCreate, api_pb2.TokenFlowCreateRequest())

    flow = synchronizer.run(create(client))
    use_browser = not headless and flow.web_url.startswith("http")
    if use_browser:
        click.echo(f"Complete authentication in your browser:\n  {flow.web_url}")
        click.echo(f"Verification code: {flow.code}")
        if not no_browser:
            import webbrowser

            webbrowser.open(flow.web_url)

    if use_browser and timeout <= 0:
        raise click.ClickException("--timeout must be > 0 for the browser flow (or pass --headless)")

    async def wait(c):
        deadline = time.time() + timeout
        while True:
            # browser mode must never send timeout=0 — the server reads 0 as
            # the headless immediate grant, which would skip approval
            step = min(5.0, max(0.5, deadline - time.time())) if use_browser else 0.0
            resp = await retry_transient_errors(
                c.stub.TokenFlowWait,
                api_pb2.TokenFlowWaitRequest(token_flow_id=flow.token_flow_id, timeout=step),
            )
            if not resp.timeout:
                return resp
            if time.time() >= deadline:
                raise click.ClickException("token flow timed out waiting for browser approval")

    resp = synchronizer.run(wait(client))
    _store_user_config({"token_id": resp.token_id, "token_secret": resp.token_secret}, profile)
    click.echo(f"token stored for workspace {resp.workspace_name!r}")


def main() -> None:
    try:
        cli(standalone_mode=False)
    except click.exceptions.Abort:
        sys.exit(1)
    except click.ClickException as exc:
        exc.show()
        sys.exit(exc.exit_code)
    except Error as exc:
        click.echo(f"error: {exc}", err=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
