"""Critical-path latency attribution over the span store (port of
modal_tpu/observability/critical_path.py; the rules, the sweep and the
aggregate are the JAX package's, so both give the same numbers on the same
spans).

Every span name maps to a named segment with a priority (`SEGMENT_RULES`).
A trace's root interval (`function.call`, or the earliest root span) is
swept instant by instant, and each instant goes to the highest-priority
segment whose span covers it: the part of a client's `FunctionGetOutputs`
long poll that overlaps `user.execute` counts as user time, and only the
rest counts as output delivery. Wall time that no span covers is the
``gap`` segment: the attribution never claims full coverage on its own
(the bar: gap at most 10% of a no-op call).

Surfaces: ``python -m modal_tpu_torch.cli app attribute <needle>`` and
``app trace --critical-path``.
"""

from __future__ import annotations

from typing import Optional

# span-name rule -> (segment, priority). Rules ending in '*' are prefix
# matches. Higher priority wins where spans overlap in time. The segment
# order tells the dispatch story: queue_wait → place → handoff → serialize →
# rpc → user.execute → output delivery. The rules are the JAX package's; the
# port's own span names (catalog.SPAN_CATALOG says which, and where each
# one counts) have none, so each counts as the span that covers it.
SEGMENT_RULES: list[tuple[str, str, int]] = [
    ("user.execute", "user.execute", 90),
    ("container.imports", "container.imports", 80),
    ("container.enter_hooks", "container.enter_hooks", 80),
    ("container.boot", "container.boot", 70),
    ("coldstart.handoff", "handoff", 60),
    ("coldstart.preimport", "container.boot", 60),
    ("coldstart.preinit", "container.boot", 60),
    ("image.build", "image.build", 60),
    ("worker.launch_task", "handoff", 55),
    ("scheduler.place", "place", 50),
    ("scheduler.queue_wait", "queue_wait", 50),
    ("client.serialize", "serialize", 45),
    ("client.deserialize", "deserialize", 45),
    # anchored at the server's claim stamp (io_manager): covers
    # claim→user.execute, the true delivery cost
    ("container.input_deliver", "input_deliver", 40),
    ("recovery.*", "recovery", 38),
    ("rpc.server.*", "rpc.server", 30),
    ("rpc.client.FunctionGetOutputs", "output_deliver", 20),
    ("rpc.client.FunctionStreamOutputs", "output_deliver", 20),
    ("rpc.client.AttemptAwait", "output_deliver", 20),
    ("rpc.client.MapAwait", "output_deliver", 20),
    # push-streamed delivery: the client-side wait on the
    # keep-alive outputs stream — same segment as the poll it replaced
    ("client.stream_outputs", "output_deliver", 20),
    # the coalescing window's enqueue→flush wait (_utils/coalescer.py):
    # named so batching delay shows up as itself, not as gap/prepare
    ("dispatch.coalesce", "coalesce", 28),
    ("rpc.client.*", "rpc.client", 25),
    # SDK residue around the RPCs: stub/token prep and the output-wait loop;
    # lowest priorities, so they claim only what nothing else explains. The
    # port's two spans tile their root (functions.traced_call):
    # `client.await_output` starts at `client.prepare`'s end stamp, so
    # `output_deliver` also holds the SDK's own write of the prepare span
    # and whatever time the process gave other threads between the two
    ("client.prepare", "client.prepare", 12),
    ("client.await_output", "output_deliver", 11),
]

ROOT_SPAN = "function.call"
GAP = "gap"

# -- serving ruleset ----------------------------------------------------------
# Per-request serving timelines root at `serving.request` (engine.submit)
# and decompose TTFT / per-token latency into queue → prefill → decode →
# stream. Priorities: prefill chunks (device compute) over the blanket
# prefill span over decode marks over the SSE stream span (which covers the
# whole delivery and must claim only what compute doesn't explain).
SERVING_ROOT_SPAN = "serving.request"
SERVING_SEGMENT_RULES: list[tuple[str, str, int]] = [
    ("serving.preempt", "requeue", 80),
    ("serving.prefill_chunk", "prefill", 65),
    ("serving.decode", "decode", 55),
    ("serving.admit", "queue", 50),
    ("serving.prefill", "prefill", 45),
    ("serving.stream", "stream", 20),
]


def segment_for(
    name: str, rules: Optional[list[tuple[str, str, int]]] = None
) -> Optional[tuple[str, int]]:
    for rule, segment, priority in (rules if rules is not None else SEGMENT_RULES):
        if rule.endswith("*"):
            if name.startswith(rule[:-1]):
                return segment, priority
        elif name == rule:
            return segment, priority
    return None


# -- tree reconstruction ------------------------------------------------------


def normalize_starts(spans: list[dict]) -> dict[str, float]:
    """Per-span normalized start: a child never starts before its parent.
    Cross-process wall clocks skew by milliseconds; within a process the
    recorded monotonic stamp (`mono`) preserves creation order. Returns
    {span_id: normalized_start}. Shared with the `app trace` waterfall
    (the ordering-fix satellite)."""
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}
    norm: dict[str, float] = {}

    def _norm(s: dict, visiting: set) -> float:
        sid = s["span_id"]
        if sid in norm:
            return norm[sid]
        start = float(s.get("start") or 0.0)
        parent = by_id.get(s.get("parent_id") or "")
        # visiting-set guard: a corrupt store with a parent cycle must not
        # recurse forever — break the cycle at the re-entry point
        if parent is not None and parent["span_id"] not in visiting and len(visiting) < 64:
            visiting.add(sid)
            start = max(start, _norm(parent, visiting))
            visiting.discard(sid)
        norm[sid] = start
        return start

    for s in by_id.values():
        _norm(s, {s["span_id"]})
    return norm


def span_depth(spans: list[dict]) -> dict[str, int]:
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}
    depths: dict[str, int] = {}

    def _depth(s: dict) -> int:
        sid = s["span_id"]
        if sid in depths:
            return depths[sid]
        d, seen = 0, {sid}
        cur = s
        while cur.get("parent_id") and cur["parent_id"] in by_id and cur["parent_id"] not in seen:
            seen.add(cur["parent_id"])
            cur = by_id[cur["parent_id"]]
            d += 1
        depths[sid] = d
        return d

    for s in by_id.values():
        _depth(s)
    return depths


def order_spans(spans: list[dict]) -> list[dict]:
    """Waterfall order: (normalized start, tree depth, raw start, mono) —
    children never sort before their parents even when process clock skew
    or equal timestamps would say otherwise."""
    norm = normalize_starts(spans)
    depths = span_depth(spans)
    return sorted(
        spans,
        key=lambda s: (
            norm.get(s.get("span_id", ""), float(s.get("start") or 0.0)),
            depths.get(s.get("span_id", ""), 0),
            float(s.get("start") or 0.0),
            float(s.get("mono") or 0.0),
        ),
    )


# -- per-trace attribution ----------------------------------------------------


def trace_root(spans: list[dict], root_span: str = ROOT_SPAN) -> Optional[dict]:
    roots = [s for s in spans if s.get("name") == root_span]
    if not roots:
        ids = {s.get("span_id") for s in spans}
        roots = [s for s in spans if not s.get("parent_id") or s["parent_id"] not in ids]
    if not roots:
        return None
    return min(roots, key=lambda s: float(s.get("start") or 0.0))


def attribute_trace(
    spans: list[dict],
    rules: Optional[list[tuple[str, str, int]]] = None,
    root_span: str = ROOT_SPAN,
) -> Optional[dict]:
    """One trace's wall-time attribution: {segment: seconds}, plus ``gap``
    (root wall time no segment covers) and ``total`` (root wall time).
    Returns None when the trace has no usable root interval. `rules` /
    `root_span` select the ruleset — the default dispatch story, or the
    serving timeline (SERVING_SEGMENT_RULES + SERVING_ROOT_SPAN)."""
    root = trace_root(spans, root_span)
    if root is None:
        return None
    norm = normalize_starts(spans)
    if root.get("name") == root_span:
        t0 = norm.get(root.get("span_id", ""), float(root.get("start") or 0.0))
        t1 = float(root.get("end") or 0.0)
    else:
        # no client root recorded (a remote client without a local span sink
        # only ships its context, not its spans): attribute over the stored
        # spans' envelope so server/container segments still account
        t0 = min(norm.get(s.get("span_id", ""), float(s.get("start") or 0.0)) for s in spans)
        t1 = max(float(s.get("end") or s.get("start") or 0.0) for s in spans)
    if t1 <= t0:
        return None

    # clip every mapped span to the root interval
    intervals: list[tuple[float, float, int, str]] = []
    for s in spans:
        mapped = segment_for(s.get("name") or "", rules)
        if mapped is None:
            continue
        segment, priority = mapped
        lo = max(norm.get(s.get("span_id", ""), float(s.get("start") or 0.0)), t0)
        hi = min(float(s.get("end") or s.get("start") or 0.0), t1)
        if hi > lo:
            intervals.append((lo, hi, priority, segment))

    # boundary sweep: attribute each elementary interval to the covering
    # segment with the highest priority (ties: later rule order irrelevant —
    # priorities are distinct per overlap class)
    bounds = sorted({t0, t1, *(lo for lo, _, _, _ in intervals), *(hi for _, hi, _, _ in intervals)})
    out: dict[str, float] = {}
    gap = 0.0
    for lo, hi in zip(bounds, bounds[1:]):
        if hi <= lo:
            continue
        best: Optional[tuple[int, str]] = None
        for ilo, ihi, priority, segment in intervals:
            if ilo <= lo and ihi >= hi and (best is None or priority > best[0]):
                best = (priority, segment)
        if best is None:
            gap += hi - lo
        else:
            out[best[1]] = out.get(best[1], 0.0) + (hi - lo)
    out[GAP] = gap
    out["total"] = t1 - t0
    return out


# -- aggregation across calls -------------------------------------------------


# the one quantile rule of the registry, the history and this aggregate
from .quantile import quantile as _quantile  # noqa: E402


def aggregate_attributions(per_trace: list[dict]) -> dict:
    """p50/p95/p99/mean per segment across calls + each segment's share of
    total attributed wall time. Input: `attribute_trace` results."""
    segments: dict[str, list[float]] = {}
    totals: list[float] = []
    for attr in per_trace:
        if not attr:
            continue
        totals.append(attr.get("total", 0.0))
        for segment, seconds in attr.items():
            if segment == "total":
                continue
            segments.setdefault(segment, []).append(seconds)
    n = len(totals)
    grand_total = sum(totals) or 1e-12
    out: dict = {"calls": n, "total_p50_s": _quantile(sorted(totals), 0.5)}
    seg_out = {}
    for segment, vals in segments.items():
        # calls missing a segment spent 0 in it — pad so quantiles compare
        padded = sorted(vals + [0.0] * (n - len(vals)))
        seg_out[segment] = {
            "p50_s": _quantile(padded, 0.5),
            "p95_s": _quantile(padded, 0.95),
            "p99_s": _quantile(padded, 0.99),
            "mean_s": sum(vals) / n if n else 0.0,
            "share": sum(vals) / grand_total,
        }
    out["segments"] = seg_out
    out["gap_share"] = seg_out.get(GAP, {}).get("share", 0.0)
    return out


SEGMENT_ORDER = [
    "queue_wait", "place", "handoff", "image.build", "container.boot",
    "container.imports", "container.enter_hooks", "serialize", "coalesce",
    "client.prepare", "rpc.client", "rpc.server", "recovery", "input_deliver",
    "user.execute", "output_deliver", "deserialize",
    # serving timeline segments (SERVING_SEGMENT_RULES), in lifecycle order
    "queue", "prefill", "decode", "requeue", "stream", GAP,
]


def format_attribution_table(agg: dict) -> str:
    """Human table for the CLI / bench output, segments in dispatch order."""
    lines = [
        f"{'segment':<22} {'p50':>9} {'p95':>9} {'p99':>9} {'mean':>9} {'share':>7}",
    ]
    segs = agg.get("segments", {})
    ordered = [s for s in SEGMENT_ORDER if s in segs]
    ordered += [s for s in sorted(segs) if s not in SEGMENT_ORDER]
    for segment in ordered:
        v = segs[segment]
        lines.append(
            f"{segment:<22} {v['p50_s']*1000:>7.1f}ms {v['p95_s']*1000:>7.1f}ms "
            f"{v['p99_s']*1000:>7.1f}ms {v['mean_s']*1000:>7.1f}ms {v['share']*100:>6.1f}%"
        )
    lines.append(
        f"{agg.get('calls', 0)} call(s), p50 total {agg.get('total_p50_s', 0.0)*1000:.1f}ms, "
        f"gap share {agg.get('gap_share', 0.0)*100:.1f}%"
    )
    return "\n".join(lines)


def attribute_store(
    trace_dir: str, needle: str = "", last: int = 0, serving: bool = False
) -> tuple[dict, list[dict]]:
    """End-to-end helper: read the span store, group by trace, attribute each
    call, aggregate. `last` keeps only the N most recent matching traces
    (0 = all). `serving=True` switches to the serving-timeline ruleset and
    considers only traces that actually carry a `serving.request` root.
    Returns (aggregate, per_trace_attributions)."""
    from . import tracing

    traces = tracing.find_traces(trace_dir, needle)
    ordered = sorted(traces.values(), key=lambda spans: min(s["start"] for s in spans))
    if serving:
        ordered = [
            spans for spans in ordered if any(s.get("name") == SERVING_ROOT_SPAN for s in spans)
        ]
    if last:
        ordered = ordered[-last:]
    rules = SERVING_SEGMENT_RULES if serving else None
    root = SERVING_ROOT_SPAN if serving else ROOT_SPAN
    per_trace = [
        a for spans in ordered if (a := attribute_trace(spans, rules=rules, root_span=root)) is not None
    ]
    return aggregate_attributions(per_trace), per_trace
