"""Chaos injection: one seeded policy for every layer of the plane (port of
modal_tpu/chaos.py).

`LocalSupervisor` attaches one ChaosPolicy to the control-plane servicer
and the input plane (through `ChaosServicerProxy`), the blob server's HTTP
routes, the servicer's output stream, the warm pool's handoff, each
worker's heartbeats and the follower side of journal replication, so a
single policy object drives faults across the plane, reproducibly by seed.
A sharded plane (server/shards.py) owns the shard and director events and
hands each shard an event-less clone.

Determinism: every RPC name gets its own PRNG stream seeded with
``(seed, rpc_name)``. The k-th call of an RPC draws the same decision
however calls to other RPCs interleave, so asyncio's scheduling cannot
change the injected sequence. ``fault_log`` records ``"RpcName#k"``
entries, so two runs with one seed (and the same per-RPC call counts)
compare directly, and the JAX package's policy gives the same log.

Fault classes:
- rate faults: a per-RPC (or default) probability of aborting UNAVAILABLE
  before the handler runs;
- latency: a per-call extra delay drawn from the same stream;
- budgeted faults: named counters that fail the next N calls of an RPC
  family across both planes (``fail_put_inputs`` covers FunctionPutInputs,
  FunctionMap, MapStartOrContinue and AttemptStart), and the lifecycle
  knobs a component drains itself (``warm_kill_handoff``, ``stream_reset``
  and the follower's ``repl_torn_tail``, ``repl_disk_full`` and
  ``repl_ack_drop``);
- scheduled events: one-shot ``supervisor_crash``, ``worker_kill``,
  ``worker_preempt`` and ``heartbeat_blackhole`` events, and the sharded
  plane's ``shard_kill``, ``shard_partition`` and ``director_blackhole``,
  that fire once N outputs exist (the output count is the deterministic
  clock of a map).
"""

from __future__ import annotations

import asyncio
import os
import random
import time
from dataclasses import dataclass
from typing import Optional

from .config import logger
from .exception import InvalidError

# A budgeted knob fails the next N calls of every RPC in its family.
# FunctionExchange is FunctionGetInputs and FunctionPutOutputs in one
# turnaround, so both turnaround knobs cover it.
KNOB_RPCS: dict[str, frozenset] = {
    "fail_get_inputs": frozenset({"FunctionGetInputs", "FunctionExchange"}),
    "fail_put_outputs": frozenset({"FunctionPutOutputs", "FunctionExchange"}),
    "fail_put_inputs": frozenset({"FunctionPutInputs", "FunctionMap", "MapStartOrContinue", "AttemptStart"}),
    "fail_get_outputs": frozenset({"FunctionGetOutputs", "MapAwait", "AttemptAwait"}),
}

HEARTBEAT_RPCS = frozenset({"ContainerHeartbeat", "WorkerHeartbeat"})

# Lifecycle knobs, drained by the component they target.
# warm_kill_handoff: the warm pool SIGKILLs the parked interpreter right
# after the handoff payload is queued; the ack never lands and the
# placement falls back to a fresh spawn. stream_reset: FunctionStreamOutputs
# aborts UNAVAILABLE mid-stream; the client degrades to the unary poll rung
# and the call completes exactly once.
# repl_torn_tail / repl_disk_full / repl_ack_drop: the replica store
# (server/replication.py) writes half a record line, refuses an append, or
# appends durably and drops the ack, for its next N appends.
LIFECYCLE_KNOBS = frozenset(
    {"warm_kill_handoff", "stream_reset", "repl_torn_tail", "repl_disk_full", "repl_ack_drop"}
)

# HTTP blob routes are injected under pseudo-RPC names, so one policy and
# one rate table cover the gRPC and HTTP planes alike.
BLOB_RPCS = frozenset(
    {"BlobPut", "BlobGet", "BlobPutPart", "BlobComplete", "BlockGet", "VolumeFileGet"}
)

EVENT_KINDS = frozenset(
    {
        "supervisor_crash",
        "worker_kill",
        "worker_preempt",
        "heartbeat_blackhole",
        "shard_kill",
        "shard_partition",
        "director_blackhole",
    }
)


@dataclass
class ChaosEvent:
    """One-shot lifecycle fault, fired once `after_outputs` outputs exist.

    kinds: ``worker_preempt`` (graceful drain: SIGTERM and a grace window,
    inputs requeued, checkpoint flush), ``worker_kill`` (SIGKILL the
    worker's containers, no grace), ``heartbeat_blackhole`` (drop heartbeat
    RPCs for `duration_s`), ``supervisor_crash`` (abandon the control
    plane's state and rebuild it from the journal, server/journal.py),
    ``shard_kill`` (kill shard `shard_index` with no drain and no flush; the
    director's health loop takes its partition over, server/shards.py),
    ``shard_partition`` (cut shard `shard_index` off the director's health
    probes for `duration_s` while it keeps running: a false death, fenced
    before its partition is adopted) and ``director_blackhole`` (the
    director drops the RPCs it routes for `duration_s`; clients ride their
    shard map and retries).
    """

    kind: str
    after_outputs: int = 0
    worker_index: int = 0
    grace_s: float = 5.0
    duration_s: float = 10.0
    shard_index: int = 0  # target shard for shard_kill/shard_partition
    fired: bool = False


class ChaosPolicy:
    """Seeded, layer-agnostic fault policy. All mutation happens on the
    supervisor's event loop."""

    def __init__(
        self,
        seed: int = 0,
        *,
        error_rates: Optional[dict[str, float]] = None,
        default_error_rate: float = 0.0,
        latency_ms: float = 0.0,
        latency_jitter_ms: float = 0.0,
        latency_rate: float = 1.0,
        events: Optional[list[ChaosEvent]] = None,
        max_faults: Optional[int] = None,
    ):
        for ev in events or ():
            if ev.kind not in EVENT_KINDS:
                raise InvalidError(f"unknown chaos event kind {ev.kind!r} (have {sorted(EVENT_KINDS)})")
        self.seed = seed
        self.error_rates = dict(error_rates or {})
        self.default_error_rate = default_error_rate
        self.latency_ms = latency_ms
        self.latency_jitter_ms = latency_jitter_ms
        self.latency_rate = latency_rate
        self.events = list(events or [])
        self.max_faults = max_faults
        # budgeted one-shot faults
        self.fail_counts: dict[str, int] = {}
        # extra delay before each replicated append batch (the writer side
        # of server/replication.py): stresses the quorum commit's timeout
        self.repl_lag_ms = 0.0
        # observability
        self.call_counts: dict[str, int] = {}
        self.injected: dict[str, int] = {}
        self.fault_log: list[str] = []
        self.outputs_seen = 0
        self._blackhole_until = 0.0
        self._streams: dict[str, random.Random] = {}
        self._total_injected = 0

    # -- configuration ------------------------------------------------------

    @classmethod
    def from_env(cls) -> Optional["ChaosPolicy"]:
        """The policy the environment asks for (the JAX package's variables):

        - MODAL_TPU_CHAOS=1 enables
        - MODAL_TPU_CHAOS_SEED (int, default 0)
        - MODAL_TPU_CHAOS_ERROR_RATE (float, default rate for every RPC)
        - MODAL_TPU_CHAOS_RPCS ("Name=0.05,Other=0.1", or "Name,Other" at
          the default rate)
        - MODAL_TPU_CHAOS_LATENCY_MS / _LATENCY_JITTER_MS / _LATENCY_RATE
        - MODAL_TPU_CHAOS_SUPERVISOR_CRASH_AFTER (int N: crash the control
          plane and recover it from the journal once N outputs exist;
          comma-separated for repeated crashes, e.g. "10,30")
        - MODAL_TPU_CHAOS_WARM_KILL_HANDOFF (int N: kill the next N warm-pool
          interpreters mid-handoff; the placements fall back to fresh spawns)
        - MODAL_TPU_CHAOS_STREAM_RESETS (int N: abort the next N
          FunctionStreamOutputs streams mid-flight)
        - MODAL_TPU_CHAOS_SHARD_KILL_AFTER ("shard:outputs" pairs, e.g.
          "1:50,2:200": kill shard 1 after 50 outputs, shard 2 after 200; a
          bare int targets shard 1)
        - MODAL_TPU_CHAOS_SHARD_PARTITION ("shard:outputs[:duration_s]": cut
          the shard off the director's health probes; it stays alive)
        - MODAL_TPU_CHAOS_REPL_TORN_TAIL / _REPL_DISK_FULL / _REPL_ACK_DROP
          (int N: budgeted follower-side replication faults)
        - MODAL_TPU_CHAOS_REPL_LAG_MS (float: extra delay before every
          replicated append batch)
        """
        if os.environ.get("MODAL_TPU_CHAOS", "") not in ("1", "true", "yes"):
            return None
        events: list[ChaosEvent] = []
        for part in filter(
            None,
            (p.strip() for p in os.environ.get("MODAL_TPU_CHAOS_SUPERVISOR_CRASH_AFTER", "").split(",")),
        ):
            try:
                events.append(ChaosEvent(kind="supervisor_crash", after_outputs=int(part)))
            except ValueError:
                # a typo'd knob must not kill the supervisor at boot
                logger.warning(
                    f"ignoring malformed MODAL_TPU_CHAOS_SUPERVISOR_CRASH_AFTER token {part!r}"
                )
        for env_name, kind in (
            ("MODAL_TPU_CHAOS_SHARD_KILL_AFTER", "shard_kill"),
            ("MODAL_TPU_CHAOS_SHARD_PARTITION", "shard_partition"),
        ):
            for part in filter(None, (p.strip() for p in os.environ.get(env_name, "").split(","))):
                try:
                    pieces = part.split(":")
                    if len(pieces) == 1:
                        shard, after, duration = 1, int(pieces[0]), 10.0
                    else:
                        shard, after = int(pieces[0]), int(pieces[1])
                        duration = float(pieces[2]) if len(pieces) > 2 else 10.0
                    events.append(
                        ChaosEvent(kind=kind, after_outputs=after, shard_index=shard, duration_s=duration)
                    )
                except ValueError:
                    logger.warning(f"ignoring malformed {env_name} token {part!r}")
        default_rate = float(os.environ.get("MODAL_TPU_CHAOS_ERROR_RATE", "0") or 0)
        rates: dict[str, float] = {}
        spec = os.environ.get("MODAL_TPU_CHAOS_RPCS", "")
        apply_default = not spec  # a bare default rate applies everywhere
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" in part:
                name, _, rate = part.partition("=")
                rates[name.strip()] = float(rate)
            else:
                rates[part] = default_rate
        policy = cls(
            seed=int(os.environ.get("MODAL_TPU_CHAOS_SEED", "0") or 0),
            error_rates=rates,
            default_error_rate=default_rate if apply_default else 0.0,
            latency_ms=float(os.environ.get("MODAL_TPU_CHAOS_LATENCY_MS", "0") or 0),
            latency_jitter_ms=float(os.environ.get("MODAL_TPU_CHAOS_LATENCY_JITTER_MS", "0") or 0),
            latency_rate=float(os.environ.get("MODAL_TPU_CHAOS_LATENCY_RATE", "1") or 1),
            events=events,
        )
        for env_name, knob in (
            ("MODAL_TPU_CHAOS_WARM_KILL_HANDOFF", "warm_kill_handoff"),
            ("MODAL_TPU_CHAOS_STREAM_RESETS", "stream_reset"),
            ("MODAL_TPU_CHAOS_REPL_TORN_TAIL", "repl_torn_tail"),
            ("MODAL_TPU_CHAOS_REPL_DISK_FULL", "repl_disk_full"),
            ("MODAL_TPU_CHAOS_REPL_ACK_DROP", "repl_ack_drop"),
        ):
            try:
                budget = int(os.environ.get(env_name, "0") or 0)
            except ValueError:
                budget = 0
                logger.warning(f"ignoring malformed {env_name}")
            if budget > 0:
                policy.fail_counts[knob] = budget
        try:
            policy.repl_lag_ms = max(0.0, float(os.environ.get("MODAL_TPU_CHAOS_REPL_LAG_MS", "0") or 0))
        except ValueError:
            logger.warning("ignoring malformed MODAL_TPU_CHAOS_REPL_LAG_MS")
        return policy

    # -- deterministic decision engine --------------------------------------

    def _stream(self, rpc: str) -> random.Random:
        stream = self._streams.get(rpc)
        if stream is None:
            stream = self._streams[rpc] = random.Random(f"{self.seed}:{rpc}")
        return stream

    def decide(self, rpc: str) -> tuple[float, bool]:
        """(extra_delay_s, inject_fault) for the next call of `rpc`.

        Draw order per call is fixed (latency draw, then fault draw) so the
        per-RPC stream stays aligned across runs with the same config.
        """
        n = self.call_counts.get(rpc, 0)
        self.call_counts[rpc] = n + 1
        stream = self._stream(rpc)
        delay = 0.0
        if self.latency_ms > 0:
            roll = stream.random()
            if roll < self.latency_rate:
                delay = (self.latency_ms + stream.random() * self.latency_jitter_ms) / 1000.0
                from .observability.catalog import CHAOS_INJECTIONS

                CHAOS_INJECTIONS.inc(rpc=rpc, kind="latency")
        # budgeted knobs outrank rates and are NOT drawn from the stream
        # (hand-set counters must not perturb seeded reproducibility)
        for knob, rpcs in KNOB_RPCS.items():
            if rpc in rpcs and self.fail_counts.get(knob, 0) > 0:
                self.fail_counts[knob] -= 1
                self._note_fault(rpc, n, f"{knob} budget")
                return delay, True
        if rpc in HEARTBEAT_RPCS and self.heartbeat_blackholed():
            self._note_fault(rpc, n, "heartbeat blackhole")
            return delay, True
        rate = self.error_rates.get(rpc, self.default_error_rate)
        if rate > 0 and (self.max_faults is None or self._total_injected < self.max_faults):
            if stream.random() < rate:
                self._note_fault(rpc, n, f"rate {rate}")
                return delay, True
        return delay, False

    def _note_fault(self, rpc: str, call_index: int, why: str) -> None:
        self.injected[rpc] = self.injected.get(rpc, 0) + 1
        self._total_injected += 1
        self.fault_log.append(f"{rpc}#{call_index}")
        # every injection is a per-RPC counter sample and (for a traced
        # call) an event on the current server span
        from .observability import tracing
        from .observability.catalog import CHAOS_INJECTIONS

        CHAOS_INJECTIONS.inc(rpc=rpc, kind="error")
        tracing.add_event("chaos.injected", rpc=rpc, call_index=call_index, why=why, seed=self.seed)
        logger.debug(f"chaos: injecting UNAVAILABLE into {rpc} call {call_index} ({why})")

    # -- injection helpers (one per transport) ------------------------------

    async def inject_grpc(self, rpc: str, context) -> None:
        """Server-side gRPC hook: sleep the injected latency, then abort
        UNAVAILABLE if this call drew a fault."""
        delay, fail = self.decide(rpc)
        if delay > 0:
            await asyncio.sleep(delay)
        if fail:
            import grpc

            await context.abort(grpc.StatusCode.UNAVAILABLE, f"chaos: injected fault in {rpc}")

    async def inject_http(self, route: str):
        """Blob-server hook: an aiohttp 503 Response to send instead of
        handling the request, or None to proceed."""
        delay, fail = self.decide(route)
        if delay > 0:
            await asyncio.sleep(delay)
        if fail:
            from aiohttp import web

            return web.Response(status=503, text=f"chaos: injected fault in {route}")
        return None

    # -- heartbeat blackhole -------------------------------------------------

    def start_heartbeat_blackhole(self, duration_s: float) -> None:
        self._blackhole_until = time.monotonic() + duration_s
        logger.warning(f"chaos: heartbeat blackhole for {duration_s}s")

    def heartbeat_blackholed(self) -> bool:
        return time.monotonic() < self._blackhole_until

    # -- scheduled lifecycle events ------------------------------------------

    def note_outputs(self, n: int) -> None:
        self.outputs_seen += n

    def pop_due_events(self) -> list[ChaosEvent]:
        due = []
        for ev in self.events:
            if not ev.fired and self.outputs_seen >= ev.after_outputs:
                ev.fired = True
                due.append(ev)
        if due:
            from .observability.catalog import CHAOS_EVENTS

            for ev in due:
                CHAOS_EVENTS.inc(kind=ev.kind)
        return due

    # -- the knob surface ------------------------------------------------------

    def set_knob(self, knob: str, count: int) -> None:
        if knob not in KNOB_RPCS and knob not in LIFECYCLE_KNOBS:
            raise KeyError(
                f"unknown chaos knob {knob!r} (have {sorted(KNOB_RPCS) + sorted(LIFECYCLE_KNOBS)})"
            )
        self.fail_counts[knob] = count

    def get_knob(self, knob: str) -> int:
        return self.fail_counts.get(knob, 0)

    def consume_knob(self, knob: str) -> bool:
        """Drain one charge of a budgeted lifecycle knob; True = the
        component injects its fault now."""
        if self.fail_counts.get(knob, 0) <= 0:
            return False
        self.fail_counts[knob] -= 1
        self._note_fault(knob, self.call_counts.get(knob, 0), f"{knob} budget")
        self.call_counts[knob] = self.call_counts.get(knob, 0) + 1
        return True


class ChaosServicerProxy:
    """Wraps a gRPC servicer at the generic-handler boundary: every RPC the
    servicer defines passes through `policy.inject_grpc` first. The
    servicer itself stays clean (the scheduler, tests and the supervisor
    keep talking to it). Published outputs are the clock of the scheduled
    events: those of FunctionPutOutputs, and those a FunctionExchange
    carries (the JAX package counts FunctionPutOutputs only, so there an
    output that rides an exchange does not advance the clock)."""

    def __init__(self, servicer, policy: ChaosPolicy):
        self._servicer = servicer
        self._policy = policy

    def __getattr__(self, name: str):
        import inspect

        impl = getattr(self._servicer, name)
        if name.startswith("_") or not callable(impl):
            return impl
        if inspect.isasyncgenfunction(impl):

            async def stream_wrapped(request, context, _impl=impl, _name=name):
                await self._policy.inject_grpc(_name, context)
                async for item in _impl(request, context):
                    yield item

            return stream_wrapped
        if inspect.iscoroutinefunction(impl):

            async def unary_wrapped(request, context, _impl=impl, _name=name):
                await self._policy.inject_grpc(_name, context)
                resp = await _impl(request, context)
                if _name == "FunctionPutOutputs":
                    self._policy.note_outputs(len(request.outputs))
                elif _name == "FunctionExchange" and request.HasField("put"):
                    self._policy.note_outputs(len(request.put.outputs))
                return resp

            return unary_wrapped
        return impl


__all__ = [
    "ChaosPolicy",
    "ChaosEvent",
    "ChaosServicerProxy",
    "KNOB_RPCS",
    "HEARTBEAT_RPCS",
    "BLOB_RPCS",
]
