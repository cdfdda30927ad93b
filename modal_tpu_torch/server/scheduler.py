"""Scheduler: autoscaling and GPU placement (port of
modal_tpu/server/scheduler.py).

- **Autoscaling**: per function, keep `desired = clamp(backlog + buffer,
  min_containers, max_containers)` containers running; idle containers drain
  themselves after `scaledown_window` (the container input loop exits).
- **Card placement**: a task asking for N GPUs (`resources.gpu_config`) is
  pinned to N free card indices of one worker whose card type matches
  (`GPUSpec.matches_device`; a worker registered as `local-sim` takes any
  type, as the JAX package's simulated hosts take any TPU type). The worker
  hands the task `CUDA_VISIBLE_DEVICES` set to those indices.
- **Loud refusal**: a backlog whose placement no registered worker could
  ever hold (labels, or the card type and count) fails with the
  unsatisfiable-placement reason after `PLACEMENT_UNSAT_GRACE_S`.
- **Warm pools**: `min_containers` / `buffer_containers` also keep booted
  interpreters parked on the workers (at most 4 per image), sent as
  `PoolDirective` diffs on the poll stream and split across workers; a
  stopped app's image gets target 0. Among equally loaded workers, one with
  a parked interpreter wins the placement.
- **Sandboxes**: `launch_sandbox` places a sandbox's task like a function's,
  its cards from `resources.gpu_config`.
- **Schedules**: a function with a Cron or Period schedule gets one
  zero-argument input at every due tick (`_evaluate_schedule`, times from
  `cron.next_fire`); the reap tick drops finished fires
  (`_gc_scheduled_calls`).

- **Gangs** (`group_size > 1`): all ranks are reserved before any launches
  (`_launch_gang`), each on its own cards of a worker (a worker takes
  several ranks when it has the cards; the least-loaded worker first), and
  a failed launch rolls the gang back. Desired gangs are the busy ones plus
  the unclaimed backlog, capped by `max_containers` in gang units. A gang
  whose ranks the registered workers could never hold together is refused
  like any unsatisfiable card ask. Gangs never take a warm-pool
  interpreter.

- **SLO autoscaling** (`_slo_desired`): a function that declares
  `target_ttft_ms` or `target_tokens_per_replica` (an `llm_service`
  replica has no input backlog) is sized on serving telemetry instead.
  When the time-series store has TTFT observations in the fast window, the
  burn rate (windowed p95 / target) decides and sizes the step up; without
  them, each replica's last pushed report does. Down only when TTFT is well
  under target and tokens/s per replica under `SLO_SCALEDOWN_UTIL` of its
  target; one move per `SLO_SCALE_COOLDOWN_S`. A replica the cards cannot
  hold yet waits for capacity like any launch.

After a restart of the plane, journal-recovered workers take no placement
until their next heartbeat re-adopts them, and are deregistered when none
comes within `WORKER_READOPT_GRACE_S`; the reap tick also compacts the
journal (`ModalTPUServicer.maybe_compact`).
"""

from __future__ import annotations

import asyncio
import json
import os
import secrets
import time
from typing import Optional

from ..config import logger
from ..gpu_config import GPUSpec, parse_gpu_config
from ..observability import tracing
from ..observability.catalog import (
    SCHED_PLACEMENT_LATENCY,
    SCHED_QUEUE_DEPTH,
    SCHED_TASKS_LAUNCHED,
    SCHED_TASKS_REAPED,
)
from ..proto import api_pb2
from .state import ClusterState, FunctionState, ServerState, TaskState_, WorkerState

SCHEDULE_INTERVAL = 0.05
# how long a placement may look unsatisfiable before its backlog is failed
# (covers worker (re-)registration races at boot)
PLACEMENT_UNSAT_GRACE_S = 5.0
# Containers whose heartbeat is this stale are considered dead.
TASK_HEARTBEAT_TIMEOUT = 120.0
# Tasks assigned to a worker that never said ContainerHello within this window
# while their worker is gone are stranded: fail them explicitly.
TASK_LAUNCH_TIMEOUT = 60.0
# margin past a draining worker's grace window before its unreported tasks
# are force-reaped (covers a worker that died mid-drain)
DRAIN_REAP_MARGIN = 10.0
# journal-recovered workers that do not heartbeat within this window after a
# restart of the plane are deregistered (they died with, or before, the
# plane); until then they take no placements (adoption_pending)
WORKER_READOPT_GRACE_S = 30.0
# a worker registered with this type simulates its cards (tests): any card
# type matches it, and its containers see no card
LOCAL_SIM = "local-sim"

_LIVE_TASK_STATES = (
    api_pb2.TASK_STATE_QUEUED,
    api_pb2.TASK_STATE_WORKER_ASSIGNED,
    api_pb2.TASK_STATE_CREATED,
    api_pb2.TASK_STATE_ACTIVE,
    api_pb2.TASK_STATE_IDLE,
)


def gpu_spec(resources: api_pb2.Resources) -> Optional[GPUSpec]:
    """The GPUs a definition asks for, or None for a CPU task."""
    return parse_gpu_config(resources.gpu_config) if resources.gpu_config.gpu_type else None


def worker_holds(worker: WorkerState, spec: Optional[GPUSpec]) -> bool:
    """Could `worker` ever hold a task asking for `spec` (busy or not)?"""
    if spec is None:
        return True
    if worker.gpu_type != LOCAL_SIM and not spec.matches_device(worker.gpu_type):
        return False
    return worker.num_gpus >= spec.count


class Scheduler:
    def __init__(self, state: ServerState, servicer=None):
        self.s = state
        self.servicer = servicer  # for shared task-failure handling
        self._task: Optional[asyncio.Task] = None
        self._last_reap = 0.0

    def start(self) -> None:
        self._task = asyncio.create_task(self._run(), name="scheduler")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        while True:
            try:
                self.s.schedule_event.clear()
                await self._schedule_once()
                if time.time() - self._last_reap > 10.0:
                    self._last_reap = time.time()
                    await self.reap_dead_tasks()
                    self._gc_scheduled_calls()
                    if self.servicer is not None:
                        self.servicer.reap_stale_ephemerals()
                        await self.servicer.maybe_compact()
            except Exception:
                logger.exception("scheduler iteration failed")
            try:
                await asyncio.wait_for(self.s.schedule_event.wait(), timeout=1.0)
            except asyncio.TimeoutError:
                pass
            await asyncio.sleep(SCHEDULE_INTERVAL)

    async def _schedule_once(self) -> None:
        depth = 0
        for fn in self.s.functions.values():
            for iid in fn.pending:
                inp = self.s.inputs.get(iid)
                if inp is not None and inp.status == "pending":
                    depth += 1
        SCHED_QUEUE_DEPTH.set(depth)
        # warm-pool sizing: booted interpreters parked for each image that
        # a live function keeps min/buffer containers of
        desired_pools: dict[str, int] = {}
        for fn in list(self.s.functions.values()):
            app = self.s.apps.get(fn.app_id)
            if app is not None and app.done:
                continue
            try:
                await self._evaluate_schedule(fn)
            except Exception as exc:  # noqa: BLE001 — one bad schedule must
                # not halt scheduling for every other function
                if fn.next_fire_at != -1.0:
                    logger.warning(f"disabling schedule for {fn.tag}: {exc}")
                    fn.next_fire_at = -1.0
            backlog = sum(1 for iid in fn.pending if self.s.inputs[iid].status == "pending")
            group_size = fn.definition.group_size or 0
            unsat_reason = self.placement_unsatisfiable_reason(
                fn.definition.scheduler_placement, subject=fn.tag, spec=gpu_spec(fn.definition.resources),
                ranks=max(1, group_size),
            )
            if backlog > 0 and unsat_reason is not None:
                # no registered worker could EVER hold this: fail the backlog
                # loudly instead of queueing forever ("all matching workers
                # busy" is not this case). Grace window: a matching worker
                # may simply not have registered yet.
                now = time.time()
                if fn.placement_unsat_since == 0.0:
                    fn.placement_unsat_since = now
                if now - fn.placement_unsat_since < PLACEMENT_UNSAT_GRACE_S:
                    continue
                result = api_pb2.GenericResult(status=api_pb2.GENERIC_STATUS_FAILURE, exception=unsat_reason)
                logger.warning(result.exception)
                if self.servicer is not None:
                    await self.servicer._fail_pending_inputs(fn, result)
                continue
            fn.placement_unsat_since = 0.0  # satisfiable again
            settings = fn.autoscaler
            if (fn.definition.group_size or 0) <= 1:
                # gangs are excluded: a process group's state must never
                # pass to a parked interpreter
                pool_target = min(4, max(settings.min_containers, settings.buffer_containers))
                if pool_target > 0:
                    image_key = fn.definition.image_id or ""
                    desired_pools[image_key] = max(desired_pools.get(image_key, 0), pool_target)
            live = [tid for tid in fn.task_ids if self.s.tasks[tid].state in _LIVE_TASK_STATES]
            if group_size > 1:
                # one gang serves one call at a time: desired gangs are the
                # busy ones plus the unclaimed backlog (so a call that comes
                # while a gang works gets a gang of its own), capped by
                # max_containers in gang units
                live_clusters = {self.s.tasks[tid].cluster_id for tid in live if self.s.tasks[tid].cluster_id}
                busy_clusters = {
                    self.s.tasks[inp.claimed_by].cluster_id
                    for inp in self.s.inputs.values()
                    if inp.status == "claimed" and inp.claimed_by in self.s.tasks
                    and self.s.tasks[inp.claimed_by].function_id == fn.function_id
                    and self.s.tasks[inp.claimed_by].cluster_id
                }
                max_gangs = max(1, (settings.max_containers or 8) // group_size)
                for _ in range(max(0, min(backlog + len(busy_clusters), max_gangs) - len(live_clusters))):
                    if not await self._launch_gang(fn, group_size):
                        break  # short of cards now; the next tick retries
                continue
            max_containers = settings.max_containers or 8
            # a container drains max_concurrent_inputs at once: 100 pending
            # inputs at concurrency 50 need 2 containers, not 8
            max_conc = max(1, fn.definition.max_concurrent_inputs or 1)
            desired = -(-backlog // max_conc)  # ceil
            # serving functions have no input backlog: their replicas are
            # sized on the telemetry their containers push, against the
            # declared TTFT and throughput targets
            slo_desired = self._slo_desired(fn, live)
            if slo_desired is not None:
                desired = slo_desired
            # drain-time shaping from the container-reported call-time EWMA:
            # when the live fleet clears the backlog faster than a cold start
            # could help, adding containers only adds cold starts
            if desired > len(live) > 0 and fn.reported_call_time > 0:
                drain_s = backlog * fn.reported_call_time / (len(live) * max_conc)
                if drain_s <= 5.0:
                    desired = len(live)
            desired = min(desired + settings.buffer_containers, max_containers)
            desired = max(desired, settings.min_containers)
            for _ in range(max(0, desired - len(live))):
                if not await self._launch_task(fn):
                    break  # no capacity right now
        await self._sync_pool_directives(desired_pools)

    # -- the SLO autoscaler of serving functions ----------------------------

    SLO_SCALE_COOLDOWN_S = float(os.environ.get("MODAL_TPU_SLO_SCALE_COOLDOWN", "10"))
    # scale down only when both: p95 TTFT under half its target and the
    # fleet below this fraction of per-replica token capacity
    SLO_SCALEDOWN_UTIL = 0.3

    @staticmethod
    def _serving_report(task: TaskState_) -> Optional[dict]:
        """One task's last pushed serving telemetry (the raw heartbeat JSON,
        per replica, unlike the merged registry gauges), read with the
        shared `pushed_gauge` that history's replica rows use."""
        from ..observability.device_telemetry import pushed_gauge

        raw = getattr(task, "telemetry_prev_json", "")
        if not raw:
            return None
        try:
            report = json.loads(raw)
        except ValueError:
            return None
        ttft_p95 = pushed_gauge(report, "modal_tpu_serving_ttft_p95_seconds")
        tokens_per_s = pushed_gauge(report, "modal_tpu_serving_tokens_per_second")
        queue_depth = pushed_gauge(report, "modal_tpu_serving_queue_depth")
        if ttft_p95 is None and tokens_per_s is None and queue_depth is None:
            return None
        # the disaggregation role rides the push as a numeric gauge (the
        # engine's ROLE_GAUGE_VALUES, inlined: the plane never imports the
        # serving tier)
        role_code = pushed_gauge(report, "modal_tpu_serving_role")
        role = None
        if role_code is not None:
            role = {0: "both", 1: "prefill", 2: "decode"}.get(int(role_code))
        return {
            "ttft_p95_s": ttft_p95 or 0.0,
            "tokens_per_s": tokens_per_s or 0.0,
            "queue_depth": queue_depth or 0.0,
            "role": role,
        }

    def _sole_serving_function(self, fn: FunctionState) -> bool:
        """Is `fn` the only function with live serving replicas? The fleet
        TTFT histogram is unlabeled (every replica's pushes merge into it),
        so its windowed p95 belongs to one function's objective only when no
        other function has a live task pushing serving telemetry."""
        for other in self.s.functions.values():
            if other.function_id == fn.function_id:
                continue
            for tid in other.task_ids:
                task = self.s.tasks.get(tid)
                if (
                    task is not None
                    and task.state in _LIVE_TASK_STATES
                    and self._serving_report(task) is not None
                ):
                    return False
        return True

    def _ttft_burn_rate(self, fn: FunctionState, ttft_slo_s: float) -> Optional[float]:
        """The TTFT objective's burn over the store's fast window: windowed
        p95 / target. None without a store, without observations in the
        window (window membership is the staleness gate), or when another
        function serves too (the raw-report path decides then)."""
        store = getattr(self.s, "timeseries", None)
        if store is None or ttft_slo_s <= 0 or not self._sole_serving_function(fn):
            return None
        from ..observability.slo import _env_f

        fast_window = _env_f("MODAL_TPU_SLO_FAST_WINDOW_S", 60.0)
        p95 = store.hist_quantile("modal_tpu_serving_ttft_seconds", 0.95, fast_window)
        if p95 is None:
            return None
        return p95 / ttft_slo_s

    @staticmethod
    def _burn_step(burn: Optional[float]) -> int:
        """Scale-up step from the burn rate: a 10× burn adds replicas faster
        than a 1.1× one (one move per cooldown, sized by severity)."""
        if burn is None or burn < 2.0:
            return 1
        if burn < 8.0:
            return 2
        return 3

    def _slo_desired(self, fn: FunctionState, live: list[str]) -> Optional[int]:
        """Desired replica count from serving telemetry, or None when the
        function declares no SLO target (backlog autoscaling applies).

        Up when the TTFT objective burns (burn > 1, or a replica's pushed p95
        over target while traffic flows) or replicas report a queue; the
        step grows with the burn. Down when TTFT sits under half its target
        and mean tokens/s per decode replica is under SLO_SCALEDOWN_UTIL ×
        target_tokens_per_replica. One move per cooldown window."""
        settings = fn.autoscaler
        ttft_slo_s = (settings.target_ttft_ms or 0.0) / 1000.0
        tps_target = settings.target_tokens_per_replica or 0.0
        if ttft_slo_s <= 0 and tps_target <= 0:
            return None
        reports = []
        for tid in live:
            task = self.s.tasks.get(tid)
            if task is None:
                continue
            report = self._serving_report(task)
            if report is not None:
                reports.append(report)
        current = len(live)
        burn = self._ttft_burn_rate(fn, ttft_slo_s)
        if not reports and burn is None:
            return max(current, settings.min_containers, 1)
        worst_ttft = max((r["ttft_p95_s"] for r in reports), default=0.0)
        queued = sum(r["queue_depth"] for r in reports)
        total_tps = sum(r["tokens_per_s"] for r in reports)
        desired = current
        if burn is not None:
            violated = queued > 0 or burn > 1.0
            ttft_ok_for_down = burn < 0.5
        else:
            # a pushed p95 is the last window's value and goes stale when
            # requests stop: it counts only while there is traffic, or a
            # spike followed by silence would pin the fleet at its maximum
            active = queued > 0 or total_tps > 0
            violated = queued > 0 or (ttft_slo_s > 0 and worst_ttft > ttft_slo_s and active)
            ttft_ok_for_down = ttft_slo_s <= 0 or worst_ttft < 0.5 * ttft_slo_s or not active
        # prefill replicas stream no decode tokens: the utilisation counts
        # only decode-capable replicas
        n_prefill = sum(1 for r in reports if r.get("role") == "prefill")
        decode_n = max(1, current - n_prefill)
        idle = (
            ttft_ok_for_down
            and queued == 0
            and tps_target > 0
            and total_tps / decode_n < self.SLO_SCALEDOWN_UTIL * tps_target
        )
        floor = max(settings.min_containers, 1)
        ceiling = settings.max_containers or 8
        now = time.time()
        if now - fn.slo_last_scale_at >= self.SLO_SCALE_COOLDOWN_S:
            if violated:
                desired = min(current + self._burn_step(burn), max(ceiling, floor))
            elif idle:
                desired = max(current - 1, floor)
            if desired != current:
                # the cooldown is stamped only for a move that happens: a
                # clamped no-op must not delay the next step
                fn.slo_last_scale_at = now
                logger.info(
                    f"SLO autoscale {fn.tag}: {current} -> {desired} "
                    f"(burn={f'{burn:.2f}x' if burn is not None else 'n/a'} "
                    f"ttft_p95={worst_ttft * 1000:.0f}ms target={settings.target_ttft_ms:.0f}ms "
                    f"queue={queued:.0f} tokens/s={total_tps:.0f})"
                )
        return max(desired, floor)

    async def _sync_pool_directives(self, desired: dict[str, int]) -> None:
        """Send warm-pool sizing diffs to the workers (PoolDirective on the
        poll stream). A target is cluster-wide (min/buffer_containers) and
        split evenly across eligible workers, the remainder on the first;
        a removal rides as target 0 (the worker evicts that image's parked
        interpreters: the app stopped, or the image changed)."""
        eligible = sorted((w for w in self.s.workers.values() if not w.draining and not w.adoption_pending),
                          key=lambda w: w.worker_id)
        n = len(eligible)
        for i, worker in enumerate(eligible):
            sent = worker.pool_directives
            for image_id, target in desired.items():
                share = (target + n - 1 - i) // n
                prev = sent.get(image_id)
                if share > 0 and prev != share:
                    await worker.events.put(api_pb2.WorkerPollResponse(
                        pool_directive=api_pb2.PoolDirective(image_id=image_id, target=share)))
                    sent[image_id] = share
                elif share == 0 and prev is not None:
                    await worker.events.put(api_pb2.WorkerPollResponse(
                        pool_directive=api_pb2.PoolDirective(image_id=image_id, target=0)))
                    del sent[image_id]
            for image_id in [k for k in sent if k not in desired]:
                await worker.events.put(api_pb2.WorkerPollResponse(
                    pool_directive=api_pb2.PoolDirective(image_id=image_id, target=0)))
                del sent[image_id]

    async def _evaluate_schedule(self, fn: FunctionState) -> None:
        """Fire Cron/Period schedules: enqueue one zero-argument input per
        due tick."""
        sched = fn.definition.schedule
        if sched.WhichOneof("schedule_oneof") is None or fn.bound_parent:
            return
        if fn.next_fire_at == -1.0:
            return  # disabled after an evaluation error
        from .cron import next_fire

        now = time.time()
        if fn.next_fire_at == 0.0:
            fn.next_fire_at = next_fire(sched, now)
            return
        if now < fn.next_fire_at:
            return
        from ..serialization import serialize
        from .state import FunctionCallState

        call_id = self.s.make_id("fc")
        call = FunctionCallState(
            function_id=fn.function_id,
            function_call_id=call_id,
            call_type=api_pb2.FUNCTION_CALL_TYPE_UNARY,
            invocation_type=api_pb2.FUNCTION_CALL_INVOCATION_TYPE_ASYNC,
            server_originated=True,  # GC'd after completion; no client reads it
        )
        self.s.function_calls[call_id] = call
        item = api_pb2.FunctionPutInputsItem(
            idx=0, input=api_pb2.FunctionInput(args=serialize(((), {})), data_format=api_pb2.DATA_FORMAT_PICKLE)
        )
        if self.servicer is not None:
            # the call before its input (replay order): an input record
            # naming an unjournaled call would recover orphaned
            self.servicer._j("call", function_call_id=call_id, function_id=fn.function_id,
                             call_type=call.call_type, invocation_type=call.invocation_type, server_originated=True)
            self.servicer._enqueue_input(fn, call, item)
        async with fn.input_condition:
            fn.input_condition.notify_all()
        logger.debug(f"schedule fired for {fn.tag} (call {call_id})")
        fn.next_fire_at = next_fire(sched, now)

    def _gc_scheduled_calls(self) -> None:
        """Drop completed server-originated (scheduled-fire) calls and their
        inputs: no client will ever read them, and a Period(minutes=1) app
        would otherwise accumulate state forever."""
        now = time.time()
        for call_id, call in list(self.s.function_calls.items()):
            if not call.server_originated:
                continue
            if call.num_done >= call.num_inputs and now - call.created_at > 60.0:
                for input_id in call.input_ids:
                    self.s.inputs.pop(input_id, None)
                del self.s.function_calls[call_id]

    # ------------------------------------------------------------------

    @staticmethod
    def _placement_ok(worker: WorkerState, placement) -> bool:
        """Does this worker's labels satisfy the SchedulerPlacement? Empty
        constraint lists match everything."""
        if placement is None:
            return True
        if placement.regions and worker.region not in placement.regions:
            return False
        if placement.zones and worker.zone not in placement.zones:
            return False
        if placement.HasField("spot") and worker.spot != placement.spot:
            return False
        if placement.instance_types and worker.instance_type not in placement.instance_types:
            # workers that report no instance type never match an
            # instance_types constraint
            return False
        return True

    def placement_unsatisfiable_reason(
        self, placement_proto, subject: str = "", spec: Optional[GPUSpec] = None, ranks: int = 1
    ) -> Optional[str]:
        """A non-None reason means the registered workers could never take
        the placement: its labels match no worker, or the workers they match
        do not hold `spec`'s card type and count for each of `ranks` ranks
        together (each rank's cards on one worker). Callers own the grace
        window."""
        placement = self._placement_or_none(placement_proto)
        if placement is None and spec is None:
            return None
        workers = [w for w in self.s.workers.values() if self._placement_ok(w, placement)]
        holders = [w for w in workers if worker_holds(w, spec)]
        if holders and (spec is None or spec.count == 0
                        or sum(w.num_gpus // spec.count for w in holders) >= ranks):
            return None
        reason = "unsatisfiable placement" + (f" for {subject}" if subject else "")
        if not workers and placement is not None:
            return (
                reason
                + f": regions={list(placement.regions)} zones={list(placement.zones)}"
                + (f" spot={placement.spot}" if placement.HasField("spot") else "")
                + (f" instance_types={list(placement.instance_types)}" if placement.instance_types else "")
                + " matches no registered worker"
            )
        if ranks > 1:
            return reason + f": gpu={spec} for each of {ranks} ranks matches no registered worker"
        return reason + f": gpu={spec} matches no registered worker"

    @staticmethod
    def _placement_or_none(p):
        """None when the proto expresses no constraint at all."""
        if not p.regions and not p.zones and not p.HasField("spot") and not p.instance_types:
            return None
        return p

    def _pick_worker(self, spec: Optional[GPUSpec], placement=None, reserved: Optional[dict] = None,
                     rank_load: Optional[dict] = None) -> Optional[WorkerState]:
        """Least-loaded live worker with enough free matching cards that
        satisfies the placement constraints; among equals, one with a parked
        warm-pool interpreter (it serves without a fresh process boot).
        `reserved` (worker_id -> cards) and `rank_load` (worker_id -> ranks)
        count what a gang being placed has taken already."""
        reserved, rank_load = reserved or {}, rank_load or {}
        best: Optional[WorkerState] = None
        best_load = (0, 0)
        for worker in self.s.workers.values():
            if time.time() - worker.last_heartbeat > 60.0 or worker.draining:
                continue
            if worker.adoption_pending:
                # journal-recovered and not yet heard from: it may be gone
                continue
            if not self._placement_ok(worker, placement) or not worker_holds(worker, spec):
                continue
            if spec is not None and len(worker.free_gpus()) - reserved.get(worker.worker_id, 0) < spec.count:
                continue
            load = (len(worker.active_tasks) + rank_load.get(worker.worker_id, 0),
                    0 if worker.warm_pool_ready > 0 else 1)
            if best is None or load < best_load:
                best, best_load = worker, load
        return best

    def _launch_trace_context(self, fn: FunctionState) -> str:
        """Trace context of the oldest traced pending input: the launch this
        backlog caused parents its boot spans there."""
        for iid in fn.pending:
            inp = self.s.inputs.get(iid)
            if inp is not None and inp.status == "pending" and inp.trace_context:
                return inp.trace_context
        return ""

    def _claim(self, resources: api_pb2.Resources, placement_proto, worker: Optional[WorkerState] = None,
               **fields) -> Optional[TaskState_]:
        """A new task on `worker`, or else the least-loaded worker that can
        take it, its cards pinned; None when no worker has room now."""
        spec = gpu_spec(resources)
        if worker is None:
            worker = self._pick_worker(spec, placement=self._placement_or_none(placement_proto))
        if worker is None:
            return None
        task_id = self.s.make_id("ta")
        gpu_ids = worker.free_gpus()[: spec.count] if spec is not None else []
        if spec is not None and len(gpu_ids) < spec.count:
            return None  # never launch short of cards
        for g in gpu_ids:
            worker.gpus_in_use[g] = task_id
        task = TaskState_(task_id=task_id, state=api_pb2.TASK_STATE_WORKER_ASSIGNED, worker_id=worker.worker_id,
                          gpu_ids=gpu_ids, router_token=secrets.token_urlsafe(24), **fields)
        self.s.tasks[task_id] = task
        worker.active_tasks.add(task_id)
        return task

    async def _assign(self, task: TaskState_, assignment: api_pb2.TaskAssignment) -> None:
        assignment.task_id = task.task_id
        assignment.gpu_ids.extend(task.gpu_ids)
        assignment.router_token = task.router_token
        await self.s.workers[task.worker_id].events.put(api_pb2.WorkerPollResponse(assignment=assignment))

    async def _launch_task(self, fn: FunctionState, cluster: Optional[ClusterState] = None, rank: int = 0,
                           worker: Optional[WorkerState] = None) -> Optional[TaskState_]:
        t_place0 = time.time()
        task = self._claim(fn.definition.resources, fn.definition.scheduler_placement, worker=worker,
                           function_id=fn.function_id, app_id=fn.app_id, trace_context=self._launch_trace_context(fn),
                           rank=rank, cluster_id=cluster.cluster_id if cluster is not None else "")
        if task is None:
            return None
        fn.task_ids.add(task.task_id)
        args = self._container_arguments(fn, task)
        if cluster is not None:
            args.rank = rank
            args.world_size = cluster.size
        await self._assign(task, api_pb2.TaskAssignment(container_arguments=args))
        kind = "gang_member" if cluster is not None else "task"
        SCHED_TASKS_LAUNCHED.inc(kind=kind)
        SCHED_PLACEMENT_LATENCY.observe(time.time() - t_place0, kind=kind)
        tracing.record_span(
            "scheduler.place",
            start=t_place0,
            end=time.time(),
            parent=tracing.parse_context(task.trace_context),
            attrs={"task_id": task.task_id, "worker_id": task.worker_id, "function_id": fn.function_id,
                   "gpus": len(task.gpu_ids)},
        )
        logger.debug(f"scheduled task {task.task_id} for {fn.tag} on {task.worker_id} gpus={task.gpu_ids}")
        return task

    def _pick_gang_workers(self, fn: FunctionState, group_size: int) -> Optional[list[WorkerState]]:
        """A worker for each rank, or None when the cards are short now. A
        worker takes several ranks when it holds their cards (many ranks on
        one host in local runs); ranks spread over the least-loaded hosts
        first."""
        spec = gpu_spec(fn.definition.resources)
        placement = self._placement_or_none(fn.definition.scheduler_placement)
        chosen: list[WorkerState] = []
        reserved: dict[str, int] = {}
        rank_load: dict[str, int] = {}
        for _rank in range(group_size):
            w = self._pick_worker(spec, placement=placement, reserved=reserved, rank_load=rank_load)
            if w is None:
                return None
            reserved[w.worker_id] = reserved.get(w.worker_id, 0) + (spec.count if spec is not None else 0)
            rank_load[w.worker_id] = rank_load.get(w.worker_id, 0) + 1
            chosen.append(w)
        return chosen

    async def _launch_gang(self, fn: FunctionState, group_size: int) -> bool:
        """Place a gang atomically: every rank's worker is reserved before
        any launches, and a launch that fails rolls the gang back (its
        launched ranks stopped and their cards freed at once, not after the
        rendezvous times out). False when the cards are short now."""
        from .._utils.grpc_utils import find_free_port

        chosen = self._pick_gang_workers(fn, group_size)
        if chosen is None:
            return False
        cluster = ClusterState(cluster_id=self.s.make_id("cl"), function_id=fn.function_id, size=group_size,
                               coordinator_port=find_free_port())
        self.s.clusters[cluster.cluster_id] = cluster
        for rank, worker in enumerate(chosen):
            task = await self._launch_task(fn, cluster=cluster, rank=rank, worker=worker)
            if task is None:
                for tid in cluster.task_ids:
                    t = self.s.tasks[tid]
                    t.terminate = True
                    t.state = api_pb2.TASK_STATE_FAILED
                    t.finished_at = time.time()
                    w = self.s.workers.get(t.worker_id)
                    if w is not None:
                        await w.events.put(api_pb2.WorkerPollResponse(stop=api_pb2.TaskStopEvent(task_id=tid, force=True)))
                    if self.servicer is not None:
                        self.servicer._release_task(t)
                del self.s.clusters[cluster.cluster_id]
                logger.warning(f"gang allocation failed for {fn.tag}; rolled back")
                return False
            cluster.task_ids.append(task.task_id)
        return True

    async def launch_sandbox(self, sandbox) -> Optional[TaskState_]:
        """Place a sandbox's task (reference: sandboxes are on-demand
        containers; here a worker subprocess running the command), pinned to
        the cards its `gpu_config` asks for, under the same rules as a
        function's task."""
        t_place0 = time.time()
        d = sandbox.definition
        task = self._claim(d.resources, d.scheduler_placement, function_id="", app_id=sandbox.app_id)
        if task is None:
            return None
        sandbox.task_id = task.task_id
        assignment = api_pb2.TaskAssignment(sandbox_def=d, sandbox_id=sandbox.sandbox_id)
        # secrets resolve into the env on the plane's side, as a function's do
        for secret_id in d.secret_ids:
            secret = self.s.secrets.get(secret_id)
            if secret is not None:
                assignment.container_arguments.env.update(secret.env_dict)
        await self._assign(task, assignment)
        SCHED_TASKS_LAUNCHED.inc(kind="sandbox")
        SCHED_PLACEMENT_LATENCY.observe(time.time() - t_place0, kind="sandbox")
        return task

    def _container_arguments(self, fn: FunctionState, task: TaskState_) -> api_pb2.ContainerArguments:
        app = self.s.apps.get(fn.app_id)
        args = api_pb2.ContainerArguments(
            task_id=task.task_id,
            function_id=fn.function_id,
            app_id=fn.app_id,
            function_def=fn.definition,
            environment_name=app.environment_name if app else "",
        )
        # secrets resolve to env at assignment time
        for secret_id in fn.definition.secret_ids:
            secret = self.s.secrets.get(secret_id)
            if secret is not None:
                for k, v in secret.env_dict.items():
                    args.env[k] = v
        if fn.serialized_params:
            args.env["MODAL_TPU_BOUND_PARAMS"] = fn.serialized_params.hex()
        if task.trace_context:
            args.env[tracing.TRACE_CONTEXT_ENV] = task.trace_context
        if fn.definition.proxy_id:
            proxy = self.s.proxies.get(fn.definition.proxy_id)
            if proxy is not None:
                # the container's static egress address (reference ProxyInfo
                # on the task layout), exported as env here; a production
                # worker binds SNAT to it
                args.env["MODAL_TPU_PROXY_IP"] = proxy.proxy_ip
        if app is not None:
            for tag, fn_id in {**app.function_ids, **app.class_ids}.items():
                args.app_layout.objects[tag] = fn_id
        return args

    # ------------------------------------------------------------------
    # Preemption drain: stop placing on the host, requeue its claimed inputs
    # ------------------------------------------------------------------

    async def _send_stop(self, task: TaskState_, grace_s: float, preempt: bool) -> None:
        worker = self.s.workers.get(task.worker_id)
        if worker is not None:
            await worker.events.put(
                api_pb2.WorkerPollResponse(
                    stop=api_pb2.TaskStopEvent(task_id=task.task_id, preempt=preempt, grace_s=grace_s)
                )
            )

    async def drain_worker(self, worker_id: str, grace_s: float = 10.0, notify_worker: bool = True) -> None:
        """Enter drain state for a (pre-)preempted worker: `_pick_worker`
        stops placing here; every live task gets a graceful preempt-stop (its
        inputs requeue without consuming retries when it reports); tasks that
        never report by the drain deadline are force-reaped. With
        `notify_worker=False` the worker initiated the drain and signals its
        own containers."""
        worker = self.s.workers.get(worker_id)
        if worker is None:
            return
        worker.draining = True
        worker.drain_deadline = time.time() + grace_s + DRAIN_REAP_MARGIN
        logger.warning(f"worker {worker_id} draining (grace {grace_s}s)")
        for task_id in list(worker.active_tasks):
            task = self.s.tasks.get(task_id)
            if task is None or task.finished_at:
                continue
            task.preempted = True
            task.terminate = True
            # a gang drains as a unit: its peers on other hosts stop too, and
            # the replacement gang is placed whole from the backlog
            cluster = self.s.clusters.get(task.cluster_id) if task.cluster_id else None
            for peer_id in cluster.task_ids if cluster is not None else ():
                peer = self.s.tasks.get(peer_id)
                if peer is not None and peer_id != task_id and not peer.preempted:
                    peer.preempted = True
                    peer.terminate = True
                    await self._send_stop(peer, grace_s, True)
            if notify_worker:
                await self._send_stop(task, grace_s, True)
        self.s.schedule_event.set()

    async def reap_dead_tasks(self) -> None:
        """Failure detection, three reap classes, so clients never hang:

        1. heartbeat timeout: the container stopped heartbeating; claimed
           inputs retry (budget consumed) or fail when exhausted;
        2. drain deadline: a draining worker's task never reported; inputs
           requeue for free;
        3. stranded launch: a task assigned to a worker that vanished before
           the container ever said hello.
        """
        now = time.time()
        for task in list(self.s.tasks.values()):
            if task.finished_at:
                continue
            worker = self.s.workers.get(task.worker_id)
            worker_dead = worker is None or now - worker.last_heartbeat > 90.0
            if (
                task.state == api_pb2.TASK_STATE_ACTIVE
                and task.last_heartbeat
                and now - task.last_heartbeat > TASK_HEARTBEAT_TIMEOUT
            ):
                await self._reap_task(task, "heartbeat timeout", free_requeue=task.preempted)
            elif worker is not None and worker.draining and worker.drain_deadline and now > worker.drain_deadline:
                await self._reap_task(task, "drain deadline expired", free_requeue=True)
            elif (
                task.state in (api_pb2.TASK_STATE_WORKER_ASSIGNED, api_pb2.TASK_STATE_CREATED)
                and worker_dead
                and now - task.created_at > TASK_LAUNCH_TIMEOUT
            ):
                await self._reap_task(task, "worker lost before container start", free_requeue=False)
        # a fully drained worker with nothing left running leaves the
        # registry, and so does a journal-recovered one that never heartbeat
        # within the re-adoption window
        for worker_id, worker in list(self.s.workers.items()):
            if worker.draining and worker.drain_deadline and now > worker.drain_deadline and not worker.active_tasks:
                logger.info(f"drained worker {worker_id} deregistered")
                del self.s.workers[worker_id]
                self._journal_worker_gone(worker_id)
            elif worker.adoption_pending and worker.recovered_at and now - worker.recovered_at > WORKER_READOPT_GRACE_S:
                logger.warning(f"recovered worker {worker_id} never re-adopted; deregistered")
                del self.s.workers[worker_id]
                self._journal_worker_gone(worker_id)

    def _journal_worker_gone(self, worker_id: str) -> None:
        if self.s.journal is not None:
            self.s.journal.append("worker_gone", worker_id=worker_id)

    async def _reap_task(self, task: TaskState_, reason: str, free_requeue: bool) -> None:
        """Tear down one dead or stuck task. `free_requeue` (preemption): its
        inputs go back to pending without consuming the retry budget;
        otherwise inputs retry under the policy or fail when exhausted."""
        SCHED_TASKS_REAPED.inc(reason=reason.replace(" ", "_"))
        logger.warning(
            f"task {task.task_id} {reason}; "
            + ("requeueing its inputs" if free_requeue else "failing/retrying its inputs")
        )
        task.terminate = True
        task.finished_at = time.time()
        if free_requeue:
            task.preempted = True
            task.state = api_pb2.TASK_STATE_PREEMPTED
            if self.servicer is not None:
                await self.servicer._requeue_claimed_inputs(task)
                self.servicer._release_task(task)
        else:
            task.state = api_pb2.TASK_STATE_FAILED
            result = api_pb2.GenericResult(
                status=api_pb2.GENERIC_STATUS_INTERNAL_FAILURE,
                exception=f"container {task.task_id} lost ({reason})",
            )
            if self.servicer is not None:
                await self.servicer._fail_claimed_inputs(task, result)
                self.servicer._release_task(task)
        worker = self.s.workers.get(task.worker_id)
        if worker is not None:
            await worker.events.put(
                api_pb2.WorkerPollResponse(stop=api_pb2.TaskStopEvent(task_id=task.task_id, force=True))
            )
