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
- **Schedules**: a function with a Cron or Period schedule gets one
  zero-argument input at every due tick (`_evaluate_schedule`, times from
  `cron.next_fire`); the reap tick drops finished fires
  (`_gc_scheduled_calls`).

Gang placement (`group_size > 1`) comes with the port's gang runtime
(ROADMAP Queue A 4d; FunctionCreate refuses a gang until then), and so does
the SLO autoscaler of serving functions (FunctionCreate and
FunctionUpdateSchedulingParams refuse its targets until then).

After a restart of the plane, journal-recovered workers take no placement
until their next heartbeat re-adopts them, and are deregistered when none
comes within `WORKER_READOPT_GRACE_S`; the reap tick also compacts the
journal (`ModalTPUServicer.maybe_compact`).
"""

from __future__ import annotations

import asyncio
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
from .state import FunctionState, ServerState, TaskState_, WorkerState

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
            unsat_reason = self.placement_unsatisfiable_reason(
                fn.definition.scheduler_placement, subject=fn.tag, spec=gpu_spec(fn.definition.resources)
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
            live = [tid for tid in fn.task_ids if self.s.tasks[tid].state in _LIVE_TASK_STATES]
            max_containers = settings.max_containers or 8
            # a container drains max_concurrent_inputs at once: 100 pending
            # inputs at concurrency 50 need 2 containers, not 8
            max_conc = max(1, fn.definition.max_concurrent_inputs or 1)
            desired = -(-backlog // max_conc)  # ceil
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
        self, placement_proto, subject: str = "", spec: Optional[GPUSpec] = None
    ) -> Optional[str]:
        """A non-None reason means no registered worker could EVER take the
        placement: its labels match no worker, or no worker they match has
        `spec`'s card type and count. Callers own the grace window."""
        placement = self._placement_or_none(placement_proto)
        if placement is None and spec is None:
            return None
        workers = [w for w in self.s.workers.values() if self._placement_ok(w, placement)]
        if workers and any(worker_holds(w, spec) for w in workers):
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
        return reason + f": gpu={spec} matches no registered worker"

    @staticmethod
    def _placement_or_none(p):
        """None when the proto expresses no constraint at all."""
        if not p.regions and not p.zones and not p.HasField("spot") and not p.instance_types:
            return None
        return p

    def _pick_worker(self, spec: Optional[GPUSpec], placement=None) -> Optional[WorkerState]:
        """Least-loaded live worker with enough free matching cards that
        satisfies the placement constraints."""
        best: Optional[WorkerState] = None
        best_load = 0
        for worker in self.s.workers.values():
            if time.time() - worker.last_heartbeat > 60.0 or worker.draining:
                continue
            if worker.adoption_pending:
                # journal-recovered and not yet heard from: it may be gone
                continue
            if not self._placement_ok(worker, placement) or not worker_holds(worker, spec):
                continue
            if spec is not None and len(worker.free_gpus()) < spec.count:
                continue
            load = len(worker.active_tasks)
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

    async def _launch_task(self, fn: FunctionState) -> Optional[TaskState_]:
        t_place0 = time.time()
        spec = gpu_spec(fn.definition.resources)
        worker = self._pick_worker(spec, placement=self._placement_or_none(fn.definition.scheduler_placement))
        if worker is None:
            return None
        task_id = self.s.make_id("ta")
        gpu_ids = worker.free_gpus()[: spec.count] if spec is not None else []
        for g in gpu_ids:
            worker.gpus_in_use[g] = task_id
        task = TaskState_(
            task_id=task_id,
            function_id=fn.function_id,
            app_id=fn.app_id,
            state=api_pb2.TASK_STATE_WORKER_ASSIGNED,
            worker_id=worker.worker_id,
            gpu_ids=gpu_ids,
            trace_context=self._launch_trace_context(fn),
        )
        self.s.tasks[task_id] = task
        fn.task_ids.add(task_id)
        worker.active_tasks.add(task_id)
        assignment = api_pb2.TaskAssignment(
            task_id=task_id,
            container_arguments=self._container_arguments(fn, task),
            gpu_ids=gpu_ids,
            router_token=secrets.token_urlsafe(24),
        )
        await worker.events.put(api_pb2.WorkerPollResponse(assignment=assignment))
        SCHED_TASKS_LAUNCHED.inc(kind="task")
        SCHED_PLACEMENT_LATENCY.observe(time.time() - t_place0, kind="task")
        tracing.record_span(
            "scheduler.place",
            start=t_place0,
            end=time.time(),
            parent=tracing.parse_context(task.trace_context),
            attrs={"task_id": task_id, "worker_id": worker.worker_id, "function_id": fn.function_id,
                   "gpus": len(gpu_ids)},
        )
        logger.debug(f"scheduled task {task_id} for {fn.tag} on {worker.worker_id} gpus={gpu_ids}")
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
