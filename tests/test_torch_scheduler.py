"""The port's scheduler (`modal_tpu_torch/server/scheduler.py`, cards) against
the JAX package's (`modal_tpu/server/scheduler.py`, chips) on the same
inventories and asks, with no subprocess: which worker a task lands on,
which ids it is pinned to, when placement is refused, and reuse of the ids
after the task is released. A TPU ask of N chips (`v5e-N`) stands beside a
GPU ask of N cards (`H100:N`); the JAX hosts register as `local-sim` TPUs,
the port's as `local-sim` or as H100s.

Where the two differ by design: the JAX scheduler has no card type to
match and queues an ask no host can hold; the port refuses it with the
unsatisfiable-placement reason (ROADMAP Queue C)."""

import asyncio
import time

import pytest

from modal_tpu.proto import api_pb2 as japi
from modal_tpu.server import scheduler as jsched
from modal_tpu.server import services as jservices
from modal_tpu.server import state as jstate
from modal_tpu_torch.proto import api_pb2 as tapi
from modal_tpu_torch.server import scheduler as tsched
from modal_tpu_torch.server import services as tservices
from modal_tpu_torch.server import state as tstate

H100 = "NVIDIA H100 80GB HBM3"


class _Pair:
    """One control plane of each package, in memory (no server, no worker)."""

    def __init__(self, tmp_path, inventories, port_type="local-sim"):
        self.j = jstate.ServerState(str(tmp_path / "jax"))
        self.t = tstate.ServerState(str(tmp_path / "port"))
        self.jsvc, self.tsvc = jservices.ModalTPUServicer(self.j), tservices.ModalTPUServicer(self.t)
        self.jsch, self.tsch = jsched.Scheduler(self.j, self.jsvc), tsched.Scheduler(self.t, self.tsvc)
        self.jw, self.tw = [], []
        for i, n in enumerate(inventories):
            jw = jstate.WorkerState(worker_id=f"w{i}", tpu_type="local-sim", num_chips=n)
            tw = tstate.WorkerState(worker_id=f"w{i}", gpu_type=port_type, num_gpus=n)
            self.j.workers[jw.worker_id], self.t.workers[tw.worker_id] = jw, tw
            self.jw.append(jw)
            self.tw.append(tw)

    def functions(self, n, region=""):
        jdef = japi.Function(function_name="f")
        tdef = tapi.Function(function_name="f")
        if n:
            jdef.resources.tpu_config.tpu_type = f"v5e-{n}"
            tdef.resources.gpu_config.CopyFrom(tapi.GPUConfig(gpu_type="H100", count=n))
        if region:
            jdef.scheduler_placement.regions.append(region)
            tdef.scheduler_placement.regions.append(region)
        jfn = jstate.FunctionState(function_id="fu-1", app_id="", tag="f", definition=jdef)
        tfn = tstate.FunctionState(function_id="fu-1", app_id="", tag="f", definition=tdef)
        self.j.functions[jfn.function_id], self.t.functions[tfn.function_id] = jfn, tfn
        return jfn, tfn

    def launch(self, jfn, tfn):
        jt = asyncio.run(self.jsch._launch_task(jfn))
        tt = asyncio.run(self.tsch._launch_task(tfn))
        return jt, tt


def _placed(task):
    if task is None:
        return None
    return (task.worker_id, list(getattr(task, "tpu_chip_ids", None) or getattr(task, "gpu_ids", [])))


# (worker inventories, ask, tasks to launch): every launch's (worker, ids) or
# None (no capacity now) must agree
CASES = [
    ([1], 1, 2),  # the card is taken by the first task: the second waits
    ([4], 1, 5),  # four one-card tasks fill a 4-card host in id order
    ([4], 2, 3),
    ([2, 4], 2, 4),  # least loaded first: w0, w1, then w1 (w0 full), then none
    ([8, 8], 4, 5),
    ([4, 4], 0, 3),  # CPU tasks pin nothing and spread by load
    ([1, 2, 4], 4, 2),  # only the 4-card host can hold it
]


@pytest.mark.parametrize("inventories,n,launches", CASES)
def test_placements_equal_jax(tmp_path, inventories, n, launches):
    pair = _Pair(tmp_path, inventories)
    jfn, tfn = pair.functions(n)
    got = [tuple(map(_placed, pair.launch(jfn, tfn))) for _ in range(launches)]
    assert [g[1] for g in got] == [g[0] for g in got], got
    assert any(g[0] is not None for g in got)
    # the port's cards and the JAX package's chips in use are the same ids
    # (task ids differ: each package mints its own)
    for jw, tw in zip(pair.jw, pair.tw):
        assert sorted(tw.gpus_in_use) == sorted(jw.chips_in_use) and tw.free_gpus() == jw.free_chips()


@pytest.mark.parametrize("inventories,n", [([2], 2), ([4, 4], 1), ([2, 4], 2)])
def test_released_ids_are_reused_as_in_jax(tmp_path, inventories, n):
    pair = _Pair(tmp_path, inventories)
    jfn, tfn = pair.functions(n)
    first = [pair.launch(jfn, tfn) for _ in range(sum(inventories) // n)]
    assert pair.launch(jfn, tfn) == (None, None)  # full
    jt, tt = first[0]
    pair.jsvc._release_task(jt)
    pair.tsvc._release_task(tt)
    again = pair.launch(jfn, tfn)
    assert _placed(again[1]) == _placed(again[0]) == _placed(tt)


def test_the_card_type_must_match(tmp_path):
    """`gpu="H100"` lands on a worker that registered the card's full name,
    never on an L40S; "L4" does not match "L40S". The JAX hosts have no
    type to match: the equal placement is the H100 host's."""
    pair = _Pair(tmp_path, [4, 4], port_type=H100)
    pair.tw[0].gpu_type = "NVIDIA L40S"
    jfn, tfn = pair.functions(1)
    _jt, tt = pair.launch(jfn, tfn)
    assert _placed(tt) == ("w1", [0])
    tfn.definition.resources.gpu_config.gpu_type = "L4"
    assert tsched.worker_holds(pair.tw[0], tsched.gpu_spec(tfn.definition.resources)) is False
    tfn.definition.resources.gpu_config.gpu_type = "ANY"
    assert tsched.worker_holds(pair.tw[0], tsched.gpu_spec(tfn.definition.resources)) is True


def test_unsatisfiable_labels_give_the_jax_reason(tmp_path):
    pair = _Pair(tmp_path, [4])
    jfn, tfn = pair.functions(1, region="mars-north1")
    want = pair.jsch.placement_unsatisfiable_reason(jfn.definition.scheduler_placement, subject="f")
    got = pair.tsch.placement_unsatisfiable_reason(
        tfn.definition.scheduler_placement, subject="f", spec=tsched.gpu_spec(tfn.definition.resources)
    )
    assert want is not None and got == want
    assert "unsatisfiable placement for f: regions=['mars-north1']" in got


@pytest.mark.parametrize("inventories,ask,port_type", [([1], 2, H100), ([4], 8, "local-sim"), ([8], 1, "NVIDIA A100-SXM4-80GB")])
def test_an_ask_no_worker_can_hold_is_refused(tmp_path, inventories, ask, port_type):
    """The JAX scheduler queues such an ask (no reason, no launch); the
    port names it, so the backlog fails after the grace window."""
    pair = _Pair(tmp_path, inventories, port_type=port_type)
    jfn, tfn = pair.functions(min(ask, 8))
    spec = tsched.gpu_spec(tfn.definition.resources)
    assert pair.jsch.placement_unsatisfiable_reason(jfn.definition.scheduler_placement, subject="f") is None
    reason = pair.tsch.placement_unsatisfiable_reason(tfn.definition.scheduler_placement, subject="f", spec=spec)
    assert reason == f"unsatisfiable placement for f: gpu={spec} matches no registered worker"
    assert asyncio.run(pair.tsch._launch_task(tfn)) is None
    # a worker that can hold it registers: satisfiable again
    pair.t.workers["big"] = tstate.WorkerState(worker_id="big", gpu_type="local-sim", num_gpus=8)
    assert pair.tsch.placement_unsatisfiable_reason(tfn.definition.scheduler_placement, subject="f", spec=spec) is None


def test_backlog_fails_after_the_grace_window(tmp_path, monkeypatch):
    """An unsatisfiable backlog fails with the reason, not before
    PLACEMENT_UNSAT_GRACE_S has passed."""
    pair = _Pair(tmp_path, [1], port_type=H100)
    _jfn, tfn = pair.functions(2)
    call = tstate.FunctionCallState(function_call_id="fc-1", function_id=tfn.function_id)
    pair.t.function_calls[call.function_call_id] = call

    async def scenario():
        pair.tsvc._enqueue_input(tfn, call, tapi.FunctionPutInputsItem(idx=0, input=tapi.FunctionInput(args=b"")))
        await pair.tsch._schedule_once()
        assert call.outputs == [] and tfn.placement_unsat_since > 0
        tfn.placement_unsat_since -= tsched.PLACEMENT_UNSAT_GRACE_S
        await pair.tsch._schedule_once()

    asyncio.run(scenario())
    (out,) = call.outputs
    assert out.result.status == tapi.GENERIC_STATUS_FAILURE
    assert out.result.exception == "unsatisfiable placement for f: gpu=H100:2 matches no registered worker"
    assert not pair.t.tasks  # never launched without its cards


class _AbortCtx:
    """The slice of a servicer context a refusing handler uses."""

    async def abort(self, code, details):
        raise RuntimeError(f"{code.name}: {details}")


def test_gangs_and_waiting_features_are_refused_at_create(tmp_path):
    """Only a TPU ask is refused at FunctionCreate now: gangs (since 4d-i),
    web endpoints and schedules (4c-ii) and the SLO targets (the SLO
    autoscaler, 4d-ii) are kept, the targets as the JAX plane keeps them."""
    slo_ttft = tapi.Function(function_name="f", autoscaler_settings=tapi.AutoscalerSettings(target_ttft_ms=250.0))
    slo_tps = tapi.Function(function_name="g",
                            autoscaler_settings=tapi.AutoscalerSettings(target_tokens_per_replica=900.0))
    assert tservices.waiting_feature(slo_ttft) == "" and tservices.waiting_feature(slo_tps) == ""
    assert tservices.waiting_feature(tapi.Function(group_size=2)) == ""
    assert tservices.waiting_feature(tapi.Function(webhook_type=tapi.WEB_ENDPOINT_TYPE_ASGI_APP)) == ""
    assert tservices.waiting_feature(tapi.Function(schedule=tapi.Schedule(period=tapi.Schedule.Period(hours=1)))) == ""
    tpu = tapi.Function(resources=tapi.Resources(tpu_config=tapi.TPUConfig(tpu_type="v5e-4")))
    assert "tpu_config ('v5e-4') asks for TPU chips" in tservices.waiting_feature(tpu)
    assert tservices.waiting_feature(tapi.Function(function_name="f")) == ""
    # FunctionCreate keeps each SLO-targeted definition, its targets as the
    # JAX plane keeps them; a TPU ask is answered with InvalidError and kept
    # nowhere
    svc = tservices.ModalTPUServicer(tstate.ServerState(str(tmp_path / "port")))
    jsvc = jservices.ModalTPUServicer(jstate.ServerState(str(tmp_path / "jax")))
    for d in (slo_ttft, slo_tps):
        t = asyncio.run(svc.FunctionCreate(tapi.FunctionCreateRequest(function=d), _AbortCtx()))
        j = asyncio.run(jsvc.FunctionCreate(
            japi.FunctionCreateRequest(function=japi.Function.FromString(d.SerializeToString())), _AbortCtx()))
        got = svc.s.functions[t.function_id].autoscaler
        want = jsvc.s.functions[j.function_id].autoscaler
        assert (got.target_ttft_ms, got.target_tokens_per_replica) == (want.target_ttft_ms,
                                                                       want.target_tokens_per_replica)
        assert got.SerializeToString() == d.autoscaler_settings.SerializeToString()
    n = len(svc.s.functions)
    with pytest.raises(RuntimeError, match=r"INVALID_ARGUMENT: InvalidError: tpu_config"):
        asyncio.run(svc.FunctionCreate(tapi.FunctionCreateRequest(function=tpu), _AbortCtx()))
    assert len(svc.s.functions) == n == 2


def test_slo_targets_are_refused_at_update(tmp_path):
    """FunctionUpdateSchedulingParams keeps the SLO targets on both planes
    (the name stays from the slices that refused them)."""
    svc = tservices.ModalTPUServicer(tstate.ServerState(str(tmp_path / "port")))
    jsvc = jservices.ModalTPUServicer(jstate.ServerState(str(tmp_path / "jax")))
    fn = asyncio.run(svc.FunctionCreate(tapi.FunctionCreateRequest(function=tapi.Function(function_name="f")),
                                        _AbortCtx()))
    jfn = asyncio.run(jsvc.FunctionCreate(japi.FunctionCreateRequest(function=japi.Function(function_name="f")),
                                          _AbortCtx()))
    for field, value in (("target_ttft_ms", 250.0), ("target_tokens_per_replica", 900.0)):
        req = tapi.FunctionUpdateSchedulingParamsRequest(function_id=fn.function_id)
        setattr(req.settings, field, value)
        asyncio.run(svc.FunctionUpdateSchedulingParams(req, _AbortCtx()))
        jreq = japi.FunctionUpdateSchedulingParamsRequest(function_id=jfn.function_id)
        setattr(jreq.settings, field, value)
        asyncio.run(jsvc.FunctionUpdateSchedulingParams(jreq, _AbortCtx()))
        assert getattr(svc.s.functions[fn.function_id].autoscaler, field) == value
        assert (svc.s.functions[fn.function_id].autoscaler.SerializeToString()
                == jsvc.s.functions[jfn.function_id].autoscaler.SerializeToString())
    ok = tapi.FunctionUpdateSchedulingParamsRequest(
        function_id=fn.function_id, settings=tapi.AutoscalerSettings(min_containers=1))
    asyncio.run(svc.FunctionUpdateSchedulingParams(ok, _AbortCtx()))
    assert svc.s.functions[fn.function_id].autoscaler.min_containers == 1


def _claimed(pkg_state, pkg_api, pkg_services, pkg_sched, tmp_path, retries, chips_field):
    """One plane of a package with one worker, one function, one ACTIVE task
    that claimed one input (the JAX package's tests/test_preemption.py
    `_mini_plane`)."""
    s = pkg_state.ServerState(str(tmp_path))
    servicer = pkg_services.ModalTPUServicer(s)
    scheduler = pkg_sched.Scheduler(s, servicer)
    servicer.scheduler = scheduler
    fn = pkg_state.FunctionState(function_id="fn-1", app_id="ap-1", tag="f", definition=pkg_api.Function(
        retry_policy=pkg_api.RetryPolicy(retries=retries)))
    s.functions["fn-1"] = fn
    s.workers["wk-1"] = pkg_state.WorkerState(worker_id="wk-1", **{chips_field: 0})
    task = pkg_state.TaskState_(task_id="ta-1", function_id="fn-1", app_id="ap-1", state=pkg_api.TASK_STATE_ACTIVE,
                                worker_id="wk-1", last_heartbeat=time.time())
    s.tasks["ta-1"] = task
    s.workers["wk-1"].active_tasks.add("ta-1")
    call = pkg_state.FunctionCallState(function_call_id="fc-1", function_id="fn-1")
    call.num_inputs = 1
    s.function_calls["fc-1"] = call
    s.inputs["in-1"] = pkg_state.InputState(input_id="in-1", function_call_id="fc-1", idx=0,
                                            input=pkg_api.FunctionInput(), status="claimed", claimed_by="ta-1")
    return s, servicer, scheduler


def _outcome(s, api):
    inp, task, call = s.inputs["in-1"], s.tasks["ta-1"], s.function_calls["fc-1"]
    return {
        "task": api.TaskState.Name(task.state), "finished": bool(task.finished_at), "preempted": task.preempted,
        "input": (inp.status, inp.retry_count, inp.claimed_by, inp.resume_token), "pending": list(s.functions["fn-1"].pending),
        "outputs": [(api.GenericResultStatus.Name(o.result.status), o.result.exception) for o in call.outputs],
        "workers": sorted(s.workers),
    }


async def _heartbeat_timeout(s, servicer, scheduler, sched_mod, api):
    s.tasks["ta-1"].last_heartbeat = time.time() - sched_mod.TASK_HEARTBEAT_TIMEOUT - 1
    await scheduler.reap_dead_tasks()
    await scheduler.reap_dead_tasks()  # idempotent


async def _drain_then_report(s, servicer, scheduler, sched_mod, api):
    ctx = type("Ctx", (), {"abort": None})()
    await servicer.ContainerCheckpoint(api.ContainerCheckpointRequest(
        task_id="ta-1", input_id="in-1", resume_token="step:37"), ctx)
    await scheduler.drain_worker("wk-1", grace_s=5.0)
    stop = s.workers["wk-1"].events.get_nowait().stop
    assert (stop.task_id, stop.preempt, stop.grace_s) == ("ta-1", True, 5.0)
    assert scheduler._pick_worker(*((None,) if sched_mod is tsched else (0, api.SchedulerPlacement(), None))) is None
    await servicer.TaskResult(api.TaskResultRequest(task_id="ta-1", result=api.GenericResult(
        status=api.GENERIC_STATUS_TERMINATED)), ctx)


async def _drain_deadline(s, servicer, scheduler, sched_mod, api):
    await scheduler.drain_worker("wk-1", grace_s=0.0)
    s.workers["wk-1"].drain_deadline = time.time() - 1  # the task never reported
    await scheduler.reap_dead_tasks()


@pytest.mark.parametrize("retries", [0, 1])
@pytest.mark.parametrize("scenario", [_heartbeat_timeout, _drain_then_report, _drain_deadline])
def test_reaping_and_draining_equal_jax(tmp_path, scenario, retries):
    """Failure detection and preemption drains, on the same hand-built
    plane: a heartbeat-dead task's input retries or fails, a drain blocks
    placement, requeues without consuming retries and keeps the input's
    resume token, a drained worker that never reported is reaped."""
    outcomes = []
    for pkg_state, pkg_api, pkg_services, sched_mod, field in (
        (jstate, japi, jservices, jsched, "num_chips"), (tstate, tapi, tservices, tsched, "num_gpus")
    ):
        s, servicer, scheduler = _claimed(pkg_state, pkg_api, pkg_services, sched_mod, tmp_path / field, retries, field)
        asyncio.run(scenario(s, servicer, scheduler, sched_mod, pkg_api))
        outcomes.append(_outcome(s, pkg_api))
    assert outcomes[1] == outcomes[0]
    assert outcomes[0]["finished"]


def test_a_drain_counts_one_preemption_as_jax_does(tmp_path):
    """`drain_worker` increments modal_tpu_worker_preemptions_total once per
    drain entered, in both packages; a worker the plane does not know
    counts nothing."""
    from modal_tpu.observability.catalog import WORKER_PREEMPTIONS as JAX_PREEMPTIONS
    from modal_tpu_torch.observability.catalog import WORKER_PREEMPTIONS

    deltas = []
    for pkg_state, pkg_api, pkg_services, sched_mod, field, counter in (
        (jstate, japi, jservices, jsched, "num_chips", JAX_PREEMPTIONS),
        (tstate, tapi, tservices, tsched, "num_gpus", WORKER_PREEMPTIONS),
    ):
        s, servicer, scheduler = _claimed(pkg_state, pkg_api, pkg_services, sched_mod, tmp_path / field, 0, field)
        before = counter.value()
        asyncio.run(scheduler.drain_worker("wk-1", grace_s=5.0))
        asyncio.run(scheduler.drain_worker("wk-gone", grace_s=5.0))
        deltas.append(counter.value() - before)
    assert deltas == [1, 1]
