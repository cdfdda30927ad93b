"""The port's write-ahead journal and recovery (`modal_tpu_torch/server/
journal.py`), the counterparts of the JAX package's tests/test_recovery.py:
segments and a torn tail, rotation, compaction that replays to the same
state, a declined recovery archiving, owner-only files, compaction racing
appends, claims requeued and outputs deduped on recovery, the deployed map
after AppDeploy, worker re-adoption, ids that never collide after recovery,
the bounded journal-backed idempotency cache, and the plane's own journal
against the JAX package's: the same RPCs journal the same record types and
payloads, and a journal the JAX plane wrote replays into the port's state
with the JAX-only record types counted by type."""

from __future__ import annotations

import logging
import os
import stat

import pytest

from modal_tpu.proto import api_pb2 as japi
from modal_tpu.server import journal as JJ
from modal_tpu.server import services as jservices
from modal_tpu.server import state as jstate
from modal_tpu_torch.proto import api_pb2
from modal_tpu_torch.server import journal as J
from modal_tpu_torch.server import services as tservices
from modal_tpu_torch.server import state as tstate


class _Ctx:
    """The slice of a grpc context a handler called directly uses."""

    def invocation_metadata(self):
        return ()

    async def abort(self, code, details=""):
        raise RuntimeError(f"abort {code}: {details}")


async def _plane(pkg_api, pkg_state, pkg_services, pkg_journal, state_dir: str):
    """One plane of a package with its journal on: an app, a function, a map
    call."""
    state = pkg_state.ServerState(state_dir)
    state.journal = pkg_journal.Journal(state_dir)
    state.idempotency = pkg_journal.IdempotencyCache(journal=state.journal)
    servicer = pkg_services.ModalTPUServicer(state)
    ctx = _Ctx()
    app = await servicer.AppCreate(pkg_api.AppCreateRequest(description="rec"), ctx)
    fn = await servicer.FunctionCreate(pkg_api.FunctionCreateRequest(
        app_id=app.app_id, function=pkg_api.Function(function_name="f"), tag="f"), ctx)
    call = await servicer.FunctionMap(pkg_api.FunctionMapRequest(
        function_id=fn.function_id, function_call_type=pkg_api.FUNCTION_CALL_TYPE_MAP), ctx)
    return servicer, ctx, fn.function_id, call.function_call_id


async def _port_plane(state_dir: str):
    return await _plane(api_pb2, tstate, tservices, J, state_dir)


def _recovered(state_dir: str):
    state = tstate.ServerState(state_dir)
    state.idempotency = J.IdempotencyCache(journal=None)
    journal = J.Journal(state_dir)
    report = J.recover_state(state, journal)
    state.journal = journal
    state.idempotency.journal = journal
    return state, report


def _put_inputs(api, fn_id, call_id, n, payload=b"p"):
    return api.FunctionPutInputsRequest(function_id=fn_id, function_call_id=call_id, inputs=[
        api.FunctionPutInputsItem(idx=i, input=api.FunctionInput(args=payload)) for i in range(n)])


def _output(api, call_id, item):
    return api.FunctionPutOutputsRequest(outputs=[api.FunctionPutOutputsItem(
        function_call_id=call_id, input_id=item.input_id, idx=item.idx,
        result=api.GenericResult(status=api.GENERIC_STATUS_SUCCESS))])


# ---------------------------------------------------------------------------
# the journal's mechanics
# ---------------------------------------------------------------------------


def test_journal_roundtrip_segments_and_torn_tail(tmp_path):
    j = J.Journal(str(tmp_path))
    for i in range(10):
        j.append("app", app_id=f"ap-{i}")
    j.close()
    seg = sorted(p for p in os.listdir(j.dir) if p.startswith("segment-"))[-1]
    with open(os.path.join(j.dir, seg), "a") as f:
        f.write('{"seq": 11, "t": "ap')  # a crash mid-write
    j2 = J.Journal(str(tmp_path))
    snap, tail = j2.replay()
    assert snap == []
    assert [r["app_id"] for r in tail] == [f"ap-{i}" for i in range(10)]
    assert [r["seq"] for r in tail] == list(range(1, 11))
    assert j2.append("app", app_id="ap-next") == 11  # the sequence goes on
    j2.close()


def test_journal_segment_rotation(tmp_path, monkeypatch):
    monkeypatch.setattr(J, "SEGMENT_MAX_RECORDS", 5)
    j = J.Journal(str(tmp_path))
    for i in range(12):
        j.append("app", app_id=f"ap-{i}")
    assert len([p for p in os.listdir(j.dir) if p.startswith("segment-")]) == 3  # 5 + 5 + 2
    _, tail = j.replay()
    assert len(tail) == 12 and [r["seq"] for r in tail] == list(range(1, 13))
    j.close()


async def test_snapshot_compaction_prunes_and_replays_equivalently(tmp_path):
    servicer, ctx, fn_id, call_id = await _port_plane(str(tmp_path / "a"))
    resp = await servicer.FunctionPutInputs(_put_inputs(api_pb2, fn_id, call_id, 20, b"x" * 64), ctx)
    for item in list(resp.inputs)[:10]:
        await servicer.FunctionPutOutputs(_output(api_pb2, call_id, item), ctx)
    j = servicer.s.journal
    pre = j.status()
    assert pre["tail_records"] > 30
    j.write_snapshot(J.synthesize_records(servicer.s))
    post = j.status()
    assert post["snapshot_seq"] == j.seq and post["segments"] == 0 and post["tail_records"] == 0
    j.close()
    state, report = _recovered(str(tmp_path / "a"))
    call = state.function_calls[call_id]
    assert call.num_inputs == 20 and call.num_done == 10 and len(call.outputs) == 10
    assert len(state.inputs) == 20 and len(state.functions[fn_id].pending) == 10
    assert report["records_skipped"] == 0
    state.journal.close()


def test_declined_recovery_archives_old_journal(tmp_path):
    j = J.Journal(str(tmp_path))
    j.append("app", app_id="ap-ghost")
    j.close()
    dest = J.archive_existing(str(tmp_path))
    assert dest is not None and os.path.isdir(dest)
    fresh = J.Journal(str(tmp_path))
    assert not fresh.has_records() and fresh.seq == 0
    assert J.archive_existing(str(tmp_path)) is None  # nothing left to archive
    fresh.close()


def test_journal_files_are_owner_only(tmp_path):
    j = J.Journal(str(tmp_path))
    j.append("rpc_dedupe", key="k", method="FunctionMap", resp="")
    j.write_snapshot([{"t": "app", "app_id": "ap-1"}])
    j.append("app", app_id="ap-2")
    names = [n for n in os.listdir(j.dir) if n.endswith(".jsonl")]
    assert any(n.startswith("snapshot-") for n in names) and any(n.startswith("segment-") for n in names)
    for name in names:
        assert stat.S_IMODE(os.stat(os.path.join(j.dir, name)).st_mode) == 0o600, name
    assert stat.S_IMODE(os.stat(j.dir).st_mode) == 0o700
    j.close()


async def test_compact_async_keeps_racing_appends(tmp_path):
    j = J.Journal(str(tmp_path))
    for i in range(6):
        j.append("app", app_id=f"ap-{i}")
    covered = j.seq
    await j.compact_async([{"t": "app", "app_id": f"ap-{i}"} for i in range(6)])
    j.append("app", app_id="ap-late")  # after the snapshot's coverage
    snap, tail = j.replay()
    assert len(snap) == 6
    assert [r["app_id"] for r in tail] == ["ap-late"] and tail[0]["seq"] == covered + 1
    j.close()


async def test_a_group_commits_once_and_skips_nothing(tmp_path):
    """FunctionPutInputs of 8 inputs appends 8 records under one group: all
    of them are on disk when the handler returns."""
    servicer, ctx, fn_id, call_id = await _port_plane(str(tmp_path))
    seq0 = servicer.s.journal.seq
    await servicer.FunctionPutInputs(_put_inputs(api_pb2, fn_id, call_id, 8), ctx)
    _, tail = J.Journal(str(tmp_path)).replay()  # a second reader sees the flushed file
    assert [r["t"] for r in tail if r["seq"] > seq0] == ["input"] * 8
    servicer.s.journal.close()


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------


async def test_recovery_requeues_claimed_inputs_and_dedupes_outputs(tmp_path):
    servicer, ctx, fn_id, call_id = await _port_plane(str(tmp_path / "s"))
    items = list((await servicer.FunctionPutInputs(_put_inputs(api_pb2, fn_id, call_id, 6), ctx)).inputs)
    for item in items[:3]:  # claims are not journaled: they recover as pending
        inp = servicer.s.inputs[item.input_id]
        inp.status, inp.claimed_by = "claimed", "ta-dead"
        servicer.s.functions[fn_id].pending.remove(item.input_id)
    await servicer.ContainerCheckpoint(api_pb2.ContainerCheckpointRequest(
        task_id="ta-dead", input_id=items[0].input_id, resume_token="step-41"), ctx)
    await servicer.FunctionPutOutputs(_output(api_pb2, call_id, items[2]), ctx)
    servicer.s.journal.close()

    state, report = _recovered(str(tmp_path / "s"))
    assert report["records_applied"] > 0 and report["records_skipped"] == 0
    call = state.function_calls[call_id]
    assert call.num_inputs == 6 and call.num_done == 1
    unfinished = [i for i in state.inputs.values() if i.status == "pending"]
    assert len(unfinished) == 5 and report["inputs_requeued"] == 5
    assert sorted(state.functions[fn_id].pending) == sorted(i.input_id for i in unfinished)
    assert state.inputs[items[0].input_id].resume_token == "step-41"
    # the dead attempt's duplicate report is dropped on the recovered state
    recovered = tservices.ModalTPUServicer(state)
    await recovered.FunctionPutOutputs(_output(api_pb2, call_id, items[2]), ctx)
    assert call.num_done == 1 and len(call.outputs) == 1
    assert tstate.make_id("in") not in state.inputs
    assert tstate.make_id("fc") not in state.function_calls
    state.journal.close()


async def test_app_deploy_replay_keeps_deployed_functions(tmp_path):
    servicer, ctx, fn_id, _ = await _port_plane(str(tmp_path / "d"))
    app_id = next(iter(servicer.s.apps))
    await servicer.AppPublish(api_pb2.AppPublishRequest(
        app_id=app_id, name="depl", app_state=api_pb2.APP_STATE_DEPLOYED, function_ids={"f": fn_id}), ctx)
    await servicer.AppDeploy(api_pb2.AppDeployRequest(app_id=app_id, name="depl"), ctx)
    assert servicer.s.deployed_functions[("", "depl", "f")] == fn_id
    servicer.s.journal.close()
    state, _ = _recovered(str(tmp_path / "d"))
    assert state.deployed_functions.get(("", "depl", "f")) == fn_id
    assert state.deployed_apps.get(("", "depl")) == app_id
    state.journal.close()


async def test_recovered_worker_awaits_readoption(tmp_path):
    from modal_tpu_torch.server.scheduler import WORKER_READOPT_GRACE_S, Scheduler

    servicer, ctx, _, _ = await _port_plane(str(tmp_path / "w"))
    resp = await servicer.WorkerRegister(api_pb2.WorkerRegisterRequest(
        hostname="h1", num_gpus=8, gpu_type="local-sim"), ctx)
    ghost = await servicer.WorkerRegister(api_pb2.WorkerRegisterRequest(hostname="h2", gpu_type="local-sim"), ctx)
    servicer.s.journal.close()
    state, report = _recovered(str(tmp_path / "w"))
    worker = state.workers[resp.worker_id]
    assert worker.adoption_pending and worker.num_gpus == 8 and worker.gpu_type == "local-sim"
    assert report["workers_pending_adoption"] == 2
    scheduler = Scheduler(state, tservices.ModalTPUServicer(state))
    assert scheduler._pick_worker(None) is None  # no placement on an unadopted worker
    recovered = tservices.ModalTPUServicer(state)
    await recovered.WorkerHeartbeat(api_pb2.WorkerHeartbeatRequest(worker_id=resp.worker_id), ctx)
    assert not worker.adoption_pending and scheduler._pick_worker(None) is worker
    hb = await recovered.WorkerHeartbeat(api_pb2.WorkerHeartbeatRequest(worker_id="wk-never"), ctx)
    assert hb.reannounce
    # the other never heartbeats: past the window it leaves, journaled
    state.workers[ghost.worker_id].recovered_at -= WORKER_READOPT_GRACE_S + 1
    await scheduler.reap_dead_tasks()
    assert ghost.worker_id not in state.workers and resp.worker_id in state.workers
    state.journal.close()
    again, _ = _recovered(str(tmp_path / "w"))
    assert sorted(again.workers) == [resp.worker_id]
    again.journal.close()


def test_recovered_ids_and_input_tokens_never_collide(tmp_path):
    """Inputs recovered with their `input_token` records keep their tokens,
    and a fresh id can never collide with a recovered one (a collision would
    hand one input's token and result to another)."""
    j = J.Journal(str(tmp_path))
    j.append("call", function_call_id="fc-00009000", function_id="")
    ids = [tstate.make_id("in") for _ in range(3)]
    ids.append("in-00090000")  # past anything this process minted
    for i, input_id in enumerate(ids):
        j.append("input", input_id=input_id, function_call_id="fc-00009000", idx=i, input="", retry_count=0)
        j.append("input_token", input_id=input_id, resume_token=f"step-{i}")
    j.close()
    state, report = _recovered(str(tmp_path))
    assert set(ids) <= set(state.inputs) and report["records_skipped"] == 0
    assert [state.inputs[i].resume_token for i in ids] == [f"step-{i}" for i in range(4)]
    fresh = tstate.make_id("in")
    assert fresh not in state.inputs and int(fresh.rpartition("-")[2]) > 90000
    assert tstate.make_id("fc") != "fc-00009000"
    state.journal.close()


def test_idempotency_cache_bounded_and_journal_backed(tmp_path):
    j = J.Journal(str(tmp_path))
    cache = J.IdempotencyCache(journal=j, max_entries=3)
    for i in range(5):
        cache.put(f"k{i}", "FunctionMap", f"resp-{i}".encode())
    assert len(cache) == 3
    assert cache.get("k0", "FunctionMap") is None  # oldest evicted first
    assert cache.get("k4", "FunctionMap") == b"resp-4"
    assert cache.get("k4", "FunctionCreate") is None  # the method must match
    j.close()
    state = tstate.ServerState(str(tmp_path / "st"))
    state.idempotency = J.IdempotencyCache(journal=None)
    j2 = J.Journal(str(tmp_path))
    J.recover_state(state, j2)
    assert state.idempotency.get("k4", "FunctionMap") == b"resp-4"
    j2.close()


def test_a_journal_that_cannot_open_its_directory_raises(tmp_path):
    """The journal never falls back to memory: a state dir it cannot write
    raises at once."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    with pytest.raises(OSError):
        J.Journal(str(blocker))


# ---------------------------------------------------------------------------
# against the JAX package's journal
# ---------------------------------------------------------------------------


async def _function_path(api, pkg_state, pkg_services, pkg_journal, state_dir: str):
    """The function path's mutating RPCs on one package's plane: app,
    function, its bound variant, scheduling params, a map of 4 inputs with
    one output taken and one checkpoint, a cancelled call, a worker."""
    servicer, ctx, fn_id, call_id = await _plane(api, pkg_state, pkg_services, pkg_journal, state_dir)
    await servicer.FunctionBindParams(api.FunctionBindParamsRequest(function_id=fn_id, serialized_params=b"kw"), ctx)
    await servicer.FunctionUpdateSchedulingParams(api.FunctionUpdateSchedulingParamsRequest(
        function_id=fn_id, settings=api.AutoscalerSettings(min_containers=1)), ctx)
    items = list((await servicer.FunctionPutInputs(_put_inputs(api, fn_id, call_id, 4), ctx)).inputs)
    await servicer.FunctionPutOutputs(_output(api, call_id, items[0]), ctx)
    await servicer.FunctionGetOutputs(api.FunctionGetOutputsRequest(
        function_call_id=call_id, timeout=0, clear_on_success=True), ctx)
    await servicer.ContainerCheckpoint(api.ContainerCheckpointRequest(
        input_id=items[1].input_id, resume_token="step-7"), ctx)
    other = await servicer.FunctionMap(api.FunctionMapRequest(function_id=fn_id, pipelined_inputs=[
        api.FunctionPutInputsItem(idx=0, input=api.FunctionInput(args=b"c"))]), ctx)
    await servicer.FunctionCallCancel(api.FunctionCallCancelRequest(function_call_id=other.function_call_id), ctx)
    return servicer, ctx, fn_id, call_id


def _shape(records: list[dict]) -> list:
    """Record types and payload keys, ids and times left out."""
    return [(r["t"], sorted(k for k in r if k != "seq")) for r in records]


async def test_the_function_path_journals_what_jax_journals(tmp_path):
    """The same RPCs on both planes append the same record types with the
    same payload keys, in the same order (worker records aside: the port's
    workers hold cards, gpu_type and num_gpus)."""
    got = {}
    for name, pkg in (("jax", (japi, jstate, jservices, JJ)), ("port", (api_pb2, tstate, tservices, J))):
        servicer, *_ = await _function_path(*pkg, str(tmp_path / name))
        servicer.s.journal.close()
        _, tail = pkg[3].Journal(str(tmp_path / name)).replay()
        got[name] = _shape(tail)
    assert got["port"] == got["jax"]
    assert {t for t, _ in got["port"]} == {"app", "app_state", "function", "fn_sched", "call", "input", "output",
                                           "consumed", "input_token", "call_cancel"}


async def test_a_jax_journal_replays_into_the_port(tmp_path, caplog):
    """A journal the JAX plane wrote (the function path, an image, a secret
    and a volume with a file, an environment, a workspace setting, a granted
    token, a proxy, a named dict and queue, plus a record of a table the
    port has not taken: an input-plane attempt) replays through the port's
    recover_state into the same apps, functions, calls, pending inputs,
    images, secrets, volumes and SDK objects as JAX's own recovery; the
    JAX-only records are counted by type and each type is named in a
    warning."""
    jdir = str(tmp_path / "jax")
    servicer, ctx, fn_id, call_id = await _function_path(japi, jstate, jservices, JJ, jdir)
    await servicer.EnvironmentCreate(japi.EnvironmentCreateRequest(name="staging"), ctx)
    await servicer.WorkspaceSettingsSet(japi.WorkspaceSettingsSetRequest(name="default_environment",
                                                                         value="staging"), ctx)
    flow = await servicer.TokenFlowCreate(japi.TokenFlowCreateRequest(), ctx)
    await servicer.TokenFlowWait(japi.TokenFlowWaitRequest(token_flow_id=flow.token_flow_id, timeout=0), ctx)
    await servicer.ProxyCreate(japi.ProxyCreateRequest(name="egress"), ctx)
    for rpc, req in (("DictGetOrCreate", japi.DictGetOrCreateRequest), ("QueueGetOrCreate", japi.QueueGetOrCreateRequest)):
        await getattr(servicer, rpc)(req(deployment_name="named",
                                         object_creation_type=japi.OBJECT_CREATION_TYPE_CREATE_IF_MISSING), ctx)
    servicer.s.journal.append("attempt", token="at-00000001", call_id=call_id, input_id="in-x")
    await servicer.SecretGetOrCreate(japi.SecretGetOrCreateRequest(
        deployment_name="s", env_dict={"K": "v"},
        object_creation_type=japi.OBJECT_CREATION_TYPE_CREATE_IF_MISSING), ctx)
    await servicer.ImageGetOrCreate(japi.ImageGetOrCreateRequest(
        image=japi.Image(dockerfile_commands=["FROM python:3.12-slim-bookworm"], version="2026.07"),
        builder_version="2026.07"), ctx)
    vol = await servicer.VolumeGetOrCreate(japi.VolumeGetOrCreateRequest(
        deployment_name="v", object_creation_type=japi.OBJECT_CREATION_TYPE_CREATE_IF_MISSING), ctx)
    servicer.s.put_block("ab" * 32, b"x")
    await servicer.VolumePutFiles2(japi.VolumePutFiles2Request(
        volume_id=vol.volume_id, files=[japi.VolumeFile(path="d/f.bin", size=1, block_sha256_hex=["ab" * 32])]), ctx)
    await servicer.VolumeCommit(japi.VolumeCommitRequest(volume_id=vol.volume_id), ctx)
    await servicer.WorkerRegister(japi.WorkerRegisterRequest(hostname="h", tpu_type="local-sim", num_chips=4), ctx)
    servicer.s.journal.close()

    jax_state = jstate.ServerState(str(tmp_path / "jax-replay"))
    jax_state.idempotency = JJ.IdempotencyCache(journal=None)
    JJ.recover_state(jax_state, JJ.Journal(jdir))
    port_state = tstate.ServerState(str(tmp_path / "port-replay"))
    port_state.idempotency = J.IdempotencyCache(journal=None)
    with caplog.at_level(logging.WARNING, logger="modal_tpu_torch"):
        # the port's logger does not propagate: hand it caplog's handler
        logging.getLogger("modal_tpu_torch").addHandler(caplog.handler)
        try:
            report = J.recover_state(port_state, J.Journal(jdir))
        finally:
            logging.getLogger("modal_tpu_torch").removeHandler(caplog.handler)

    def view(s):
        return {
            "apps": {a.app_id: (a.description, a.state, dict(a.function_ids)) for a in s.apps.values()},
            "functions": {f.function_id: (f.app_id, f.tag, f.definition.function_name, f.bound_parent,
                                          f.serialized_params, f.autoscaler.min_containers)
                          for f in s.functions.values()},
            "calls": {c.function_call_id: (c.function_id, c.num_inputs, c.num_done, c.outputs_consumed,
                                           c.cancelled, [o.idx for o in c.outputs])
                      for c in s.function_calls.values()},
            "inputs": {i.input_id: (i.idx, i.status, i.resume_token, i.input.args) for i in s.inputs.values()},
            "pending": {f.function_id: list(f.pending) for f in s.functions.values()},
            "workers": sorted(s.workers),
            "secrets": {k: (v.name, dict(v.env_dict)) for k, v in s.secrets.items()},
            "deployed_secrets": dict(s.deployed_secrets),
            "images": {k: (v.definition.SerializeToString(), v.metadata.SerializeToString(), v.built)
                       for k, v in s.images.items()},
            "images_by_hash": dict(s.images_by_hash),
            "volumes": {k: (v.name, v.version, v.committed_version, v.ephemeral,
                            {p: f.SerializeToString() for p, f in v.files.items()}) for k, v in s.volumes.items()},
            "deployed_volumes": dict(s.deployed_volumes),
            "environments": dict(s.environments),
            "workspace_settings": dict(s.workspace_settings),
            "tokens": dict(s.tokens),
            "proxies": {k: (p.name, p.proxy_ip, p.environment_name) for k, p in s.proxies.items()},
            "deployed_proxies": dict(s.deployed_proxies),
            "dicts": {k: (d.name, d.ephemeral) for k, d in s.dicts.items()},
            "deployed_dicts": dict(s.deployed_dicts),
            "queues": {k: (q.name, q.ephemeral) for k, q in s.queues.items()},
            "deployed_queues": dict(s.deployed_queues),
        }

    assert view(port_state) == view(jax_state)
    assert len(port_state.secrets) == 1 and len(port_state.images) == 1 and len(port_state.volumes) == 1
    assert list(port_state.volumes[vol.volume_id].files) == ["d/f.bin"]
    assert len(port_state.apps) == 1 and len(port_state.functions) == 2 and len(port_state.function_calls) == 2
    assert len(port_state.functions[fn_id].pending) == 3
    assert port_state.environments == {"main": "", "staging": ""} and len(port_state.tokens) == 1
    assert port_state.deployed_dicts == {("staging", "named"): next(iter(port_state.dicts))}
    assert report["skipped_by_type"] == {"attempt": 1}
    assert report["records_skipped"] == 1 and report["inputs_requeued"] == 3
    warned = " ".join(r.getMessage() for r in caplog.records)
    for t, waits in (("attempt", "4e"),):
        assert f"skipped 1 {t!r} record(s): its table comes with ROADMAP Queue A {waits}" in warned, warned
    assert port_state.workers[next(iter(port_state.workers))].num_gpus == 0  # chips are not cards


def test_every_jax_record_type_is_applied_or_named():
    """Each record type of the JAX applier table is either applied by the
    port's or named with the sub-slice that brings its table."""
    assert set(JJ._APPLIERS) == set(J._APPLIERS) | set(J.WAITING_RECORD_TYPES)
    assert not set(J._APPLIERS) & set(J.WAITING_RECORD_TYPES)
    assert set(J.IDEMPOTENT_RPCS) == set(JJ.IDEMPOTENT_RPCS)
    # since the SDK's objects (4e-objects) only the input plane's table waits
    assert set(J.WAITING_RECORD_TYPES) == {"attempt"}
    # a dict's or a queue's contents are exempt, as in the JAX table
    for rpc in ("DictUpdate", "DictPop", "DictClear", "QueuePut", "QueueGet", "QueueClear", "TokenFlowCreate"):
        assert J.EXEMPT_RPCS[rpc] == JJ.EXEMPT_RPCS[rpc], rpc
