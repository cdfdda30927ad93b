"""The port's App objects, invocation surface and map failure handling
against the JAX package's, and the wire both clients send.

- The requests each client sends for the same decorator arguments, taken
  by a recording stub: FunctionCreateRequest.function equal apart from
  `gpu_config` against `tpu_config` (and the cloudpickle bytes of the
  function, which each package's own pickler writes), and
  ImageGetOrCreateRequest, SecretGetOrCreateRequest and
  MountGetOrCreateRequest byte-equal.
- Raw RPCs to both planes: a with_options bind merges the secrets alike (a
  TPU override is refused by the port's plane, as its FunctionCreate
  refuses one), and a secret reaches the container's environment.
- Counterparts of tests/test_invocation_surface.py (starmap, for_each,
  get_gen, include, update_autoscaler, secret env, gather) and
  tests/test_map_failures.py (retries, retries exhausted, a container
  killed, a lost input, spawn_map past the outstanding cap, the byte
  budget), through both packages' App on their module-scoped planes
  (tests/test_torch_app.py's `planes`).
- What waits for a later sub-slice is refused, naming it; the port's
  default state dir is not the JAX package's.
"""

import asyncio
import hashlib
import os
import subprocess
import sys
import textwrap
import time

import pytest

import modal_tpu
import modal_tpu._utils.blob_utils
import modal_tpu.parallel_map
import modal_tpu_torch
import modal_tpu_torch._utils.blob_utils
import modal_tpu_torch.parallel_map
from modal_tpu.proto import api_pb2 as japi
from modal_tpu_torch.proto import api_pb2
from modal_tpu_torch.serialization import serialize
from tests.test_torch_app import planes  # noqa: F401 — the module-scoped planes fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _file_fn(x):
    """A function the containers find by module and name (not serialized)."""
    return x + 1


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------


class _RecordingStub:
    """Answers the object-creation RPCs with ids derived from the request's
    bytes (so load order does not matter) and records every request."""

    def __init__(self, api):
        self.api = api
        self.requests: list = []

    def __getattr__(self, name: str):
        api = self.api

        async def call(request, metadata=None, timeout=None):
            self.requests.append((name, request))
            key = hashlib.sha256(request.SerializeToString(deterministic=True)).hexdigest()[:8]
            if name == "ImageGetOrCreate":
                return api.ImageGetOrCreateResponse(
                    image_id=f"im-{key}", metadata=api.ImageMetadata(image_builder_version="2026.07"))
            if name == "SecretGetOrCreate":
                return api.SecretGetOrCreateResponse(secret_id=f"st-{key}")
            if name == "MountPutFile":
                return api.MountPutFileResponse(exists=bool(request.WhichOneof("data_oneof")))
            if name == "MountGetOrCreate":
                return api.MountGetOrCreateResponse(mount_id=f"mo-{key}")
            if name == "FunctionCreate":
                return api.FunctionCreateResponse(function_id=f"fu-{key}")
            raise AssertionError(f"unexpected RPC {name}")

        return call


class _RecordingClient:
    image_builder_version = "2026.07"

    def __init__(self, api):
        self.stub = _RecordingStub(api)


def _created(m, api, mount_file: str, **resources) -> list:
    """Load one app's function, with an image, a secret and a mount, through
    package `m`'s resolver against the recording stub; the requests sent."""
    app = m.App("wire")
    image = m.Image.debian_slim("3.12").pip_install("numpy", "einops").env({"A": "1"})

    def work(x):
        return x * 2

    f = app.function(
        serialized=True, image=image, secrets=[m.Secret.from_dict({"TOKEN": "t-1"})],
        mounts=[m.Mount.from_local_file(mount_file, remote_path="/data/data.txt")], timeout=123,
        retries=m.Retries(max_retries=2, initial_delay=0.5), max_containers=2, scaledown_window=30, cpu=2.0,
        memory=1024, min_containers=1, **resources,
    )(work)
    g = app.function(name="file_fn")(_file_fn)
    client = _RecordingClient(api)

    async def load():
        resolver = m.object.Resolver()
        ctx = m.object.LoadContext(client=client, app_id="ap-wire")
        for fn in (f, g):
            await resolver.load(fn, ctx)

    asyncio.run(load())
    return client.stub.requests


def test_both_clients_send_the_same_requests_for_the_same_decorator(tmp_path):
    mount_file = tmp_path / "data.txt"
    mount_file.write_text("mounted\n")
    jreqs = _created(modal_tpu, japi, str(mount_file), tpu="v5e-4")
    treqs = _created(modal_tpu_torch, api_pb2, str(mount_file), gpu="H100")
    assert [n for n, _ in treqs] == [n for n, _ in jreqs]
    assert sorted({n for n, _ in treqs}) == ["FunctionCreate", "ImageGetOrCreate", "MountGetOrCreate",
                                             "MountPutFile", "SecretGetOrCreate"]
    for (name, jr), (_, tr) in zip(jreqs, treqs):
        if name != "FunctionCreate":
            assert tr.SerializeToString(deterministic=True) == jr.SerializeToString(deterministic=True), name
            continue
        jdef, tdef = japi.Function(), api_pb2.Function()
        jdef.CopyFrom(jr.function)
        tdef.CopyFrom(tr.function)
        if tdef.function_serialized:
            assert jdef.resources.tpu_config.tpu_type == "v5e-4" and tdef.resources.gpu_config.gpu_type == "H100"
            jdef.resources.ClearField("tpu_config")
            tdef.resources.ClearField("gpu_config")
            assert modal_tpu_torch.serialization.deserialize(tdef.function_serialized)(21) == 42
            jdef.ClearField("function_serialized")
            tdef.ClearField("function_serialized")
        else:  # the file function: found again by module and name
            assert tdef.module_name == "tests.test_torch_app_objects" and tdef.definition_type == "file"
        assert tdef.SerializeToString(deterministic=True) == jdef.SerializeToString(deterministic=True)
        assert (tr.app_id, tr.tag) == (jr.app_id, jr.tag)


def test_what_waits_is_refused_naming_its_sub_slice(tmp_path, planes):  # noqa: F811
    app = modal_tpu_torch.App("refused")
    # runtime_debug= is accepted since the metrics plane (4d-ii): it rides
    # experimental_options, as in the JAX package
    debug = app.function(runtime_debug=True, serialized=True)(lambda: 0)
    assert debug._spec.experimental_options == {"runtime_debug": "1"}
    # volumes= is accepted since the storage slice (4d-i), on the App too
    modal_tpu_torch.App("with-volumes", volumes={"/data": object()})
    with pytest.raises(modal_tpu_torch.exception.InvalidError, match="gpu="):
        app.function(tpu="v5e-4")
    # proxy= is accepted since the SDK's objects (4e-objects); cloud= still waits
    proxied = app.function(proxy=modal_tpu_torch.Proxy.from_name("egress"), serialized=True)(lambda: 0)
    assert proxied._spec.proxy is not None
    with pytest.raises(modal_tpu_torch.exception.InvalidError, match="4e"):
        app.function(cloud="aws")
    # a Cron is validated as the JAX package validates it
    for bad in ("* * *", "61 * * * *", "*/0 * * * *"):
        with pytest.raises(modal_tpu.exception.InvalidError):
            modal_tpu.Cron(bad)
        with pytest.raises(modal_tpu_torch.exception.InvalidError):
            modal_tpu_torch.Cron(bad)
    good = "5 4 * * 1-5"
    assert modal_tpu_torch.Cron(good).to_proto().SerializeToString() == modal_tpu.Cron(good).to_proto().SerializeToString()
    # since the cron loop (4c-ii) the port's plane takes a schedule, and a
    # plain function's web URL is refused as no web endpoint
    import grpc

    sched = modal_tpu_torch.App("scheduled")
    fn = sched.function(serialized=True, schedule=modal_tpu_torch.Period(hours=1))(lambda: 1)
    with sched.run(client=planes.tclient):
        assert planes.tsup.state.functions[fn.object_id].definition.schedule.period.hours == 1
        with pytest.raises(grpc.aio.AioRpcError, match="no web endpoint"):
            fn.get_web_url(timeout=1)


# ---------------------------------------------------------------------------
# step 0: with_options binds and secrets at placement, over raw RPCs
# ---------------------------------------------------------------------------


def _rpc(planes, m, name, request):
    from modal_tpu._utils.async_utils import synchronizer as jsync
    from modal_tpu._utils.grpc_utils import retry_transient_errors as jretry
    from modal_tpu_torch._utils.async_utils import synchronizer as tsync
    from modal_tpu_torch._utils.grpc_utils import retry_transient_errors as tretry

    client, _sup = planes.of(m)
    sync, retry = (jsync, jretry) if m is modal_tpu else (tsync, tretry)
    return sync.run(retry(getattr(client.stub, name), request))


def _raw_function(planes, m, api, fn, **fields):
    app_id = _rpc(planes, m, "AppCreate", api.AppCreateRequest(description="raw")).app_id
    fdef = api.Function(function_name="raw", definition_type="serialized", function_serialized=serialize(fn),
                        **fields)
    fdef.autoscaler_settings.scaledown_window = 600
    fn_id = _rpc(planes, m, "FunctionCreate", api.FunctionCreateRequest(app_id=app_id, function=fdef)).function_id
    return app_id, fn_id


def test_bind_params_merges_secrets_as_jax_does(planes):  # noqa: F811
    """Sent to both planes, one bind request replaces the parent's secrets
    alike (and merges its timeout)."""
    got = {}
    for m, api in ((modal_tpu, japi), (modal_tpu_torch, api_pb2)):
        _app, fn_id = _raw_function(planes, m, api, lambda: 1, secret_ids=["st-parent"])
        opts = api.FunctionOptions(replace_secrets=True, secret_ids=["st-a", "st-b"], timeout_secs=9)
        bound = _rpc(planes, m, "FunctionBindParams",
                     api.FunctionBindParamsRequest(function_id=fn_id, options=opts)).bound_function_id
        d = planes.of(m)[1].state.functions[bound].definition
        got[m.__name__] = (list(d.secret_ids), d.timeout_secs)
    assert got["modal_tpu_torch"] == got["modal_tpu"] == (["st-a", "st-b"], 9)


def test_bind_params_refuses_a_tpu_override(planes):  # noqa: F811
    """The port's plane refuses a bound variant that asks for TPU chips with
    the text its FunctionCreate gives, and merges a card override."""
    _app, fn_id = _raw_function(planes, modal_tpu_torch, api_pb2, lambda: 1)
    tpu = api_pb2.FunctionOptions(has_tpu=True)
    tpu.tpu_config.tpu_type = "v5e-4"
    with pytest.raises(Exception, match="asks for TPU chips, which this control plane does not place"):
        _rpc(planes, modal_tpu_torch, "FunctionBindParams",
             api_pb2.FunctionBindParamsRequest(function_id=fn_id, options=tpu))
    gpu = api_pb2.FunctionOptions(has_gpu=True)
    gpu.gpu_config.gpu_type, gpu.gpu_config.count = "H100", 2
    bound = _rpc(planes, modal_tpu_torch, "FunctionBindParams",
                 api_pb2.FunctionBindParamsRequest(function_id=fn_id, options=gpu)).bound_function_id
    cfg = planes.tsup.state.functions[bound].definition.resources.gpu_config
    assert (cfg.gpu_type, cfg.count) == ("H100", 2)


def test_a_secret_reaches_the_container_env_on_both_planes(planes):  # noqa: F811
    """SecretGetOrCreate, then a function created with that secret: the
    container sees the variable (the scheduler resolves secret_ids into the
    container's env at placement)."""

    def read_env():
        import os as _os

        return _os.environ.get("PLACED_SECRET")

    got = {}
    for m, api in ((modal_tpu, japi), (modal_tpu_torch, api_pb2)):
        secret_id = _rpc(planes, m, "SecretGetOrCreate", api.SecretGetOrCreateRequest(
            env_dict={"PLACED_SECRET": "ps-1"},
            object_creation_type=api.OBJECT_CREATION_TYPE_ANONYMOUS_OWNED_BY_APP)).secret_id
        _app, fn_id = _raw_function(planes, m, api, read_env, secret_ids=[secret_id])
        item = api.FunctionPutInputsItem(idx=0, input=api.FunctionInput(args=serialize(((), {}))))
        call_id = _rpc(planes, m, "FunctionMap",
                       api.FunctionMapRequest(function_id=fn_id, pipelined_inputs=[item])).function_call_id
        deadline = time.monotonic() + 60
        outputs = []
        while not outputs:
            assert time.monotonic() < deadline
            outputs = _rpc(planes, m, "FunctionGetOutputs", api.FunctionGetOutputsRequest(
                function_call_id=call_id, timeout=10, clear_on_success=True)).outputs
        got[m.__name__] = modal_tpu_torch.serialization.deserialize(outputs[0].result.data)
    assert got == {"modal_tpu": "ps-1", "modal_tpu_torch": "ps-1"}


# ---------------------------------------------------------------------------
# the invocation surface
# ---------------------------------------------------------------------------


def test_starmap_for_each_gather_and_get_gen(planes):  # noqa: F811
    sink_root = planes.root

    def scenario(m, client, sup):
        app = m.App("surface")
        sink = os.path.join(sink_root, f"sink-{m.__name__}")
        os.makedirs(sink, exist_ok=True)

        @app.function(serialized=True)
        def add(a, b):
            return a + b

        @app.function(serialized=True)
        def record(x):
            import os as _os

            if x < 0:
                raise ValueError("negative")
            with open(_os.path.join(sink, f"k{x}"), "w") as fh:
                fh.write(str(x * x))

        @app.function(serialized=True)
        def gen(n):
            for i in range(n):
                yield i * 3

        @app.function(serialized=True)
        def work(x):
            if x == 13:
                raise ValueError("unlucky")
            return x * 2

        out = {}
        with app.run(client=client):
            out["starmap"] = sorted(add.starmap([(1, 2), (10, 20), (100, 200)]))
            record.for_each([1, 2, 3])
            record.for_each([4, -1], ignore_exceptions=True)
            out["for_each"] = {n: open(os.path.join(sink, n)).read() for n in sorted(os.listdir(sink))}
            call = gen.spawn(4)
            out["get_gen"] = list(call.get_gen())
            again = m.FunctionCall.from_id(call.object_id)
            again._is_generator = True
            out["again"] = list(again.get_gen())
            unary = work.spawn(5)
            out["unary"] = unary.get(timeout=30)
            detached = m.FunctionCall.from_id(unary.object_id)
            detached._is_generator = True
            try:
                list(detached.get_gen())
            except m.exception.InvalidError as exc:
                out["get_gen_on_unary"] = "unary result" in str(exc)
            out["gather"] = m.FunctionCall.gather(*[work.spawn(i) for i in (1, 2, 3)])
            try:
                m.FunctionCall.gather(work.spawn(1), work.spawn(13))
            except Exception as exc:  # noqa: BLE001 — the error is part of the result
                out["gather_error"] = (type(exc).__name__, "unlucky" in str(exc))
        return out

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"]["starmap"] == [3, 30, 300] and got["port"]["get_gen"] == [0, 3, 6, 9]
    assert got["port"]["for_each"] == {"k1": "1", "k2": "4", "k3": "9", "k4": "16"}
    assert got["port"]["gather"] == [2, 4, 6] and got["port"]["get_gen_on_unary"] is True


def test_include_update_autoscaler_and_secrets_in_env(planes):  # noqa: F811
    def scenario(m, client, sup):
        m.Secret.create_deployed(f"deployed-creds-{m.__name__}", {"DEPLOYED_KEY": "dk-123"}, client=client)
        lib = m.App("lib")

        @lib.function(serialized=True, name="lib_fn")
        def lib_fn(x):
            return x * 10

        main = m.App("main")

        @main.function(serialized=True, name="main_fn", scaledown_window=1)
        def main_fn(x):
            return x + 1

        @main.function(serialized=True, name="read_env", secrets=[
            m.Secret.from_dict({"INLINE_KEY": "ik-456"}), m.Secret.from_name(f"deployed-creds-{m.__name__}")])
        def read_env():
            import os as _os

            return _os.environ.get("INLINE_KEY"), _os.environ.get("DEPLOYED_KEY")

        main.include(lib)
        out = {"registered": sorted(main.registered_functions)}
        with main.run(client=client):
            out["calls"] = [main_fn.remote(1), lib_fn.remote(3)]
            out["env"] = read_env.remote()
            fn_state = next(f for f in list(sup.state.functions.values())
                            if f.tag == "main_fn" and f.app_id == main.app_id)
            task = next(sup.state.tasks[tid] for tid in fn_state.task_ids)
            out["blocked"] = [sup.servicer._scaledown_blocked(fn_state, task)]
            main_fn.update_autoscaler(min_containers=1)
            out["blocked"].append(sup.servicer._scaledown_blocked(fn_state, task))
            out["min_containers"] = fn_state.autoscaler.min_containers
        return out

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == {"registered": ["lib_fn", "main_fn", "read_env"], "calls": [2, 30],
                           "env": ("ik-456", "dk-123"), "blocked": [False, True], "min_containers": 1}


def test_deploy_then_call_by_name(planes):  # noqa: F811
    """app.deploy() publishes the app under its name; Function.from_name
    finds the function again and calls it."""

    def scenario(m, client, sup):
        app = m.App(f"deployed-{m.__name__}")

        @app.function(serialized=True, name="triple", scaledown_window=2)
        def triple(x):
            return 3 * x

        app.deploy(client=client)
        return m.Function.from_name(f"deployed-{m.__name__}", "triple").remote(5)

    assert planes.both(scenario) == {"jax": 15, "port": 15}


# ---------------------------------------------------------------------------
# map failures
# ---------------------------------------------------------------------------


def test_map_retries_and_exhausted_retries(planes):  # noqa: F811
    root = planes.root

    def scenario(m, client, sup):
        app = m.App("map-retry")
        attempts = os.path.join(root, f"attempts-{m.__name__}")
        os.makedirs(attempts, exist_ok=True)

        def flaky(x):
            import os as _os

            marker = _os.path.join(attempts, str(x))
            with open(marker, "a") as fh:
                fh.write("x")
            if _os.path.getsize(marker) == 1:
                raise ValueError(f"transient {x}")
            return x * 10

        def always_fails(x):
            raise RuntimeError(f"perma {x}")

        f = app.function(serialized=True, retries=m.Retries(max_retries=2, initial_delay=0.1))(flaky)
        g = app.function(serialized=True, retries=m.Retries(max_retries=1, initial_delay=0.1))(always_fails)
        out = {}
        with app.run(client=client):
            out["retried"] = list(f.map([1, 2, 3]))
            try:
                list(g.map([1, 2]))
            except RuntimeError as exc:
                out["exhausted"] = "perma" in str(exc)
            outs = list(g.map([1], return_exceptions=True))
            out["returned"] = [type(o).__name__ for o in outs]
        out["attempts"] = sorted(os.path.getsize(os.path.join(attempts, str(x))) for x in (1, 2, 3))
        return out

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == {"retried": [10, 20, 30], "exhausted": True, "returned": ["RuntimeError"],
                           "attempts": [2, 2, 2]}


def test_map_survives_a_killed_container_and_a_lost_input(planes, monkeypatch):  # noqa: F811
    monkeypatch.setattr(modal_tpu.parallel_map, "LOST_INPUT_CHECK_PERIOD", 1.0)
    monkeypatch.setattr(modal_tpu_torch.parallel_map, "LOST_INPUT_CHECK_PERIOD", 1.0)

    def scenario(m, client, sup):
        app = m.App("map-kill")

        def slowish(x):
            import os as _os
            import time as _t

            _t.sleep(0.3)
            return _os.getpid(), x * 2

        f = app.function(serialized=True, retries=1, max_containers=1)(slowish)
        out = {}
        with app.run(client=client):
            gen = f.map(list(range(6)), order_outputs=False)
            first_pid, first_val = next(gen)
            for proc in list(sup.workers[0]._procs.values()):
                proc.kill()
            rest = list(gen)
            out["killed"] = sorted([first_val] + [v for _pid, v in rest])
            out["replaced"] = any(pid != first_pid for pid, _v in rest)

            gen = f.map(list(range(5)), order_outputs=False)
            got = [next(gen)[1]]
            fn_state = next(s for s in list(sup.state.functions.values()) if s.app_id == app.app_id)
            for iid in list(fn_state.pending):
                inp = sup.state.inputs.get(iid)
                if inp is not None and inp.status == "pending":
                    fn_state.pending.remove(iid)
                    del sup.state.inputs[iid]
                    out["dropped"] = True
                    break
            got.extend(v for _pid, v in gen)
            out["lost"] = sorted(got)
        return out

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == {"killed": [0, 2, 4, 6, 8, 10], "replaced": True, "dropped": True,
                           "lost": [0, 2, 4, 6, 8]}


def test_spawn_map_past_the_outstanding_cap_and_the_byte_budget(planes):  # noqa: F811
    def scenario(m, client, sup):
        app = m.App("map-spawn")

        @app.function(serialized=True)
        def ident(x):
            return x

        with app.run(client=client):
            call = ident.spawn_map(range(m.parallel_map.MAX_INPUTS_OUTSTANDING + 50))
            return call.object_id.startswith("fc-")

    assert planes.both(scenario) == {"jax": True, "port": True}

    for budget_cls in (modal_tpu._utils.blob_utils._ByteBudget, modal_tpu_torch._utils.blob_utils._ByteBudget):
        async def run():
            b = budget_cls(budget=100, max_items=3)
            await b.acquire(60)
            assert b.would_block(60)
            acquired = asyncio.Event()

            async def second():
                await b.acquire(60)
                acquired.set()

            t = asyncio.create_task(second())
            await asyncio.sleep(0.05)
            assert not acquired.is_set(), "a second acquire over the budget must block"
            await b.release(60)
            await asyncio.wait_for(acquired.wait(), 1.0)
            await t
            await b.release(60)
            for _ in range(3):
                await b.acquire(1)
            assert b.would_block(1), "max_items caps the inflight count"
            for _ in range(3):
                await b.release(1)
            await asyncio.wait_for(b.acquire(10_000), 1.0)  # oversized, admitted alone
            await b.release(10_000)

        asyncio.run(run())


# ---------------------------------------------------------------------------
# the smaller modules, and the port's own state dir
# ---------------------------------------------------------------------------


def test_file_patterns_type_manager_and_running_app_match_jax():
    from modal_tpu import file_pattern_matcher as jfpm
    from modal_tpu import running_app as jra
    from modal_tpu._utils import type_manager as jtm
    from modal_tpu_torch import file_pattern_matcher as tfpm
    from modal_tpu_torch import running_app as tra
    from modal_tpu_torch._utils import type_manager as ttm

    patterns = ("**/*.pyc", "!keep/**", "build", "*.tmp", "data/?.bin")
    paths = ("a.pyc", "x/y/z.pyc", "keep/a.pyc", "build/out.o", "b.tmp", "d/b.tmp", "data/1.bin", "data/12.bin",
             "src/main.py")
    assert [tfpm.FilePatternMatcher(*patterns)(p) for p in paths] == [
        jfpm.FilePatternMatcher(*patterns)(p) for p in paths]
    fields = [("name", str, True, "tiny"), ("size", int, False, None), ("ratio", float, True, 0.5)]
    tschema, jschema = ttm.build_schema(fields), jtm.build_schema(fields)
    assert [s.SerializeToString() for s in tschema] == [s.SerializeToString() for s in jschema]
    kwargs = {"size": 3, "name": "big"}
    encoded = ttm.encode_parameter_set(tschema, kwargs)
    assert encoded == jtm.encode_parameter_set(jschema, kwargs)
    assert ttm.decode_parameter_set(encoded, tschema) == {"size": 3, "name": "big", "ratio": 0.5}
    with pytest.raises(modal_tpu_torch.exception.InvalidError):
        ttm.encode_parameter_set(tschema, {"size": "3"})
    layout = api_pb2.AppLayout()
    layout.objects["f"], layout.objects["C"] = "fu-1", "cs-2"
    jlayout = japi.AppLayout.FromString(layout.SerializeToString())
    assert vars(tra.running_app_from_layout("ap-1", layout)) == vars(jra.running_app_from_layout("ap-1", jlayout))


def test_the_port_does_not_recover_a_jax_default_journal(tmp_path):
    """Both packages' planes journal under their default state dir; the
    port's is its own (~/.modal_tpu_torch_state), so a plane `app.run()`
    boots does not replay the apps a JAX run left in ~/.modal_tpu_state."""
    code = textwrap.dedent(
        """
        import os
        from modal_tpu.config import config as jconfig
        from modal_tpu.server.journal import Journal
        from modal_tpu_torch._utils.async_utils import synchronizer
        from modal_tpu_torch.config import config
        from modal_tpu_torch.server.supervisor import LocalSupervisor

        home = os.path.expanduser("~")
        assert jconfig["state_dir"] == os.path.join(home, ".modal_tpu_state")
        j = Journal(jconfig["state_dir"])
        j.append("app", app_id="ap-00000042", description="jax", state=1, environment_name="")
        j.close()
        assert config["state_dir"] == os.path.join(home, ".modal_tpu_torch_state"), config["state_dir"]
        sup = LocalSupervisor(num_workers=1, worker_gpus=1, worker_gpu_type="local-sim")
        synchronizer.run(sup.start())
        try:
            print("apps", sorted(sup.state.apps), "report", sup.recovery_report, "dir", sup.state_dir)
        finally:
            synchronizer.run(sup.stop())
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("MODAL_TPU_STATE_DIR")}
    env.update(HOME=str(tmp_path), PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"apps [] report None dir {tmp_path / '.modal_tpu_torch_state'}" in proc.stdout, proc.stdout
