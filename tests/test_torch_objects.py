"""The SDK's objects of the port (Dict, Queue, Proxy, Environment,
Workspace) against the JAX package's: the same script of operations runs
through `modal_tpu` against its plane and through `modal_tpu_torch` against
the port's, and the results must be equal. Also: ephemeral objects reaped
under a small `MODAL_TPU_EPHEMERAL_TTL`, named objects surviving a
`crash_restart` while their contents do not (as in the JAX package), and a
tensor value coming back on the kind of device it left (ROADMAP Queue C 10).

The planes are tests.test_torch_app's (one per package for the module).
"""

import os
import tempfile
import threading
import time

import grpc
import pytest
import torch

import modal_tpu
import modal_tpu_torch
from modal_tpu._utils.async_utils import synchronizer as jsync
from modal_tpu.client import _Client as JaxClient
from modal_tpu.server.supervisor import LocalSupervisor as JaxSupervisor
from modal_tpu_torch._utils.async_utils import synchronizer as tsync
from modal_tpu_torch.client import _Client
from modal_tpu_torch.server.supervisor import LocalSupervisor
from tests.test_torch_app import planes  # noqa: F401 — the module-scoped fixture


def _sync(m):
    return jsync if m is modal_tpu else tsync


def test_dict_operations_equal_jax(planes):  # noqa: F811
    def scenario(m, client, sup):
        d = m.Dict.lookup("objects-dict", client=client, create_if_missing=True)
        out = [d.put("a", 1), d.put("a", 2, skip_if_exists=True), d.get("a"), d.put("a", 3), d.get("a")]
        d.update({"b": [1, 2]}, c="x")
        out += [d.pop("c"), d.contains("b"), d.contains("zz"), d.len(), d.get("missing", "dflt")]
        out += [sorted(d.keys()), sorted(map(repr, d.values())), sorted((k, repr(v)) for k, v in d.items())]
        try:
            d.pop("zz")
            out.append("no KeyError")
        except KeyError:
            out.append("KeyError")
        d.put(("tuple", 1), {"nested": [1.5, None]})
        out.append(d.get(("tuple", 1)))
        d.clear()
        out += [d.len(), list(d.keys())]
        same = m.Dict.lookup("objects-dict", client=client)
        out.append(same.object_id == d.object_id)
        m.Dict.delete("objects-dict", client=client)
        try:
            m.Dict.lookup("objects-dict", client=client)
            out.append("still there")
        except Exception as exc:  # noqa: BLE001 — NOT_FOUND, as each package raises it
            out.append("not found" if "not found" in str(exc) else repr(exc))
        return out

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][:5] == [True, False, 1, True, 3] and got["port"][-1] == "not found"


def test_queue_operations_equal_jax(planes):  # noqa: F811
    def scenario(m, client, sup):
        q = m.Queue.ephemeral(client=client)
        q.put(1)
        q.put_many([2, 3, 4])
        out = [q.get(), q.get_many(2), q.len()]
        q.put("p1", partition="a")
        q.put_many(["p2", "p3"], partition="a")
        out += [q.len(partition="a"), q.len(total=True), q.get(partition="a")]
        out.append(list(q.iterate(partition="a")))  # non-destructive
        out.append(q.len(partition="a"))
        out.append(q.get(block=False, partition="b"))  # empty, no wait
        t0 = time.monotonic()
        try:
            q.get(timeout=0.3, partition="b")
            out.append("no timeout")
        except TimeoutError as exc:
            out.append(type(exc).__name__)
        out.append(time.monotonic() - t0 >= 0.3)
        # a blocking get returns once another thread puts
        threading.Timer(0.3, lambda: q.put("late", partition="c")).start()
        out.append(q.get(timeout=10, partition="c"))
        q.clear(partition="a")
        out += [q.len(partition="a"), q.len(total=True)]
        q.put("x")
        q.clear(all=True)
        out.append(q.len(total=True))
        try:
            q.put(1, partition="")
            out.append("empty partition accepted")
        except Exception as exc:  # noqa: BLE001
            out.append(type(exc).__name__)
        named = m.Queue.lookup("objects-queue", client=client, create_if_missing=True)
        named.put("kept")
        out.append(m.Queue.lookup("objects-queue", client=client).len())
        return out

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][:3] == [1, [2, 3], 1] and "late" in got["port"]


def test_proxy_create_lookup_delete_and_a_proxied_function(planes):  # noqa: F811
    def scenario(m, client, sup):
        p = m.Proxy.create("objects-egress", client=client)
        looked = m.Proxy.lookup("objects-egress", client=client)
        ip = sup.state.proxies[p.object_id].proxy_ip
        out = [p.object_id[:3], looked.object_id == p.object_id, ip]
        try:
            m.Proxy.create("objects-egress", client=client)
            out.append("created twice")
        except Exception as exc:  # noqa: BLE001
            out.append("exists" if "exists" in str(exc) else repr(exc))
        app = m.App("proxied")

        def report_ip():
            import os as _os

            return _os.environ.get("MODAL_TPU_PROXY_IP", "")

        f = app.function(serialized=True, proxy=m.Proxy.from_name("objects-egress"))(report_ip)
        with app.run(client=client):
            fn_state = sup.state.functions[f.object_id]
            out += [fn_state.definition.proxy_id == p.object_id, f.remote() == ip]
        m.Proxy.delete("objects-egress", client=client)
        try:
            m.Proxy.lookup("objects-egress", client=client)
            out.append("still there")
        except Exception as exc:  # noqa: BLE001
            out.append("not found" if "not found" in str(exc) else repr(exc))
        return out

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == ["pr-", True, "10.250.0.2", "exists", True, True, "not found"]


def test_handles_passed_to_a_function_reach_its_container(planes):  # noqa: F811
    """A Queue and a Dict passed as arguments are rebound to the container's
    client (the port's container loads their modules on demand): what the
    function puts and writes, the caller reads. The JAX package's container
    cannot unpickle them (its lazy package never imported the modules that
    register the "qu" and "di" prefixes): the reference's own fault, ROADMAP
    Queue C 36."""

    def scenario(m, client, sup):
        q, d = m.Queue.ephemeral(client=client), m.Dict.ephemeral(client=client)
        app = m.App("handles")

        def produce(queue, texts, n):
            for i in range(n):
                queue.put({"step": i})
            texts["done"] = n
            return queue.len(), texts.len()

        f = app.function(serialized=True)(produce)
        with app.run(client=client):
            try:
                lens = f.remote(q, d, 3)
            except Exception as exc:  # noqa: BLE001 — the JAX package's container fails to unpickle
                return ["raised", str(exc)]
        return [lens, q.get_many(3), d.get("done")]

    got = planes.both(scenario)
    assert got["jax"][0] == "raised" and "unknown object id prefix 'qu'" in got["jax"][1]
    assert got["port"] == [(3, 1), [{"step": 0}, {"step": 1}, {"step": 2}], 3]


def test_environments_and_workspace_settings_equal_jax(planes):  # noqa: F811
    """Environments' CRUD, the settings validated by the plane, and
    `image_builder_version` taking effect: a client's handshake advertises
    it, its images are stamped with that epoch, and the built image carries
    that epoch's env (the port: no NVIDIA_TF32_OVERRIDE in 2026.04; JAX: no
    LIBTPU_INIT_ARGS)."""
    assert "MODAL_TPU_IMAGE_BUILDER_VERSION" not in os.environ

    def scenario(m, client, sup):
        Environment = m.Environment
        staging = Environment.create("objects-staging", client=client)
        out = [sorted(e.name for e in Environment.list(client=client))]
        staging.rename("objects-stage")
        out.append(sorted(e.name for e in Environment.list(client=client)))
        try:
            Environment.from_name("objects-staging", client=client)
            out.append("found")
        except Exception as exc:  # noqa: BLE001
            out.append(type(exc).__name__)
        ws = m.Workspace.from_context()
        ws.hydrate(client)
        out += [ws.name, ws.settings.list()]
        for name, value in (("no_such_setting", "x"), ("image_builder_version", "1999.01"),
                            ("default_environment", "nope")):
            try:
                ws.settings.set(name, value)
                out.append("accepted")
            except Exception as exc:  # noqa: BLE001
                out.append(exc.code().name if isinstance(exc, grpc.RpcError) else type(exc).__name__)
        ws.settings.set("default_environment", "objects-stage")
        ws.settings.set("image_builder_version", "2026.04")
        out.append(ws.settings.list())
        # the setting reaches a fresh client's handshake and its images
        fresh = type(client)(sup.server_url)
        fresh._open()
        fresh.hello()
        try:
            out.append(fresh.image_builder_version)
            app = m.App("epoch-setting")
            image = m.Image.debian_slim().env({"OBJECTS_EPOCH": "1"})

            def read_env():
                import os as _os

                return sorted(k for k in ("NVIDIA_TF32_OVERRIDE", "LIBTPU_INIT_ARGS") if k in _os.environ)

            f = app.function(image=image, serialized=True)(read_env)
            with app.run(client=fresh):
                out.append(sup.state.images[image.object_id].definition.version)
                out.append(f.remote())
                # an app created with no environment lands in the default one
                out.append(sup.state.apps[app.app_id].environment_name)
        finally:
            fresh._close()
            ws.settings.set("image_builder_version", "")
            ws.settings.set("default_environment", "")
        out.append(ws.settings.list())
        m.Environment.from_name("objects-stage", client=client).delete()
        out.append(sorted(e.name for e in Environment.list(client=client)))
        return out

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port[0] == ["main", "objects-staging"] and port[5:8] == ["INVALID_ARGUMENT", "INVALID_ARGUMENT", "NotFoundError"]
    assert port[9:13] == ["2026.04", "2026.04", [], "objects-stage"]


def test_ephemeral_objects_are_reaped_under_a_small_ttl(planes, monkeypatch):  # noqa: F811
    """An ephemeral dict, queue and volume whose client stops heartbeating
    are reaped once the TTL passes; a heartbeat keeps one alive; named
    objects stay."""
    monkeypatch.setenv("MODAL_TPU_EPHEMERAL_TTL", "1")

    def scenario(m, client, sup):
        from importlib import import_module

        api = import_module(f"{m.__name__}.proto.api_pb2")
        d, q, v = m.Dict.ephemeral(client=client), m.Queue.ephemeral(client=client), m.Volume.ephemeral(client=client)
        named = m.Dict.lookup("objects-keep", client=client, create_if_missing=True)
        d.put("k", 1)
        out = [sup.state.dicts[d.object_id].ephemeral, sup.state.queues[q.object_id].ephemeral]
        kept = m.Dict.ephemeral(client=client)
        time.sleep(0.6)  # inside the TTL: a heartbeat keeps `kept` alive
        out.append(_sync(m).run(client.stub.EphemeralObjectHeartbeat(
            api.EphemeralObjectHeartbeatRequest(object_id=kept.object_id))).ttl_seconds)
        time.sleep(0.6)  # the others are now past it
        # the scheduler's reap tick may have taken them already
        sup.servicer.reap_stale_ephemerals()
        out += [d.object_id in sup.state.dicts, q.object_id in sup.state.queues, v.object_id in sup.state.volumes,
                kept.object_id in sup.state.dicts, named.object_id in sup.state.dicts]
        try:
            d.get("k")
            out.append("still readable")
        except Exception as exc:  # noqa: BLE001
            out.append("not found" if "not found" in str(exc) else repr(exc))
        return out

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == [True, True, 1.0, False, False, False, True, True, "not found"]


def test_named_objects_survive_a_crash_restart_and_their_contents_do_not():
    """The registry of dicts, queues and proxies, the environments, a
    workspace setting and a granted token are journaled; a dict's and a
    queue's contents are not (as in the JAX package)."""
    root = tempfile.mkdtemp(prefix="objects-crash-", dir="/tmp")
    results = {}
    for name, m, sup_cls, client_cls in (("jax", modal_tpu, JaxSupervisor, JaxClient),
                                         ("port", modal_tpu_torch, LocalSupervisor, _Client)):
        sync = _sync(m)
        sup = sup_cls(num_workers=0, state_dir=os.path.join(root, name))
        sync.run(sup.start())
        try:
            client = client_cls(sup.server_url)
            client._open()
            d = m.Dict.lookup("crash-dict", client=client, create_if_missing=True)
            q = m.Queue.lookup("crash-queue", client=client, create_if_missing=True)
            d.put("k", "v")
            q.put("item")
            p = m.Proxy.create("crash-egress", client=client)
            m.Environment.create("crash-env", client=client)
            ws = m.Workspace.from_context()
            ws.hydrate(client)
            ws.settings.set("image_builder_version", "2026.04")
            client._close()
            ids = (d.object_id, q.object_id, p.object_id)
            report = sync.run(sup.crash_restart())
            client = client_cls(sup.server_url)
            client._open()
            d2 = m.Dict.lookup("crash-dict", client=client)
            q2 = m.Queue.lookup("crash-queue", client=client)
            ws = m.Workspace.from_context()
            ws.hydrate(client)
            results[name] = [
                (d2.object_id, q2.object_id, m.Proxy.lookup("crash-egress", client=client).object_id) == ids,
                d2.len(), d2.get("k", "gone"), q2.len(), ws.settings.list(),
                sorted(e.name for e in m.Environment.list(client=client)), report["records_skipped"],
            ]
            client._close()
        finally:
            sync.run(sup.stop())
    assert results["port"] == results["jax"]
    assert results["port"] == [True, 0, "gone", 0, {"image_builder_version": "2026.04"}, ["crash-env", "main"], 0]


# -- a tensor value keeps the kind of device it left ---------------------------------


def test_a_cpu_tensor_value_comes_back_on_the_cpu(planes):  # noqa: F811
    client, _sup = planes.of(modal_tpu_torch)
    d = modal_tpu_torch.Dict.ephemeral(client=client)
    q = modal_tpu_torch.Queue.ephemeral(client=client)
    t = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4)
    d.put("t", t)
    q.put(t)
    for got in (d.get("t"), q.get()):
        assert got.device.type == "cpu" and got.dtype == torch.bfloat16 and torch.equal(got, t)


def test_a_cuda_tensor_value_needs_a_card_to_come_back():
    """A value that left a card rebuilds on the reader's current card; a
    process without one refuses it (as a snapshot's CUDA leaf is refused)."""
    import pickle

    from modal_tpu_torch.exception import DeserializationError
    from modal_tpu_torch.serialization import _rebuild_tensor_on

    raw = pickle.PickleBuffer(torch.arange(4, dtype=torch.float32).view(torch.uint8).numpy())
    if torch.cuda.is_available():
        t = _rebuild_tensor_on(raw, "float32", (4,), False, False, "cuda")
        assert t.device.type == "cuda" and t.cpu().tolist() == [0.0, 1.0, 2.0, 3.0]
    else:
        with pytest.raises(DeserializationError, match="no CUDA device"):
            _rebuild_tensor_on(raw, "float32", (4,), False, False, "cuda")


@pytest.mark.cuda
def test_a_cuda_tensor_put_comes_back_on_the_card(planes):  # noqa: F811
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    client, _sup = planes.of(modal_tpu_torch)
    d = modal_tpu_torch.Dict.ephemeral(client=client)
    q = modal_tpu_torch.Queue.ephemeral(client=client)
    t = torch.randn(64, 64, device="cuda", dtype=torch.bfloat16)
    d.put("t", t)
    q.put({"logits": t})
    for got in (d.get("t"), q.get()["logits"]):
        assert got.device.type == "cuda" and torch.equal(got, t)
