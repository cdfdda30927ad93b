"""The port's counterparts of the JAX package's tests/test_api_parity.py.

Its twelve tests, and where each is held for the port:

- `test_every_implemented_rpc_is_instrumented`,
  `test_every_emitted_span_is_in_catalog`,
  `test_parameter_init_false_default_applies`,
  `test_parameter_rejects_mixed_init`, `test_mount_ignore_patterns` and
  `test_blob_http_routes_chaos_and_metrics_parity`: here, the AST rules run
  over `modal_tpu_torch/` and the rest through both packages side by side.
- `test_every_mutating_rpc_is_journal_covered`: the port journals,
  exempts and dedupes the RPCs JAX's table does
  (`tests/test_torch_journal.py::test_every_jax_record_type_is_applied_or_named`).
- `test_parameter_synthesized_constructor`: through both planes
  (`tests/test_torch_app.py::test_cls_parametrized_bind_and_parameter_fields`).
- `test_probe_objects`: `tests/test_torch_sandbox.py::test_sandbox_readiness_probe`
  and `::test_sandbox_readiness_probe_sandbox_dies_first`.
- `test_environment_object`:
  `tests/test_torch_objects.py::test_environments_and_workspace_settings_equal_jax`.
- `test_file_pattern_matcher`:
  `tests/test_torch_app_objects.py::test_file_patterns_type_manager_and_running_app_match_jax`.
- `test_fastapi_endpoint_alias_and_web_server`: the alias's definition
  (`tests/test_torch_web.py::test_a_web_function_definition_reaches_the_plane_with_min_containers`)
  and a `@web_server` behind the reverse proxy
  (`tests/test_torch_web.py::test_the_four_web_types_answer_the_same_bodies_on_both_planes`).
"""

import ast
import importlib

import numpy as np
import pytest

import modal_tpu
import modal_tpu_torch


@pytest.fixture(scope="module")
def src_modules():
    from modal_tpu_torch.analysis.core import load_modules

    return {m.relpath: m for m in load_modules()}


def _implemented_rpcs(module, class_name: str) -> set:
    for cls in module.index.classes:
        if cls.name == class_name:
            return {node.name for node in cls.body
                    if isinstance(node, ast.AsyncFunctionDef) and node.name[:1].isupper()}
    raise AssertionError(f"class {class_name} not found in {module.relpath}")


@pytest.mark.parametrize("relpath, class_name", [
    ("server/services.py", "ModalTPUServicer"),
    ("server/input_plane.py", "InputPlaneServicer"),
    ("server/task_router.py", "TaskRouterServicer"),
])
def test_every_implemented_rpc_is_instrumented(src_modules, relpath, class_name):
    """Every RPC a servicer implements is in the RPC registry that
    proto/rpc.py wraps with the latency and count instruments."""
    from modal_tpu_torch.observability import METRIC_CATALOG, instrumented_rpc_names

    implemented = _implemented_rpcs(src_modules[relpath], class_name)
    assert implemented, f"{class_name} implements no RPCs?"
    assert not implemented - instrumented_rpc_names(), sorted(implemented - instrumented_rpc_names())
    for family in ("modal_tpu_rpc_latency_seconds", "modal_tpu_rpc_total", "modal_tpu_client_rpc_latency_seconds"):
        assert family in METRIC_CATALOG


# the families whose help text is not the JAX package's: they count the
# port's own machinery (kernel builds and graph captures for XLA's compiles,
# torch's memory stats) or a label set without values the port never emits
PORT_HELP = {
    "modal_tpu_compile_cache_errors_total", "modal_tpu_compile_cache_hits_total",
    "modal_tpu_compile_cache_misses_total", "modal_tpu_compile_cache_puts_total", "modal_tpu_compile_events_total",
    "modal_tpu_compile_seconds", "modal_tpu_device_memory_bytes", "modal_tpu_dispatch_exchange_total",
    "modal_tpu_warm_pool_evictions_total", "modal_tpu_warm_pool_placements_total",
}


def test_the_catalogs_are_the_jax_packages_under_the_ports_differences():
    """The metric catalog is JAX's families under JAX's help texts (but
    those of PORT_HELP) and the port's kernel-launch gauge; the RPC registry
    is JAX's."""
    from modal_tpu.observability import catalog as jcat
    from modal_tpu_torch.observability import catalog as tcat

    assert set(tcat.METRIC_CATALOG) - set(jcat.METRIC_CATALOG) == {"modal_tpu_kernel_launches"}
    assert set(jcat.METRIC_CATALOG) <= set(tcat.METRIC_CATALOG)
    differ = {n for n, text in jcat.METRIC_CATALOG.items() if tcat.METRIC_CATALOG[n] != text}
    assert differ == PORT_HELP and all(tcat.METRIC_CATALOG.values())
    assert tcat.instrumented_rpc_names() == jcat.instrumented_rpc_names()
    for name in ("x", "rpc.server.", "rpc.server.FunctionMap", "rpc.", "function.call", "container.import_torch"):
        assert tcat.declared_span_name(name) == (name in tcat.SPAN_CATALOG or name.startswith(("rpc.server.",
                                                                                                "rpc.client.")))


def _emitted_spans(src_modules) -> dict:
    """The JAX test's rule: the literal first argument of every
    tracing.span/open_span/record_span call (an f-string as its literal
    prefix)."""
    emitted: dict = {}
    for mod in src_modules.values():
        for node in mod.index.calls:
            if not node.args:
                continue
            func = node.func
            name = getattr(func, "attr", None) or getattr(func, "id", None)
            if name not in ("span", "open_span", "record_span"):
                continue
            if isinstance(func, ast.Attribute):
                owner = func.value
                if (getattr(owner, "attr", None) or getattr(owner, "id", None)) not in ("tracing", "_tracing"):
                    continue
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(first.value, str):
                emitted.setdefault(first.value, []).append(mod.relpath)
            elif isinstance(first, ast.JoinedStr):
                prefix = ""
                for part in first.values:
                    if not (isinstance(part, ast.Constant) and isinstance(part.value, str)):
                        break
                    prefix += part.value
                emitted.setdefault(prefix, []).append(mod.relpath)
    return emitted


def test_every_emitted_span_is_in_catalog(src_modules):
    from modal_tpu_torch.observability.catalog import SPAN_CATALOG, declared_span_name

    emitted = _emitted_spans(src_modules)
    assert "function.call" in emitted and "user.execute" in emitted and "coldstart.park" in emitted
    undeclared = {name: paths[0] for name, paths in emitted.items() if not declared_span_name(name)}
    assert not undeclared, f"span names emitted but not declared in SPAN_CATALOG: {undeclared}"

    def _covers(entry: str) -> bool:
        if entry.endswith(".*"):
            return any(n.startswith(entry[:-1]) for n in emitted)
        return entry in emitted

    assert not [e for e in SPAN_CATALOG if not _covers(e)], "SPAN_CATALOG declares spans nothing emits"


def test_the_span_catalog_keeps_the_jax_packages_entries():
    """Every JAX entry is the port's too, under its name; the port's own
    entries each say that they are the port's."""
    from modal_tpu.observability.catalog import SPAN_CATALOG as JAX_SPANS
    from modal_tpu_torch.observability.catalog import SPAN_CATALOG

    assert set(JAX_SPANS) <= set(SPAN_CATALOG)
    for name in set(SPAN_CATALOG) - set(JAX_SPANS):
        assert SPAN_CATALOG[name].startswith("the port's: "), name


@pytest.mark.parametrize("m", [modal_tpu, modal_tpu_torch], ids=["jax", "port"])
def test_parameter_init_false_default_applies(m):
    cls_mod = importlib.import_module(f"{m.__name__}.cls")

    class M:
        x: int = m.parameter(default=1)
        cache: dict = m.parameter(init=False, default=None)
        unset: int = m.parameter(init=False)

    cls_mod._apply_parameter_constructor(M)
    obj = M()
    assert obj.x == 1 and obj.cache is None
    assert M(x=5).x == 5
    with pytest.raises(TypeError):
        M(cache={})
    with pytest.raises(AttributeError):
        obj.unset


@pytest.mark.parametrize("m", [modal_tpu, modal_tpu_torch], ids=["jax", "port"])
def test_parameter_rejects_mixed_init(m):
    cls_mod = importlib.import_module(f"{m.__name__}.cls")
    exc_mod = importlib.import_module(f"{m.__name__}.exception")

    class Mixed:
        x: int = m.parameter(default=1)

        def __init__(self):
            pass

    with pytest.raises(exc_mod.InvalidError, match="mixes"):
        cls_mod._apply_parameter_constructor(Mixed)


@pytest.mark.parametrize("ignore", [["**/*.pyc", "__pycache__"], "**/*.pyc"], ids=["list", "one_string"])
def test_mount_ignore_patterns(tmp_path, ignore):
    from modal_tpu.mount import _Mount as JaxMount
    from modal_tpu_torch.mount import _Mount

    src = tmp_path / "src"
    (src / "__pycache__").mkdir(parents=True)
    (src / "pkg").mkdir()
    for rel in ("app.py", "junk.pyc", "__pycache__/c.pyc", "pkg/mod.py", "pkg/mod.pyc"):
        (src / rel).write_text("x")
    got = sorted(str(e.local_path.relative_to(src)) for e in _Mount.from_local_dir(src, ignore=ignore)._entries)
    want = sorted(str(e.local_path.relative_to(src)) for e in JaxMount.from_local_dir(src, ignore=ignore)._entries)
    assert got == want == ["app.py", "pkg/mod.py"]


def test_blob_http_routes_chaos_and_metrics_parity(tmp_path):
    """Every blob route of the port's blob server passes through the seeded
    chaos injection under its pseudo-RPC name, and counts the blob bytes and
    requests: for a ranged response, the range's bytes."""
    from modal_tpu.chaos import BLOB_RPCS as JAX_BLOB_RPCS
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch._utils.blob_utils import _get_range, _put_url
    from modal_tpu_torch.chaos import BLOB_RPCS, ChaosPolicy
    from modal_tpu_torch.exception import ExecutionError
    from modal_tpu_torch.observability.catalog import BLOB_BYTES, BLOB_REQUESTS
    from modal_tpu_torch.proto import api_pb2
    from modal_tpu_torch.server.blob_server import BlobServer
    from modal_tpu_torch.server.state import ServerState, VolumeState

    assert set(BLOB_RPCS) == set(JAX_BLOB_RPCS)
    assert {"BlobPut", "BlobGet", "BlobPutPart", "BlobComplete", "BlockGet", "VolumeFileGet"} <= set(BLOB_RPCS)
    state = ServerState(str(tmp_path / "state"))
    data = np.random.default_rng(0).integers(0, 256, size=1 << 20, dtype=np.uint8).tobytes()
    with open(state.blob_path("bl-parity"), "wb") as f:
        f.write(data)
    sha = "ab" * 32
    with open(state.block_path(sha), "wb") as f:
        f.write(data)
    state.volumes["vo-parity"] = VolumeState(volume_id="vo-parity")
    state.volumes["vo-parity"].files["ckpt/w.bin"] = api_pb2.VolumeFile(
        path="ckpt/w.bin", size=len(data), block_sha256_hex=[sha])

    chaos = ChaosPolicy(seed=7, error_rates={rpc: 1.0 for rpc in BLOB_RPCS})
    srv = BlobServer(state, chaos=chaos)
    url = synchronizer.run(srv.start())
    try:
        for route_url, rpc in [(f"{url}/blob/bl-parity", "BlobGet"), (f"{url}/block/{sha}", "BlockGet"),
                               (f"{url}/volfile/vo-parity/ckpt/w.bin", "VolumeFileGet")]:
            with pytest.raises(ExecutionError):
                synchronizer.run(_get_range(route_url, 0, 100))
            assert chaos.injected.get(rpc, 0) > 0, f"{rpc} not injected"
        with pytest.raises(ExecutionError):
            synchronizer.run(_put_url(f"{url}/blob/bl-parity2", b"x"))
        assert chaos.injected.get("BlobPut", 0) > 0

        chaos.error_rates = {}
        for route_url, route in [(f"{url}/blob/bl-parity", "get"), (f"{url}/block/{sha}", "block_get"),
                                 (f"{url}/volfile/vo-parity/ckpt/w.bin", "volfile")]:
            out_before = BLOB_BYTES.value(direction="out")
            assert synchronizer.run(_get_range(route_url, 1000, 5000)) == data[1000:5000]
            assert BLOB_BYTES.value(direction="out") - out_before == 4000
            assert BLOB_REQUESTS.value(route=route, code="206") > 0
        in_before = BLOB_BYTES.value(direction="in")
        synchronizer.run(_put_url(f"{url}/blob/bl-streamed", [memoryview(data[:100_000])]))
        assert BLOB_BYTES.value(direction="in") - in_before == 100_000
    finally:
        synchronizer.run(srv.stop())
