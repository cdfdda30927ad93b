"""Every public name of every module of the JAX package has a counterpart
in the port, or a stated reason in `DIVERGENCES`.

The JAX side is read from its sources with `ast`, never imported: for each
`.py` under `modal_tpu/` (the generated `*_pb2.py` aside), the module's
public top-level functions, classes and assigned names, the public methods
of its public classes and of each `_X` class whose public alias `X` the
module binds (the synchronized API classes: `App = synchronize_api(_App)`),
and, for an `__init__.py`, the names it imports or lists in `__all__`. The
port's counterpart module has the same path (`tpu_config.py` is
`gpu_config.py`), is imported, and must bind each name (`hasattr`, which
also resolves a module's lazy `__getattr__`); a `__main__.py` is read with
`ast` instead, since importing it runs it.

Private names (a leading underscore) are out of the audit's scope. A
`DIVERGENCES` entry that is dead, a name the port now binds or one the JAX
package no longer has, fails the audit, as `analysis/knob_catalog.py`'s
divergences are held. `tests/test_torch_namespace.py` holds the top-level
namespace itself (values, `__all__`, the star import).
"""

import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "modal_tpu")
PORT_ROOT = os.path.join(REPO, "modal_tpu_torch")
RENAMED_MODULES = {"tpu_config.py": "gpu_config.py"}

# "<module path under modal_tpu/>:<name>" -> why the port does not bind it
DIVERGENCES = {
    "__init__.py:TPUSliceSpec": "renamed GPUSpec (modal_tpu_torch.JAX_NAMES): a card ask, not a TPU slice",
    "__init__.py:parse_tpu_config": "renamed parse_gpu_config (modal_tpu_torch.JAX_NAMES)",
    "tpu_config.py:TPUSliceSpec": "gpu_config.GPUSpec: a card type and count, no slice topology",
    "tpu_config.py:TPUSliceSpec.cores": "a TPU slice's core count; a GPUSpec counts cards",
    "tpu_config.py:TPUSliceSpec.default_mesh": "a TPU slice's mesh; a GPUSpec carries mesh hints (parse_gpu_config(mesh=))",
    "tpu_config.py:TPUSliceSpec.to_proto": "a TPU slice's wire form; GPUSpec.to_proto gives a GPUConfig",
    "tpu_config.py:parse_tpu_config": "renamed gpu_config.parse_gpu_config",
    "_native/__init__.py:logger": "JAX's logs its silent hashlib fallback; the port's native routes raise instead",
    "_utils/blob_utils.py:DEFAULT_DOWNLOAD_SPILL_BYTES": "renamed DOWNLOAD_SPILL_BYTES (the same 32 MiB), read per call",
    "_utils/blob_utils.py:LARGE_FILE_LIMIT": "read nowhere in the JAX package",
    "_utils/blob_utils.py:format_blob_data": "inlined at its caller, functions._create_input, which spans the upload",
    "image.py:_Image.tpu_base": "renamed cuda_base: the CUDA base image of the builder epoch",
    "models/sampling.py:DECODE_CHUNK": "JAX pads decode to fixed jitted scans; the eager decode runs exactly the steps asked",
    "observability/federation.py:FederatedHistory.close": "the port fetches with urllib per request: no session to close",
    "observability/federation.py:FederationServer": "moved to server/shards.py, the director's HTTP surface",
    "observability/federation.py:FederationServer.start": "moved with FederationServer to server/shards.py",
    "observability/federation.py:FederationServer.stop": "moved with FederationServer to server/shards.py",
    "ops/attention.py:NEG_INF": "the plain versions mask with float('-inf'); each CUDA kernel keeps its own constant",
    "ops/attention.py:VMEM_STAGED_BUDGET_BYTES": "a TPU VMEM budget; the Hopper kernels stage tiles in shared memory",
    "ops/attention.py:flash_attention_pallas": "the Pallas entry; the port's kernel entry is flash_attention_kernel",
    "ops/paged_attention.py:NEG_INF": "the plain version masks with float('-inf'); K4 keeps its own constant",
    "parallel/mesh.py:named": "builds a jax NamedSharding; the port places DTensors (parallel.sharding.placements)",
    "parallel/sharding.py:batch_sharding": "a jax NamedSharding; the port places the batch by placements(mesh, batch_spec())",
    "runtime/compile_client.py:TieredJaxCache": "wraps jax's persistent cache; the port's fleet tier sits under ops/_build",
    "runtime/compile_client.py:TieredJaxCache.get": "see TieredJaxCache: FleetCompileCache.get under ops/_build",
    "runtime/compile_client.py:TieredJaxCache.put": "see TieredJaxCache: FleetCompileCache.put under ops/_build",
    "runtime/compile_client.py:normalize_cache_keys": "strips paths from jax's keys; the port's keys never hold a path",
    "runtime/container_entrypoint.py:initialize_clustered": "the boot calls runtime.clustered.init_cluster itself",
    "runtime/container_entrypoint.py:setup_compilation_cache": "XLA's cache env; the port's kernels cache in ops/_build",
    "serialization.py:PICKLE_PROTOCOL": "the port pickles every payload at protocol 5 (OOB_PICKLE_PROTOCOL); JAX used 4 in band",
    "server/state.py:ServerState.app_log": "called nowhere in the JAX package; the port's services append log entries",
    "server/state.py:WorkerState.free_chips": "renamed free_gpus",
    "server/warm_pool.py:ACK_TIMEOUT_S": "read per adoption from config['warm_pool_ack_timeout'], not once at import",
    "server/worker.py:detect_tpu_inventory": "renamed detect_gpu_inventory (nvidia-smi)",
}


def _public_names(tree: ast.Module, is_init: bool) -> set:
    names = set()
    classes = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                names.add(node.name)
            if isinstance(node, ast.ClassDef):
                classes.append(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                for n in ast.walk(target):
                    if isinstance(n, ast.Name) and not n.id.startswith("_"):
                        names.add(n.id)
        elif is_init and isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                name = (alias.asname or alias.name).split(".")[0]
                if name != "*" and not name.startswith("_"):
                    names.add(name)
    if is_init:
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(getattr(t, "id", "") == "__all__" for t in node.targets):
                names |= {e.value for e in getattr(node.value, "elts", []) if isinstance(e, ast.Constant)}
    for cls in classes:
        public = not cls.name.startswith("_")
        alias = cls.name.startswith("_") and not cls.name.startswith("__") and cls.name[1:] in names
        if public or alias:
            names |= {f"{cls.name}.{f.name}" for f in cls.body
                      if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef)) and not f.name.startswith("_")}
    return names


def _jax_surface() -> dict:
    surface = {}
    for dirpath, dirnames, filenames in os.walk(JAX_ROOT):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fname in sorted(filenames):
            if not fname.endswith(".py") or fname.endswith("_pb2.py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, JAX_ROOT).replace(os.sep, "/")
            with open(path, encoding="utf-8") as f:
                surface[rel] = _public_names(ast.parse(f.read()), fname == "__init__.py")
    return surface


SURFACE = _jax_surface()


def _port_rel(rel: str) -> str:
    return RENAMED_MODULES.get(rel, rel)


def _bound(rel: str, name: str) -> bool:
    """Does the port's counterpart of `rel` bind `name` (dotted for a method)?"""
    port_rel = _port_rel(rel)
    if port_rel.endswith("__main__.py"):
        with open(os.path.join(PORT_ROOT, port_rel), encoding="utf-8") as f:
            return name in _public_names(ast.parse(f.read()), False)
    module_name = "modal_tpu_torch." + port_rel[:-3].replace("/", ".")
    module_name = module_name[: -len(".__init__")] if module_name.endswith(".__init__") else module_name
    obj = importlib.import_module(module_name)
    for part in name.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def test_the_walk_sees_the_jax_package():
    assert len(SURFACE) > 100 and "app.py" in SURFACE and "server/__main__.py" in SURFACE
    assert {"App", "_App.run", "_App.is_interactive"} <= SURFACE["app.py"]
    assert "METRIC_CATALOG" in SURFACE["observability/__init__.py"]
    assert not any(n.startswith("_") for names in SURFACE.values() for n in names if "." not in n)


@pytest.mark.parametrize("rel", sorted(SURFACE))
def test_every_public_name_of_the_jax_module_is_bound_in_the_port(rel):
    assert os.path.exists(os.path.join(PORT_ROOT, _port_rel(rel))), f"no counterpart of modal_tpu/{rel}"
    missing = sorted(n for n in SURFACE[rel] if f"{rel}:{n}" not in DIVERGENCES and not _bound(rel, n))
    assert not missing, f"modal_tpu/{rel}: bind these in the port or list them in DIVERGENCES: {missing}"


@pytest.mark.parametrize("entry", sorted(DIVERGENCES))
def test_no_divergence_is_dead(entry):
    rel, name = entry.split(":", 1)
    assert name in SURFACE.get(rel, ()), f"the JAX package no longer has {entry}"
    assert not _bound(rel, name), f"the port binds {entry} now: drop the entry"
    reason = DIVERGENCES[entry]
    assert reason.strip() and "\n" not in reason


def test_the_names_this_audit_closed_behave_as_the_jax_packages():
    """The counterparts bound to close the audit's gaps, against JAX's."""
    import modal_tpu
    import modal_tpu_torch
    from modal_tpu import parallel as jparallel
    from modal_tpu._utils.local_transport import _LocalContext as JaxContext
    from modal_tpu_torch import parallel as tparallel
    from modal_tpu_torch._utils.local_transport import _LocalContext

    assert modal_tpu_torch.App("a").is_interactive is modal_tpu.App("a").is_interactive is False
    for axes in ({"pipe": 2, "expert": 2}, {"pipe": 1, "expert": 4}, {"pipe": 2}):
        refused = []
        for validate, exc in ((jparallel.validate_mesh_constraints, jparallel.MeshConstraintError),
                              (tparallel.validate_mesh_constraints, tparallel.MeshConstraintError)):
            try:
                validate(axes)
                refused.append(False)
            except exc:
                refused.append(True)
        assert refused[0] == refused[1] == (axes == {"pipe": 2, "expert": 2}), axes
    port, jax_ctx = _LocalContext([("k", "v")]), JaxContext([("k", "v")])
    assert port.peer() == jax_ctx.peer() and port.invocation_metadata() == jax_ctx.invocation_metadata()
    assert port.set_code(0) is None and port.set_details("x") is None
