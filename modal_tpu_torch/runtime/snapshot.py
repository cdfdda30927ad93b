"""Warm-state snapshots to and from the card (port of
modal_tpu/runtime/snapshot.py:39-243).

On the FIRST boot of a snapshot-enabled function the `@enter(snap=True)`
hooks run (expensive: weight load or init), then every attribute they set
on the instance is written to worker-local disk: tensor and numpy leaves
as raw buffers, everything else pickled, with the tree structure kept. On
every LATER cold boot the hooks are skipped and the state streams from
disk straight into device memory. With the fleet compile cache under the
kernel builds (`compile_client.py`), the two big cold-start costs, weight
init and kernel builds, leave the boot.

Contract (the JAX package's): snap-enter hooks only establish state on
`self`. If any attribute cannot be snapshotted (open sockets, locks:
what cloudpickle refuses; a lambda, a closure or a local class is kept), the
snapshot is abandoned and leaves nothing behind; every boot then pays the
full enter cost. A restore stages every attribute before setting any, so
it never applies partially. Snapshots are keyed by the function
definition's hash, so a changed definition never restores stale state.

The on-disk format is the JAX package's, leaf for leaf:

- `<root>/<key>/manifest.json`: {"attrs": {name: {"treedef", "leaves",
  "devices"}}, "writer"}, written last (the directory moves into place with
  one `os.replace`);
- `<name>.<i>.bin`: one array leaf's raw C-order bytes, bf16 as its uint16
  bits, beside {"kind": "array", "file", "shape", "dtype"} (JAX's dtype
  strings) and, for a DTensor, JAX's "sharding" record (kind "named",
  axis_names, mesh_shape, spec). For the same params every leaf file is
  byte for byte the one the JAX package writes.

Trees flatten under JAX's pytree rules for the standard types (dict and
defaultdict by sorted key, OrderedDict in order, list, tuple, NamedTuple;
None is an empty node; anything else is a leaf), so a state has the leaf
order and count `jax.tree_util.tree_flatten` gives it. The treedef and the
non-array leaves are pickled with the port's cloudpickle `serialization`
(imported at save and restore time, as the JAX package does), and "devices"
records where each array leaf lived ("cuda", "cpu" or "numpy"): a leaf
goes back to the kind of device it came from, where JAX `device_put`s
every leaf.

Moving the bytes: a CUDA leaf is written chunk by chunk through two pinned
host buffers (the device-to-host copy of one chunk overlaps the write of
the one before), never as one host copy of the leaf; a restore reads each
chunk into a pinned buffer and copies it to the card with
`non_blocking=True` while the next chunk is read. Host memory holds two
chunks, never the state. Every file is fsynced before the manifest
commits, then dropped from the page cache (`POSIX_FADV_DONTNEED`): the
process already holds the state, and a multi-GB snapshot must not push the
host's useful pages out.

Sharding: a DTensor leaf records its mesh and placements. A restore
rebuilds it over a DeviceMesh of the process group; when the group cannot
host the recorded mesh (fewer ranks, or no group), the restore raises
`_ShardingUnavailable` inside and keeps the snapshot on disk for a boot
that can. A save from a group of more than one rank is abandoned with a
warning: the JAX package's single-controller save has no one-process
counterpart before the port has a gang runtime.

torch and numpy load when a function here runs, not at import: the
container entrypoint reaches this module before its hello.
"""

from __future__ import annotations

import collections
import hashlib
import json
import math
import os
import shutil
import sys
from typing import TYPE_CHECKING, Any, Callable, Iterator, Optional

from ..config import config, logger

if TYPE_CHECKING:
    import numpy as np
    import torch

# the most bytes of each of the two pinned staging buffers (a smaller tensor
# gets buffers of its own size)
CHUNK_BYTES = 256 << 20
WRITER = "modal_tpu_torch"


def _snapshot_root() -> str:
    return os.environ.get("MODAL_TPU_SNAPSHOT_DIR", os.path.join(config["state_dir"], "snapshots"))


def snapshot_key(function_def: Any) -> str:
    """sha256 of the definition, as the JAX package keys it: any message
    with `SerializeToString(deterministic=True)` (map fields otherwise
    serialize in arbitrary order), or its serialized bytes."""
    if isinstance(function_def, (bytes, bytearray, memoryview)):
        data = bytes(function_def)
    else:
        data = function_def.SerializeToString(deterministic=True)
    return hashlib.sha256(data).hexdigest()[:24]


class _KeepSnapshot(RuntimeError):
    """This process cannot restore the snapshot; it stays on disk."""


class _ShardingUnavailable(_KeepSnapshot):
    """The process group cannot host the snapshotted mesh; keep the snapshot."""


# -- trees ---------------------------------------------------------------------


def _flatten(tree: Any, leaves: list) -> tuple:
    """Append `tree`'s leaves to `leaves` in JAX's order; return its treedef."""
    if tree is None:
        return ("none",)
    kind = type(tree)
    if kind in (dict, collections.defaultdict, collections.OrderedDict):
        keys = list(tree) if kind is collections.OrderedDict else sorted(tree)
        meta = (tree.default_factory, keys) if kind is collections.defaultdict else keys
        return (kind.__name__, meta, [_flatten(tree[k], leaves) for k in keys])
    if kind in (list, tuple):
        return (kind.__name__, None, [_flatten(c, leaves) for c in tree])
    if isinstance(tree, tuple) and hasattr(kind, "_fields"):
        return ("namedtuple", kind, [_flatten(c, leaves) for c in tree])
    leaves.append(tree)
    return ("leaf",)


def _unflatten(treedef: tuple, leaves: Iterator) -> Any:
    kind = treedef[0]
    if kind == "leaf":
        return next(leaves)
    if kind == "none":
        return None
    meta, children = treedef[1], [_unflatten(c, leaves) for c in treedef[2]]
    if kind == "dict":
        return dict(zip(meta, children))
    if kind == "OrderedDict":
        return collections.OrderedDict(zip(meta, children))
    if kind == "defaultdict":
        out = collections.defaultdict(meta[0])
        out.update(zip(meta[1], children))
        return out
    if kind == "list":
        return children
    if kind == "tuple":
        return tuple(children)
    if kind == "namedtuple":
        return meta(*children)
    raise ValueError(f"unknown treedef node {kind!r}")


# -- leaves --------------------------------------------------------------------


def _dtensor_type():
    """DTensor, when the process has imported it: a leaf can be one only
    then, and importing it costs seconds (3.63 s of a boot on an H100 host)."""
    return getattr(sys.modules.get("torch.distributed.tensor"), "DTensor", None)


def _world_size() -> int:
    import torch

    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _leaf_device(leaf: Any) -> Optional[str]:
    """"cuda", "cpu" or "numpy" for an array leaf; None for a pickled one."""
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        dev = leaf.device.type
        if dev not in ("cuda", "cpu"):
            raise ValueError(f"cannot snapshot a tensor on {leaf.device}")
        return dev
    if isinstance(leaf, np.ndarray):
        return "numpy"
    return None


def _dtype_str(dtype) -> str:
    """JAX's dtype string (numpy's name; bf16 is "bfloat16")."""
    import numpy as np
    import torch

    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return "bfloat16" if dtype == np.dtype("V2") else str(dtype)


def _sharding_meta(dt) -> dict:
    """A DTensor's mesh and placements in JAX's `sharding` schema: the
    spec lists, per tensor dim, the mesh axes that shard it (None, a name,
    or a list of names in mesh order)."""
    mesh = dt.device_mesh
    names = list(mesh.mesh_dim_names or [f"dim{i}" for i in range(mesh.ndim)])
    spec: list = [[] for _ in range(dt.ndim)]
    for name, pl in zip(names, dt.placements):
        if pl.is_shard():
            spec[pl.dim % dt.ndim].append(name)
        elif not pl.is_replicate():
            raise ValueError(f"cannot snapshot a DTensor with placement {pl}")
    return {
        "kind": "named",
        "axis_names": names,
        "mesh_shape": list(mesh.shape),
        "spec": [None if not s else s[0] if len(s) == 1 else s for s in spec],
    }


def _restore_mesh(meta: dict, meshes: dict):
    """The DeviceMesh and placements a recorded sharding needs, or
    _ShardingUnavailable when the process group cannot host it."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    shape = tuple(meta["mesh_shape"])
    needed = math.prod(shape)
    world = _world_size()
    if needed > world:
        raise _ShardingUnavailable(f"snapshot leaf sharded over {needed} ranks; only {world} present")
    if needed != world or not torch.distributed.is_initialized():
        raise _ShardingUnavailable(
            f"snapshot leaf sharded over a mesh of {needed} ranks; this process is in a group of {world}"
            + ("" if torch.distributed.is_initialized() else " and has no process group")
        )
    names = tuple(meta["axis_names"])
    if (shape, names) not in meshes:
        from torch.distributed.device_mesh import init_device_mesh

        from ..parallel.mesh import _device_type

        meshes[(shape, names)] = init_device_mesh(_device_type(), shape, mesh_dim_names=names)
    placements = []
    for name in names:
        dims = [d for d, e in enumerate(meta["spec"]) if e == name or (isinstance(e, list) and name in e)]
        placements.append(Shard(dims[0]) if dims else Replicate())
    return meshes[(shape, names)], placements


def _write_all(f, buf) -> None:
    view = memoryview(buf).cast("B")
    while view:
        view = view[f.write(view):]


def _read_exact(f, buf) -> None:
    view = memoryview(buf).cast("B")
    while view:
        n = f.readinto(view)
        if not n:
            raise EOFError(f"{f.name}: file ends early")
        view = view[n:]


class Staging:
    """Two pinned host buffers that stream CUDA tensors between the card and
    the host chunk by chunk (files here, host tensors in the serializer);
    allocated at the first CUDA tensor, at most `chunk` bytes each
    (`CHUNK_BYTES` unless given), grown when a later tensor needs more."""

    def __init__(self, chunk: Optional[int] = None):
        self.chunk = chunk or CHUNK_BYTES
        self.bufs: list = []
        self.events: list = [None, None]

    def _buffers(self, nbytes: int):
        import torch

        size = min(self.chunk, nbytes)
        if not self.bufs or self.bufs[0].numel() < size:
            self.drain()
            self.bufs = [torch.empty(size, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
            self.views = [b.numpy() for b in self.bufs]
        return self.bufs

    def to_host(self, flat: torch.Tensor, sink: Callable[[int, np.ndarray], None]) -> None:
        """Pass a CUDA uint8 tensor to `sink(offset, chunk)` in order: chunk
        j's copy to the host runs while `sink` takes chunk j - 1."""
        import torch

        bufs, pending = self._buffers(flat.numel()), None
        with torch.cuda.device(flat.device):
            for j, off in enumerate(range(0, flat.numel(), self.chunk)):
                k, n = j % 2, min(self.chunk, flat.numel() - off)
                bufs[k][:n].copy_(flat[off:off + n], non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                if pending is not None:
                    pending[3].synchronize()
                    sink(pending[1], self.views[pending[0]][:pending[2]])
                pending = (k, off, n, event)
            if pending is not None:
                pending[3].synchronize()
                sink(pending[1], self.views[pending[0]][:pending[2]])

    def from_file(self, f, flat: torch.Tensor) -> None:
        """Fill a CUDA uint8 tensor: chunk j is read while chunk j - 1 copies
        to the card; a buffer is refilled only after its copy finished."""
        import torch

        bufs = self._buffers(flat.numel())
        with torch.cuda.device(flat.device):
            for j, off in enumerate(range(0, flat.numel(), self.chunk)):
                k, n = j % 2, min(self.chunk, flat.numel() - off)
                if self.events[k] is not None:
                    self.events[k].synchronize()
                _read_exact(f, self.views[k][:n])
                flat[off:off + n].copy_(bufs[k][:n], non_blocking=True)
                self.events[k] = torch.cuda.Event()
                self.events[k].record()

    def drain(self) -> None:
        for event in self.events:
            if event is not None:
                event.synchronize()


def _flush_file(f) -> None:
    """fsync, then drop the file's pages from the page cache."""
    os.fsync(f.fileno())
    if hasattr(os, "posix_fadvise"):
        os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)


def _write_leaf(leaf: Any, path: str, staging: Staging) -> dict:
    import numpy as np
    import torch

    meta: dict = {}
    if isinstance(leaf, torch.Tensor):
        dtensor = _dtensor_type()
        if dtensor is not None and isinstance(leaf, dtensor):
            meta["sharding"] = _sharding_meta(leaf)
            local = leaf.to_local()
            if tuple(local.shape) != tuple(leaf.shape):
                raise ValueError("cannot snapshot a DTensor whose local piece is not the whole tensor")
            leaf = local
        flat = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
        head = {"shape": list(leaf.shape), "dtype": _dtype_str(leaf.dtype)}
    else:
        arr = np.ascontiguousarray(leaf)
        flat = arr.reshape(-1).view(np.uint8)
        head = {"shape": list(arr.shape), "dtype": _dtype_str(arr.dtype)}
    with open(path, "wb", buffering=0) as f:
        if isinstance(flat, torch.Tensor) and flat.device.type == "cuda":
            staging.to_host(flat, lambda _off, chunk: _write_all(f, chunk))
        else:
            _write_all(f, flat.numpy() if isinstance(flat, torch.Tensor) else flat)
        _flush_file(f)
    return {**head, **meta}


def _torch_dtype(name: str) -> torch.dtype:
    import torch

    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _read_leaf(path: str, meta: dict, device: Optional[str], staging: Staging, meshes: dict) -> Any:
    import numpy as np
    import torch

    sharding = meta.get("sharding")
    placed = _restore_mesh(sharding, meshes) if sharding else None
    shape = tuple(meta["shape"])
    with open(path, "rb", buffering=0) as f:
        if device == "numpy":
            out = np.empty(shape, np.dtype(meta["dtype"]))
            want, dst = out.nbytes, out.reshape(-1).view(np.uint8)
        else:
            if device == "cuda" and not torch.cuda.is_available():
                raise _KeepSnapshot("the snapshot holds CUDA tensors and this process has no CUDA device")
            dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
            out = torch.empty(shape, dtype=_torch_dtype(meta["dtype"]), device=dev)
            dst = out.reshape(-1).view(torch.uint8)
            want = dst.numel()
        have = os.fstat(f.fileno()).st_size
        if have != want:
            raise ValueError(f"{os.path.basename(path)} holds {have} bytes; its manifest entry needs {want}")
        if isinstance(dst, torch.Tensor) and dst.device.type == "cuda":
            staging.from_file(f, dst)
        elif want:
            _read_exact(f, dst.numpy() if isinstance(dst, torch.Tensor) else dst)
    if placed is None:
        return out
    from ..parallel.sharding import distribute

    mesh, placements = placed
    return distribute(out.to(mesh.device_type), mesh, placements)


# -- save / restore ------------------------------------------------------------


def save_snapshot(function_def: Any, user_instance: Any) -> bool:
    """Snapshot user_instance's attributes after the snap-enter hooks.
    Returns True when a complete snapshot landed; False (with everything
    cleaned up) otherwise."""
    from ..serialization import serialize

    if user_instance is None:
        return False
    world = _world_size()
    if world > 1:
        logger.warning(f"warm-state snapshot abandoned: a save from a group of {world} ranks is not supported")
        return False
    key = snapshot_key(function_def)
    final_dir = os.path.join(_snapshot_root(), key)
    if os.path.exists(os.path.join(final_dir, "manifest.json")):
        return True
    tmp_dir = final_dir + ".saving"
    shutil.rmtree(tmp_dir, ignore_errors=True)
    os.makedirs(tmp_dir, exist_ok=True)
    manifest: dict = {"attrs": {}, "writer": WRITER}
    staging = Staging()
    try:
        for name, value in vars(user_instance).items():
            leaves: list = []
            treedef = _flatten(value, leaves)
            entry: dict = {"treedef": serialize(treedef).hex(), "leaves": [], "devices": []}
            for i, leaf in enumerate(leaves):
                device = _leaf_device(leaf)
                if device is None:
                    entry["leaves"].append({"kind": "pickle", "data": serialize(leaf).hex()})
                else:
                    fname = f"{name}.{i}.bin"
                    meta = _write_leaf(leaf, os.path.join(tmp_dir, fname), staging)
                    entry["leaves"].append({"kind": "array", "file": fname, **meta})
                entry["devices"].append(device)
            manifest["attrs"][name] = entry
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            _flush_file(f)
        os.replace(tmp_dir, final_dir)
        logger.debug(f"warm-state snapshot saved: {key} ({len(manifest['attrs'])} attrs)")
        return True
    except Exception as exc:  # noqa: BLE001 — snapshot is best-effort, never partial
        logger.warning(f"warm-state snapshot abandoned ({type(exc).__name__}: {exc})")
        shutil.rmtree(tmp_dir, ignore_errors=True)
        return False


def restore_snapshot(function_def: Any, user_instance: Any) -> bool:
    """Stream a saved snapshot back onto user_instance. Returns True when
    fully applied; False → the caller runs the snap-enter hooks. Never
    partially applies: every attribute is staged first. A snapshot this
    process cannot host stays on disk; one that fails to restore is
    dropped, so the next boot's save rewrites it."""
    from ..serialization import deserialize

    if user_instance is None:
        return False
    key = snapshot_key(function_def)
    snap_dir = os.path.join(_snapshot_root(), key)
    manifest_path = os.path.join(snap_dir, "manifest.json")
    if not os.path.exists(manifest_path):
        return False
    staging = Staging()
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        if manifest.get("writer") != WRITER:
            raise _KeepSnapshot(f"snapshot written by {manifest.get('writer') or 'the JAX package'}")
        staged: dict[str, Any] = {}
        meshes: dict = {}
        for name, entry in manifest["attrs"].items():
            treedef = deserialize(bytes.fromhex(entry["treedef"]))
            leaves = []
            for meta, device in zip(entry["leaves"], entry["devices"], strict=True):
                if meta["kind"] == "array":
                    leaves.append(_read_leaf(os.path.join(snap_dir, meta["file"]), meta, device, staging, meshes))
                else:
                    leaves.append(deserialize(bytes.fromhex(meta["data"])))
            staged[name] = _unflatten(treedef, iter(leaves))
        for name, value in staged.items():
            setattr(user_instance, name, value)
        logger.debug(f"warm-state snapshot restored: {key} ({len(staged)} attrs)")
        return True
    except _KeepSnapshot as exc:
        logger.warning(f"warm-state restore skipped ({exc}); running enter hooks")
        return False
    except Exception as exc:  # noqa: BLE001
        logger.warning(f"warm-state restore failed ({type(exc).__name__}: {exc}); running enter hooks")
        drop_snapshot(function_def)
        return False
    finally:
        staging.drain()


def drop_snapshot(function_def: Any) -> None:
    shutil.rmtree(os.path.join(_snapshot_root(), snapshot_key(function_def)), ignore_errors=True)
