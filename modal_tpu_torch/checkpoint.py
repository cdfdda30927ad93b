"""Checkpoints of tensor trees on a Volume, streamed to and from the device
(port of modal_tpu/checkpoint.py).

A training run's state is saved leaf by leaf as content-addressed Volume
blocks, so successive checkpoints upload only the blocks that changed, and
restored one leaf at a time into fresh tensors on the device: the host
never holds more than a leaf (its bytes land in one buffer by
`read_file_range_into`, the co-located store's files read in place).

The format is the JAX package's, file for file: `<path>/manifest.json`
(each leaf's tree path, shape and dtype) and `<path>/leaves/<i>.bin`, a
leaf's raw little-endian bytes, `i` its index in the flattened tree (dict
keys sorted, sequences in order, as `jax.tree_util` flattens). A leaf that
spans several processes, a DTensor over a mesh of more than one rank, is
saved as shards, `leaves/<i>.s<start>.bin`, one per distinct piece of the
mesh (the manifest's shard table, which every rank computes alike from the
placements), unless its placements leave it whole (replicated), when rank
0 saves it as any other leaf; each rank writes the pieces it holds the first copy of, and
every rank meets at a `torch.distributed` barrier before rank 0 publishes
the manifest, so a visible manifest means every shard has landed. A
restore assembles each rank's piece from the shards it overlaps, onto any
mesh: regridding to fewer or more ranks. The manifest's `treedef` is a
description of the tree of the port's own; JAX's restore never reads it.
Either package restores the other's files.

Importing this module loads no torch; saving or restoring a tree of
tensors does.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import math
from typing import Any, Optional

from ._utils.async_utils import synchronize_api
from .config import logger
from .volume import _Volume

# a save uploads its leaves in batches of about this many bytes: the host
# holds one batch's bytes at a time, not the whole tree's
SAVE_BATCH_BYTES = 1 << 30

# dtype names of the manifest (numpy's, and "bfloat16") <-> torch dtypes
_DTYPE_NAMES = {
    "float64": "float64", "float32": "float32", "float16": "float16", "bfloat16": "bfloat16",
    "int64": "int64", "int32": "int32", "int16": "int16", "int8": "int8", "uint8": "uint8", "bool": "bool",
}


def _torch_dtype(name: str):
    import torch

    if name not in _DTYPE_NAMES:
        raise ValueError(f"checkpoint dtype {name!r} has no torch counterpart")
    return getattr(torch, _DTYPE_NAMES[name])


def _dtype_name(dtype) -> str:
    """The manifest's name of a torch or numpy dtype."""
    name = str(dtype).removeprefix("torch.")
    if name not in _DTYPE_NAMES:
        raise ValueError(f"dtype {dtype} cannot be checkpointed")
    return name


# ---------------------------------------------------------------------------
# Trees: flattened in jax.tree_util's order, with its path strings
# ---------------------------------------------------------------------------


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _tree_flatten_with_paths(tree: Any, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """Stable (path, leaf) pairs: dict keys sorted, sequences by index,
    NamedTuples by field, None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _tree_flatten_with_paths(tree[k], (*prefix, str(k)))]
    if _is_namedtuple(tree):
        return [pair for name in tree._fields for pair in _tree_flatten_with_paths(getattr(tree, name), (*prefix, name))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree) for pair in _tree_flatten_with_paths(v, (*prefix, str(i)))]
    return [("/".join(prefix), tree)]


def _tree_unflatten(example: Any, leaves) -> Any:
    """`example`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if example is None:
        return None
    if isinstance(example, dict):
        return {k: _tree_unflatten(example[k], leaves) for k in sorted(example)}
    if _is_namedtuple(example):
        return type(example)(*(_tree_unflatten(getattr(example, n), leaves) for n in example._fields))
    if isinstance(example, (list, tuple)):
        return type(example)(_tree_unflatten(v, leaves) for v in example)
    return next(leaves)


def _treedef_str(tree: Any) -> str:
    """The port's description of a tree's structure, `*` for a leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef_str(tree[k])}" for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(f"{n}={_treedef_str(getattr(tree, n))}" for n in tree._fields) + ")"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_treedef_str(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _unflatten_from_paths(pairs: list[tuple[str, Any]]) -> Any:
    """Nested dicts (lists where every key of a level is an integer) from
    path/leaf pairs."""
    root: dict = {}
    for path, leaf in pairs:
        parts = path.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def _listify(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [_listify(node[k]) for k in sorted(keys, key=int)]
        return {k: _listify(v) for k, v in node.items()}

    return _listify(root)


# ---------------------------------------------------------------------------
# Shards: pieces of a DTensor's global shape, from its placements
# ---------------------------------------------------------------------------


def _box(shape: tuple, mesh_shape: tuple, coord: tuple, placements) -> tuple[tuple, tuple]:
    """(start, shape) of the piece the rank at mesh coordinate `coord`
    holds: each Shard cuts the range the earlier mesh dims left into
    ceil-sized chunks (torch.chunk's rule, DTensor's)."""
    from torch.distributed.tensor import Shard

    lo = [0] * len(shape)
    size = list(shape)
    for n, c, pl in zip(mesh_shape, coord, placements):
        if isinstance(pl, Shard) and n > 1:
            d = pl.dim
            step = -(-size[d] // n)
            start = min(c * step, size[d])
            lo[d] += start
            size[d] = max(0, min(step, size[d] - start))
    return tuple(lo), tuple(size)


def _shard_table(shape: tuple, mesh, placements) -> list[tuple[tuple, tuple]]:
    """The distinct (start, shape) pieces covering the global tensor, in
    start order: from the mesh's shape and the placements alone, so every
    rank computes the same table."""
    mesh_shape = tuple(mesh.shape)
    table: dict[tuple, tuple] = {}
    for coord in itertools.product(*(range(n) for n in mesh_shape)):
        start, size = _box(shape, mesh_shape, coord, placements)
        if all(size) or not shape:
            table[start] = size
    return sorted(table.items())


def _first_copy(mesh, placements) -> bool:
    """Does this rank hold the first copy of its piece (coordinate 0 on
    every mesh dim that does not shard it; JAX's replica_id 0)?"""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    return all(c == 0 for c, n, pl in zip(coord, mesh.shape, placements) if n > 1 and not isinstance(pl, Shard))


def _is_dtensor(leaf: Any) -> bool:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # pragma: no cover — a torch build without distributed
        return False
    return isinstance(leaf, DTensor)


def _use_shard_format(leaf: Any) -> bool:
    """The per-shard format for a DTensor cut into several pieces over
    several ranks: no rank holds the whole value. One piece (a replicated
    leaf) is saved whole by rank 0, which holds it, as JAX saves an array
    one process holds. (JAX's `shard_leaves_over` cuts an array that one
    process holds on several devices; a rank of the port holds one piece.)"""
    if not _is_dtensor(leaf) or leaf.device_mesh.size() == 1:
        return False
    return len(_shard_table(tuple(leaf.shape), leaf.device_mesh, leaf.placements)) > 1


def _shard_file(leaf_index: int, start: tuple) -> str:
    return f"leaves/{leaf_index}.s{'_'.join(map(str, start)) or 'scalar'}.bin"


def _norm_index(idx: tuple) -> list[tuple[int, int]]:
    """A box (start, shape) as [(start, stop)] per dim."""
    start, size = idx
    return [(int(a), int(a) + int(n)) for a, n in zip(start, size)]


def _overlaps(s_start: tuple, s_shape: tuple, idx: tuple) -> bool:
    for (a0, alen), (b0, b1) in zip(zip(s_start, s_shape), _norm_index(idx)):
        if a0 + alen <= b0 or b1 <= a0:
            return False
    return True


def _assemble_index(idx: tuple, pieces: list, dtype) -> Any:
    """The sub-tensor of the box `idx` ((start, shape) in the global shape),
    copied out of the saved shards that overlap it."""
    import torch

    bounds = _norm_index(idx)
    out = torch.empty(tuple(b1 - b0 for b0, b1 in bounds), dtype=dtype)
    for start, arr in pieces:
        if not _overlaps(start, tuple(arr.shape), idx):
            continue
        src, dst = [], []
        for (a0, alen), (b0, b1) in zip(zip(start, arr.shape), bounds):
            lo, hi = max(a0, b0), min(a0 + alen, b1)
            src.append(slice(lo - a0, hi - a0))
            dst.append(slice(lo - b0, hi - b0))
        out[tuple(dst)] = arr[tuple(src)]
    return out


# ---------------------------------------------------------------------------
# Leaves to and from bytes
# ---------------------------------------------------------------------------


def _leaf_meta(leaf: Any) -> tuple[list, str]:
    """(shape, dtype name) of a tensor, array or Python scalar leaf."""
    import numpy as np

    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        return list(leaf.shape), _dtype_name(leaf.dtype)
    a = np.asarray(leaf)
    return list(a.shape), _dtype_name(a.dtype)


def _leaf_nbytes(leaf: Any) -> int:
    shape, dtype = _leaf_meta(leaf)
    return math.prod(shape or (1,)) * _torch_dtype(dtype).itemsize


def _host_bytes(leaf: Any) -> memoryview:
    """A leaf's raw little-endian bytes on the host (a DTensor of one rank:
    its local tensor), with no copy beyond the device-to-host one."""
    import numpy as np
    import torch

    if _is_dtensor(leaf):
        leaf = leaf._local_tensor
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        return memoryview(t.reshape(-1).view(torch.uint8).numpy()) if t.numel() else memoryview(b"")
    return memoryview(np.ascontiguousarray(np.asarray(leaf))).cast("B")


def _empty_host(shape: tuple, dtype, pinned: bool):
    import torch

    return torch.empty(shape, dtype=dtype, pin_memory=pinned)


class _VolumeCheckpointer:
    """Save and restore trees of tensors on a Volume."""

    def __init__(self, volume: _Volume):
        self._volume = volume

    async def save(self, path: str, tree: Any, *, commit: bool = True) -> dict:
        """Write every leaf and the manifest; only new blocks upload.

        On several ranks (a process group): a DTensor leaf over more than
        one rank takes the shard format, each rank writing the pieces whose
        first copy it holds, and the other leaves are written by rank 0
        alone; every rank meets at a barrier before rank 0 publishes the
        manifest. Returns the manifest."""
        path = path.strip("/")
        flat = _tree_flatten_with_paths(tree)
        num_processes, process_id = _process_topology()
        is_writer = num_processes == 1 or process_id == 0
        manifest = {"format": 1, "treedef": _treedef_str(tree), "leaves": []}
        wrote_shards = False
        batch, queued = self._volume.batch_upload(force=True), 0

        def put(data: memoryview, file: str) -> None:
            nonlocal queued
            batch.put_data(data, file)
            queued += data.nbytes

        for i, (leaf_path, leaf) in enumerate(flat):
            if queued >= SAVE_BATCH_BYTES:
                # the host holds at most a batch of leaves' bytes at once
                await batch.__aexit__(None, None, None)
                batch, queued = self._volume.batch_upload(force=True), 0
            shape, dtype = _leaf_meta(leaf)
            meta = {"shape": shape, "dtype": dtype, "nbytes": _leaf_nbytes(leaf)}
            if _use_shard_format(leaf):
                wrote_shards = True
                mesh, pls = leaf.device_mesh, leaf.placements
                table = _shard_table(tuple(leaf.shape), mesh, pls)
                start, size = _box(tuple(leaf.shape), tuple(mesh.shape), tuple(mesh.get_coordinate()), pls)
                if tuple(leaf._local_tensor.shape) != size:
                    raise ValueError(f"leaf {leaf_path!r}: local piece {tuple(leaf._local_tensor.shape)}, "
                                     f"the placements give {size}")
                if _first_copy(mesh, pls) and (all(size) or not size):
                    put(await asyncio.to_thread(_host_bytes, leaf._local_tensor), f"{path}/{_shard_file(i, start)}")
                meta["shards"] = [{"file": _shard_file(i, s), "start": list(s), "shape": list(shp)}
                                  for s, shp in table]
            elif is_writer:
                # the device-to-host copy off the SDK's loop
                put(await asyncio.to_thread(_host_bytes, leaf), f"{path}/leaves/{i}.bin")
            manifest["leaves"].append({"index": i, "path": leaf_path, **meta})
        await batch.__aexit__(None, None, None)
        # every rank's shards are in (the batch above awaited them) before
        # the manifest becomes visible
        if num_processes > 1 and wrote_shards:
            import torch.distributed as dist

            await asyncio.to_thread(dist.barrier)
        if is_writer:
            async with self._volume.batch_upload(force=True) as batch:
                batch.put_data(json.dumps(manifest).encode(), f"{path}/manifest.json")
            if commit:
                await self._volume.commit()
        logger.debug(f"checkpoint saved: {path} ({len(flat)} leaves)")
        return manifest

    async def restore(
        self,
        path: str,
        *,
        example_tree: Optional[Any] = None,
        shardings: Optional[Any] = None,
        mesh: Any = None,
        dtype: Optional[Any] = None,
        device=None,
    ) -> Any:
        """Stream the leaves back, one at a time, into fresh tensors on
        `device` (CUDA unless the caller names the CPU).

        `shardings`: DTensor placements over `mesh` per leaf, a tree like
        the saved one or a callable leaf_path -> placements (None for a
        plain tensor); each such leaf comes back a DTensor holding this
        rank's piece, assembled from the shards it overlaps (any mesh: the
        saved one, fewer ranks or more). `example_tree` rebuilds the saved
        structure (NamedTuples, tuples); without it the tree comes back as
        nested dicts and lists keyed by path. `dtype` casts."""
        from .config import resolve_device

        dev = resolve_device(device)
        path = path.strip("/")
        manifest = json.loads(await self._read_file(f"{path}/manifest.json"))
        if shardings is not None and mesh is None:
            raise ValueError("shardings= needs its mesh=")
        by_index = _placements_leaves(shardings) if shardings is not None and not callable(shardings) else None
        leaves = []
        for meta in manifest["leaves"]:
            if callable(shardings):
                pls = shardings(meta["path"])
            elif by_index is not None:
                pls = by_index[meta["index"]]
            else:
                pls = None
            leaves.append(await self._restore_leaf(path, meta, mesh, pls, dtype, dev))
        pairs = [(m["path"], leaf) for m, leaf in zip(manifest["leaves"], leaves)]
        if example_tree is not None:
            by_path = dict(pairs)
            try:
                ordered = [by_path[p] for p, _ in _tree_flatten_with_paths(example_tree)]
            except KeyError as exc:
                raise ValueError(f"checkpoint at {path!r} has no leaf {exc.args[0]!r} required by example_tree "
                                 f"(saved leaves: {sorted(by_path)[:5]}...)") from None
            return _tree_unflatten(example_tree, iter(ordered))
        return _unflatten_from_paths(pairs)

    async def _read_file(self, file: str) -> bytes:
        import io

        buf = io.BytesIO()
        await self._volume.read_file_into(file, buf)
        return buf.getvalue()

    async def _read_tensor(self, file: str, shape: tuple, dtype_name: str, pinned: bool):
        """A saved buffer as a host tensor of its dtype and shape, its bytes
        landed in place (no intermediate copy)."""
        import torch

        t = _empty_host(shape, _torch_dtype(dtype_name), pinned)
        n = t.numel() * t.element_size()
        if n:
            got = await self._volume.read_file_range_into(file, 0, n, t.reshape(-1).view(torch.uint8).numpy())
            if got != n:
                raise IOError(f"short read of {file}: {got} of {n} bytes")
        return t

    async def _restore_leaf(self, path: str, meta: dict, mesh, pls, dtype, dev):
        """One leaf on `dev`: a tensor, or with placements `pls` over `mesh`
        a DTensor holding this rank's piece (cut on the host, so only the
        piece travels to the device)."""
        import torch

        shape = tuple(meta["shape"])
        pls = list(pls) if pls else None
        cast = (lambda t: t) if dtype is None else (lambda t: t.to(_torch_dtype(str(dtype).removeprefix("torch."))))
        if pls is None:
            box = ((0,) * len(shape), shape)
        else:
            box = _box(shape, tuple(mesh.shape), tuple(mesh.get_coordinate()), pls)
        if "shards" not in meta:
            host = await self._read_tensor(f"{path}/leaves/{meta['index']}.bin", shape, meta["dtype"],
                                           pinned=dev.type == "cuda" and pls is None)
            if pls is not None:
                host = host[tuple(slice(a, a + n) for a, n in zip(*box))]
        else:
            # only the shards this rank's piece overlaps are read
            pieces = await self._read_leaf_shards(path, meta, [box])
            host = _assemble_index(box, pieces, _torch_dtype(meta["dtype"]))
        local = cast(host).to(dev, non_blocking=True)
        if pls is None:
            return local
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local.contiguous(), mesh, pls, run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    async def _read_leaf_shards(self, path: str, meta: dict, needed: list) -> list:
        """The shard files overlapping any needed box, read 8 at a time."""
        to_read = [e for e in meta["shards"] if any(_overlaps(tuple(e["start"]), tuple(e["shape"]), idx) for idx in needed)]
        sem = asyncio.Semaphore(8)

        async def _read(entry: dict):
            async with sem:
                t = await self._read_tensor(f"{path}/{entry['file']}", tuple(entry["shape"]), meta["dtype"], False)
                return tuple(entry["start"]), t

        return list(await asyncio.gather(*[_read(e) for e in to_read]))

    async def exists(self, path: str) -> bool:
        from .exception import NotFoundError

        try:
            await self._volume.read_file_range(path.strip("/") + "/manifest.json", 0, 0)
            return True
        except NotFoundError:
            return False


def _placements_leaves(shardings: Any) -> list:
    """A placements tree's leaves in flattening order: a placements list is
    a leaf, not a sequence to descend into."""
    if shardings is None:
        return []  # as the tree's None holds no leaf
    if isinstance(shardings, dict):
        return [x for k in sorted(shardings) for x in _placements_leaves(shardings[k])]
    if _is_namedtuple(shardings) or (isinstance(shardings, (list, tuple)) and shardings
                                     and isinstance(shardings[0], (dict, list, tuple))):
        return [x for v in shardings for x in _placements_leaves(v)]
    return [shardings]


def _process_topology() -> tuple[int, int]:
    """(number of processes, this process's rank) from the default process
    group, if one exists; asking initializes nothing."""
    import sys

    dist = sys.modules.get("torch.distributed")
    if dist is None or not dist.is_available() or not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


VolumeCheckpointer = synchronize_api(_VolumeCheckpointer)
