"""Named device meshes over a torch.distributed process group (port of
modal_tpu/parallel/mesh.py).

The JAX package builds a `jax.sharding.Mesh` over the devices of one
process. The port runs one process per card (one rank each), so a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the process
group, with the same six named dims in the same order:

  data   — pure data parallel (params replicated)
  pipe   — pipeline parallel (the layer stack split across stages, GPipe)
  expert — expert parallel (MoE experts sharded; all-to-all dispatch)
  fsdp   — data parallel with sharded params and optimizer state (ZeRO-3)
  seq    — sequence parallel (ring attention)
  model  — tensor parallel (heads and FFN sharded; activations all-reduced)

`init_process_group` is the port's process-group setup: NCCL on CUDA, gloo
only when the caller names the CPU. A CUDA request without NCCL raises; there
is no fallback to gloo.
"""

from __future__ import annotations

import math
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from ..config import resolve_device

AXIS_ORDER = ("data", "pipe", "expert", "fsdp", "seq", "model")


class MeshConstraintError(ValueError):
    """A mesh/model combination the workload layer cannot execute, rejected
    at mesh-build time, before any parameter is initialised."""


def validate_mesh_constraints(axes: dict[str, int], model_cfg=None) -> None:
    """pipe × expert (pipeline × MoE) is refused: the GPipe schedule runs a
    uniform dense layer block per stage, and the expert all-to-all does not
    commute with the stage rotation (modal_tpu/parallel/mesh.py:38)."""
    pipe = int(axes.get("pipe", 1) or 1)
    expert = int(axes.get("expert", 1) or 1)
    is_moe = bool(getattr(model_cfg, "is_moe", False)) if model_cfg is not None else False
    if pipe > 1 and (expert > 1 or is_moe):
        raise MeshConstraintError(
            f"pipeline parallelism (pipe={pipe}) cannot compose with MoE layers "
            f"(expert={expert}, is_moe={is_moe}): the GPipe stage loop assumes a "
            "uniform dense layer block per stage, and the expert all-to-all does "
            "not commute with the stage rotation. Drop the pipe axis (use expert "
            "parallelism alone) or use a dense model config with pipe."
        )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(
    device=None, world_size: int = 1, rank: int = 0, init_method: Optional[str] = None
) -> torch.device:
    """Join (or create) the default process group and return this rank's
    device. CUDA (the default): NCCL, each rank on card `rank % count`. The
    CPU, only when named: gloo. `init_method` defaults to a free localhost
    TCP port, which serves a group of one; a group of several needs the
    same `init_method` on every rank (`tcp://localhost:<port>` or
    `file://<path>`). A group that already exists is kept when its backend
    matches the device."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("CUDA process group requested but this torch build has no NCCL")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"a {have} process group exists; {dev.type} needs {backend}")
        return dev
    if init_method is None:
        if world_size != 1:
            raise ValueError("a process group of several ranks needs an explicit init_method")
        init_method = f"tcp://localhost:{_free_port()}"
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank, **kw)
    return dev


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.mesh.init_process_group first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def build_mesh(axes: Optional[dict[str, int]] = None, model_cfg=None):
    """A DeviceMesh with the six named dims of AXIS_ORDER over the ranks of
    the process group. Missing axes are 1; the sizes must divide the world
    size, and the remainder goes to fsdp. `model_cfg` checks the pipe × MoE
    constraint here, before any init."""
    from torch.distributed.device_mesh import init_device_mesh

    axes = dict(axes or {})
    unknown = set(axes) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; valid: {AXIS_ORDER}")
    validate_mesh_constraints(axes, model_cfg)
    device_type = _device_type()
    n = dist.get_world_size()
    sized = {k: v for k, v in axes.items() if v and v > 1}
    prod = math.prod(sized.values()) if sized else 1
    if prod > n or n % prod != 0:
        raise ValueError(f"mesh axes {axes} need {prod} devices, have {n}")
    if prod < n:
        sized["fsdp"] = sized.get("fsdp", 1) * (n // prod)
    shape = tuple(sized.get(name, 1) for name in AXIS_ORDER)
    return init_device_mesh(device_type, shape, mesh_dim_names=AXIS_ORDER)


def single_device_mesh():
    """The mesh of a one-rank group (every axis 1)."""
    if dist.is_initialized() and dist.get_world_size() != 1:
        raise ValueError(f"single_device_mesh needs a group of one rank, have {dist.get_world_size()}")
    return build_mesh({"fsdp": 1})


def mesh_from_slice_info(num_hosts: int, chips_per_host: int, hints: Optional[dict[str, int]] = None):
    """Default mapping for a gang: fsdp over the cards of a host × data
    across hosts, unless hints say otherwise."""
    if hints:
        return build_mesh(hints)
    return build_mesh({"data": num_hosts, "fsdp": chips_per_host})


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size}, as `jax.sharding.Mesh.shape` gives."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spawn(fn, world_size: int, *args) -> None:
    """Run `fn(rank, world_size, *args)` in `world_size` fresh CPU
    processes, each with one thread, having joined one gloo process group
    through a rendezvous file in a fresh temporary directory (so concurrent
    spawns never share a port). `fn` must be importable by name (spawned
    workers import it). Raises if any rank fails."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        mp.spawn(_spawned, args=(fn, world_size, init, args), nprocs=world_size, join=True)


def _spawned(rank: int, fn, world_size: int, init: str, args: tuple) -> None:
    torch.set_num_threads(1)
    init_process_group("cpu", world_size=world_size, rank=rank, init_method=init)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
