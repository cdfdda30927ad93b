"""Rank bodies for the port's sharded-checkpoint tests (not collected: no
`test_` prefix). Each runs in a process spawned by
`modal_tpu_torch.parallel.mesh.spawn` (gloo, the CPU) and talks to the
port's control plane at `url`: it builds a mesh of the whole group, places
the full tree the test wrote (`torch.save`) with `param_specs`' placements,
and saves it with `VolumeCheckpointer`, or restores a saved one onto its
mesh and writes, per rank, whether its pieces equal the full tree's."""

from __future__ import annotations

import torch

from modal_tpu_torch.checkpoint import VolumeCheckpointer
from modal_tpu_torch.client import _Client
from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.parallel import mesh as tmesh
from modal_tpu_torch.parallel.sharding import local_chunk, param_shardings, shard_params
from modal_tpu_torch.volume import Volume


def _volume(url: str, name: str):
    client = _Client(url)
    client._open()
    vol = Volume.from_name(name, create_if_missing=True)
    vol.hydrate(client)
    return client, vol


def save_sharded(rank: int, world: int, url: str, volume: str, path: str, tree_file: str) -> None:
    """Place the full tree on a mesh of every rank (fsdp = world) and save
    it: each rank writes the shards it holds the first copy of."""
    client, vol = _volume(url, volume)
    try:
        full = torch.load(tree_file)
        cfg = tllama.get_config("tiny", dtype=full["embed"].dtype)
        mesh = tmesh.build_mesh({"fsdp": world})
        VolumeCheckpointer(vol).save(path, shard_params(mesh, cfg, full))
    finally:
        client._close()


def restore_sharded(rank: int, world: int, url: str, volume: str, path: str, tree_file: str, out: str) -> None:
    """Restore onto a mesh of every rank; each rank checks its pieces
    against the full tree and writes what it found to `out.<rank>`."""
    client, vol = _volume(url, volume)
    try:
        full = torch.load(tree_file)
        cfg = tllama.get_config("tiny", dtype=full["embed"].dtype)
        mesh = tmesh.build_mesh({"fsdp": world})
        pls = param_shardings(mesh, cfg)
        got = VolumeCheckpointer(vol).restore(path, shardings=pls, mesh=mesh, device="cpu")
        checks = {}
        for key in ("embed", "final_norm", "lm_head"):
            checks[key] = _same_piece(got[key], full[key], mesh, pls[key])
        for key, t in full["layers"].items():
            checks[f"layers/{key}"] = _same_piece(got["layers"][key], t, mesh, pls["layers"][key])
        torch.save(checks, f"{out}.{rank}")
    finally:
        client._close()


def _same_piece(got, want: torch.Tensor, mesh, pls) -> bool:
    return (tuple(got.shape) == tuple(want.shape) and list(got.placements) == list(pls)
            and torch.equal(got.to_local(), local_chunk(want, mesh, pls)))
