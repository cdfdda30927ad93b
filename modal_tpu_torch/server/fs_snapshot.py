"""Filesystem snapshots of sandboxes: a workdir to a tarball in the blob
store and back (port of modal_tpu/server/fs_snapshot.py).

The control plane tars a sandbox's workdir (SandboxSnapshotFs,
SandboxSnapshot); the worker seeds a new sandbox's workdir from a snapshot
image. Reference: sandbox.py `snapshot_filesystem` and snapshot.py; there the
tar and the restore happen in the closed worker runtime, here the plane and
its workers share one filesystem, so either side can do it.

Extraction rejects unsafe names (absolute paths, `..` components): the blob
store is trusted locally, but snapshots round-trip through ids a client sees.
"""

from __future__ import annotations

import asyncio
import io
import os
import tarfile


def sandbox_workdir(state_dir: str, task_id: str, definition_workdir: str) -> str:
    """The sandbox's working directory: explicit workdir, else a dedicated
    per-task dir (so snapshots capture exactly the sandbox's files)."""
    return definition_workdir or os.path.join(state_dir, "tasks", task_id, "work")


def _tar_dir_sync(root: str) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        if os.path.isdir(root):
            for entry in sorted(os.listdir(root)):
                tar.add(os.path.join(root, entry), arcname=entry)
    return buf.getvalue()


def _untar_dir_sync(data: bytes, dest: str) -> None:
    os.makedirs(dest, exist_ok=True)
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        for member in tar.getmembers():
            name = member.name
            if name.startswith("/") or ".." in name.split("/"):
                raise ValueError(f"unsafe path in snapshot tar: {name!r}")
        tar.extractall(dest, filter="data")


async def tar_dir(root: str) -> bytes:
    return await asyncio.to_thread(_tar_dir_sync, root)


async def untar_dir(data: bytes, dest: str) -> None:
    await asyncio.to_thread(_untar_dir_sync, data, dest)
