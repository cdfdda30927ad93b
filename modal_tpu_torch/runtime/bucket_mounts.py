"""A container's CloudBucketMounts: synced down before user code, written
back at exit (port of modal_tpu/runtime/bucket_mounts.py).

The reference's worker mounts the bucket with FUSE (cloud_bucket_mount.py
is only the descriptor). Here there is no FUSE: the entrypoint downloads the
bucket prefix into the mount path before user code runs and, unless the
mount is read_only, uploads the files that are new or changed at exit.
That serves weights in and checkpoints out; it is not a live shared file
system (concurrent writers: the last writer of a file wins).
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field

from ..config import logger
from .._utils.s3 import S3Client, S3Config


@dataclass
class _MountState:
    path: str
    spec: dict
    client: S3Client
    prefix: str
    synced_sha: dict[str, str] = field(default_factory=dict)  # relpath -> sha256


def _file_sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


async def sync_bucket_mounts(cloud_bucket_mounts: dict) -> list[_MountState]:
    """Download each mount's bucket prefix into its mount path. Returns the
    per-mount state the exit-time write-back diffs against."""
    states: list[_MountState] = []
    for path, spec_json in cloud_bucket_mounts.items():
        spec = json.loads(spec_json)
        client = S3Client(S3Config.from_env(spec["bucket_name"], spec.get("bucket_endpoint_url")))
        prefix = spec.get("key_prefix") or ""
        st = _MountState(path=path, spec=spec, client=client, prefix=prefix)
        os.makedirs(path, exist_ok=True)
        keys = await client.list_keys(prefix)
        for key in keys:
            rel = key[len(prefix):] if prefix and key.startswith(prefix) else key
            if not rel or rel.endswith("/"):
                continue
            dest = os.path.join(path, rel)
            # keys are untrusted remote names: a '..' segment must not write
            # outside the mount
            if os.path.commonpath([os.path.realpath(path), os.path.realpath(dest)]) != os.path.realpath(path):
                logger.warning(f"bucket key escapes mount, skipped: {key!r}")
                continue
            os.makedirs(os.path.dirname(dest) or path, exist_ok=True)
            data = await client.get_object(key)
            with open(dest, "wb") as f:
                f.write(data)
            st.synced_sha[rel] = hashlib.sha256(data).hexdigest()
        logger.debug(f"bucket mount {spec['bucket_name']} -> {path}: {len(st.synced_sha)} objects")
        states.append(st)
    return states


def writeback_bucket_mounts_sync(states: list[_MountState]) -> None:
    """Upload files that are new or changed since sync-down (skipped for
    read_only mounts). SYNCHRONOUS on purpose: this runs in the container's
    shutdown finally — the main task is mid-cancellation there, and aiohttp
    awaits were observed hanging until the worker's SIGKILL escalation.
    Blocking urllib can't be cancelled out from under us. Failures log —
    exit-time write-back must not mask the task's own result."""
    for st in states:
        if st.spec.get("read_only"):
            continue
        for root, _dirs, files in os.walk(st.path):
            for name in files:
                full = os.path.join(root, name)
                rel = os.path.relpath(full, st.path)
                try:
                    sha = _file_sha(full)
                    if st.synced_sha.get(rel) == sha:
                        continue
                    with open(full, "rb") as f:
                        data = f.read()
                    st.client.put_object_sync(st.prefix + rel, data)
                except Exception as exc:  # noqa: BLE001
                    logger.warning(f"bucket write-back failed for {rel}: {exc}")
