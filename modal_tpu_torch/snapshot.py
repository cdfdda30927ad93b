"""Sandbox snapshots (port of modal_tpu/snapshot.py; reference
py/modal/snapshot.py _SandboxSnapshot).

A snapshot captures a sandbox's definition and filesystem; restoring creates
a fresh sandbox whose workdir is seeded from the snapshot. The reference's
memory half rides CRIU in its closed worker runtime; here the restored
sandbox re-runs its entrypoint over the snapshot's filesystem (api.proto
SandboxSnapshotRequest).
"""

from __future__ import annotations

from typing import Optional

from ._utils.async_utils import synchronize_api
from ._utils.grpc_utils import retry_transient_errors
from .client import _Client
from .object import _Object
from .proto import api_pb2


class _SandboxSnapshot(_Object, type_prefix="sn"):
    @staticmethod
    async def from_id(snapshot_id: str, client: Optional[_Client] = None) -> "_SandboxSnapshot":
        if client is None:
            client = await _Client.from_env()
        resp = await retry_transient_errors(
            client.stub.SandboxSnapshotGet, api_pb2.SandboxSnapshotGetRequest(snapshot_id=snapshot_id)
        )
        return _SandboxSnapshot._new_hydrated(resp.snapshot_id, client, None)


SandboxSnapshot = synchronize_api(_SandboxSnapshot)
