"""Workspace identity, membership and settings (port of
modal_tpu/workspace.py; reference py/modal/_workspace.py:70 `_Workspace`,
`_WorkspaceMembersManager`, `_WorkspaceSettingsManager`; the billing RPCs
are not part of the contract).

The local control plane models a single workspace ("local") whose members
are its issued tokens, the oldest grant its owner. Settings are validated
by the plane (`image_builder_version` must name an epoch of
`modal_tpu_torch/builder/`, `default_environment` a real environment);
`image_builder_version` decides the epoch a client's images build at
(`Image._load`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ._utils.async_utils import synchronize_api
from ._utils.grpc_utils import retry_transient_errors
from .object import LoadContext, Resolver, _Object
from .proto import api_pb2


@dataclass(frozen=True)
class WorkspaceMemberInfo:
    username: str
    role: str
    created_at: float


class _WorkspaceMembersManager:
    def __init__(self, workspace: "_Workspace"):
        self._workspace = workspace

    async def _stub(self):
        # auto-hydrate: from_context() is lazy; reaching for .members before
        # an explicit hydrate() must work, not die on a bare client assert
        if not self._workspace._is_hydrated:
            await self._workspace.hydrate()
        return self._workspace.client.stub

    async def list(self) -> list[WorkspaceMemberInfo]:
        stub = await self._stub()
        resp = await retry_transient_errors(
            stub.WorkspaceMemberList, api_pb2.WorkspaceMemberListRequest()
        )
        return [
            WorkspaceMemberInfo(username=m.username, role=m.role, created_at=m.created_at)
            for m in resp.members
        ]


class _WorkspaceSettingsManager:
    def __init__(self, workspace: "_Workspace"):
        self._workspace = workspace

    async def _stub(self):
        if not self._workspace._is_hydrated:
            await self._workspace.hydrate()
        return self._workspace.client.stub

    async def list(self) -> dict[str, str]:
        stub = await self._stub()
        resp = await retry_transient_errors(
            stub.WorkspaceSettingsList, api_pb2.WorkspaceSettingsListRequest()
        )
        return {s.name: s.value for s in resp.settings}

    async def set(self, name: str, value: str) -> None:
        stub = await self._stub()
        await retry_transient_errors(
            stub.WorkspaceSettingsSet,
            api_pb2.WorkspaceSettingsSetRequest(name=name, value=value),
        )


class _Workspace(_Object, type_prefix="ac"):
    _name: Optional[str] = None

    @property
    def name(self) -> Optional[str]:
        return self._name

    @property
    def members(self) -> _WorkspaceMembersManager:
        return _WorkspaceMembersManager(self)

    @property
    def settings(self) -> _WorkspaceSettingsManager:
        return _WorkspaceSettingsManager(self)

    @staticmethod
    def from_context() -> "_Workspace":
        """The workspace the active credentials authenticate against
        (reference Workspace.from_context, _workspace.py:87)."""

        async def _load(self: "_Workspace", resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
            resp = await retry_transient_errors(
                context.client.stub.WorkspaceNameLookup, api_pb2.WorkspaceNameLookupRequest()
            )
            self._name = resp.workspace_name or None
            # workspaces have no server-side id namespace locally: synthesize
            self._hydrate(f"ac-{resp.workspace_name or 'local'}", context.client, None)

        return _Workspace._from_loader(_load, "Workspace.from_context()", hydrate_lazily=True)


Workspace = synchronize_api(_Workspace)
WorkspaceMembersManager = synchronize_api(_WorkspaceMembersManager)
WorkspaceSettingsManager = synchronize_api(_WorkspaceSettingsManager)
