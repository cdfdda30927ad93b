"""NetworkFileSystem: the legacy shared-volume API (port of
modal_tpu/network_file_system.py; reference py/modal/network_file_system.py
`_NetworkFileSystem`, kept for the surface: new code uses Volume). It is a
Volume of the same block store under the name `nfs:<name>`, with the v1
file-system version."""

from __future__ import annotations

from typing import Optional

from ._utils.async_utils import synchronize_api
from ._utils.grpc_utils import retry_transient_errors
from .object import LoadContext, Resolver
from .proto import api_pb2
from .volume import _Volume


class _NetworkFileSystem(_Volume, type_prefix="vo"):
    """Thin alias over Volume with v1 semantics (reference marks NFS legacy)."""

    @staticmethod
    def from_name(
        name: str, *, environment_name: Optional[str] = None, create_if_missing: bool = False
    ) -> "_NetworkFileSystem":
        async def _load(self, resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
            req = api_pb2.VolumeGetOrCreateRequest(
                deployment_name=f"nfs:{name}",
                environment_name=environment_name or context.environment_name,
                object_creation_type=(
                    api_pb2.OBJECT_CREATION_TYPE_CREATE_IF_MISSING
                    if create_if_missing
                    else api_pb2.OBJECT_CREATION_TYPE_UNSPECIFIED
                ),
                version=api_pb2.VOLUME_FS_VERSION_V1,
            )
            resp = await retry_transient_errors(context.client.stub.VolumeGetOrCreate, req)
            self._hydrate(resp.volume_id, context.client, resp.metadata)

        return _NetworkFileSystem._from_loader(
            _load, f"NetworkFileSystem.from_name({name!r})", hydrate_lazily=True
        )


NetworkFileSystem = synchronize_api(_NetworkFileSystem)
