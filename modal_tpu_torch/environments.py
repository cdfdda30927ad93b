"""Environment objects (port of modal_tpu/environments.py; reference
py/modal/environments.py): the SDK over the plane's environment CRUD, named
deployment namespaces within the workspace."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ._utils.async_utils import synchronize_api
from ._utils.grpc_utils import retry_transient_errors
from .client import _Client
from .exception import NotFoundError
from .proto import api_pb2


@dataclass(frozen=True)
class EnvironmentInfo:
    name: str
    webhook_suffix: str


class _Environment:
    """Handle for one environment. Environments have no server-side id
    namespace — the name IS the identity (matching the wire contract)."""

    def __init__(self, name: str, client: _Client):
        self.name = name
        self._client = client

    @staticmethod
    async def create(name: str, *, client: Optional[_Client] = None) -> "_Environment":
        if client is None:
            client = await _Client.from_env()
        await retry_transient_errors(
            client.stub.EnvironmentCreate, api_pb2.EnvironmentCreateRequest(name=name)
        )
        return _Environment(name, client)

    @staticmethod
    async def from_name(name: str, *, client: Optional[_Client] = None) -> "_Environment":
        if client is None:
            client = await _Client.from_env()
        resp = await retry_transient_errors(
            client.stub.EnvironmentList, api_pb2.EnvironmentListRequest()
        )
        if not any(item.name == name for item in resp.items):
            raise NotFoundError(f"environment {name!r} not found")
        return _Environment(name, client)

    @staticmethod
    async def list(*, client: Optional[_Client] = None) -> list[EnvironmentInfo]:
        if client is None:
            client = await _Client.from_env()
        resp = await retry_transient_errors(
            client.stub.EnvironmentList, api_pb2.EnvironmentListRequest()
        )
        return [EnvironmentInfo(name=i.name, webhook_suffix=i.webhook_suffix) for i in resp.items]

    async def delete(self) -> None:
        await retry_transient_errors(
            self._client.stub.EnvironmentDelete, api_pb2.EnvironmentDeleteRequest(name=self.name)
        )

    async def rename(self, new_name: str) -> None:
        await retry_transient_errors(
            self._client.stub.EnvironmentUpdate,
            api_pb2.EnvironmentUpdateRequest(current_name=self.name, name=new_name),
        )
        self.name = new_name


Environment = synchronize_api(_Environment)
