"""Static-egress proxy objects (port of modal_tpu/proxy.py; reference
py/modal/proxy.py:1).

A Proxy gives a function's containers a stable outbound IP, the thing to
hand an allowlist-guarded database. A function binds one with
`@app.function(proxy=modal_tpu_torch.Proxy.from_name("prod-egress"))`; its
containers see the egress address as `MODAL_TPU_PROXY_IP`.

Unlike the reference (where proxies are provisioned only from the
dashboard), this control plane provisions them from the SDK
(`Proxy.create`): there is no separate dashboard.
"""

from __future__ import annotations

from typing import Optional

from ._utils.async_utils import synchronize_api
from ._utils.grpc_utils import retry_transient_errors
from .client import _Client
from .object import LoadContext, Resolver, _Object
from .proto import api_pb2


class _Proxy(_Object, type_prefix="pr"):
    @staticmethod
    def from_name(name: str, *, environment_name: Optional[str] = None) -> "_Proxy":
        async def _load(self: "_Proxy", resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
            resp = await retry_transient_errors(
                context.client.stub.ProxyGet,
                api_pb2.ProxyGetRequest(
                    name=name, environment_name=environment_name or context.environment_name
                ),
            )
            self._hydrate(resp.proxy.proxy_id, context.client, None)

        return _Proxy._from_loader(_load, f"Proxy.from_name({name!r})", hydrate_lazily=True)

    @staticmethod
    async def create(
        name: str, *, environment_name: Optional[str] = None, client: Optional[_Client] = None
    ) -> "_Proxy":
        """Provision a new static-egress proxy (CLI: `modal-tpu proxy create`)."""
        if client is None:
            client = await _Client.from_env()
        resp = await retry_transient_errors(
            client.stub.ProxyCreate,
            api_pb2.ProxyCreateRequest(name=name, environment_name=environment_name or ""),
        )
        return _Proxy._new_hydrated(resp.proxy.proxy_id, client, None)

    @staticmethod
    async def lookup(name: str, *, client: Optional[_Client] = None) -> "_Proxy":
        obj = _Proxy.from_name(name)
        await obj.hydrate(client)
        return obj

    @staticmethod
    async def delete(name: str, *, client: Optional[_Client] = None) -> None:
        obj = await _Proxy.lookup(name, client=client)
        await retry_transient_errors(
            obj.client.stub.ProxyDelete, api_pb2.ProxyDeleteRequest(proxy_id=obj.object_id)
        )


Proxy = synchronize_api(_Proxy)
