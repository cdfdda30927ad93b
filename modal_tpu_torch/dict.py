"""Distributed key-value store (port of modal_tpu/dict.py; reference
py/modal/dict.py `_Dict`).

Keys and values go through the port's `serialization.py`; a value that
holds a CUDA tensor comes back as a tensor on the reader's current card
(ROADMAP Queue C 10), where a function's result comes back on the CPU. The
plane keeps a dict's contents in memory: a named dict survives a restart of
the plane, its contents do not (as in the JAX package).
"""

from __future__ import annotations

from typing import Any, AsyncGenerator, Optional

from ._utils.async_utils import synchronize_api
from ._utils.grpc_utils import retry_transient_errors
from .client import _Client
from .object import LoadContext, Resolver, _Object, live_method, live_method_gen
from .proto import api_pb2
from .serialization import deserialize, serialize


class _Dict(_Object, type_prefix="di"):
    @staticmethod
    def from_name(
        name: str, *, environment_name: Optional[str] = None, create_if_missing: bool = False
    ) -> "_Dict":
        async def _load(self: "_Dict", resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
            req = api_pb2.DictGetOrCreateRequest(
                deployment_name=name,
                environment_name=environment_name or context.environment_name,
                object_creation_type=(
                    api_pb2.OBJECT_CREATION_TYPE_CREATE_IF_MISSING
                    if create_if_missing
                    else api_pb2.OBJECT_CREATION_TYPE_UNSPECIFIED
                ),
            )
            resp = await retry_transient_errors(context.client.stub.DictGetOrCreate, req)
            self._hydrate(resp.dict_id, context.client, None)

        return _Dict._from_loader(_load, f"Dict.from_name({name!r})", hydrate_lazily=True)

    @classmethod
    async def ephemeral(cls, client: Optional[_Client] = None) -> "_Dict":
        if client is None:
            client = await _Client.from_env()
        resp = await retry_transient_errors(
            client.stub.DictGetOrCreate,
            api_pb2.DictGetOrCreateRequest(object_creation_type=api_pb2.OBJECT_CREATION_TYPE_EPHEMERAL),
        )
        return cls._new_hydrated_ephemeral(resp.dict_id, client)

    @staticmethod
    async def lookup(name: str, *, client: Optional[_Client] = None, create_if_missing: bool = False) -> "_Dict":
        obj = _Dict.from_name(name, create_if_missing=create_if_missing)
        await obj.hydrate(client)
        return obj

    @staticmethod
    async def delete(name: str, *, client: Optional[_Client] = None) -> None:
        obj = await _Dict.lookup(name, client=client)
        await retry_transient_errors(obj.client.stub.DictDelete, api_pb2.DictDeleteRequest(dict_id=obj.object_id))

    @live_method
    async def get(self, key: Any, default: Any = None) -> Any:
        resp = await retry_transient_errors(
            self.client.stub.DictGet, api_pb2.DictGetRequest(dict_id=self.object_id, key=serialize(key))
        )
        return deserialize(resp.value, self.client) if resp.found else default

    @live_method
    async def __getitem__(self, key: Any) -> Any:
        resp = await retry_transient_errors(
            self.client.stub.DictGet, api_pb2.DictGetRequest(dict_id=self.object_id, key=serialize(key))
        )
        if not resp.found:
            raise KeyError(key)
        return deserialize(resp.value, self.client)

    @live_method
    async def put(self, key: Any, value: Any, *, skip_if_exists: bool = False) -> bool:
        resp = await retry_transient_errors(
            self.client.stub.DictUpdate,
            api_pb2.DictUpdateRequest(
                dict_id=self.object_id,
                updates=[api_pb2.DictEntry(key=serialize(key), value=serialize(value, keep_device=True))],
                if_not_exists=skip_if_exists,
            ),
        )
        return resp.created

    @live_method
    async def __setitem__(self, key: Any, value: Any) -> None:
        await self.put(key, value)

    @live_method
    async def update(self, other: dict = {}, /, **kwargs: Any) -> None:
        updates = [
            api_pb2.DictEntry(key=serialize(k), value=serialize(v, keep_device=True)) for k, v in {**other, **kwargs}.items()
        ]
        await retry_transient_errors(
            self.client.stub.DictUpdate, api_pb2.DictUpdateRequest(dict_id=self.object_id, updates=updates)
        )

    @live_method
    async def pop(self, key: Any) -> Any:
        resp = await retry_transient_errors(
            self.client.stub.DictPop, api_pb2.DictPopRequest(dict_id=self.object_id, key=serialize(key))
        )
        if not resp.found:
            raise KeyError(key)
        return deserialize(resp.value, self.client)

    @live_method
    async def contains(self, key: Any) -> bool:
        resp = await retry_transient_errors(
            self.client.stub.DictContains,
            api_pb2.DictContainsRequest(dict_id=self.object_id, key=serialize(key)),
        )
        return resp.found

    @live_method
    async def __contains__(self, key: Any) -> bool:
        return await self.contains(key)

    @live_method
    async def len(self) -> int:
        resp = await retry_transient_errors(self.client.stub.DictLen, api_pb2.DictLenRequest(dict_id=self.object_id))
        return resp.len

    @live_method
    async def __len__(self) -> int:
        return await self.len()

    @live_method_gen
    async def keys(self) -> AsyncGenerator[Any, None]:
        resp = await retry_transient_errors(
            self.client.stub.DictContents, api_pb2.DictContentsRequest(dict_id=self.object_id, keys=True)
        )
        for item in resp.items:
            yield deserialize(item.key, self.client)

    @live_method_gen
    async def values(self) -> AsyncGenerator[Any, None]:
        resp = await retry_transient_errors(
            self.client.stub.DictContents, api_pb2.DictContentsRequest(dict_id=self.object_id, values=True)
        )
        for item in resp.items:
            yield deserialize(item.value, self.client)

    @live_method_gen
    async def items(self) -> AsyncGenerator[tuple, None]:
        resp = await retry_transient_errors(
            self.client.stub.DictContents,
            api_pb2.DictContentsRequest(dict_id=self.object_id, keys=True, values=True),
        )
        for item in resp.items:
            yield (deserialize(item.key, self.client), deserialize(item.value, self.client))

    @live_method
    async def clear(self) -> None:
        await retry_transient_errors(self.client.stub.DictClear, api_pb2.DictClearRequest(dict_id=self.object_id))


Dict = synchronize_api(_Dict)
