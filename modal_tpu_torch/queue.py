"""Distributed queue with partitions (port of modal_tpu/queue.py; reference
py/modal/queue.py `_Queue`, with `QueueNextItems` long-poll iteration).

Values go through the port's `serialization.py`; a value that holds a CUDA
tensor comes back as a tensor on the reader's current card (ROADMAP Queue C
10). The plane keeps a queue's items in memory: a named queue survives a
restart of the plane, its items do not (as in the JAX package).
"""

from __future__ import annotations

from typing import Any, AsyncGenerator, Optional

from ._utils.async_utils import synchronize_api
from ._utils.grpc_utils import retry_transient_errors
from .client import _Client
from .exception import InvalidError
from .object import LoadContext, Resolver, _Object, live_method, live_method_gen
from .proto import api_pb2
from .serialization import deserialize, serialize


class _Queue(_Object, type_prefix="qu"):
    @staticmethod
    def validate_partition_key(partition: Optional[str]) -> str:
        if partition is None:
            return ""
        if not 0 < len(partition) <= 64:
            raise InvalidError("partition key must be 1-64 characters")
        return partition

    @staticmethod
    def from_name(
        name: str, *, environment_name: Optional[str] = None, create_if_missing: bool = False
    ) -> "_Queue":
        async def _load(self: "_Queue", resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
            req = api_pb2.QueueGetOrCreateRequest(
                deployment_name=name,
                environment_name=environment_name or context.environment_name,
                object_creation_type=(
                    api_pb2.OBJECT_CREATION_TYPE_CREATE_IF_MISSING
                    if create_if_missing
                    else api_pb2.OBJECT_CREATION_TYPE_UNSPECIFIED
                ),
            )
            resp = await retry_transient_errors(context.client.stub.QueueGetOrCreate, req)
            self._hydrate(resp.queue_id, context.client, None)

        return _Queue._from_loader(_load, f"Queue.from_name({name!r})", hydrate_lazily=True)

    @classmethod
    async def ephemeral(cls, client: Optional[_Client] = None) -> "_Queue":
        if client is None:
            client = await _Client.from_env()
        resp = await retry_transient_errors(
            client.stub.QueueGetOrCreate,
            api_pb2.QueueGetOrCreateRequest(object_creation_type=api_pb2.OBJECT_CREATION_TYPE_EPHEMERAL),
        )
        return cls._new_hydrated_ephemeral(resp.queue_id, client)

    @staticmethod
    async def lookup(name: str, *, client: Optional[_Client] = None, create_if_missing: bool = False) -> "_Queue":
        obj = _Queue.from_name(name, create_if_missing=create_if_missing)
        await obj.hydrate(client)
        return obj

    @staticmethod
    async def delete(name: str, *, client: Optional[_Client] = None) -> None:
        obj = await _Queue.lookup(name, client=client)
        await retry_transient_errors(obj.client.stub.QueueDelete, api_pb2.QueueDeleteRequest(queue_id=obj.object_id))

    @live_method
    async def put(
        self,
        v: Any,
        *,
        partition: Optional[str] = None,
        timeout: Optional[float] = None,
        partition_ttl: int = 86400,
    ) -> None:
        await self.put_many([v], partition=partition, timeout=timeout, partition_ttl=partition_ttl)

    @live_method
    async def put_many(
        self,
        vs: list,
        *,
        partition: Optional[str] = None,
        timeout: Optional[float] = None,
        partition_ttl: int = 86400,
    ) -> None:
        await retry_transient_errors(
            self.client.stub.QueuePut,
            api_pb2.QueuePutRequest(
                queue_id=self.object_id,
                values=[serialize(v, keep_device=True) for v in vs],
                partition_key=self.validate_partition_key(partition),
                timeout=timeout or 0.0,
                partition_ttl_seconds=partition_ttl,
            ),
        )

    @live_method
    async def get(
        self, *, block: bool = True, timeout: Optional[float] = None, partition: Optional[str] = None
    ) -> Any:
        poll = (timeout if timeout is not None else 3600.0) if block else 0.0
        resp = await retry_transient_errors(
            self.client.stub.QueueGet,
            api_pb2.QueueGetRequest(
                queue_id=self.object_id,
                partition_key=self.validate_partition_key(partition),
                timeout=poll,
                n_values=1,
            ),
            attempt_timeout=poll + 5.0,
        )
        if resp.values:
            return deserialize(resp.values[0], self.client)
        if block:
            from .exception import TimeoutError as _TimeoutError

            raise _TimeoutError("queue.get timed out")
        return None

    @live_method
    async def get_many(
        self, n_values: int, *, block: bool = True, timeout: Optional[float] = None, partition: Optional[str] = None
    ) -> list:
        poll = (timeout if timeout is not None else 3600.0) if block else 0.0
        resp = await retry_transient_errors(
            self.client.stub.QueueGet,
            api_pb2.QueueGetRequest(
                queue_id=self.object_id,
                partition_key=self.validate_partition_key(partition),
                timeout=poll,
                n_values=n_values,
            ),
            attempt_timeout=poll + 5.0,
        )
        return [deserialize(v, self.client) for v in resp.values]

    @live_method_gen
    async def iterate(
        self, *, partition: Optional[str] = None, item_poll_timeout: float = 0.0
    ) -> AsyncGenerator[Any, None]:
        """Non-destructive iteration via QueueNextItems long-poll (reference
        queue.py iterate)."""
        last_entry_id = ""
        while True:
            resp = await retry_transient_errors(
                self.client.stub.QueueNextItems,
                api_pb2.QueueNextItemsRequest(
                    queue_id=self.object_id,
                    partition_key=self.validate_partition_key(partition),
                    last_entry_id=last_entry_id,
                    item_poll_timeout=item_poll_timeout,
                ),
            )
            if not resp.items:
                return
            for item in resp.items:
                yield deserialize(item.value, self.client)
                last_entry_id = item.entry_id

    @live_method
    async def len(self, *, partition: Optional[str] = None, total: bool = False) -> int:
        resp = await retry_transient_errors(
            self.client.stub.QueueLen,
            api_pb2.QueueLenRequest(
                queue_id=self.object_id, partition_key=self.validate_partition_key(partition), total=total
            ),
        )
        return resp.len

    @live_method
    async def clear(self, *, partition: Optional[str] = None, all: bool = False) -> None:  # noqa: A002
        await retry_transient_errors(
            self.client.stub.QueueClear,
            api_pb2.QueueClearRequest(
                queue_id=self.object_id,
                partition_key=self.validate_partition_key(partition),
                all_partitions=all,
            ),
        )


Queue = synchronize_api(_Queue)
