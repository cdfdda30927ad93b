"""Lazy object model: unhydrated handles + deferred loading + hydration
(port of modal_tpu/object.py).

Reference: py/modal/_object.py (`_Object`, _object.py:77), py/modal/_resolver.py
(`Resolver`, _resolver.py:14), py/modal/_load_context.py (`LoadContext`).

Every server resource (Function, Image, Volume, Dict, ...) is a subclass with a
`type_prefix` ID namespace. Objects are constructed *unhydrated* with a
deferred `_load` coroutine; `Resolver.load` runs loads with per-object
deduplication; `_hydrate` binds the handle to server state. `live_method`
decorators auto-hydrate on first use.
"""

from __future__ import annotations

import asyncio
import functools
import os
import typing
import uuid
from typing import Any, Awaitable, Callable, ClassVar, Hashable, Optional, TypeVar

from .client import _Client
from .config import logger
from .exception import ExecutionError, InvalidError

O = TypeVar("O", bound="_Object")

_BLOCKING_O = typing.TypeVar("_BLOCKING_O")


class LoadContext:
    """Carries client/environment/app through a load graph (reference:
    _load_context.py:11)."""

    def __init__(
        self,
        client: Optional[_Client] = None,
        environment_name: Optional[str] = None,
        app_id: Optional[str] = None,
    ):
        self._client = client
        self.environment_name = environment_name or ""
        self.app_id = app_id

    @property
    def client(self) -> _Client:
        if self._client is None:
            raise ExecutionError("LoadContext has no client bound")
        return self._client

    async def resolve_client(self) -> _Client:
        if self._client is None:
            self._client = await _Client.from_env()
        return self._client

    def merged_with(self, other: Optional["LoadContext"]) -> "LoadContext":
        if other is None:
            return self
        return LoadContext(
            client=other._client or self._client,
            environment_name=other.environment_name or self.environment_name,
            app_id=other.app_id or self.app_id,
        )

    def copy(self, **updates: Any) -> "LoadContext":
        ctx = LoadContext(self._client, self.environment_name, self.app_id)
        for k, v in updates.items():
            setattr(ctx, k if not k.startswith("client") else "_client", v)
        return ctx


# the module defining each handle type, by its id prefix ("vo" is Volume's:
# a NetworkFileSystem handle reuses its prefix)
_PREFIX_MODULES = {
    "cs": "cls", "di": "dict", "fu": "functions", "fc": "functions", "im": "image", "mo": "mount", "pr": "proxy",
    "qu": "queue", "sb": "sandbox", "st": "secret", "sn": "snapshot", "vo": "volume", "ac": "workspace",
}


class _Object:
    _type_prefix: ClassVar[Optional[str]] = None
    _prefix_to_type: ClassVar[dict[str, type]] = {}

    _load: Optional[Callable[["_Object", "Resolver", LoadContext, Optional[str]], Awaitable[None]]]
    _preload: Optional[Callable[["_Object", "Resolver", LoadContext, Optional[str]], Awaitable[None]]]
    _rep: str
    _is_another_app: bool
    _hydrate_lazily: bool
    _deps: Optional[Callable[..., list["_Object"]]]
    _deduplication_key: Optional[Callable[[], Awaitable[Hashable]]] = None

    _object_id: Optional[str]
    _client: Optional[_Client]
    _is_hydrated: bool

    @classmethod
    def __init_subclass__(cls, type_prefix: Optional[str] = None) -> None:
        super().__init_subclass__()
        if type_prefix is not None:
            cls._type_prefix = type_prefix
            # first registration wins: alias subclasses (e.g. NetworkFileSystem
            # over Volume's "vo" prefix) must not hijack deserialization of
            # the base type
            cls._prefix_to_type.setdefault(type_prefix, cls)

    def __init__(self, *args: Any, **kwargs: Any):
        raise InvalidError(f"Class {type(self).__name__} has no constructor. Use class constructor methods instead.")

    def _init(
        self,
        rep: str,
        load: Optional[Callable] = None,
        is_another_app: bool = False,
        preload: Optional[Callable] = None,
        hydrate_lazily: bool = False,
        deps: Optional[Callable[..., list["_Object"]]] = None,
        deduplication_key: Optional[Callable[[], Awaitable[Hashable]]] = None,
    ) -> None:
        self._local_uuid = str(uuid.uuid4())
        self._load = load
        self._preload = preload
        self._rep = rep
        self._is_another_app = is_another_app
        self._hydrate_lazily = hydrate_lazily
        self._deps = deps
        self._deduplication_key = deduplication_key
        self._object_id = None
        self._client = None
        self._is_hydrated = False
        self._initialize_from_empty()

    def _initialize_from_empty(self) -> None:
        # subclass hook for instance-local state
        pass

    def _initialize_from_other(self, other: "_Object") -> None:
        self._object_id = other._object_id
        self._is_hydrated = other._is_hydrated
        self._client = other._client

    def _hydrate(self, object_id: str, client: _Client, metadata: Optional[Any]) -> None:
        assert isinstance(object_id, str)
        if self._type_prefix and not object_id.startswith(self._type_prefix + "-"):
            raise ExecutionError(
                f"can't hydrate {type(self).__name__}: id {object_id} has wrong prefix "
                f"(expected {self._type_prefix}-...)"
            )
        self._object_id = object_id
        self._client = client
        self._hydrate_metadata(metadata)
        self._is_hydrated = True

    def _hydrate_metadata(self, metadata: Optional[Any]) -> None:
        # subclass hook: bind server-returned handle metadata
        pass

    def _get_metadata(self) -> Optional[bytes]:
        # subclass hook: serialized handle metadata for persistent-id pickling
        return None

    @classmethod
    def _from_loader(
        cls: type[O],
        load: Callable,
        rep: str,
        is_another_app: bool = False,
        preload: Optional[Callable] = None,
        hydrate_lazily: bool = False,
        deps: Optional[Callable[..., list["_Object"]]] = None,
        deduplication_key: Optional[Callable[[], Awaitable[Hashable]]] = None,
    ) -> O:
        obj = cls.__new__(cls)
        obj._init(rep, load, is_another_app, preload, hydrate_lazily, deps, deduplication_key)
        return obj

    @classmethod
    def _new_hydrated(cls: type[O], object_id: str, client: _Client, metadata: Optional[Any]) -> O:
        obj = cls.__new__(cls)
        obj._init(rep=f"{cls.__name__}({object_id})")
        obj._hydrate(object_id, client, metadata)
        return obj

    @classmethod
    def _new_hydrated_ephemeral(cls: type[O], object_id: str, client: _Client, metadata: Optional[Any] = None) -> O:
        """Hydrate an ephemeral object AND keep it alive: a background task
        heartbeats it (reference _object.py:21 EPHEMERAL_OBJECT_HEARTBEAT_
        SLEEP) so the server's reaper knows the client still holds it; the
        object disappears server-side ~TTL after this client exits."""
        obj = cls._new_hydrated(object_id, client, metadata)
        obj._ephemeral_heartbeat_task = asyncio.create_task(
            _ephemeral_heartbeat_loop(client, object_id),
            name=f"ephemeral-heartbeat-{object_id}",
        )
        return obj

    @classmethod
    def _new_hydrated_from_pickle(cls, object_id: str, client: _Client, metadata_bytes: bytes) -> "_Object":
        prefix = object_id.split("-", 1)[0]
        subcls = cls._prefix_to_type.get(prefix)
        if subcls is None and prefix in _PREFIX_MODULES:
            # the package imports lazily: a container given a handle of a
            # type whose module it has not loaded loads it now
            import importlib

            importlib.import_module(f"{__package__}.{_PREFIX_MODULES[prefix]}")
            subcls = cls._prefix_to_type.get(prefix)
        if subcls is None:
            raise ExecutionError(f"unknown object id prefix {prefix!r} in {object_id}")
        metadata = subcls._deserialize_metadata(metadata_bytes) if metadata_bytes else None
        return subcls._new_hydrated(object_id, client, metadata)

    @classmethod
    def _deserialize_metadata(cls, metadata_bytes: bytes) -> Optional[Any]:
        return None

    def clone(self: O) -> O:
        obj = type(self).__new__(type(self))
        obj.__dict__ = dict(self.__dict__)
        obj._local_uuid = str(uuid.uuid4())
        return obj

    @property
    def local_uuid(self) -> str:
        return self._local_uuid

    @property
    def object_id(self) -> str:
        if self._object_id is None:
            raise ExecutionError(f"object {self._rep} has no id (not hydrated)")
        return self._object_id

    @property
    def client(self) -> _Client:
        assert self._client is not None
        return self._client

    @property
    def is_hydrated(self) -> bool:
        return self._is_hydrated

    @property
    def deps(self) -> Callable[..., list["_Object"]]:
        return self._deps if self._deps is not None else lambda: []

    async def hydrate(self: O, client: Optional[_Client] = None) -> O:
        """Hydrate on demand — lazy objects only (reference `hydrate`,
        _object.py)."""
        if self._is_hydrated:
            return self
        if not self._hydrate_lazily:
            raise ExecutionError(
                f"{self._rep} can't be hydrated lazily: run it inside an app or use `.from_name`/`.lookup`"
            )
        ctx = LoadContext(client)
        await ctx.resolve_client()
        resolver = Resolver()
        await resolver.load(self, ctx)
        return self

    def __repr__(self) -> str:
        return self._rep

    def _validate_is_hydrated(self) -> None:
        if not self._is_hydrated:
            raise ExecutionError(f"{self._rep} has not been hydrated with the metadata it needs to run.")


def live_method(method: Callable) -> Callable:
    """Auto-hydrate `self` before an async method runs (reference:
    _object.py:42)."""

    @functools.wraps(method)
    async def wrapped(self: _Object, *args: Any, **kwargs: Any) -> Any:
        if not self._is_hydrated:
            await self.hydrate()
        return await method(self, *args, **kwargs)

    return wrapped


def live_method_gen(method: Callable) -> Callable:
    """Auto-hydrate for async generator methods (reference: _object.py:51)."""

    @functools.wraps(method)
    async def wrapped(self: _Object, *args: Any, **kwargs: Any) -> Any:
        if not self._is_hydrated:
            await self.hydrate()
        async for item in method(self, *args, **kwargs):
            yield item

    return wrapped


class Resolver:
    """Loads an object graph with per-object dedup (reference: _resolver.py:39).

    Concurrent loads of the same object (by local uuid or deduplication key)
    share one future; deps load before dependents.
    """

    def __init__(self) -> None:
        self._local_uuid_to_future: dict[str, asyncio.Future] = {}
        self._deduplication_cache: dict[Hashable, asyncio.Future] = {}

    async def preload(self, obj: _Object, context: LoadContext) -> None:
        if obj._preload is not None:
            await obj._preload(obj, self, context, None)

    async def load(self, obj: _Object, context: LoadContext, existing_object_id: Optional[str] = None) -> _Object:
        if obj._is_hydrated and obj._is_another_app:
            return obj

        cached_future = self._local_uuid_to_future.get(obj.local_uuid)
        if cached_future is None and obj._deduplication_key is not None:
            dedup_key = await obj._deduplication_key()
            dedup_future = self._deduplication_cache.get(dedup_key)
            if dedup_future is not None:
                hydrated = await asyncio.shield(dedup_future)
                obj._initialize_from_other(hydrated)
                return obj
        else:
            dedup_key = None

        if cached_future is not None:
            return await asyncio.shield(cached_future)

        async def _loader() -> _Object:
            # load deps first (parallel). A dep hydrated by a DIFFERENT
            # client (e.g. the module-level default image, hydrated during a
            # previous app run / against a previous server) must re-load —
            # its object id means nothing to this context's server.
            deps = obj.deps()
            if deps:
                await asyncio.gather(
                    *[
                        self.load(dep, context)
                        for dep in deps
                        if not dep._is_hydrated or dep._client is not context.client
                    ]
                )
            if obj._load is not None:
                await obj._load(obj, self, context, existing_object_id)
            if obj._object_id is None:
                raise ExecutionError(f"loader for {obj._rep} didn't hydrate the object")
            if existing_object_id is not None and obj._object_id != existing_object_id:
                logger.debug(f"object id changed on reload: {existing_object_id} -> {obj._object_id}")
            return obj

        fut = asyncio.ensure_future(_loader())
        self._local_uuid_to_future[obj.local_uuid] = fut
        if dedup_key is not None:
            self._deduplication_cache[dedup_key] = fut
        return await fut

    @property
    def objects(self) -> list[_Object]:
        return [fut.result() for fut in self._local_uuid_to_future.values() if fut.done() and not fut.exception()]


async def _ephemeral_heartbeat_loop(client: _Client, object_id: str) -> None:
    """Keep an ephemeral object alive while this client holds it (reference
    _object.py:21). Sleeps in short slices so a closed client stops the loop
    within seconds rather than one full heartbeat period."""
    from ._utils.grpc_utils import retry_transient_errors
    from .proto import api_pb2

    interval = float(os.environ.get("MODAL_TPU_EPHEMERAL_HEARTBEAT", "300"))
    elapsed = 0.0
    while not client._closed:
        await asyncio.sleep(min(5.0, interval))
        elapsed += min(5.0, interval)
        if elapsed < interval:
            continue
        elapsed = 0.0
        if client._closed:
            return
        try:
            await retry_transient_errors(
                client.stub.EphemeralObjectHeartbeat,
                api_pb2.EphemeralObjectHeartbeatRequest(object_id=object_id),
                max_retries=3,
            )
        except Exception as exc:  # noqa: BLE001
            # NOT_FOUND = the object was deleted: stop for good. Anything
            # else is transient beyond the retries — keep the loop alive, a
            # single blip must not doom the object to the reaper.
            import grpc as _grpc

            if isinstance(exc, _grpc.aio.AioRpcError) and exc.code() == _grpc.StatusCode.NOT_FOUND:
                logger.debug(f"ephemeral object {object_id} gone; stopping heartbeats")
                return
            logger.debug(f"ephemeral heartbeat for {object_id} failed (will retry): {exc}")
