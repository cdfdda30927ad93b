"""Client-side shard routing (port of modal_tpu/_utils/shard_router.py).

When ClientHello returns a shard map (``shard_map_json``: the director's
``{"epoch": E, "urls": [owner-url per partition]}``), the client wraps its
stub in a ``ShardRouterStub``: unary RPCs that carry a routable id/name dial
the owning shard DIRECTLY — the director stays out of the data path — while
streams and unroutable RPCs go through the director, which forwards.

Failover ride-along: a direct-dialed shard that died answers UNAVAILABLE.
The router then re-hellos the director for a fresh map (the takeover rewrote
it at a bumped epoch) and retries once against the new owner.  Layered under
``retry_transient_errors``, every retry attempt re-routes — so a map running
through a shard kill keeps its idempotency key while its attempts migrate to
the successor, and the successor's journal-replayed dedupe cache keeps the
effect exactly-once.
"""

from __future__ import annotations

import json
from typing import Any

import grpc
import grpc.aio

from ..proto import api_pb2
from ..proto.rpc import RPCS, Arity
from .shard_routing import partition_for_request


class _RoutedUnary:
    """One unary RPC on the router: route → dial owner → on UNAVAILABLE,
    refresh the map and retry once.  Carries the ``_method`` attr the retry
    engine's breaker/logging key off."""

    def __init__(self, router: "ShardRouterStub", name: str, path: str):
        self._router = router
        self._name = name
        self._method = path
        self._breaker_scope = "shardmap"

    async def _target(self, request) -> tuple[Any, bool]:
        router = self._router
        part = partition_for_request(request, len(router.shard_urls))
        if part is None:
            return router.director, False
        return await router.client.get_stub(router.shard_urls[part]), True

    async def __call__(self, request, timeout=None, metadata=None, **kwargs):
        metadata = self._with_trace_context(metadata)
        target, direct = await self._target(request)
        fn = getattr(target, self._name)
        try:
            return await fn(request, timeout=timeout, metadata=metadata, **kwargs)
        except grpc.aio.AioRpcError as exc:
            if not direct or exc.code() != grpc.StatusCode.UNAVAILABLE:
                raise
            # the owner may have just died: the director's health loop fences
            # it and rewrites the map — fetch the new topology and re-dial.
            # the same trace context rides the retry: the re-routed attempt
            # stitches under the SAME caller span as the failed one
            await self._router.refresh()
            target, _ = await self._target(request)
            return await getattr(target, self._name)(
                request, timeout=timeout, metadata=metadata, **kwargs
            )

    @staticmethod
    def _with_trace_context(metadata):
        """Attach the ambient trace context to a routed call: explicit
        metadata survives the refresh-and-retry leg landing on another
        channel and stitches the in-process rung as the wire does."""
        from ..observability import tracing

        ctx = tracing.current_context()
        if ctx is None:
            return metadata
        md = list(metadata or ())
        have = {k for k, _v in md}
        if tracing.TRACE_ID_METADATA_KEY in have:
            return metadata
        return md + tracing.context_metadata(ctx)


class ShardRouterStub:
    """Drop-in for ModalTPUStub: same attribute surface, shard-map-aware
    dispatch.  ``director`` is the (fast-path-wrapped) stub on the director's
    channel; per-shard stubs come from the client's cache on demand."""

    def __init__(self, client: Any, director_stub: Any, shard_map: dict):
        self.client = client
        self.director = director_stub
        self.epoch = 0
        self.shard_urls: list[str] = []
        self.update_map(shard_map)

    def update_map(self, shard_map: dict) -> None:
        epoch = int(shard_map.get("epoch", 0))
        if epoch < self.epoch:
            return  # stale map (raced refreshes) must not roll routing back
        self.epoch = epoch
        self.shard_urls = list(shard_map.get("urls") or [])

    async def refresh(self) -> None:
        from .grpc_utils import retry_transient_errors

        resp = await retry_transient_errors(
            self.director.ClientHello,
            api_pb2.ClientHelloRequest(),
            max_retries=5,
        )
        if resp.shard_map_json:
            self.update_map(json.loads(resp.shard_map_json))

    def __getattr__(self, name: str):
        method = RPCS.get(name)
        if method is None:
            raise AttributeError(name)
        if method.arity != Arity.UNARY_UNARY:
            # streams hold a connection for their lifetime; the director
            # forwards them so the client never pins a stream to a shard
            # that a takeover is about to replace
            return getattr(self.director, name)
        routed = _RoutedUnary(self, name, method.path)
        self.__dict__[name] = routed  # cache: one wrapper per method
        return routed
