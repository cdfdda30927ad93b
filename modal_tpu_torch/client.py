"""The client: owns the channel + stub to the control plane (port of
modal_tpu/client.py).

Reference: py/modal/client.py `_Client` (client.py:77): `from_env`
(client.py:207), `from_credentials` (client.py:256), per-URL stub cache
(client.py:135), fork-safety PID reset (client.py:347). The stub is the
registry-derived `ModalTPUStub` over the port's messages, so this client
talks to any server of the wire contract, the JAX package's included.

Where the JAX client would (the default URL, nothing listening,
`auto_local_server` on, not in a container), this client boots the port's
in-process LocalSupervisor: control plane, blob server and one worker.

Stubs take the local fast-path ladder (_utils/local_transport.py): in
process when the URL is a plane of this process, else the plane's Unix
socket, else TCP. A container learns the socket and the blob store
directory from its env (`MODAL_TPU_SERVER_UDS`, `MODAL_TPU_BLOB_LOCAL_DIR`);
any other client from ClientHello. A path this process cannot stat keeps
the stub on TCP and HTTP.

A sharded control plane's director (server/shards.py) sends a shard map
at ClientHello: with more than one owner the stub becomes a
`ShardRouterStub`, which dials the owning shard of each routable unary RPC
and leaves streams and unroutable RPCs to the director. With
MODAL_TPU_SHARDS > 1, the auto-booted plane is a sharded one.
"""

from __future__ import annotations

import asyncio
import atexit
import os
import socket
from typing import Any, ClassVar, Optional

import grpc

from ._utils.async_utils import synchronize_api
from ._utils.grpc_utils import create_channel, retry_transient_errors
from .config import _SETTINGS, config, logger
from .exception import ClientClosed
from .proto import api_pb2
from .proto.rpc import ModalTPUStub

# an app run heartbeats its app every HEARTBEAT_INTERVAL seconds (runner.py)
HEARTBEAT_INTERVAL: float = config["heartbeat_interval"]
CLIENT_VERSION = "0.1.0"


class _Client:
    _client_from_env: ClassVar[Optional["_Client"]] = None
    _client_from_env_lock: ClassVar[Optional[asyncio.Lock]] = None

    def __init__(
        self,
        server_url: str,
        client_type: int = api_pb2.CLIENT_TYPE_CLIENT,
        credentials: Optional[tuple[str, str]] = None,
    ):
        self.server_url = server_url
        self.client_type = client_type
        self._credentials = credentials
        self._channel: Optional[grpc.aio.Channel] = None
        self._stub: Optional[ModalTPUStub] = None
        self._stub_cache: dict[str, ModalTPUStub] = {}
        self._channel_cache: dict[str, grpc.aio.Channel] = {}
        self._closed = False
        self._owner_pid = os.getpid()
        self.image_builder_version: Optional[str] = None
        self.input_plane_url: Optional[str] = None
        # the input plane's Unix socket, by its URL (from ClientHello): a
        # get_stub of that URL takes the socket rung
        self._uds_by_url: dict[str, str] = {}
        self._auth_token_manager: Optional[Any] = None
        # the TCP stub under the fast-path ladder: hello() re-wraps it once
        # the server advertises its local coordinates
        self._stub_tcp: Optional[ModalTPUStub] = None
        # coalesced dispatch (_utils/coalescer.py): a micro-batcher per
        # plane (FunctionMap), per event loop
        from ._utils.coalescer import BatcherRegistry

        self._batchers = BatcherRegistry()
        self._map_batch_unsupported = False

    def _metadata(self) -> dict[str, str]:
        md = {
            "x-modal-tpu-client-version": CLIENT_VERSION,
            "x-modal-tpu-client-type": str(self.client_type),
        }
        if self._credentials:
            token_id, token_secret = self._credentials
            md["x-modal-tpu-token-id"] = token_id
            md["x-modal-tpu-token-secret"] = token_secret
        if config["task_id"]:
            md["x-modal-tpu-task-id"] = config["task_id"]
        return md

    def _wrap_fastpath(
        self, server_url: str, tcp_stub: ModalTPUStub, uds_path: str = "", blob_local_dir: str = ""
    ) -> Any:
        """The TCP stub on the local fast-path ladder when a local rung is
        usable (`local_transport.wrap_stub`); the socket's channel joins
        this client's cache."""
        from ._utils import local_transport

        return local_transport.wrap_stub(
            server_url,
            tcp_stub,
            uds_path,
            blob_local_dir,
            channels=self._channel_cache,
            metadata=self._metadata(),
        )

    async def _open(self) -> None:
        self._channel = create_channel(self.server_url, metadata=self._metadata())
        # a container learns its local coordinates from the worker's env (it
        # never calls hello()); other clients upgrade at hello()
        self._stub_tcp = ModalTPUStub(self._channel)
        self._stub = self._wrap_fastpath(
            self.server_url,
            self._stub_tcp,
            uds_path=os.environ.get("MODAL_TPU_SERVER_UDS", ""),
            blob_local_dir=os.environ.get("MODAL_TPU_BLOB_LOCAL_DIR", ""),
        )

    async def _close(self) -> None:
        self._closed = True
        for channel in [self._channel, *self._channel_cache.values()]:
            if channel is not None:
                await channel.close()
        self._channel = None
        self._stub = None
        self._channel_cache.clear()
        self._stub_cache.clear()

    @property
    def stub(self) -> ModalTPUStub:
        if self._stub is None:
            raise ClientClosed("client is not connected")
        return self._stub

    async def get_stub(self, server_url: str) -> ModalTPUStub:
        """Stub for an alternate server URL (input plane, a shard, worker
        data plane), cached per URL (reference client.py:135); in process
        when the URL is a plane of this process, over its socket when
        ClientHello named one."""
        if server_url not in self._stub_cache:
            channel = create_channel(server_url, metadata=self._metadata())
            self._channel_cache[server_url] = channel
            self._stub_cache[server_url] = self._wrap_fastpath(
                server_url, ModalTPUStub(channel), uds_path=self._uds_by_url.get(server_url, "")
            )
        return self._stub_cache[server_url]

    async def get_input_plane_metadata(self) -> list[tuple[str, str]]:
        """Per-call metadata for input-plane RPCs: the refreshing JWT
        (reference client.py:301 get_input_plane_metadata)."""
        if self._auth_token_manager is None:
            from ._utils.auth_token_manager import AuthTokenManager

            self._auth_token_manager = AuthTokenManager(self.stub)
        token = await self._auth_token_manager.get_token()
        return [("x-modal-tpu-auth-token", token)]

    async def hello(self) -> None:
        """Learn the server's capabilities: the input plane's URL and socket,
        the local coordinates that re-point the stub at the fast-path ladder
        when this process can stat them, and a sharded plane's shard map."""
        resp = await retry_transient_errors(
            self.stub.ClientHello,
            api_pb2.ClientHelloRequest(client_version=CLIENT_VERSION, client_type=self.client_type),
        )
        if resp.warning:
            logger.warning(resp.warning)
        self.image_builder_version = resp.image_builder_version or None
        self.input_plane_url = resp.input_plane_url or None
        if resp.input_plane_url and resp.input_plane_uds_path:
            self._uds_by_url[resp.input_plane_url] = resp.input_plane_uds_path
        if self._stub_tcp is not None and (resp.uds_path or resp.blob_local_dir):
            self._stub = self._wrap_fastpath(
                self.server_url, self._stub_tcp, uds_path=resp.uds_path, blob_local_dir=resp.blob_local_dir
            )
        # a shard map with more than one owner: unary RPCs dial their owning
        # shard, and the director leaves the data path
        if resp.shard_map_json:
            import json

            from ._utils.shard_router import ShardRouterStub

            shard_map = json.loads(resp.shard_map_json)
            if isinstance(self._stub, ShardRouterStub):
                self._stub.update_map(shard_map)
            elif len(shard_map.get("urls") or []) > 1:
                self._stub = ShardRouterStub(self, self._stub, shard_map)

    async def __aenter__(self) -> "_Client":
        await self._open()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self._close()

    _local_supervisor: ClassVar[Optional[Any]] = None

    @classmethod
    async def _maybe_boot_local_server(cls, server_url: str) -> str:
        """Zero-config local mode: when the configured server is the default
        localhost URL and nothing listens there, boot an in-process
        LocalSupervisor (control plane + worker + blob server) on that port
        and use it. Containers (task_id set) never boot one, and an
        explicitly configured URL is returned as it is: a refused
        connection there surfaces on the first RPC."""
        if cls._local_supervisor is not None:
            return cls._local_supervisor.server_url
        if config["task_id"] or not config["auto_local_server"]:
            return server_url
        if server_url != _SETTINGS["server_url"].default:
            return server_url
        host, port_s = server_url.removeprefix("grpc://").rsplit(":", 1)
        try:
            # one 250 ms-bounded probe, before any RPC traffic exists on this loop
            probe = socket.create_connection((host, int(port_s)), timeout=0.25)  # lint: disable=blocking-in-async
            probe.close()
            return server_url  # a real server is listening
        except OSError:
            pass
        from .server.supervisor import LocalSupervisor

        # MODAL_TPU_SHARDS > 1 boots the sharded plane (server/shards.py)
        try:
            num_shards = int(os.environ.get("MODAL_TPU_SHARDS", "1") or 1)
        except ValueError:
            num_shards = 1
        if num_shards > 1:
            from .server.shards import ShardedSupervisor

            sup: Any = ShardedSupervisor(num_shards=num_shards, num_workers=1, port=int(port_s))
        else:
            sup = LocalSupervisor(num_workers=1, port=int(port_s))
        try:
            await sup.start()
        except Exception as exc:  # noqa: BLE001 — e.g. lost a port race
            logger.debug(f"local supervisor auto-boot failed: {exc}")
            await sup.stop()  # release what did bind (the port)
            return server_url
        cls._local_supervisor = sup
        loop = asyncio.get_running_loop()

        def _shutdown() -> None:
            if not loop.is_closed() and loop.is_running():
                asyncio.run_coroutine_threadsafe(sup.stop(), loop).result(timeout=30.0)

        atexit.register(_shutdown)
        logger.info(f"auto-booted local supervisor at {sup.server_url}")
        return sup.server_url

    @classmethod
    async def from_env(cls) -> "_Client":
        """Singleton client from config/env; re-created on fork (reference
        client.py:207,347)."""
        if cls._client_from_env is not None and cls._client_from_env._owner_pid != os.getpid():
            cls._client_from_env = None
            cls._client_from_env_lock = None
        if cls._client_from_env_lock is None:
            cls._client_from_env_lock = asyncio.Lock()
        # single-flight by design: concurrent from_env callers must wait for
        # ONE handshake instead of racing dials
        async with cls._client_from_env_lock:  # lint: disable=lock-across-await
            if cls._client_from_env is None or cls._client_from_env._closed:
                server_url = await cls._maybe_boot_local_server(config["server_url"])
                token_id = config["token_id"]
                token_secret = config["token_secret"]
                credentials = (token_id, token_secret) if token_id else None
                client_type = (
                    api_pb2.CLIENT_TYPE_CONTAINER if config["task_id"] else api_pb2.CLIENT_TYPE_CLIENT
                )
                client = cls(server_url, client_type, credentials)
                await client._open()
                try:
                    # learn server capabilities (input_plane_url, builder
                    # version); a failure here surfaces on the first real
                    # RPC anyway, so it does not block client creation
                    await client.hello()
                except Exception as exc:  # noqa: BLE001
                    logger.debug(f"client hello failed: {exc}")
                cls._client_from_env = client
            return cls._client_from_env

    @classmethod
    async def from_credentials(cls, token_id: str, token_secret: str) -> "_Client":
        client = cls(config["server_url"], api_pb2.CLIENT_TYPE_CLIENT, (token_id, token_secret))
        await client._open()
        return client

    @classmethod
    async def anonymous(cls, server_url: str) -> "_Client":
        client = cls(server_url, api_pb2.CLIENT_TYPE_CLIENT, None)
        await client._open()
        return client

    @classmethod
    def set_env_client(cls, client: Optional["_Client"]) -> None:
        cls._client_from_env = client

    @classmethod
    async def verify(cls, server_url: str, credentials: tuple[str, str]) -> None:
        async with cls(server_url, api_pb2.CLIENT_TYPE_CLIENT, credentials) as client:
            await client.hello()


Client = synchronize_api(_Client)
