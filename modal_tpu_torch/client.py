"""The client: owns the channel + stub to the control plane (port of
modal_tpu/client.py).

Reference: py/modal/client.py `_Client` (client.py:77): `from_env`
(client.py:207), `from_credentials` (client.py:256), per-URL stub cache
(client.py:135), fork-safety PID reset (client.py:347). The stub is the
registry-derived `ModalTPUStub` over the port's messages, so this client
talks to any server of the wire contract, the JAX package's included.

Three parts of the JAX client rest on modules the port does not have yet.
Each degrades the way the JAX client does when that module is off:

- the local fast-path ladder (in-process, then Unix socket, then TCP):
  every stub stays on TCP, as in the JAX client with the fast path off;
- the shard router: a sharded control plane's director is used for every
  call, as the JAX client does with a one-owner shard map;
- the auto-booted local supervisor: where the JAX client would boot one
  (the default URL, nothing listening, `auto_local_server` on, not in a
  container), this client raises `ConnectionError`.
"""

from __future__ import annotations

import asyncio
import os
import socket
from typing import Any, ClassVar, Optional

import grpc

from ._utils.async_utils import synchronize_api
from ._utils.grpc_utils import create_channel, retry_transient_errors
from .config import _SETTINGS, config, logger
from .exception import ClientClosed, ConnectionError
from .proto import api_pb2
from .proto.rpc import ModalTPUStub

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
        self._auth_token_manager: Optional[Any] = None

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

    async def _open(self) -> None:
        self._channel = create_channel(self.server_url, metadata=self._metadata())
        self._stub = ModalTPUStub(self._channel)

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
        """Stub for an alternate server URL (input plane, worker data plane),
        cached per URL (reference client.py:135)."""
        if server_url not in self._stub_cache:
            channel = create_channel(server_url, metadata=self._metadata())
            self._channel_cache[server_url] = channel
            self._stub_cache[server_url] = ModalTPUStub(channel)
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
        """Learn the server's capabilities. The local coordinates it
        advertises (uds_path, blob_local_dir) and a shard map are read by
        the fast path and the shard router, which the port has not taken
        yet: the stub stays on TCP to this URL."""
        resp = await retry_transient_errors(
            self.stub.ClientHello,
            api_pb2.ClientHelloRequest(client_version=CLIENT_VERSION, client_type=self.client_type),
        )
        if resp.warning:
            logger.warning(resp.warning)
        self.image_builder_version = resp.image_builder_version or None
        self.input_plane_url = resp.input_plane_url or None

    async def __aenter__(self) -> "_Client":
        await self._open()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self._close()

    @classmethod
    def _check_local_server(cls, server_url: str) -> str:
        """Where the JAX client boots an in-process LocalSupervisor (the
        default localhost URL, nothing listening, `auto_local_server` on,
        not in a container), raise ConnectionError: the port has no
        supervisor of its own yet. Any other URL is returned as it is, and
        a refused connection there surfaces on the first RPC, as in the JAX
        client."""
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
        raise ConnectionError(
            f"no control plane listening at {server_url}, and modal_tpu_torch has no local supervisor to boot "
            "in its place: start one and set MODAL_TPU_SERVER_URL, or set MODAL_TPU_AUTO_LOCAL_SERVER=0"
        )

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
                server_url = cls._check_local_server(config["server_url"])
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
