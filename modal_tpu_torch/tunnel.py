"""In-container port forwarding: `with modal_tpu_torch.forward(port) as
tunnel:` (port of modal_tpu/tunnel.py).

Reference: py/modal/_tunnel.py: a running container exposes one of its
ports at an address a client reaches. The control plane serves the forward
as a TCP proxy on its host (TunnelStart/TunnelStop); a production
deployment fronts the same contract with TLS and a public hostname.
"""

from __future__ import annotations

from dataclasses import dataclass

from ._utils.async_utils import synchronize_api
from ._utils.grpc_utils import retry_transient_errors
from .client import _Client
from .config import config
from .exception import InvalidError
from .proto import api_pb2


@dataclass(frozen=True)
class Tunnel:
    """A client-reachable forward of a port (reference _tunnel.py Tunnel):
    connect to (host, port) to reach a container's or a sandbox's port."""

    host: str
    port: int
    unencrypted: bool = False

    @property
    def url(self) -> str:
        scheme = "http" if self.unencrypted else "https"
        return f"{scheme}://{self.host}:{self.port}"

    @property
    def tcp_socket(self) -> tuple[str, int]:
        return (self.host, self.port)


class _forward:
    """Async context manager forwarding `port` of THIS container."""

    def __init__(self, port: int, unencrypted: bool = False):
        if not (0 < port < 65536):
            raise InvalidError(f"invalid port {port}")
        self.port = port
        self.unencrypted = unencrypted
        self._task_id = config["task_id"]
        self._client: _Client | None = None

    async def __aenter__(self) -> Tunnel:
        if not self._task_id:
            raise InvalidError("modal_tpu_torch.forward() only works inside a running container")
        self._client = await _Client.from_env()
        resp = await retry_transient_errors(
            self._client.stub.TunnelStart,
            api_pb2.TunnelStartRequest(
                task_id=self._task_id, port=self.port, unencrypted=self.unencrypted
            ),
        )
        return Tunnel(host=resp.host, port=resp.port, unencrypted=self.unencrypted)

    async def __aexit__(self, *exc) -> None:
        if self._client is not None:
            try:
                await retry_transient_errors(
                    self._client.stub.TunnelStop,
                    api_pb2.TunnelStopRequest(task_id=self._task_id, port=self.port),
                    max_retries=1,
                )
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass


forward = synchronize_api(_forward)
