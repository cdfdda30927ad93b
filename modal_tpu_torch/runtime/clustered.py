"""A gang member's set-up inside its container (port of
modal_tpu/runtime/clustered.py).

Reference: py/modal/_clustered_functions.py — `ClusterInfo` (:12),
`_initialize_clustered_function` (:41): the container's own address,
TaskClusterHello → rank and peers, then the collective library's set-up.

The rendezvous answers this rank, the world size and the coordinator (rank
0's host and a port the plane chose for the gang). Where the JAX package
calls `jax.distributed.initialize`, the port joins a `torch.distributed`
process group there (`parallel.mesh.init_process_group`, the TCP store on
the coordinator): NCCL when the gang's containers hold cards, gloo when they
hold none. `MODAL_TPU_SKIP_TORCH_DISTRIBUTED=1` skips the group and keeps
the rendezvous. `get_cluster_info()` gives rank and peers as the reference's
does; `get_fabric_peers()` the peers on this rank's host fabric (NVLink),
which the plane does not report yet: every peer.

Importing this module loads no torch; `init_cluster` imports it after the
container's hello.
"""

from __future__ import annotations

import asyncio
import os
import socket
from dataclasses import dataclass, field
from typing import Optional

from .._utils.grpc_utils import retry_transient_errors
from ..client import _Client
from ..config import logger
from ..proto import api_pb2

SKIP_DISTRIBUTED_ENV = "MODAL_TPU_SKIP_TORCH_DISTRIBUTED"


@dataclass
class ClusterInfo:
    rank: int = 0
    world_size: int = 1
    container_ips: list[str] = field(default_factory=list)
    coordinator_address: str = ""
    cluster_id: str = ""
    # the process group's backend ("nccl" or "gloo"), "" when none was made
    backend: str = ""


_cluster_info: Optional[ClusterInfo] = None


def get_cluster_info() -> ClusterInfo:
    """Rank and peers of this container (reference get_cluster_info); a
    container outside a gang is rank 0 of 1."""
    return _cluster_info if _cluster_info is not None else ClusterInfo()


def get_fabric_peers() -> list[str]:
    """The peers sharing this rank's fabric (reference
    _clustered_functions.py:33, NVLink peers). The plane reports no fabric
    yet, so every peer is one."""
    return list(get_cluster_info().container_ips)


def _own_address() -> str:
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def _holds_cards(container_args: api_pb2.ContainerArguments) -> bool:
    """Did the plane give this container cards? A function that asks for
    none, or a simulated card (`CUDA_VISIBLE_DEVICES` empty), holds none."""
    asked = bool(container_args.function_def.resources.gpu_config.gpu_type)
    return asked and os.environ.get("CUDA_VISIBLE_DEVICES", "") != ""


async def init_cluster(container_args: api_pb2.ContainerArguments, client: _Client) -> ClusterInfo:
    """Rendezvous, then join the gang's process group, before user code
    runs. Awaited on the entrypoint's loop (the client's channel lives
    there); the group's set-up, which blocks until every rank has joined,
    runs in a thread so the heartbeat goes on."""
    global _cluster_info

    resp = await retry_transient_errors(
        client.stub.TaskClusterHello,
        api_pb2.TaskClusterHelloRequest(task_id=container_args.task_id, container_address=_own_address()),
        attempt_timeout=150.0,
        max_retries=2,
    )
    info = ClusterInfo(
        rank=resp.rank,
        world_size=resp.world_size,
        container_ips=list(resp.peer_addresses),
        coordinator_address=resp.coordinator_address,
        cluster_id=resp.cluster_id,
    )
    _cluster_info = info
    logger.info(f"cluster rendezvous complete: rank={info.rank}/{info.world_size} "
                f"coordinator={info.coordinator_address}")
    if info.world_size > 1 and os.environ.get(SKIP_DISTRIBUTED_ENV) != "1":
        device = "cuda" if _holds_cards(container_args) else "cpu"
        info.backend = await asyncio.to_thread(_join_group, device, info)
        logger.info(f"torch.distributed initialized: rank {info.rank}/{info.world_size} over {info.backend}")
    return info


def _join_group(device: str, info: ClusterInfo) -> str:
    import torch.distributed as dist

    from ..parallel.mesh import init_process_group

    init_process_group(device, world_size=info.world_size, rank=info.rank,
                       init_method=f"tcp://{info.coordinator_address}")
    return dist.get_backend()


def shutdown_cluster() -> None:
    """Leave the gang's process group, if this container joined one (at
    exit, after the user's exit hooks)."""
    if _cluster_info is None or not _cluster_info.backend:
        return
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
