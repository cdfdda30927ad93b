"""LocalSupervisor: control plane, blob server and workers in one process
(port of modal_tpu/server/supervisor.py).

An asyncio gRPC server with the function path's servicer, the HTTP blob
store, the scheduler, and N in-process worker agents that spawn container
subprocesses. `python -m modal_tpu_torch.server` serves one standalone.

The control plane keeps its state in memory, as the JAX supervisor does
with `MODAL_TPU_JOURNAL=0`. The journal and its recovery come with ROADMAP
Queue A 4b': until then an explicit `MODAL_TPU_JOURNAL=1` is refused.
Replication and shards, the input plane and chaos (4e), and the SLO,
time-series and profiler loops (4d) wait too.
"""

from __future__ import annotations

import asyncio
import os
from typing import Optional

import grpc

from ..config import config, logger, tune_switch_interval
from ..observability import tracing
from ..proto.rpc import build_generic_handler
from .blob_server import BlobServer
from .scheduler import Scheduler
from .services import ModalTPUServicer
from .state import ServerState
from .worker import WorkerAgent


def _check_journal_setting() -> None:
    """Unset (or off) means in memory; an explicit request for the journal
    is refused rather than silently ignored."""
    value = os.environ.get("MODAL_TPU_JOURNAL", "")
    if value and value.lower() not in ("0", "false", "no"):
        raise NotImplementedError(
            f"MODAL_TPU_JOURNAL={value}: the port's control plane keeps its state in memory; the journal "
            "and its recovery come with ROADMAP Queue A 4b'"
        )


class LocalSupervisor:
    def __init__(
        self,
        num_workers: int = 1,
        port: int = 0,
        state_dir: Optional[str] = None,
        worker_gpus: Optional[int] = None,
        worker_gpu_type: Optional[str] = None,
    ):
        _check_journal_setting()
        self.num_workers = num_workers
        self.port = port
        self.state_dir = state_dir or config["state_dir"]
        # test override of the probed inventory: worker_gpu_type="local-sim"
        # simulates worker_gpus cards that no container sees
        self.worker_gpus = worker_gpus
        self.worker_gpu_type = worker_gpu_type
        self.state = ServerState(self.state_dir)
        self.servicer = ModalTPUServicer(self.state)
        self.scheduler = Scheduler(self.state, self.servicer)
        self.servicer.scheduler = self.scheduler
        self.blob_server = BlobServer(self.state)
        self.workers: list[WorkerAgent] = []
        self._grpc_server: Optional[grpc.aio.Server] = None

    @property
    def server_url(self) -> str:
        return f"grpc://127.0.0.1:{self.port}"

    async def start(self) -> None:
        os.makedirs(self.state_dir, exist_ok=True)
        tune_switch_interval()
        # span sink under the state dir, exported to containers by the
        # workers (MODAL_TPU_TRACE_DIR)
        tracing.configure(os.path.join(self.state_dir, "traces"))
        self._grpc_server = grpc.aio.server(
            options=[
                ("grpc.max_receive_message_length", 128 * 1024 * 1024),
                ("grpc.max_send_message_length", 128 * 1024 * 1024),
            ]
        )
        self._grpc_server.add_generic_rpc_handlers((build_generic_handler(self.servicer),))
        self.port = self._grpc_server.add_insecure_port(f"127.0.0.1:{self.port}")
        await self._grpc_server.start()
        await self.blob_server.start()
        self.scheduler.start()
        for _ in range(self.num_workers):
            worker = WorkerAgent(
                self.server_url,
                num_gpus=self.worker_gpus,
                gpu_type=self.worker_gpu_type,
                state_dir=self.state_dir,
                # the blob plane serves /compile/<key>: its base url is the
                # fleet cache's url; co-located containers read the store
                compile_cache_url=self.state.blob_url_base,
                compile_cache_dir=self.state.compile_cache.root_dir,
            )
            await worker.start()
            self.workers.append(worker)
        logger.debug(f"local supervisor up at {self.server_url} ({self.num_workers} workers)")

    async def preempt_worker(self, index: int = 0, grace_s: float = 10.0) -> None:
        """A preemption notice for one worker: drain, graceful container
        stop with the resume-token flush, input requeue."""
        await self.workers[index].preempt(grace_s)

    async def stop(self) -> None:
        for worker in self.workers:
            await worker.stop()
        await self.scheduler.stop()
        await self.blob_server.stop()
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=0.5)


async def serve_forever(port: int = 9900, num_workers: int = 1, state_dir: Optional[str] = None) -> None:
    sup = LocalSupervisor(num_workers=num_workers, port=port, state_dir=state_dir)
    await sup.start()
    print(f"modal_tpu_torch control plane listening on {sup.server_url}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await sup.stop()
