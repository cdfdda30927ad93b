"""LocalSupervisor: control plane, blob server and workers in one process
(port of modal_tpu/server/supervisor.py).

An asyncio gRPC server with the function path's servicer, the HTTP blob
store, the scheduler, and N in-process worker agents that spawn container
subprocesses. `python -m modal_tpu_torch.server` serves one standalone.

The plane is durable: its state is journaled (server/journal.py) unless
`MODAL_TPU_JOURNAL` is 0/false/no, and a plane that starts on a state dir
holding a journal replays it before its first RPC (`recover=None`;
`recover=False` archives the old journal instead). `crash_restart` drops
the plane with no drain and rebuilds it from the journal on the same ports
and socket. Beside its TCP port the plane binds a Unix socket in the state
dir and registers its servicer for the in-process rung of the local fast
path (_utils/local_transport.py).

Once the scheduler runs, a sampler task samples the process registry into
the time-series store on cadence (observability/timeseries.py,
`MODAL_TPU_TS_INTERVAL`; 0 turns it off) and evaluates the SLO burn-rate
rules on the same tick (observability/slo.py). Both are built against each
new state, so after a crash_restart the evaluator adopts the alerts the
journal replay rebuilt. `MODAL_TPU_PROFILE` starts the sampling profiler
at boot (observability/profiler.py), and the span store is pruned before
this run's sink opens (`tracing.gc_trace_dir`).

Replication and shards, the input plane, chaos and the flight recorder
(ROADMAP Queue A 4e) wait for their sub-slice.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from typing import Optional

import grpc

from .._utils import local_transport
from ..config import config, logger, tune_switch_interval
from ..observability import tracing
from ..proto.rpc import build_generic_handler
from .blob_server import BlobServer
from .journal import IdempotencyCache, Journal, archive_existing, recover_state
from .scheduler import Scheduler
from .services import ModalTPUServicer
from .state import ServerState
from .worker import WorkerAgent


def _journal_enabled() -> bool:
    return os.environ.get("MODAL_TPU_JOURNAL", "1") not in ("0", "false", "no")


class LocalSupervisor:
    def __init__(
        self,
        num_workers: int = 1,
        port: int = 0,
        state_dir: Optional[str] = None,
        worker_gpus: Optional[int] = None,
        worker_gpu_type: Optional[str] = None,
        recover: Optional[bool] = None,  # None: recover when a journal exists
    ):
        self.num_workers = num_workers
        self.port = port
        self.state_dir = state_dir or config["state_dir"]
        # test override of the probed inventory: worker_gpu_type="local-sim"
        # simulates worker_gpus cards that no container sees
        self.worker_gpus = worker_gpus
        self.worker_gpu_type = worker_gpu_type
        self.recover = recover
        self.recovery_report: Optional[dict] = None  # set when start() replayed a journal
        self.state = ServerState(self.state_dir)
        self.servicer = ModalTPUServicer(self.state)
        self.scheduler = Scheduler(self.state, self.servicer)
        self.servicer.scheduler = self.scheduler
        self.blob_server = BlobServer(self.state)
        self.workers: list[WorkerAgent] = []
        self.uds_path = ""  # the plane's Unix socket (set at bind time)
        self._grpc_server: Optional[grpc.aio.Server] = None
        # two crash_restarts must not interleave their teardown and rebuild
        self._crash_lock = asyncio.Lock()
        self._sampler_task: Optional[asyncio.Task] = None

    @property
    def server_url(self) -> str:
        return f"grpc://127.0.0.1:{self.port}"

    def _attach_journal(self) -> None:
        """Open the journal and, when the state dir holds one, replay it into
        this ServerState before any RPC is served: open calls resume,
        orphaned claims requeue, journaled workers await re-adoption. A
        journal that cannot open its directory raises: the plane never
        carries on in memory in its place."""
        if not _journal_enabled():
            return
        if self.recover is False:
            # declined: archive the old records, or the next boot's
            # auto-recovery would merge the abandoned state with this run's
            archive_existing(self.state_dir)
        journal = Journal(self.state_dir)
        # the input-plane JWT secret survives the restart, or every token
        # already handed out turns UNAUTHENTICATED
        secret_path = os.path.join(journal.dir, "auth.secret")
        try:
            if os.path.exists(secret_path):
                with open(secret_path, "rb") as f:
                    self.state.auth_secret = f.read()
            else:
                with open(secret_path, "wb") as f:
                    f.write(self.state.auth_secret)
                os.chmod(secret_path, 0o600)
        except OSError as exc:
            logger.warning(f"auth secret persistence failed: {exc}")
        should_recover = self.recover if self.recover is not None else journal.has_records()
        if should_recover and journal.has_records():
            self.state.idempotency = IdempotencyCache(journal=None)  # filled by the replay
            self.recovery_report = recover_state(self.state, journal)
        # wired after the replay: replaying must not re-append its records
        self.state.journal = journal
        if self.state.idempotency is None:
            self.state.idempotency = IdempotencyCache(journal=journal)
        else:
            self.state.idempotency.journal = journal
        # port continuity: clients that outlive a restart hold the old URLs
        # (the plane's, and the blob URLs of BlobCreate and BlobGet); binding
        # the same ports lands their retries on the recovered plane. A port
        # the caller asked for wins; a saved one that is taken falls back to
        # a fresh one (_start_control_plane).
        try:
            with open(os.path.join(journal.dir, "ports.json")) as f:
                saved = json.load(f)
            self.port = self.port or int(saved.get("grpc", 0))
            self.blob_server.port = self.blob_server.port or int(saved.get("blob", 0))
        except (OSError, ValueError):
            pass

    def _save_ports(self) -> None:
        """Record the bound ports for the next (post-crash) boot."""
        if self.state.journal is None:
            return
        try:
            with open(os.path.join(self.state.journal.dir, "ports.json"), "w") as f:
                json.dump({"grpc": self.port, "blob": self.blob_server.port}, f)
        except OSError:
            pass

    async def start(self) -> None:
        os.makedirs(self.state_dir, exist_ok=True)
        tune_switch_interval()
        # span sink under the state dir, exported to containers by the
        # workers (MODAL_TPU_TRACE_DIR); dead runs' span files are pruned
        # (size and age bounds) before this run's sink opens
        trace_dir = os.path.join(self.state_dir, "traces")
        tracing.gc_trace_dir(trace_dir)
        tracing.configure(trace_dir)
        # MODAL_TPU_PROFILE starts the plane's sampling profiler at boot;
        # ProfileControl toggles it (and every container's) at run time
        from ..observability import profiler as obs_profiler

        obs_profiler.maybe_start_from_env(
            os.path.join(self.state_dir, "observability", "profiles"), tag="supervisor"
        )
        # journal and recovery before the gRPC server binds: the first
        # client retry after a restart sees the replayed state, and the
        # dedupe wrapper takes state.idempotency at handler-build time
        self._attach_journal()
        await self._start_control_plane(self.port)
        for _ in range(self.num_workers):
            worker = WorkerAgent(
                self.server_url,
                num_gpus=self.worker_gpus,
                gpu_type=self.worker_gpu_type,
                state_dir=self.state_dir,
                # in-process workers are co-located: they use the fast-path
                # coordinates and hand them to their containers
                server_uds=self.uds_path,
                blob_local_dir=self.state.blob_dir,
                # the blob plane serves /compile/<key>: its base url is the
                # fleet cache's url; co-located containers read the store
                compile_cache_url=self.state.blob_url_base,
                compile_cache_dir=self.state.compile_cache.root_dir,
            )
            await worker.start()
            self.workers.append(worker)
        logger.debug(f"local supervisor up at {self.server_url} ({self.num_workers} workers)")

    async def _start_control_plane(self, grpc_port: int) -> None:
        """Bind and start the gRPC server, the blob server and the scheduler:
        one code path for a fresh boot and the post-crash rebuild."""
        self._grpc_server = grpc.aio.server(
            options=[
                ("grpc.max_receive_message_length", 128 * 1024 * 1024),
                ("grpc.max_send_message_length", 128 * 1024 * 1024),
                # a port still held by another server must fail to bind (and
                # fall back below), not be shared with it
                ("grpc.so_reuseport", 0),
            ]
        )
        self._grpc_server.add_generic_rpc_handlers((build_generic_handler(self.servicer),))
        try:
            self.port = self._grpc_server.add_insecure_port(f"127.0.0.1:{grpc_port}")
        except RuntimeError:
            if not grpc_port:
                raise
            logger.warning(f"port {grpc_port} of the last run is taken; binding a fresh one")
            self.port = self._grpc_server.add_insecure_port("127.0.0.1:0")
        # the local fast path: a Unix socket beside the TCP port for
        # co-located peers in other processes (the containers), advertised
        # at ClientHello; it lives in the state dir, so it is the same path
        # after a crash_restart
        self.uds_path = ""
        uds = os.path.join(self.state_dir, "control.sock")
        if local_transport.uds_enabled() and local_transport.usable_uds_path(uds):
            try:
                os.unlink(uds)
            except FileNotFoundError:
                pass
            try:
                self._grpc_server.add_insecure_port(f"unix:{uds}")
                self.uds_path = uds
            except Exception as exc:  # noqa: BLE001 — the socket is an optimization
                logger.warning(f"control-plane UDS bind failed ({exc}); TCP only")
        self.state.uds_path = self.uds_path
        self.state.blob_local_dir = self.state.blob_dir
        await self._grpc_server.start()
        try:
            await self.blob_server.start()
        except OSError:
            if not self.blob_server.port:
                raise
            logger.warning(f"blob port {self.blob_server.port} of the last run is taken; binding a fresh one")
            await self.blob_server.stop()
            self.blob_server.port = 0
            await self.blob_server.start()
        # the in-process rung: registered once the servers are live, so a
        # resolvable entry always means a serving plane
        local_transport.register_local_server(self.server_url, self.servicer)
        self._save_ports()
        self.scheduler.start()
        # built here (not in start()) so a crash_restart builds the store
        # and the evaluator against the new state: the evaluator adopts
        # state.alerts, which the replay just refilled
        self._start_sampler()

    def _start_sampler(self) -> None:
        """Start the sampler task (MODAL_TPU_TS_INTERVAL not 0), building
        this state's time-series store and SLO evaluator on first use; a
        sampler stopped with `_stop_sampler` resumes on the same store."""
        from ..observability import timeseries as ts
        from ..observability.slo import SLOEvaluator

        if not ts.sampling_enabled() or self._sampler_task is not None:
            return
        if self.state.timeseries is None:
            self.state.timeseries = ts.TimeSeriesStore()
            self.state.slo = SLOEvaluator(self.state.timeseries, alerts=self.state.alerts, journal=self.state.journal)
        self._sampler_task = asyncio.create_task(self._sampler_loop(), name="ts-sampler")

    async def _sampler_loop(self) -> None:
        """Sample the registry into the store and evaluate the SLO rules,
        forever; one loop owns both so alert windows and history agree."""
        from ..observability.catalog import (
            TIMESERIES_POINTS,
            TIMESERIES_SAMPLE_SECONDS,
            TIMESERIES_SAMPLES,
        )

        store, evaluator = self.state.timeseries, self.state.slo
        while True:
            try:
                t0 = time.perf_counter()
                store.sample()
                TIMESERIES_SAMPLES.inc()
                TIMESERIES_SAMPLE_SECONDS.observe(time.perf_counter() - t0)
                for tier, n in store.point_counts().items():
                    TIMESERIES_POINTS.set(float(n), tier=tier)
                evaluator.evaluate()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("time-series sampler iteration failed")
            await asyncio.sleep(store.interval_s)

    async def _stop_sampler(self) -> None:
        if self._sampler_task is not None:
            self._sampler_task.cancel()
            try:
                await self._sampler_task
            except asyncio.CancelledError:
                pass
            self._sampler_task = None

    async def preempt_worker(self, index: int = 0, grace_s: float = 10.0) -> None:
        """A preemption notice for one worker: drain, graceful container
        stop with the resume-token flush, input requeue."""
        await self.workers[index].preempt(grace_s)

    async def crash_restart(self) -> Optional[dict]:
        """A crash of the control plane and its recovery from the journal, in
        one process. The old ServerState is abandoned (nothing is drained or
        flushed beyond what the journal holds), then a fresh state is rebuilt
        by replay and served on the same ports and socket. The worker agents
        keep running: their next heartbeat re-adopts the recovered record."""
        if not _journal_enabled():
            logger.warning("crash_restart ignored: journaling is off")
            return None
        async with self._crash_lock:  # lint: disable=lock-across-await
            return await self._crash_restart_locked()

    async def crash_abandon(self) -> tuple[int, int]:
        """The teardown half of a crash: kill the container subprocesses and
        drop every serving surface with no drain and no state flush. The
        journal is closed and its segments stay on disk for the rebuild.
        Returns the (grpc, blob) ports for a same-port rebuild."""
        ports = (self.port, self.blob_server.port)
        # the workers are in process: a real crash of this process takes
        # their containers with it; the agents outlive it and re-adopt
        for worker in self.workers:
            worker.kill_containers()
        # the in-process rung dies with the plane (a stale registration would
        # serve the abandoned state) and registers again on the rebuild
        local_transport.unregister_local_server(self.server_url)
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=None)
            self._grpc_server = None
        await self.scheduler.stop()
        await self._stop_sampler()  # it holds the abandoned state
        await self.blob_server.stop()
        if self.state.journal is not None:
            self.state.journal.close()
        return ports

    async def _crash_restart_locked(self) -> Optional[dict]:
        t0 = time.time()
        grpc_port, blob_port = await self.crash_abandon()
        self.state = ServerState(self.state_dir)
        self.servicer = ModalTPUServicer(self.state)
        self.scheduler = Scheduler(self.state, self.servicer)
        self.servicer.scheduler = self.scheduler
        self.blob_server = BlobServer(self.state, port=blob_port)
        self.recover = True
        self._attach_journal()
        await self._start_control_plane(grpc_port)
        tracing.record_span("recovery.crash_restart", start=t0, end=time.time(),
                            attrs={k: v for k, v in (self.recovery_report or {}).items() if k != "skipped_by_type"})
        logger.warning(f"control plane crash-restarted in {time.time() - t0:.2f}s: {self.recovery_report}")
        return self.recovery_report

    async def stop(self) -> None:
        local_transport.unregister_local_server(self.server_url)
        if self.uds_path:
            try:
                os.unlink(self.uds_path)
            except OSError:
                pass
        for worker in self.workers:
            await worker.stop()
        await self.scheduler.stop()
        await self._stop_sampler()
        await self.blob_server.stop()
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=0.5)
        if self.state.journal is not None:
            self.state.journal.close()


async def serve_forever(port: int = 9900, num_workers: int = 1, state_dir: Optional[str] = None) -> None:
    sup = LocalSupervisor(num_workers=num_workers, port=port, state_dir=state_dir)
    await sup.start()
    print(f"modal_tpu_torch control plane listening on {sup.server_url}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await sup.stop()
