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

Chaos (chaos.py): a ChaosPolicy, given or from the environment
(`MODAL_TPU_CHAOS=1`), wraps the servicer at the handler boundary, guards
the blob routes, resets output streams, kills warm interpreters
mid-handoff, and fires its scheduled events from `_chaos_event_loop`
(`supervisor_crash` runs `crash_restart`; `worker_preempt`, `worker_kill`,
`heartbeat_blackhole`; a sharded plane's director fires `shard_kill`,
`shard_partition` and `director_blackhole`, server/shards.py). The flight
recorder
(observability/flight_recorder.py, on unless `MODAL_TPU_FLIGHT_RECORDER=0`)
keeps the last minute of samples, spans, journal records and chaos events
and dumps it as `<state_dir>/observability/postmortem-<event>-<t>.json` on
a crash_restart (before the teardown) and when an SLO alert fires.

The input plane (server/input_plane.py) runs beside the control plane on
its own port and Unix socket; the port survives a crash_restart
(`ports.json`). As one shard of a sharded plane (server/shards.py) a
supervisor mints ids in its partition (`shard_index`), shares the fleet's
blob store (`blob_dir`) and replicates its journal to its siblings
(server/replication.py; peers from `replication_peers`, or from
`<fleet_root>/shards.json` for a subprocess shard). A takeover adopts a dead
sibling's partition (`adopt_partition` from its journal,
`adopt_from_replica` from this shard's replica stream), and `fence` stops a
shard that a takeover replaced; the flight recorder dumps a `fence` and a
`takeover` postmortem, and a `fence_rejections` one when stale appends of
an undead writer storm this shard's replica store.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from typing import Any, Optional

import grpc

from .._utils import local_transport
from ..chaos import ChaosPolicy, ChaosServicerProxy
from ..config import config, logger, tune_switch_interval
from ..observability import tracing
from ..proto.rpc import build_generic_handler
from .blob_server import BlobServer
from .input_plane import InputPlaneServer
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
        chaos: Optional[ChaosPolicy] = None,  # one policy object, every layer
        shard_index: int = 0,  # the partition of minted ids (server/shards.py)
        blob_dir: Optional[str] = None,  # the fleet's shared blob store
        # a shard's fleet (server/shards.py): `fleet_root` is the fleet's
        # state dir (None on a monolith); journal replication
        # (server/replication.py) takes the live siblings from
        # `replication_peers()` -> [(shard_index, url)] (in-process shards),
        # else from `<fleet_root>/shards.json` (subprocess shards). Neither:
        # a standalone plane, which replicates nothing.
        replication_peers: Optional[Any] = None,
        fleet_root: Optional[str] = None,
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
        self.shard_index = shard_index
        self._blob_dir_override = blob_dir
        # epoch fencing (server/shards.py): a fenced shard was replaced by a
        # takeover and never serves or journals its partition again
        self.fenced = False
        self.fenced_at_epoch = 0
        self.takeover_reports: list[dict] = []  # one per adopted partition
        self.replication_peers = replication_peers
        self.fleet_root = fleet_root
        self.replica_store = None  # the follower side, set by _attach_replication
        self._fence_rejection_times: list[float] = []  # the storm detector's window
        self._fence_storm_dumped_at = 0.0
        # an explicit policy, else the environment's (MODAL_TPU_CHAOS=1)
        self.chaos = chaos if chaos is not None else ChaosPolicy.from_env()
        self._build_plane()
        self.blob_server = BlobServer(self.state, chaos=self.chaos, fleet_root=self.fleet_root)
        self.input_plane = InputPlaneServer(self.state, self.servicer, chaos=self.chaos)
        self.workers: list[WorkerAgent] = []
        self.uds_path = ""  # the plane's Unix socket (set at bind time)
        self._grpc_server: Optional[grpc.aio.Server] = None
        # two crash_restarts must not interleave their teardown and rebuild
        self._crash_lock = asyncio.Lock()
        self._sampler_task: Optional[asyncio.Task] = None
        self.flight_recorder = None
        self._chaos_task: Optional[asyncio.Task] = None
        self._chaos_subtasks: set[asyncio.Task] = set()  # strong refs

    @property
    def server_url(self) -> str:
        return f"grpc://127.0.0.1:{self.port}"

    def _build_plane(self) -> None:
        """A fresh state, servicer and scheduler: at construction and on the
        rebuild of a crash_restart."""
        self.state = ServerState(self.state_dir, shard_index=self.shard_index, blob_dir=self._blob_dir_override)
        self.servicer = ModalTPUServicer(self.state)
        self.servicer.chaos = self.chaos
        self.servicer.supervisor = self  # ShardControl and JournalReplicate
        self.scheduler = Scheduler(self.state, self.servicer)
        self.servicer.scheduler = self.scheduler

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
        self._attach_replication(journal)
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
            self.input_plane.port = self.input_plane.port or int(saved.get("input_plane", 0))
        except (OSError, ValueError):
            pass

    def _attach_replication(self, journal: Journal) -> None:
        """Wire the follower's ReplicaStore and the writer's
        JournalReplicator onto the journal just opened. A standalone plane
        (no peers, no fleet root) gets neither, and so does
        MODAL_TPU_JOURNAL_REPLICAS=0: the journal then writes what an
        unreplicated one does."""
        from .replication import JournalReplicator, ReplicaStore, replicas_configured

        if (self.replication_peers is None and not self.fleet_root) or replicas_configured() == 0:
            return
        # the follower's durability follows the journal's: with
        # MODAL_TPU_JOURNAL_FSYNC=1 a quorum ack means fsynced there too
        self.replica_store = ReplicaStore(
            self.state_dir, fsync=journal.fsync, chaos=self.chaos, on_fence_rejection=self._note_fence_rejection
        )
        peers = self.replication_peers or self._peers_from_fleet_root
        replicator = JournalReplicator(journal, self.shard_index, self.state_dir, peers=peers, chaos=self.chaos)
        self.state.replicator = replicator
        journal.observer = replicator.observe
        journal.on_snapshot = replicator.ship_snapshot

    def _peers_from_fleet_root(self) -> list[tuple[int, str]]:
        """A subprocess shard's siblings: the director rewrites
        <fleet_root>/shards.json on every change of the topology; dead and
        unstarted ones are left out. Read per call, so a takeover or a
        respawn needs no control channel."""
        try:
            with open(os.path.join(self.fleet_root, "shards.json")) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return []
        peers = []
        for entry in doc.get("shards", ()):
            try:
                idx = int(entry.get("index", -1))
            except (TypeError, ValueError):
                continue
            url = entry.get("url") or ""
            if idx < 0 or idx == self.shard_index or not url or entry.get("dead"):
                continue
            peers.append((idx, url))
        return peers

    def _note_fence_rejection(self, writer: int) -> None:
        """The fence-rejection storm detector: one stale append is routine
        during a takeover; five in ten seconds mean an undead writer keeps
        appending to a sealed stream, and the flight recorder dumps its last
        minute (at most once a minute)."""
        now = time.monotonic()
        window = [t for t in self._fence_rejection_times if now - t < 10.0]
        window.append(now)
        self._fence_rejection_times = window
        if len(window) >= 5 and now - self._fence_storm_dumped_at > 60.0:
            self._fence_storm_dumped_at = now
            if self.flight_recorder is not None:
                self.flight_recorder.dump("fence_rejections", extra={"writer": writer, "rejections_10s": len(window)})

    def _save_ports(self) -> None:
        """Record the bound ports for the next (post-crash) boot."""
        if self.state.journal is None:
            return
        try:
            with open(os.path.join(self.state.journal.dir, "ports.json"), "w") as f:
                json.dump({"grpc": self.port, "blob": self.blob_server.port, "input_plane": self.input_plane.port}, f)
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
        if self.chaos is not None:
            # /metrics echoes the seed, so a failure names its fault sequence
            from ..observability.catalog import CHAOS_SEED

            CHAOS_SEED.set(float(self.chaos.seed))
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
                chaos=self.chaos,
            )
            await worker.start()
            self.workers.append(worker)
        if self.chaos is not None and self.chaos.events:
            self._chaos_task = asyncio.create_task(self._chaos_event_loop(), name="chaos-events")
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
        # chaos wraps the handler boundary: the servicer itself (and every
        # in-process caller: the scheduler, tests) stays clean
        handler_target = ChaosServicerProxy(self.servicer, self.chaos) if self.chaos is not None else self.servicer
        self._grpc_server.add_generic_rpc_handlers((build_generic_handler(handler_target),))
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
        await self.input_plane.start()
        # the in-process rung: registered once the servers are live, so a
        # resolvable entry always means a serving plane
        local_transport.register_local_server(self.server_url, handler_target)
        self._save_ports()
        self.scheduler.start()
        # built here (not in start()) so a crash_restart builds the store
        # and the evaluator against the new state: the evaluator adopts
        # state.alerts, which the replay just refilled
        self._start_sampler()
        # the flight recorder, rebuilt with the plane so it taps the new
        # journal
        from ..observability import flight_recorder as obs_fr

        if obs_fr.enabled():
            self.flight_recorder = obs_fr.FlightRecorder(
                self.state_dir, journal=self.state.journal, chaos=self.chaos, shard_index=self.shard_index
            )
            self.flight_recorder.start()
        # the replication senders need the running loop, and a crash_restart
        # starts them again against the new journal
        if self.state.replicator is not None:
            self.state.replicator.start()

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
                transitions = evaluator.evaluate()
                recorder = self.flight_recorder
                if recorder is not None:
                    for tr in transitions:
                        if tr.get("state") == "firing":
                            recorder.dump("alert", extra={"alert": tr})
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

    def _stop_recorder(self) -> None:
        if self.flight_recorder is not None:
            self.flight_recorder.stop()
            self.flight_recorder = None

    async def _chaos_event_loop(self) -> None:
        """Fire the scheduled chaos events once their output count passes.
        Each fired event also goes into the flight recorder's chaos tail,
        so a crash_restart's postmortem names the event that caused it."""
        while True:
            try:
                for ev in self.chaos.pop_due_events():
                    if self.flight_recorder is not None:
                        self.flight_recorder.record_chaos(
                            {"kind": ev.kind, "after_outputs": ev.after_outputs,
                             "outputs_seen": self.chaos.outputs_seen, "t": round(time.time(), 3)}
                        )
                    if ev.kind == "supervisor_crash":
                        logger.warning("chaos: crashing and recovering the control plane")
                        t = asyncio.create_task(self.crash_restart())
                        self._chaos_subtasks.add(t)
                        t.add_done_callback(self._chaos_subtasks.discard)
                        continue
                    idx = min(ev.worker_index, len(self.workers) - 1)
                    if idx < 0:
                        continue
                    if ev.kind == "worker_preempt":
                        logger.warning(f"chaos: preempting worker {idx} (grace {ev.grace_s}s)")
                        t = asyncio.create_task(self.workers[idx].preempt(ev.grace_s))
                        self._chaos_subtasks.add(t)
                        t.add_done_callback(self._chaos_subtasks.discard)
                    elif ev.kind == "worker_kill":
                        logger.warning(f"chaos: killing worker {idx} containers")
                        self.workers[idx].kill_containers()
                    elif ev.kind == "heartbeat_blackhole":
                        self.chaos.start_heartbeat_blackhole(ev.duration_s)
            except asyncio.CancelledError:
                return
            except Exception:
                logger.exception("chaos event loop iteration failed")
            await asyncio.sleep(0.1)

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

    async def crash_abandon(self) -> tuple[int, int, int]:
        """The teardown half of a crash: kill the container subprocesses and
        drop every serving surface with no drain and no state flush. The
        journal is closed and its segments stay on disk: a crash_restart
        rebuilds from them, and a sibling's takeover replays them (chaos
        `shard_kill`, server/shards.py). Returns the (grpc, blob,
        input-plane) ports for a same-port rebuild."""
        ports = (self.port, self.blob_server.port, self.input_plane.port)
        # the workers are in process: a real crash of this process takes
        # their containers with it; the agents outlive it and re-adopt
        for worker in self.workers:
            worker.kill_containers()
        # the in-process rung dies with the plane (a stale registration would
        # serve the abandoned state) and registers again on the rebuild
        local_transport.unregister_local_server(self.server_url)
        local_transport.unregister_local_server(self.state.input_plane_url)
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=None)
            self._grpc_server = None
        await self.scheduler.stop()
        await self._stop_sampler()  # it holds the abandoned state
        self._stop_recorder()
        await self.input_plane.stop()
        await self.blob_server.stop()
        await self._stop_replication()
        if self.state.journal is not None:
            self.state.journal.close()
        return ports

    async def _crash_restart_locked(self) -> Optional[dict]:
        t0 = time.time()
        if self.flight_recorder is not None:
            # the dump comes before the teardown: the ring still holds the
            # minute up to the crash (the rebuilt plane gets a fresh ring)
            self.flight_recorder.dump("crash_restart")
        grpc_port, blob_port, input_port = await self.crash_abandon()
        self._build_plane()
        self.blob_server = BlobServer(self.state, port=blob_port, chaos=self.chaos, fleet_root=self.fleet_root)
        self.input_plane = InputPlaneServer(self.state, self.servicer, port=input_port, chaos=self.chaos)
        self.recover = True
        self._attach_journal()
        await self._start_control_plane(grpc_port)
        tracing.record_span("recovery.crash_restart", start=t0, end=time.time(),
                            attrs={k: v for k, v in (self.recovery_report or {}).items() if k != "skipped_by_type"})
        logger.warning(f"control plane crash-restarted in {time.time() - t0:.2f}s: {self.recovery_report}")
        return self.recovery_report

    async def adopt_partition(self, source_state_dir: str, partition: int = -1) -> dict:
        """A takeover (server/shards.py): replay a dead sibling's journal into
        this shard's live state (recover_state pointed at its segments),
        compact the merged state into this shard's journal, which becomes
        its one durable record, and archive the source's segments, so a
        respawned stale shard can never replay them (with the director's
        epoch bump, the fence against a split brain)."""
        from ..observability.catalog import SHARD_TAKEOVER_SECONDS
        from .journal import synthesize_records

        t0 = time.time()
        source = Journal(source_state_dir)
        try:
            report = recover_state(self.state, source, preserve_live_workers=True)
        finally:
            source.close()
        archive_existing(source_state_dir)
        if self.state.journal is not None:
            await self.state.journal.compact_async(synthesize_records(self.state))
        # the adopted partition's requeued inputs want placement now
        self.state.schedule_event.set()
        took = time.time() - t0
        report = dict(report, partition=partition, source=source_state_dir, seconds=round(took, 4))
        self.takeover_reports.append(report)
        SHARD_TAKEOVER_SECONDS.set(took, partition=str(partition))
        if self.flight_recorder is not None:
            self.flight_recorder.dump("takeover", extra={"report": report})
        tracing.record_span("control.takeover", start=t0, end=time.time(),
                            attrs={k: v for k, v in report.items() if k != "skipped_by_type"})
        logger.warning(f"shard {self.shard_index} adopted partition {partition}: {report}")
        return report

    async def fence(self, epoch: int) -> None:
        """Epoch fencing: this shard's partition was taken over while it was
        presumed dead (a stale rejoiner), or is about to be (a false death:
        the director lost it, but it lives). Either way it stops serving:
        clients get UNAVAILABLE, hello the director again and land on the
        successor. The journal is closed but not archived: after a false
        death the successor replays these segments next (adopt_partition is
        the one archive point, after a replay that succeeded)."""
        if self.fenced:
            return
        self.fenced = True
        self.fenced_at_epoch = epoch
        if self.flight_recorder is not None:
            self.flight_recorder.dump("fence", extra={"epoch": epoch})
        local_transport.unregister_local_server(self.server_url)
        local_transport.unregister_local_server(self.state.input_plane_url)
        for worker in self.workers:
            worker.kill_containers()
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=None)
            self._grpc_server = None
        await self.scheduler.stop()
        await self._stop_sampler()
        self._stop_recorder()
        await self.input_plane.stop()
        await self.blob_server.stop()
        await self._stop_replication()
        if self.state.journal is not None:
            self.state.journal.close()
            self.state.journal = None
        logger.warning(f"shard {self.shard_index} fenced at epoch {epoch}")

    async def _stop_replication(self) -> None:
        """Cancel the writer's senders and close the follower's files. The
        replica streams stay on disk: a takeover seals and materializes
        them once this shard, or its disk, is gone."""
        replicator = self.state.replicator
        if replicator is not None:
            await replicator.stop()
            self.state.replicator = None
        if self.replica_store is not None:
            self.replica_store.close()
            self.replica_store = None

    def note_fleet_epoch(self, epoch: int) -> None:
        """Adopt the director's fleet epoch (carried by its health probes and
        takeovers): the replicator stamps later appends with it, so
        followers fence any incarnation of this shard that missed a
        takeover."""
        replicator = self.state.replicator
        if replicator is not None:
            replicator.note_epoch(epoch)

    async def adopt_from_replica(self, writer: int, partition: int, epoch: int) -> dict:
        """A quorum takeover (server/shards.py): adopt a dead writer's
        partition from this shard's replica stream of its journal, the path
        that survives a lost disk. Seal first (idempotent; the director
        seals every other surviving holder at the same epoch, so the old
        writer's quorum is gone), then materialize the sealed stream into a
        journal-shaped directory and adopt it as adopt_partition does."""
        if self.replica_store is None:
            raise RuntimeError(f"shard {self.shard_index} holds no replica streams (replication off?)")
        t0 = time.time()
        sealed = self.replica_store.seal(writer, epoch)
        if not sealed.get("ok"):
            raise RuntimeError(f"seal of writer {writer} at epoch {epoch} refused: {sealed}")
        source = self.replica_store.materialize(writer)
        tracing.record_span(
            "control.seal",
            start=t0,
            end=time.time(),
            attrs={"writer": writer, "partition": partition, "epoch": epoch, "sealed_seq": sealed.get("sealed_seq", 0)},
        )
        self.note_fleet_epoch(epoch)
        report = await self.adopt_partition(source, partition=partition)
        report["mode"] = "replica"
        report["writer"] = writer
        report["sealed_seq"] = sealed.get("sealed_seq", 0)
        return report

    def shard_status(self) -> dict:
        """This shard's health and topology, for the director's probes and
        `journal status`."""
        j = self.state.journal
        return {
            "shard_index": self.shard_index,
            "state_dir": self.state_dir,
            "url": self.server_url,
            "fenced": self.fenced,
            "fenced_at_epoch": self.fenced_at_epoch,
            "workers": len(self.state.workers),
            "open_calls": sum(1 for c in self.state.function_calls.values() if c.num_done < c.num_inputs),
            "journal_seq": j.seq if j is not None else 0,
            "takeovers": len(self.takeover_reports),
            # the writer's followers (acks, lag, epoch) and the replica
            # streams this shard holds for its peers
            "replication": self.state.replicator.status() if self.state.replicator is not None else None,
            "replica_streams": self.replica_store.status_all() if self.replica_store is not None else [],
            # the director's chaos clock (a subprocess shard reports its
            # output count through the probe)
            "chaos_outputs_seen": self.chaos.outputs_seen if self.chaos is not None else 0,
        }

    async def stop(self) -> None:
        local_transport.unregister_local_server(self.server_url)
        local_transport.unregister_local_server(self.state.input_plane_url)
        if self.uds_path:
            try:
                os.unlink(self.uds_path)
            except OSError:
                pass
        if self._chaos_task is not None:
            self._chaos_task.cancel()
            try:
                await self._chaos_task
            except asyncio.CancelledError:
                pass
        for t in list(self._chaos_subtasks):
            t.cancel()
        if self._chaos_subtasks:
            await asyncio.gather(*self._chaos_subtasks, return_exceptions=True)
        for worker in self.workers:
            await worker.stop()
        if self.fenced:
            return  # fence() or a kill already tore the surfaces and the journal down
        await self.scheduler.stop()
        await self._stop_sampler()
        self._stop_recorder()
        await self.input_plane.stop()
        await self.blob_server.stop()
        await self._stop_replication()
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=0.5)
        if self.state.journal is not None:
            self.state.journal.close()


async def serve_forever(
    port: int = 9900,
    num_workers: int = 1,
    state_dir: Optional[str] = None,
    shards: int = 1,
    subprocess_shards: bool = False,
    shard_index: int = 0,
    blob_dir: Optional[str] = None,
    fleet_root: Optional[str] = None,
) -> None:
    if shards > 1:
        # the sharded plane (server/shards.py); one shard is the monolith,
        # which never builds a director
        from .shards import ShardedSupervisor

        sup: Any = ShardedSupervisor(
            num_shards=shards, num_workers=num_workers, port=port, state_dir=state_dir,
            subprocess_shards=subprocess_shards,
        )
    else:
        sup = LocalSupervisor(
            num_workers=num_workers, port=port, state_dir=state_dir,
            shard_index=shard_index, blob_dir=blob_dir, fleet_root=fleet_root,
        )
    await sup.start()
    if sup.chaos is not None:
        events = ",".join(f"{ev.kind}@{ev.after_outputs}" for ev in sup.chaos.events) or "none"
        print(f"chaos policy attached: seed {sup.chaos.seed}, events {events}", flush=True)
    if sup.flight_recorder is not None:
        print(f"flight recorder on: ring {sup.flight_recorder.samples.maxlen} samples", flush=True)
    print(f"modal_tpu_torch control plane listening on {sup.server_url}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await sup.stop()
