"""Worker agent: the host daemon that runs containers (port of
modal_tpu/server/worker.py).

The worker registers its GPU inventory with the control plane, polls for
assignments, runs each task as a container subprocess of this host, tails
its logs into the app's logs and reports its exit. A task's image is built
on first use into a content-addressed venv (server/image_builder.py): the
container runs the image's python with the image's env, `PATH` and
`MODAL_TPU_IMAGE_ROOT`; a trivial chain (a matching python base and nothing
else) runs in the worker's own interpreter; a build that fails reports
INIT_FAILURE with the build log's tail, and nothing runs. A task is pinned to its cards through
`CUDA_VISIBLE_DEVICES` (with `CUDA_DEVICE_ORDER=PCI_BUS_ID`, so nvidia-smi's
indices are CUDA's); a task without cards, and every task on a `local-sim`
host, gets `CUDA_VISIBLE_DEVICES=""`: a container never sees a card it was
not given. The inventory comes from `nvidia-smi`; the worker never
initializes CUDA in its own process.

A worker beside its plane takes the local fast path (in process, or the
plane's Unix socket; _utils/local_transport.py) and hands its containers
the socket and the blob store directory (`MODAL_TPU_SERVER_UDS`,
`MODAL_TPU_BLOB_LOCAL_DIR`). After a restart of the plane a poll answered
NOT_FOUND, or a heartbeat answered `reannounce`, re-announces the worker
under the same id.

Each worker also serves the second data plane, its task command router
(server/task_router.py), on a loopback port it registers as
`router_address`: clients exec into a sandbox and operate on its files
there, and warm-pool interpreters take their placements there
(server/warm_pool.py). A placement first tries a parked interpreter and
falls back to a fresh spawn; a stop for a pooled placement drains in band
(the input poll's kill switch), with SIGKILL after the grace. Sandboxes
(`_run_sandbox`) run their command as a subprocess with streamed stdio, a
tunnel listener per open port and a readiness probe; sidecars
(`_run_sidecar`) share a sandbox's workdir and env. A sandbox pinned to a
card gets `CUDA_VISIBLE_DEVICES` as a function's container does, and so
does every process exec'd into it. The card pinning always wins over an
image's env. Sandboxes and sidecars run in their image too; a snapshot
image seeds a sandbox's workdir.

A shard takeover (server/shards.py) re-homes the agents of the dead
shard onto its successor (`rehome`): the same worker id registers there,
and the successor's journal-replayed record of it is adopted in place.
"""

from __future__ import annotations

import asyncio
import os
import shutil
import signal
import subprocess
import sys
import time
from typing import Any, Optional

from .._utils.grpc_utils import create_channel, retry_transient_errors
from ..config import config, logger
from ..observability import tracing
from ..observability.catalog import IMAGE_BUILD_SECONDS
from ..proto import api_pb2
from ..proto.rpc import ModalTPUStub
from .scheduler import LOCAL_SIM

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=index,name,memory.total", "--format=csv,noheader"]
# a stopped container stuck in user code is killed after this grace
STOP_GRACE_S = 10.0
# how long a sidecar launch waits for its sandbox to come up
SIDECAR_BOOT_WAIT_S = 600.0


def parse_gpu_inventory(text: str) -> tuple[str, list[int]]:
    """(card type, nvidia-smi indices of the cards of that type) from
    `nvidia-smi --query-gpu=index,name,memory.total --format=csv,noheader`
    lines. A worker registers one card type, as a JAX worker registers one
    TPU type: on a mixed host, the type most cards share (the lowest index
    breaks a tie), and only its cards."""
    cards: list[tuple[int, str]] = []
    for line in text.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) >= 2 and parts[0].isdigit():
            cards.append((int(parts[0]), parts[1]))
    if not cards:
        return "", []
    names = [name for _, name in sorted(cards)]
    gpu_type = max(names, key=lambda n: (names.count(n), -names.index(n)))
    return gpu_type, sorted(i for i, name in cards if name == gpu_type)


def detect_gpu_inventory() -> tuple[str, list[int]]:
    """This host's cards through nvidia-smi (a subprocess: CUDA is never
    initialized in the worker). `MODAL_TPU_WORKER_GPU_TYPE` and
    `MODAL_TPU_WORKER_NUM_GPUS` override it; no nvidia-smi means no card."""
    env_type = os.environ.get("MODAL_TPU_WORKER_GPU_TYPE")
    if env_type is not None:
        return env_type, list(range(int(os.environ.get("MODAL_TPU_WORKER_NUM_GPUS", "0"))))
    try:
        out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        logger.debug(f"gpu probe: {exc}")
        return "", []
    if out.returncode != 0:
        logger.debug(f"gpu probe: nvidia-smi exited {out.returncode}: {out.stderr.strip()[:200]}")
        return "", []
    return parse_gpu_inventory(out.stdout)


def container_gpu_env(gpu_ids: list[int], card_indices: list[int], gpu_type: str) -> dict[str, str]:
    """The card pinning of a container: the task's cards (the scheduler's
    ids, positions in `card_indices`) as nvidia-smi indices in PCI bus
    order; none for a CPU task or on a simulated host."""
    if not gpu_ids or gpu_type == LOCAL_SIM:
        return {"CUDA_VISIBLE_DEVICES": ""}
    return {
        "CUDA_VISIBLE_DEVICES": ",".join(str(card_indices[g]) for g in gpu_ids),
        "CUDA_DEVICE_ORDER": "PCI_BUS_ID",
    }


class WorkerAgent:
    """Registers with the control plane, polls for assignments, runs
    container subprocesses, reports exits."""

    def __init__(
        self,
        server_url: str,
        worker_id: Optional[str] = None,
        num_gpus: Optional[int] = None,
        gpu_type: Optional[str] = None,
        state_dir: Optional[str] = None,
        region: Optional[str] = None,
        zone: Optional[str] = None,
        spot: Optional[bool] = None,
        instance_type: Optional[str] = None,
        compile_cache_url: str = "",
        compile_cache_dir: str = "",
        server_uds: str = "",  # the co-located plane's Unix socket
        blob_local_dir: str = "",  # the co-located blob store (handoff by path)
        chaos=None,  # the plane's ChaosPolicy: the warm pool's warm_kill_handoff
    ):
        self.server_url = server_url
        # the local fast-path coordinates: from an in-process supervisor, else
        # the env of a standalone worker beside its plane
        self.server_uds = server_uds or os.environ.get("MODAL_TPU_SERVER_UDS", "")
        self.blob_local_dir = blob_local_dir or os.environ.get("MODAL_TPU_BLOB_LOCAL_DIR", "")
        self.worker_id = worker_id or ""
        self._override_gpus = num_gpus
        self._override_type = gpu_type
        # placement labels: explicit args, else MODAL_TPU_WORKER_REGION / _ZONE
        # / _SPOT / _INSTANCE_TYPE (how an operator tags hosts)
        self.region = region if region is not None else config["worker_region"]
        self.zone = zone if zone is not None else config["worker_zone"]
        self.spot = spot if spot is not None else config["worker_spot"]
        self.instance_type = instance_type if instance_type is not None else config["worker_instance_type"]
        self.state_dir = state_dir or config["state_dir"]
        # the fleet compile cache: the supervisor's store (read in place by
        # co-located containers) and its HTTP leg
        self.compile_cache_url = compile_cache_url or os.environ.get("MODAL_TPU_COMPILE_CACHE_URL", "")
        self.compile_cache_dir = compile_cache_dir
        # an in-process worker shares its plane's policy; its heartbeats are
        # blackholed at the plane's servicer (chaos.HEARTBEAT_RPCS)
        self.chaos = chaos
        self.gpu_type = ""
        self.card_indices: list[int] = []
        self._procs: dict[str, asyncio.subprocess.Process] = {}
        # task_id -> the warm-pool entry serving it: a stop for it drains in
        # band (kill switch) instead of SIGTERM, which would evict a reusable
        # interpreter, and whose escalation would kill it after it re-parked
        self._pool_tasks: dict[str, Any] = {}
        # task_id -> (cwd, env) of a running sandbox: its sidecars launch
        # into the same workdir and env
        self._sandbox_runtime: dict[str, tuple[str, dict]] = {}
        self.router = None  # TaskRouterServicer, bound in start()
        self._router_server = None
        self.router_address = ""
        self.pool = None  # WarmPool, created in start() once the router is up
        # stop events that raced ahead of their assignment: the task is
        # stopped at registration instead of booting on released cards
        self._early_stops: dict[str, None] = {}  # insertion-ordered set
        self._channel = None
        self._uds_channels: dict[str, Any] = {}  # the plane's socket (local_transport.wrap_stub)
        self._stub: Optional[ModalTPUStub] = None
        self._tasks: list[asyncio.Task] = []
        self._children: set[asyncio.Task] = set()  # strong refs to per-task coroutines
        self._stopped = False
        self._image_builder = None  # server/image_builder.py, made at the first image
        # preemption drain: announced on the next heartbeat; assignments
        # that race the notice are preempt-signaled as soon as they spawn
        self.draining = False
        self._drain_grace_s = 10.0

    async def start(self) -> None:
        os.makedirs(os.path.join(self.state_dir, "tasks"), exist_ok=True)
        self._channel = create_channel(self.server_url)
        self._stub = ModalTPUStub(self._channel)
        # fast path: an in-process supervisor is reached directly, a
        # co-located one over its Unix socket
        from .._utils import local_transport

        self._stub = local_transport.wrap_stub(
            self.server_url, self._stub, self.server_uds, channels=self._uds_channels
        )
        if self._override_gpus is not None or self._override_type is not None:
            self.gpu_type = self._override_type or ""
            self.card_indices = list(range(self._override_gpus or 0))
        else:
            self.gpu_type, self.card_indices = await asyncio.to_thread(detect_gpu_inventory)
        # the second data plane: the task command router that clients dial
        # directly, and the warm pool it serves
        import grpc

        from ..proto.rpc import build_router_handler
        from .task_router import TaskRouterServicer
        from .warm_pool import WarmPool

        self.router = TaskRouterServicer()
        self._router_server = grpc.aio.server()
        self._router_server.add_generic_rpc_handlers((build_router_handler(self.router),))
        router_port = self._router_server.add_insecure_port("127.0.0.1:0")
        await self._router_server.start()
        self.router_address = f"127.0.0.1:{router_port}"
        self.pool = WarmPool(self)
        self.router.pool = self.pool
        await self.pool.start()
        await self._register()
        self._tasks.append(asyncio.create_task(self._poll_loop(), name=f"worker-poll-{self.worker_id}"))
        self._tasks.append(asyncio.create_task(self._heartbeat_loop(), name=f"worker-hb-{self.worker_id}"))
        logger.debug(f"worker {self.worker_id} registered ({len(self.card_indices)} x {self.gpu_type!r})")

    async def _register(self) -> None:
        """(Re-)announce this host under the same worker_id."""
        resp = await retry_transient_errors(
            self._stub.WorkerRegister,
            api_pb2.WorkerRegisterRequest(
                worker_id=self.worker_id,
                hostname=os.uname().nodename,
                gpu_type=self.gpu_type,
                num_gpus=len(self.card_indices),
                milli_cpu=(os.cpu_count() or 1) * 1000,
                memory_mb=16384,
                container_address="127.0.0.1",
                router_address=self.router_address,
                region=self.region or "",
                zone=self.zone or "",
                spot=self.spot,
                instance_type=self.instance_type or "",
            ),
            max_retries=10,
            max_delay=2.0,
        )
        self.worker_id = resp.worker_id

    async def rehome(self, server_url: str, server_uds: str = "") -> None:
        """Point this agent at another control plane: the shard that owned
        it died and a survivor adopted its partition. The stub is rebuilt as
        start() builds it, and the agent registers again under the same
        worker id: the successor's replayed WorkerState awaits adoption, so
        it is adopted in place and in-flight maps resume on this worker."""
        from .._utils import local_transport

        old_channels = [self._channel, *self._uds_channels.values()]
        self._uds_channels = {}
        self.server_url = server_url
        self.server_uds = server_uds
        self._channel = create_channel(self.server_url)
        self._stub = local_transport.wrap_stub(
            self.server_url, ModalTPUStub(self._channel), self.server_uds, channels=self._uds_channels
        )
        for ch in old_channels:
            if ch is not None:
                try:
                    await ch.close()
                except Exception:  # noqa: BLE001 — the old plane is dead anyway
                    pass
        await self._register()
        logger.warning(f"worker {self.worker_id} rehomed to {server_url}")

    async def stop(self) -> None:
        self._stopped = True
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        if self.pool is not None:
            await self.pool.stop()
        for proc in list(self._procs.values()):
            await self._kill_proc(proc)
        if self._children:
            await asyncio.gather(*self._children, return_exceptions=True)
        if self.router is not None:
            await self.router.shutdown()
        if self._router_server is not None:
            await self._router_server.stop(grace=0.2)
        for channel in (self._channel, *self._uds_channels.values()):
            if channel is not None:
                await channel.close()

    def kill_containers(self) -> None:
        """SIGKILL every container of this host, with no grace: what a crash
        of the process that runs this agent does to them."""
        for proc in list(self._procs.values()):
            if proc.returncode is None:
                try:
                    proc.kill()
                except ProcessLookupError:
                    pass
        if self.pool is not None:
            self.pool.kill_parked()

    async def _kill_proc(self, proc: asyncio.subprocess.Process) -> None:
        if proc.returncode is None:
            try:
                proc.terminate()
                try:
                    await asyncio.wait_for(proc.wait(), timeout=5.0)
                except asyncio.TimeoutError:
                    proc.kill()
                    await proc.wait()
            except ProcessLookupError:
                pass

    def _spawn_child(self, coro) -> None:
        task = asyncio.create_task(coro)
        self._children.add(task)
        task.add_done_callback(self._children.discard)

    async def _heartbeat_loop(self) -> None:
        while not self._stopped:
            try:
                resp = await retry_transient_errors(
                    self._stub.WorkerHeartbeat,
                    api_pb2.WorkerHeartbeatRequest(
                        worker_id=self.worker_id,
                        active_task_ids=list(self._procs.keys()),
                        draining=self.draining,
                        drain_grace_s=self._drain_grace_s if self.draining else 0.0,
                        warm_pool_ready=self.pool.ready_count() if self.pool is not None else 0,
                    ),
                    max_retries=2,
                )
                if resp.reannounce:
                    logger.warning(f"worker {self.worker_id} unknown to control plane; re-announcing")
                    await self._register()
            except Exception as exc:  # noqa: BLE001 — the heartbeat loop must keep beating
                logger.warning(f"worker heartbeat failed: {exc}")
            await asyncio.sleep(5.0)

    # ------------------------------------------------------------------
    # Preemption: the cloud sends the host a notice with a grace window
    # ------------------------------------------------------------------

    async def preempt(self, grace_s: float = 10.0) -> None:
        """Handle a preemption notice for this host. The control plane must
        mark this worker's tasks preempted before any container exits (else
        their inputs burn retry budget instead of requeueing for free), so:
        announce draining with an immediate heartbeat, then send each
        container the preempt signal (SIGUSR2: flush resume tokens, exit
        gracefully), then escalate after the grace window."""
        if self.draining:
            return
        self.draining = True
        self._drain_grace_s = grace_s
        logger.warning(f"worker {self.worker_id} preempted (grace {grace_s}s); draining")
        if self.pool is not None:
            # parked interpreters hold no work: evict them now, so the host
            # can terminate inside its grace window
            self.pool.drain()
        try:
            await retry_transient_errors(
                self._stub.WorkerHeartbeat,
                api_pb2.WorkerHeartbeatRequest(
                    worker_id=self.worker_id,
                    active_task_ids=list(self._procs.keys()),
                    draining=True,
                    drain_grace_s=grace_s,
                ),
                max_retries=3,
                max_delay=1.0,
            )
        except Exception as exc:  # noqa: BLE001 — the containers must still be signaled
            logger.warning(f"preemption drain announce failed: {exc}")
        for task_id, proc in list(self._procs.items()):
            self._signal_preempt(task_id, proc, grace_s)

    def _signal_preempt(self, task_id: str, proc: asyncio.subprocess.Process, grace_s: float) -> None:
        """SIGUSR2 now, SIGTERM at the grace deadline, SIGKILL 5 s later."""
        if proc.returncode is not None:
            return
        try:
            proc.send_signal(signal.SIGUSR2)
        except ProcessLookupError:
            return

        async def _escalate() -> None:
            try:
                await asyncio.wait_for(proc.wait(), timeout=grace_s)
                return
            except asyncio.TimeoutError:
                logger.warning(f"task {task_id} still running at preemption deadline; terminating")
            await self._kill_proc(proc)

        self._spawn_child(_escalate())

    async def _poll_loop(self) -> None:
        import grpc

        while not self._stopped:
            try:
                async for event in self._stub.WorkerPoll(api_pb2.WorkerPollRequest(worker_id=self.worker_id)):
                    which = event.WhichOneof("event_oneof")
                    if which == "assignment":
                        if event.assignment.sandbox_id:
                            self._spawn_child(self._run_sandbox(event.assignment))
                        else:
                            self._spawn_child(self._run_task(event.assignment))
                    elif which == "stop":
                        await self._stop_task(event.stop)
                    elif which == "sidecar":
                        self._spawn_child(self._run_sidecar(event.sidecar))
                    elif event.HasField("pool_directive") and self.pool is not None:
                        # the scheduler's warm-pool sizing (outside the
                        # event oneof, as in api.proto)
                        self.pool.set_directive(event.pool_directive.image_id, event.pool_directive.target)
            except asyncio.CancelledError:
                return
            except Exception as exc:  # noqa: BLE001 — the poll stream reconnects
                if self._stopped:
                    return
                if isinstance(exc, grpc.aio.AioRpcError) and exc.code() == grpc.StatusCode.NOT_FOUND:
                    # a restarted control plane does not know this worker id
                    logger.warning(f"worker {self.worker_id} poll NOT_FOUND; re-announcing")
                    try:
                        await self._register()
                        continue
                    except Exception as reg_exc:  # noqa: BLE001
                        logger.warning(f"worker re-announce failed: {reg_exc}")
                logger.warning(f"worker poll stream broke ({exc}); reconnecting")
                await asyncio.sleep(0.5)

    def _note_early_stop(self, key: str) -> None:
        self._early_stops[key] = None
        while len(self._early_stops) > 1024:  # stops of long-gone tasks
            self._early_stops.pop(next(iter(self._early_stops)))

    def _consume_early_stop(self, key: str) -> bool:
        """True if a stop for this task (or sidecar) came before it started."""
        if key in self._early_stops:
            self._early_stops.pop(key)
            return True
        return False

    async def _stop_task(self, stop: api_pb2.TaskStopEvent) -> None:
        if stop.sidecar_name:
            # a sidecar's stop kills only that process; one that raced ahead
            # of the launch is consumed by _run_sidecar
            key = f"{stop.task_id}/sc/{stop.sidecar_name}"
            proc = self._procs.get(key)
            if proc is None:
                self._note_early_stop(key)
                return
            try:
                proc.kill()
            except ProcessLookupError:
                pass
            return
        proc = self._procs.get(stop.task_id)
        if proc is None:
            self._note_early_stop(stop.task_id)
            return
        logger.debug(f"stopping task {stop.task_id}")
        pool_entry = self._pool_tasks.get(stop.task_id)
        if pool_entry is not None and not stop.force and not stop.preempt:
            # pooled placement: the plane's terminate already reaches the
            # container as the kill switch on its next input poll, so its
            # input loop drains, the @exit hooks run and the interpreter
            # re-parks or exits; SIGKILL only if that misses the grace
            async def _escalate_pool(e=pool_entry, task_id=stop.task_id) -> None:
                try:
                    if e.task_done is not None:
                        await asyncio.wait_for(asyncio.shield(e.task_done), timeout=STOP_GRACE_S)
                except (asyncio.TimeoutError, asyncio.CancelledError):
                    logger.warning(f"pooled task {task_id} ignored the kill switch for {STOP_GRACE_S}s; killing")
                    try:
                        proc.kill()
                    except ProcessLookupError:
                        pass

            self._spawn_child(_escalate_pool())
            return
        if stop.preempt and not stop.force:
            self._signal_preempt(stop.task_id, proc, stop.grace_s or 10.0)
            return
        if stop.force:
            proc.kill()
            return
        try:
            proc.terminate()
        except ProcessLookupError:
            return
        # a container stuck in user code must still die: SIGKILL after the
        # grace window
        async def _escalate() -> None:
            try:
                await asyncio.wait_for(proc.wait(), timeout=STOP_GRACE_S)
            except asyncio.TimeoutError:
                logger.warning(f"task {stop.task_id} ignored SIGTERM for {STOP_GRACE_S}s; killing")
                try:
                    proc.kill()
                except ProcessLookupError:
                    pass

        self._spawn_child(_escalate())

    def _compile_cache_env(self, task_dir: str) -> dict[str, str]:
        """Where a container builds and finds its kernels: its own build
        directory (`TORCH_EXTENSIONS_DIR`, empty at boot, as on a fresh
        host), the supervisor's fleet store read in place, and its HTTP leg.
        A container then loads a kernel another container published instead
        of running nvcc again."""
        out = {"TORCH_EXTENSIONS_DIR": os.path.join(task_dir, "kernels")}
        if self.compile_cache_dir and os.path.isdir(self.compile_cache_dir):
            out["MODAL_TPU_COMPILE_CACHE_DIR"] = self.compile_cache_dir
        if self.compile_cache_url:
            out["MODAL_TPU_COMPILE_CACHE_URL"] = self.compile_cache_url
        return out

    async def _report_never_started(self, task_id: str) -> None:
        """The result of a task stopped before its launch: the control plane
        releases its cards on it (no container will ever report)."""
        await self._report_result(
            task_id,
            api_pb2.GenericResult(status=api_pb2.GENERIC_STATUS_TERMINATED, exception="stopped before container start"),
        )

    async def _report_result(self, task_id: str, result: api_pb2.GenericResult) -> None:
        try:
            await retry_transient_errors(
                self._stub.TaskResult, api_pb2.TaskResultRequest(task_id=task_id, result=result), max_retries=2
            )
        except Exception as exc:  # noqa: BLE001 — the reaper is the backstop
            logger.warning(f"failed reporting result of task {task_id}: {exc}")

    def container_env(self, assignment: api_pb2.TaskAssignment, task_dir: str, args_path: str, t_launch0: float,
                      built=None) -> dict:
        """The environment a container process starts with: the worker's,
        its image's (`built`), the task's (secrets, bound params), the
        plane's coordinates, and its card pinning last."""
        args = assignment.container_arguments
        env = dict(os.environ)
        if built is not None:
            built.launch_env(env)
        env.update(dict(args.env))
        env["MODAL_TPU_CONTAINER_ARGS_PATH"] = args_path
        # the container's boot span starts at the spawn decision, in this
        # supervisor's span sink
        env[tracing.TRACE_T0_ENV] = str(t_launch0)
        if tracing.trace_dir():
            env[tracing.TRACE_DIR_ENV] = tracing.trace_dir()
        # where the container's sampling profiler writes its folded stacks,
        # for the MODAL_TPU_PROFILE switch and the heartbeat's commands alike
        env.setdefault("MODAL_TPU_PROFILE_DIR", os.path.join(self.state_dir, "observability", "profiles"))
        env["MODAL_TPU_SERVER_URL"] = self.server_url
        # a container never calls ClientHello: it inherits the worker's
        # fast-path coordinates and stats them before use
        if self.server_uds:
            env["MODAL_TPU_SERVER_UDS"] = self.server_uds
        if self.blob_local_dir:
            env["MODAL_TPU_BLOB_LOCAL_DIR"] = self.blob_local_dir
        for key, value in self._compile_cache_env(task_dir).items():
            env.setdefault(key, value)
        env["MODAL_TPU_TASK_ID"] = assignment.task_id
        env["MODAL_TPU_TASK_DIR"] = task_dir
        if config["import_trace"]:  # MODAL_TPU_IMPORT_TRACE: per-module import timings
            env["MODAL_TPU_TELEMETRY_PATH"] = os.path.join(task_dir, "imports.jsonl")
        # sys.path for "file"-defined functions, and the repo root so the
        # container imports modal_tpu_torch
        globals_path = args.function_def.experimental_options.get("globals_path", "")
        if globals_path:
            env["PYTHONPATH"] = globals_path + os.pathsep + env.get("PYTHONPATH", "")
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env.update(container_gpu_env(list(assignment.gpu_ids), self.card_indices, self.gpu_type))
        return env

    async def _run_task(self, assignment: api_pb2.TaskAssignment) -> None:
        task_id = assignment.task_id
        t_launch0 = time.time()
        if self._consume_early_stop(task_id):
            await self._report_never_started(task_id)
            return
        args = assignment.container_arguments
        args.server_url = self.server_url
        task_dir = os.path.join(self.state_dir, "tasks", task_id)
        os.makedirs(task_dir, exist_ok=True)
        args_path = os.path.join(task_dir, "container_arguments.pb")
        with open(args_path, "wb") as f:
            f.write(args.SerializeToString())
        trace_ctx = args.env.get(tracing.TRACE_CONTEXT_ENV, "")
        # the function's image, built on first use; a failed build reports
        # INIT_FAILURE with the log's tail, and the function never runs
        ok, built = await self._prepare_image(task_id, args.function_def.image_id, trace_ctx)
        if not ok:
            return
        env = self.container_env(assignment, task_dir, args_path, t_launch0, built)
        stdout_path = os.path.join(task_dir, "stdout.log")
        stderr_path = os.path.join(task_dir, "stderr.log")
        globals_path = args.function_def.experimental_options.get("globals_path", "")
        container_python = built.python_bin if built is not None else sys.executable
        container_cwd = (built.workdir if built is not None else "") or globals_path or None
        # a parked interpreter takes the placement first, in process: no
        # exec, no imports; its env delta carries the card pinning and the
        # build dir, which nothing in it has read yet. Any failure falls
        # back to the fresh spawn below. Gangs are excluded: a process
        # group's state must never pass between placements.
        pool_entry = None
        out_offset = err_offset = 0
        if (self.pool is not None and not self.draining and args.world_size <= 1
                and (args.function_def.group_size or 0) <= 1):
            # a trivial chain runs in the worker's environment: the host key
            pool_entry = await self.pool.adopt(args.function_def.image_id if built is not None else "", env,
                                               task_id, args_path, cwd=container_cwd or "")
        if pool_entry is not None:
            proc = pool_entry.proc
            stdout_path, stderr_path = pool_entry.stdout_path, pool_entry.stderr_path
            try:
                out_offset, err_offset = os.path.getsize(stdout_path), os.path.getsize(stderr_path)
            except OSError:
                out_offset = err_offset = 0
            tracing.record_span(
                "coldstart.handoff", start=t_launch0, end=time.time(), parent=tracing.parse_context(trace_ctx),
                attrs={"task_id": task_id, "worker_id": self.worker_id, "pool_id": pool_entry.pool_id,
                       "pid": proc.pid, "generation": pool_entry.generation},
            )
        else:
            # fork+exec of a fresh interpreter: never a bare fork of a process
            # that may hold a CUDA context
            with open(stdout_path, "wb") as out_f, open(stderr_path, "wb") as err_f:
                proc = await asyncio.create_subprocess_exec(
                    container_python, "-u", "-m", "modal_tpu_torch.runtime.container_entrypoint",
                    env=env, stdout=out_f, stderr=err_f, cwd=container_cwd,
                )
        self._procs[task_id] = proc
        if pool_entry is not None:
            self._pool_tasks[task_id] = pool_entry
        tracing.record_span(
            "worker.launch_task",
            start=t_launch0,
            end=time.time(),
            parent=tracing.parse_context(trace_ctx),
            attrs={"task_id": task_id, "worker_id": self.worker_id, "pid": proc.pid,
                   "warm_pool_hit": pool_entry is not None},
        )
        logger.debug(f"task {task_id} started pid={proc.pid} gpus={list(assignment.gpu_ids)} "
                     f"warm_pool_hit={pool_entry is not None}")
        if self._consume_early_stop(task_id):  # a stop raced in during spawn
            proc.kill()
        elif self.draining:
            # the assignment raced the preemption notice
            self._signal_preempt(task_id, proc, self._drain_grace_s)
        self.router.register_task(task_id, env, container_cwd or os.getcwd(), token=assignment.router_token)
        tail_task = asyncio.create_task(
            self._stream_logs(task_id, stdout_path, stderr_path, proc, out_offset, err_offset))
        if pool_entry is not None:
            # resolved when the interpreter re-parks (its next
            # PoolAwaitArguments) or by the pool's watcher when it exits
            try:
                outcome, returncode = await pool_entry.task_done
            except asyncio.CancelledError:
                outcome, returncode = "exited", -1
            if outcome == "reparked":
                returncode = 0
                # the process lives on: one beat for the tailer to flush the
                # placement's last bytes before it detaches from the shared files
                await asyncio.sleep(0.25)
        else:
            returncode = await proc.wait()
        del self._procs[task_id]
        self._pool_tasks.pop(task_id, None)
        self.router.unregister_task(task_id)
        if proc.returncode is None:  # re-parked: the tailer would never see an exit
            tail_task.cancel()
            try:
                await tail_task
            except asyncio.CancelledError:
                pass
        else:  # exited: the tailer drains the files to their end, then returns
            await tail_task
        if returncode != 0:
            logger.warning(f"task {task_id} exited rc={returncode}")
            with open(stderr_path, "rb") as f:
                f.seek(max(err_offset, os.path.getsize(stderr_path) - 4096))
                tail = f.read().decode(errors="replace")
            result = api_pb2.GenericResult(
                status=api_pb2.GENERIC_STATUS_FAILURE, exception=f"container exited with code {returncode}", traceback=tail
            )
        else:
            result = api_pb2.GenericResult(status=api_pb2.GENERIC_STATUS_SUCCESS)
        # the container's own report came first when it had one (first wins)
        await self._report_result(task_id, result)

    async def _stream_logs(self, task_id: str, stdout_path: str, stderr_path: str, proc,
                           stdout_offset: int = 0, stderr_offset: int = 0) -> None:
        """Tail the container's stdout and stderr into the app's logs (read
        back through AppGetLogs), until the process has exited and the files
        are drained. A pooled placement shares its interpreter's log files
        across placements: nonzero offsets tail only this task's bytes."""
        import codecs

        offsets = {stdout_path: stdout_offset, stderr_path: stderr_offset}
        fds = {stdout_path: 1, stderr_path: 2}
        decoders = {path: codecs.getincrementaldecoder("utf-8")(errors="replace") for path in offsets}
        while True:
            logs = []
            for path, off in offsets.items():
                try:
                    size = os.path.getsize(path)
                except OSError:
                    continue
                if size > off:
                    with open(path, "rb") as f:
                        f.seek(off)
                        data = f.read(64 * 1024)
                    offsets[path] = off + len(data)
                    text = decoders[path].decode(data)
                    if text:
                        logs.append(
                            api_pb2.TaskLogs(data=text, task_id=task_id, file_descriptor=fds[path], timestamp=time.time())
                        )
            if logs:
                try:
                    await retry_transient_errors(
                        self._stub.ContainerLog, api_pb2.ContainerLogRequest(task_id=task_id, logs=logs), max_retries=1
                    )
                except Exception as exc:  # noqa: BLE001 — logs are best effort
                    logger.debug(f"log push failed for {task_id}: {exc}")
            elif proc.returncode is not None:
                return
            await asyncio.sleep(0.05 if logs else 0.2)

    # ------------------------------------------------------------------
    # Sandboxes and sidecars
    # ------------------------------------------------------------------

    async def _materialize_image(self, image_id: str, parent=None):
        """Build (or reuse) an image: a BuiltImage, or None for a trivial
        chain (the worker's own environment). Raises ImageBuildError."""
        from .image_builder import get_image_builder

        if self._image_builder is None:
            self._image_builder = get_image_builder(self.state_dir)
        return await self._image_builder.materialize(self._stub, image_id, parent)

    async def _prepare_image(self, task_id: str, image_id: str, trace_context: str = ""):
        """(ok, built) for a task's image, shared by the function and sandbox
        paths: a failed build reports INIT_FAILURE with the build log's tail
        and gives (False, None)."""
        if not image_id:
            return True, None
        t0 = time.time()
        parent = tracing.parse_context(trace_context)
        try:
            built = await self._materialize_image(image_id, parent)
        except Exception as exc:  # noqa: BLE001 — reported as the task's init failure
            logger.warning(f"image build failed for task {task_id}: {exc}")
            await self._init_failure(task_id, f"image build failed: {exc}")
            return False, None
        IMAGE_BUILD_SECONDS.observe(time.time() - t0)
        tracing.record_span("image.build", start=t0, end=time.time(), parent=parent,
                            attrs={"task_id": task_id, "image_id": image_id, "trivial": built is None})
        return True, built

    def sandbox_env(self, assignment: api_pb2.TaskAssignment, task_dir: str, built=None) -> dict:
        """A sandbox's environment: the worker's, its image's, its secrets,
        the repo on the path, a kernel build dir of its own (unless the
        image has one), and its cards pinned as a function container's are."""
        env = dict(os.environ)
        if built is not None:
            built.launch_env(env)
        env.update(dict(assignment.container_arguments.env))
        for key, value in self._compile_cache_env(task_dir).items():
            env.setdefault(key, value)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env.update(container_gpu_env(list(assignment.gpu_ids), self.card_indices, self.gpu_type))
        return env

    async def _init_failure(self, task_id: str, exception: str) -> None:
        await self._report_result(
            task_id, api_pb2.GenericResult(status=api_pb2.GENERIC_STATUS_INIT_FAILURE, exception=exception))

    async def _sidecar_exit(self, task_id: str, name: str, returncode: int) -> None:
        try:
            await retry_transient_errors(
                self._stub.SandboxSidecarExit,
                api_pb2.SandboxSidecarExitRequest(task_id=task_id, name=name, returncode=returncode),
                max_retries=2,
            )
        except Exception as exc:  # noqa: BLE001 — the listing keeps "running"
            logger.warning(f"sidecar {name!r} exit report failed: {exc}")

    async def _push_log(self, task_id: str, fd: int, text: str) -> None:
        try:
            await self._stub.ContainerLog(
                api_pb2.ContainerLogRequest(
                    task_id=task_id,
                    logs=[api_pb2.TaskLogs(data=text, task_id=task_id, file_descriptor=fd, timestamp=time.time())],
                ),
                timeout=10.0,
            )
        except Exception:  # noqa: BLE001 — logs are best effort
            pass

    async def _run_sidecar(self, event: api_pb2.SidecarLaunchEvent) -> None:
        """Launch a sandbox sidecar (reference sandbox.py `_experimental_sidecars`):
        an auxiliary process in the sandbox's workdir and base env, with its
        own command and env. Its output goes to the sandbox's logs tagged
        with its name; its exit is reported through SandboxSidecarExit."""
        task_id, sc = event.task_id, event.sidecar
        key = f"{task_id}/sc/{sc.name}"
        # the launch can race the sandbox's own boot
        runtime = None
        deadline = time.monotonic() + SIDECAR_BOOT_WAIT_S
        while time.monotonic() < deadline:
            if self._consume_early_stop(key):
                break
            runtime = self._sandbox_runtime.get(task_id)
            if runtime is not None:
                break
            await asyncio.sleep(0.2)
        if runtime is None:
            await self._sidecar_exit(task_id, sc.name, -1)
            return
        cwd, base_env = runtime
        env = dict(base_env)
        if sc.image_id:
            # not _prepare_image: its failure reports INIT_FAILURE for the
            # whole task, which would kill the sandbox over its sidecar's image
            try:
                built = await self._materialize_image(sc.image_id)
            except Exception as exc:  # noqa: BLE001 — reported as exit -1
                logger.warning(f"sidecar {sc.name!r} image build failed: {exc}")
                await self._sidecar_exit(task_id, sc.name, -1)
                return
            if built is not None:
                pinning = {k: env[k] for k in ("CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER") if k in env}
                built.launch_env(env)
                env.update(pinning)  # the sandbox's card pinning wins over the image's env
        env.update(dict(sc.env))
        try:
            proc = await asyncio.create_subprocess_exec(
                *sc.entrypoint_args, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE, cwd=cwd, env=env)
        except Exception as exc:  # noqa: BLE001 — reported as exit -1
            logger.warning(f"sidecar {sc.name!r} failed to spawn: {exc}")
            await self._sidecar_exit(task_id, sc.name, -1)
            return
        self._procs[key] = proc
        if self._consume_early_stop(key):  # a stop raced in during spawn
            proc.kill()

        async def _pump(stream, fd: int) -> None:
            while True:
                data = await stream.read(64 * 1024)
                if not data:
                    return
                await self._push_log(task_id, fd, f"[{sc.name}] " + data.decode("utf-8", "replace"))

        pumps = [asyncio.create_task(_pump(proc.stdout, 1)), asyncio.create_task(_pump(proc.stderr, 2))]
        try:
            returncode = await proc.wait()
        finally:
            self._procs.pop(key, None)
            for p in pumps:
                p.cancel()
        await self._sidecar_exit(task_id, sc.name, returncode)

    async def _run_sandbox(self, assignment: api_pb2.TaskAssignment) -> None:
        """Run a sandbox's command as a supervised subprocess: stdin drained
        from the control plane, stdout and stderr streamed back as logs, a
        tunnel listener per open port, the readiness probe, the timeout."""
        task_id = assignment.task_id
        if self._consume_early_stop(task_id):
            await self._report_never_started(task_id)
            return
        sandbox_id = assignment.sandbox_id
        d = assignment.sandbox_def
        task_dir = os.path.join(self.state_dir, "tasks", task_id)
        os.makedirs(task_dir, exist_ok=True)
        ok, built = await self._prepare_image(task_id, d.image_id)
        if not ok:
            return
        env = self.sandbox_env(assignment, task_dir, built)
        from .fs_snapshot import sandbox_workdir

        # a workdir of its own unless one is named (or the image's): a fs
        # snapshot then captures exactly this sandbox's files
        sandbox_cwd = d.workdir or (built.workdir if built is not None else "") or sandbox_workdir(
            self.state_dir, task_id, "")
        try:
            os.makedirs(sandbox_cwd, exist_ok=True)
            if built is not None and built.fs_seed_dir:
                # a snapshot image: the sandbox starts on a copy of its tree
                await asyncio.to_thread(shutil.copytree, built.fs_seed_dir, sandbox_cwd, dirs_exist_ok=True,
                                        ignore=shutil.ignore_patterns(".complete"))
        except Exception as exc:  # noqa: BLE001 — reported as the task's init failure
            await self._init_failure(task_id, f"snapshot restore failed: {exc}")
            return
        try:
            await retry_transient_errors(
                self._stub.ContainerHello,
                api_pb2.ContainerHelloRequest(task_id=task_id, sandbox_workdir=sandbox_cwd),
                max_retries=3,
            )
            proc = await asyncio.create_subprocess_exec(
                *d.entrypoint_args, stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE, cwd=sandbox_cwd, env=env,
            )
        except Exception as exc:  # noqa: BLE001
            await self._init_failure(task_id, repr(exc))
            return
        self._procs[task_id] = proc
        if self._consume_early_stop(task_id):  # a stop raced in during spawn
            proc.kill()
        self._sandbox_runtime[task_id] = (sandbox_cwd, env)
        self.router.register_task(task_id, env, sandbox_cwd, token=assignment.router_token)

        async def _heartbeat() -> None:
            # a sandbox heartbeats like a function container, so the reaper
            # leaves a long-running command alone
            while proc.returncode is None:
                try:
                    await retry_transient_errors(
                        self._stub.ContainerHeartbeat, api_pb2.ContainerHeartbeatRequest(task_id=task_id),
                        max_retries=1, attempt_timeout=10.0,
                    )
                except Exception:  # noqa: BLE001
                    pass
                await asyncio.sleep(10.0)

        async def _pump_stdin() -> None:
            offset = 0
            try:
                while proc.returncode is None:
                    resp = await retry_transient_errors(
                        self._stub.SandboxGetStdin,
                        api_pb2.SandboxGetStdinRequest(sandbox_id=sandbox_id, offset=offset, timeout=5.0),
                        attempt_timeout=15.0, max_retries=8,
                    )
                    for chunk in resp.chunks:
                        proc.stdin.write(chunk)
                        await proc.stdin.drain()
                    offset = resp.next_offset
                    if resp.eof:
                        proc.stdin.close()
                        return
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001
                # the stdin channel is lost: close the pipe so a reader sees
                # EOF instead of blocking to the sandbox's timeout
                logger.warning(f"sandbox {sandbox_id} stdin pump failed: {exc}")
                try:
                    proc.stdin.close()
                except Exception:  # noqa: BLE001
                    pass

        async def _pump_out(stream, fd: int) -> None:
            import codecs

            # incremental decoder: a UTF-8 character split across two reads
            # must not become U+FFFD
            decoder = codecs.getincrementaldecoder("utf-8")(errors="replace")
            while True:
                data = await stream.read(64 * 1024)
                text = decoder.decode(data, final=not data)
                if text:
                    await self._push_log(task_id, fd, text)
                if not data:
                    return

        tunnel_servers: list[asyncio.AbstractServer] = []

        async def _open_tunnels() -> None:
            """One TCP listener per open port, piping to the sandbox's own
            port on this host (reference _tunnel.py, sandbox.py `tunnels`;
            a production deployment fronts the same proxy with TLS)."""
            tunnels = []
            for spec in d.open_ports:
                server = await asyncio.start_server(tcp_proxy(spec.port), "127.0.0.1", 0)
                tunnel_servers.append(server)
                tunnels.append(api_pb2.TunnelData(container_port=spec.port, host="127.0.0.1",
                                                  port=server.sockets[0].getsockname()[1],
                                                  unencrypted=spec.unencrypted))
            await retry_transient_errors(
                self._stub.TaskTunnelsUpdate, api_pb2.TaskTunnelsUpdateRequest(task_id=task_id, tunnels=tunnels),
                max_retries=3,
            )

        async def _ready() -> None:
            await retry_transient_errors(self._stub.TaskReady, api_pb2.TaskReadyRequest(task_id=task_id),
                                         max_retries=3)

        async def _readiness_probe() -> None:
            probe = d.readiness_probe
            period = probe.period_secs or 1.0
            deadline = time.monotonic() + (probe.timeout_secs or d.timeout_secs or 600)
            while proc.returncode is None and time.monotonic() < deadline:
                try:
                    p = await asyncio.create_subprocess_exec(
                        *probe.exec_command, cwd=sandbox_cwd, env=env,
                        stdout=asyncio.subprocess.DEVNULL, stderr=asyncio.subprocess.DEVNULL,
                    )
                    rc = await asyncio.wait_for(p.wait(), timeout=max(period * 5, 10.0))
                except (asyncio.TimeoutError, OSError):
                    rc = -1
                if rc == 0:
                    await _ready()
                    return
                await asyncio.sleep(period)

        stdin_task = asyncio.create_task(_pump_stdin())
        hb_task = asyncio.create_task(_heartbeat())
        out_task = asyncio.create_task(_pump_out(proc.stdout, 1))
        err_task = asyncio.create_task(_pump_out(proc.stderr, 2))
        aux_tasks = []
        if d.open_ports:
            aux_tasks.append(asyncio.create_task(_open_tunnels()))
        # no probe: the sandbox is ready once it runs
        aux_tasks.append(asyncio.create_task(_readiness_probe() if d.readiness_probe.exec_command else _ready()))
        timeout_s = d.timeout_secs or 600
        try:
            returncode = await asyncio.wait_for(proc.wait(), timeout=timeout_s)
            if returncode == 0:
                status, exception = api_pb2.GENERIC_STATUS_SUCCESS, ""
            elif returncode < 0:
                # killed by a signal (terminate, stop event): TERMINATED, the
                # client's SandboxTerminatedError contract
                status, exception = api_pb2.GENERIC_STATUS_TERMINATED, f"terminated by signal {-returncode}"
            else:
                status, exception = api_pb2.GENERIC_STATUS_FAILURE, f"exit code {returncode}"
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()
            returncode = -1
            status, exception = api_pb2.GENERIC_STATUS_TIMEOUT, f"sandbox exceeded timeout of {timeout_s}s"
        finally:
            self._procs.pop(task_id, None)
            self._sandbox_runtime.pop(task_id, None)
            # sidecars share the sandbox's lifecycle: its exit takes them down
            for key, sc_proc in list(self._procs.items()):
                if key.startswith(f"{task_id}/sc/"):
                    try:
                        sc_proc.kill()
                    except ProcessLookupError:
                        pass
            self.router.unregister_task(task_id)
            stdin_task.cancel()
            hb_task.cancel()
            for t in aux_tasks:
                t.cancel()
            for server in tunnel_servers:
                server.close()
            await asyncio.gather(stdin_task, hb_task, *aux_tasks, return_exceptions=True)
            await asyncio.gather(out_task, err_task, return_exceptions=True)
        result = api_pb2.GenericResult(status=status, exception=exception, data=str(returncode).encode())
        await self._report_result(task_id, result)


def tcp_proxy(target_port: int):
    """A connection handler that pipes bytes both ways to `target_port` on
    this host."""

    async def handle(reader, writer):
        try:
            up_r, up_w = await asyncio.open_connection("127.0.0.1", target_port)
        except OSError:
            writer.close()
            return

        async def pipe(src, dst):
            try:
                while True:
                    data = await src.read(64 * 1024)
                    if not data:
                        break
                    dst.write(data)
                    await dst.drain()
            except Exception:  # noqa: BLE001 — the peer reset
                pass
            finally:
                try:
                    dst.close()
                except Exception:  # noqa: BLE001
                    pass

        await asyncio.gather(pipe(reader, up_w), pipe(up_r, writer))

    return handle
