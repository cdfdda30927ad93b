"""Worker agent: the host daemon that runs containers (port of
modal_tpu/server/worker.py).

The worker registers its GPU inventory with the control plane, polls for
assignments, runs each task as a container subprocess of this host (the
"image" is the worker's own interpreter), tails its logs into the app's
logs and reports its exit. A task is pinned to its cards through
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

Waiting for later sub-slices (ROADMAP Queue A): sandboxes and their command
router and sidecars, the warm pool and the image builder, the fs snapshot
of sandboxes, and the re-homing of a worker onto a shard that took over its
plane (4e).
"""

from __future__ import annotations

import asyncio
import os
import signal
import subprocess
import sys
import time
from typing import Any, Optional

from .._utils.grpc_utils import create_channel, retry_transient_errors
from ..config import config, logger
from ..observability import tracing
from ..proto import api_pb2
from ..proto.rpc import ModalTPUStub
from .scheduler import LOCAL_SIM

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=index,name,memory.total", "--format=csv,noheader"]
# a stopped container stuck in user code is killed after this grace
STOP_GRACE_S = 10.0


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
        self.gpu_type = ""
        self.card_indices: list[int] = []
        self._procs: dict[str, asyncio.subprocess.Process] = {}
        # stop events that raced ahead of their assignment: the task is
        # stopped at registration instead of booting on released cards
        self._early_stops: dict[str, None] = {}  # insertion-ordered set
        self._channel = None
        self._uds_channels: dict[str, Any] = {}  # the plane's socket (local_transport.wrap_stub)
        self._stub: Optional[ModalTPUStub] = None
        self._tasks: list[asyncio.Task] = []
        self._children: set[asyncio.Task] = set()  # strong refs to per-task coroutines
        self._stopped = False
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
                region=self.region or "",
                zone=self.zone or "",
                spot=self.spot,
                instance_type=self.instance_type or "",
            ),
            max_retries=10,
            max_delay=2.0,
        )
        self.worker_id = resp.worker_id

    async def stop(self) -> None:
        self._stopped = True
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        for proc in list(self._procs.values()):
            await self._kill_proc(proc)
        if self._children:
            await asyncio.gather(*self._children, return_exceptions=True)
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
                        self._spawn_child(self._run_task(event.assignment))
                    elif which == "stop":
                        await self._stop_task(event.stop)
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

    async def _stop_task(self, stop: api_pb2.TaskStopEvent) -> None:
        proc = self._procs.get(stop.task_id)
        if proc is None:
            self._early_stops[stop.task_id] = None
            while len(self._early_stops) > 1024:  # stops of long-gone tasks
                self._early_stops.pop(next(iter(self._early_stops)))
            return
        logger.debug(f"stopping task {stop.task_id}")
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

    async def _report_result(self, task_id: str, result: api_pb2.GenericResult) -> None:
        try:
            await retry_transient_errors(
                self._stub.TaskResult, api_pb2.TaskResultRequest(task_id=task_id, result=result), max_retries=2
            )
        except Exception as exc:  # noqa: BLE001 — the reaper is the backstop
            logger.warning(f"failed reporting result of task {task_id}: {exc}")

    def container_env(self, assignment: api_pb2.TaskAssignment, task_dir: str, args_path: str, t_launch0: float) -> dict:
        """The environment a container process starts with."""
        args = assignment.container_arguments
        env = dict(os.environ)
        env.update(dict(args.env))
        env["MODAL_TPU_CONTAINER_ARGS_PATH"] = args_path
        # the container's boot span starts at the spawn decision, in this
        # supervisor's span sink
        env[tracing.TRACE_T0_ENV] = str(t_launch0)
        if tracing.trace_dir():
            env[tracing.TRACE_DIR_ENV] = tracing.trace_dir()
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
        if task_id in self._early_stops:
            self._early_stops.pop(task_id)
            # the control plane releases the task's cards on this result
            await self._report_result(
                task_id,
                api_pb2.GenericResult(status=api_pb2.GENERIC_STATUS_TERMINATED, exception="stopped before container start"),
            )
            return
        args = assignment.container_arguments
        args.server_url = self.server_url
        task_dir = os.path.join(self.state_dir, "tasks", task_id)
        os.makedirs(task_dir, exist_ok=True)
        args_path = os.path.join(task_dir, "container_arguments.pb")
        with open(args_path, "wb") as f:
            f.write(args.SerializeToString())
        env = self.container_env(assignment, task_dir, args_path, t_launch0)
        stdout_path = os.path.join(task_dir, "stdout.log")
        stderr_path = os.path.join(task_dir, "stderr.log")
        globals_path = args.function_def.experimental_options.get("globals_path", "")
        # fork+exec of a fresh interpreter: never a bare fork of a process
        # that may hold a CUDA context
        with open(stdout_path, "wb") as out_f, open(stderr_path, "wb") as err_f:
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-u", "-m", "modal_tpu_torch.runtime.container_entrypoint",
                env=env, stdout=out_f, stderr=err_f, cwd=globals_path or None,
            )
        self._procs[task_id] = proc
        tracing.record_span(
            "worker.launch_task",
            start=t_launch0,
            end=time.time(),
            parent=tracing.parse_context(args.env.get(tracing.TRACE_CONTEXT_ENV, "")),
            attrs={"task_id": task_id, "worker_id": self.worker_id, "pid": proc.pid},
        )
        logger.debug(f"task {task_id} started pid={proc.pid} gpus={list(assignment.gpu_ids)}")
        if task_id in self._early_stops:  # a stop raced in during spawn
            self._early_stops.pop(task_id)
            proc.kill()
        elif self.draining:
            # the assignment raced the preemption notice
            self._signal_preempt(task_id, proc, self._drain_grace_s)
        tail_task = asyncio.create_task(self._stream_logs(task_id, stdout_path, stderr_path, proc))
        returncode = await proc.wait()
        del self._procs[task_id]
        await tail_task
        if returncode != 0:
            logger.warning(f"task {task_id} exited rc={returncode}")
            with open(stderr_path, "rb") as f:
                f.seek(max(0, os.path.getsize(stderr_path) - 4096))
                tail = f.read().decode(errors="replace")
            result = api_pb2.GenericResult(
                status=api_pb2.GENERIC_STATUS_FAILURE, exception=f"container exited with code {returncode}", traceback=tail
            )
        else:
            result = api_pb2.GenericResult(status=api_pb2.GENERIC_STATUS_SUCCESS)
        # the container's own report came first when it had one (first wins)
        await self._report_result(task_id, result)

    async def _stream_logs(self, task_id: str, stdout_path: str, stderr_path: str, proc) -> None:
        """Tail the container's stdout and stderr into the app's logs (read
        back through AppGetLogs), until the process has exited and the files
        are drained."""
        import codecs

        offsets = {stdout_path: 0, stderr_path: 0}
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
