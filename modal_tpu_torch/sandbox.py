"""Sandboxes: on-demand supervised processes with streamed IO (port of
modal_tpu/sandbox.py).

Reference: py/modal/sandbox.py: `_Sandbox.create`, wait/poll/terminate,
stdin/stdout/stderr streams (io_streams.py), exec and the filesystem over
the worker's command router, tunnels, snapshots and sidecars. The command
runs as a subprocess of a worker; its stdin rides a control-plane queue the
worker drains. `gpu="H100"` pins the sandbox, and every process exec'd into
it, to a card as `@app.function(gpu=...)` does; there is no `tpu=`.
"""

from __future__ import annotations

import asyncio
from typing import Any, AsyncGenerator, Optional, Sequence

from ._utils.async_utils import synchronize_api
from ._utils.grpc_utils import retry_transient_errors
from .client import _Client
from .exception import (
    ExecutionError,
    InvalidError,
    NotFoundError,
    SandboxTerminatedError,
    SandboxTimeoutError,
)
from .gpu_config import parse_gpu_config
from .image import _Image
from .object import _Object
from .proto import api_pb2
from .tunnel import Tunnel


class _StreamReader:
    """Streamed stdout/stderr of a sandbox (reference io_streams.py
    _StreamReader)."""

    def __init__(self, sandbox: "_Sandbox", fd: int):
        self._sandbox = sandbox
        self._fd = fd

    async def read(self) -> str:
        """Read everything until EOF."""
        parts = []
        async for chunk in self._aiter():
            parts.append(chunk)
        return "".join(parts)

    async def _aiter(self) -> AsyncGenerator[str, None]:
        last_entry_id = ""
        while True:
            eof = False
            async for batch in self._sandbox.client.stub.SandboxGetLogs(
                api_pb2.SandboxGetLogsRequest(
                    sandbox_id=self._sandbox.object_id,
                    file_descriptor=self._fd,
                    timeout=30.0,
                    last_entry_id=last_entry_id,
                )
            ):
                last_entry_id = batch.entry_id or last_entry_id
                for item in batch.items:
                    yield item.data
                if batch.eof_task_id:
                    eof = True
            if eof:
                return

    def __aiter__(self):
        return self._aiter()


class _StreamWriter:
    """Sandbox stdin (reference io_streams.py _StreamWriter): buffered writes,
    flushed as indexed chunks."""

    def __init__(self, sandbox: "_Sandbox"):
        self._sandbox = sandbox
        self._buffer = bytearray()
        self._index = 0
        self._eof = False

    def write(self, data: "bytes | str") -> None:
        if self._eof:
            raise InvalidError("stdin is closed")
        self._buffer.extend(data.encode() if isinstance(data, str) else data)

    def write_eof(self) -> None:
        self._eof = True

    async def drain(self) -> None:
        data = bytes(self._buffer)
        self._buffer.clear()
        self._index += 1
        await retry_transient_errors(
            self._sandbox.client.stub.SandboxStdinWrite,
            api_pb2.SandboxStdinWriteRequest(
                sandbox_id=self._sandbox.object_id, input=data, index=self._index, eof=self._eof
            ),
        )


class _Sandbox(_Object, type_prefix="sb"):
    _stdout: Optional[_StreamReader] = None
    _stderr: Optional[_StreamReader] = None
    _stdin: Optional[_StreamWriter] = None
    _result: Optional[api_pb2.GenericResult] = None
    _router: Optional[Any] = None
    _fs: Optional[Any] = None

    @staticmethod
    async def create(
        *entrypoint_args: str,
        app: Optional[Any] = None,
        image: Optional[_Image] = None,
        timeout: int = 600,
        workdir: Optional[str] = None,
        gpu: Optional[str] = None,
        cpu: Optional[float] = None,
        memory: Optional[int] = None,
        secrets: Sequence[Any] = (),
        name: Optional[str] = None,
        encrypted_ports: Sequence[int] = (),
        unencrypted_ports: Sequence[int] = (),
        readiness_probe: Optional[Sequence[str]] = None,
        region: "str | Sequence[str] | None" = None,
        scheduler_placement: Optional[Any] = None,
        client: Optional[_Client] = None,
    ) -> "_Sandbox":
        """Launch a sandbox running `entrypoint_args` (reference
        Sandbox.create, sandbox.py:518). Ports listed in encrypted_ports /
        unencrypted_ports are forwarded — see `tunnels()`. A readiness_probe
        argv is run inside the sandbox until it exits 0 (reference
        sandbox.py:256 Probe); `wait_until_ready()` blocks on it."""
        if not entrypoint_args:
            raise InvalidError("sandbox needs a command, e.g. Sandbox.create('python', '-c', ...)")
        if client is None:
            client = await _Client.from_env()
        definition = api_pb2.Sandbox(
            entrypoint_args=list(entrypoint_args),
            timeout_secs=timeout,
            workdir=workdir or "",
            name=name or "",
        )
        if image is not None:
            from .object import LoadContext, Resolver

            if not image.is_hydrated:
                resolver = Resolver()
                await resolver.load(image, LoadContext(client=client))
            definition.image_id = image.object_id
        for port in encrypted_ports:
            definition.open_ports.append(api_pb2.PortSpec(port=port, unencrypted=False))
        for port in unencrypted_ports:
            definition.open_ports.append(api_pb2.PortSpec(port=port, unencrypted=True))
        if readiness_probe:
            if isinstance(readiness_probe, Probe):
                definition.readiness_probe.exec_command.extend(readiness_probe.exec_command)
                definition.readiness_probe.period_secs = readiness_probe.period_secs
                definition.readiness_probe.timeout_secs = readiness_probe.timeout_secs
            else:
                definition.readiness_probe.exec_command.extend(readiness_probe)
        if region is not None or scheduler_placement is not None:
            from .schedule import SchedulerPlacement

            placement = scheduler_placement or SchedulerPlacement(region=region)
            if region is not None and scheduler_placement is not None:
                raise InvalidError("pass either region or scheduler_placement, not both")
            definition.scheduler_placement.CopyFrom(placement.to_proto())
        spec = parse_gpu_config(gpu)
        if spec is not None:
            definition.resources.gpu_config.CopyFrom(spec.to_proto())
        if cpu:
            definition.resources.milli_cpu = int(cpu * 1000)
        if memory:
            definition.resources.memory_mb = memory
        for s in secrets:
            definition.secret_ids.append(s.object_id)
        app_id = ""
        if app is not None and getattr(app, "app_id", None):
            app_id = app.app_id
        resp = await retry_transient_errors(
            client.stub.SandboxCreate,
            api_pb2.SandboxCreateRequest(app_id=app_id, definition=definition),
        )
        sandbox = _Sandbox._new_hydrated(resp.sandbox_id, client, None)
        return sandbox

    @staticmethod
    async def from_name(name: str, *, client: Optional[_Client] = None) -> "_Sandbox":
        if client is None:
            client = await _Client.from_env()
        resp = await retry_transient_errors(
            client.stub.SandboxGetFromName, api_pb2.SandboxGetFromNameRequest(name=name)
        )
        return _Sandbox._new_hydrated(resp.sandbox_id, client, None)

    @property
    def stdout(self) -> _StreamReader:
        if self._stdout is None:
            self._stdout = _StreamReader(self, 1)
        return self._stdout

    @property
    def stderr(self) -> _StreamReader:
        if self._stderr is None:
            self._stderr = _StreamReader(self, 2)
        return self._stderr

    @property
    def stdin(self) -> _StreamWriter:
        if self._stdin is None:
            self._stdin = _StreamWriter(self)
        return self._stdin

    async def wait(self, raise_on_termination: bool = True) -> int:
        """Block until the sandbox exits; returns the exit code."""
        while True:
            resp = await retry_transient_errors(
                self.client.stub.SandboxWait,
                api_pb2.SandboxWaitRequest(sandbox_id=self.object_id, timeout=55.0),
                attempt_timeout=60.0,
                max_retries=None,
            )
            if resp.HasField("result") and resp.result.status != api_pb2.GENERIC_STATUS_UNSPECIFIED:
                self._result = resp.result
                if resp.result.status == api_pb2.GENERIC_STATUS_TIMEOUT:
                    if raise_on_termination:
                        raise SandboxTimeoutError(resp.result.exception)
                    return -1
                if resp.result.status == api_pb2.GENERIC_STATUS_TERMINATED and raise_on_termination:
                    raise SandboxTerminatedError(resp.result.exception)
                return self.returncode if self.returncode is not None else 0

    async def poll(self) -> Optional[int]:
        """Exit code if finished, else None."""
        resp = await retry_transient_errors(
            self.client.stub.SandboxWait,
            api_pb2.SandboxWaitRequest(sandbox_id=self.object_id, timeout=0.0),
        )
        if resp.HasField("result") and resp.result.status != api_pb2.GENERIC_STATUS_UNSPECIFIED:
            self._result = resp.result
            return self.returncode
        return None

    @property
    def returncode(self) -> Optional[int]:
        if self._result is None:
            return None
        try:
            return int(self._result.data.decode())
        except (ValueError, AttributeError):
            return 0 if self._result.status == api_pb2.GENERIC_STATUS_SUCCESS else 1

    # -- direct data plane (worker command router) --------------------------

    def _get_router(self):
        if self._router is None:
            from ._utils.router_client import TaskRouterClient

            self._router = TaskRouterClient(self.client.stub, self.object_id)
        return self._router

    async def exec(
        self,
        *args: str,
        workdir: Optional[str] = None,
        env: Optional[dict] = None,
        timeout: int = 0,
        text: bool = True,
        pty: bool = False,
        pty_rows: int = 0,
        pty_cols: int = 0,
    ):
        """Run a command inside the running sandbox, returning a
        ContainerProcess with streamed stdio (reference Sandbox.exec,
        sandbox.py:1930 — V2 data plane via the worker's command router).
        With pty=True the command runs under a real pseudo-terminal
        (stdout+stderr merged on fd 1, as terminals do)."""
        if not args:
            raise InvalidError("exec needs a command")
        from .container_process import _ContainerProcess

        router = self._get_router()
        exec_id = await router.exec_start(
            list(args),
            workdir=workdir or "",
            env=env,
            timeout_secs=timeout,
            pty=pty,
            pty_rows=pty_rows,
            pty_cols=pty_cols,
        )
        return _ContainerProcess(router, exec_id, text=text)

    @property
    def _experimental_sidecars(self) -> "_SidecarManager":
        """Manage sidecar containers attached to this sandbox (reference
        sandbox.py:2157): auxiliary processes — a database, a helper service —
        that share the sandbox's filesystem and lifecycle but run their own
        command, env, and (optionally) image."""
        return _SidecarManager(self)

    @property
    def fs(self):
        """Typed filesystem API inside the sandbox (reference sandbox_fs.py)."""
        if self._fs is None:
            from .sandbox_fs import _SandboxFS

            self._fs = _SandboxFS(self._get_router())
        return self._fs

    async def open(self, path: str, mode: str = "r"):
        """Remote file handle (reference Sandbox.open / file_io.py)."""
        return await self.fs.open(path, mode)

    async def tunnels(self, timeout: float = 50.0) -> dict[int, Tunnel]:
        """Forwarded addresses for the sandbox's open ports, keyed by
        container port (reference Sandbox.tunnels, sandbox.py:1930). Blocks
        until the worker's tunnel listeners are up."""
        resp = await retry_transient_errors(
            self.client.stub.SandboxGetTunnels,
            api_pb2.SandboxGetTunnelsRequest(sandbox_id=self.object_id, timeout=timeout),
            attempt_timeout=timeout + 5.0,
        )
        if resp.result.status == api_pb2.GENERIC_STATUS_FAILURE:
            raise InvalidError(resp.result.exception)
        return {
            t.container_port: Tunnel(host=t.host, port=t.port, unencrypted=t.unencrypted)
            for t in resp.tunnels
        }

    async def wait_until_ready(self, timeout: float = 55.0) -> None:
        """Block until the readiness probe passes. Raises
        SandboxTerminatedError if the sandbox exits first, TimeoutError if
        the probe still hasn't passed after `timeout` — a timeout must never
        read as readiness."""
        resp = await retry_transient_errors(
            self.client.stub.SandboxGetTaskId,
            api_pb2.SandboxGetTaskIdRequest(
                sandbox_id=self.object_id, timeout=timeout, wait_until_ready=True
            ),
            attempt_timeout=timeout + 5.0,
        )
        if resp.task_result_json:
            raise SandboxTerminatedError(
                f"sandbox exited before becoming ready: {resp.task_result_json}"
            )
        if not resp.ready:
            raise TimeoutError(f"sandbox not ready after {timeout}s (probe still failing)")

    async def snapshot_filesystem(self, timeout: float = 55.0) -> _Image:
        """Snapshot the sandbox's filesystem into an Image usable by new
        sandboxes (reference sandbox.py:1480)."""
        resp = await retry_transient_errors(
            self.client.stub.SandboxSnapshotFs,
            api_pb2.SandboxSnapshotFsRequest(sandbox_id=self.object_id, timeout=timeout),
            attempt_timeout=timeout + 5.0,
        )
        if resp.result.status != api_pb2.GENERIC_STATUS_SUCCESS:
            raise ExecutionError(f"filesystem snapshot failed: {resp.result.exception}")
        return _Image._new_hydrated(resp.image_id, self.client, resp.image_metadata)

    async def snapshot(self):
        """Full sandbox snapshot (definition + filesystem) restorable with
        `Sandbox.from_snapshot` (reference sandbox.py:2157
        _experimental_snapshot; the local backend restores by re-running the
        entrypoint over the snapshotted filesystem — no process checkpoint)."""
        from .snapshot import _SandboxSnapshot

        resp = await retry_transient_errors(
            self.client.stub.SandboxSnapshot,
            api_pb2.SandboxSnapshotRequest(sandbox_id=self.object_id),
        )
        return _SandboxSnapshot._new_hydrated(resp.snapshot_id, self.client, None)

    # reference-parity alias (sandbox.py:2157)
    _experimental_snapshot = snapshot

    @staticmethod
    async def from_snapshot(snapshot: Any, name: str = "", client: Optional[_Client] = None) -> "_Sandbox":
        """Recreate a sandbox from a snapshot (reference
        Sandbox._experimental_from_snapshot)."""
        if client is None:
            client = await _Client.from_env()
        snapshot_id = snapshot if isinstance(snapshot, str) else snapshot.object_id
        resp = await retry_transient_errors(
            client.stub.SandboxRestore,
            api_pb2.SandboxRestoreRequest(snapshot_id=snapshot_id, name=name),
        )
        return _Sandbox._new_hydrated(resp.sandbox_id, client, None)

    async def terminate(self) -> None:
        await retry_transient_errors(
            self.client.stub.SandboxTerminate, api_pb2.SandboxTerminateRequest(sandbox_id=self.object_id)
        )

    @staticmethod
    async def list(*, app_id: str = "", client: Optional[_Client] = None) -> list[api_pb2.SandboxInfo]:
        if client is None:
            client = await _Client.from_env()
        resp = await retry_transient_errors(
            client.stub.SandboxList, api_pb2.SandboxListRequest(app_id=app_id)
        )
        return list(resp.sandboxes)


class Probe:
    """Sandbox readiness probe (reference sandbox.py:256): `wait_until_ready`
    blocks until the probe command exits 0 inside the sandbox."""

    def __init__(self, exec_command: Sequence[str], period_secs: float = 0.0, timeout_secs: float = 0.0):
        if not exec_command:
            raise InvalidError("probe needs a command")
        self.exec_command = list(exec_command)
        self.period_secs = period_secs
        self.timeout_secs = timeout_secs

    @staticmethod
    def with_exec(*args: str, period_secs: float = 0.0, timeout_secs: float = 0.0) -> "Probe":
        return Probe(list(args), period_secs, timeout_secs)

    @staticmethod
    def with_tcp(port: int, period_secs: float = 0.0, timeout_secs: float = 0.0) -> "Probe":
        """Ready when the sandbox-local TCP port accepts connections."""
        check = (
            "import socket; s=socket.socket(); s.settimeout(1); "
            f"s.connect(('127.0.0.1', {int(port)})); s.close()"
        )
        # "python3", not sys.executable: the probe runs on the WORKER host,
        # where the client's interpreter path may not exist
        return Probe(["python3", "-c", check], period_secs, timeout_secs)


class _SidecarContainer:
    """Handle for one sidecar (reference _SidecarContainer, sandbox.py:2680)."""

    def __init__(self, sandbox: "_Sandbox", name: str):
        self._sandbox = sandbox
        self.name = name

    async def poll(self) -> Optional[int]:
        """None while running, else the sidecar's exit code."""
        resp = await retry_transient_errors(
            self._sandbox.client.stub.SandboxSidecarList,
            api_pb2.SandboxSidecarListRequest(sandbox_id=self._sandbox.object_id),
        )
        for sc in resp.sidecars:
            if sc.name == self.name:
                return None if sc.running else sc.returncode
        raise NotFoundError(f"sidecar {self.name!r} not found")

    async def wait(self, timeout: float = 60.0) -> int:
        import time as _time

        deadline = _time.monotonic() + timeout
        while True:
            code = await self.poll()
            if code is not None:
                return code
            if _time.monotonic() >= deadline:
                raise TimeoutError(f"sidecar {self.name!r} still running after {timeout}s")
            await asyncio.sleep(0.2)

    async def stop(self) -> None:
        await retry_transient_errors(
            self._sandbox.client.stub.SandboxSidecarStop,
            api_pb2.SandboxSidecarStopRequest(sandbox_id=self._sandbox.object_id, name=self.name),
        )


class _SidecarManager:
    """Create/get/list sidecars of a sandbox (reference _SidecarManager,
    sandbox.py:2752)."""

    def __init__(self, sandbox: "_Sandbox"):
        self._sandbox = sandbox

    async def create(
        self,
        *args: str,
        name: str,
        image: Optional[Any] = None,
        env: Optional[dict[str, str]] = None,
    ) -> _SidecarContainer:
        if not args:
            raise InvalidError("sidecar needs a command")
        if name == "main":
            raise InvalidError("the name 'main' is reserved for the sandbox's main container")
        image_id = ""
        if image is not None:
            await image.hydrate(self._sandbox.client)
            image_id = image.object_id
        await retry_transient_errors(
            self._sandbox.client.stub.SandboxSidecarCreate,
            api_pb2.SandboxSidecarCreateRequest(
                sandbox_id=self._sandbox.object_id,
                sidecar=api_pb2.SandboxSidecar(
                    name=name, entrypoint_args=list(args), env=env or {}, image_id=image_id
                ),
            ),
        )
        return _SidecarContainer(self._sandbox, name)

    async def get(self, *, name: str) -> _SidecarContainer:
        resp = await retry_transient_errors(
            self._sandbox.client.stub.SandboxSidecarList,
            api_pb2.SandboxSidecarListRequest(sandbox_id=self._sandbox.object_id),
        )
        if not any(sc.name == name for sc in resp.sidecars):
            raise NotFoundError(f"sidecar {name!r} not found")
        return _SidecarContainer(self._sandbox, name)

    async def list(self) -> list[api_pb2.SandboxSidecar]:
        resp = await retry_transient_errors(
            self._sandbox.client.stub.SandboxSidecarList,
            api_pb2.SandboxSidecarListRequest(sandbox_id=self._sandbox.object_id),
        )
        return list(resp.sidecars)


Sandbox = synchronize_api(_Sandbox)
StreamReader = synchronize_api(_StreamReader)
StreamWriter = synchronize_api(_StreamWriter)
SidecarManager = synchronize_api(_SidecarManager)
SidecarContainer = synchronize_api(_SidecarContainer)
