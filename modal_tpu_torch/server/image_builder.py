"""Worker-side image materialization: layer chain → content-addressed venv
(port of modal_tpu/server/image_builder.py).

The reference builds images remotely (the client waits on `ImageGetOrCreate`
→ `ImageJoinStreaming`, reference py/modal/_image.py:426-665); its builder
is a closed server component. This is the local worker backend's: an image
definition chain (each layer one `Image` proto, linked by `FROM
<parent_image_id>`) materializes into

    <state_dir>/images/<chain-sha256>/
        venv/        # python -m venv --system-site-packages + pip layers
        rootfs/      # COPY targets, and a prewarm's kernel libraries
        image.json   # {python_bin, env, workdir, entrypoint} for launch
        build.log

Builds are content-addressed (the same chain hash is reused), built in
place under a per-hash lock (an asyncio lock in process, `flock` across
processes) with image.json written last as the commit marker, and **fail
loudly**: a layer that cannot be honored (an unsupported python version, a
failing RUN, an unreachable index) fails the build, which fails the task
with INIT_FAILURE carrying the build-log tail. No path runs a function in
the worker's own environment when its image failed to build.

Command interpretation (host-venv backend, no docker or chroot):
- `FROM python:X...`      → venv from the host python; its minor version
                            must match the host's (else a loud failure).
- `FROM <im-...>`         → parent layer (resolved into the chain).
- `RUN python -m pip ...` / `RUN pip ...`
                          → run with the venv's python and pip.
- `RUN uv pip install --system ...`
                          → rewritten to the venv's `python -m pip ...`
                            (uv itself is not assumed present).
- `RUN <other>`           → bash -lc under the recorded env and workdir with
                            the venv's bin first on PATH.
- `ENV K=V` / `WORKDIR p` → recorded, applied at container launch.
- `COPY src dst`          → copied under rootfs/<dst>; the container gets
                            MODAL_TPU_IMAGE_ROOT pointing at rootfs.
- `ENTRYPOINT/CMD [...]`  → recorded (a sandbox's default command).
- `#MOUNT_PYTHON_SOURCE`  → no-op on the local backend (the client's
                            filesystem is the worker's).
- `#RUN_FUNCTION`         → build_function_serialized executed with the
                            venv's python at build time (the weight-baking
                            hook, reference _image.py:2175).
- `#PREWARM`              → as #RUN_FUNCTION, with the kernel build dir
                            (`TORCH_EXTENSIONS_DIR`, which `ops/_build`
                            reads) at `<rootfs>/cache/kernels` and recorded
                            as image env: the libraries `nvcc` builds at
                            build time are what every container of the
                            image loads, and they are published to the
                            fleet compile store.

The venv is made with `--system-site-packages --without-pip`, and a `.pth`
file bridges the worker interpreter's site directories into it: on a card
host the worker's python is itself usually a venv, whose torch (with its
`nvidia-*` libraries) the base interpreter's site-packages does not hold.
The image's own site-packages stays first, so a pip layer shadows or
extends the host stack; pip itself comes through the bridge.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import re
import shlex
import shutil
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

from ..config import logger
from ..observability import tracing
from ..proto import api_pb2

# the part of the build log an INIT_FAILURE carries
LOG_TAIL_BYTES = 4000
# a prewarm's kernel libraries, under the image's rootfs
PREWARM_KERNEL_DIR = os.path.join("cache", "kernels")


class ImageBuildError(Exception):
    def __init__(self, message: str, log_tail: str = ""):
        super().__init__(message + (f"\n--- build log tail ---\n{log_tail}" if log_tail else ""))
        self.log_tail = log_tail


@dataclass
class BuiltImage:
    python_bin: str
    env: dict[str, str] = field(default_factory=dict)
    workdir: str = ""
    entrypoint: list[str] = field(default_factory=list)
    cmd: list[str] = field(default_factory=list)
    rootfs: str = ""
    # a snapshot image: the extracted tree a sandbox's workdir is seeded
    # with (Sandbox.snapshot_filesystem round trip)
    fs_seed_dir: str = ""

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @staticmethod
    def from_json(data: str) -> "BuiltImage":
        return BuiltImage(**json.loads(data))

    def launch_env(self, env: dict) -> None:
        """Fold the image into a process environment: its env, its rootfs
        and its venv's bin first on PATH."""
        env.update(self.env)
        env["MODAL_TPU_IMAGE_ROOT"] = self.rootfs
        env["PATH"] = os.path.dirname(self.python_bin) + os.pathsep + env.get("PATH", "")


def _host_minor() -> str:
    return f"{sys.version_info.major}.{sys.version_info.minor}"


def _is_trivial(chain: list[api_pb2.Image]) -> bool:
    """A chain that only pins a matching-python base needs no venv at all:
    the worker's environment is that image. Keeps the zero-layer path free."""
    for image in chain:
        for cmd in image.dockerfile_commands:
            c = cmd.strip()
            if not c or c.startswith("#MOUNT_PYTHON_SOURCE"):
                continue
            if c.startswith("FROM "):
                ref = c[5:].strip()
                if ref.startswith("im-"):
                    continue
                m = re.match(r"python:(\d+\.\d+)", ref)
                if m and m.group(1) == _host_minor():
                    continue
                return False
            return False
        if image.build_function_serialized:
            return False
    return True


def chain_version(chain: list[api_pb2.Image]) -> str:
    """The builder epoch a chain is built under: the newest layer's version
    wins (layers inherit the epoch of the app that created them)."""
    from ..config import config

    for image in reversed(chain):
        if image.version:
            return image.version
    return config["image_builder_version"]


def chain_hash(chain: list[api_pb2.Image]) -> str:
    from .. import builder as builder_epochs

    h = hashlib.sha256()
    for image in chain:
        h.update(image.SerializeToString(deterministic=True))
        h.update(b"\x00")
    # the epoch's pinned content is part of the key: editing an epoch file
    # (or switching epochs) rebuilds every image under it
    try:
        h.update(builder_epochs.epoch_content_hash(chain_version(chain)).encode())
    except builder_epochs.UnknownBuilderVersion:
        pass  # refused loudly at build time; the hash stays total
    return h.hexdigest()[:24]


def runner_script(payload_path: str, pkg_root: str, telemetry_out: str = "") -> str:
    """The script a build function runs in, under the image's python. With
    `telemetry_out` (a #PREWARM layer) it registers the compile listener
    first, so its nvcc runs count as COMPILE_EVENTS{source="prewarm"}
    (MODAL_TPU_PREWARM_BUILD is set in its env), and dumps the counts there
    for the builder to merge into the worker's registry."""
    prelude = epilogue = ""
    if telemetry_out:
        prelude = (
            "try:  # the listener needs torch imported; a torch-less bake skips it\n"
            "    import torch\n"
            "    from modal_tpu_torch.observability import device_telemetry as _dt\n"
            "    _dt.install_compile_hooks()\n"
            "except Exception:\n"
            "    pass\n"
        )
        epilogue = (
            "try:\n"
            "    import json as _json\n"
            "    from modal_tpu_torch.observability.catalog import COMPILE_EVENTS as _ce\n"
            f"    open({telemetry_out!r}, 'w').write(_json.dumps(_ce.snapshot()))\n"
            "except Exception:\n"
            "    pass\n"
        )
    return (
        "import sys\n"
        f"sys.path.insert(0, {pkg_root!r})\n"
        + prelude
        + "from modal_tpu_torch.serialization import deserialize\n"
        f"fn, (args, kwargs) = deserialize(open({payload_path!r}, 'rb').read(), None)\n"
        "fn(*args, **kwargs)\n"
        + epilogue
    )


def _bridge_paths() -> list[str]:
    """The worker interpreter's site directories, in its own order."""
    import sysconfig

    paths = [sysconfig.get_paths()["purelib"], sysconfig.get_paths()["platlib"]]
    paths += [p for p in sys.path if p.rstrip("/").endswith(("site-packages", "dist-packages"))]
    out: list[str] = []
    for p in paths:
        if p and os.path.isdir(p) and p not in out:
            out.append(p)
    return out


_builders: dict[str, "ImageBuilder"] = {}


def get_image_builder(state_dir: str) -> "ImageBuilder":
    """One builder per state dir in this process: every WorkerAgent sharing
    a state dir (a LocalSupervisor's) shares the per-hash build locks."""
    key = os.path.realpath(state_dir)
    if key not in _builders:
        _builders[key] = ImageBuilder(state_dir)
    return _builders[key]


class ImageBuilder:
    """Materializes image chains on one worker host, with caching."""

    def __init__(self, state_dir: str):
        self.images_dir = os.path.join(state_dir, "images")
        os.makedirs(self.images_dir, exist_ok=True)
        # ServerState's fleet compile store: a prewarm publishes its
        # libraries there, so the whole fleet loads what one build built
        self.compile_store_dir = os.path.join(state_dir, "compile_cache")
        self._locks: dict[str, asyncio.Lock] = {}

    async def fetch_chain(self, stub, image_id: str) -> list[api_pb2.Image]:
        """Resolve the FROM-linked layer chain, base first."""
        from .._utils.grpc_utils import retry_transient_errors

        chain: list[api_pb2.Image] = []
        current: Optional[str] = image_id
        for _ in range(64):  # chain-length guard
            if not current:
                break
            resp = await retry_transient_errors(stub.ImageFromId, api_pb2.ImageFromIdRequest(image_id=current))
            chain.append(resp.definition)
            current = None
            for cmd in resp.definition.dockerfile_commands:
                c = cmd.strip()
                if c.startswith("FROM im-"):
                    current = c[5:].strip()
                    break
        chain.reverse()
        return chain

    async def materialize(self, stub, image_id: str, parent=None) -> Optional[BuiltImage]:
        """The built image, or None when the chain is trivial (the worker's
        environment is the image). Raises ImageBuildError on any layer that
        cannot be honored. A build records its parts as `image.build_part`
        spans under `parent` (a task's trace context)."""
        chain = await self.fetch_chain(stub, image_id)
        snapshot_blob_id = next((im.fs_snapshot_blob_id for im in chain if im.fs_snapshot_blob_id), "")
        if snapshot_blob_id:
            return await self._materialize_snapshot(stub, snapshot_blob_id)
        if _is_trivial(chain):
            return None
        key = chain_hash(chain)
        final_dir = os.path.join(self.images_dir, key)
        meta_path = os.path.join(final_dir, "image.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                return BuiltImage.from_json(f.read())
        lock = self._locks.setdefault(key, asyncio.Lock())
        # single-flight by design: one build per image key, waiters reuse it
        async with lock:  # lint: disable=lock-across-await
            # across processes (standalone workers sharing a state dir) the
            # flock serializes the build. It happens IN final_dir, so the
            # venv's paths are right for good, with image.json written LAST
            # as the commit marker; a dir without image.json is a dead build
            import fcntl

            lock_file = open(final_dir + ".lock", "w")
            try:
                await asyncio.to_thread(fcntl.flock, lock_file, fcntl.LOCK_EX)
                if os.path.exists(meta_path):  # built while this one waited
                    with open(meta_path) as f:
                        return BuiltImage.from_json(f.read())
                shutil.rmtree(final_dir, ignore_errors=True)
                os.makedirs(final_dir)
                try:
                    built = await self._build(chain, final_dir, parent)
                    with open(meta_path, "w") as f:
                        f.write(built.to_json())
                    logger.debug(f"image {key} built at {final_dir}")
                    return built
                except Exception:
                    shutil.rmtree(final_dir, ignore_errors=True)
                    raise
            finally:
                fcntl.flock(lock_file, fcntl.LOCK_UN)
                lock_file.close()

    async def _materialize_snapshot(self, stub, blob_id: str) -> BuiltImage:
        """A snapshot image is a filesystem tarball, not a layer build:
        fetched once (content-addressed by blob id) and extracted; a sandbox
        of the image starts on a copy of the tree as its workdir."""
        from .._utils.blob_utils import blob_download
        from .fs_snapshot import untar_dir

        seed_dir = os.path.join(self.images_dir, f"snapshot-{blob_id}")
        marker = os.path.join(seed_dir, ".complete")
        if not os.path.exists(marker):
            lock = self._locks.setdefault(f"snapshot-{blob_id}", asyncio.Lock())
            # single-flight by design: one extraction per blob
            async with lock:  # lint: disable=lock-across-await
                import fcntl

                lock_file = open(seed_dir + ".lock", "w")
                try:
                    await asyncio.to_thread(fcntl.flock, lock_file, fcntl.LOCK_EX)
                    if not os.path.exists(marker):
                        data = await blob_download(blob_id, stub)
                        tmp_dir = f"{seed_dir}.tmp{os.getpid()}"
                        shutil.rmtree(tmp_dir, ignore_errors=True)
                        await untar_dir(bytes(data), tmp_dir)
                        open(os.path.join(tmp_dir, ".complete"), "w").close()
                        shutil.rmtree(seed_dir, ignore_errors=True)
                        os.replace(tmp_dir, seed_dir)
                finally:
                    fcntl.flock(lock_file, fcntl.LOCK_UN)
                    lock_file.close()
        return BuiltImage(python_bin=sys.executable, fs_seed_dir=seed_dir)

    async def _build(self, chain: list[api_pb2.Image], build_dir: str, parent=None) -> BuiltImage:
        venv_dir = os.path.join(build_dir, "venv")
        rootfs = os.path.join(build_dir, "rootfs")
        log_path = os.path.join(build_dir, "build.log")
        os.makedirs(rootfs)
        log_f = open(log_path, "a")
        key = os.path.basename(build_dir)

        def log(line: str) -> None:
            log_f.write(line.rstrip() + "\n")
            log_f.flush()

        def tail() -> str:
            log_f.flush()
            with open(log_path) as f:
                return f.read()[-LOG_TAIL_BYTES:]

        def part(kind: str, t0: float, **attrs) -> None:
            # the build's time by part, for the chip run and the traces
            tracing.record_span("image.build_part", start=t0, end=time.time(), parent=parent,
                                attrs={"image_key": key, "part": kind, **attrs})

        async def run_shell(cmd: str, env: dict[str, str], cwd: str) -> None:
            log(f"$ {cmd}")
            proc = await asyncio.create_subprocess_shell(
                cmd, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT, env=env, cwd=cwd or None,
                executable="/bin/bash",
            )
            out, _ = await proc.communicate()
            log(out.decode(errors="replace"))
            if proc.returncode != 0:
                raise ImageBuildError(f"build command failed (rc={proc.returncode}): {cmd}", tail())

        host = _host_minor()
        built = BuiltImage(python_bin="", rootfs=rootfs)
        from .. import builder as builder_epochs

        try:
            # the builder epoch (reference builder/'s versioned requirement
            # sets): an unknown epoch fails the build loudly; its base-image
            # config seeds the env and bounds the pythons
            epoch = chain_version(chain)
            epoch_cfg = builder_epochs.base_image_config(epoch)  # raises UnknownBuilderVersion
            log(f"builder epoch {epoch} (content {builder_epochs.epoch_content_hash(epoch)})")
            if epoch_cfg["python"] and host not in epoch_cfg["python"]:
                raise ImageBuildError(f"builder epoch {epoch} supports python {epoch_cfg['python']}, host is {host}",
                                      tail())
            built.env.update(epoch_cfg["cuda_env"])
            t0 = time.time()
            log(f"creating venv (python {host}, system-site-packages)")
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "venv", "--system-site-packages", "--without-pip", venv_dir,
                stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT,
            )
            out, _ = await proc.communicate()
            log(out.decode(errors="replace"))
            if proc.returncode != 0:
                raise ImageBuildError("venv creation failed", tail())
            built.python_bin = os.path.join(venv_dir, "bin", "python")
            venv_bin = os.path.join(venv_dir, "bin")
            venv_site = os.path.join(venv_dir, "lib", f"python{host}", "site-packages")
            bridged = _bridge_paths()
            with open(os.path.join(venv_site, "_modal_tpu_host.pth"), "w") as f:
                f.write("".join(p + "\n" for p in bridged))
            log(f"bridged host site directories: {bridged}")
            part("venv", t0)

            def shell_env() -> dict[str, str]:
                env = dict(os.environ)
                env.update(built.env)
                env["PATH"] = venv_bin + os.pathsep + env.get("PATH", "")
                env["VIRTUAL_ENV"] = venv_dir
                env["MODAL_TPU_IMAGE_ROOT"] = rootfs
                env["MODAL_TPU_IMAGE_BUILD"] = "1"
                return env

            for image in chain:
                for raw in image.dockerfile_commands:
                    cmd = raw.strip()
                    # '#'-directives: #MOUNT_PYTHON_SOURCE is a no-op here;
                    # #RUN_FUNCTION and #PREWARM run build_function_serialized
                    # after the command loop
                    if not cmd or cmd.startswith("#"):
                        continue
                    if cmd.startswith("FROM "):
                        ref = cmd[5:].strip()
                        if ref.startswith("im-"):
                            continue  # the parent layer, already in the chain
                        m = re.match(r"python:(\d+\.\d+)", ref)
                        if m is None or m.group(1) != host:
                            raise ImageBuildError(
                                f"cannot honor base {ref!r} on the local worker backend (host python is {host}); "
                                "use a matching python or a registry-capable worker",
                                tail(),
                            )
                        continue
                    if cmd.startswith("ENV "):
                        k, _, v = cmd[4:].partition("=")
                        built.env[k.strip()] = _unquote(v)
                        log(f"ENV {k.strip()}={built.env[k.strip()]}")
                        continue
                    if cmd.startswith("WORKDIR "):
                        wd = cmd[8:].strip()
                        if not os.path.isabs(wd) or not os.path.isdir(wd):
                            # a workdir that does not exist lives under rootfs
                            wd = os.path.join(rootfs, wd.lstrip("/"))
                            os.makedirs(wd, exist_ok=True)
                        built.workdir = wd
                        log(f"WORKDIR {built.workdir}")
                        continue
                    if cmd.startswith("ENTRYPOINT "):
                        built.entrypoint = json.loads(cmd[len("ENTRYPOINT "):])
                        continue
                    if cmd.startswith("CMD "):
                        built.cmd = json.loads(cmd[len("CMD "):])
                        continue
                    if cmd.startswith("COPY "):
                        parts = shlex.split(cmd[5:])
                        if len(parts) != 2:
                            raise ImageBuildError(f"unsupported COPY form: {cmd}", tail())
                        src, dst = parts
                        target = os.path.join(rootfs, dst.lstrip("/"))
                        if not os.path.exists(src):
                            raise ImageBuildError(f"COPY source missing: {src}", tail())
                        os.makedirs(os.path.dirname(target) or rootfs, exist_ok=True)
                        if os.path.isdir(src):
                            shutil.copytree(src, target, dirs_exist_ok=True)
                        else:
                            shutil.copy2(src, target)
                        log(f"COPY {src} -> {target}")
                        continue
                    if cmd.startswith("RUN "):
                        t0 = time.time()
                        shell_cmd = _rewrite_run(cmd[4:].strip(), built.python_bin)
                        # bare package names in pip installs get the epoch pin
                        shell_cmd = builder_epochs.constrain_pip_install(shell_cmd, epoch)
                        await run_shell(shell_cmd, shell_env(), built.workdir)
                        part("run", t0, command=cmd[4:].strip()[:200])
                        continue
                    raise ImageBuildError(f"unsupported image directive: {cmd}", tail())

                if image.build_function_serialized:
                    await self._run_build_function(image, built, run_shell, shell_env, build_dir, part)
            return built
        finally:
            log_f.close()

    async def _run_build_function(self, image, built, run_shell, shell_env, build_dir, part) -> None:
        """Run a run_function()/prewarm() build step with the image's python
        (reference _image.py:2175: bake weights or caches at build time).

        A #PREWARM layer first points the kernel build dir inside the image
        rootfs and records it as image env: every kernel the function builds
        (`nvcc`, through `ops/_build`) is built once at build time, and every
        container of the image loads it from there."""
        prewarm = any(c.strip() == "#PREWARM" for c in image.dockerfile_commands)
        kernel_dir = ""
        if prewarm:
            kernel_dir = os.path.join(built.rootfs, PREWARM_KERNEL_DIR)
            os.makedirs(kernel_dir, exist_ok=True)
            built.env["TORCH_EXTENSIONS_DIR"] = kernel_dir
        payload = os.path.join(build_dir, "build_fn.pkl")
        with open(payload, "wb") as f:
            f.write(image.build_function_serialized)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        telemetry_out = os.path.join(build_dir, "prewarm_compile_events.json") if prewarm else ""
        script = os.path.join(build_dir, "build_fn.py")
        with open(script, "w") as f:
            f.write(runner_script(payload, pkg_root, telemetry_out))
        env = shell_env()
        if prewarm:
            # the build subprocess's env only, never image env: its builds
            # count as source="prewarm", not as serving cost
            env["MODAL_TPU_PREWARM_BUILD"] = "1"
        t0 = time.time()
        await run_shell(f"{shlex.quote(built.python_bin)} {shlex.quote(script)}", env, built.workdir)
        part("prewarm" if prewarm else "run_function", t0)
        if prewarm:
            self._merge_prewarm_compile_events(telemetry_out)
            self._publish_prewarm_cache(kernel_dir)

    def _publish_prewarm_cache(self, kernel_dir: str) -> int:
        """Put the prewarm's libraries into the fleet compile store, under
        the key each one's file name carries (`<kernel>-<key>.so`, the key
        `ops/_build` asks the fleet for), so containers of other images, or
        other hosts over the blob plane, load what this build built. A
        failed publish costs fleet hits, never the build."""
        try:
            from .compile_cache import CompileCacheStore

            store = CompileCacheStore(self.compile_store_dir)
            published = 0
            for name in sorted(os.listdir(kernel_dir)):
                m = re.fullmatch(r"[A-Za-z0-9_]+-(tc-[0-9a-f]+)\.so", name)
                if m is None:
                    continue
                with open(os.path.join(kernel_dir, name), "rb") as f:
                    data = f.read()
                if not store.has(m.group(1)) and store.put_bytes(m.group(1), data):
                    published += 1
            if published:
                logger.info(f"prewarm published {published} kernel libraries to the fleet store")
            return published
        except Exception as exc:  # noqa: BLE001 — never fail a build over cache publishing
            logger.warning(f"prewarm fleet-store publish skipped: {exc}")
            return 0

    @staticmethod
    def _merge_prewarm_compile_events(path: str) -> None:
        """Fold the bake subprocess's compile-event counts into this
        process's registry: GET /metrics then shows what the prewarm built
        (source="prewarm") beside what serving builds at run time. A bake
        without torch writes nothing."""
        from ..observability.catalog import COMPILE_EVENTS

        try:
            with open(path) as f:
                snapshot = json.load(f)
        except (OSError, ValueError):
            return
        for key, count in snapshot.items():
            parts = str(key).split(",")
            if len(parts) != 2:
                continue
            try:
                COMPILE_EVENTS.inc(float(count), event=parts[0], source=parts[1])
            except (TypeError, ValueError):
                continue


def _unquote(v: str) -> str:
    v = v.strip()
    try:
        parts = shlex.split(v)
        return parts[0] if len(parts) == 1 else v
    except ValueError:
        return v


def _rewrite_run(cmd: str, python_bin: str) -> str:
    """Map docker-style RUN commands onto the venv backend."""
    q = shlex.quote(python_bin)
    # uv is not assumed installed; `--system` targets the venv anyway
    cmd = re.sub(r"^uv pip install --system\b", f"{q} -m pip install", cmd)
    cmd = re.sub(r"^uv pip install\b", f"{q} -m pip install", cmd)
    cmd = re.sub(r"^python -m pip\b", f"{q} -m pip", cmd)
    cmd = re.sub(r"^pip install\b", f"{q} -m pip install", cmd)
    cmd = re.sub(r"^python\b", q, cmd)
    return cmd
