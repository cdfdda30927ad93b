"""The warm pool: pre-forked parked interpreters that take placements by
handoff (port of modal_tpu/server/warm_pool.py).

A container's boot pays `import torch` (several seconds on a card host)
before its first input. The pool removes that term: the worker keeps booted
interpreters (the port imported, torch pre-imported, the per-task and
pinning variables scrubbed, no CUDA context) parked and long-polling the
worker's task router for their next `ContainerArguments`. A placement that
matches a parked interpreter is handed off in process (no exec, no import);
anything else falls back to the fresh spawn unchanged.

Protocol (over the worker's task router, server/task_router.py):

    parked proc --- PoolAwaitArguments(pool_id, token, generation) --->
                <-- PoolAwaitResponse{args_path, env delta, handoff_id} ---
    parked proc --- PoolAdoptAck(handoff_id) ---------------------------->
    parked proc runs main_async() ... reports TaskResult ... re-parks
    parked proc --- PoolAwaitArguments(generation+1) -------------------->

The ack is the commit point: the worker treats the placement as adopted
only once the interpreter confirms delivery. A parked process killed
mid-handoff never acks; the adoption times out fast
(`MODAL_TPU_WARM_POOL_ACK_TIMEOUT`) and `WorkerAgent._run_task` spawns
fresh: a warm pool can make a cold start faster, never less reliable.

What a CUDA process changes (ROADMAP Queue C 28): the card pinning
(`CUDA_VISIBLE_DEVICES`) and the kernels' build directory and fleet-cache
coordinates arrive in the adoption's env delta, never in the spawn's
environment, and they take effect because nothing in a parked interpreter
initializes CUDA. A placement that did initialize CUDA leaves a context, a
pinned card and cached allocator blocks behind, so that interpreter exits
after it instead of re-parking, as a crashed placement does; the pool then
pre-forks a fresh one. An interpreter whose placements never touched CUDA
re-parks under the same pid.

Sizing: a baseline pool for the host's own environment from
`MODAL_TPU_WARM_POOL`; the scheduler adds per-image pools (`PoolDirective`
on the worker's poll stream) from `min_containers` / `buffer_containers`,
and a target of 0 evicts. Each image has its own pool key, as in the JAX
package: its interpreters run the image's python with the image's env
(server/image_builder.py), and only that image's placements adopt them. A
trivial chain (the worker's own environment) maps to `HOST_KEY`.

Park-time kernel warm-up: with `MODAL_TPU_AOT_LOWER` set, a parked
interpreter builds, or fetches from the fleet store, the libraries of its
entries' kernels (runtime/aot.py) into the build directory its placements
will use: the image's own (a prewarmed image's `<rootfs>/cache/kernels`)
or the pool's `<state_dir>/pool/kernels`, whose libraries reach a placement
through the fleet store, and loads them into the interpreter. The
coordinates ride `POOL_BUILD_ENV`, applied only while the warm-up runs;
loading a library makes no CUDA context (runtime/container_entrypoint.py,
ROADMAP Queue C 28).
"""

from __future__ import annotations

import asyncio
import json
import os
import secrets
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

from ..config import config, logger
from ..observability.catalog import (
    WARM_POOL_EVICTIONS,
    WARM_POOL_HANDOFF_SECONDS,
    WARM_POOL_PLACEMENTS,
    WARM_POOL_SIZE,
)
from ..proto import api_pb2

# park long-poll window served by the router (client asks; server caps)
AWAIT_POLL_CAP_S = 55.0
# reserved env key carrying the task working directory through the env delta
POOL_CWD_ENV = "MODAL_TPU_POOL_CWD"
# what a parked interpreter's environment never holds: the card pinning and
# the per-task kernel build dir and fleet-cache coordinates come with the
# adoption (container_entrypoint._CLUSTER_ENV_SCRUB removes them again)
SPAWN_ENV_DROP = (
    "CUDA_VISIBLE_DEVICES",
    "CUDA_DEVICE_ORDER",
    "TORCH_EXTENSIONS_DIR",
    "MODAL_TPU_COMPILE_CACHE_DIR",
    "MODAL_TPU_COMPILE_CACHE_URL",
)

_EVICT = object()  # handoff-queue sentinel: exit instead of parking again
# the key of the worker's own environment: a placement without an image, or
# whose chain is trivial. The card pinning is applied at adoption, since
# nothing reads it while parked
HOST_KEY = ""
# the park-time warm-up's build dir and fleet coordinates (JSON), applied
# only while it runs: a parked interpreter's environment holds none of them
POOL_BUILD_ENV = "MODAL_TPU_POOL_BUILD_ENV"


@dataclass
class PoolEntry:
    pool_id: str
    key: str  # what placements must match: the image ("" = the host's own environment)
    token: str
    proc: asyncio.subprocess.Process
    spawn_env: dict[str, str]
    stdout_path: str
    stderr_path: str
    python_bin: str = ""  # the interpreter it runs: the image's python, or the worker's
    created_at: float = field(default_factory=time.time)
    state: str = "booting"  # booting -> parked -> adopting -> serving (-> parked ...) -> dead
    generation: int = 0  # placements completed by this interpreter
    task_id: str = ""
    # handoff plumbing
    handoff_q: asyncio.Queue = field(default_factory=lambda: asyncio.Queue(maxsize=1))
    pending_handoff_id: str = ""
    ack_evt: asyncio.Event = field(default_factory=asyncio.Event)
    dead_evt: asyncio.Event = field(default_factory=asyncio.Event)
    # resolved ("reparked", 0) when the interpreter polls the next generation,
    # ("exited", rc) when the process ends while serving
    task_done: Optional[asyncio.Future] = None
    evicting: bool = False

    @property
    def alive(self) -> bool:
        return self.proc.returncode is None and not self.dead_evt.is_set()


class WarmPool:
    """Owns the parked interpreters of one WorkerAgent."""

    MAX_BOOT_STRIKES = 3

    def __init__(self, worker):
        self.worker = worker
        self.state_dir = worker.state_dir
        self.pool_dir = os.path.join(self.state_dir, "pool")
        os.makedirs(self.pool_dir, exist_ok=True)
        # sizing inputs: a baseline pool from config plus the scheduler's
        # directives (image_id -> target); `targets` (key -> target) is
        # recomputed in _ensure
        self.baseline = int(config["warm_pool"] or 0)
        self.directives: dict[str, int] = {}
        self.targets: dict[str, int] = {}
        self._image_keys: dict[str, str] = {}  # image_id -> its pool key
        self.entries: dict[str, PoolEntry] = {}
        self._watchers: set[asyncio.Task] = set()
        self._stopped = False
        self._draining = False
        self._seq = 0
        # serializes _ensure: concurrent runs (directive bursts, watcher
        # respawns) would both count the same deficit across their awaits and
        # double-spawn
        self._ensure_lock = asyncio.Lock()
        # crash-loop guard: an interpreter that dies while still booting
        # strikes its key; three strikes disable the key instead of
        # fork-looping a broken configuration
        self._boot_strikes: dict[str, int] = {}

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        await self._ensure()

    def ready_count(self) -> int:
        return sum(1 for e in self.entries.values() if e.state == "parked" and e.alive)

    def _gauge(self) -> None:
        counts = {"booting": 0, "parked": 0, "serving": 0}
        for e in self.entries.values():
            if e.state == "booting":
                counts["booting"] += 1
            elif e.state == "parked":
                counts["parked"] += 1
            elif e.state in ("adopting", "serving"):
                counts["serving"] += 1
        for state, n in counts.items():
            WARM_POOL_SIZE.set(float(n), state=state)

    async def wait_parked(self, n: int = 1, timeout: float = 60.0) -> bool:
        """Block until `n` interpreters are parked (tests and chip runs: the
        measured placement must actually go through the pool)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.ready_count() >= n:
                return True
            await asyncio.sleep(0.05)
        return self.ready_count() >= n

    def set_directive(self, image_id: str, target: int) -> None:
        """Scheduler-driven sizing (PoolDirective). Target 0 removes the pool
        for that image: its parked interpreters are evicted."""
        current = self.directives.get(image_id, 0)
        if current == target:
            return
        logger.debug(f"warm pool directive: image {image_id!r} target {current} -> {target}")
        if target <= 0:
            self.directives.pop(image_id, None)
        else:
            self.directives[image_id] = target
        self._track(asyncio.create_task(self._ensure()))

    def _track(self, task: asyncio.Task) -> None:
        self._watchers.add(task)
        task.add_done_callback(self._watchers.discard)

    async def _ensure(self) -> None:
        """Converge the entries to the targets: spawn deficits, evict surplus
        and stale-key parked interpreters (newest first, so a re-parked
        veteran keeps serving successive placements from the same pid)."""
        if self._stopped or self._draining:
            return
        # single-flight by design: concurrent converge ticks would double-spawn
        async with self._ensure_lock:  # lint: disable=lock-across-await
            await self._ensure_locked()

    async def _effective_key(self, image_id: str) -> str:
        """The pool key of an image's placements: a chain that materializes
        to the worker's own environment (trivial) collapses onto HOST_KEY.
        Builds the image on first use (raises ImageBuildError)."""
        if not image_id:
            return HOST_KEY
        if image_id not in self._image_keys:
            built = await self.worker._materialize_image(image_id)
            self._image_keys[image_id] = HOST_KEY if built is None else image_id
        return self._image_keys[image_id]

    async def _ensure_locked(self) -> None:
        if self._stopped or self._draining:
            return
        targets: dict[str, int] = {}
        if self.baseline > 0:
            targets[HOST_KEY] = self.baseline
        for image_id, target in dict(self.directives).items():
            try:
                key = await self._effective_key(image_id)
            except Exception as exc:  # noqa: BLE001 — an unbuildable image gets no pool
                logger.warning(f"warm pool directive for {image_id!r} dropped: {exc}")
                self.directives.pop(image_id, None)
                continue
            targets[key] = max(targets.get(key, 0), target)
        for key in [k for k in targets if self._boot_strikes.get(k, 0) >= self.MAX_BOOT_STRIKES]:
            del targets[key]
        self.targets = targets
        resident_states = ("booting", "parked", "serving", "adopting")
        by_key: dict[str, list[PoolEntry]] = {}
        for e in list(self.entries.values()):
            if e.alive:
                by_key.setdefault(e.key, []).append(e)
        for key, group in by_key.items():
            target = self.targets.get(key, 0)
            group.sort(key=lambda e: e.created_at)
            resident = [e for e in group if e.state in resident_states]
            surplus = len(resident) - target
            for e in reversed(resident):  # newest first
                if surplus <= 0:
                    break
                if e.state in ("serving", "adopting"):
                    continue  # never yank a serving interpreter; it re-parks and is re-checked
                self._evict(e, "image_change" if target == 0 else "target_shrunk")
                surplus -= 1
        for key, target in self.targets.items():
            have = sum(1 for e in self.entries.values() if e.alive and e.key == key and e.state in resident_states)
            for _ in range(max(0, target - have)):
                try:
                    await self._spawn(key)
                except Exception as exc:  # noqa: BLE001 — the pool is best-effort
                    logger.warning(f"warm pool spawn failed for {key!r}: {exc}")
                    break
        self._gauge()

    def _evict(self, entry: PoolEntry, reason: str) -> None:
        if entry.evicting or not entry.alive:
            return
        entry.evicting = True
        WARM_POOL_EVICTIONS.inc(reason=reason)
        logger.debug(f"warm pool evicting {entry.pool_id} ({reason})")
        try:
            entry.handoff_q.put_nowait(_EVICT)  # graceful: exit at the next poll
        except asyncio.QueueFull:
            pass

        async def _escalate(e=entry) -> None:
            try:
                await asyncio.wait_for(e.proc.wait(), timeout=10.0)
            except asyncio.TimeoutError:
                try:
                    e.proc.kill()
                except ProcessLookupError:
                    pass

        self._track(asyncio.create_task(_escalate()))

    def spawn_env(self, pool_id: str, token: str, built=None) -> dict[str, str]:
        """A parked interpreter's environment: the worker's and its image's,
        without the card pinning and the per-task build and cache variables,
        plus the pool's coordinates, the park-time warm-up's build dir and
        fleet coordinates (`POOL_BUILD_ENV`) and the repo on the path."""
        env = dict(os.environ)
        if built is not None:
            built.launch_env(env)
        # <pool_dir>/kernels and the fleet, unless the worker's or the image's
        # env names them, as a placement's env (WorkerAgent.container_env) does
        build_env = self.worker._compile_cache_env(self.pool_dir)
        build_env.update({k: env[k] for k in build_env if env.get(k)})
        env = {k: v for k, v in env.items() if k not in SPAWN_ENV_DROP}
        env[POOL_BUILD_ENV] = json.dumps(build_env)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env["MODAL_TPU_SERVER_URL"] = self.worker.server_url
        env["MODAL_TPU_POOL_ID"] = pool_id
        env["MODAL_TPU_POOL_TOKEN"] = token
        env["MODAL_TPU_POOL_ROUTER"] = self.worker.router_address
        from ..observability import tracing

        if tracing.trace_dir():
            env[tracing.TRACE_DIR_ENV] = tracing.trace_dir()
        return env

    async def _spawn(self, key: str) -> PoolEntry:
        self._seq += 1
        pool_id = f"pw-{os.getpid()}-{self._seq}"
        token = secrets.token_urlsafe(24)
        # an image's interpreter runs its python (built already: the key
        # came from _effective_key)
        built = await self.worker._materialize_image(key) if key != HOST_KEY else None
        python_bin = built.python_bin if built is not None else sys.executable
        env = self.spawn_env(pool_id, token, built)
        stdout_path = os.path.join(self.pool_dir, f"{pool_id}.out")
        stderr_path = os.path.join(self.pool_dir, f"{pool_id}.err")
        # fork+exec of a fresh interpreter, never a bare fork of this process
        with open(stdout_path, "wb") as out_f, open(stderr_path, "wb") as err_f:
            proc = await asyncio.create_subprocess_exec(
                python_bin, "-u", "-m", "modal_tpu_torch.runtime.container_entrypoint",
                env=env, stdout=out_f, stderr=err_f,
            )
        entry = PoolEntry(pool_id=pool_id, key=key, token=token, proc=proc, python_bin=python_bin, spawn_env=env,
                          stdout_path=stdout_path, stderr_path=stderr_path)
        self.entries[pool_id] = entry
        self._track(asyncio.create_task(self._watch(entry), name=f"pool-watch-{pool_id}"))
        logger.debug(f"warm pool spawned {pool_id} (key={key!r}, pid={proc.pid})")
        self._gauge()
        return entry

    async def _watch(self, entry: PoolEntry) -> None:
        rc = await entry.proc.wait()
        entry.dead_evt.set()
        was = entry.state
        entry.state = "dead"
        if entry.task_done is not None and not entry.task_done.done():
            entry.task_done.set_result(("exited", rc))
        self.entries.pop(entry.pool_id, None)
        if not entry.evicting and was != "serving":
            WARM_POOL_EVICTIONS.inc(reason="died")
            logger.warning(f"warm pool interpreter {entry.pool_id} died rc={rc} while {was}")
            if was == "booting":
                # died before ever parking: strike the key; _ensure disables
                # it at MAX_BOOT_STRIKES
                strikes = self._boot_strikes.get(entry.key, 0) + 1
                self._boot_strikes[entry.key] = strikes
                if strikes >= self.MAX_BOOT_STRIKES:
                    logger.error(f"warm pool key {entry.key!r} disabled after {strikes} boot failures (last "
                                 f"rc={rc}); placements spawn fresh; see {entry.stderr_path}")
        self._gauge()
        if not self._stopped and not self._draining:
            await self._ensure()

    # -- router-side protocol (called by TaskRouterServicer) ------------------

    def entry_for(self, pool_id: str, token: str) -> Optional[PoolEntry]:
        entry = self.entries.get(pool_id)
        if entry is None or not secrets.compare_digest(entry.token, token):
            return None
        return entry

    def note_parked(self, entry: PoolEntry, generation: int) -> None:
        """The interpreter is at its PoolAwaitArguments long-poll: booting is
        over, and a poll with an advanced generation means the previous
        placement finished (the re-park)."""
        if entry.state == "serving" and generation > entry.generation:
            entry.generation = generation
            entry.task_id = ""
            entry.state = "parked"
            if entry.task_done is not None and not entry.task_done.done():
                entry.task_done.set_result(("reparked", 0))
            logger.debug(f"warm pool {entry.pool_id} re-parked (generation {generation})")
        elif entry.state == "booting":
            entry.state = "parked"
            self._boot_strikes.pop(entry.key, None)  # a healthy boot clears the strikes
            logger.debug(f"warm pool {entry.pool_id} parked (pid {entry.proc.pid})")
        self._gauge()

    # -- adoption --------------------------------------------------------------

    async def adopt(
        self, image_id: str, task_env: dict[str, str], task_id: str, args_path: str, cwd: str = ""
    ) -> Optional[PoolEntry]:
        """Hand a placement to a parked interpreter of its image (`image_id`,
        "" for the worker's own environment). Returns the serving entry once
        the interpreter acked delivery, or None (the caller spawns fresh).
        Never raises. `task_env` is the container's whole environment: keys
        of the spawn's environment it lacks are unset."""
        if self._stopped or self._draining:
            return None
        key = image_id or HOST_KEY
        parked = sorted((e for e in self.entries.values() if e.state == "parked" and e.alive),
                        key=lambda e: e.created_at)
        candidates = [e for e in parked if e.key == key]
        if not candidates:
            WARM_POOL_PLACEMENTS.inc(outcome="miss_key" if parked else "miss_empty")
            return None
        entry = candidates[0]
        entry.state = "adopting"
        entry.task_id = task_id
        handoff_id = secrets.token_urlsafe(12)
        entry.pending_handoff_id = handoff_id
        entry.ack_evt = asyncio.Event()
        entry.task_done = asyncio.get_running_loop().create_future()
        env_set = dict(task_env)
        if cwd:
            env_set[POOL_CWD_ENV] = cwd
        payload = api_pb2.PoolAwaitResponse(
            has_task=True,
            task_id=task_id,
            args_path=args_path,
            env_set_json=json.dumps(env_set),
            env_unset=[k for k in entry.spawn_env if k not in env_set],
            handoff_id=handoff_id,
        )
        t0 = time.monotonic()
        try:
            entry.handoff_q.put_nowait(payload)
        except asyncio.QueueFull:
            # an evict sentinel is already queued: this entry is on its way out
            WARM_POOL_PLACEMENTS.inc(outcome="handoff_failed")
            return None
        ack = asyncio.ensure_future(entry.ack_evt.wait())
        died = asyncio.ensure_future(entry.dead_evt.wait())
        try:
            await asyncio.wait({ack, died}, timeout=float(config["warm_pool_ack_timeout"]),
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            ack.cancel()
            died.cancel()
        if not entry.ack_evt.is_set():
            # dead or wedged mid-handoff: drop it and let the caller spawn
            # fresh; _watch() cleans up and respawns
            WARM_POOL_PLACEMENTS.inc(outcome="handoff_failed")
            logger.warning(f"warm pool handoff to {entry.pool_id} failed "
                           f"({'died' if entry.dead_evt.is_set() else 'ack timeout'}); spawning fresh")
            if entry.alive:
                entry.evicting = True
                try:
                    entry.proc.kill()
                except ProcessLookupError:
                    pass
            if entry.task_done is not None and not entry.task_done.done():
                entry.task_done.cancel()
            return None
        entry.state = "serving"
        WARM_POOL_PLACEMENTS.inc(outcome="hit")
        WARM_POOL_HANDOFF_SECONDS.observe(time.monotonic() - t0)
        self._gauge()
        return entry

    def ack(self, entry: PoolEntry, handoff_id: str) -> bool:
        if entry.pending_handoff_id and secrets.compare_digest(entry.pending_handoff_id, handoff_id):
            entry.ack_evt.set()
            return True
        return False

    # -- teardown --------------------------------------------------------------

    def drain(self) -> None:
        """Preemption: parked interpreters hold no work; evict them all so the
        host can terminate inside its grace window."""
        self._draining = True
        for entry in list(self.entries.values()):
            if entry.state in ("booting", "parked"):
                self._evict(entry, "drain")
        self._gauge()

    def kill_parked(self) -> None:
        """Abrupt host loss takes the parked interpreters with it (serving
        ones are killed through the worker's process map)."""
        for entry in list(self.entries.values()):
            if entry.state in ("booting", "parked") and entry.alive:
                entry.evicting = True
                try:
                    entry.proc.kill()
                except ProcessLookupError:
                    pass

    async def stop(self) -> None:
        self._stopped = True
        for entry in list(self.entries.values()):
            if entry.alive:
                entry.evicting = True
                try:
                    entry.proc.kill()
                except ProcessLookupError:
                    pass
        # let the watchers reap the kills (they resolve task_done futures);
        # cancel stragglers after a bounded wait
        if self._watchers:
            _done, pending = await asyncio.wait(self._watchers, timeout=5.0)
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
        self.entries.clear()
        self._gauge()
