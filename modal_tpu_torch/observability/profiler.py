"""Low-overhead in-process sampling profiler.

No native dependencies, no signals: a daemon thread wakes at the sampling
interval, walks ``sys._current_frames()`` for every thread and accumulates
folded stacks (``mod.fn;mod.fn2 <count>``, the flamegraph interchange
format). Sampling every thread on the wall clock shows event loops,
synchronizer threads and user threads alike; the sampler skips itself.
This is the JAX package's profiler (modal_tpu/observability/profiler.py).

Every wake preempts whatever holds the GIL: DEFAULT_HZ below says what that
costs and why it is 19.

Output: ``<out_dir>/profile-<pid>-<tag>.folded``, rewritten atomically every
``FLUSH_INTERVAL_S`` while running and on stop, so a live container's
profile can be read without stopping it.

Control surfaces (all reach the module singleton):

- env: ``MODAL_TPU_PROFILE=1`` (or ``=<hz>``) starts the profiler at process
  boot (supervisor start, container entrypoint); ``MODAL_TPU_PROFILE_DIR``
  overrides the sink (the worker exports it to each container).
- RPC: ``ProfileControl{start|stop|status}`` toggles the supervisor's
  profiler and reaches live containers through
  ``ContainerHeartbeatResponse.profile_command``.

A function's ``runtime_debug=True`` profile is another tool: torch.profiler
around each input (runtime/container_entrypoint.py).
"""


from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from typing import Optional

# In-process sampling pays a GIL-handoff toll per wake (the sampler thread
# preempts whatever holds the GIL). On the JAX package's no-op dispatch
# loop, ~100 Hz cost ~50% of wall time while ~20 Hz was indistinguishable
# from off; 19 (prime, so it does not phase-lock with periodic work) is the
# default. A start command can ask for another rate ("start:<hz>").
DEFAULT_HZ = 19.0
FLUSH_INTERVAL_S = 2.0
PROFILE_ENV = "MODAL_TPU_PROFILE"
PROFILE_DIR_ENV = "MODAL_TPU_PROFILE_DIR"


class SamplingProfiler:
    """One sampler thread aggregating folded stacks for the whole process."""

    def __init__(self, out_dir: str, tag: str = "proc", hz: float = DEFAULT_HZ):
        self.out_dir = out_dir
        self.tag = tag
        self.hz = max(1.0, min(float(hz or DEFAULT_HZ), 1000.0))
        self.n_samples = 0
        self.started_at = 0.0
        self._stacks: dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_flush = 0.0

    @property
    def path(self) -> str:
        return os.path.join(self.out_dir, f"profile-{os.getpid()}-{self.tag}.folded")

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running:
            return
        os.makedirs(self.out_dir, exist_ok=True)
        self.started_at = time.time()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="modal-tpu-profiler", daemon=True
        )
        self._thread.start()

    def stop(self) -> str:
        """Stop sampling and write the final folded file; returns its path."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None
        self.flush()
        return self.path

    def _run(self) -> None:
        interval = 1.0 / self.hz
        me = threading.get_ident()
        while not self._stop.wait(interval):
            self._sample(me)
            if time.monotonic() - self._last_flush >= FLUSH_INTERVAL_S:
                try:
                    self.flush()
                except OSError:
                    pass

    def _sample(self, skip_ident: int) -> None:
        frames = sys._current_frames()
        try:
            from .catalog import PROFILER_SAMPLES

            PROFILER_SAMPLES.inc()
        except Exception:  # noqa: BLE001 — metrics must never break sampling
            pass
        with self._lock:
            self.n_samples += 1
            for ident, frame in frames.items():
                if ident == skip_ident:
                    continue
                stack: list[str] = []
                depth = 0
                while frame is not None and depth < 128:
                    code = frame.f_code
                    mod = code.co_filename.rsplit(os.sep, 1)[-1]
                    stack.append(f"{mod}:{code.co_name}")
                    frame = frame.f_back
                    depth += 1
                if not stack:
                    continue
                key = ";".join(reversed(stack))
                self._stacks[key] = self._stacks.get(key, 0) + 1

    def flush(self) -> None:
        """Atomically rewrite the folded file with the current aggregate."""
        self._last_flush = time.monotonic()
        with self._lock:
            lines = [f"{stack} {count}\n" for stack, count in sorted(self._stacks.items())]
        tmp = self.path + ".tmp"
        os.makedirs(self.out_dir, exist_ok=True)
        with open(tmp, "w") as f:
            f.writelines(lines)
        os.replace(tmp, self.path)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._stacks)


# -- module singleton (one profiler per process) ------------------------------

_profiler: Optional[SamplingProfiler] = None
_singleton_lock = threading.Lock()


def current() -> Optional[SamplingProfiler]:
    return _profiler


def running() -> bool:
    return _profiler is not None and _profiler.running


def start(out_dir: str, tag: str = "proc", hz: float = DEFAULT_HZ) -> SamplingProfiler:
    """Start (or return) the process profiler. Idempotent: a second start
    with the same sink and hz is a no-op; a different hz restarts the
    sampler keeping the accumulated stacks; a different out_dir/tag flushes
    the old profiler and starts a fresh one there — an env-booted profiler
    must not silently swallow a ProfileControl/CLI start that points at the
    state dir `profile show` actually reads."""
    global _profiler
    with _singleton_lock:
        hz_n = max(1.0, min(float(hz or DEFAULT_HZ), 1000.0))
        if _profiler is not None and (_profiler.out_dir != out_dir or _profiler.tag != tag):
            _profiler.stop()
            _profiler = None
        if _profiler is not None and _profiler.running:
            if abs(_profiler.hz - hz_n) < 1e-9:
                return _profiler
            _profiler.stop()
        if _profiler is None:
            _profiler = SamplingProfiler(out_dir, tag=tag, hz=hz_n)
        else:
            _profiler.hz = hz_n
        _profiler.start()
        try:
            from .catalog import PROFILER_RUNNING

            PROFILER_RUNNING.set(1.0)
        except Exception:  # noqa: BLE001 — metrics must never break profiling
            pass
        return _profiler


def stop() -> Optional[str]:
    """Stop the process profiler; returns the folded file path (or None)."""
    with _singleton_lock:
        if _profiler is None:
            return None
        path = _profiler.stop()
        try:
            from .catalog import PROFILER_RUNNING, PROFILER_SAMPLES

            PROFILER_RUNNING.set(0.0)
            PROFILER_SAMPLES.inc(0)  # family renders even when start was env-less
        except Exception:  # noqa: BLE001
            pass
        return path


def apply_command(command: str, out_dir: str, tag: str = "proc") -> None:
    """Apply a control-plane profile command (``start[:hz]`` / ``stop``) —
    the ContainerHeartbeatResponse.profile_command carrier. Idempotent, so
    the supervisor can repeat the current command on every heartbeat."""
    if not command or not out_dir:
        return
    if command == "stop":
        stop()
        return
    if command.startswith("start"):
        _, _, hz_s = command.partition(":")
        try:
            hz = float(hz_s) if hz_s else DEFAULT_HZ
        except ValueError:
            hz = DEFAULT_HZ
        start(out_dir, tag=tag, hz=hz)


def maybe_start_from_env(default_dir: str, tag: str) -> bool:
    """Boot hook: ``MODAL_TPU_PROFILE=1`` (or ``=<hz>``) starts the profiler
    with the sink from ``MODAL_TPU_PROFILE_DIR`` (else `default_dir`)."""
    raw = os.environ.get(PROFILE_ENV, "").strip().lower()
    if not raw or raw in ("0", "false", "no", "off"):
        return False
    try:
        hz = float(raw)
        if hz <= 0:  # "0.0" and negatives mean OFF, like "0"
            return False
        if hz == 1.0:  # "1" means "on at the default rate" (boolean-ish)
            hz = DEFAULT_HZ
        # other sub-default values pass through: an operator asking for 2 Hz
        # gets 2 Hz (SamplingProfiler clamps to its 1 Hz floor), never a
        # silent jump to the 19 Hz default
    except ValueError:
        # non-numeric: only explicit truthy tokens enable — "False"/"OFF"
        # style spellings must never start a sampler the operator asked off
        if raw not in ("true", "yes", "on"):
            return False
        hz = DEFAULT_HZ
    out_dir = os.environ.get(PROFILE_DIR_ENV) or default_dir
    if not out_dir:
        return False
    try:
        start(out_dir, tag=tag, hz=hz)
    except OSError:
        return False
    return True


def _shutdown() -> None:
    try:
        if _profiler is not None and _profiler.running:
            _profiler.stop()
    except Exception:  # noqa: BLE001 — atexit must never raise
        pass


atexit.register(_shutdown)


# -- folded-stack readers (ProfileControl's listing, tests) ---------------------


def read_folded(path: str) -> dict[str, int]:
    """Parse one folded-stack file into {stack: count}; torn lines skipped."""
    stacks: dict[str, int] = {}
    try:
        with open(path) as f:
            for line in f:
                stack, _, count_s = line.rstrip("\n").rpartition(" ")
                if not stack:
                    continue
                try:
                    stacks[stack] = stacks.get(stack, 0) + int(count_s)
                except ValueError:
                    continue
    except OSError:
        pass
    return stacks


def merge_folded(paths: list[str]) -> dict[str, int]:
    merged: dict[str, int] = {}
    for p in paths:
        for stack, count in read_folded(p).items():
            merged[stack] = merged.get(stack, 0) + count
    return merged


def list_profiles(out_dir: str) -> list[str]:
    try:
        names = sorted(os.listdir(out_dir))
    except OSError:
        return []
    return [
        os.path.join(out_dir, n)
        for n in names
        if n.startswith("profile-") and n.endswith(".folded")
    ]


def top_table(stacks: dict[str, int], top: int = 20) -> list[dict]:
    """Per-frame roll-up of folded stacks: ``self`` = samples where the frame
    is the leaf, ``cum`` = samples where it appears anywhere (counted once
    per stack even if recursion repeats it)."""
    total = sum(stacks.values()) or 1
    self_counts: dict[str, int] = {}
    cum_counts: dict[str, int] = {}
    for stack, count in stacks.items():
        frames = stack.split(";")
        self_counts[frames[-1]] = self_counts.get(frames[-1], 0) + count
        for frame in set(frames):
            cum_counts[frame] = cum_counts.get(frame, 0) + count
    rows = [
        {
            "frame": frame,
            "self": self_counts.get(frame, 0),
            "cum": cum,
            "self_pct": 100.0 * self_counts.get(frame, 0) / total,
            "cum_pct": 100.0 * cum / total,
        }
        for frame, cum in cum_counts.items()
    ]
    rows.sort(key=lambda r: (-r["self"], -r["cum"], r["frame"]))
    return rows[: max(1, top)]
