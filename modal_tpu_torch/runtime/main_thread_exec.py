"""Main-thread executor for cancellable sync inputs (SIGUSR1 equivalent;
port of modal_tpu/runtime/main_thread_exec.py).

Reference: py/modal/_container_entrypoint.py:194-264 — running *sync* user
code is interrupted by delivering SIGUSR1 and raising InputCancellation
inside the executing frame. The mechanism only works where CPython runs
Python-level signal handlers: the MAIN thread. A sync input parked in
`asyncio.to_thread` is unreachable — `task.cancel()` cancels the awaiting
coroutine but the worker thread keeps running `time.sleep(60)` to completion.

The entrypoint's asyncio
machinery lives on the synchronizer's daemon thread, so this process's main
thread is otherwise idle — exactly the thread where a Python signal handler
CAN raise into running user code. The executor therefore runs ONE sync input
at a time on the main thread (cancellable anywhere, even mid-C-call like
time.sleep — PEP 475 aborts the syscall when the handler raises); overflow
concurrency beyond that first input falls back to `asyncio.to_thread` in the
caller, which matches the reference's thread-spawned concurrency being
equally signal-unreachable.
"""

from __future__ import annotations

import queue
import signal
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..config import logger
from ..exception import InputCancellation


@dataclass
class _Job:
    fn: Callable
    args: tuple
    kwargs: dict
    future: Future = field(default_factory=Future)
    job_id: int = 0
    cancel_requested: bool = False


class MainThreadExecutor:
    """Runs submitted sync callables on the main thread; `cancel()` delivers
    SIGUSR1 → InputCancellation into the currently-executing callable."""

    def __init__(self) -> None:
        self._queue: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._current: Optional[_Job] = None
        self._lock = threading.Lock()
        self._next_id = 1
        self._main_ident = threading.main_thread().ident
        self._running = False
        # submitted-but-unfinished count. idle() keys off this, NOT _current:
        # between the run loop popping a job and setting _current there is a
        # window where the queue is empty and _current is None — a
        # _current-based idle() would accept a second input into the queue
        # (serializing it behind a possibly minutes-long call) instead of
        # sending it to the thread pool.
        self._inflight = 0

    # -- caller side (any thread) ------------------------------------------

    def install_signal_handler(self) -> None:
        """Must be called from the main thread before run_until()."""
        signal.signal(signal.SIGUSR1, self._on_sigusr1)

    @property
    def active(self) -> bool:
        return self._running

    def idle(self) -> bool:
        """True when a submit would start immediately (no queueing): the
        caller should fall back to thread-pool concurrency otherwise."""
        with self._lock:
            return self._running and self._inflight == 0

    def submit(self, fn: Callable, *args: Any, **kwargs: Any) -> _Job:
        with self._lock:
            job = _Job(fn, args, kwargs, job_id=self._next_id)
            self._next_id += 1
            self._inflight += 1
        job.future.add_done_callback(self._job_done)
        self._queue.put(job)
        return job

    def _job_done(self, _future) -> None:
        with self._lock:
            self._inflight -= 1

    def cancel(self, job: _Job) -> None:
        """Cancel a queued job outright, or interrupt it mid-execution via
        SIGUSR1 if it is the one running on the main thread right now."""
        job.cancel_requested = True
        if job.future.cancel():
            return  # was still queued
        if self._current is job and self._main_ident is not None:
            try:
                signal.pthread_kill(self._main_ident, signal.SIGUSR1)
            except (OSError, RuntimeError) as exc:  # pragma: no cover
                logger.warning(f"SIGUSR1 delivery failed: {exc}")

    # -- main-thread side ---------------------------------------------------

    def _on_sigusr1(self, signum, frame) -> None:
        # Only interrupt when the main thread is actually inside a cancelled
        # job — a stray/late signal between jobs must be a no-op.
        job = self._current
        if job is not None and job.cancel_requested and not job.future.done():
            raise InputCancellation("input cancelled via SIGUSR1")

    def run_until(self, done: "Future | Any") -> None:
        """Main-thread loop: execute jobs until `done` (a concurrent Future)
        resolves. The loop parks in a blocking queue.get — a submitted job's
        put() wakes it immediately, and `done` resolving enqueues a sentinel
        via its callback, so neither arrival pays a poll interval. (The old
        0.1 s timeout poll put an avg ~50 ms floor under every sync input's
        start; SIGUSR1 cancellation never needed the poll — it only targets a
        RUNNING job, and queue.get on the main thread is signal-interruptible
        anyway.) The short timeout stays as a belt-and-suspenders backstop."""
        self._running = True
        done.add_done_callback(lambda _f: self._queue.put(None))
        try:
            while not done.done():
                try:
                    job = self._queue.get(timeout=5.0)
                except queue.Empty:
                    continue
                except InputCancellation:
                    continue  # late signal landed between jobs
                if job is None:
                    continue
                try:
                    self._run_job(job)
                except InputCancellation:
                    # a cancel() racing the job epilogue can raise AFTER the
                    # fn's try block exited (between any two bytecodes before
                    # _current clears) — the loop must survive it
                    pass
                finally:
                    self._current = None
                    if not job.future.done():
                        # the race above can leave the future unresolved; the
                        # awaiting input must still get its TERMINATED result
                        job.future.set_exception(InputCancellation("input cancelled"))
        finally:
            self._running = False
            # drain: anything still queued will never run
            while True:
                try:
                    leftover = self._queue.get_nowait()
                except queue.Empty:
                    break
                if leftover is not None:
                    leftover.future.cancel()

    def _run_job(self, job: _Job) -> None:
        if not job.future.set_running_or_notify_cancel():
            return  # cancelled while queued
        self._current = job
        try:
            if job.cancel_requested:
                raise InputCancellation("input cancelled before start")
            result = job.fn(*job.args, **job.kwargs)
        except BaseException as exc:  # noqa: BLE001 — routed to the future
            self._current = None
            if not job.future.done():
                job.future.set_exception(exc)
            return
        self._current = None
        if not job.future.done():
            job.future.set_result(result)
        # NOTE: a signal landing between the fn's return and set_result still
        # raises InputCancellation out of this frame — run_until catches it
        # and resolves the future, so neither the loop nor the input is lost.


# process-wide singleton, set by container_entrypoint.main() only — absent in
# tests that drive main_async() directly, where callers fall back to
# asyncio.to_thread (non-cancellable mid-syscall, as before)
_executor: Optional[MainThreadExecutor] = None


def get_executor() -> Optional[MainThreadExecutor]:
    return _executor


def set_executor(executor: Optional[MainThreadExecutor]) -> None:
    global _executor
    _executor = executor
