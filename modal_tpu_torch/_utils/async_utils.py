"""Async core + dual sync/async public surface (port of
modal_tpu/_utils/async_utils.py).

The reference SDK is written fully async and exposes a blocking+``.aio`` dual
API through the `synchronicity` library (reference: py/modal/_utils/
async_utils.py:326-338, `synchronize_api`). We keep the same architectural
choice — one async implementation, both surfaces generated — but with a much
smaller mechanism: a singleton background event loop thread plus descriptors
that give every async method a blocking form with an ``.aio`` attribute:

    fn.remote(x)        # blocking, runs on the synchronizer loop
    await fn.remote.aio(x)   # native async

Also here: `TaskContext` (structured concurrency group), `retry`,
`async_map`/`async_map_ordered`/`async_merge`, `queue_batch_iterator` — the
concurrency toolkit used across the SDK, runner, and container runtime.

The port's synchronizer is its own loop thread ("modal-tpu-torch-
synchronizer"): in a process that also runs the JAX package, the two SDKs'
loops never share a grpc.aio object, they meet only over the wire.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import inspect
import itertools
import os
import threading
import time
import typing
from collections.abc import AsyncGenerator, AsyncIterable, Awaitable, Iterable
from typing import Any, Callable, Optional, TypeVar

T = TypeVar("T")
V = TypeVar("V")

_SENTINEL = object()


class Synchronizer:
    """Owns the background event loop thread that executes all SDK
    coroutines when the user calls the blocking API surface.

    Re-creates the loop after fork (reference fork-safety PID check,
    client.py:347).
    """

    def __init__(self) -> None:
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._pid: Optional[int] = None
        self._lock = threading.Lock()

    def _ensure_loop(self) -> asyncio.AbstractEventLoop:
        with self._lock:
            if self._loop is None or self._pid != os.getpid() or not self._thread or not self._thread.is_alive():
                loop = asyncio.new_event_loop()
                ready = threading.Event()

                def _run() -> None:
                    asyncio.set_event_loop(loop)
                    loop.call_soon(ready.set)
                    loop.run_forever()

                thread = threading.Thread(target=_run, name="modal-tpu-torch-synchronizer", daemon=True)
                thread.start()
                ready.wait()
                self._loop = loop
                self._thread = thread
                self._pid = os.getpid()
        return self._loop

    def in_loop_thread(self) -> bool:
        return self._thread is not None and threading.current_thread() is self._thread

    def run(self, coro: Awaitable[T]) -> T:
        if self.in_loop_thread():
            raise RuntimeError(
                "Blocking API call inside the synchronizer event loop; use the `.aio` variant and await it."
            )
        loop = self._ensure_loop()
        fut = asyncio.run_coroutine_threadsafe(coro, loop)
        try:
            return fut.result()
        except KeyboardInterrupt:
            fut.cancel()
            raise

    def spawn(self, coro: Awaitable[T]) -> "concurrent.futures.Future[T]":
        """Schedule a coroutine on the synchronizer loop WITHOUT blocking;
        the caller (a non-loop thread) overlaps its own work with the IO and
        collects via `.result()`, e.g. to stream the next tensor fetch while
        the current one is copied to the card."""
        if self.in_loop_thread():
            raise RuntimeError("spawn() must be called from outside the synchronizer loop")
        loop = self._ensure_loop()
        return asyncio.run_coroutine_threadsafe(coro, loop)

    def run_generator(self, agen: AsyncGenerator[T, None]) -> typing.Generator[T, None, None]:
        """Bridge an async generator to a sync generator, preserving laziness."""
        loop = self._ensure_loop()

        def _next() -> Any:
            async def _anext() -> Any:
                try:
                    return await agen.__anext__()
                except StopAsyncIteration:
                    return _SENTINEL

            return asyncio.run_coroutine_threadsafe(_anext(), loop).result()

        try:
            while True:
                item = _next()
                if item is _SENTINEL:
                    return
                yield item
        finally:
            asyncio.run_coroutine_threadsafe(agen.aclose(), loop).result()


synchronizer = Synchronizer()


class _BlockingCallable:
    """The object returned for a wrapped async callable: call it = blocking;
    `.aio(...)` = async variant.

    All impl coroutines — blocking *and* `.aio` — execute on the synchronizer
    loop, because loop-bound resources (grpc.aio channels) live there. An
    `.aio` call from a foreign event loop is bridged with a cross-thread
    future; a call from the synchronizer loop itself runs the impl coroutine
    directly (so internal `await self._foo()` is transparent). This matches
    the reference's synchronicity semantics (async_utils.py:326)."""

    def __init__(self, async_callable: Callable, name: Optional[str] = None):
        self._impl = async_callable
        functools.update_wrapper(self, async_callable)
        if name:
            self.__name__ = name

    def aio(self, *args: Any, **kwargs: Any) -> Any:
        if synchronizer.in_loop_thread():
            return self._impl(*args, **kwargs)
        if inspect.isasyncgenfunction(self._impl):
            return _bridge_async_gen(self._impl(*args, **kwargs))
        return _bridge_coro(self._impl(*args, **kwargs))

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if synchronizer.in_loop_thread():
            # Internal async code calling a sibling wrapped method: stay
            # async — return the coroutine / async generator for awaiting.
            return self._impl(*args, **kwargs)
        if inspect.isasyncgenfunction(self._impl):
            return synchronizer.run_generator(self._impl(*args, **kwargs))
        return synchronizer.run(self._impl(*args, **kwargs))

    def __repr__(self) -> str:
        return f"<blocking wrapper for {self._impl!r}>"


async def _bridge_coro(coro: Awaitable[T]) -> T:
    """Run a coroutine on the synchronizer loop, awaitable from any loop."""
    loop = synchronizer._ensure_loop()
    return await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(coro, loop))


async def _bridge_async_gen(agen: AsyncGenerator[T, None]) -> AsyncGenerator[T, None]:
    loop = synchronizer._ensure_loop()

    async def _anext() -> Any:
        try:
            return await agen.__anext__()
        except StopAsyncIteration:
            return _SENTINEL

    try:
        while True:
            item = await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(_anext(), loop))
            if item is _SENTINEL:
                return
            yield item
    finally:
        await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(agen.aclose(), loop))


class synchronize_method:
    """Descriptor wrapping an async (generator) method into the dual surface."""

    def __init__(self, async_func: Callable):
        self._async_func = async_func
        functools.update_wrapper(self, async_func)

    def __set_name__(self, owner: type, name: str) -> None:
        self._name = name

    def __get__(self, obj: Any, objtype: Optional[type] = None) -> Any:
        if obj is None:
            # Accessed on the class: bind classmethod-style? No — return self
            # so introspection still sees the descriptor.
            return _BlockingCallable(self._async_func)
        bound = self._async_func.__get__(obj, objtype)
        return _BlockingCallable(bound)


def synchronize_api(obj: Any) -> Any:
    """Wrap an async implementation (class or function) into the dual
    blocking/.aio public surface.

    - For a **class**: returns the same class with every coroutine /
      async-generator method replaced by a `synchronize_method` descriptor
      (async classmethods get a blocking classmethod + `.aio`).
    - For a **function**: returns a `_BlockingCallable`.
    """
    _WRAPPED_DUNDERS = (
        "__aenter__",
        "__aexit__",
        "__getitem__",
        "__setitem__",
        "__delitem__",
        "__contains__",
        "__len__",
    )
    if inspect.isclass(obj):
        # include inherited async methods (e.g. _Object.hydrate on resource
        # classes): collect from the MRO, nearest definition wins, and set
        # the wrapper on `obj` itself so base classes stay untouched.
        members: dict[str, Any] = {}
        for klass in reversed(obj.__mro__[:-1]):  # exclude `object`
            members.update(vars(klass))
        for name, member in list(members.items()):
            if name.startswith("__") and name not in _WRAPPED_DUNDERS:
                continue
            if isinstance(member, classmethod):
                inner = member.__func__
                if inspect.iscoroutinefunction(inner) or inspect.isasyncgenfunction(inner):
                    setattr(obj, name, _SyncClassMethod(inner))
            elif isinstance(member, staticmethod):
                inner = member.__func__
                if inspect.iscoroutinefunction(inner) or inspect.isasyncgenfunction(inner):
                    setattr(obj, name, staticmethod(_BlockingCallable(inner)))
            elif inspect.iscoroutinefunction(member) or inspect.isasyncgenfunction(member):
                setattr(obj, name, synchronize_method(member))
        # Context manager duality: blocking `with` plus native `async with`.
        # __aenter__/__aexit__ must stay awaitable from a foreign loop, so they
        # bridge onto the synchronizer loop rather than going through the
        # blocking wrapper.
        if "__aenter__" in vars(obj) or any("__aenter__" in vars(b) for b in obj.__mro__[1:]):
            aenter = inspect.getattr_static(obj, "__aenter__")
            aexit = inspect.getattr_static(obj, "__aexit__")
            aenter_impl = aenter._async_func if isinstance(aenter, synchronize_method) else aenter
            aexit_impl = aexit._async_func if isinstance(aexit, synchronize_method) else aexit

            def __enter__(self):  # noqa: N807
                return synchronizer.run(aenter_impl(self))

            def __exit__(self, *exc):  # noqa: N807
                return synchronizer.run(aexit_impl(self, *exc))

            def __aenter__(self):  # noqa: N807
                if synchronizer.in_loop_thread():
                    return aenter_impl(self)
                return _bridge_coro(aenter_impl(self))

            def __aexit__(self, *exc):  # noqa: N807
                if synchronizer.in_loop_thread():
                    return aexit_impl(self, *exc)
                return _bridge_coro(aexit_impl(self, *exc))

            obj.__enter__ = __enter__
            obj.__exit__ = __exit__
            obj.__aenter__ = __aenter__
            obj.__aexit__ = __aexit__
        return obj
    elif inspect.iscoroutinefunction(obj) or inspect.isasyncgenfunction(obj):
        return _BlockingCallable(obj)
    else:
        raise TypeError(f"cannot synchronize {obj!r}")


class _SyncClassMethod:
    def __init__(self, async_func: Callable):
        self._async_func = async_func
        functools.update_wrapper(self, async_func)

    def __get__(self, obj: Any, objtype: Optional[type] = None) -> Any:
        bound = self._async_func.__get__(objtype, type(objtype))
        return _BlockingCallable(bound)


# ---------------------------------------------------------------------------
# Structured concurrency
# ---------------------------------------------------------------------------


class TaskContext:
    """A group of tasks that are cancelled/awaited together (reference:
    async_utils.py TaskContext). `infinite_loop` runs a coroutine function
    on a timer until the context exits — used for heartbeats."""

    def __init__(self, grace: Optional[float] = None):
        self._grace = grace
        self._tasks: list[asyncio.Task] = []
        self._exited = asyncio.Event()

    async def __aenter__(self) -> "TaskContext":
        return self

    async def start(self) -> "TaskContext":
        return self

    def create_task(self, coro: Awaitable[Any], name: Optional[str] = None) -> asyncio.Task:
        task = asyncio.create_task(coro, name=name)  # type: ignore[arg-type]
        self._tasks.append(task)
        return task

    def infinite_loop(
        self, async_f: Callable[[], Awaitable[Any]], sleep: float = 10.0, timeout: Optional[float] = None
    ) -> asyncio.Task:
        async def _loop() -> None:
            while not self._exited.is_set():
                try:
                    if timeout is not None:
                        await asyncio.wait_for(async_f(), timeout)
                    else:
                        await async_f()
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    from ..config import logger

                    logger.warning(f"loop {async_f} raised: {type(exc).__name__}: {exc}")
                try:
                    await asyncio.wait_for(self._exited.wait(), sleep)
                except asyncio.TimeoutError:
                    pass

        return self.create_task(_loop(), name=f"loop:{getattr(async_f, '__name__', 'anon')}")

    async def __aexit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        await self.stop()

    async def stop(self) -> None:
        self._exited.set()
        if self._grace:
            done, pending = await asyncio.wait(self._tasks, timeout=self._grace) if self._tasks else (set(), set())
        else:
            pending = [t for t in self._tasks if not t.done()]
        for task in pending:
            task.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)

    async def wait(self, *tasks: asyncio.Task) -> None:
        # Wait for given tasks; if any context task dies with an exception
        # meanwhile, propagate it (so e.g. a dead heartbeat fails the run).
        watched = set(tasks) if tasks else set(self._tasks)
        while watched:
            # Only wait on unfinished tasks — already-done ones would make
            # FIRST_COMPLETED return immediately and busy-spin.
            unfinished = {t for t in set(self._tasks) | watched if not t.done()}
            for task in list(watched):
                if task.done():
                    task.result()
                    watched.discard(task)
            for task in self._tasks:
                if task.done() and not task.cancelled() and task.exception() is not None:
                    raise task.exception()  # type: ignore[misc]
            if not watched:
                return
            if not unfinished:
                return
            await asyncio.wait(unfinished, return_when=asyncio.FIRST_COMPLETED)

    @staticmethod
    async def gather(*coros: Awaitable[Any]) -> list[Any]:
        async with TaskContext() as tc:
            tasks = [tc.create_task(c) for c in coros]
            await asyncio.gather(*tasks)
            return [t.result() for t in tasks]


def retry(
    direct_fn: Optional[Callable] = None,
    *,
    n_attempts: int = 3,
    base_delay: float = 0.0,
    delay_factor: float = 2.0,
    timeout: Optional[float] = None,
) -> Callable:
    """Retry an async function on exception with exponential backoff
    (reference: async_utils.py `retry`)."""

    def decorator(fn: Callable) -> Callable:
        @functools.wraps(fn)
        async def wrapped(*args: Any, **kwargs: Any) -> Any:
            delay = base_delay
            for attempt in range(n_attempts):
                try:
                    if timeout is not None:
                        return await asyncio.wait_for(fn(*args, **kwargs), timeout)
                    return await fn(*args, **kwargs)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    if attempt == n_attempts - 1:
                        raise
                    if delay:
                        await asyncio.sleep(delay)
                    delay = delay * delay_factor if delay else base_delay

        return wrapped

    if direct_fn is not None:
        return decorator(direct_fn)
    return decorator


async def asyncify(fn: Callable[..., T], *args: Any, **kwargs: Any) -> T:
    """Run a blocking function on a worker thread."""
    return await asyncio.to_thread(fn, *args, **kwargs)


async def sync_or_async_iter(it: typing.Union[Iterable[T], AsyncIterable[T]]) -> AsyncGenerator[T, None]:
    if hasattr(it, "__aiter__"):
        async for item in typing.cast(AsyncIterable[T], it):
            yield item
    else:
        for item in typing.cast(Iterable[T], it):
            yield item
            await asyncio.sleep(0)


async def async_merge(*iterables: AsyncIterable[T]) -> AsyncGenerator[T, None]:
    """Merge async iterables, yielding items as each produces them."""
    queue: asyncio.Queue = asyncio.Queue(maxsize=100)

    async def _pump(it: AsyncIterable[T]) -> None:
        async for item in it:
            await queue.put(item)

    async with TaskContext() as tc:
        tasks = [tc.create_task(_pump(it)) for it in iterables]
        done_fut = asyncio.gather(*tasks)
        while True:
            getter = asyncio.ensure_future(queue.get())
            done, _ = await asyncio.wait({getter, done_fut}, return_when=asyncio.FIRST_COMPLETED)
            if getter in done:
                yield getter.result()
            else:
                getter.cancel()
                done_fut.result()  # raise pump errors
                while not queue.empty():
                    yield queue.get_nowait()
                return


async def async_map(
    input_gen: AsyncIterable[T],
    async_mapper_func: Callable[[T], Awaitable[V]],
    concurrency: int,
) -> AsyncGenerator[V, None]:
    """Map with bounded concurrency, unordered yield."""
    input_q: asyncio.Queue = asyncio.Queue(maxsize=concurrency * 2)
    output_q: asyncio.Queue = asyncio.Queue()
    DONE = object()

    async def _feeder() -> None:
        async for item in input_gen:
            await input_q.put(item)
        for _ in range(concurrency):
            await input_q.put(DONE)

    async def _worker() -> None:
        while True:
            item = await input_q.get()
            if item is DONE:
                return
            await output_q.put(await async_mapper_func(item))

    async with TaskContext() as tc:
        # The feeder is part of the gathered future: if the input generator
        # raises, the error must surface instead of deadlocking the workers.
        feeder = tc.create_task(_feeder())
        workers = [tc.create_task(_worker()) for _ in range(concurrency)]
        gathered = asyncio.gather(feeder, *workers)
        while True:
            getter = asyncio.ensure_future(output_q.get())
            done, _ = await asyncio.wait({getter, gathered}, return_when=asyncio.FIRST_COMPLETED)
            if getter in done:
                yield getter.result()
            else:
                getter.cancel()
                gathered.result()
                while not output_q.empty():
                    yield output_q.get_nowait()
                return


async def async_map_ordered(
    input_gen: AsyncIterable[T],
    async_mapper_func: Callable[[T], Awaitable[V]],
    concurrency: int,
) -> AsyncGenerator[V, None]:
    """Map with bounded concurrency, yielding in input order."""

    async def _indexed(pair: tuple[int, T]) -> tuple[int, V]:
        i, item = pair
        return i, await async_mapper_func(item)

    async def _enumerate() -> AsyncGenerator[tuple[int, T], None]:
        i = 0
        async for item in input_gen:
            yield i, item
            i += 1

    buffer: dict[int, V] = {}
    next_idx = 0
    async for i, value in async_map(_enumerate(), _indexed, concurrency):
        buffer[i] = value
        while next_idx in buffer:
            yield buffer.pop(next_idx)
            next_idx += 1


async def queue_batch_iterator(
    q: asyncio.Queue, max_batch_size: int = 100, debounce_time: float = 0.015
) -> AsyncGenerator[list[Any], None]:
    """Read a queue, yielding batches; `None` on the queue terminates
    (reference: async_utils.py queue_batch_iterator)."""
    item_list: list[Any] = []
    while True:
        if len(item_list) >= max_batch_size:
            yield item_list
            item_list = []
        try:
            item = await asyncio.wait_for(q.get(), debounce_time if item_list else None)
        except asyncio.TimeoutError:
            yield item_list
            item_list = []
            continue
        if item is None:
            if item_list:
                yield item_list
            return
        item_list.append(item)


class aclosing(typing.Generic[T]):
    def __init__(self, agen: AsyncGenerator[T, None]):
        self._agen = agen

    async def __aenter__(self) -> AsyncGenerator[T, None]:
        return self._agen

    async def __aexit__(self, *exc: Any) -> None:
        await self._agen.aclose()


def run_coroutine_blocking(coro: Awaitable[T]) -> T:
    """Run a coroutine to completion from sync context (fresh loop if none)."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)  # type: ignore[arg-type]
    return synchronizer.run(coro)


class ConcurrencySemaphore:
    """Adjustable semaphore for input concurrency slots (reference:
    InputSlots, container_io_manager.py:417)."""

    def __init__(self, value: int):
        self.active = 0
        self.value = value
        self._waiters: list[asyncio.Future] = []
        self._closed = False

    async def acquire(self) -> None:
        while self.active >= self.value and not self._closed:
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._waiters.append(fut)
            try:
                await fut
            except asyncio.CancelledError:
                # Remove ourselves so we don't absorb a future wakeup; if we
                # were already woken, pass the wakeup on.
                if fut in self._waiters:
                    self._waiters.remove(fut)
                elif fut.done() and not fut.cancelled():
                    self._wake()
                raise
        self.active += 1

    def try_acquire(self) -> bool:
        """Non-blocking acquire: take a free slot now or report none. Used by
        the claim-coalescing input fetch (io_manager) to size one GetInputs
        at however many inputs this container could run immediately."""
        if self._closed or self.active >= self.value:
            return False
        self.active += 1
        return True

    def release(self) -> None:
        self.active -= 1
        self._wake()

    def set_value(self, value: int) -> None:
        self.value = value
        self._wake()

    def _wake(self) -> None:
        # Wake every waiter that could now fit; each re-checks capacity in
        # its acquire() loop, so over-waking is safe but under-waking (e.g.
        # after set_value raising capacity by N) would strand waiters.
        # Already-done (cancelled) futures don't count against capacity.
        n_wakeable = len(self._waiters) if self._closed else max(0, self.value - self.active)
        woken = 0
        i = 0
        while woken < n_wakeable and i < len(self._waiters):
            fut = self._waiters[i]
            if fut.done():
                self._waiters.pop(i)
                continue
            self._waiters.pop(i)
            fut.set_result(None)
            woken += 1

    def close(self) -> None:
        self._closed = True
        for fut in self._waiters:
            if not fut.done():
                fut.set_result(None)
        self._waiters.clear()
