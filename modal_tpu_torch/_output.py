"""Output manager: progress UX for run/deploy/serve (port of
modal_tpu/_output.py).

Reference: py/modal/_output/manager.py:112 — an OutputManager ABC with a
rich-backed implementation (spinners, step trees, dim status lines) and a
plain fallback. Enabled explicitly (`enable_output()` or by the CLI); library use
stays silent by default, matching the reference."""

from __future__ import annotations

import contextlib
import sys
from typing import Iterator, Optional


class OutputManager:
    """Plain-text progress output (also the ABC for the rich variant)."""

    def __init__(self, stream=None):
        self._stream = stream or sys.stderr

    def step(self, message: str) -> None:
        """A progress step has started."""
        self._stream.write(f"- {message}\n")
        self._stream.flush()

    def done(self, message: str) -> None:
        """A progress step completed."""
        self._stream.write(f"✓ {message}\n")
        self._stream.flush()

    def warning(self, message: str) -> None:
        self._stream.write(f"! {message}\n")
        self._stream.flush()

    @contextlib.contextmanager
    def status(self, message: str) -> Iterator[None]:
        self.step(message)
        yield

    def close(self) -> None:
        pass


class RichOutputManager(OutputManager):
    """rich-backed: live spinner for in-flight steps, checkmarked lines for
    completed ones."""

    def __init__(self, stream=None):
        super().__init__(stream)
        from rich.console import Console

        self._console = Console(file=self._stream, highlight=False)
        self._status = None

    def step(self, message: str) -> None:
        if self._status is not None:
            self._status.update(message)
        else:
            self._console.print(f"[dim]- {message}[/dim]")

    def done(self, message: str) -> None:
        self._console.print(f"[green]✓[/green] {message}")

    def warning(self, message: str) -> None:
        self._console.print(f"[yellow]![/yellow] {message}")

    @contextlib.contextmanager
    def status(self, message: str) -> Iterator[None]:
        from rich.status import Status

        status = Status(message, console=self._console, spinner="dots")
        self._status = status
        try:
            with status:
                yield
        finally:
            self._status = None

    def close(self) -> None:
        self._status = None


# module-global (not thread-local): the blocking API surface hops threads
# onto the synchronizer loop, so the manager must be visible process-wide
_GLOBAL: Optional[OutputManager] = None


def get_output_manager() -> Optional[OutputManager]:
    """The active manager, or None when output is disabled (the default)."""
    return _GLOBAL


@contextlib.contextmanager
def enable_output(plain: bool = False) -> Iterator[OutputManager]:
    """Turn on progress output for run/deploy within this context (reference
    `modal.enable_output()`)."""
    global _GLOBAL
    manager: OutputManager
    if plain or not sys.stderr.isatty():
        manager = OutputManager()
    else:
        try:
            manager = RichOutputManager()
        except Exception:  # rich unavailable/broken terminal
            manager = OutputManager()
    prev = _GLOBAL
    _GLOBAL = manager
    try:
        yield manager
    finally:
        manager.close()
        _GLOBAL = prev


def _emit(kind: str, message: str) -> None:
    mgr = get_output_manager()
    if mgr is None:
        return
    getattr(mgr, kind)(message)


def step(message: str) -> None:
    _emit("step", message)


def done(message: str) -> None:
    _emit("done", message)


def warning(message: str) -> None:
    _emit("warning", message)
