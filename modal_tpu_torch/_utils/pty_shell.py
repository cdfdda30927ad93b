"""Client-side PTY passthrough: raw local terminal ⇄ remote pty exec (port
of modal_tpu/_utils/pty_shell.py).

Reference: py/modal/_output/pty.py + cli/shell.py — the client puts its own
terminal into raw mode and pipes bytes both ways, forwarding window-size
changes. Runs on the blocking SDK surface (reader loop on a thread, stdin
pump on the main thread) so ctrl-C reaches the remote as a byte, not a local
KeyboardInterrupt.
"""

from __future__ import annotations

import os
import shutil
import signal
import sys
import threading


def _term_size() -> tuple[int, int]:
    size = shutil.get_terminal_size(fallback=(80, 24))
    return size.lines, size.columns


def run_pty_session(sandbox, argv: list[str]) -> int:
    """Exec `argv` in the sandbox under a PTY and wire it to this terminal.
    Returns the remote exit code. Requires a real local tty."""
    import termios
    import tty

    rows, cols = _term_size()
    proc = sandbox.exec(*argv, pty=True, pty_rows=rows, pty_cols=cols, text=False)

    stdin_fd = sys.stdin.fileno()
    old_attrs = termios.tcgetattr(stdin_fd)

    def on_winch(signum, frame):
        r, c = _term_size()
        try:
            proc.pty_resize(r, c)
        except Exception:  # noqa: BLE001 — resize is best-effort
            pass

    old_winch = signal.signal(signal.SIGWINCH, on_winch)

    stop = threading.Event()

    def pump_output() -> None:
        try:
            for chunk in proc.stdout:
                os.write(sys.stdout.fileno(), chunk)
        except Exception:  # noqa: BLE001 — session teardown races
            pass
        finally:
            stop.set()

    reader = threading.Thread(target=pump_output, daemon=True)
    tty.setraw(stdin_fd)
    reader.start()
    try:
        import select

        while not stop.is_set():
            # select with a short timeout so the loop notices the remote
            # side exiting even while local stdin is idle
            readable, _, _ = select.select([stdin_fd], [], [], 0.25)
            if stdin_fd not in readable:
                continue
            try:
                data = os.read(stdin_fd, 4096)
            except OSError:
                break
            if not data:
                break
            try:
                proc.stdin.write(data)
                proc.stdin.drain()
            except Exception:  # noqa: BLE001 — remote process exited while we
                # were writing: fall through to proc.wait() for the real exit
                # code instead of blowing a traceback out of the shell
                break
    finally:
        termios.tcsetattr(stdin_fd, termios.TCSADRAIN, old_attrs)
        signal.signal(signal.SIGWINCH, old_winch)
    return proc.wait()
