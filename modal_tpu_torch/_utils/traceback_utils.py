"""Remote-traceback rehydration: re-raise container exceptions with their
original frames client-side (the port's copy of
modal_tpu/_utils/traceback_utils.py).

Reference behavior: py/modal/_traceback.py + py/modal/_vendor/tblib.py — the
reference pickles traceback objects with a vendored tblib so `f.remote()`
failures re-raise with the remote stack attached. This is an independent
implementation of the same idea, sized to what the framework needs:

- capture: walk the traceback into plain dicts (filename/name/lineno/module)
  — always picklable, no code or frame objects on the wire;
- rebuild: synthesize a real ``types.TracebackType`` chain by compiling a
  stub code object per frame (with the original filename/name), executing it
  to obtain a genuine frame, and threading the frames together with the
  original line numbers.

The rebuilt traceback is real enough for every consumer that matters:
``traceback.format_exception`` shows the original file/line/function (and the
source line itself when the file exists client-side, e.g. shared project
code), debuggers can walk it, and pytest renders it inline.
"""

from __future__ import annotations

import pickle
import sys
import types
from typing import Any, Optional


class _TracebackMaker(Exception):
    """Internal sentinel raised inside synthesized code objects."""


def capture_traceback_frames(tb: Optional[types.TracebackType]) -> list[dict[str, Any]]:
    """Flatten a live traceback into picklable per-frame summaries."""
    frames = []
    while tb is not None:
        code = tb.tb_frame.f_code
        frames.append(
            {
                "filename": code.co_filename,
                "name": code.co_name,
                "lineno": tb.tb_lineno,
                "module": tb.tb_frame.f_globals.get("__name__", ""),
            }
        )
        tb = tb.tb_next
    return frames


def serialize_traceback(tb: Optional[types.TracebackType]) -> bytes:
    if tb is None:
        return b""
    try:
        return pickle.dumps(capture_traceback_frames(tb), protocol=4)
    except Exception:  # noqa: BLE001 — traceback transport is best-effort
        return b""


def _make_frame(filename: str, name: str, lineno: int) -> types.FrameType:
    """A real frame whose code object carries the original filename/name.

    The stub source is padded with newlines so the frame's own line number
    also lands on the original line — consumers that read ``frame.f_lineno``
    (not just ``tb_lineno``) stay consistent."""
    pad = "\n" * (max(lineno, 1) - 1)
    code = compile(pad + "raise _TracebackMaker()", filename, "exec")
    code = code.replace(co_name=name)
    g = {"_TracebackMaker": _TracebackMaker, "__name__": "<remote>", "__file__": filename}
    try:
        exec(code, g)  # noqa: S102 — executes only our own one-line raise
    except _TracebackMaker:
        tb = sys.exc_info()[2]
        assert tb is not None and tb.tb_next is not None
        return tb.tb_next.tb_frame
    raise AssertionError("synthesized code object did not raise")


def rebuild_traceback(frames: list[dict[str, Any]]) -> Optional[types.TracebackType]:
    """Reconstruct a TracebackType chain from captured frame summaries."""
    tb: Optional[types.TracebackType] = None
    for summary in reversed(frames):
        try:
            frame = _make_frame(
                str(summary.get("filename", "<remote>")),
                str(summary.get("name", "<unknown>")),
                int(summary.get("lineno", 1)),
            )
            tb = types.TracebackType(tb, frame, frame.f_lasti, int(summary.get("lineno", 1)))
        except Exception:  # noqa: BLE001 — a single bad frame must not lose
            # the rest of the stack (rebuild is best-effort by design)
            continue
    return tb


def deserialize_traceback(data: bytes) -> Optional[types.TracebackType]:
    if not data:
        return None
    try:
        frames = pickle.loads(data)  # noqa: S301 — list of plain dicts
        if not isinstance(frames, list):
            return None
        return rebuild_traceback(frames)
    except Exception:  # noqa: BLE001
        return None
