"""`serve`: deploy in a subprocess, redeploy on a file change (port of
modal_tpu/serving/reload.py).

Reference: py/modal/serving.py:92 (_serve_app runs deploy in a subprocess,
restarts on watchfiles events from _watcher.py). The watcher polls mtimes
(1 Hz): the same contract with no third-party package.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
from typing import Optional


def _snapshot(paths: list[str]) -> dict[str, float]:
    out: dict[str, float] = {}
    for root in paths:
        if os.path.isfile(root):
            try:
                out[root] = os.path.getmtime(root)
            except OSError:
                pass
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d not in ("__pycache__", ".git", ".venv")]
            for f in filenames:
                if f.endswith(".py"):
                    p = os.path.join(dirpath, f)
                    try:
                        out[p] = os.path.getmtime(p)
                    except OSError:
                        pass
    return out


async def watch(paths: list[str], poll_interval: float = 1.0):
    """Yield on every detected change (a polling stand-in for watchfiles,
    reference _watcher.py:96)."""
    last = _snapshot(paths)
    while True:
        await asyncio.sleep(poll_interval)
        cur = _snapshot(paths)
        if cur != last:
            changed = sorted(set(cur.items()) ^ set(last.items()))
            last = cur
            yield [p for p, _ in changed][:5]


async def serve_app(file_path: str, app_ref: str, name: Optional[str] = None) -> None:
    """Deploy the app, then redeploy on every source change until Ctrl-C."""

    def _spawn() -> subprocess.Popen:
        code = (
            "from modal_tpu_torch.cli.import_refs import parse_import_ref, import_and_filter; "
            f"r = import_and_filter(parse_import_ref({app_ref!r})); "
            "from modal_tpu_torch.runner import deploy_app; "
            f"deploy_app(r.app, name={name!r} or r.app.name or 'served-app')"
        )
        return subprocess.Popen([sys.executable, "-c", code], cwd=os.getcwd())

    proc = _spawn()
    watch_paths = [os.path.dirname(os.path.abspath(file_path)) or "."]
    print(f"serving {app_ref}; watching {watch_paths[0]} (Ctrl-C to stop)", flush=True)
    try:
        async for changed in watch(watch_paths):
            print(f"change detected ({', '.join(os.path.basename(c) for c in changed)}); redeploying", flush=True)
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
            proc = _spawn()
    finally:
        if proc.poll() is None:
            proc.terminate()
