"""chip_smoke.py's process guard, on the CPU: a run leaves no process
behind. Each case runs the guard in a fresh interpreter (it makes that
process its descendants' subreaper), starts an orphan (a shell that
backgrounds a sleep and exits) and a child, and holds what the guard finds
and stops."""

import json
import os
import subprocess
import sys
import textwrap
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import importlib.util, json, os, subprocess, sys, time
    sys.path.insert(0, {repo!r})
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join({repo!r}, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    guard = smoke._ProcessGuard(float(sys.argv[1]))
    orphan = subprocess.run(["sh", "-c", "sleep 300 >/dev/null 2>&1 & echo $!"], capture_output=True,
                            text=True).stdout.strip()
    child = subprocess.Popen(["sleep", "300"])
    print(json.dumps({{"orphan": int(orphan), "child": child.pid, "subreaper": guard.subreaper,
                      "found": sorted(p for p, _s, _c in guard.leftovers(0.5))}}), flush=True)
    if sys.argv[2] == "stop":
        stopped = sorted(p for p, _s, _c in guard.stop_all(1.0))
        print(json.dumps({{"stopped": stopped, "left": smoke._descendants(os.getpid())}}), flush=True)
        guard.cancel()
    else:
        time.sleep(60)  # the budget runs out first
""")


def _run(budget: str, mode: str) -> tuple:
    proc = subprocess.run([sys.executable, "-c", CHILD.format(repo=REPO), budget, mode], capture_output=True,
                          text=True, timeout=60, cwd=REPO)
    return proc, [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]


def _gone(pid: int) -> bool:
    """No such process, or only its zombie (init reaps it)."""
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            return True
        if stat[stat.rindex(")") + 2] == "Z":
            return True
        time.sleep(0.1)
    return False


def test_the_guard_finds_an_orphan_and_a_child_and_stops_both():
    proc, lines = _run("100", "stop")
    assert proc.returncode == 0, proc.stderr[-2000:]
    first, after = lines
    assert first["subreaper"] is True
    # the orphan's parent shell has exited: only the subreaper still sees it
    assert first["found"] == sorted([first["orphan"], first["child"]])
    assert after["stopped"] == first["found"] and after["left"] == []
    assert _gone(first["orphan"]) and _gone(first["child"])


def test_a_run_past_its_budget_stops_its_processes_and_fails():
    proc, lines = _run("3", "sleep")
    assert proc.returncode == 3, (proc.returncode, proc.stderr[-2000:])
    assert "the run passed its budget of 3s" in proc.stderr
    assert "Thread" in proc.stderr or "thread" in proc.stderr  # the stacks, for the cause
    first = lines[0]
    assert _gone(first["orphan"]) and _gone(first["child"])
