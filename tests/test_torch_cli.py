"""The port's command line against the JAX package's: each case of
tests/test_cli.py (and the CLI cases of test_observability.py,
test_recovery.py and test_slo.py) runs through `modal_tpu.cli` against a
JAX plane and through `modal_tpu_torch.cli` against the port's plane, and
the exit codes and the output, with ids, times, counts and paths masked,
must be the same. A container's log lines reach the terminal on the
worker's log tick, so where they fall among the CLI's own lines is a race
in both packages (ROADMAP Queue C 48): a command's output is compared as
two ordered streams, the lines the plane logged for its containers during
the command and the CLI's own, each exactly.

A fresh plane per package for each case (`tests.test_torch_app.Planes`),
as tests/test_cli.py has a fresh supervisor for each. The two CLIs run one
after the other (click's CliRunner swaps the process's
stdout); the commands that only run as a process (`curl`, the interactive
`shell`) run as subprocesses of each package's `python -m ...cli`. A test
walks both command trees (`lint` is tests/test_torch_analysis.py's), and
a subprocess runs `app list` and `debug bundle` with torch and jax
unimportable.
"""

import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import textwrap
import time

import pytest
from click.testing import CliRunner

import modal_tpu
import modal_tpu_torch
from modal_tpu.cli.entry_point import cli as jcli
from modal_tpu_torch.cli.entry_point import cli as tcli
from tests.test_torch_app import CONTAINER_ENV, Planes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = (("jax", modal_tpu, jcli), ("port", modal_tpu_torch, tcli))
# a gang's containers skip the collective runtime's rendezvous
GANG_ENV = {"MODAL_TPU_SKIP_JAX_DISTRIBUTED": "1", "MODAL_TPU_SKIP_TORCH_DISTRIBUTED": "1"}


@pytest.fixture
def planes():
    env = {**CONTAINER_ENV, **GANG_ENV}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    p = Planes(tempfile.mkdtemp(prefix="cli-", dir="/tmp"))
    # the JAX client learns its plane's input plane as the port's does, as
    # each package's CLI does through its env client's ClientHello
    p.jclient.hello()
    try:
        yield p
    finally:
        p.close()
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)


_MASKS = (
    (re.compile(r"/tmp/[^\s'\"]+"), "<path>"),
    (re.compile(r"\b[a-z]{2}-[0-9A-Za-z_-]{6,}\b"), "<id>"),
    (re.compile(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d"), "<ts>"),
    (re.compile(r"\d+(\.\d+)?"), "<n>"),
    (re.compile(r"modal[-_]tpu[-_]torch"), "modal_tpu"),
    (re.compile(r"modal-tpu"), "modal_tpu"),
)


def mask(text: str) -> str:
    for pattern, repl in _MASKS:
        text = pattern.sub(repl, text)
    return text


class Cli:
    """One package's CLI in a scenario: `run(*args)` invokes it, checks the
    exit code and keeps (code, masked stdout) in the transcript the two
    packages are compared on."""

    def __init__(self, name: str, m, root, client, sup):
        self.name, self.m, self.root, self.client, self.sup = name, m, root, client, sup
        self.cli = jcli if m is modal_tpu else tcli
        self.transcript: list = []

    def run(self, *args: str, expect=0, input=None, keep=True) -> str:
        logged = self._container_lines()
        result = CliRunner().invoke(self.cli, list(args), input=input)
        if expect is not None:
            assert result.exit_code == expect, (self.name, args, result.output, result.exception)
        if keep:
            own, container = self._split(result.stdout, self._container_lines() - logged)
            self.transcript.append((args[0], result.exit_code, mask(own), mask(container)))
        return result.stdout

    def _container_lines(self) -> collections.Counter:
        """Every line the plane holds in its apps' container logs."""
        return collections.Counter(line for app in list(self.sup.state.apps.values())
                                   for entry in list(app.log_entries) for line in entry.data.splitlines())

    @staticmethod
    def _split(stdout: str, new_lines: collections.Counter) -> tuple[str, str]:
        """(the CLI's own lines, the container lines it printed), each in
        its order: a line is a container's when the plane logged it during
        the command."""
        own, container = [], []
        for line in stdout.splitlines():
            if new_lines[line] > 0:
                new_lines[line] -= 1
                container.append(line)
            else:
                own.append(line)
        return "\n".join(own), "\n".join(container)

    def script(self, body: str, name: str = "cli_app") -> str:
        """A user's app file for this package (`{pkg}` names it)."""
        path = os.path.join(self.root, f"{name}_{self.name}.py")
        with open(path, "w") as f:
            f.write(textwrap.dedent(body).replace("{pkg}", self.m.__name__))
        return path

    def process(self, *args: str, **kw) -> subprocess.CompletedProcess:
        env = {**os.environ, "MODAL_TPU_SERVER_URL": self.sup.server_url, "PYTHONPATH": REPO}
        return subprocess.run([sys.executable, "-m", f"{self.m.__name__}.cli", *args], capture_output=True,
                              text=True, timeout=120, env=env, cwd=REPO, **kw)


def both(planes, scenario) -> dict:
    """scenario(cli) through the JAX CLI, then the port's: the two
    transcripts must be equal. Returns {name: scenario's return value}."""
    out, transcripts = {}, {}
    for name, m, _cli in PACKAGES:
        client, sup = planes.of(m)
        root = tempfile.mkdtemp(prefix=f"{name}-", dir=planes.root)
        c = Cli(name, m, root, client, sup)
        out[name] = scenario(c)
        transcripts[name] = c.transcript
    assert transcripts["port"] == transcripts["jax"]
    return out


APP_SCRIPT = """
import {pkg}

app = {pkg}.App("cli-test-app")

@app.function(serialized=True)
def double(x: int):
    print(f"doubling {x}")
    return x * 2

@app.local_entrypoint()
def main(x: int = 4):
    print("RESULT:", double.remote(int(x)))
"""


def _wait(cond, timeout: float = 20.0, step: float = 0.25) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


# -- the cases of tests/test_cli.py ---------------------------------------------


def test_cli_run_local_entrypoint_function_and_bad_ref(planes):
    def scenario(c):
        path = c.script(APP_SCRIPT)
        assert "RESULT: 8" in c.run("run", f"{path}::main")
        assert "42" in c.run("run", f"{path}::double", "21")
        c.run("run", f"{path}::nope", expect=None)
        assert c.transcript[-1][1] != 0

    both(planes, scenario)


def test_cli_deploy_and_app_list(planes):
    def scenario(c):
        path = c.script(APP_SCRIPT)
        assert "deployed" in c.run("deploy", path, "--name", "cli-deployed")
        listing = c.run("app", "list", keep=False)
        row = next(ln for ln in listing.splitlines() if ln.endswith(" cli-deployed"))
        assert row.split()[1] == "deployed"
        c.run("app", "history", row.split()[0])
        c.run("app", "stop", row.split()[0])

    both(planes, scenario)


def test_cli_app_logs_backfill(planes):
    def scenario(c):
        path = c.script(APP_SCRIPT, "logs_app")
        c.run("run", f"{path}::main", "7")
        app_id = max(a for a in c.sup.state.apps if c.sup.state.apps[a].description == "cli-test-app")
        assert _wait(lambda: "doubling 7" in c.run("app", "logs", app_id, keep=False))
        c.run("app", "logs", app_id)

    both(planes, scenario)


def test_cli_volume_roundtrip(planes):
    def scenario(c):
        c.run("volume", "create", "cli-vol")
        assert "cli-vol" in c.run("volume", "list")
        local = os.path.join(c.root, "hello.txt")
        with open(local, "w") as f:
            f.write("volume data")
        c.run("volume", "put", "cli-vol", local, "/hello.txt")
        assert "hello.txt" in c.run("volume", "ls", "cli-vol")
        dest = os.path.join(c.root, "out.txt")
        c.run("volume", "get", "cli-vol", "/hello.txt", dest)
        with open(dest) as f:
            assert f.read() == "volume data"
        c.run("volume", "rm", "cli-vol", "/hello.txt")
        assert "hello.txt" not in c.run("volume", "ls", "cli-vol")
        c.run("volume", "delete", "cli-vol", "--yes")

    both(planes, scenario)


def test_cli_secret_lifecycle(planes):
    def scenario(c):
        c.run("secret", "create", "cli-secret", "API_KEY=abc123")
        assert "cli-secret" in c.run("secret", "list")
        c.run("secret", "create", "bad", "NOEQUALS", expect=2)
        c.run("secret", "delete", "cli-secret")
        assert "cli-secret" not in c.run("secret", "list")

    both(planes, scenario)


def test_cli_shell_single_command_and_gpu_flag(planes):
    """`shell --cmd` runs one command in a fresh sandbox and exits with its
    code; the port's `--gpu` pins the sandbox to a card, and `--tpu` is
    refused as `tpu=` is."""

    def scenario(c):
        assert "from-shell" in c.run("shell", "--cmd", "echo from-shell; echo err-side >&2")
        c.run("shell", "--cmd", "exit 7", expect=7)

    both(planes, scenario)
    client, sup = planes.of(modal_tpu_torch)
    result = CliRunner().invoke(tcli, ["shell", "--gpu", "H100", "--cmd", "echo pinned"])
    assert result.exit_code == 0 and "pinned" in result.stdout, result.output
    pinned = [t for t in sup.state.tasks.values() if list(t.gpu_ids)]
    assert pinned, "the --gpu sandbox took no card"
    result = CliRunner().invoke(tcli, ["shell", "--tpu", "v5e-1", "--cmd", "true"])
    assert result.exit_code == 2 and "tpu= asks for TPU chips" in result.output, result.output


def test_cli_app_imports(planes, monkeypatch):
    monkeypatch.setenv("MODAL_TPU_IMPORT_TRACE", "1")

    def scenario(c):
        path = c.script(APP_SCRIPT, "imports_app")
        c.run("run", f"{path}::main")
        tasks_dir = os.path.join(c.sup.state_dir, "tasks")
        task_id = max(d for d in os.listdir(tasks_dir) if os.path.exists(os.path.join(tasks_dir, d, "imports.jsonl")))
        out = c.run("app", "imports", task_id, "--state-dir", c.sup.state_dir, keep=False)
        assert "ms" in out and c.m.__name__ in out
        c.run("app", "imports", "ta-missing", "--state-dir", c.sup.state_dir, expect=1)

    both(planes, scenario)


def test_cli_shell_interactive_pty(planes):
    """The interactive `shell` through a real pseudo-terminal: the remote
    shell's prompt, a command's round trip, a clean exit."""
    import errno
    import pty
    import select

    for name, m, _cli in PACKAGES:
        _client, sup = planes.of(m)
        env = {**os.environ, "MODAL_TPU_SERVER_URL": sup.server_url, "SHELL": "/bin/sh", "PYTHONPATH": REPO}
        master, slave = pty.openpty()
        proc = subprocess.Popen([sys.executable, "-m", f"{m.__name__}.cli", "shell"], stdin=slave, stdout=slave,
                                stderr=slave, env=env, close_fds=True)
        os.close(slave)
        buf = b""

        def read_until(needle: bytes, timeout: float) -> bytes:
            nonlocal buf
            deadline = time.monotonic() + timeout
            while needle not in buf and time.monotonic() < deadline:
                r, _, _ = select.select([master], [], [], 0.5)
                if master in r:
                    try:
                        data = os.read(master, 4096)
                    except OSError as exc:
                        if exc.errno == errno.EIO:
                            break
                        raise
                    if not data:
                        break
                    buf += data
            return buf

        try:
            read_until(b"# " if os.geteuid() == 0 else b"$ ", 60.0)
            os.write(master, b"echo interactive-$((6*7))\n")
            assert b"interactive-42" in read_until(b"interactive-42", 30.0), (name, buf[-500:])
            os.write(master, b"exit\n")
            assert proc.wait(timeout=30) == 0, name
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            os.close(master)


def test_cli_container_list_stop_logs(planes):
    """container list shows a live container (the port's with its cards);
    stop kills it; logs backfill; finished containers show with --all."""

    def scenario(c):
        app = c.m.App("cli-containers")

        def chatty(x):
            print(f"chatty says {x}")
            return x

        f = app.function(serialized=True)(chatty)
        with app.run(client=c.client):
            assert f.remote(9) == 9
            out = c.run("container", "list")
            task_id = next((line.split()[0] for line in out.splitlines() if line.endswith(".chatty")), None)
            assert task_id, (c.name, out)
            assert _wait(lambda: "chatty says 9" in c.run("container", "logs", task_id, keep=False), 15)
            c.run("container", "logs", task_id)
            c.run("container", "stop", task_id)
            assert _wait(lambda: c.sup.state.tasks[task_id].finished_at, 20), "stop did not land"
        assert task_id not in c.run("container", "list")
        assert task_id in c.run("container", "list", "--all", keep=False)
        return task_id

    both(planes, scenario)


def test_cli_cluster_list_and_rendezvous(planes):
    """cluster list surfaces a gang with its size and rendezvous progress."""

    def scenario(c):
        app = c.m.App("cli-cluster")

        def gang(x):
            import time as _t

            _t.sleep(1)
            return x

        g = app.function(serialized=True, timeout=60)(c.m.clustered(size=2)(gang))
        with app.run(client=c.client):
            call = g.spawn(1)
            assert call.get(timeout=60) == 1
            out = c.run("cluster", "list")
            assert "size=2" in out and "ranks_reported=2" in out and "gang" in out

    both(planes, scenario)


def test_cli_environment_lifecycle(planes):
    def scenario(c):
        assert "created" in c.run("environment", "create", "staging")
        assert "staging" in c.run("environment", "list")
        assert "renamed" in c.run("environment", "rename", "staging", "prod2")
        listing = c.run("environment", "list")
        assert "prod2" in listing and "staging" not in listing
        c.run("environment", "delete", "prod2", "--yes")
        assert "prod2" not in c.run("environment", "list")

    both(planes, scenario)


def test_cli_image_prune_refusal_matrix(planes):
    """A scale-to-zero deployment pins its image and the FROM-chain base;
    stopping it unpins the chain and prune removes both."""

    def scenario(c):
        path = c.script(
            """
            import {pkg}

            base = {pkg}.Image.debian_slim()
            child = base.env({"CHAIN_MARK": "1"})
            app = {pkg}.App("prune-matrix-app")

            @app.function(serialized=True, image=child)
            def noop(x):
                return x
            """,
            "chain_app",
        )
        assert "deployed" in c.run("deploy", path)
        fn = next(f for f in c.sup.state.functions.values() if f.tag == "noop" and f.definition.image_id
                  and c.sup.state.apps[f.app_id].description == "prune-matrix-app")
        child_id = fn.definition.image_id
        base_id = next(cmd.strip()[5:].strip() for cmd in c.sup.state.images[child_id].definition.dockerfile_commands
                       if cmd.strip().startswith("FROM im-"))
        c.run("image", "prune", "--yes", keep=False)
        assert child_id in c.sup.state.images and base_id in c.sup.state.images
        c.run("app", "stop", fn.app_id)
        assert _wait(lambda: (c.run("image", "prune", "--yes", keep=False) or True)
                     and child_id not in c.sup.state.images and base_id not in c.sup.state.images)

    both(planes, scenario)


def test_cli_container_stop_kills_worker_process(planes):
    def scenario(c):
        app = c.m.App("cli-stop-kill")

        def slow(x):
            import time as _t

            _t.sleep(60)
            return x

        f = app.function(serialized=True)(slow)
        with app.run(client=c.client):
            call = f.spawn(1)
            worker = c.sup.workers[0]
            task_id = None

            def claimed():
                nonlocal task_id
                ids = [i.claimed_by for i in c.sup.state.inputs.values()
                       if i.function_call_id == call.object_id and i.claimed_by]
                task_id = ids[0] if ids and ids[0] in worker._procs else None
                return task_id is not None

            assert _wait(claimed, 30, 0.2), "the container process never appeared on the worker"
            c.run("container", "stop", task_id)
            assert _wait(lambda: task_id not in worker._procs, 40), "the worker process survived container stop"
            assert c.sup.state.tasks[task_id].finished_at

    both(planes, scenario)


def test_cli_curl_hits_web_endpoint(planes):
    def scenario(c):
        app = c.m.App("curl-app")

        def hello(name="world"):
            return f"hi {name}"

        fn = app.function(serialized=True)(c.m.web_endpoint(method="GET")(hello))
        with app.run(client=c.client):
            proc = c.process("curl", fn.get_web_url() + "?name=curl")
            assert proc.returncode == 0 and "hi curl" in proc.stdout, proc.stderr
            c.transcript.append(("curl", proc.returncode, mask(proc.stdout)))
        c.run("curl", "not-a-ref", expect=2)

    both(planes, scenario)


def test_cli_launch_python_piped(planes):
    def scenario(c):
        assert "repl says 42" in c.run("launch", "python", input="print('repl says', 6*7)\n")

    both(planes, scenario)


def test_cli_image_prebuild_list_and_prune(planes):
    """`image prebuild` publishes the base image through the worker; image
    list shows it; prune keeps the images a running container pins."""

    def scenario(c):
        out = c.run("image", "prebuild")
        image_id = next(w for w in out.split() if w.startswith("im-"))
        assert image_id in c.sup.state.images
        app = c.m.App("cli-image")

        def noop(x):
            return x

        f = app.function(serialized=True)(noop)
        with app.run(client=c.client):
            assert f.remote(1) == 1
            assert "im-" in c.run("image", "list", keep=False)
            c.run("image", "prune", "--yes", keep=False)
            assert "im-" in c.run("image", "list", keep=False)

    both(planes, scenario)


def test_cli_nfs_alias_matches_volume(planes):
    def scenario(c):
        src = os.path.join(c.root, "hello.txt")
        with open(src, "w") as f:
            f.write("nfs-alias")
        c.run("nfs", "create", "shared-fs")
        c.run("nfs", "put", "shared-fs", src, "/hello.txt")
        assert "hello.txt" in c.run("nfs", "ls", "shared-fs", "/")
        assert "hello.txt" in c.run("volume", "ls", "shared-fs", "/")

    both(planes, scenario)


def test_cli_dict_queue_proxy_workspace_config_profile(planes, tmp_path, monkeypatch):
    """The object groups (dict, queue, proxy), workspace, config profiles and
    token set: the same lines from both CLIs. Each package's profiles go to
    a file of its own (the JAX package reads its path at import, and never
    the user's own file here)."""
    jconfig = sys.modules["modal_tpu.config"]  # the package's `config` attribute is the Config
    monkeypatch.setattr(jconfig, "user_config_path", str(tmp_path / "jax.toml"))
    monkeypatch.setattr(jconfig, "_user_config", {})
    monkeypatch.setenv("MODAL_TPU_CONFIG_PATH", str(tmp_path / "port.toml"))

    def scenario(c):
        d = c.m.Dict.from_name("cli-dict", create_if_missing=True)
        d["k"] = 1
        assert "cli-dict" in c.run("dict", "list")
        c.run("dict", "clear", "cli-dict")
        q = c.m.Queue.from_name("cli-queue", create_if_missing=True)
        q.put_many([1, 2, 3])
        assert "cli-queue" in c.run("queue", "list")
        assert c.run("queue", "peek", "cli-queue", "-n", "2").split() == ["1", "2"]
        c.run("proxy", "create", "cli-proxy")
        assert "cli-proxy" in c.run("proxy", "list")
        c.run("proxy", "delete", "cli-proxy")
        c.run("workspace", "current")
        c.run("workspace", "set", "default_environment", "main")
        assert "default_environment = main" in c.run("workspace", "settings")
        c.run("workspace", "members")
        c.run("token", "set", "--token-id", "ak-x", "--token-secret", "as-x", "--profile", "p1")
        c.run("profile", "activate", "p1")
        assert c.run("profile", "list").split() == ["p1"]
        with open(tmp_path / f"{c.name}.toml") as f:
            return f.read()

    got = both(planes, scenario)
    # the port reads the file at each access, so the token outlives the
    # activation; the JAX package rewrites the file from the profiles it read
    # at import, which drops a token stored earlier in the same process
    assert got["port"] == '[p1]\ntoken_id = "ak-x"\ntoken_secret = "as-x"\nactive = true\n'
    assert got["jax"] == "[p1]\nactive = true\n"


# -- the CLI cases of test_observability.py, test_recovery.py, test_slo.py -----


def test_cli_app_trace_attribute_metrics_and_profile(planes):
    """`app trace` renders a call's waterfall and its critical path, `app
    attribute` aggregates it, `metrics` scrapes the plane (text and --json),
    `app profile` lists a runtime_debug function's traces."""

    def scenario(c):
        app = c.m.App("cli-trace")

        def noop(x):
            return x

        f = app.function(serialized=True)(noop)
        with app.run(client=c.client):
            assert f.remote(3) == 3
        state = c.sup.state_dir
        traced = c.run("app", "trace", f.object_id, "--state-dir", state, "--critical-path", keep=False)
        assert "function.call" in traced and "user.execute" in traced and "critical path:" in traced
        agg = json.loads(c.run("app", "attribute", f.object_id, "--state-dir", state, "--json", keep=False))
        assert agg["calls"] >= 1 and set(agg["segments"]) >= {"user.execute", "gap"}
        c.run("app", "trace", "no-such-needle", "--state-dir", state, expect=1)
        c.run("app", "attribute", "no-such-needle", "--state-dir", state, expect=1)
        text = c.run("metrics", "--state-dir", state, keep=False)
        assert "modal_tpu_rpc_latency_seconds" in text
        url = open(os.path.join(state, "observability", "metrics_url")).read().strip()
        assert json.loads(c.run("metrics", "--url", url, "--json", keep=False))
        return agg

    both(planes, scenario)


FOLDED = """main;serve;decode_step;attention 120
main;serve;decode_step;matmul 300
main;serve;prefill;matmul 80
main;heartbeat 7
main;serve;decode_step 13
"""


@pytest.mark.parametrize("where", ["file", "store"])
def test_cli_profile_show_prints_the_jax_packages_table(tmp_path, where):
    """`profile show` through `python -m modal_tpu.cli` and `python -m
    modal_tpu_torch.cli`: one folded file (`--file`), or the store of a
    state dir with `--match`, prints the same self%/cum% table."""
    profiles = tmp_path / "observability" / "profiles"
    profiles.mkdir(parents=True)
    (profiles / "profile-ta-1-100.folded").write_text(FOLDED)
    (profiles / "profile-ta-2-100.folded").write_text("main;other 5\n")
    if where == "file":
        args = ["--file", str(profiles / "profile-ta-1-100.folded"), "--top", "4"]
    else:
        args = ["--state-dir", str(tmp_path), "--match", "ta-1"]
    env = {**os.environ, "PYTHONPATH": REPO}
    out = {}
    for m in (modal_tpu, modal_tpu_torch):
        proc = subprocess.run([sys.executable, "-m", f"{m.__name__}.cli", "profile", "show", *args],
                              capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-2000:]
        out[m.__name__] = proc.stdout.splitlines()
    assert out["modal_tpu_torch"] == out["modal_tpu"]
    lines = out["modal_tpu_torch"]
    assert lines[0] == "1 profile file(s):" and lines[2].split() == ["self%", "cum%", "self", "cum", "frame"]
    assert lines[-1] == "520 samples total" and lines[3].endswith("  matmul")


def test_cli_metrics_reports_stale_breadcrumb(planes, tmp_path):
    from modal_tpu._utils.grpc_utils import find_free_port

    obs = tmp_path / "state" / "observability"
    obs.mkdir(parents=True)
    (obs / "metrics_url").write_text(f"http://127.0.0.1:{find_free_port()}/metrics\n")

    def scenario(c):
        out = CliRunner().invoke(c.cli, ["metrics", "--state-dir", str(tmp_path / "state")])
        assert out.exit_code == 1 and "stale" in out.output and "not answering" in out.output
        c.transcript.append(("metrics", out.exit_code, mask(out.output)))

    both(planes, scenario)


def test_cli_journal_status_and_compact(planes, tmp_path):
    """journal status (text and --json) and an offline compact of a stopped
    plane's journal, then status of a dir with none."""
    from modal_tpu._utils.async_utils import synchronizer as jsync
    from modal_tpu.server.supervisor import LocalSupervisor as JaxSupervisor
    from modal_tpu_torch._utils.async_utils import synchronizer as tsync
    from modal_tpu_torch.server.supervisor import LocalSupervisor

    def scenario(c):
        state = os.path.join(c.root, "state")
        sync, cls = (jsync, JaxSupervisor) if c.m is modal_tpu else (tsync, LocalSupervisor)
        sup = cls(num_workers=0, state_dir=state)
        sync.run(sup.start())
        client = (modal_tpu.client._Client if c.m is modal_tpu else modal_tpu_torch.client._Client)(sup.server_url)
        client._open()
        try:
            for name in ("j1", "j2"):
                c.m.Secret.create_deployed(name, {"A": "b"}, client=client)
        finally:
            client._close()
            sync.run(sup.stop())
        st = json.loads(c.run("journal", "status", "--state-dir", state, "--json", keep=False))
        assert st["tail_records"] > 0
        c.run("journal", "status", "--state-dir", state)
        assert "compacted" in c.run("journal", "compact", "--state-dir", state)
        st = json.loads(c.run("journal", "status", "--state-dir", state, "--json", keep=False))
        assert st["snapshot_seq"] == st["seq"] and st["tail_records"] <= 1
        out = CliRunner().invoke(c.cli, ["journal", "status", "--state-dir", os.path.join(c.root, "nope")])
        assert out.exit_code == 1 and "no journal" in out.output
        c.transcript.append(("journal", out.exit_code, mask(out.output)))

    both(planes, scenario)


def test_cli_alerts_top_and_history(planes):
    """`alerts` and `top` over the plane's history endpoint (text, --once
    and --json), `trace gc` and `debug bundle` on a plane that never
    crashed."""

    def scenario(c):
        state = c.sup.state_dir
        alerts = c.run("alerts", "--state-dir", state, keep=False)
        assert "firing" in alerts or "no SLO rules" in alerts
        assert json.loads(c.run("alerts", "--state-dir", state, "--json", keep=False)) is not None
        frame = c.run("top", "--state-dir", state, "--once", keep=False)
        assert frame.startswith("modal_tpu top") and "replica" in frame
        payload = json.loads(c.run("top", "--state-dir", state, "--json", keep=False))
        assert "fleet" in payload
        c.run("trace", "gc", "--state-dir", state, "--max-mb", "64")
        bundle = json.loads(c.run("debug", "bundle", "--state-dir", state, "--json", keep=False))
        assert [pm["event"] for pm in bundle["postmortems"]] == []
        return sorted(payload)

    got = both(planes, scenario)
    assert got["port"] == got["jax"]


# -- the port's own: the tree and no torch at import -----------------------------


def _tree(command, path=()) -> dict:
    """{command path: sorted option names} of a click command tree, hidden
    options left out."""
    import click

    out = {path: sorted(o for p in command.params if isinstance(p, click.Option) and not p.hidden for o in p.opts)}
    if isinstance(command, click.Group):
        for name, sub in command.commands.items():
            out.update(_tree(sub, path + (name,)))
    return out


def test_both_command_trees_have_the_same_groups_commands_and_options():
    jtree, ttree = _tree(jcli), _tree(tcli)
    assert sorted(ttree) == sorted(jtree)
    renamed = {k: [("--gpu" if o == "--tpu" else o) for o in v] for k, v in jtree.items()}
    for path, options in renamed.items():
        assert ttree[path] == sorted(options), path
    assert [p for p, v in jtree.items() if "--tpu" in v] == [("shell",), ("launch", "python"), ("launch", "jupyter")]
    assert len(ttree) > 80


def test_cli_commands_without_a_card_run_with_torch_and_jax_unimportable(tmp_path):
    """`app list` against a live port plane, and `debug bundle` and `journal
    status` over its state dir, in a process where torch, jax and the JAX
    package cannot be imported."""
    state = str(tmp_path / "state")
    port_file = tmp_path / "port"
    server = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(f"""
            import asyncio, sys
            from modal_tpu_torch.server.supervisor import LocalSupervisor

            async def main():
                sup = LocalSupervisor(num_workers=0, state_dir={state!r})
                await sup.start()
                open({str(port_file)!r}, "w").write(str(sup.port))
                await asyncio.Event().wait()

            asyncio.run(main())
            """)],
        env={**os.environ, "PYTHONPATH": REPO}, cwd=REPO)
    try:
        assert _wait(lambda: port_file.exists() and port_file.read_text(), 60), "the plane did not come up"
        blocker = tmp_path / "blocker"
        blocker.mkdir()
        (blocker / "sitecustomize.py").write_text(
            "import sys\nfor name in ('torch', 'jax', 'jaxlib', 'modal_tpu'):\n    sys.modules[name] = None\n")
        env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(blocker), REPO]),
               "MODAL_TPU_SERVER_URL": f"grpc://127.0.0.1:{port_file.read_text()}", "MODAL_TPU_STATE_DIR": state}
        for args in (["app", "list"], ["debug", "bundle", "--json"], ["journal", "status"], ["config", "show"]):
            proc = subprocess.run([sys.executable, "-m", "modal_tpu_torch.cli", *args], env=env, cwd=REPO,
                                  capture_output=True, text=True, timeout=120)
            assert proc.returncode == 0, (args, proc.stderr[-2000:])
    finally:
        server.terminate()
        server.wait(timeout=30)
