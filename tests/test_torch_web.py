"""The port's web endpoints, `llm_service`, the cron loop and the hot reload
against the JAX package's, on the CPU.

The web scenarios run through `modal_tpu.App` and `modal_tpu_torch.App`
side by side, on the module's two planes (`tests/test_torch_app.Planes`: a
JAX `LocalSupervisor` and the port's, containers of each package's
entrypoint). `llm_service` serves the fp32 `tiny` model from a safetensors
checkpoint written by the JAX package's `export_checkpoint` from
`init_params(PRNGKey(0))`; its /v1/generate tokens are held to the JAX
serving flow's (`serving_asgi_app` over JAX's `ServingEngine`) on the same
weights."""

import asyncio
import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap
import threading
import time
import urllib.error
import urllib.request

import grpc
import pytest

import modal_tpu_torch
from modal_tpu_torch.proto import api_pb2
from tests.test_torch_app import CONTAINER_ENV, Planes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def planes():
    saved = {k: os.environ.get(k) for k in CONTAINER_ENV}
    os.environ.update(CONTAINER_ENV)
    p = Planes(tempfile.mkdtemp(prefix="web-", dir="/tmp"))
    try:
        yield p
    finally:
        p.close()
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)


def _http(url: str, method: str = "GET", body=None, timeout: float = 60.0) -> tuple:
    """(status, body bytes, content type) of one request."""
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method, headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), resp.headers.get("content-type", "")
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read(), exc.headers.get("content-type", "")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_four_web_types_answer_the_same_bodies_on_both_planes(planes):
    """A plain-function endpoint (JSON in, JSON out; GET query, POST body,
    a 400 on a bad argument, a 405 on a wrong method), an ASGI app, a WSGI
    app and a `@web_server` behind the container's reverse proxy answer
    the same status and bodies through each package's plane."""

    def scenario(m, client, sup):
        app = m.App("web-types")
        server_port = _free_port()

        def make():
            @app.function(serialized=True)
            @m.web_endpoint(method="POST")
            def add(a: int = 1, b: int = 2):
                return {"sum": int(a) + int(b)}

            @app.function(serialized=True)
            @m.asgi_app()
            def asgi():
                async def app_(scope, receive, send):
                    if scope["type"] == "lifespan":
                        while True:
                            msg = await receive()
                            kind = msg["type"].rsplit(".", 1)[-1]
                            await send({"type": f"lifespan.{kind}.complete"})
                            if kind == "shutdown":
                                return
                    body = (await receive()).get("body", b"")
                    out = json.dumps({"path": scope["path"], "method": scope["method"], "len": len(body),
                                      "query": scope["query_string"].decode()}).encode()
                    await send({"type": "http.response.start", "status": 201,
                                "headers": [(b"content-type", b"application/json"),
                                            (b"content-length", str(len(out)).encode())]})
                    await send({"type": "http.response.body", "body": out})

                return app_

            @app.function(serialized=True)
            @m.wsgi_app()
            def wsgi():
                def app_(environ, start_response):
                    size = int(environ.get("CONTENT_LENGTH") or 0)
                    body = environ["wsgi.input"].read(size)
                    start_response("202 Accepted", [("Content-Type", "text/plain")])
                    return [f"{environ['REQUEST_METHOD']} {environ['PATH_INFO']} ".encode(), body[::-1]]

                return app_

            @app.function(serialized=True)
            @m.web_server(port=server_port, startup_timeout=30)
            def server():
                import http.server
                import threading

                class Handler(http.server.BaseHTTPRequestHandler):
                    def do_GET(self):
                        out = f"upstream {self.path}".encode()
                        self.send_response(200)
                        self.send_header("content-type", "text/plain")
                        self.send_header("content-length", str(len(out)))
                        self.end_headers()
                        self.wfile.write(out)

                    def log_message(self, *args):
                        pass

                srv = http.server.ThreadingHTTPServer(("127.0.0.1", server_port), Handler)
                threading.Thread(target=srv.serve_forever, daemon=True).start()

            return add, asgi, wsgi, server

        add, asgi, wsgi, server = make()
        out = {}
        with app.run(client=client):
            urls = {name: f.get_web_url(timeout=60) for name, f in
                    (("add", add), ("asgi", asgi), ("wsgi", wsgi), ("server", server))}
            for name, url in urls.items():
                assert url.startswith("http://127.0.0.1:"), url
            out["add_post"] = _http(urls["add"], "POST", {"a": 40, "b": 2})[:2]
            out["add_get"] = _http(urls["add"] + "?a=5&b=6")[:2]
            out["add_bad"] = _http(urls["add"], "POST", {"c": 1})[0]
            out["add_put"] = _http(urls["add"], "PUT", {"a": 1})[0]
            out["asgi"] = _http(urls["asgi"] + "/x/y?q=1", "POST", b"abcd")[:2]
            out["wsgi"] = _http(urls["wsgi"] + "/w", "POST", b"hello")[:2]
            out["server"] = _http(urls["server"] + "/deep/path?k=v")[:2]
        return out

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"]["add_post"] == (200, b'{"result": {"sum": 42}}')
    assert got["port"]["add_get"] == (200, b'{"result": {"sum": 11}}')
    assert (got["port"]["add_bad"], got["port"]["add_put"]) == (400, 405)
    assert got["port"]["asgi"][0] == 201 and json.loads(got["port"]["asgi"][1]) == {
        "path": "/x/y", "method": "POST", "len": 4, "query": "q=1"}
    assert got["port"]["wsgi"] == (202, b"POST /w olleh")
    assert got["port"]["server"] == (200, b"upstream /deep/path?k=v")


def test_get_web_url_long_polls_and_fast_fails_a_non_web_function(planes):
    """`get_web_url` on a plain function fails at once with
    INVALID_ARGUMENT; on a web function whose container takes ~3 s to come
    up, a 1 s poll finds no URL (ExecutionError) and a longer one waits it
    out; the function's handle metadata carries the URL afterwards."""

    def scenario(m, client, sup):
        app = m.App("web-poll")

        def make():
            @app.function(serialized=True)
            def plain(x):
                return x

            @app.function(serialized=True)
            @m.asgi_app()
            def slow():
                import time

                time.sleep(3.0)

                async def app_(scope, receive, send):
                    if scope["type"] == "lifespan":
                        return
                    await send({"type": "http.response.start", "status": 200, "headers": []})
                    await send({"type": "http.response.body", "body": b"up"})

                return app_

            return plain, slow

        plain, slow = make()
        out = {}
        with app.run(client=client):
            t0 = time.monotonic()
            try:
                plain.get_web_url(timeout=30)
            except grpc.aio.AioRpcError as exc:
                out["plain"] = (exc.code().name, exc.details(), time.monotonic() - t0 < 5)
            try:
                slow.get_web_url(timeout=1)
                out["short"] = "url"
            except Exception as exc:  # noqa: BLE001 — the type is compared
                out["short"] = (type(exc).__name__, str(exc))
            t0 = time.monotonic()
            url = slow.get_web_url(timeout=30)
            out["long"] = (_http(url)[:2], time.monotonic() - t0 < 30)
            got_url = (sup.state.functions[slow.object_id].web_url == url)
            out["state_url"] = got_url
        return out

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"]["plain"] == ("INVALID_ARGUMENT", "function has no web endpoint (webhook_type unset)", True)
    assert got["port"]["short"] == ("ExecutionError", "web endpoint did not come up (is webhook_type set?)")
    assert got["port"]["long"] == ((200, b"up"), True) and got["port"]["state_url"]


def test_a_period_schedule_fires_on_both_planes(planes):
    """A `Period(seconds=1)` function fires from the control plane's cron
    loop with no caller: each fire is a server-originated call of one
    zero-argument input that completes."""

    def scenario(m, client, sup):
        app = m.App("cron")

        def tick():
            return "tick"

        fn = app.function(serialized=True, schedule=m.Period(seconds=1))(tick)
        with app.run(client=client):
            deadline = time.monotonic() + 30
            fires = []
            while time.monotonic() < deadline:
                fires = [c for c in list(sup.state.function_calls.values())
                         if c.function_id == fn.object_id and c.server_originated]
                if sum(1 for c in fires if c.num_done >= 1) >= 2:
                    break
                time.sleep(0.2)
            done = [c for c in fires if c.num_done >= 1]
            outputs = sorted({o.result.status for c in done for o in c.outputs})
            return {"fired_twice": len(done) >= 2, "one_input_each": all(c.num_inputs == 1 for c in done),
                    "statuses": outputs, "next_fire_ahead": sup.state.functions[fn.object_id].next_fire_at > 0}

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == {"fired_twice": True, "one_input_each": True,
                           "statuses": [api_pb2.GENERIC_STATUS_SUCCESS], "next_fire_ahead": True}


GREEDY = {"prompt": [1, 2, 3, 4, 5], "max_new_tokens": 8}
SAMPLED = {"prompt": list(range(40, 77)), "max_new_tokens": 6, "temperature": 0.8, "top_p": 0.9, "seed": 7}


def _generate(app, body: dict) -> list:
    """/v1/generate through an in-process ASGI app: the tokens."""
    from modal_tpu_torch.serving.api import asgi_request  # a plain ASGI client, for either package's app

    status, raw = asyncio.run(asgi_request(app, "POST", "/v1/generate", body))
    assert status == 200, raw
    return json.loads(raw)["tokens"]


@pytest.fixture(scope="module")
def tiny_checkpoint():
    """The fp32 tiny params of PRNGKey(0) as the JAX package writes them;
    the JAX serving flow's greedy tokens on them, and the port's in-process
    flow's sampled tokens on them (a sampled stream draws from each
    framework's own generator)."""
    import jax
    import jax.numpy as jnp
    import torch

    from modal_tpu.models.llama import get_config, init_params
    from modal_tpu.models.weights import export_checkpoint
    from modal_tpu.serving.api import serving_asgi_app as jax_app
    from modal_tpu.serving.engine import ServingEngine as JaxEngine
    from modal_tpu_torch.models import llama as tllama
    from modal_tpu_torch.models.weights import load_params
    from modal_tpu_torch.serving import ServingEngine, serving_asgi_app

    cfg = get_config("tiny", dtype=jnp.float32)
    params = init_params(cfg, jax.random.PRNGKey(0))
    root = tempfile.mkdtemp(prefix="ckpt-", dir="/tmp")
    export_checkpoint(params, cfg, root)
    geometry = dict(max_slots=4, num_pages=41, page_size=16)
    engine = JaxEngine(params, cfg, **geometry).start()
    try:
        greedy = _generate(jax_app(engine), GREEDY)
    finally:
        engine.stop()
    tcfg = tllama.get_config("tiny", dtype=torch.float32)
    engine = ServingEngine(load_params(root, tcfg, device="cpu"), tcfg, device="cpu", **geometry).start()
    try:
        port_greedy = _generate(serving_asgi_app(engine), GREEDY)
        sampled = _generate(serving_asgi_app(engine), SAMPLED)
    finally:
        engine.stop()
    assert port_greedy == greedy
    return root, greedy, sampled


def test_llm_service_serves_generate_with_jax_tokens(planes, tiny_checkpoint):
    """`llm_service` through `app.run()` on the port's plane: `@enter`
    loads the checkpoint and starts the engine, the `@asgi_app` method
    serves /v1/generate (JSON and SSE) from the container, /v1/stats counts
    the requests; the greedy tokens equal the JAX flow's on the same weights,
    the sampled stream the port's in-process flow's. An SLO-targeted service
    deploys with its targets kept."""
    ckpt, greedy_want, sampled_want = tiny_checkpoint
    client = planes.tclient
    app = modal_tpu_torch.App("llm-cpu")
    Service = modal_tpu_torch.serving.llm_service(
        app, model="tiny", checkpoint=ckpt, max_slots=4, num_pages=41, page_size=16, name="TinyLLM",
        device="cpu", dtype="float32", gpu="H100", timeout=300)
    with app.run(client=client):
        url = Service.get_web_url(timeout=60)
        status, raw, _ct = _http(url + "/v1/generate", "POST", GREEDY)
        assert status == 200, raw
        greedy = json.loads(raw)
        status, raw, ct = _http(url + "/v1/generate", "POST", {**SAMPLED, "stream": True})
        assert status == 200 and ct.startswith("text/event-stream"), (status, ct)
        events = [json.loads(line[6:]) for line in raw.decode().splitlines() if line.startswith("data: ")]
        streamed = [e["token"] for e in events if "token" in e]
        stats = json.loads(_http(url + "/v1/stats")[1])
    assert greedy["tokens"] == greedy_want
    assert greedy["request_id"].startswith("gr-ta-"), greedy["request_id"]
    assert streamed == sampled_want == events[-1]["tokens"]
    assert stats["requests_completed"] >= 2 and stats["device"] == "cpu" and stats["cuda_graphs"] is False

    # an SLO-targeted service deploys since the SLO autoscaler (4d-ii): the
    # plane keeps its targets on the class's function
    slo = modal_tpu_torch.App("llm-slo")
    modal_tpu_torch.serving.llm_service(slo, model="tiny", device="cpu", target_ttft_ms=500,
                                        target_tokens_per_replica=900)
    with slo.run(client=client):
        kept = [fn.autoscaler for fn in list(planes.tsup.state.functions.values())
                if fn.app_id == slo.app_id]
    assert [(a.target_ttft_ms, a.target_tokens_per_replica) for a in kept] == [(500.0, 900.0)]


def test_serve_app_redeploys_a_changed_file(planes, tmp_path):
    """`serve_app` in a subprocess deploys a file's app through the port's
    runner, and deploys it again when the file changes: the deployed
    function answers the new code."""
    script = tmp_path / "served_app.py"

    def source(version: str) -> str:
        return textwrap.dedent(f"""
            import modal_tpu_torch

            app = modal_tpu_torch.App("serve-e2e")

            @app.function(serialized=True, name="echo")
            def echo():
                return "{version}"
            """)

    script.write_text(source("v1"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env.update({"MODAL_TPU_SERVER_URL": planes.tsup.server_url, "PYTHONPATH": REPO})
    code = (f"import asyncio; from modal_tpu_torch.serving import serve_app; "
            f"asyncio.run(serve_app({str(script)!r}, {str(script) + '::app'!r}))")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def deployed_value(timeout: float) -> str:
        deadline, last = time.monotonic() + timeout, None
        while time.monotonic() < deadline:
            try:
                fn = modal_tpu_torch.Function.from_name("serve-e2e", "echo")
                fn.hydrate(planes.tclient)
                return fn.remote()
            except Exception as exc:  # noqa: BLE001 — the deploy may not have landed yet
                last = exc
                time.sleep(0.5)
        raise AssertionError(f"the deployed function never answered: {last}")

    try:
        assert deployed_value(60) == "v1"
        time.sleep(1.2)  # a distinct mtime on coarse filesystems
        script.write_text(source("v2"))
        deadline, value = time.monotonic() + 60, "v1"
        while time.monotonic() < deadline and value != "v2":
            value = deployed_value(30)
            if value != "v2":
                time.sleep(1)
        assert value == "v2", "the redeploy after the change never took effect"
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()


def test_serving_package_and_llm_service_load_no_torch():
    """`import modal_tpu_torch.serving` and reading `llm_service` and
    `serve_app` (what a deploying client touches) load no torch; the
    engine loads it on first access."""
    code = textwrap.dedent("""
        import sys
        import modal_tpu_torch
        from modal_tpu_torch.serving import llm_service, serve_app
        assert modal_tpu_torch.serving.llm_service is llm_service and callable(serve_app)
        assert "torch" not in sys.modules, "torch loaded"
        app = modal_tpu_torch.App("x")
        llm_service(app, model="llama3-8b", gpu="H100")
        assert "torch" not in sys.modules, "torch loaded by llm_service"
        modal_tpu_torch.serving.ServingEngine
        assert "torch" in sys.modules
        print("clean")
        """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-3000:]


def test_a_web_function_definition_reaches_the_plane_with_min_containers(planes):
    """The web decorators' params land in the function definition as the
    JAX App writes them (webhook type, HTTP method, the server's port and
    startup timeout), and the plane keeps at least one container of a web
    function warm."""

    def scenario(m, client, sup):
        app = m.App("web-def")

        def make():
            @app.function(serialized=True)
            @m.fastapi_endpoint(method="GET")
            def f():
                return 1

            @app.function(serialized=True, min_containers=0)
            @m.web_server(port=8765, startup_timeout=12)
            def g():
                pass

            return f, g

        f, g = make()
        defs = {}
        with app.run(client=client):
            for name, fn in (("f", f), ("g", g)):
                d = sup.state.functions[fn.object_id].definition
                defs[name] = (d.webhook_type, dict(d.experimental_options).get("web_method"),
                              dict(d.experimental_options).get("web_server_port"),
                              dict(d.experimental_options).get("web_server_startup_timeout"),
                              d.autoscaler_settings.min_containers)
        return defs

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == {"f": (api_pb2.WEB_ENDPOINT_TYPE_FUNCTION, "GET", None, None, 1),
                           "g": (api_pb2.WEB_ENDPOINT_TYPE_WEB_SERVER, None, "8765", "12", 1)}


def test_a_class_web_method_serves_its_enter_state(planes):
    """A class whose one `@asgi_app` method serves what its `@enter` hook
    built; a second web method on one class is refused at decoration."""

    def scenario(m, client, sup):
        app = m.App("cls-web")

        def make():
            @app.cls(serialized=True)
            class Svc:
                @m.enter()
                def load(self):
                    self.greeting = "loaded"

                @m.asgi_app()
                def web(self):
                    greeting = self.greeting

                    async def app_(scope, receive, send):
                        if scope["type"] == "lifespan":
                            return
                        await send({"type": "http.response.start", "status": 200, "headers": []})
                        await send({"type": "http.response.body", "body": greeting.encode()})

                    return app_

            return Svc

        Svc = make()
        with app.run(client=client):
            url = Svc.get_web_url(timeout=60)
            body = _http(url + "/")[:2]
        try:
            @app.cls(serialized=True)
            class Two:
                @m.asgi_app()
                def a(self):
                    pass

                @m.wsgi_app()
                def b(self):
                    pass
            refused = ""
        except Exception as exc:  # noqa: BLE001 — the type is compared
            refused = type(exc).__name__
        return {"body": body, "refused": refused}

    got = planes.both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == {"body": (200, b"loaded"), "refused": "InvalidError"}


def test_proxy_to_port_streams_a_chunked_upstream_without_aiohttp():
    """The port's `@web_server` proxy speaks HTTP/1.1 over asyncio streams:
    a chunked upstream response arrives de-framed, headers kept, and an
    unreachable upstream answers 502."""
    import http.server

    from modal_tpu_torch.runtime.asgi import AsgiHttpServer, proxy_to_port

    class Chunked(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):
            body = self.rfile.read(int(self.headers["content-length"]))
            self.send_response(200)
            self.send_header("x-up", "1")
            self.send_header("transfer-encoding", "chunked")
            self.end_headers()
            for part in (b"echo:", body, b"!" * 70000):
                self.wfile.write(f"{len(part):x}\r\n".encode() + part + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")

        def log_message(self, *args):
            pass

    up = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Chunked)
    threading.Thread(target=up.serve_forever, daemon=True).start()
    loop = asyncio.new_event_loop()
    threading.Thread(target=loop.run_forever, daemon=True).start()
    proxy = AsgiHttpServer(proxy_to_port(up.server_address[1]))
    dead = AsgiHttpServer(proxy_to_port(_free_port()))
    for srv in (proxy, dead):
        asyncio.run_coroutine_threadsafe(srv.start(), loop).result(10)
    try:
        req = urllib.request.Request(proxy.url + "/p", data=b"abc", method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 200 and resp.headers["x-up"] == "1"
            assert resp.read() == b"echo:abc" + b"!" * 70000
        status, body, _ct = _http(dead.url + "/")
        assert status == 502 and b"unreachable" in body
    finally:
        for srv in (proxy, dead):
            asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        up.shutdown()
