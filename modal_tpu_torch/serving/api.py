"""HTTP surface of the serving engine: JSON + SSE over ASGI 3 (port of
modal_tpu/serving/api.py).

Routes:

- ``POST /v1/generate`` — body ``{"prompt": [ids...]} | {"text": "..."}``
  plus ``max_new_tokens``, ``stream``, ``request_id``, ``eos_token_id`` and
  the sampling fields ``temperature``, ``top_k``, ``top_p``, ``seed``.
  ``stream=false`` answers one JSON object at completion; ``stream=true``
  answers ``text/event-stream``: a ``start`` event with the request id, one
  ``token`` event per generated token (SSE ``id`` = token index), and a
  final ``done`` event.
- ``GET /v1/result/{request_id}`` — the buffered result (blocks until the
  request completes): a client whose stream died re-fetches every token
  exactly once from the engine's per-request buffer.
- ``POST /v1/prefill`` — the prefill leg of a disaggregated request: runs
  the prompt's prefill, exports its KV pages as a shipment
  (`shipment.py`) and answers ``{"kv_ref", "first_token", "n_tokens",
  "request_id"}``. The shipment goes to ``$MODAL_TPU_KV_SHIP_URL/blob/<name>``
  by HTTP PUT when that is set and ``MODAL_TPU_BLOB_LOCAL_DIR`` is not; else,
  or when the PUT fails, to a file under ``MODAL_TPU_BLOB_LOCAL_DIR`` (the
  temp dir when unset).
- ``POST /v1/prefilled`` — the decode leg: ``kv_ref`` plus the generate
  fields. The engine imports the shipped pages and goes straight to decode;
  an unreadable or mismatched shipment degrades to a local prefill (the
  same tokens, a later first token). A missing ``kv_ref`` is a 400.
- ``GET /v1/stats`` — engine stats; ``GET /healthz`` — liveness.

``text`` prompts use byte-level tokens (ids 0-255).
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import tempfile
import time
import urllib.request
from typing import Callable, Optional

from ..config import logger
from ..observability import tracing
from ..observability.catalog import SERVING_STREAM_EVENTS
from . import shipment as wire
from .engine import EngineStopped, GenRequest, ServingEngine

BLOB_LOCAL_DIR_ENV = "MODAL_TPU_BLOB_LOCAL_DIR"
KV_SHIP_URL_ENV = "MODAL_TPU_KV_SHIP_URL"
# chaos: cut the next N SSE streams after their first token event, as a
# transport loss would; the request finishes in the engine and its buffer
# stays readable through GET /v1/result/{id}
STREAM_RESET_ENV = "MODAL_TPU_CHAOS_SERVING_STREAM_RESETS"
_chaos_resets: dict = {"remaining": None}


def _consume_stream_reset() -> bool:
    """Take one unit of the stream-reset budget, read from the env at first
    use (tests set the env, then `_reset_chaos_for_tests()`)."""
    if _chaos_resets["remaining"] is None:
        try:
            _chaos_resets["remaining"] = int(os.environ.get(STREAM_RESET_ENV, "0") or 0)
        except ValueError:
            logger.warning(f"ignoring malformed {STREAM_RESET_ENV}")
            _chaos_resets["remaining"] = 0
    if _chaos_resets["remaining"] > 0:
        _chaos_resets["remaining"] -= 1
        return True
    return False


def _reset_chaos_for_tests() -> None:
    _chaos_resets["remaining"] = None


class _StreamReset(Exception):
    """Raised mid-SSE to kill the connection the way a transport loss
    would: the response has started, so the server can only truncate it."""


def _decode_prompt(body: dict, vocab_size: int) -> list[int]:
    if "prompt" in body:
        prompt = body["prompt"]
        if not isinstance(prompt, list) or not all(isinstance(t, int) for t in prompt):
            raise ValueError("'prompt' must be a list of int token ids")
        bad = [t for t in prompt if not 0 <= t < vocab_size]
        if bad:
            raise ValueError(f"token ids out of range [0, {vocab_size}): {bad[:5]}")
        return prompt
    if "text" in body:
        if vocab_size < 256:
            raise ValueError("byte-level 'text' prompts need vocab_size >= 256")
        data = str(body["text"]).encode("utf-8")
        if not data:
            raise ValueError("empty text prompt")
        return list(data)
    raise ValueError("body needs 'prompt' (token ids) or 'text'")


def _sse(event: str, data: dict, event_id: Optional[int] = None) -> bytes:
    lines = [f"event: {event}"]
    if event_id is not None:
        lines.append(f"id: {event_id}")
    lines.append(f"data: {json.dumps(data, separators=(',', ':'))}")
    return ("\n".join(lines) + "\n\n").encode()


def _result_payload(req: GenRequest, vocab_size: int) -> dict:
    out = {
        "request_id": req.id,
        "tokens": list(req.tokens),
        "num_tokens": len(req.tokens),
        "ttft_s": req.ttft_s,
        "preemptions": req.preemptions,
        "temperature": req.temperature,
        "top_k": req.top_k,
        "top_p": req.top_p,
        "seed": req.seed,
    }
    if req.error:
        out["error"] = req.error
    if vocab_size >= 256 and all(t < 256 for t in req.tokens):
        out["text"] = bytes(req.tokens).decode("utf-8", "replace")
    return out


def _parse_sampling(body: dict, defaults: dict) -> dict:
    """Validate temperature/top_k/top_p/seed; omitted fields take the
    service defaults. Bad values are 400s here, before the engine."""
    temperature = body.get("temperature", defaults.get("temperature", 0.0))
    try:
        temperature = float(temperature)
    except (TypeError, ValueError):
        raise ValueError(f"temperature must be a number, got {temperature!r}")
    if math.isnan(temperature) or math.isinf(temperature) or temperature < 0:
        raise ValueError(f"temperature must be finite and >= 0, got {temperature}")
    top_k = body.get("top_k", defaults.get("top_k", 0))
    if not isinstance(top_k, int) or isinstance(top_k, bool) or top_k < 0:
        raise ValueError(f"top_k must be an int >= 0, got {top_k!r}")
    top_p = body.get("top_p", defaults.get("top_p", 1.0))
    try:
        top_p = float(top_p)
    except (TypeError, ValueError):
        raise ValueError(f"top_p must be a number, got {top_p!r}")
    if math.isnan(top_p) or not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    seed = body.get("seed", defaults.get("seed", 0))
    if not isinstance(seed, int) or isinstance(seed, bool):
        raise ValueError(f"seed must be an int, got {seed!r}")
    return {"temperature": temperature, "top_k": top_k, "top_p": top_p, "seed": seed}


def _ship_dir() -> str:
    d = os.environ.get(BLOB_LOCAL_DIR_ENV, "") or tempfile.gettempdir()
    os.makedirs(d, exist_ok=True)
    return d


def _ship_url_base() -> str:
    """The blob plane's base URL for shipments between engines that share no
    filesystem; empty when a shared dir is configured (it is preferred)."""
    if os.environ.get(BLOB_LOCAL_DIR_ENV, ""):
        return ""
    return os.environ.get(KV_SHIP_URL_ENV, "").strip().rstrip("/")


def _ship_put_http(base: str, name: str, payload: bytes) -> str:
    """PUT the shipment to the blob plane; returns the URL the decode leg
    reads. Raises on a transport failure (the caller writes a file)."""
    url = f"{base}/blob/{name}"
    req = urllib.request.Request(url, data=payload, method="PUT")
    urllib.request.urlopen(req, timeout=15.0).close()
    return url


def _ship_get_http(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=15.0) as resp:
        return resp.read()


def _write_file(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _read_shipment(kv_ref: str) -> dict:
    """http(s) refs come from a prefill engine on another host; anything
    else is a file of the shared-dir handoff."""
    if kv_ref.startswith(("http://", "https://")):
        return wire.decode(_ship_get_http(kv_ref))
    with open(kv_ref, "rb") as f:
        return wire.decode(f.read())


async def _lifespan_protocol(receive, send) -> None:
    """Complete the ASGI lifespan protocol (no startup/shutdown work)."""
    while True:
        msg = await receive()
        if msg["type"] == "lifespan.startup":
            await send({"type": "lifespan.startup.complete"})
        elif msg["type"] == "lifespan.shutdown":
            await send({"type": "lifespan.shutdown.complete"})
            return


def serving_asgi_app(
    engine: ServingEngine,
    max_new_tokens_limit: int = 4096,
    sampling_defaults: Optional[dict] = None,
) -> Callable:
    """Build the ASGI 3 application fronting `engine`."""
    vocab_size = engine.cfg.vocab_size
    defaults = dict(sampling_defaults or {})

    async def send_json(send, status: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        await send(
            {
                "type": "http.response.start",
                "status": status,
                "headers": [
                    (b"content-type", b"application/json"),
                    (b"content-length", str(len(data)).encode()),
                ],
            }
        )
        await send({"type": "http.response.body", "body": data})

    async def read_body(receive) -> bytes:
        body = b""
        while True:
            msg = await receive()
            if msg["type"] != "http.request":
                return body
            body += msg.get("body", b"")
            if not msg.get("more_body"):
                return body

    async def wait_done(req: GenRequest) -> None:
        offset, done = 0, False
        while not done:
            new, done = await req.wait_new_async(offset, timeout=None)
            offset += len(new)

    async def handle_generate(receive, send) -> None:
        try:
            raw = await read_body(receive)
            body = json.loads(raw) if raw else {}
            if not isinstance(body, dict):
                raise ValueError("JSON body must be an object")
            prompt = _decode_prompt(body, vocab_size)
            max_new = int(body.get("max_new_tokens", 64))
            if not 1 <= max_new <= max_new_tokens_limit:
                raise ValueError(f"max_new_tokens must be in [1, {max_new_tokens_limit}]")
            stream = bool(body.get("stream", False))
            eos = body.get("eos_token_id")
            request_id = str(body.get("request_id", ""))
            sampling = _parse_sampling(body, defaults)
        except (ValueError, json.JSONDecodeError) as exc:
            await send_json(send, 400, {"error": str(exc)})
            return
        try:
            req = engine.submit(
                prompt, max_new, request_id=request_id,
                eos_token_id=int(eos) if eos is not None else None,
                **sampling,
            )
        except EngineStopped as exc:
            # backpressure (429: retry here) vs drain (503: retry elsewhere)
            await send_json(send, 429 if "queue full" in str(exc) else 503, {"error": str(exc)})
            return
        except ValueError as exc:
            await send_json(send, 400, {"error": str(exc)})
            return
        if not stream:
            await wait_done(req)
            await send_json(send, 500 if req.error else 200, _result_payload(req, vocab_size))
            return
        await stream_sse(send, req)

    async def stream_sse(send, req: GenRequest) -> None:
        """SSE delivery with a cursor into the request's buffer. A transport
        death (or the chaos reset) mid-stream leaves the buffer intact: the
        client re-reads through GET /v1/result/{id}."""
        await send(
            {
                "type": "http.response.start",
                "status": 200,
                "headers": [
                    (b"content-type", b"text/event-stream"),
                    (b"cache-control", b"no-cache"),
                    (b"x-accel-buffering", b"no"),
                ],
            }
        )
        SERVING_STREAM_EVENTS.inc(event="open")
        chaos_this_stream = _consume_stream_reset()
        with tracing.span("serving.stream", attrs={"request_id": req.id}, parent=req.trace_context):
            start = {
                "request_id": req.id,
                "temperature": req.temperature,
                "top_k": req.top_k,
                "top_p": req.top_p,
                "seed": req.seed,
            }
            await send({"type": "http.response.body", "body": _sse("start", start), "more_body": True})
            offset = 0
            try:
                while True:
                    tokens, done = await req.wait_new_async(offset, timeout=30.0)
                    for i, tok in enumerate(tokens):
                        await send(
                            {
                                "type": "http.response.body",
                                "body": _sse("token", {"token": tok, "i": offset + i}, event_id=offset + i),
                                "more_body": True,
                            }
                        )
                        SERVING_STREAM_EVENTS.inc(event="token")
                        if chaos_this_stream:
                            raise _StreamReset()
                    offset += len(tokens)
                    if done:
                        break
                    if not tokens:
                        # keep-alive comment per the SSE spec (idle admission queue)
                        await send(
                            {"type": "http.response.body", "body": b": keep-alive\n\n", "more_body": True}
                        )
                await send(
                    {
                        "type": "http.response.body",
                        "body": _sse("done", _result_payload(req, vocab_size)),
                        "more_body": True,
                    }
                )
                SERVING_STREAM_EVENTS.inc(event="done")
                await send({"type": "http.response.body", "body": b""})
            except _StreamReset:
                SERVING_STREAM_EVENTS.inc(event="reset")
                logger.warning(f"serving: chaos stream reset for {req.id} (buffer intact)")
                raise ConnectionResetError(f"chaos serving stream reset ({req.id})")

    async def handle_prefill(receive, send) -> None:
        """Prefill leg: generate exactly the first token, export the prompt's
        KV pages and park them behind a reference. The pages never transit
        the HTTP response; only the reference does."""
        try:
            raw = await read_body(receive)
            body = json.loads(raw) if raw else {}
            if not isinstance(body, dict):
                raise ValueError("JSON body must be an object")
            prompt = _decode_prompt(body, vocab_size)
            request_id = str(body.get("request_id", ""))
            sampling = _parse_sampling(body, defaults)
        except (ValueError, json.JSONDecodeError) as exc:
            await send_json(send, 400, {"error": str(exc)})
            return
        try:
            req = engine.prefill_export(prompt, request_id=request_id, **sampling)
        except EngineStopped as exc:
            await send_json(send, 429 if "queue full" in str(exc) else 503, {"error": str(exc)})
            return
        except ValueError as exc:
            await send_json(send, 400, {"error": str(exc)})
            return
        await wait_done(req)
        if req.error or req.shipment is None:
            await send_json(send, 500, {"error": req.error or "prefill produced no shipment"})
            return
        payload = await asyncio.to_thread(wire.encode, req.shipment)
        req.shipment = None  # the reference is the handoff; drop the host copy
        kv_ref = ""
        ship_base = _ship_url_base()
        if ship_base:
            # no shared filesystem: a failed PUT degrades to the file path
            # (worst case the decode leg prefills again), never to a 500
            try:
                kv_ref = await asyncio.to_thread(_ship_put_http, ship_base, f"kvship-{req.id}", payload)
            except Exception as exc:  # noqa: BLE001 — degrade, never 500 a good prefill
                logger.warning(f"serving: kv ship via {ship_base} failed ({exc}); local file")
        if not kv_ref:
            kv_ref = os.path.join(_ship_dir(), f"kvship-{req.id}.bin")
            await asyncio.to_thread(_write_file, kv_ref, payload)
        await send_json(
            send,
            200,
            {
                "kv_ref": kv_ref,
                "first_token": req.tokens[0] if req.tokens else None,
                "n_tokens": len(prompt),
                "request_id": req.id,
            },
        )

    async def handle_prefilled(receive, send) -> None:
        """Decode leg: land a shipped prefill and answer like /v1/generate.
        A shipment that cannot be read or does not fit degrades to a local
        prefill, not an error."""
        try:
            raw = await read_body(receive)
            body = json.loads(raw) if raw else {}
            if not isinstance(body, dict):
                raise ValueError("JSON body must be an object")
            prompt = _decode_prompt(body, vocab_size)
            kv_ref = str(body.get("kv_ref", ""))
            if not kv_ref:
                raise ValueError("'kv_ref' is required (the reference /v1/prefill answered)")
            max_new = int(body.get("max_new_tokens", 64))
            if not 1 <= max_new <= max_new_tokens_limit:
                raise ValueError(f"max_new_tokens must be in [1, {max_new_tokens_limit}]")
            stream = bool(body.get("stream", False))
            eos = body.get("eos_token_id")
            request_id = str(body.get("request_id", ""))
            sampling = _parse_sampling(body, defaults)
        except (ValueError, json.JSONDecodeError) as exc:
            await send_json(send, 400, {"error": str(exc)})
            return
        bundle = None
        try:
            bundle = await asyncio.to_thread(_read_shipment, kv_ref)
        except Exception as exc:  # noqa: BLE001 — any unreadable shipment degrades to a local prefill
            logger.warning(f"serving: kv_ref {kv_ref!r} unreadable ({exc}); local prefill")
        kwargs = dict(
            request_id=request_id, eos_token_id=int(eos) if eos is not None else None, **sampling
        )
        try:
            try:
                req = engine.submit_prefilled(prompt, bundle, max_new, **kwargs)
            except ValueError as exc:
                if bundle is None or "shipment" not in str(exc):
                    raise
                # the shipment does not fit, the request does: prefill locally
                logger.warning(f"serving: shipment rejected ({exc}); local prefill")
                req = engine.submit_prefilled(prompt, None, max_new, **kwargs)
        except EngineStopped as exc:
            await send_json(send, 429 if "queue full" in str(exc) else 503, {"error": str(exc)})
            return
        except ValueError as exc:
            await send_json(send, 400, {"error": str(exc)})
            return
        if not stream:
            await wait_done(req)
            await send_json(send, 500 if req.error else 200, _result_payload(req, vocab_size))
            return
        await stream_sse(send, req)

    async def handle_result(receive, send, request_id: str) -> None:
        await read_body(receive)
        req = engine.get(request_id)
        if req is None:
            await send_json(send, 404, {"error": f"unknown request {request_id!r}"})
            return
        SERVING_STREAM_EVENTS.inc(event="buffered_fallback")
        await wait_done(req)
        await send_json(send, 500 if req.error else 200, _result_payload(req, vocab_size))

    async def app(scope, receive, send):
        if scope["type"] == "lifespan":
            return await _lifespan_protocol(receive, send)
        if scope["type"] != "http":
            return
        path = scope.get("path", "/")
        method = scope.get("method", "GET").upper()
        try:
            if path == "/healthz" and method == "GET":
                await read_body(receive)
                await send_json(send, 200, {"ok": True, "time": time.time()})
            elif path == "/v1/stats" and method == "GET":
                await read_body(receive)
                await send_json(send, 200, engine.stats())
            elif path == "/v1/generate" and method == "POST":
                await handle_generate(receive, send)
            elif path == "/v1/prefill" and method == "POST":
                await handle_prefill(receive, send)
            elif path == "/v1/prefilled" and method == "POST":
                await handle_prefilled(receive, send)
            elif path.startswith("/v1/result/") and method == "GET":
                await handle_result(receive, send, path[len("/v1/result/"):])
            else:
                await read_body(receive)
                await send_json(send, 404, {"error": f"no route {method} {path}"})
        except (ConnectionResetError, BrokenPipeError, asyncio.CancelledError):
            raise
        except Exception as exc:  # noqa: BLE001 — one request must not kill the app
            logger.warning(f"serving api error on {method} {path}: {exc}")
            try:
                await send_json(send, 500, {"error": f"{type(exc).__name__}: {exc}"})
            except Exception:  # noqa: BLE001 — a started response (SSE) cannot take a second start
                pass

    return app


async def asgi_request(app: Callable, method: str, path: str, body: Optional[dict] = None) -> tuple[int, bytes]:
    """Drive one HTTP exchange through an ASGI app in process (no socket).
    Returns (status, response body bytes)."""
    payload = json.dumps(body).encode() if body is not None else b""
    sent = False
    status = 0
    chunks: list[bytes] = []

    async def receive():
        nonlocal sent
        if not sent:
            sent = True
            return {"type": "http.request", "body": payload, "more_body": False}
        await asyncio.sleep(3600)
        return {"type": "http.disconnect"}

    async def send(msg):
        nonlocal status
        if msg["type"] == "http.response.start":
            status = msg["status"]
        elif msg["type"] == "http.response.body":
            chunks.append(msg.get("body", b""))

    scope = {"type": "http", "method": method, "path": path, "headers": []}
    await app(scope, receive, send)
    return status, b"".join(chunks)
