"""Serving tier of the port (port of modal_tpu/serving/__init__.py).

Two halves share this package:

- `reload`: the hot reload (deploy in a subprocess, redeploy on a file
  change), eager: it loads no torch.
- `engine` / `api` / `service` / `router`: the continuous-batching engine
  over the paged KV pool, its SSE/JSON ASGI surface, the `@app.cls`
  deployment helper `llm_service` and the fleet router. The first three are
  lazy attributes: the engine pulls in torch, which a deploying client and
  the CLI must not pay for.
"""

from .reload import serve_app, watch  # noqa: F401

__all__ = [
    "EngineStopped",
    "GenRequest",
    "ServingEngine",
    "serve_app",
    "watch",
    "serving_asgi_app",
    "asgi_request",
    "llm_service",
]

_LAZY = {
    "ServingEngine": ("engine", "ServingEngine"),
    "GenRequest": ("engine", "GenRequest"),
    "EngineStopped": ("engine", "EngineStopped"),
    "serving_asgi_app": ("api", "serving_asgi_app"),
    "asgi_request": ("api", "asgi_request"),
    "llm_service": ("service", "llm_service"),
}


def __getattr__(name: str):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module = importlib.import_module(f".{entry[0]}", __name__)
    value = getattr(module, entry[1])
    globals()[name] = value
    return value
