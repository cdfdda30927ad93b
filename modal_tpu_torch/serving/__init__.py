"""Serving tier of the port: the continuous-batching engine and its ASGI app."""

from .api import asgi_request, serving_asgi_app
from .engine import EngineStopped, GenRequest, ServingEngine

__all__ = ["EngineStopped", "GenRequest", "ServingEngine", "asgi_request", "serving_asgi_app"]
