"""Observability: distributed tracing and the process-wide metrics registry,
with the fleet tier on top of them.

- ``tracing``: spans (trace and span ids, parent, name, start and end,
  attrs) in a JSONL store under the plane's state dir; the context crosses
  client → server in gRPC metadata and server → container in the input and
  the `MODAL_TPU_TRACE_*` env, so one `.remote()` is one stitched trace.
- ``metrics``: counters, gauges and histograms with bounded label sets,
  exposed as Prometheus text at ``GET /metrics`` on the blob server;
  ``catalog`` declares every family (`METRIC_CATALOG`) and every span name
  (`SPAN_CATALOG`) the port emits, and ``instrumented_rpc_names()`` the
  RPCs the server-side instruments cover.
- ``timeseries`` (the plane's tiered history of the registry), ``slo``
  (multi-window burn-rate alerts), ``quantile`` (the one quantile rule),
  ``profiler`` (folded-stack sampling), ``device_telemetry`` (the card's
  memory, step times and compile events, and the heartbeat report), and
  ``critical_path`` (where a call's wall time went).

These are the JAX package's names (`__all__`). `critical_path` is bound
here; the rest load on first access, so importing `tracing` loads no more
than it did.
"""

import importlib

from . import critical_path

# public name -> (submodule, attribute or None for the module itself)
_LAZY = {
    "tracing": ("tracing", None),
    "metrics": ("metrics", None),
    "profiler": ("profiler", None),
    "device_telemetry": ("device_telemetry", None),
    "quantile": ("quantile", None),
    "slo": ("slo", None),
    "timeseries": ("timeseries", None),
    "REGISTRY": ("metrics", "REGISTRY"),
    "METRIC_CATALOG": ("catalog", "METRIC_CATALOG"),
    "SPAN_CATALOG": ("catalog", "SPAN_CATALOG"),
    "instrumented_rpc_names": ("catalog", "instrumented_rpc_names"),
}

__all__ = [
    "tracing",
    "metrics",
    "critical_path",
    "profiler",
    "device_telemetry",
    "quantile",
    "slo",
    "timeseries",
    "REGISTRY",
    "METRIC_CATALOG",
    "SPAN_CATALOG",
    "instrumented_rpc_names",
]


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module_name, attr = _LAZY[name]
    module = importlib.import_module(f".{module_name}", __name__)
    value = module if attr is None else getattr(module, attr)
    globals()[name] = value
    return value
