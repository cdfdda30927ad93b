"""Ahead-of-time warm-up of the known entry points (port of
modal_tpu/runtime/aot.py).

The JAX package lowers and compiles each jit entry point against abstract
shapes, so the first real request deserializes an executable instead of
tracing. PyTorch runs eagerly and has nothing to trace; what makes the
first real call cheap here is:

- building (`nvcc`) the hand-written kernels the entry launches
  (`ops/_build.build`), which otherwise happens inside the first call;
- for ``decode``, capturing the step as a CUDA graph. A graph needs real
  buffers (the params, the engine's page pool), so the capture happens
  where they live: `ServingEngine(cuda_graphs=...)` captures at
  construction (`models/paged_kv.DecodeGraph`).

The entry-point catalog is the JAX package's:

- ``train``   — the flash forward and backward kernels (K1, K2, K3)
- ``prefill`` — no kernel: chunks take the gather path, as in the JAX package
- ``decode``  — the paged decode kernel (K4), then the engine's graph
- ``verify``  — no kernel: the gather path
- ``sample``  — no kernel: plain torch ops

Each entry also reports the bytes its params would take for the configured
model, from `llama.init_params_abstract` (meta tensors: no memory).

Gate: ``MODAL_TPU_AOT_LOWER`` — unset/0 → nothing happens; ``1``/``all`` →
every entry; else a csv of entry names, with ``cfg=<name>``/``slots=<n>``/...
option tokens in the same csv (``MODAL_TPU_AOT_LOWER=prefill,decode,cfg=tiny``).
A failing entry is logged and listed under ``"errors"`` in the result; the
rest still run, because a container's ``@enter`` calls `maybe_aot_lower`.
`maybe_aot_lower` imports torch, then puts the fleet compile-cache tier
under the builds (`compile_client.install_fleet_cache`) and attaches the
compile telemetry, as the JAX hook imports jax first: what it builds is
published to the fleet store and counted, and what the store holds is
fetched, not built.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from ..config import logger

AOT_ENV = "MODAL_TPU_AOT_LOWER"

ENTRY_POINTS = ("train", "prefill", "decode", "verify", "sample")

# the kernels each entry launches (ops/_build.SOURCES names)
ENTRY_KERNELS = {
    "train": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
    "prefill": (),
    "decode": ("paged_decode",),
    "verify": (),
    "sample": (),
}

# the JAX package's option tokens and defaults, so one spec string means the
# same in both packages
_DEFAULTS = {
    "cfg": "tiny",
    "slots": 4,
    "num_pages": 64,
    "page_size": 0,  # 0 → models/paged_kv.DEFAULT_PAGE_SIZE
    "max_context": 0,  # 0 → cfg.max_seq_len
    "batch": 8,  # train tokens [batch, seq]
    "seq": 64,
    "spec_k": 4,  # verify step width = spec_k + 1
}


def parse_aot_spec(raw: Optional[str] = None) -> Optional[tuple[list[str], dict]]:
    """``(entries, options)`` from the env spec; None when the gate is off.
    Unknown entry names are dropped (an old container given a newer spec
    warms what it knows)."""
    if raw is None:
        raw = os.environ.get(AOT_ENV, "")
    raw = raw.strip()
    if not raw or raw.lower() in ("0", "false", "no", "off"):
        return None
    entries: list[str] = []
    options = dict(_DEFAULTS)
    for token in (t.strip().lower() for t in raw.split(",")):
        if not token:
            continue
        if "=" in token:
            key, _, value = token.partition("=")
            if key == "cfg":
                options["cfg"] = value
            elif key in options:
                try:
                    options[key] = int(value)
                except ValueError:
                    pass
            continue
        if token in ("1", "all", "true", "on"):
            entries = list(ENTRY_POINTS)
        elif token in ENTRY_POINTS and token not in entries:
            entries.append(token)
    if not entries:
        return None
    return entries, options


def run_aot_lowering(entries: Optional[list[str]] = None, options: Optional[dict] = None) -> dict:
    """Build the kernels of the requested entry points. Returns ``{entry:
    {"executables": kernels built, "kernels", "param_bytes", "seconds",
    "sources": {kernel: "local" | "fleet" | "nvcc"}}}`` for what succeeded;
    failed entries land under ``"errors"``."""
    from ..models.llama import get_config, init_params_abstract
    from ..models.quant import quantized_bytes
    from ..ops import _build

    opts = dict(_DEFAULTS)
    opts.update(options or {})
    cfg = get_config(str(opts["cfg"]))
    param_bytes = quantized_bytes(init_params_abstract(cfg))
    results: dict = {}
    errors: dict = {}
    for entry in entries or list(ENTRY_POINTS):
        if entry not in ENTRY_KERNELS:
            continue
        kernels = ENTRY_KERNELS[entry]
        t0 = time.monotonic()
        try:
            built = _build.build(kernels) if kernels else {}
        except Exception as exc:  # noqa: BLE001 — one entry failing must not stop the rest
            logger.warning(f"AOT warm-up of {entry!r} failed: {exc}")
            errors[entry] = str(exc)
            continue
        results[entry] = {
            "executables": len(kernels), "kernels": list(kernels), "param_bytes": param_bytes,
            "seconds": round(time.monotonic() - t0, 3),
            "sources": {name: r["source"] for name, r in built.items()},
        }
    if errors:
        results["errors"] = errors
    return results


def maybe_aot_lower() -> Optional[dict]:
    """The env-gated hook (a container's @enter): parse MODAL_TPU_AOT_LOWER
    and warm everything requested. None when the gate is off or the spec
    cannot run at all (an unknown cfg); per-entry failures are in the
    result's ``"errors"``. Never raises."""
    spec = parse_aot_spec()
    if spec is None:
        return None
    entries, options = spec
    # torch first (a container of a CPU function has not loaded it), so the
    # fleet tier and the compile telemetry attach before the builds: what
    # the warm-up builds is published and counted
    import torch  # noqa: F401

    from ..observability.device_telemetry import install_compile_hooks
    from .compile_client import install_fleet_cache

    install_fleet_cache()
    install_compile_hooks()
    try:
        t0 = time.monotonic()
        results = run_aot_lowering(entries, options)
    except Exception as exc:  # noqa: BLE001 — warm-up is an optimization, never a failure
        logger.warning(f"AOT warm-up skipped: {exc}")
        return None
    logger.info(
        f"AOT warm-up done in {time.monotonic() - t0:.1f}s: "
        + ", ".join(f"{k}={v['executables']}" for k, v in results.items() if k != "errors")
    )
    return results
