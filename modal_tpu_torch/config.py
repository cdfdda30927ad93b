"""Package logger, the settings the cold-start runtime reads, the device
rule every entry point follows, and the host-to-device copy that does not
wait for the stream."""

from __future__ import annotations

import logging
import os
from typing import Optional, Union

import torch

logger = logging.getLogger("modal_tpu_torch")
if not logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(logging.Formatter("[%(name)s] %(levelname)s %(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(os.environ.get("MODAL_TPU_TORCH_LOGLEVEL", "WARNING").upper())
    logger.propagate = False

# the JAX package's settings that the cold-start runtime reads, under the same
# `MODAL_TPU_<KEY>` environment names and defaults (modal_tpu/config.py:120,
# :127); the port reads the environment only, not the TOML profile
_SETTINGS = {
    # local state: snapshots live under <state_dir>/snapshots
    "state_dir": os.path.expanduser("~/.modal_tpu_state"),
    "compilation_cache_dir": os.path.expanduser("~/.modal_tpu_state/jit_cache"),
}


class _Config:
    """`config[key]`: `MODAL_TPU_<KEY>` when set, else the default; read at
    each access, so a process may point a setting elsewhere at run time."""

    def __getitem__(self, key: str) -> str:
        return os.environ.get("MODAL_TPU_" + key.upper(), _SETTINGS[key])


config = _Config()


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means CUDA. A CUDA request without a usable card raises; the
    CPU is used only when the caller names it (the CPU tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())  # compares equal to tensors' .device
    return dev


def host_to_device(values, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array (numpy, list or CPU tensor) as a tensor on `device`. On
    CUDA the copy goes through pinned memory with `non_blocking=True`: a
    copy from pageable memory waits for every launch queued before it, which
    would put a host sync into code that must only queue work."""
    t = torch.as_tensor(values, dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
