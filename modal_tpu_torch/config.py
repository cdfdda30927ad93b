"""Package logger and the device rule every entry point follows."""

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
