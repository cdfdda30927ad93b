"""Serving metrics and spans (the subset of modal_tpu.observability the
engine emits), and the critical-path attribution over the span store."""

from . import critical_path

__all__ = ["critical_path"]
