"""Serving metrics and spans (the subset of modal_tpu.observability the
engine emits)."""
