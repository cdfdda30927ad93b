"""The wire format of a KV-page shipment between a prefill-role and a
decode-role engine: the bundle `{prompt, first_token, n_tokens, k, v}`
(`ServingEngine.prefill_export`) as `torch.save` bytes.

This is the port's own format. The JAX package ships the same bundle in its
`serialization` frames (cloudpickle with out-of-band buffers); the two are
not byte-compatible, and a shipment crosses only between engines of one
implementation. Decoding loads with `weights_only=True`: only tensors,
numbers, strings and containers of them, never arbitrary objects.
"""

from __future__ import annotations

import io

import torch


def encode(bundle: dict) -> bytes:
    """The bundle as bytes; k and v go as CPU tensors in their own dtype."""
    buf = io.BytesIO()
    torch.save(bundle, buf)
    return buf.getvalue()


def decode(data: bytes) -> dict:
    """The bundle from `encode`'s bytes, its tensors on the CPU."""
    bundle = torch.load(io.BytesIO(data), weights_only=True, map_location="cpu")
    if not isinstance(bundle, dict):
        raise ValueError(f"a KV shipment decodes to a dict, got {type(bundle).__name__}")
    return bundle
