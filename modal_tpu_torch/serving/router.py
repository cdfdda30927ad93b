"""The one piece of the JAX package's fleet router (modal_tpu/serving/router.py)
the port needs so far: the content digest under which an engine advertises
the prefixes its cache holds (`ServingEngine.prefix_digests`)."""

from __future__ import annotations

import hashlib


def prefix_digest(tokens) -> str:
    """Stable content digest of one token prefix. Token-value-based, so any
    engine and router compute identical digests for identical content."""
    h = hashlib.blake2b(digest_size=8)
    h.update(" ".join(str(int(t)) for t in tokens).encode())
    return h.hexdigest()
