"""Minimal HS256 JWT encode/decode (stdlib only) for the input-plane auth
tokens (the port's copy of modal_tpu/_utils/jwt_utils.py).

Reference: the input plane authenticates with an `x-modal-auth-token` JWT
whose `exp` claim drives client-side refresh-ahead
(reference py/modal/_utils/auth_token_manager.py:28-51). The token is a
plain HS256 three-parter, so the standard library is enough.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Any, Optional


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(part: str) -> bytes:
    return base64.urlsafe_b64decode(part + "=" * (-len(part) % 4))


def encode_jwt(claims: dict[str, Any], secret: bytes, ttl_s: Optional[float] = None) -> str:
    """HS256 JWT; `ttl_s` sets/overrides the exp claim relative to now."""
    header = {"alg": "HS256", "typ": "JWT"}
    payload = dict(claims)
    if ttl_s is not None:
        payload["exp"] = int(time.time() + ttl_s)
    signing_input = f"{_b64url(json.dumps(header, separators=(',', ':')).encode())}.{_b64url(json.dumps(payload, separators=(',', ':')).encode())}"
    sig = hmac.new(secret, signing_input.encode(), hashlib.sha256).digest()
    return f"{signing_input}.{_b64url(sig)}"


def decode_jwt_claims(token: str) -> dict[str, Any]:
    """Decode the payload WITHOUT verifying (client-side exp inspection —
    the server is the verifier)."""
    try:
        return json.loads(_b64url_decode(token.split(".")[1]))
    except Exception:  # noqa: BLE001 — malformed token = no claims
        return {}


def verify_jwt(token: str, secret: bytes) -> Optional[dict[str, Any]]:
    """Constant-time signature check + exp check. Returns claims or None."""
    try:
        signing_input, _, sig_part = token.rpartition(".")
        expected = hmac.new(secret, signing_input.encode(), hashlib.sha256).digest()
        if not hmac.compare_digest(expected, _b64url_decode(sig_part)):
            return None
        claims = decode_jwt_claims(token)
        exp = claims.get("exp")
        if exp is not None and time.time() > float(exp):
            return None
        return claims
    except Exception:  # noqa: BLE001
        return None
