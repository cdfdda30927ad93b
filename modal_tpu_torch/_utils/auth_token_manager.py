"""Input-plane auth token cache with refresh-ahead (the port's copy of
modal_tpu/_utils/auth_token_manager.py).

Reference: `_AuthTokenManager` (py/modal/_utils/auth_token_manager.py:14) —
three states: valid cached token (return it); missing/expired (everyone
blocks while ONE coroutine fetches); expiring within the refresh window
(one coroutine refreshes, others keep using the still-valid token).
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from ..exception import ExecutionError
from ..proto import api_pb2
from .jwt_utils import decode_jwt_claims

REFRESH_WINDOW = 5 * 60.0  # start refreshing this long before expiry
DEFAULT_EXPIRY_OFFSET = 20 * 60.0  # tokens without exp (not expected)


class AuthTokenManager:
    def __init__(self, stub):
        self._stub = stub
        self._token = ""
        self._expiry = 0.0
        self._lock: Optional[asyncio.Lock] = None

    async def get_token(self) -> str:
        if not self._token or self._is_expired():
            await self._refresh_token()  # block everyone: no usable token
        elif self._needs_refresh():
            lock = self._get_lock()
            if not lock.locked():
                await self._refresh_token()
            # else: someone is already refreshing; old token is still valid
        return self._token

    async def _refresh_token(self) -> None:
        lock = self._get_lock()
        # single-flight by design: one AuthTokenGet per expiry, waiters reuse it
        async with lock:  # lint: disable=lock-across-await
            if self._token and not self._needs_refresh():
                return  # another coroutine refreshed while we waited
            resp = await self._stub.AuthTokenGet(api_pb2.AuthTokenGetRequest())
            if not resp.token:
                raise ExecutionError("server returned no input-plane auth token")
            self._token = resp.token
            exp = decode_jwt_claims(resp.token).get("exp")
            self._expiry = float(exp) if exp else time.time() + DEFAULT_EXPIRY_OFFSET

    def _is_expired(self) -> bool:
        return time.time() >= self._expiry

    def _needs_refresh(self) -> bool:
        return time.time() >= self._expiry - REFRESH_WINDOW

    def _get_lock(self) -> asyncio.Lock:
        # created lazily so it binds to the running loop
        if self._lock is None:
            self._lock = asyncio.Lock()
        return self._lock
