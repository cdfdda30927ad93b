"""User-facing retry policy (port of modal_tpu/retries.py; reference:
py/modal/retries.py:30 `Retries`)."""

from __future__ import annotations

import random

from .exception import InvalidError
from .proto import api_pb2


class Retries:
    """Retry policy for function inputs.

    Bounds mirror the reference (retries.py:52-90): max_retries >= 0,
    initial_delay/max_delay 0-60s, backoff 1-10x.
    """

    def __init__(
        self,
        *,
        max_retries: int,
        backoff_coefficient: float = 2.0,
        initial_delay: float = 1.0,
        max_delay: float = 60.0,
    ):
        if not 0 <= max_retries <= 10:
            raise InvalidError(f"max_retries must be between 0 and 10, got {max_retries}")
        if not 1.0 <= backoff_coefficient <= 10.0:
            raise InvalidError(f"backoff_coefficient must be between 1 and 10, got {backoff_coefficient}")
        if not 0.0 <= initial_delay <= 60.0:
            raise InvalidError(f"initial_delay must be between 0 and 60s, got {initial_delay}")
        if not 0.0 <= max_delay <= 60.0:
            raise InvalidError(f"max_delay must be between 0 and 60s, got {max_delay}")
        if max_delay < initial_delay:
            # e.g. Retries(max_retries=1, initial_delay=30, max_delay=5)
            # silently inverted the bound: every delay was clamped to 5s
            raise InvalidError(
                f"max_delay ({max_delay}s) must be >= initial_delay ({initial_delay}s)"
            )
        self.max_retries = max_retries
        self.backoff_coefficient = backoff_coefficient
        self.initial_delay = initial_delay
        self.max_delay = max_delay

    def to_proto(self) -> api_pb2.RetryPolicy:
        return api_pb2.RetryPolicy(
            retries=self.max_retries,
            backoff_coefficient=self.backoff_coefficient,
            initial_delay_ms=int(self.initial_delay * 1000),
            max_delay_ms=int(self.max_delay * 1000),
        )


class RetryManager:
    """Computes per-attempt delays from a RetryPolicy (reference
    retries.py RetryManager)."""

    def __init__(self, policy: api_pb2.RetryPolicy):
        self._policy = policy

    def attempt_delay(self, retry_count: int, jitter: bool = False) -> float:
        """Delay before the `retry_count`-th attempt. With `jitter`, draws
        full jitter in [0, delay] (AWS-style): a burst of inputs failing
        together then spreads its retries instead of re-arriving as a thundering
        herd at exactly initial_delay * backoff^n."""
        if retry_count <= 0:
            return 0.0
        delay_ms = self._policy.initial_delay_ms * (self._policy.backoff_coefficient ** (retry_count - 1))
        if self._policy.max_delay_ms:
            delay_ms = min(delay_ms, self._policy.max_delay_ms)
        if jitter:
            delay_ms = random.uniform(0.0, delay_ms)
        return delay_ms / 1000.0
