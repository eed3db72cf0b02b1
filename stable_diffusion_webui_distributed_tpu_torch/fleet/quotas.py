"""Per-tenant token-bucket quotas (images as the metered unit).

Port of the JAX package's ``fleet/quotas.py``, line for line.

Every admitted request withdraws ``total_images`` tokens from its
tenant's bucket; buckets refill continuously at ``SDTPU_QUOTA_IPM``
images per minute up to a burst ceiling of ``SDTPU_QUOTA_BURST`` tokens.
An empty bucket throttles the request — the dispatcher surfaces that as
HTTP 429 with a ``Retry-After`` derived from the refill rate — so one
flooding tenant cannot crowd the fleet out from under everyone else
(the paper's per-worker pixel-cap guard, generalized to request rate).

``SDTPU_QUOTA_IPM`` unset or <= 0 disables metering entirely (the
default — single-tenant deployments pay nothing).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

DEFAULT_BURST = 8.0


class TokenBucket:
    """Classic continuous-refill token bucket (rate in tokens/second)."""

    def __init__(self, rate: float, burst: float,
                 clock=time.monotonic) -> None:
        self.rate = max(0.0, float(rate))
        self.burst = max(1.0, float(burst))
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst  # guarded-by: _lock
        self._stamp = clock()  # guarded-by: _lock

    def try_take(self, n: float) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._stamp) * self.rate)
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def refund(self, n: float) -> None:
        """Return ``n`` previously-taken tokens (capped at the burst
        ceiling) — for withdrawals whose request was never admitted."""
        with self._lock:
            self._tokens = min(self.burst, self._tokens + max(0.0, n))

    def retry_after(self, n: float) -> float:
        """Seconds until ``n`` tokens will be available (0 if now)."""
        with self._lock:
            now = self._clock()
            tokens = min(self.burst,
                         self._tokens + (now - self._stamp) * self.rate)
            if tokens >= n or self.rate <= 0:
                return 0.0
            return (n - tokens) / self.rate

    def available(self) -> float:
        with self._lock:
            now = self._clock()
            return min(self.burst,
                       self._tokens + (now - self._stamp) * self.rate)


class QuotaLedger:
    """Tenant -> bucket registry; buckets are created on first sight."""

    def __init__(self, images_per_minute: float = 0.0,
                 burst: Optional[float] = None,
                 clock=time.monotonic) -> None:
        self.rate = max(0.0, float(images_per_minute)) / 60.0
        self.burst = DEFAULT_BURST if burst is None else max(1.0, burst)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}  # guarded-by: _lock
        self._throttled = 0  # guarded-by: _lock
        self._admitted = 0  # guarded-by: _lock

    @property
    def enabled(self) -> bool:
        return self.rate > 0

    @classmethod
    def from_env(cls, clock=time.monotonic) -> "QuotaLedger":
        from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
            env_float,
        )

        return cls(images_per_minute=env_float("SDTPU_QUOTA_IPM", 0.0),
                   burst=env_float("SDTPU_QUOTA_BURST", DEFAULT_BURST),
                   clock=clock)

    def _bucket(self, tenant: str) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                b = TokenBucket(self.rate, self.burst, self._clock)
                self._buckets[tenant] = b
            return b

    def admit(self, tenant: str, images: int) -> Optional[float]:
        """None = admitted; a float = throttled, retry after that many
        seconds. Disabled metering admits everything for free."""
        if not self.enabled:
            return None
        b = self._bucket(tenant)
        if b.try_take(float(images)):
            with self._lock:
                self._admitted += 1
            return None
        with self._lock:
            self._throttled += 1
        return max(1.0, b.retry_after(float(images)))

    def refund(self, tenant: str, images: int) -> None:
        """Give back tokens withdrawn for a request that was rejected
        after the quota check (e.g. by SLO admission): tenants are charged
        only for work the fleet actually accepted, and cannot be
        quota-throttled by their own rejected requests."""
        if not self.enabled:
            return
        self._bucket(tenant).refund(float(images))

    def summary(self) -> Dict[str, object]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "images_per_minute": self.rate * 60.0,
                "burst": self.burst,
                "tenants": {t: round(b.available(), 3)
                            for t, b in self._buckets.items()},
                "admitted": self._admitted,
                "throttled": self._throttled,
            }
