"""Request gate: optional API-key auth + per-client rate limiting.

Counterpart of ``jpdvt_mt_ntnu_tpu/serve/gate.py`` (pure Python, copied).
The reference service is wide open — CORS-all, no auth, no limits
(reference: api/app.py:49-55) — acceptable for a demo box, not for a
service fronting a GPU where one 250-step faithful solve costs real
device time. This gate is shared by BOTH transports (FastAPI and the
stdlib server) so the policy cannot drift between them.

Policy (all opt-in, off by default = reference-compatible):
- ``api_key``: when set, mutating ``/api`` POSTs must present it in an
  ``X-API-Key`` header (or ``Authorization: Bearer <key>``). Compared
  constant-time. 401 otherwise. GETs (models list, SPA) stay open.
- ``rate_limit`` requests/second with burst ``rate_burst``: classic token
  bucket per client id (X-Forwarded-For-aware). 429 with Retry-After
  when drained. Authenticated and anonymous clients are tracked apart.

Env fallbacks (picked up by ServiceConfig defaults in serve/service.py):
``JPDVT_API_KEY``, ``JPDVT_RATE_LIMIT`` (float, req/s),
``JPDVT_RATE_BURST`` (int).
"""

from __future__ import annotations

import hmac
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class GateDecision:
    status: int             # 0 = allow; else HTTP status (401 / 429)
    detail: str = ""
    retry_after: float = 0.0

    @property
    def allowed(self) -> bool:
        return self.status == 0


@dataclass
class AccessGate:
    api_key: str = ""
    rate_limit: float = 0.0          # sustained requests/second; 0 = off
    rate_burst: int = 0              # bucket size; 0 = ceil(2 * rate_limit)
    clock: Callable[[], float] = time.monotonic
    # client id -> (tokens, last refill time)
    _buckets: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    # bound the per-client table: an address-spoofing client must not be
    # able to grow host memory without limit
    max_clients: int = 10_000

    def _burst(self) -> float:
        return float(self.rate_burst or max(1, int(2 * self.rate_limit + 0.5)))

    def _check_key(self, presented: Optional[str]) -> bool:
        if not self.api_key:
            return True
        return bool(presented) and hmac.compare_digest(
            presented.encode(), self.api_key.encode())

    def _take_token(self, client: str) -> float:
        """Refill-and-take; returns 0.0 on success else seconds to wait."""
        now = self.clock()
        burst = self._burst()
        with self._lock:
            if len(self._buckets) >= self.max_clients and \
                    client not in self._buckets:
                self._buckets.clear()   # crude but bounded; refills on use
            tokens, last = self._buckets.get(client, (burst, now))
            tokens = min(burst, tokens + (now - last) * self.rate_limit)
            if tokens >= 1.0:
                self._buckets[client] = (tokens - 1.0, now)
                return 0.0
            self._buckets[client] = (tokens, now)
            return (1.0 - tokens) / self.rate_limit

    def check(self, client: str, headers: dict) -> GateDecision:
        """Gate one mutating request. ``headers`` keys must be lowercase."""
        presented = headers.get("x-api-key")
        if not presented:
            auth = headers.get("authorization", "")
            if auth.lower().startswith("bearer "):
                presented = auth[7:].strip()
        if not self._check_key(presented):
            return GateDecision(401, "invalid or missing API key")
        if self.rate_limit > 0:
            # authenticated traffic is one pool per key-presenting client;
            # X-Forwarded-For (first hop) identifies clients behind proxies
            fwd = headers.get("x-forwarded-for", "")
            cid = (fwd.split(",")[0].strip() or client) if fwd else client
            wait = self._take_token(cid)
            if wait > 0:
                return GateDecision(
                    429, "rate limit exceeded", retry_after=round(wait, 3))
        return GateDecision(0)
