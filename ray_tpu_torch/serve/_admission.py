"""Serve admission pieces the serving engine uses.

Copies of `RequestRejectedError` (ray_tpu/serve/_admission.py) — the
typed rejection an engine raises when its queue is full — and of the
SLO window helpers `_SLO_WINDOW_S` / `_p95_ms` (ray_tpu/serve/_replica.py)
with the nearest-rank `percentile` they call (ray_tpu/util/metrics.py).
The router-side AdmissionController waits for the serve runtime's port.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

# Latency samples older than this never reach the autoscaler.
_SLO_WINDOW_S = 15.0


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ASCENDING-sorted sequence
    (0 <= q <= 1).  Returns 0.0 on empty input."""
    if not sorted_vals:
        return 0.0
    idx = min(int(len(sorted_vals) * q), len(sorted_vals) - 1)
    return sorted_vals[idx]


def _p95_ms(samples: List[float]) -> Optional[float]:
    """p95 of a list of second-valued samples, in ms (None if empty)."""
    if not samples:
        return None
    return percentile(sorted(samples), 0.95) * 1000.0


class RequestRejectedError(RuntimeError):
    """A request shed at admission (typed so ingress layers can map it
    to 429 without string matching): reason, retry-after hint, and the
    deployment/priority/tenant it was judged against."""

    def __init__(self, deployment: str = "", reason: str = "overloaded",
                 retry_after_s: float = 0.5, priority: str = "normal",
                 tenant_id: str = "") -> None:
        self.deployment = deployment
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.priority = priority
        self.tenant_id = tenant_id
        super().__init__(
            f"request to {deployment!r} rejected: {reason} "
            f"(priority={priority}, tenant={tenant_id!r}, "
            f"retry after {retry_after_s:g}s)")

    def __reduce__(self):
        # A custom __init__ needs an explicit reduce, or unpickling
        # loses the structured fields.
        return (RequestRejectedError,
                (self.deployment, self.reason, self.retry_after_s,
                 self.priority, self.tenant_id))
