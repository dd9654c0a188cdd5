"""Shared token-bucket rate limiter for network stages (labeling + naming).

One implementation serves both scaled stages: NamingService bounds LLM
requests/second across every cluster and service worker
(naming/registry.py), and LabelingService bounds labeler requests/second
across every in-flight image (labels/service.py). The reference has no rate
limiting anywhere — its only throttle is being strictly serial
(workflow.go:120-147) or retrying after a 429 (openai.go:124-128).
"""

from __future__ import annotations

import threading
import time

__all__ = ["RateLimiter"]


class RateLimiter:
    """Thread-safe token bucket bounding requests/second across every
    worker that shares it. ``clock``/``sleep`` are injectable for
    mock-clocked tests. ``rps <= 0`` disables limiting."""

    def __init__(self, rps: float, clock=time.monotonic, sleep=time.sleep):
        self.interval = 1.0 / rps if rps > 0 else 0.0
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._next = clock()

    def acquire(self) -> None:
        if not self.interval:
            return
        with self._lock:
            now = self._clock()
            wait = self._next - now
            self._next = max(self._next, now) + self.interval
        if wait > 0:
            self._sleep(wait)
