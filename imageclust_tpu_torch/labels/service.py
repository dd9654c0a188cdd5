"""Scaled labeling stage — the ``name_clusters`` treatment for per-image labels.

The reference labels strictly serially (workflow.go:120-147): one blocking
Rekognition round trip per image, no retries, no rate control, no progress.
At the engine's 100k tier that is ~100k HTTPS calls. This service gives the
labeling stage the same machinery the naming stage already has
(naming/registry.py name_clusters):

* bounded, configurable concurrency (``LabelConfig.concurrency``),
* a shared token-bucket rate limiter across the whole job
  (``LabelConfig.rate_limit_rps``) that gates only actual network calls —
  cache hits never consume a token,
* bounded per-image retries with a configurable delay,
* progress counters (a log line every ~5% by default, injectable callback),
* resumable state: the content-addressed label cache (labels/base.py)
  persists each completed image atomically, so an aborted or crashed job
  re-runs without re-querying anything already labeled — the labeling
  counterpart of naming's JSONL resume.

One service instance spans a whole job, including the streamed big-job path
where :meth:`detect_all` is called once per embed chunk: the limiter,
retry budget, and progress counter are job-global, not per-chunk.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from imageclust_tpu_torch.labels.base import CachedLabeler, Label, Labeler
from imageclust_tpu_torch.utils.ratelimit import RateLimiter

log = logging.getLogger(__name__)

__all__ = ["LabelingService", "create_labeling_service"]


class LabelingService:
    def __init__(
        self,
        labeler: Labeler,
        max_labels: int,
        min_confidence: float,
        *,
        concurrency: int = 8,
        rate_limit_rps: float = 0.0,
        retries: int = 3,
        retry_delay_s: float = 1.0,
        total: int | None = None,
        sleep=time.sleep,
    ):
        self.labeler = labeler
        self.max_labels = max_labels
        self.min_confidence = min_confidence
        self.concurrency = max(1, concurrency)
        self.limiter = RateLimiter(rate_limit_rps)
        self.retries = max(1, retries)
        self.retry_delay_s = retry_delay_s
        self.total = total
        self._sleep = sleep
        self._done = 0
        self._lock = threading.Lock()
        # Gate the limiter on actual network traffic: CachedLabeler acquires
        # it only on a cache MISS (before the inner backend call); for an
        # uncached labeler every call is a real call.
        if isinstance(labeler, CachedLabeler):
            labeler.limiter = self.limiter
            self._acquire_per_call = False
        else:
            self._acquire_per_call = True

    # ------------------------------------------------------------------

    def _one(self, blob: bytes) -> list[Label]:
        last: Exception | None = None
        for attempt in range(self.retries):
            try:
                if self._acquire_per_call:
                    self.limiter.acquire()
                return self.labeler.detect_labels(
                    blob, self.max_labels, self.min_confidence)
            except Exception as exc:  # noqa: BLE001 — backend contract is
                last = exc  # "any failure", mirroring the namers' retry loop
                log.warning("labeler failed (attempt %d/%d): %s",
                            attempt + 1, self.retries, exc)
                if attempt + 1 < self.retries:
                    self._sleep(self.retry_delay_s)
        # Abort the job loudly (reference parity: a labeling failure aborts
        # the request, workflow.go:74-97) — but every image labeled before
        # this point is already persisted in the content-hash cache, so the
        # re-run resumes instead of starting over.
        assert last is not None
        raise last

    def detect_all(self, blobs: list[bytes], progress=None) -> list[list[Label]]:
        """Label ``blobs`` with bounded concurrency; order-preserving.

        ``progress(done, total)`` fires on each completion (``done`` counts
        across every ``detect_all`` call on this instance — chunked callers
        get job-global progress)."""
        if not blobs:
            return []
        total = self.total if self.total is not None else len(blobs)
        every = max(1, total // 20)

        def run(blob: bytes) -> list[Label]:
            labels = self._one(blob)
            with self._lock:
                self._done += 1
                n = self._done
            if progress is not None:
                progress(n, total)
            elif n % every == 0 or n == total:
                log.info("labeling: %d/%d images", n, total)
            return labels

        if self.concurrency == 1 or len(blobs) == 1:
            return [run(b) for b in blobs]
        workers = min(self.concurrency, len(blobs))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(run, blobs))


def create_labeling_service(
    labeler: Labeler, cfg, total: int | None = None
) -> LabelingService:
    """Build the service from a LabelConfig (concurrency / rate limit /
    retry knobs all live there)."""
    return LabelingService(
        labeler,
        cfg.max_labels,
        cfg.min_confidence,
        concurrency=cfg.concurrency,
        rate_limit_rps=cfg.rate_limit_rps,
        retries=cfg.retries,
        retry_delay_s=cfg.retry_delay_s,
        total=total,
    )
