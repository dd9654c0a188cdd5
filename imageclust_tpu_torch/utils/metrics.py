"""Stage timing + counters (SURVEY.md §5 tracing/observability).

The reference's only instrumentation is a wall-clock log line around the
whole run (internal/workflow/workflow.go:67, :106). Here every stage reports
duration and derived rates, and an optional ``torch.profiler`` trace (CPU
and CUDA activities) captures the device timeline as a Chrome trace for
Perfetto — the port's counterpart of the JAX package's ``jax.profiler``.

Stages do not nest. Work inside a stage is timed as a span (``name/services``,
``cluster/kmeans``, ``embed/drain``): host seconds kept apart from the stages,
and under a trace a ``record_function`` range nested in its stage's range, on
the same clock as the device's operations.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field

log = logging.getLogger(__name__)

__all__ = ["RunMetrics", "StageTimer", "ServiceMetrics", "CollectiveCounters",
           "timed", "traced"]

# per-job naming counters that the service's /metrics adds up
_NAMING_TOTALS = (("naming_calls", "imageclust_naming_calls_total"),
                  ("naming_fallbacks", "imageclust_naming_fallbacks_total"),
                  ("naming_resumed", "imageclust_naming_resumed_total"),
                  ("naming_inline", "imageclust_naming_inline_total"))


def _profiler_active() -> bool:
    """Whether a ``torch.profiler`` trace is recording in this process
    (the profiler's own flag; True where a torch build lacks it, so ranges
    are never lost)."""
    import torch.autograd.profiler as ap

    return getattr(ap, "_is_profiler_enabled", True)


def traced(label: str):
    """A ``record_function`` range named ``label`` while a
    ``torch.profiler`` trace records; otherwise nothing, at the cost of
    the check."""
    if _profiler_active():
        import torch

        return torch.profiler.record_function(label)
    return contextlib.nullcontext()


@contextlib.contextmanager
def timed(into: dict, key: str, label: str | None = None):
    """Adds the block's host seconds (``time.perf_counter``) to
    ``into[key]``. While a ``torch.profiler`` trace records, the block is
    also a ``record_function`` range named ``label`` (default ``key``)."""
    start = time.perf_counter()
    try:
        with traced(label or key):
            yield
    finally:
        into[key] = into.get(key, 0.0) + time.perf_counter() - start


class ServiceMetrics:
    """Process-wide counters for the /metrics endpoint (Prometheus text
    exposition format). The reference exposes no metrics at all
    (SURVEY.md §5 observability)."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self.counters: dict[str, float] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def observe_run(self, run: "RunMetrics") -> None:
        self.inc("imageclust_images_total", run.counters.get("images", 0))
        self.inc("imageclust_clusters_total", run.counters.get("clusters", 0))
        self.inc("imageclust_dropped_total", run.counters.get("dropped", 0))
        for key, total in _NAMING_TOTALS:
            self.inc(total, run.counters.get(key, 0))
        for stage, seconds in run.stages.items():
            self.inc(f"imageclust_stage_seconds_total{{stage=\"{stage}\"}}",
                     seconds)

    def render(self) -> str:
        with self._lock:
            lines = [
                "# TYPE imageclust_jobs_total counter",
                "# TYPE imageclust_images_total counter",
                "# TYPE imageclust_stage_seconds_total counter",
                *(f"# TYPE {total} counter" for _, total in _NAMING_TOTALS),
            ]
            for name in sorted(self.counters):
                lines.append(f"{name} {self.counters[name]:.6g}")
        return "\n".join(lines) + "\n"


@dataclass
class RunMetrics:
    """A job's host seconds by stage (``stages``; stages do not nest), by
    span inside a stage (``spans``, named ``<stage>/<part>``) and its
    counters."""
    stages: dict[str, float] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)
    spans: dict[str, float] = field(default_factory=dict)

    def rate(self, counter: str, stage: str) -> float | None:
        if counter in self.counters and self.stages.get(stage):
            return self.counters[counter] / self.stages[stage]
        return None

    def to_dict(self) -> dict:
        out = {"stages_s": dict(self.stages), "spans_s": dict(self.spans),
               "counters": dict(self.counters)}
        embed_rate = self.rate("images", "embed")
        if embed_rate is not None:
            out["images_per_sec_embed"] = embed_rate
        return out


class StageTimer:
    def __init__(self, metrics: RunMetrics, profile_dir: str | None = None):
        self.metrics = metrics
        self.profile_dir = profile_dir

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        with timed(self.metrics.stages, name):
            yield
        log.info("stage %-12s %.3fs", name, time.perf_counter() - start)

    def span(self, name: str):
        """A part of the open stage, ``name`` as ``<stage>/<part>``: its
        seconds go to ``metrics.spans``, never to ``metrics.stages``."""
        return timed(self.metrics.spans, name)

    @contextlib.contextmanager
    def profiled(self):
        """Wrap a whole run in a torch.profiler trace when profile_dir is
        set; the Chrome trace lands in ``profile_dir/trace.json``."""
        if not self.profile_dir:
            yield
            return
        import os

        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.profile_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(self.profile_dir, "trace.json"))


class CollectiveCounters:
    """Calls and bytes of the mesh collectives, by name
    (:mod:`imageclust_tpu_torch.core.collectives` adds to them), and the
    host seconds spent inside them (``seconds``). Bytes are each call's
    local payload: what this rank sends."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls: dict[str, int] = {}
        self.bytes: dict[str, int] = {}
        self.seconds = 0.0

    def add(self, name: str, nbytes: int) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.bytes[name] = self.bytes.get(name, 0) + int(nbytes)

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "seconds": self.seconds}
