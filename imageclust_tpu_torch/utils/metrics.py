"""Stage timing + counters (SURVEY.md §5 tracing/observability).

The reference's only instrumentation is a wall-clock log line around the
whole run (internal/workflow/workflow.go:67, :106). Here every stage reports
duration and derived rates, and an optional ``torch.profiler`` trace (CPU
and CUDA activities) captures the device timeline as a Chrome trace for
Perfetto — the port's counterpart of the JAX package's ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field

log = logging.getLogger(__name__)

__all__ = ["RunMetrics", "StageTimer", "ServiceMetrics"]


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
        for stage, seconds in run.stages.items():
            self.inc(f"imageclust_stage_seconds_total{{stage=\"{stage}\"}}",
                     seconds)

    def render(self) -> str:
        with self._lock:
            lines = [
                "# TYPE imageclust_jobs_total counter",
                "# TYPE imageclust_images_total counter",
                "# TYPE imageclust_stage_seconds_total counter",
            ]
            for name in sorted(self.counters):
                lines.append(f"{name} {self.counters[name]:.6g}")
        return "\n".join(lines) + "\n"


@dataclass
class RunMetrics:
    stages: dict[str, float] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)

    def rate(self, counter: str, stage: str) -> float | None:
        if counter in self.counters and self.stages.get(stage):
            return self.counters[counter] / self.stages[stage]
        return None

    def to_dict(self) -> dict:
        out = {"stages_s": dict(self.stages), "counters": dict(self.counters)}
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
        ctx = contextlib.nullcontext()
        if self.profile_dir:
            import torch

            ctx = torch.profiler.record_function(name)
        start = time.perf_counter()
        with ctx:
            yield
        elapsed = time.perf_counter() - start
        self.metrics.stages[name] = self.metrics.stages.get(name, 0.0) + elapsed
        log.info("stage %-12s %.3fs", name, elapsed)

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
