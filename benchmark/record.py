"""What a run hands its metric readers and its checks."""

from __future__ import annotations

from dataclasses import dataclass, field

from benchmark.trace import TraceSummary


@dataclass
class JobRecord:
    """One job of the window: its size, host wall seconds, the pipeline's
    ``stages_s`` and ``counters``."""
    n_images: int
    wall_s: float
    stages_s: dict
    counters: dict


@dataclass
class RunRecord:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    setup_s: float = 0.0
    window_s: float = 0.0
    jobs: list[JobRecord] = field(default_factory=list)
    flops_per_image: int = 0
    memory_peak_bytes: int = 0  # the whole process, set-up included
    window_peak_bytes: int = 0  # reset when the window opens
    trace: TraceSummary | None = None

    @property
    def images(self) -> int:
        return sum(j.n_images for j in self.jobs)
