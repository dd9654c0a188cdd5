"""Reduce the profiler's Chrome traces of a run's jobs to what the
per-layer metrics read.

Each job of a traced run writes one trace (``torch.profiler`` with CPU and
CUDA activities, the pipeline's ``profile_dir``), in which every pipeline
stage is a ``record_function`` range (``user_annotation``). A device
operation (a kernel, a copy or a fill) belongs to the stage whose range
holds the host call that launched it, found through the profiler's
launch-to-kernel correlation; a kernel of a CUDA graph shares its graph
launch's correlation. A job's traced window runs from its first stage's
start to the end of its last stage or device operation, whichever is
later. Busy time is the union of the device operations' intervals inside
that window; an idle gap is a stretch of the window with none, attributed
to the stage whose range holds the gap's middle.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside stages"


@dataclass
class TraceSummary:
    """Sums over every traced job of a run (seconds)."""
    jobs: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    # device seconds of the operations launched inside each stage's range
    stage_device_s: dict = field(default_factory=dict)
    # device seconds and launches by operation name
    op_s: dict = field(default_factory=dict)
    op_count: dict = field(default_factory=dict)
    # idle seconds by the stage the host was in
    idle_s: dict = field(default_factory=dict)

    def add(self, other: "TraceSummary") -> None:
        self.jobs += other.jobs
        self.window_s += other.window_s
        self.busy_s += other.busy_s
        for mine, theirs in ((self.stage_device_s, other.stage_device_s),
                             (self.op_s, other.op_s),
                             (self.op_count, other.op_count),
                             (self.idle_s, other.idle_s)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0) + v

    def durations(self, pattern: str) -> tuple[float, int]:
        """(device seconds, launches) of the operations whose name holds
        ``pattern``."""
        names = [k for k in self.op_s if pattern in k]
        return (sum(self.op_s[k] for k in names),
                sum(self.op_count[k] for k in names))


def _merge(intervals: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(path: str, stages: set[str]) -> TraceSummary:
    """The summary of one job's Chrome trace; ``stages`` names the
    pipeline's stage ranges."""
    with open(path, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    ranges, device, launch_ts = [], [], {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == "user_annotation" and ev.get("name") in stages:
            ranges.append((float(ev["ts"]), float(ev["ts"]) + float(
                ev.get("dur", 0)), ev["name"]))
        elif cat in DEVICE_CATS:
            device.append(ev)
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(ev["ts"])
    out = TraceSummary(jobs=1)
    if not ranges:
        return out
    ranges.sort()
    starts = [r[0] for r in ranges]

    def stage_at(ts: float) -> str:
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= ranges[i][1]:
            return ranges[i][2]
        return OUTSIDE

    intervals = []
    for ev in device:
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0))
        intervals.append((ts, ts + dur))
        name = ev.get("name", "?")
        sec = dur * 1e-6
        out.op_s[name] = out.op_s.get(name, 0.0) + sec
        out.op_count[name] = out.op_count.get(name, 0) + 1
        corr = ev.get("args", {}).get("correlation")
        stage = stage_at(launch_ts.get(corr, ts))
        out.stage_device_s[stage] = out.stage_device_s.get(stage, 0.0) + sec
    t0 = ranges[0][0]
    t1 = max([r[1] for r in ranges] + [e for _, e in intervals])
    out.window_s = (t1 - t0) * 1e-6
    cursor = t0
    for s, e in _merge(intervals):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if s > cursor:
            stage = stage_at((cursor + s) / 2)
            out.idle_s[stage] = out.idle_s.get(stage, 0.0) + (
                s - cursor) * 1e-6
        out.busy_s += (e - s) * 1e-6
        cursor = max(cursor, e)
    if t1 > cursor:
        stage = stage_at((cursor + t1) / 2)
        out.idle_s[stage] = out.idle_s.get(stage, 0.0) + (t1 - cursor) * 1e-6
    return out


def breakdown(summary: TraceSummary, n: int = 10) -> dict:
    """The contract's ``breakdown``: the device operations that took most
    time, and the idle time by what the host was doing."""
    ops = sorted(summary.op_s.items(), key=lambda kv: -kv[1])[:n]
    idle = sorted(summary.idle_s.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k[:200], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
