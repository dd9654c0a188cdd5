"""The trace reduction on a hand-made Chrome trace: launches inside a
stage's range count for it through the correlation, busy time is the
union of device intervals, idle gaps go to the stage the host was in."""

from __future__ import annotations

import json

import pytest

from benchmark.trace import OUTSIDE, TraceSummary, breakdown, summarize


def _ev(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_summarize(tmp_path):
    events = [
        _ev("user_annotation", "embed", 0, 100),
        _ev("user_annotation", "name", 100, 300),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=2),
        _ev("kernel", "conv", 15, 50, corr=1),
        _ev("kernel", "conv", 60, 80, corr=2),  # runs into the name stage
        _ev("cuda_runtime", "cudaLaunchKernel", 390, 1, corr=3),
        _ev("gpu_memcpy", "Memcpy DtoH", 395, 5, corr=3),
        _ev("kernel", "stray", 500, 10, corr=99),  # no launch: by its time
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = summarize(str(path), {"embed", "name"})
    assert s.window_s == pytest.approx(510e-6)
    assert s.busy_s == pytest.approx((140 - 15 + 5 + 10) * 1e-6)
    assert s.stage_device_s == pytest.approx(
        {"embed": 130e-6, "name": 5e-6, OUTSIDE: 10e-6})
    assert s.idle_s == pytest.approx(
        {"embed": 15e-6, "name": 255e-6, OUTSIDE: 100e-6})
    assert s.durations("conv") == (pytest.approx(130e-6), 2)
    total = TraceSummary()
    total.add(s)
    total.add(s)
    assert total.jobs == 2 and total.op_count["conv"] == 4
    b = breakdown(total)
    assert b["device_ops"][0][0] == "conv"
    assert b["idle_gaps"][0][0] == "name"
