"""The naming layer's counter readers on a hand-made run, and the trace
reduction unchanged by ranges nested inside a stage (the program's spans,
``name/services`` or ``cluster/kmeans``, which are never given to it as
stages)."""

from __future__ import annotations

import json

import pytest

from benchmark.manifest import Manifest
from benchmark.record import JobRecord, RunRecord
from benchmark.trace import summarize

READERS = {"name_call_s": "naming_call_s",
           "name_state_write_s": "naming_state_write_s"}


def _run(counters: list[dict]) -> RunRecord:
    rec = RunRecord({}, {}, {}, 1, 1.0)
    rec.jobs = [JobRecord(10, 1.0, {"name": 0.5}, c) for c in counters]
    return rec


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_means_the_jobs_that_have_it(metric):
    read = Manifest().reader(metric)
    key = READERS[metric]
    assert read(_run([{"images": 10}, {"images": 10}])) is None
    assert read(_run([])) is None
    assert read(_run([{key: 0.25}, {key: 0.75}, {"images": 10}])) == \
        pytest.approx(0.5)


def _ev(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_nested_ranges_change_no_summary(tmp_path):
    stages = [
        _ev("user_annotation", "embed", 0, 100),
        _ev("user_annotation", "cluster", 100, 100),
        _ev("user_annotation", "name", 200, 300),
        _ev("user_annotation", "report", 500, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=1),
        _ev("kernel", "conv", 15, 90, corr=1),  # runs into the cluster stage
        _ev("cuda_runtime", "cudaLaunchKernel", 130, 1, corr=2),
        _ev("kernel", "merge_loop_whole", 135, 20, corr=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 260, 1, corr=3),
        _ev("gpu_memcpy", "Memcpy DtoH", 262, 4, corr=3),
    ]
    nested = [
        _ev("user_annotation", "embed/drain", 90, 10),
        _ev("user_annotation", "cluster/kmeans", 102, 40),
        _ev("user_annotation", "cluster/bucket-repair", 145, 50),
        _ev("user_annotation", "name/details", 201, 30),
        _ev("user_annotation", "name/services", 240, 250),
    ]
    four = {"embed", "cluster", "name", "report"}
    sums = []
    for i, events in enumerate((stages, stages + nested)):
        path = tmp_path / f"trace{i}.json"
        path.write_text(json.dumps({"traceEvents": events}))
        sums.append(summarize(str(path), four))
    plain, with_spans = sums
    assert with_spans.stage_device_s == pytest.approx(plain.stage_device_s)
    assert with_spans.idle_s == pytest.approx(plain.idle_s)
    assert with_spans.busy_s == pytest.approx(plain.busy_s)
    assert with_spans.window_s == pytest.approx(plain.window_s)
    assert set(plain.idle_s) == {"embed", "cluster", "name"}
    # given as stages, the nested ranges would split the stages' seconds
    leaked = summarize(str(path), four | {e["name"] for e in nested})
    assert leaked.idle_s != pytest.approx(plain.idle_s)
