"""The port's spans and counters inside its stages.

A job's ``RunMetrics.stages`` hold its four (or more) stage seconds and
nothing else; parts of a stage are spans (``name/services``,
``cluster/kmeans``, ``embed/drain``) in ``RunMetrics.spans``, each within
its stage's seconds and, under ``profile_dir``, a ``record_function`` range
nested in its stage's range of the Chrome trace. The naming service counts
its calls, fallbacks, resumes and clusters named in the calling thread per
job, and times its calls and state writes.
"""

import json

import numpy as np
import pytest
import torch

from imageclust_tpu_torch.cluster import sharded as tsh
from imageclust_tpu_torch.config import (
    AppConfig,
    ClusterConfig,
    LabelConfig,
    NamingConfig,
)
from imageclust_tpu_torch.data.loader import decode_images
from imageclust_tpu_torch.naming.base import FALLBACK_PHRASE, FALLBACK_TITLE
from imageclust_tpu_torch.naming.fake import FakeNamer
from imageclust_tpu_torch.naming.registry import (
    NAMING_COUNTERS,
    NamingService,
)
from imageclust_tpu_torch.parallel._worker import mean_color_embedder
from imageclust_tpu_torch.pipeline import Pipeline
from imageclust_tpu_torch.utils.metrics import (
    RunMetrics,
    ServiceMetrics,
    StageTimer,
)

from helpers import color_group_images

torch.set_num_threads(1)

_STAGES = {"embed", "cluster", "name", "report"}
_ENGINE = {"cluster/kmeans", "cluster/bucket-repair", "cluster/bucket-merges",
           "cluster/merge-restamp", "cluster/reconstruction",
           "cluster/finalize"}
_NAMING = {"name/details", "name/services", "name/assign"}
_PHASES = {"quantize", "kmeans", "bucket-repair", "bucket-merges",
           "merge-restamp", "reconstruction", "spill-local", "spill-global",
           "finalize"}


def _pipeline(labels="none", **cluster):
    cfg = AppConfig(labels=LabelConfig(backend=labels),
                    naming=NamingConfig(services=("fake",), retries=1),
                    cluster=ClusterConfig(**cluster))
    return Pipeline(cfg, device="cpu", embedder=mean_color_embedder())


@pytest.fixture(scope="module")
def images():
    """24 images in 6 colour groups of 4, decoded at the toy tower's 16
    px."""
    names, blobs = color_group_images(np.random.default_rng(3), n_groups=6,
                                      per_group=4, size=16)
    return names, blobs, decode_images(blobs, size=16)


def _stream(pipe, imgs, work, **kw):
    return pipe.run_stream((imgs[s:s + 8] for s in range(0, len(imgs), 8)),
                           len(imgs), str(work), min_size=3, max_size=6, **kw)


def _within_stages(metrics: RunMetrics) -> None:
    for stage, seconds in metrics.stages.items():
        parts = [v for k, v in metrics.spans.items()
                 if k.startswith(stage + "/")]
        assert sum(parts) <= seconds, stage


class TestSpans:
    def test_run_stream_fills_the_spans(self, images, tmp_path):
        _, _, imgs = images
        res = _stream(_pipeline(exact_limit=4, bucket_size=8), imgs,
                      tmp_path)
        m = res.metrics
        assert set(m.stages) == _STAGES  # no span leaks into the stages
        assert {"embed/drain"} | _ENGINE | _NAMING <= set(m.spans)
        assert all(k.split("/")[0] in _STAGES for k in m.spans)
        _within_stages(m)
        assert {k.split("/")[1] for k in m.spans
                if k.startswith("cluster/")} <= _PHASES
        assert m.to_dict()["spans_s"] == m.spans

    @pytest.mark.parametrize("exact_limit", [1000, 4],
                             ids=["one_forward", "streamed"])
    def test_run_paths_fills_the_spans(self, images, tmp_path, exact_limit):
        names, blobs, _ = images
        paths = []
        for n, b in zip(names, blobs):
            paths.append(str(tmp_path / n))
            with open(paths[-1], "wb") as fh:
                fh.write(b)
        pipe = _pipeline(labels="fake", exact_limit=exact_limit,
                         bucket_size=8)
        res = pipe.run_paths(paths, str(tmp_path / "w"), min_size=3,
                             max_size=6)
        m = res.metrics
        assert "embed/drain" in m.spans and _NAMING <= set(m.spans)
        assert not set(m.spans) & set(m.stages)
        assert (_ENGINE <= set(m.spans)) == (exact_limit < len(names))
        _within_stages(m)

    def test_stage_and_span_keep_apart(self):
        m = RunMetrics()
        timer = StageTimer(m)
        with timer.stage("name"):
            with timer.span("name/services"):
                pass
            with timer.span("name/services"):
                pass
        assert set(m.stages) == {"name"} and set(m.spans) == {
            "name/services"}
        assert m.spans["name/services"] <= m.stages["name"]

    def test_ranges_follow_the_profiler(self, monkeypatch):
        """A trace started outside ``profile_dir`` records the stage and
        span ranges too; without one no range is opened."""
        m = RunMetrics()
        timer = StageTimer(m)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with timer.stage("name"):
                with timer.span("name/services"):
                    pass
        names = {e.name for e in prof.events()}
        assert {"name", "name/services"} <= names

        def no_range(name):
            raise AssertionError(f"range {name} opened with no trace")

        monkeypatch.setattr(torch.profiler, "record_function", no_range)
        with timer.stage("report"):
            with timer.span("report/pages"):
                pass
        assert set(m.stages) == {"name", "report"}

    def test_trace_nests_the_spans_in_their_stages(self, images, tmp_path):
        _, _, imgs = images
        prof = tmp_path / "trace"
        res = _stream(_pipeline(exact_limit=4, bucket_size=8), imgs,
                      tmp_path / "w", profile_dir=str(prof))
        with open(prof / "trace.json", encoding="utf-8") as fh:
            events = json.load(fh)["traceEvents"]
        ranges = {}
        for ev in events:
            if ev.get("ph") == "X" and ev.get("cat") == "user_annotation":
                ranges.setdefault(ev["name"], []).append(
                    (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
        assert _STAGES <= set(ranges)
        spans = {"embed/drain"} | _ENGINE | _NAMING
        assert spans <= set(ranges)
        assert set(res.metrics.spans) <= set(ranges)
        for name in spans:
            (s0, s1), = ranges[name.split("/")[0]]
            for a, b in ranges[name]:
                assert s0 <= a and b <= s1, name


class TestEnginePhases:
    @pytest.mark.parametrize("feature_dtype", ["float32", "int8"])
    def test_phases_without_the_profile_switch(self, monkeypatch,
                                               feature_dtype):
        x = np.random.default_rng(4).normal(size=(300, 8)).astype(
            np.float32)

        def run():
            return tsh.constrained_ward_bucketed(
                x, bucket_size=64, feature_dtype=feature_dtype, device="cpu")

        monkeypatch.delenv("IMAGECLUST_CLUSTER_PROFILE", raising=False)
        plain = run()
        monkeypatch.setenv("IMAGECLUST_CLUSTER_PROFILE", "1")
        synced = run()
        want = {p.split("/")[1] for p in _ENGINE}
        if feature_dtype == "int8":
            want.add("quantize")
        assert want <= set(plain.phases_s)
        assert set(plain.phases_s) == set(synced.phases_s)
        assert all(v >= 0 for v in plain.phases_s.values())
        assert plain.cluster_map == synced.cluster_map


class _Down:
    """A namer whose backend is down: every call raises."""
    name, order = "down", 1

    def generate(self, aggregated_text, retries):
        raise ConnectionError("backend down")


def _lines(path) -> int:
    with open(path, encoding="utf-8") as fh:
        return sum(1 for _ in fh)


class TestNamingCounters:
    def test_fake_namer_counts_exactly(self, tmp_path):
        texts = {f"Cluster-{i}": f"label {i}" for i in range(7)}
        svc = NamingService([FakeNamer()], retries=1, cluster_concurrency=3)
        state = str(tmp_path / "naming_state.jsonl")
        first = {}
        svc.name_clusters(texts, state_path=state, counters=first)
        assert set(first) == set(NAMING_COUNTERS)
        assert first["naming_calls"] == 7
        assert _lines(state) == 7
        assert first["naming_resumed"] == 0
        assert first["naming_fallbacks"] == 0
        assert first["naming_call_s"] >= 0 and first[
            "naming_state_write_s"] > 0
        assert first["naming_inline"] == 7  # the offline namer, inline
        again = {}
        svc.name_clusters(texts, state_path=state, counters=again)
        assert again["naming_resumed"] == 7
        assert again["naming_calls"] == 0 and _lines(state) == 7
        assert again["naming_call_s"] == again["naming_state_write_s"] == 0
        assert again["naming_inline"] == 0

    def test_fallbacks_are_counted_and_not_saved(self, tmp_path):
        texts = {f"Cluster-{i}": "x" for i in range(4)}
        svc = NamingService([FakeNamer(), _Down()], retries=1)
        state = str(tmp_path / "naming_state.jsonl")
        got = {}
        outs = svc.name_clusters(texts, state_path=state, counters=got)
        assert got["naming_calls"] == 8
        assert got["naming_fallbacks"] == 4
        assert got["naming_inline"] == 0  # _Down is remote: pooled
        assert all((o.title, o.catchy_phrase) == (FALLBACK_TITLE,
                                                  FALLBACK_PHRASE)
                   for v in outs.values() for o in v if o.service_name
                   == "down")
        assert _lines(state) == 4  # the fake's titles saved
        down_only = {}
        down_state = str(tmp_path / "down.jsonl")
        NamingService([_Down()], retries=1).name_clusters(
            texts, state_path=down_state, counters=down_only)
        assert down_only["naming_fallbacks"] == 4
        assert _lines(down_state) == 0
        assert down_only["naming_state_write_s"] == 0

    def test_pipeline_counts_and_resumes(self, images, tmp_path):
        _, _, imgs = images
        pipe = _pipeline(exact_limit=4, bucket_size=8)
        first = _stream(pipe, imgs, tmp_path).metrics.counters
        n = first["clusters"]
        assert first["naming_calls"] == n
        assert _lines(tmp_path / "naming_state.jsonl") == n
        assert first["naming_resumed"] == 0
        assert first["naming_inline"] == n
        again = _stream(pipe, imgs, tmp_path).metrics.counters
        assert again["naming_resumed"] == n and again["naming_calls"] == 0
        assert again["naming_inline"] == 0

    def test_service_metrics_add_the_naming_totals(self):
        svc = ServiceMetrics()
        for calls in (3, 4):
            svc.observe_run(RunMetrics(
                stages={"name": 0.5},
                counters={"naming_calls": calls, "naming_fallbacks": 1,
                          "naming_resumed": 2, "naming_inline": calls - 1}))
        text = svc.render()
        for total, want in (("imageclust_naming_calls_total", "7"),
                            ("imageclust_naming_fallbacks_total", "2"),
                            ("imageclust_naming_resumed_total", "4"),
                            ("imageclust_naming_inline_total", "5")):
            assert f"# TYPE {total} counter" in text
            assert f"{total} {want}\n" in text
