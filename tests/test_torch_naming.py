"""The port's ``NamingService.name_clusters`` schedules against the JAX
package's.

Offline namers (``remote = False``) name the clusters one after another in
the calling thread; a namer that may wait on a remote service keeps the
bounded pool of clusters in flight, with one namer pool per call when
several namers are enabled. Both schedules give the reference's outputs,
state-file records, counters and progress calls. No test here asserts wall
time.
"""

import json
import sys
import threading
import time

import pytest

from imageclust_tpu.naming.fake import FakeNamer as JaxFakeNamer
from imageclust_tpu.naming.registry import NamingService as JaxNamingService
from imageclust_tpu_torch.naming import registry
from imageclust_tpu_torch.naming.base import FALLBACK_PHRASE, FALLBACK_TITLE
from imageclust_tpu_torch.naming.fake import FakeNamer
from imageclust_tpu_torch.naming.registry import NamingService, _text_sha


class _RemoteFake(FakeNamer):
    """The offline namer's outputs on the pooled schedule."""
    remote = True


class _Sleeping:
    """A namer without ``remote``: sleeps, counts calls and the peak of
    calls in flight."""
    name, order = "Sleeping", 1

    def __init__(self, delay=0.002):
        self.delay = delay
        self.texts = []
        self.inflight = 0
        self.peak = 0
        self._lock = threading.Lock()

    def generate(self, text, retries):
        with self._lock:
            self.texts.append(text)
            self.inflight += 1
            self.peak = max(self.peak, self.inflight)
        time.sleep(self.delay)
        with self._lock:
            self.inflight -= 1
        return f"T:{text}", f"P:{text}"


class _Boom:
    """A backend that always raises; ``remote`` set per test."""
    name, order = "Boom", 1

    def __init__(self, remote=None):
        if remote is not None:
            self.remote = remote

    def generate(self, text, retries):
        raise RuntimeError("backend exploded")


class _OfflineDown(FakeNamer):
    """The offline namer, raising on the text ``down``."""

    def generate(self, text, retries):
        if text == "down":
            raise ConnectionError("down")
        return super().generate(text, retries)


def _texts(n=40):
    """Labels with repeats and empty texts, as the pipeline hands them."""
    words = ["cats, whiskers", "", "dogs & bones", "cats, whiskers",
             "boats 'sails' #sea", "", "a\tb\nc", "x" * 1200]
    return {f"Cluster-{i}": words[i % len(words)] for i in range(n)}


def _plain(outputs):
    return {cid: [(o.service_name, o.title, o.catchy_phrase, o.order)
                  for o in outs] for cid, outs in outputs.items()}


def _name(svc, texts, state, **kw):
    counters, seen = {}, []
    outs = svc.name_clusters(texts, state_path=str(state), counters=counters,
                             progress=lambda d, t: seen.append((d, t)), **kw)
    return outs, counters, seen


@pytest.mark.parametrize("concurrency", [1, 4, 16])
def test_inline_and_pooled_agree_with_the_reference(tmp_path, concurrency):
    texts = _texts()
    inline, c_in, seen_in = _name(
        NamingService([FakeNamer()], cluster_concurrency=concurrency),
        texts, tmp_path / "inline.jsonl")
    pooled, c_pool, seen_pool = _name(
        NamingService([_RemoteFake()], cluster_concurrency=concurrency),
        texts, tmp_path / "pooled.jsonl")
    ref = JaxNamingService([JaxFakeNamer()], cluster_concurrency=1)
    ref_out = ref.name_clusters(texts, state_path=str(tmp_path / "ref.jsonl"))

    assert list(inline) == list(pooled) == list(texts)
    assert _plain(inline) == _plain(pooled) == _plain(ref_out)
    # one record a cluster, in the texts' order inline and byte for byte
    # the reference's (one cluster in flight there, so in the same order)
    inline_bytes = (tmp_path / "inline.jsonl").read_bytes()
    assert inline_bytes == (tmp_path / "ref.jsonl").read_bytes()
    assert [json.loads(ln)["cluster"] for ln in
            inline_bytes.decode().splitlines()] == list(texts)
    assert sorted((tmp_path / "pooled.jsonl").read_bytes().splitlines()) \
        == sorted(inline_bytes.splitlines())
    n = len(texts)
    assert seen_in == [(d, n) for d in range(1, n + 1)]
    assert sorted(seen_pool) == seen_in
    assert c_in["naming_inline"] == n and c_pool["naming_inline"] == 0
    for key in ("naming_calls", "naming_fallbacks", "naming_resumed"):
        assert c_in[key] == c_pool[key]
    assert c_in["naming_calls"] == n and c_in["naming_fallbacks"] == 0


def test_namer_without_remote_keeps_the_cluster_pool(tmp_path):
    namer = _Sleeping(delay=0.002)
    svc = NamingService([namer], cluster_concurrency=64)
    texts = {f"Cluster-{i}": f"labels {i}" for i in range(2000)}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)  # more thread switches inside the lock
    try:
        outs, counters, seen = _name(svc, texts, tmp_path / "state.jsonl")
    finally:
        sys.setswitchinterval(switch)
    assert sorted(namer.texts) == sorted(texts.values())  # each once
    assert namer.peak > 8  # concurrent across clusters
    assert counters["naming_inline"] == 0
    assert counters["naming_calls"] == 2000  # no count lost
    assert sorted(seen) == [(d, 2000) for d in range(1, 2001)]
    records = (tmp_path / "state.jsonl").read_text().splitlines()
    assert sorted(json.loads(ln)["cluster"] for ln in records) \
        == sorted(texts)
    assert outs["Cluster-17"][0].title == "T:labels 17"


@pytest.mark.parametrize("namers,pools", [
    ([FakeNamer()], 0),
    ([FakeNamer(), _OfflineDown()], 0),
    ([_RemoteFake()], 1),
    ([_Sleeping(delay=0.0)], 1),
    ([_RemoteFake(), _Sleeping(delay=0.0)], 2),  # clusters, and namers
])
def test_thread_pools_per_call(monkeypatch, namers, pools):
    built = []

    class Counting(registry.ThreadPoolExecutor):
        def __init__(self, *args, **kwargs):
            built.append(kwargs.get("max_workers"))
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(registry, "ThreadPoolExecutor", Counting)
    svc = NamingService(namers, cluster_concurrency=4)
    texts = {f"Cluster-{i}": f"labels {i}" for i in range(300)}
    outs = svc.name_clusters(texts)
    assert len(built) == pools
    if pools == 2:
        assert sorted(built) == [4, 8]
    assert all(len(v) == len(namers) for v in outs.values())
    built.clear()
    svc.generate_multi("labels")  # the per-cluster contract on its own
    remote = any(getattr(n, "remote", True) for n in namers)
    assert len(built) == (len(namers) > 1 and remote)


def test_inline_resumes_from_a_torn_state_file(tmp_path):
    state = tmp_path / "naming_state.jsonl"
    torn = (json.dumps({"cluster": "Cluster-0",
                        "text_sha": _text_sha("labels 0"),
                        "outputs": [["Offline Namer", "T0", "P0", 0]]})
            + "\n"
            + json.dumps({"cluster": "Cluster-ghost",
                          "text_sha": _text_sha("ghost"),
                          "outputs": [["Offline Namer", "G", "G", 0]]})
            + "\n" + '{"cluster": "Cluster-1", "outp')  # a crash mid-line
    state.write_text(torn)
    ref_state = tmp_path / "ref.jsonl"
    ref_state.write_text(torn)
    texts = {f"Cluster-{i}": f"labels {i}" for i in range(6)}
    texts["Cluster-3"] = "down"  # every backend fails: not saved

    outs, counters, seen = _name(NamingService([_OfflineDown()]), texts,
                                 state)
    assert outs["Cluster-0"][0].title == "T0"
    assert (outs["Cluster-3"][0].title, outs["Cluster-3"][0].catchy_phrase) \
        == (FALLBACK_TITLE, FALLBACK_PHRASE)
    assert counters["naming_resumed"] == 1
    assert counters["naming_inline"] == 5
    assert counters["naming_calls"] == 5 and counters["naming_fallbacks"] == 1
    assert seen == [(d, 6) for d in range(2, 7)]

    class RefDown(JaxFakeNamer):
        def generate(self, text, retries):
            if text == "down":
                raise ConnectionError("down")
            return super().generate(text, retries)

    ref = JaxNamingService([RefDown()], cluster_concurrency=1)
    ref_out = ref.name_clusters(texts, state_path=str(ref_state))
    assert _plain(outs) == _plain(ref_out)
    # the torn line sealed, then one record a saved cluster, as the
    # reference writes them
    assert state.read_bytes() == ref_state.read_bytes()
    lines = state.read_text().splitlines()
    assert lines[2] == '{"cluster": "Cluster-1", "outp'
    assert [json.loads(ln)["cluster"] for ln in lines[3:]] == [
        "Cluster-1", "Cluster-2", "Cluster-4", "Cluster-5"]

    again, counters, _ = _name(NamingService([_OfflineDown()]), texts, state)
    assert _plain(again) == _plain(outs)
    assert counters["naming_resumed"] == 5  # all but the fallback cluster
    assert counters["naming_inline"] == 1 and counters["naming_calls"] == 1


@pytest.mark.parametrize("remote", [False, None], ids=["inline", "pooled"])
def test_raising_namer_degrades_in_order(tmp_path, remote):
    texts = _texts(24)
    boom = _Boom(remote)
    outs, counters, _ = _name(
        NamingService([boom, FakeNamer()], cluster_concurrency=4), texts,
        tmp_path / "state.jsonl")
    ref_out = JaxNamingService([boom, JaxFakeNamer()]).name_clusters(texts)
    assert _plain(outs) == _plain(ref_out)
    for v in outs.values():
        assert [o.service_name for o in v] == ["Offline Namer", "Boom"]
        assert (v[1].title, v[1].catchy_phrase) == (FALLBACK_TITLE,
                                                    FALLBACK_PHRASE)
        assert v[0].title != FALLBACK_TITLE
    assert counters["naming_fallbacks"] == len(texts)
    assert counters["naming_calls"] == 2 * len(texts)
    assert counters["naming_inline"] == (len(texts) if remote is False else 0)
    # the offline namer's titles make every record worth saving
    assert len((tmp_path / "state.jsonl").read_text().splitlines()) \
        == len(texts)
