"""The port's mesh engines over gloo ranks against the JAX package's mesh
engines and the port's single-device engines, on the same numpy inputs.

Each world (two ranks; four for a subset) is one launch of every case
(tests/test_torch_mesh_targets.py); the JAX engines run in this process on the
(data=4, model=2) mesh of eight virtual CPU devices (``mesh8``). Every
rank must return the same result. Tolerances, all exact:

* the exact engine: merge logs bit-identical to the JAX mesh engine's on
  integer grids at d <= 8 (every f32 intermediate exact; tests/
  test_torch_ward.py explains d <= 8 for the centroid rule), partitions
  equal on tie-free blobs (after tests/test_sharded.py:226);
* the bucketed engine, both rules, absorb on and off: on integer-grid
  blobs with the JAX package's k-means rows injected, results identical
  to the JAX mesh engine's (tests/test_torch_sharded.py's whole-run
  parity); on Gaussian data identical to the port's single-device engine,
  with the features given whole or row-sharded (k-means then runs in
  row-block form: its all-reduced sums round in another order than one
  device's, and on this data no assignment moves);
* the chain, ``rnn`` and ``seq``: merge logs identical to the port's
  single-device chain (Gaussian and integer-grid data, features whole or
  row-sharded), partitions equal to the JAX mesh chain's on tie-free
  Gaussian data (after tests/test_chain.py:180 and :199);
* the byte counters: an exact merge moves O(n) bytes, never O(n^2); a
  rank's exchange carries about its buckets' rows, never the n x d matrix.
"""

import os

import jax
import numpy as np
import pytest
import torch

import imageclust_tpu.cluster.chain as jchain
import imageclust_tpu.cluster.sharded as jsh
import imageclust_tpu.cluster.ward as jw
from imageclust_tpu_torch.cluster import sharded as tsh
from imageclust_tpu_torch.cluster.chain import constrained_ward_chain
from imageclust_tpu_torch.cluster.ward import constrained_ward

import test_torch_mesh_targets as targets

torch.set_num_threads(2)


def _grid(seed, n, d, lo=-3, hi=4):
    return np.random.default_rng(seed).integers(lo, hi, (n, d)).astype(
        np.float32)


def _gauss(seed, n, d=8):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _grid_blobs(seed, n_blobs, per, d, spread=8, scale=50):
    rng = np.random.default_rng(seed)
    centers = rng.integers(-scale, scale + 1, (n_blobs, d)) * spread
    x = np.repeat(centers, per, axis=0) + rng.integers(-1, 2,
                                                       (n_blobs * per, d))
    return x.astype(np.float32)


def _tie_free_blobs(seed):
    from conftest import make_blobs

    return make_blobs(np.random.default_rng(seed), n_blobs=8, per_blob=5,
                      d=8)


def _jax_init(n, seed=0):
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))


EXACT = {  # name: (x, rule, min, max)
    "exact_grid_cent": (_grid(0, 130, 8), "centroid", 3, 6),
    "exact_grid_lw": (_grid(1, 200, 8), "lance_williams", 3, 6),
    "exact_grid_lw_24": (_grid(2, 90, 4), "lance_williams", 2, 4),
    "exact_blobs": (_tie_free_blobs(3), "centroid", 3, 6),
}
BUCKETED = {  # name: (x, rule, absorb, sharded, jax parity)
    "bk_grid_lw": (_grid_blobs(4, 140, 5, 8), "lance_williams", True,
                   False, True),
    "bk_grid_cent": (_grid_blobs(5, 140, 5, 8), "centroid", True, False,
                     True),
    "bk_grid_lw_off": (_grid(6, 400, 6), "lance_williams", False, False,
                       True),
    "bk_gauss_lw": (_gauss(7, 700, 16), "lance_williams", True, False,
                    False),
    "bk_gauss_cent_sh": (_gauss(8, 700, 16), "centroid", True, True,
                         False),
    "bk_gauss_lw_off_sh": (_gauss(9, 700, 16), "lance_williams", False,
                           True, False),
    "bk_grid_lw_sh": (_grid_blobs(10, 140, 5, 8), "lance_williams", True,
                      True, True),
}
CHAIN = {  # name: (x, impl, sharded, min, max)
    "ch_rnn_gauss": (_gauss(11, 150), "rnn", False, 3, 6),
    "ch_rnn_grid_sh": (_grid(12, 200, 6), "rnn", True, 3, 6),
    "ch_rnn_gauss_sh": (_gauss(13, 257), "rnn", True, 2, 9),
    "ch_seq_gauss": (_gauss(14, 100), "seq", False, 3, 6),
    "ch_seq_grid_sh": (_grid(15, 120, 4), "seq", True, 3, 6),
    "ch_seq_gauss_sh": (_gauss(16, 257), "seq", True, 2, 9),
}
FOUR_RANKS = ("exact_grid_lw", "exact_blobs", "bk_grid_cent",
              "bk_gauss_cent_sh", "ch_rnn_gauss_sh", "ch_seq_grid_sh")


def _cases(names=None):
    out = []
    for name, (x, rule, mn, mx) in EXACT.items():
        out.append((name, "case_exact", None, dict(
            x=x, min_size=mn, max_size=mx, update_rule=rule)))
    for name, (x, rule, absorb, sh, jp) in BUCKETED.items():
        kw = dict(x=x, sharded=sh, min_size=3, max_size=6,
                  bucket_size=128, update_rule=rule,
                  reassign_dropped=absorb)
        if jp:
            kw["kmeans_idx"] = _jax_init(len(x))
        out.append((name, "case_bucketed", None, kw))
    for name, (x, impl, sh, mn, mx) in CHAIN.items():
        out.append((name, "case_chain", None, dict(
            x=x, impl=impl, sharded=sh, min_size=mn, max_size=mx)))
    return [c for c in out if names is None or c[0] in names]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{ranks: [rank results]} for worlds of 2 and 4 data ranks."""
    out = {}
    for ranks, names in ((2, None), (4, FOUR_RANKS)):
        cases = [(n, f, (ranks, 1), kw) for n, f, _, kw in _cases(names)]
        out[ranks] = targets.run(cases, ranks,
                                 tmp_path_factory.mktemp(f"e{ranks}"))
    return out


def _results(worlds, name):
    """(ranks, rank 0's result, every rank's) of each world that ran it."""
    for ranks, world in worlds.items():
        if name in world[0]:
            yield ranks, world[0][name], [w[name] for w in world]


def _same_on_every_rank(per_rank):
    first = per_rank[0]["out"]
    for w in per_rank[1:]:
        o = w["out"]
        assert o["cluster_map"] == first["cluster_map"]
        assert o["dropped"] == first["dropped"]
        np.testing.assert_array_equal(o["merges"], first["merges"])


def _partition(cluster_map):
    return {frozenset(m) for m in cluster_map.values()}


def _chain_env(impl):
    os.environ["IMAGECLUST_CHAIN_IMPL"] = impl


class TestExact:
    @pytest.mark.parametrize("name", list(EXACT))
    def test_against_jax_mesh_and_single_device(self, worlds, mesh8, name):
        x, rule, mn, mx = EXACT[name]
        ids = [f"img_{k}" for k in range(len(x))]
        want = jw.constrained_ward(x, ids, min_size=mn, max_size=mx,
                                   update_rule=rule, mesh=mesh8)
        one = constrained_ward(x, min_size=mn, max_size=mx,
                               update_rule=rule, device="cpu")
        for ranks, r0, per_rank in _results(worlds, name):
            _same_on_every_rank(per_rank)
            got = r0["out"]
            if name.startswith("exact_grid"):  # bit-identical logs
                np.testing.assert_array_equal(got["merges"], want.merges)
                np.testing.assert_array_equal(got["merges"], one.merges)
                assert got["cluster_map"] == want.cluster_map
            else:  # tie-free blobs: the same partition
                assert _partition(got["cluster_map"]) == _partition(
                    want.cluster_map) == _partition(one.cluster_map)
            assert got["dropped"] == want.dropped

    @pytest.mark.parametrize("name", ["exact_grid_lw", "exact_grid_cent"])
    def test_bytes_per_merge_are_linear(self, worlds, name):
        """Per merge: one pmin_pair of two scalars (16 bytes), one all_gather
        of this rank's n_pad / D new distances, and under Lance-Williams one
        scalar psum for D[sa, sb]; never the n x n matrix."""
        x = EXACT[name][0]
        n_pad = -(-len(x) // 128) * 128
        for ranks, r0, per_rank in _results(worlds, name):
            merges = len(r0["out"]["merges"])
            for w in per_rank:
                c = w["counters"]
                assert c["calls"]["pmin_pair"] == merges
                assert c["calls"]["all_gather"] == merges
                pad = -(-n_pad // (128 * ranks)) * 128 * ranks
                assert c["bytes"]["all_gather"] == merges * pad // ranks * 4
                assert c["bytes"]["pmin_pair"] == merges * 16
                assert c["calls"].get("psum", 0) == (
                    merges if "lw" in name else 0)
                total = sum(c["bytes"].values())
                assert total / merges < 8 * pad  # O(n): never n^2 * 4


class TestBucketed:
    @pytest.mark.parametrize("name", list(BUCKETED))
    def test_against_jax_mesh_and_single_device(self, worlds, mesh8, name,
                                                monkeypatch):
        x, rule, absorb, sharded, jax_parity = BUCKETED[name]
        kw = dict(min_size=3, max_size=6, bucket_size=128, update_rule=rule,
                  reassign_dropped=absorb)
        if jax_parity:  # the JAX rows, so the buckets are the JAX engine's
            idx = _jax_init(len(x))
            monkeypatch.setattr(tsh, "_kmeans_init_idx",
                                lambda n, k, seed: torch.from_numpy(
                                    idx[:k].copy()))
            want = jsh.constrained_ward_bucketed(x, mesh=mesh8, **kw)
        one = tsh.constrained_ward_bucketed(x, device="cpu", **kw)
        for ranks, r0, per_rank in _results(worlds, name):
            _same_on_every_rank(per_rank)
            got = r0["out"]
            assert got["cluster_map"] == one.cluster_map
            assert got["dropped"] == one.dropped
            np.testing.assert_array_equal(got["merges"], one.merges)
            if jax_parity:
                assert got["cluster_map"] == want.cluster_map
                assert got["dropped"] == want.dropped
                np.testing.assert_array_equal(got["merges"], want.merges)
            if absorb:
                assert not got["dropped"]
            for m in got["cluster_map"].values():
                assert 3 <= len(m) <= 6

    @pytest.mark.parametrize("name", ["bk_grid_lw", "bk_gauss_cent_sh",
                                      "bk_grid_cent"])
    def test_exchange_moves_each_ranks_buckets_once(self, worlds, name):
        """A rank sends its rows once and receives about its buckets' rows:
        the all_to_all carries D packets of K rows (K the largest packet),
        under twice a row block's share, never the n x d matrix; no
        all_gather moves feature rows."""
        x = BUCKETED[name][0]
        n, d = x.shape
        for ranks, r0, per_rank in _results(worlds, name):
            sent = 0
            for w in per_rank:
                ex = w["out"]["exchange"]
                rp = -(-n // ranks)
                assert ex["sent_real_rows"] <= rp
                sent += ex["sent_real_rows"]
                assert ex["send_rows"] <= 2 * rp
                assert ex["bytes"] == ex["send_rows"] * d * 4
                assert ex["bytes"] < n * d * 4
                assert w["counters"]["bytes"]["all_to_all"] == ex["bytes"]
                # gathered: per-item summaries and per-bucket logs only
                assert w["counters"]["bytes"]["all_gather"] < n * d * 4
            assert sent == n  # every row moved exactly once
            recv = [w["out"]["exchange"]["recv_real_rows"]
                    for w in per_rank]
            assert sum(recv) == n


class TestChain:
    @pytest.mark.parametrize("name", list(CHAIN))
    def test_logs_identical_to_single_device(self, worlds, name,
                                             monkeypatch):
        x, impl, _, mn, mx = CHAIN[name]
        monkeypatch.setenv("IMAGECLUST_CHAIN_IMPL", impl)
        one = constrained_ward_chain(x, min_size=mn, max_size=mx,
                                     device="cpu")
        for ranks, r0, per_rank in _results(worlds, name):
            _same_on_every_rank(per_rank)
            got = r0["out"]
            np.testing.assert_array_equal(got["merges"], one.merges)
            assert got["cluster_map"] == one.cluster_map
            assert got["dropped"] == one.dropped
            assert got["loop_stats"] == one.loop_stats

    @pytest.mark.parametrize("name", [n for n in CHAIN if "gauss" in n])
    def test_partition_equals_jax_mesh_chain(self, worlds, mesh8, name,
                                             monkeypatch):
        x, impl, _, mn, mx = CHAIN[name]
        monkeypatch.setenv("IMAGECLUST_CHAIN_IMPL", impl)
        want = jchain.constrained_ward_chain(x, min_size=mn, max_size=mx,
                                             mesh=mesh8)
        for ranks, r0, _ in _results(worlds, name):
            got = r0["out"]
            assert _partition(got["cluster_map"]) == _partition(
                want.cluster_map)
            assert sorted(got["dropped"]) == sorted(want.dropped)

    @pytest.mark.parametrize("name", ["ch_seq_gauss", "ch_rnn_gauss"])
    def test_traffic_per_step(self, worlds, name):
        """seq: one (2, d) psum (the head's and its predecessor's rows) and
        one two-entry pmin_pair a step, for the steps that ran and the
        gated ones up to the next host read of "go" (every 64 steps): O(d)
        bytes a step; the spill adds a few psums. rnn: one (rows,) pmin_pair per recompute round and,
        per merge round that merged, two all_gathers of this rank's
        ceil(n / D) cache entries (int64 partner, f32 distance)."""
        x = CHAIN[name][0]
        n, d = x.shape
        for ranks, r0, per_rank in _results(worlds, name):
            stats = r0["out"]["loop_stats"]
            for w in per_rank:
                c = w["counters"]
                if name.startswith("ch_seq"):
                    steps = c["calls"]["pmin_pair"]
                    assert stats["iterations"] <= steps
                    assert steps <= stats["iterations"] + 64
                    # plus the spill's few psums (dropped rows, centroids)
                    assert steps <= c["calls"]["psum"] <= steps + 8
                    assert c["bytes"]["pmin_pair"] == steps * 2 * 16
                    assert set(c["calls"]) == {"psum", "pmin_pair"}
                else:
                    assert c["calls"]["pmin_pair"] == stats[
                        "recompute_rounds"]
                    gathers = c["calls"]["all_gather"]
                    assert gathers % 2 == 0
                    assert 0 < gathers <= 2 * stats["merge_rounds"]
                    assert c["bytes"]["all_gather"] == (
                        gathers // 2 * -(-n // ranks) * 12)
