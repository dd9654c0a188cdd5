"""The port's bucketed engine (``constrained_ward_bucketed``) against the JAX
package's, stage by stage, on the same numpy inputs.

The port seeds k-means from a ``torch.Generator``; to compare, these tests
inject the JAX package's ``jax.random`` indices into the port's
``_kmeans_init``. Tolerances: k-means centroids within rtol 1e-5 (the
one-hot sums add in another order); everything downstream of the
assignments is integer or exact bookkeeping and must be identical; on
integer-grid data every f32 intermediate of the merge loops and spills is
exact, so whole runs must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageclust_tpu.cluster.sharded as jsh
from imageclust_tpu_torch.cluster import sharded as tsh
from imageclust_tpu_torch.data import native as tnative

torch.set_num_threads(1)


def _jax_init_indices(n, k, seed=0):
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n)[:k])


@pytest.fixture()
def jax_init(monkeypatch):
    """Make the port's k-means start from the JAX package's rows."""

    def init(x, k, seed):
        idx = torch.from_numpy(_jax_init_indices(x.shape[0], k, seed).copy())
        return x[idx.to(x.device)].to(torch.float32)

    monkeypatch.setattr(tsh, "_kmeans_init", init)


def _blobs(rng, n_blobs, per, d, spread=8, scale=50):
    centers = rng.integers(-scale, scale + 1, (n_blobs, d)) * spread
    x = np.repeat(centers, per, axis=0) + rng.integers(-1, 2,
                                                       (n_blobs * per, d))
    return x.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestKmeans:
    def test_matches_jax_with_injected_init(self, rng, jax_init):
        x = _blobs(rng, 40, 6, 5)
        k = 12
        jc, ja, jo, jp = jsh.kmeans(jnp.asarray(x), k, iters=6)
        tc, ta, to, tp = tsh.kmeans(_t(x), k, iters=6)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                                   atol=1e-5)
        # own distances come from |x|^2 + |c|^2 - 2 x.c: the centroids'
        # 1e-5 relative difference shows up against the norms' scale
        scale = float((x.astype(np.float64) ** 2).sum(1).max())
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                                   atol=1e-6 * scale)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))

    def test_block_scan_matches_one_block(self, rng, jax_init):
        x = _blobs(rng, 30, 5, 4)
        one = tsh.kmeans(_t(x), 10, iters=4)
        many = tsh.kmeans(_t(x), 10, iters=4, block=16)
        np.testing.assert_array_equal(one[1].numpy(), many[1].numpy())
        np.testing.assert_allclose(one[0].numpy(), many[0].numpy(),
                                   rtol=1e-5)

    def test_preference_ties_break_by_bucket_index(self):
        """Duplicate centroids tie exactly: ``lax.top_k`` puts the lower
        index first, and so must the port."""
        x = np.array([[0, 0], [1, 0], [5, 5], [0, 1]], np.float32)
        cents = np.array([[1, 1], [0, 0], [1, 1], [0, 0], [9, 9]],
                         np.float32)
        _, _, jp = jsh._kmeans_summarize(jnp.asarray(x), jnp.asarray(cents),
                                         kk=5, block=4)
        _, _, tp = tsh._kmeans_summarize(_t(x), _t(cents), 5, 4)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))

    def test_subsample_draws_distinct_rows(self):
        x = torch.arange(100, dtype=torch.float32)[:, None]
        sub = tsh._kmeans_subsample(x, 30, 0)
        assert sub.shape == (30, 1) and len(set(sub[:, 0].tolist())) == 30


def _repair_fixture(rng, n, nb, cap, mn, ties=0.3):
    w = rng.lognormal(0, 1.5, nb)
    assign = rng.choice(nb, size=n, p=w / w.sum()).astype(np.int32)
    own_d = rng.random(n).astype(np.float32)
    own_d[rng.random(n) < ties] = 0.5  # exercise the stable tie-break
    top_pref = rng.integers(0, nb, (n, 6)).astype(np.int32)
    return assign, own_d, top_pref, nb, cap, mn


def _fixtures(seed, count=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(300, 3000))
        nb = int(rng.integers(8, 50))
        cap = int(rng.integers(4, 24))
        mn = int(rng.integers(1, max(2, cap // 3)))
        out.append(_repair_fixture(rng, n, nb, cap, mn))
    return out


def _lists(blocks):
    return [[int(i) for i in b] for b in blocks]


class TestRepair:
    """Forced over-capacity buckets (heavy skew: spills and the cursor
    fallback) and under-min buckets (dissolves) in every fixture."""

    def test_summaries_match_jax(self):
        for assign, own_d, _, nb, cap, mn in _fixtures(3):
            want = jsh._repair_summaries(jnp.asarray(assign),
                                         jnp.asarray(own_d), nb,
                                         np.int32(cap), np.int32(mn))
            got = tsh._repair_summaries(_t(assign), _t(own_d), nb, cap, mn)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    @pytest.mark.parametrize("path", ["native", "list"])
    def test_device_repair_matches_jax(self, monkeypatch, path):
        if path == "list":
            monkeypatch.setattr(tnative, "available", lambda: False)
            monkeypatch.setattr(tnative, "native_spill_place",
                                lambda *a, **k: None)
        else:
            assert tnative.available(), "tests/conftest.py builds it"
        for fx in _fixtures(5):
            assign, own_d, top_pref, nb, cap, mn = fx
            want = jsh._repair_buckets_device(
                jnp.asarray(assign), jnp.asarray(own_d),
                jnp.asarray(top_pref), nb, cap, mn)
            got = tsh._repair_buckets_device(_t(assign), _t(own_d),
                                             _t(top_pref), nb, cap, mn)
            assert _lists(got) == _lists(want)
            assert _lists(got) == jsh._repair_buckets(*fx)

    def test_fast_path_matches_list_oracle(self):
        for assign, own_d, top_pref, nb, cap, mn in _fixtures(7):
            counts0 = np.bincount(assign, minlength=nb).astype(np.int64)
            perm = np.lexsort((own_d, assign))
            offs0 = np.concatenate([[0], np.cumsum(counts0[:-1])])
            rank = np.empty(len(assign), np.int64)
            rank[perm] = np.arange(len(assign)) - np.repeat(offs0, counts0)
            ref = jsh._repair_from_summaries(assign, rank, counts0.copy(),
                                             top_pref, nb, cap, mn)
            got = tsh._repair_from_summaries_fast(
                assign, rank, counts0.copy(), top_pref, nb, cap, mn)
            assert _lists(got) == ref
            assert tsh._repair_from_summaries(
                assign, rank, counts0.copy(), top_pref, nb, cap, mn) == ref

    def test_host_oracle_matches_jax(self, monkeypatch):
        fixtures = _fixtures(9, count=4)
        for fx in fixtures:
            assert tsh._repair_buckets(*fx) == jsh._repair_buckets(*fx)
        monkeypatch.setattr(tnative, "native_spill_place",
                            lambda *a, **k: None)
        for fx in fixtures:
            assert tsh._repair_buckets(*fx) == jsh._repair_buckets(*fx)


def _random_logs(rng):
    nb = int(rng.integers(1, 6))
    bucket_size = int(rng.integers(2, 12))
    n = nb * bucket_size + int(rng.integers(0, 5))
    counts = rng.integers(1, bucket_size + 1, nb).astype(np.int32)
    steps = np.array([rng.integers(0, c) for c in counts], np.int32)
    logs = np.zeros((nb, max(bucket_size - 1, 1), 3), np.int32)
    for b in range(nb):
        for r in range(steps[b]):
            hi = counts[b] + r
            logs[b, r, 0] = rng.integers(0, hi)
            logs[b, r, 1] = rng.integers(0, hi)
    bucket_idx = rng.integers(0, n, (nb, bucket_size)).astype(np.int32)
    return logs, steps, counts, bucket_idx, n


class TestHostTail:
    def test_restamp_matches_jax(self):
        rng = np.random.default_rng(11)
        for _ in range(10):
            args = _random_logs(rng)
            np.testing.assert_array_equal(tsh._restamp_logs(*args),
                                          jsh._restamp_logs(*args))

    def test_reconstruction_native_matches_jax_and_python_walk(self, rng):
        """Real merge states from the K2 twin: the native member expansion
        equals the JAX package's and the Python walk's order."""
        x = _blobs(rng, 50, 5, 4)
        feats = _t(x)
        buckets = [list(range(i, min(i + 90, len(x))))
                   for i in range(0, len(x), 90)]
        nb, B = len(buckets), 96
        bidx = np.zeros((nb, B), np.int32)
        counts = np.array([len(b) for b in buckets], np.int32)
        for i, b in enumerate(buckets):
            bidx[i, :len(b)] = b
        targets = np.array([tsh._bucket_target(int(c), 3, 6)
                            for c in counts], np.int32)
        logs, steps, births, _, active = tsh._all_buckets(
            feats, bidx, counts, targets, 6, 3)
        got = tsh._native_reconstruction(buckets, logs, steps, births,
                                         active)
        want = jsh._native_reconstruction(buckets, logs, steps, births,
                                          active)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        walk = []
        for bi, members in enumerate(buckets):
            children = {int(new): (int(hi), int(lo))
                        for hi, lo, new in logs[bi][:int(steps[bi])]}
            for birth in sorted(int(b) for b in births[bi][active[bi]]):
                walk += [members[k] for k in tsh._leaf_indices(
                    birth, len(members), children)]
        np.testing.assert_array_equal(got[0], walk)

    def test_all_buckets_order_and_chunking(self, rng, monkeypatch):
        """Count-sorted chunks come back in the caller's order: narrow
        chunks give the one-chunk result."""
        x = _blobs(rng, 40, 5, 4)
        bidx = np.arange(200, dtype=np.int32).reshape(5, 40)
        counts = np.array([40, 12, 33, 0, 27], np.int32)
        targets = np.array([tsh._bucket_target(int(c), 3, 6) if c else 0
                            for c in counts], np.int32)
        for rule in ("lance_williams", "centroid"):
            one = tsh._all_buckets(_t(x), bidx, counts, targets, 6, 3, rule)
            before = tsh.chunks_dispatched
            monkeypatch.setattr(tsh, "_chunk_width_whole", lambda *a: 2)
            monkeypatch.setattr(tsh, "_chunk_width", lambda *a: 2)
            many = tsh._all_buckets(_t(x), bidx, counts, targets, 6, 3, rule)
            monkeypatch.undo()
            assert tsh.chunks_dispatched == before + 3
            for a, b in zip(one, many):
                np.testing.assert_array_equal(a, b)

    def test_chunk_widths_match_jax(self):
        for B in (64, 128, 512, 4096):
            for d in (8, 1000, 2048):
                assert tsh._chunk_width(B, d) == jsh._chunk_width(B, d)
                assert (tsh._chunk_width_whole(B, d)
                        == jsh._chunk_width_whole(B, d))


class TestSpills:
    def _state(self, rng):
        """Integer-grid features, clusters with room, and a spread of
        dropped items; every f32 intermediate is exact."""
        n, d = 120, 6
        x = rng.integers(-4, 5, (n, d)).astype(np.float32)
        order = rng.permutation(n)
        members, sizes, bucket = [], [], []
        pos = 0
        while pos < 96:
            s = int(rng.integers(3, 6))
            members.append(order[pos:pos + s])
            sizes.append(s)
            bucket.append(len(sizes) % 4)
            pos += s
        dropped = [int(i) for i in order[pos:]]
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        return x, np.concatenate(members), offsets, np.array(bucket), dropped

    def _cols(self, pkg, members, offsets, bucket):
        return pkg._Clusters(members.copy(), offsets.copy(), bucket.copy())

    @pytest.mark.parametrize("local", [False, True])
    def test_spill_rounds_match_jax(self, rng, local):
        x, members, offsets, bucket, dropped = self._state(rng)
        bucket_of = ({i: int(rng.integers(0, 4)) for i in dropped}
                     if local else None)
        jc = self._cols(jsh, members, offsets, bucket)
        tc = self._cols(tsh, members, offsets, bucket)
        want = jsh._spill_rounds(jnp.asarray(x), jc, list(dropped), 6,
                                 item_bucket_of=bucket_of)
        got = tsh._spill_rounds(_t(x), tc, list(dropped), 6,
                                item_bucket_of=bucket_of)
        assert got == want
        for a, b in zip(tc.finalize(), jc.finalize()):
            np.testing.assert_array_equal(a, b)
        assert len(got) < len(dropped)

    def test_spill_centroids_match_jax(self, rng):
        x, members, offsets, bucket, _ = self._state(rng)
        cols = tsh._Clusters(members, offsets, bucket)
        assign = cols.assign_array(len(x))
        c_pad = 1 << max(cols.num - 1, 1).bit_length()
        sizes = np.full(c_pad, 6, np.int32)
        sizes[:cols.num] = cols.sizes()
        want = jsh._spill_centroids(jnp.asarray(x), jnp.asarray(assign),
                                    jnp.asarray(sizes), c_pad)
        got = tsh._spill_centroids(_t(x), _t(assign), _t(sizes), c_pad,
                                   int(cols.sizes().max()))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_candidates_match_jax(self, rng):
        x, members, offsets, bucket, dropped = self._state(rng)
        cents = rng.integers(-4, 5, (32, 6)).astype(np.float32)
        sizes = rng.integers(2, 7, 32).astype(np.int32)
        drop = np.asarray(dropped, np.int32)
        want = jsh._spill_candidates(jnp.asarray(x), jnp.asarray(cents),
                                     jnp.asarray(sizes), jnp.asarray(drop),
                                     8, jnp.int32(6))
        got = tsh._spill_candidates(_t(x), _t(cents), _t(sizes),
                                    _t(drop.astype(np.int64)), 8, 6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        table = rng.integers(-1, 32, (4, 7)).astype(np.int32)
        ib = rng.integers(0, 4, len(drop)).astype(np.int32)
        want = jsh._spill_candidates_local(
            jnp.asarray(x), jnp.asarray(cents), jnp.asarray(sizes),
            jnp.asarray(drop), jnp.asarray(ib), jnp.asarray(table), 5,
            jnp.int32(6))
        got = tsh._spill_candidates_local(
            _t(x), _t(cents), _t(sizes), _t(drop.astype(np.int64)),
            _t(ib.astype(np.int64)), _t(table.astype(np.int64)), 5, 6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _engine_pair(x, rule, reassign=True):
    want = jsh.constrained_ward_bucketed(
        x, min_size=3, max_size=6, bucket_size=128, update_rule=rule,
        reassign_dropped=reassign)
    got = tsh.constrained_ward_bucketed(
        x, min_size=3, max_size=6, bucket_size=128, update_rule=rule,
        reassign_dropped=reassign, device="cpu")
    return got, want


class TestEngine:
    @pytest.mark.parametrize("n", [300, 700])
    @pytest.mark.parametrize("rule", ["lance_williams", "centroid"])
    def test_identical_to_jax_on_grid_blobs(self, rng, jax_init, n, rule):
        x = _blobs(rng, n // 5, 5, 8)
        got, want = _engine_pair(x, rule)
        assert got.cluster_map == want.cluster_map
        assert got.dropped == want.dropped
        np.testing.assert_array_equal(got.merges, want.merges)
        assert got.n_clusters_target == want.n_clusters_target

    def test_absorb_off_drops_like_jax(self, rng, jax_init):
        x = rng.integers(-3, 4, (400, 6)).astype(np.float32)
        got, want = _engine_pair(x, "lance_williams", reassign=False)
        assert got.cluster_map == want.cluster_map
        assert got.dropped == want.dropped

    @pytest.mark.parametrize("rule", ["lance_williams", "centroid"])
    def test_normal_data_bounds_and_no_loss(self, rng, monkeypatch, rule):
        monkeypatch.setenv("IMAGECLUST_CLUSTER_PROFILE", "1")
        x = rng.normal(size=(700, 16)).astype(np.float32)
        res = tsh.constrained_ward_bucketed(
            x, min_size=3, max_size=6, bucket_size=128, update_rule=rule,
            device="cpu")
        placed = sum(len(m) for m in res.cluster_map.values())
        assert placed + len(res.dropped) == 700
        for members in res.cluster_map.values():
            assert 3 <= len(members) <= 6
        assert {"kmeans", "bucket-repair", "bucket-merges"} <= set(
            res.phases_s)
        assert res.n_buckets >= 700 // 128
        assert res.host_paths == {"placement": "native",
                                  "reconstruction": "native"}

    def test_python_host_paths_give_the_same_result(self, rng,
                                                    monkeypatch):
        x = rng.normal(size=(500, 8)).astype(np.float32)
        native = tsh.constrained_ward_bucketed(x, bucket_size=128,
                                               device="cpu")
        monkeypatch.setattr(tnative, "_load", lambda: None)
        plain = tsh.constrained_ward_bucketed(x, bucket_size=128,
                                              device="cpu")
        assert plain.host_paths == {"placement": "python",
                                    "reconstruction": "python"}
        assert plain.cluster_map == native.cluster_map
        np.testing.assert_array_equal(plain.merges, native.merges)

    def test_single_bucket_hands_off_to_exact_engine(self, rng):
        from imageclust_tpu_torch.cluster import constrained_ward

        x = rng.integers(-3, 4, (40, 4)).astype(np.float32)
        got = tsh.constrained_ward_bucketed(x, bucket_size=128,
                                            update_rule="centroid",
                                            device="cpu")
        want = constrained_ward(x, [f"img_{i}" for i in range(40)],
                                update_rule="centroid",
                                reassign_dropped=True, device="cpu")
        assert got.cluster_map == want.cluster_map

    def test_tensor_input_and_ids(self, rng):
        x = rng.normal(size=(300, 8)).astype(np.float32)
        ids = [f"p{i}" for i in range(300)]
        a = tsh.constrained_ward_bucketed(_t(x), ids, bucket_size=128,
                                          device="cpu")
        b = tsh.constrained_ward_bucketed(x, ids, bucket_size=128,
                                          device="cpu")
        assert a.cluster_map == b.cluster_map
        assert all(m.startswith("p") for c in a.cluster_map.values()
                   for m in c)

    def test_large_k_runs_the_tile_path_on_cpu(self, rng, monkeypatch):
        monkeypatch.setattr(tsh, "_PREF_FUSED_MIN_K", 2)
        x = rng.normal(size=(300, 4)).astype(np.float32)
        res = tsh.constrained_ward_bucketed(x, bucket_size=64, device="cpu")
        assert res.n_items == 300

    # mesh=: formerly a NotImplementedError; an object that is not a Mesh is
    # now a TypeError (the mesh engine: tests/test_torch_mesh_engines.py)
    @pytest.mark.parametrize("kw,exc", [
        (dict(feature_dtype="fp8"), ValueError),
        (dict(mesh=object()), TypeError),
        (dict(mesh=object(), feature_dtype="int8"), TypeError),
        (dict(update_rule="nope"), ValueError)])
    def test_unported_modes_raise(self, rng, kw, exc):
        x = rng.normal(size=(300, 4)).astype(np.float32)
        with pytest.raises(exc):
            tsh.constrained_ward_bucketed(x, bucket_size=128, device="cpu",
                                          **kw)

    @pytest.mark.parametrize("feature_dtype", ["bfloat16", "int8"])
    def test_residency_modes_match_jax(self, rng, jax_init, feature_dtype):
        """bf16/int8 residency, refused before it was ported, runs and
        gives the JAX package's partition on grid blobs."""
        x = _blobs(rng, 60, 5, 8)
        want = jsh.constrained_ward_bucketed(
            x, min_size=3, max_size=6, bucket_size=128,
            feature_dtype=feature_dtype)
        got = tsh.constrained_ward_bucketed(
            x, min_size=3, max_size=6, bucket_size=128,
            feature_dtype=feature_dtype, device="cpu")
        assert got.cluster_map == want.cluster_map
        assert got.dropped == want.dropped

    def test_need_only_mode_matches_jax(self, rng, monkeypatch, jax_init):
        """The need-only preference mode, refused before it was ported,
        gives the full-preference run's partition (and the JAX package's
        need-only one)."""
        x = _blobs(rng, 60, 5, 8)
        full = tsh.constrained_ward_bucketed(x, bucket_size=128, device="cpu")
        monkeypatch.setattr(tsh, "_PREF_NEED_ONLY_MIN_WORK", 10)
        monkeypatch.setattr(jsh, "_PREF_NEED_ONLY_MIN_WORK", 10)
        got = tsh.constrained_ward_bucketed(x, bucket_size=128, device="cpu")
        want = jsh.constrained_ward_bucketed(x, bucket_size=128)
        assert got.cluster_map == want.cluster_map == full.cluster_map

    def test_default_device_needs_cuda(self, rng, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        x = rng.normal(size=(300, 4)).astype(np.float32)
        with pytest.raises(RuntimeError, match="CUDA"):
            tsh.constrained_ward_bucketed(x, bucket_size=128)
