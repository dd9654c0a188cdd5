"""The port's exact constrained-Ward engine against the JAX package.

The JAX engine runs its fused Pallas loop in interpret mode
(IMAGECLUST_FUSED_MERGE=1, as in tests/test_pallas_kernels.py); the port runs
its pending-update loop on the CPU through the K1 twin. Integer-grid
features keep every f32 intermediate exact, so merge logs and clusters must
be identical; tie-free blobs must give equal partitions.
"""

import re

import numpy as np
import pytest
import torch

import imageclust_tpu.cluster.ward as jw
import imageclust_tpu_torch.cluster.ward as tw
from imageclust_tpu_torch.ops import merge_kernels as mk

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fused_pallas(monkeypatch):
    monkeypatch.setenv("IMAGECLUST_FUSED_MERGE", "1")


def _grid(seed, n, d, lo=-3, hi=4):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, (n, d)).astype(np.float32)


def _assert_identical(a, b):
    np.testing.assert_array_equal(a.merges, b.merges)
    assert a.cluster_map == b.cluster_map
    assert a.dropped == b.dropped
    assert a.n_clusters_target == b.n_clusters_target


def _partition(res):
    return {frozenset(m) for m in res.cluster_map.values()}


class TestParityWithJax:
    # The centroid rule sums (d,)-rows of fractional centroid offsets: XLA's
    # and torch's CPU reductions both add sequentially up to d = 8 and take
    # different orders beyond, so its integer grids stay at d <= 8. The
    # Lance-Williams rule has no reduction and runs at any width.
    @pytest.mark.parametrize("rule,seed,n,d", [
        ("centroid", 0, 24, 2), ("centroid", 1, 57, 4),
        ("centroid", 2, 130, 8), ("centroid", 3, 200, 8),
        ("centroid", 4, 90, 3), ("lance_williams", 0, 24, 2),
        ("lance_williams", 1, 57, 4), ("lance_williams", 2, 130, 8),
        ("lance_williams", 3, 200, 16), ("lance_williams", 4, 90, 64)])
    def test_integer_grid_logs_identical(self, rule, seed, n, d):
        x = _grid(seed, n, d)
        ids = [f"i{k}" for k in range(n)]
        for mn, mx in ((3, 6), (2, 4)):
            a = jw.constrained_ward(x, ids, min_size=mn, max_size=mx,
                                    update_rule=rule)
            b = tw.constrained_ward(x, ids, min_size=mn, max_size=mx,
                                    update_rule=rule, device="cpu")
            _assert_identical(a, b)

    @pytest.mark.parametrize("rule", ["centroid", "lance_williams"])
    def test_blobs_equal_partitions(self, rng, blobs, rule):
        x = blobs(rng, n_blobs=8, per_blob=5, d=16)
        a = jw.constrained_ward(x, min_size=3, max_size=6, update_rule=rule)
        b = tw.constrained_ward(x, min_size=3, max_size=6, update_rule=rule,
                                device="cpu")
        assert _partition(a) == _partition(b)
        assert sorted(a.dropped) == sorted(b.dropped)

    def test_continuous_gaussian_equal_partitions(self, rng):
        x = rng.normal(size=(150, 12)).astype(np.float32)
        a = jw.constrained_ward(x, min_size=3, max_size=6)
        b = tw.constrained_ward(x, min_size=3, max_size=6, device="cpu")
        assert _partition(a) == _partition(b)

    def test_torch_tensor_input(self):
        x = _grid(5, 40, 4)
        a = jw.constrained_ward(x, min_size=3, max_size=6)
        b = tw.constrained_ward(torch.from_numpy(x), min_size=3, max_size=6,
                                device="cpu")
        _assert_identical(a, b)

    def test_stalled_loop_stops(self):
        # tight triplets under (3, 4): once every cluster has 3 items no pair
        # is feasible, so `found` turns false before the target count
        rng = np.random.default_rng(9)
        centers = rng.normal(size=(4, 6)).astype(np.float32) * 50
        x = np.concatenate([c + rng.integers(-1, 2, (3, 6)) for c in centers])
        x = x.astype(np.float32)
        a = jw.constrained_ward(x, min_size=3, max_size=4)
        b = tw.constrained_ward(x, min_size=3, max_size=4, device="cpu")
        _assert_identical(a, b)
        assert len(b.merges) < len(x) - b.n_clusters_target

    def test_reassign_dropped(self, rng):
        x = _grid(11, 50, 4)
        for mn, mx in ((4, 5), (3, 6)):
            a = jw.constrained_ward(x, min_size=mn, max_size=mx,
                                    reassign_dropped=True)
            b = tw.constrained_ward(x, min_size=mn, max_size=mx,
                                    reassign_dropped=True, device="cpu")
            assert a.cluster_map == b.cluster_map
            assert a.dropped == b.dropped
            for members in b.cluster_map.values():
                assert len(members) <= mx

    def test_split_oversized_matches(self):
        x = _grid(12, 20, 3)
        members = list(range(3, 17))
        a = jw.split_oversized(x, members, 4)
        b = tw.split_oversized(x, members, 4, device="cpu")
        assert a == b
        assert all(len(m) <= 4 for m in b)


class TestLoopControl:
    def _counting(self):
        calls = []

        def step(state):
            calls.append(1)
            mk.merge_step_plain(state)

        return step, calls

    def test_steps_equal_merges_when_target_reached(self):
        x = _grid(13, 60, 4)
        step, calls = self._counting()
        res = tw._constrained_ward(
            x, None, min_size=3, max_size=6, update_rule="centroid",
            reassign_dropped=False, mesh=None, device="cpu", merge_step=step)
        assert len(calls) == len(res.merges) == 60 - res.n_clusters_target

    def test_stall_exits_within_found_read_window(self):
        # 256 tight triplets under (4, 5): the merges stop at 512 (every
        # cluster has 3 items), far below the n - n_target = 597 step bound;
        # the loop must notice within FOUND_READ_EVERY steps
        rng = np.random.default_rng(14)
        centers = rng.normal(size=(256, 4)).astype(np.float32) * 100
        x = np.repeat(centers, 3, axis=0) + rng.integers(
            -1, 2, (768, 4)).astype(np.float32)
        step, calls = self._counting()
        res = tw._constrained_ward(
            x, None, min_size=4, max_size=5, update_rule="lance_williams",
            reassign_dropped=False, mesh=None, device="cpu", merge_step=step)
        merges = len(res.merges)
        assert merges == 512
        assert merges < len(calls) <= merges + tw.FOUND_READ_EVERY
        assert len(calls) < len(x) - res.n_clusters_target
        assert len(res.dropped) == 768  # every cluster under min_size


class TestHostSide:
    @pytest.mark.parametrize("total,mn,mx", [
        (12, 3, 6), (100, 3, 6), (7, 2, 2), (2, 3, 6), (10, 4, 5), (5, 1, 1),
        (4096, 3, 6), (1, 1, 1)])
    def test_calculate_optimal_clusters(self, total, mn, mx):
        try:
            want = jw.calculate_optimal_clusters(total, mn, mx)
        except jw.ConstraintError as exc:
            with pytest.raises(tw.ConstraintError, match=re.escape(str(exc))):
                tw.calculate_optimal_clusters(total, mn, mx)
            return
        assert tw.calculate_optimal_clusters(total, mn, mx) == want

    @pytest.mark.parametrize("n,mn,mx", [(2, 3, 6), (7, 2, 2)])
    def test_constraint_errors(self, n, mn, mx):
        x = _grid(15, n, 3)
        with pytest.raises(jw.ConstraintError):
            jw.constrained_ward(x, min_size=mn, max_size=mx)
        with pytest.raises(tw.ConstraintError):
            tw.constrained_ward(x, min_size=mn, max_size=mx, device="cpu")

    def test_input_validation(self):
        with pytest.raises(ValueError, match="embeddings"):
            tw.constrained_ward(np.zeros(5, np.float32), device="cpu")
        with pytest.raises(ValueError, match="ids"):
            tw.constrained_ward(np.zeros((5, 2), np.float32), ["a"],
                                device="cpu")
        with pytest.raises(ValueError, match="update_rule"):
            tw.constrained_ward(_grid(1, 12, 2), update_rule="nope",
                                device="cpu")

    def test_mesh_not_ported(self, mesh8):
        """Formerly the refusal of ``mesh=``. An object that is not a Mesh
        is a TypeError; a Mesh (here a world of one rank: the mesh loop
        with identity collectives) runs the row-sharded loop, whose merge
        log on an integer grid (d = 4) is bit-identical to the JAX mesh
        engine's on the (4 x 2) virtual mesh under both rules. Multi-rank
        meshes: tests/test_torch_mesh_engines.py."""
        from imageclust_tpu_torch.core.mesh import create_mesh

        with pytest.raises(TypeError, match="Mesh"):
            tw.constrained_ward(_grid(1, 12, 2), mesh=object(), device="cpu")
        x = _grid(5, 90, 4)
        ids = [f"i{k}" for k in range(len(x))]
        one = create_mesh(data=1, device="cpu")
        for rule in ("centroid", "lance_williams"):
            a = jw.constrained_ward(x, ids, min_size=3, max_size=6,
                                    update_rule=rule, mesh=mesh8)
            b = tw.constrained_ward(x, ids, min_size=3, max_size=6,
                                    update_rule=rule, mesh=one)
            _assert_identical(a, b)

    def test_default_device_needs_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            tw.constrained_ward(_grid(1, 12, 2))

    def test_cluster_result_views_match(self):
        kw = dict(members=np.array([4, 0, 2, 1, 3]),
                  offsets=np.array([0, 2, 5]),
                  ids=["a", "b", "c", "d", "e", "f"],
                  dropped_idx=[5], n_items=6)
        a, b = jw.ClusterResult(**kw), tw.ClusterResult(**kw)
        assert b.n_clusters == a.n_clusters == 2
        assert b.cluster_map == a.cluster_map == {0: ["e", "a"],
                                                  1: ["c", "b", "d"]}
        assert b.dropped == a.dropped == ["f"]
        assert b._index_map == a._index_map
        np.testing.assert_array_equal(b.assignments(), a.assignments())
        with pytest.raises(ValueError):
            tw.ClusterResult()

    def test_eager_result_views(self):
        x = _grid(16, 30, 3)
        a = jw.constrained_ward(x, min_size=3, max_size=6)
        b = tw.constrained_ward(x, min_size=3, max_size=6, device="cpu")
        assert b._index_map == a._index_map
        np.testing.assert_array_equal(b.assignments(), a.assignments())
        assert b.n_clusters == a.n_clusters

    def test_default_ids(self):
        ids = tw.DefaultIds(4)
        assert list(ids) == list(jw.DefaultIds(4)) == [f"img_{i}"
                                                       for i in range(4)]
        assert ids[-1] == "img_3" and ids[1:3] == ["img_1", "img_2"]
        with pytest.raises(IndexError):
            ids[4]

    def test_pairwise_ward_singleton_matches(self, rng):
        x = rng.integers(-5, 6, (40, 7)).astype(np.float32)
        want = np.asarray(jw.pairwise_ward_singleton(x))
        got = tw.pairwise_ward_singleton(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("rule", ["centroid", "lance_williams"])
    def test_ward_update_vector_matches(self, rng, rule):
        m, d = 32, 5
        sizes = rng.integers(1, 5, m).astype(np.float32)
        cents = rng.integers(-4, 5, (m, d)).astype(np.float32) / 3
        c_new = rng.integers(-4, 5, d).astype(np.float32) / 3
        da, db = (rng.random(m).astype(np.float32) for _ in range(2))
        kw = dict(s_a_f=np.float32(2), s_b_f=np.float32(3),
                  s_new_f=np.float32(5), d_a=da, d_b=db,
                  d_ab=np.float32(0.25), cents=cents, c_new=c_new)
        want = np.asarray(jw.ward_update_vector(rule, sizes_f=sizes, **kw))
        got = tw.ward_update_vector(
            rule, sizes_f=torch.from_numpy(sizes),
            **{k: torch.as_tensor(v) for k, v in kw.items()}).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
