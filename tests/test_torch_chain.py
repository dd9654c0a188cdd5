"""The port's NN-chain engine (``constrained_ward_chain``) against the JAX
package's, and the equivalence tests of tests/test_chain.py with the port's
greedy engine as the arbiter.

Both loops are checked, picked with ``IMAGECLUST_CHAIN_IMPL`` as in the JAX
package: ``rnn`` (batched reciprocal-NN rounds, the default) and ``seq``
(the sequential chain). Tolerances: on tie-free Gaussian features the
partitions and dropped sets are identical and the loops' heights allclose
at rtol 1e-5. On integer-grid features at d <= 8 the ``rnn`` merge logs
are identical. The ``seq`` body's row sum ``sum(diff * diff)`` is a chain
of fused multiply-adds on XLA's CPU and rounds each product in torch, so
its heights differ from the JAX package's in the last bit and its log may
leave the JAX log at a tie (ROADMAP.md queue 3, a deliberate difference);
on grids it is held to rtol 1e-6 up to the first differing row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import imageclust_tpu.cluster.chain as jchain
from imageclust_tpu.cluster import constrained_ward_chain as jax_chain
from imageclust_tpu_torch.cluster import (
    ConstraintError,
    constrained_ward,
    constrained_ward_chain,
)
from imageclust_tpu_torch.cluster import chain as tchain

torch.set_num_threads(1)

IMPLS = ("rnn", "seq")


def _partition(result):
    """Order-free view of a ClusterResult: set of frozensets of member ids."""
    return {frozenset(m) for m in result.cluster_map.values()}


def _chain(x, *args, **kw):
    return constrained_ward_chain(x, *args, device="cpu", **kw)


def _greedy(x, **kw):
    return constrained_ward(x, device="cpu", **kw)


@pytest.fixture(params=IMPLS)
def impl(request, monkeypatch):
    monkeypatch.setenv("IMAGECLUST_CHAIN_IMPL", request.param)
    return request.param


@pytest.fixture()
def gauss(rng):
    def make(n, d=8, scale=1.0):
        return (rng.standard_normal((n, d)) * scale).astype(np.float32)

    return make


class TestMatchesJax:
    @pytest.mark.parametrize("d", [2, 4, 8])
    @pytest.mark.parametrize("n,mn,mx", [(150, 3, 6), (257, 2, 9)])
    def test_integer_grid_identical_logs(self, rng, monkeypatch, d, n, mn,
                                         mx):
        monkeypatch.setenv("IMAGECLUST_CHAIN_IMPL", "rnn")
        x = rng.integers(-3, 4, (n, d)).astype(np.float32)
        got = _chain(x, min_size=mn, max_size=mx, reassign_dropped=False)
        want = jax_chain(x, min_size=mn, max_size=mx, reassign_dropped=False)
        np.testing.assert_array_equal(got.merges, want.merges)
        assert got.cluster_map == want.cluster_map
        assert got.dropped == want.dropped

    @pytest.mark.parametrize("d", [2, 4, 8])
    @pytest.mark.parametrize("n,mx", [(150, 6), (257, 9)])
    def test_seq_integer_grid_logs_agree_to_rounding(self, rng, d, n, mx):
        x = rng.integers(-3, 4, (n, d)).astype(np.float32)
        n_pad = tchain._pad_len(n)
        got = tchain._chain_loop(
            tchain._pad_features(torch.from_numpy(x), n_pad, d), n, mx)
        xp = np.zeros((n_pad, d), np.float32)
        xp[:n] = x
        want = jchain._chain_loop(jnp.asarray(xp), n, mx)
        glog, wlog = got[0][:got[2]].numpy(), np.asarray(want[0])[:want[2]]
        m = min(len(glog), len(wlog))
        rows = np.nonzero((glog[:m] != wlog[:m]).any(axis=1))[0]
        same = int(rows[0]) if len(rows) else m
        np.testing.assert_allclose(got[1][:same].numpy(),
                                   np.asarray(want[1])[:same], rtol=1e-6)

    @pytest.mark.parametrize("d", [16, 64])
    @pytest.mark.parametrize("n,mn,mx", [(200, 3, 6), (333, 2, 9)])
    def test_gaussian_identical_partitions(self, gauss, impl, d, n, mn, mx):
        x = gauss(n, d)
        got = _chain(x, min_size=mn, max_size=mx, reassign_dropped=False)
        want = jax_chain(x, min_size=mn, max_size=mx, reassign_dropped=False)
        assert _partition(got) == _partition(want)
        assert set(got.dropped) == set(want.dropped)

    @pytest.mark.parametrize("d", [16, 64])
    def test_loop_heights_close(self, gauss, impl, d):
        n, max_size = 300, 6
        x = gauss(n, d)
        if impl == "rnn":
            got = tchain._rnn_loop(torch.from_numpy(x), n, max_size)
            want = jchain._rnn_loop(jnp.asarray(x), n, max_size)
        else:
            n_pad = tchain._pad_len(n)
            got = tchain._chain_loop(
                tchain._pad_features(torch.from_numpy(x), n_pad, d), n,
                max_size)
            xp = np.zeros((n_pad, d), np.float32)
            xp[:n] = x
            want = jchain._chain_loop(jnp.asarray(xp), n, max_size)
        m = int(want[2])
        assert got[2] == m
        np.testing.assert_array_equal(got[0][:m].numpy(),
                                      np.asarray(want[0])[:m])
        np.testing.assert_allclose(got[1][:m].numpy(),
                                   np.asarray(want[1])[:m], rtol=1e-5)

    def test_spill_matches_jax(self, gauss, impl):
        x = gauss(300, 16)
        got = _chain(x)
        want = jax_chain(x)
        assert _partition(got) == _partition(want)
        assert got.dropped == want.dropped == []


class TestChainMatchesGreedy:
    """Chain partition == greedy exact-engine partition on tie-free floats
    (tests/test_chain.py:33-60)."""

    @pytest.mark.parametrize("n,mn,mx", [(60, 3, 6), (200, 3, 6), (333, 2, 9)])
    def test_constrained(self, gauss, impl, n, mn, mx):
        x = gauss(n)
        ref = _greedy(x, min_size=mn, max_size=mx)
        got = _chain(x, min_size=mn, max_size=mx, reassign_dropped=False)
        assert _partition(got) == _partition(ref)
        assert set(got.dropped) == set(ref.dropped)

    def test_unconstrained_sizes(self, gauss, impl):
        # max_size = n disables poisoning: pure Ward dendrogram cut
        x = gauss(120)
        ref = _greedy(x, min_size=1, max_size=120)
        got = _chain(x, min_size=1, max_size=120, reassign_dropped=False)
        assert _partition(got) == _partition(ref)

    def test_tensor_input(self, gauss):
        x = gauss(90)
        ref = _chain(x, reassign_dropped=False)
        got = _chain(torch.from_numpy(x), reassign_dropped=False)
        assert _partition(got) == _partition(ref)
        assert got.cluster_map == ref.cluster_map


class TestChainGreedyFuzz:
    """Property fuzz over seeds and constraint shapes (tests/test_chain.py:
    63-97): the chain partition must equal the greedy engine's on
    continuous (generically tie-free) data."""

    @settings(max_examples=30, deadline=None)
    @given(
        seed=st.integers(0, 2**31 - 1),
        n=st.integers(10, 120),
        mn=st.integers(1, 4),
        span=st.integers(1, 6),
        d=st.integers(2, 12),
    )
    def test_matches_greedy(self, seed, n, mn, span, d):
        x = (np.random.default_rng(seed)
             .standard_normal((n, d)).astype(np.float32))
        mx = mn + span
        try:
            ref = _greedy(x, min_size=mn, max_size=mx)
        except ConstraintError:
            with pytest.raises(ConstraintError):
                _chain(x, min_size=mn, max_size=mx)
            return
        got = _chain(x, min_size=mn, max_size=mx, reassign_dropped=False)
        assert _partition(got) == _partition(ref)
        assert set(got.dropped) == set(ref.dropped)


class TestChainMatchesScipy:
    def test_unconstrained_partition(self, rng, impl):
        pytest.importorskip("scipy")
        from scipy.cluster.hierarchy import fcluster, linkage

        n = 150
        x = rng.standard_normal((n, 16)).astype(np.float32)
        # max_size = n disables poisoning: the cut at the chain's own
        # target must match scipy's maxclust cut of the same dendrogram
        got = _chain(x, min_size=1, max_size=n, reassign_dropped=False)
        want = fcluster(linkage(x, method="ward"), len(got.cluster_map),
                        criterion="maxclust")
        assign = got.assignments()
        pairs = {(a, b) for a in range(n) for b in range(a)
                 if assign[a] >= 0 and assign[a] == assign[b]}
        pairs_scipy = {(a, b) for a in range(n) for b in range(a)
                       if want[a] == want[b]}
        assert pairs == pairs_scipy


class TestConstraints:
    def test_max_size_respected(self, gauss, impl):
        res = _chain(gauss(257), min_size=3, max_size=6)
        for members in res.cluster_map.values():
            assert len(members) <= 6

    def test_no_loss_default(self, gauss, impl):
        res = _chain(gauss(500), min_size=3, max_size=6)
        placed = sum(len(m) for m in res.cluster_map.values())
        assert placed + len(res.dropped) == 500
        assert not res.dropped  # the spill pass places everything here
        for members in res.cluster_map.values():
            assert 1 <= len(members) <= 6

    def test_parity_drop_semantics(self, gauss, impl):
        res = _chain(gauss(100), reassign_dropped=False)
        placed = sum(len(m) for m in res.cluster_map.values())
        assert placed + len(res.dropped) == 100
        for members in res.cluster_map.values():
            assert 3 <= len(members) <= 6

    def test_deterministic(self, gauss, impl):
        x = gauss(180)
        a = _chain(x)
        b = _chain(x)
        assert a.cluster_map == b.cluster_map
        assert a.dropped == b.dropped

    def test_infeasible_raises(self, gauss):
        with pytest.raises(ConstraintError):
            _chain(gauss(2), min_size=3, max_size=6)

    def test_merge_log_heights_cover_cut(self, gauss, impl):
        res = _chain(gauss(64), reassign_dropped=False)
        # applied merges = n - target (feasible here)
        assert res.merges.shape[0] == 64 - res.n_clusters_target


class TestRobustness:
    def test_cut_monotone_correction(self):
        # crafted float-rounding inversion: the parent merge (birth 5)
        # carries a height BELOW its child's (birth 4); the corrected cut
        # must apply child then parent and keep every leaf once
        log = np.array([[1, 0, 4], [4, 2, 5], [5, 3, 6]], np.int32)
        heights = np.array([1.0, 0.99999, 2.0], np.float32)  # inversion
        clusters, applied = tchain._cut(log, heights, n_items=4, n_target=2)
        flat = sorted(i for mem in clusters for i in mem)
        assert flat == [0, 1, 2, 3]
        assert {frozenset(m) for m in clusters} == {
            frozenset({0, 1, 2}), frozenset({3})}
        assert list(applied) == [0, 1]
        j_clusters, j_applied = jchain._cut(log, heights, 4, 2)
        assert clusters == j_clusters
        assert list(applied) == list(j_applied)

    def test_rnn_rounds_match_sequential_chain(self, gauss, monkeypatch):
        for n, mn, mx in [(150, 3, 6), (257, 2, 9), (64, 1, 64)]:
            x = gauss(n)
            monkeypatch.setenv("IMAGECLUST_CHAIN_IMPL", "rnn")
            got = _chain(x, min_size=mn, max_size=mx, reassign_dropped=False)
            monkeypatch.setenv("IMAGECLUST_CHAIN_IMPL", "seq")
            ref = _chain(x, min_size=mn, max_size=mx, reassign_dropped=False)
            assert _partition(got) == _partition(ref)
            assert set(got.dropped) == set(ref.dropped)

    @pytest.mark.parametrize("as_tensor", [False, True])
    def test_features_unchanged(self, gauss, impl, as_tensor):
        """The loops merge centroids in place in their own buffer: the
        caller's array (which ``torch.from_numpy`` shares) and tensor are
        untouched, here where ``.to(float32)`` returns the same tensor."""
        x = gauss(200, 8)
        before = x.copy()
        arg = torch.from_numpy(x) if as_tensor else x
        _chain(arg)
        np.testing.assert_array_equal(x, before)

    def test_mesh_raises(self, gauss, mesh8, monkeypatch):
        """Formerly the refusal of ``mesh=``. An object that is not a Mesh
        is a TypeError; a Mesh (a world of one rank here) runs the mesh
        loops, ``rnn`` and ``seq``: the same partition as the JAX mesh
        chain on the (4 x 2) virtual mesh, on tie-free Gaussian features.
        Multi-rank meshes: tests/test_torch_mesh_engines.py."""
        from imageclust_tpu_torch.core.mesh import create_mesh

        with pytest.raises(TypeError, match="Mesh"):
            constrained_ward_chain(gauss(20), mesh=object(), device="cpu")
        x = gauss(120)
        one = create_mesh(data=1, device="cpu")
        for impl in IMPLS:
            monkeypatch.setenv("IMAGECLUST_CHAIN_IMPL", impl)
            got = constrained_ward_chain(x, mesh=one)
            want = jax_chain(x, mesh=mesh8)
            assert _partition(got) == _partition(want), impl
            assert sorted(got.dropped) == sorted(want.dropped), impl

    def test_default_device_needs_cuda(self, gauss, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            constrained_ward_chain(gauss(20))

    def test_ids_and_columnar_result(self, gauss, impl):
        x = gauss(40)
        res = _chain(x, reassign_dropped=False)
        assert all(i.startswith("img_") for m in res.cluster_map.values()
                   for i in m)
        named = _chain(x, [f"p{i}" for i in range(40)],
                       reassign_dropped=False)
        assert named.assignments().tolist() == res.assignments().tolist()
        with pytest.raises(ValueError, match="ids length"):
            _chain(x, ["a"])
        with pytest.raises(ValueError, match=r"\(n, d\)"):
            _chain(x[0])
        assert res.loop_stats["impl"] == impl

    def test_seq_backstop_raises(self, gauss, monkeypatch):
        monkeypatch.setenv("IMAGECLUST_CHAIN_IMPL", "seq")
        monkeypatch.setattr(tchain, "_chain_step", lambda st, ms: None)
        with pytest.raises(RuntimeError, match="did not converge"):
            _chain(gauss(12))

    def test_rnn_round_bound_raises(self, gauss, monkeypatch):
        monkeypatch.setenv("IMAGECLUST_CHAIN_IMPL", "rnn")
        monkeypatch.setattr(tchain, "_merge_round", lambda st, ms: (1, 12))
        monkeypatch.setattr(tchain, "_recompute_round",
                            lambda st, r, ms: st.pending.fill_(False))
        with pytest.raises(RuntimeError, match="did not converge"):
            _chain(gauss(12))


class TestStructured:
    def test_obvious_blobs(self, rng, impl):
        # 4 well-separated blobs of 5 -> exactly 4 clusters, one per blob
        centers = np.array([[0, 0], [40, 0], [0, 40], [40, 40]], np.float32)
        x = np.concatenate([
            c + rng.standard_normal((5, 2)).astype(np.float32) * 0.1
            for c in centers
        ])
        res = _chain(x, min_size=3, max_size=6)
        assert _partition(res) == {
            frozenset(f"img_{i}" for i in range(b * 5, b * 5 + 5))
            for b in range(4)
        }
