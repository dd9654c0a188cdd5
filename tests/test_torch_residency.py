"""bf16/int8 feature residency of the port's bucketed engine against the JAX
package: the int8 quantizer, the residency branches of the distance tile,
the Lloyd step, the need-only preference rows, the spill centroids (slab
and member-table paths) and candidates, whole bucketed runs at every
``feature_dtype`` (tile, fused-summarize and need-only modes), and the
streamed embed's residency casts with the label fusion on the int8 grid.

Integer-valued data keeps every f32 intermediate exact on both sides, so
those comparisons are bit-identical; bf16 on random data is held to rtol
1e-5 (the f32 sums of exact bf16 products add in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageclust_tpu.cluster.sharded as jsh
from imageclust_tpu_torch.cluster import sharded as tsh

torch.set_num_threads(2)

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "int8": torch.int8}
DTYPES = list(_JDT)


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    a = np.asarray(a)
    if dtype == "int8":
        a = a.astype(np.int8)
    return (jnp.asarray(a).astype(_JDT[dtype]),
            torch.from_numpy(np.ascontiguousarray(a)).to(_TDT[dtype]))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a):
    a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    return a


@pytest.fixture()
def jax_init(monkeypatch):
    """Make the port's k-means start from the JAX package's rows."""

    def init(x, k, seed):
        idx = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed),
                                                x.shape[0])[:k])
        return x[torch.from_numpy(idx.copy())].to(torch.float32)

    monkeypatch.setattr(tsh, "_kmeans_init", init)


class TestQuantizeAndTiles:
    @pytest.mark.parametrize("src", ["float32", "bfloat16"])
    def test_feat_int8_matches_jax(self, rng, src, monkeypatch):
        x = (rng.normal(size=(300, 20)) * 3).astype(np.float32)
        jx, tx = _pair(x, src)
        want = np.asarray(jsh._feat_int8(jx))
        np.testing.assert_array_equal(tsh._feat_int8(tx).numpy(), want)
        monkeypatch.setattr(tsh, "_KMEANS_BLOCK", 64)  # blockwise passes
        np.testing.assert_array_equal(tsh._feat_int8(tx).numpy(), want)
        zeros = np.zeros((5, 3), np.float32)  # the 1e-30 scale floor
        np.testing.assert_array_equal(
            tsh._feat_int8(torch.from_numpy(zeros)).numpy(),
            np.asarray(jsh._feat_int8(jnp.asarray(zeros))))

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("norms", [False, True])
    def test_sqdist_tile_integer_data_bit_identical(self, rng, dtype, norms):
        rows = rng.integers(-90, 90, (64, 40))
        cents = rng.integers(-90, 90, (23, 40)).astype(np.float32) + 0.25
        jr, tr = _pair(rows, dtype)
        jc, tc = jnp.asarray(cents), torch.from_numpy(cents)
        if norms:  # the spill path: centroids stored in the residency
            jc, tc = _pair(np.round(cents), dtype)
            jn = jsh._cent_norms(jc)
            tn = tsh._cent_norms(tc)
            np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
            want, got = jsh._sqdist_tile(jr, jc, jn), tsh._sqdist_tile(
                tr, tc, tn)
        else:
            want, got = jsh._sqdist_tile(jr, jc), tsh._sqdist_tile(tr, tc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_sqdist_tile_bf16_random_data(self, rng):
        rows = rng.normal(size=(64, 40)).astype(np.float32)
        cents = rng.normal(size=(23, 40)).astype(np.float32)
        jr, tr = _pair(rows, "bfloat16")
        want = np.asarray(jsh._sqdist_tile(jr, jnp.asarray(cents)))
        got = tsh._sqdist_tile(tr, torch.from_numpy(cents)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_kmeans_iter_integer_data_bit_identical(self, rng, dtype):
        x = rng.integers(-100, 100, (300, 12))
        jx, tx = _pair(x, dtype)
        cents = x[rng.choice(300, 17, replace=False)].astype(np.float32)
        for block in (64, 512):  # a scan plus a tail, and one block
            want = np.asarray(jsh._kmeans_iter(jx, jnp.asarray(cents), k=17,
                                               block=block))
            got = tsh._kmeans_iter(tx, torch.from_numpy(cents), 17, block)
            np.testing.assert_array_equal(got.numpy(), want)

    def test_kmeans_iter_bf16_random_data(self, rng):
        x = rng.normal(size=(300, 12)).astype(np.float32)
        jx, tx = _pair(x, "bfloat16")
        cents = x[:17].copy()
        want = np.asarray(jsh._kmeans_iter(jx, jnp.asarray(cents), k=17,
                                           block=64))
        got = tsh._kmeans_iter(tx, torch.from_numpy(cents), 17, 64).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_kmeans_at_residency_matches_jax(self, rng, dtype, jax_init):
        x = rng.integers(-60, 60, (240, 10))
        jx, tx = _pair(x, dtype)
        jc, ja, jo, jp = jsh.kmeans(jx, 9, iters=4)
        tc, ta, to, tp = tsh.kmeans(tx, 9, iters=4)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
        _, na, no, npref = tsh.kmeans(tx, 9, iters=4, top_k=0)
        assert npref is None and torch.equal(na, ta)


class TestNeedOnly:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_pref_need_rows_match_jax(self, rng, dtype):
        x = rng.integers(-30, 30, (500, 16))
        jx, tx = _pair(x, dtype)
        cents = rng.integers(-30, 30, (21, 16)).astype(np.float32)
        idx = np.sort(rng.choice(500, 130, replace=False)).astype(np.int32)
        blk = 64
        pad = np.zeros(192, np.int32)
        pad[:130] = idx
        want = np.asarray(jsh._pref_need_rows(
            jx, jnp.asarray(cents), jnp.asarray(pad), kk=8, block=blk,
            as_u16=True))[:130]
        got = tsh._pref_need_rows(tx, torch.from_numpy(cents),
                                  torch.from_numpy(idx.astype(np.int64)), 8,
                                  blk, True)
        np.testing.assert_array_equal(tsh._to_host(got), want)
        got32 = tsh._pref_need_rows(tx, torch.from_numpy(cents),
                                    torch.from_numpy(idx.astype(np.int64)),
                                    8, blk, False)
        np.testing.assert_array_equal(got32.numpy(), want.astype(np.int32))

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_repair_need_only_matches_jax(self, rng, dtype):
        """Skewed assignments force spills and dissolves, so repair reads
        the need-set's rows computed on demand."""
        n, nb = 900, 30
        x = rng.integers(-40, 40, (n, 8))
        jx, tx = _pair(x, dtype)
        cents = rng.integers(-40, 40, (nb, 8)).astype(np.float32)
        w = rng.lognormal(0, 1.5, nb)
        assign = rng.choice(nb, size=n, p=w / w.sum()).astype(np.int32)
        own = rng.random(n).astype(np.float32)
        want = jsh._repair_buckets_device(
            jnp.asarray(assign), jnp.asarray(own), None, nb, 40, 3,
            feats=jx, cents=jnp.asarray(cents))
        got = tsh._repair_buckets_device(
            torch.from_numpy(assign), torch.from_numpy(own), None, nb, 40, 3,
            feats=tx, cents=torch.from_numpy(cents))
        assert [list(map(int, b)) for b in got] == [
            list(map(int, b)) for b in want]
        with pytest.raises(ValueError, match="need-only"):
            tsh._repair_buckets_device(torch.from_numpy(assign),
                                       torch.from_numpy(own), None, nb, 40, 3)


class TestSpills:
    def _state(self, rng, dtype):
        """Integer-grid features (clusters, a spread of dropped items) in
        the residency dtype."""
        n, d = 150, 6
        x = rng.integers(-100, 100, (n, d))
        order = rng.permutation(n)
        members, sizes, bucket = [], [], []
        pos = 0
        while pos < 120:
            s = int(rng.integers(3, 6))
            members.append(order[pos:pos + s])
            sizes.append(s)
            bucket.append(len(sizes) % 4)
            pos += s
        dropped = [int(i) for i in order[pos:]]
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        jx, tx = _pair(x, dtype)
        return (jx, tx, np.concatenate(members), offsets, np.array(bucket),
                dropped)

    @pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
    def test_centroids_slab_and_table_match_jax(self, rng, dtype):
        jx, tx, members, offsets, bucket, _ = self._state(rng, dtype)
        cols = tsh._Clusters(members, offsets, bucket)
        n = tx.shape[0]
        assign = cols.assign_array(n)
        c_pad = 1 << max(cols.num - 1, 1).bit_length()
        sizes = np.full(c_pad, 6, np.int32)
        sizes[:cols.num] = cols.sizes()
        want = jsh._spill_centroids(jx, jnp.asarray(assign),
                                    jnp.asarray(sizes), c_pad)
        got = tsh._spill_centroids(tx, torch.from_numpy(assign),
                                   torch.from_numpy(sizes), c_pad,
                                   int(cols.sizes().max()))
        assert got.dtype == _TDT[dtype]
        np.testing.assert_array_equal(_np(got), _jnp(want))
        # the member-table path, with one round's appends
        jt, jc = jsh._spill_member_table(jnp.asarray(assign), c_pad, 6)
        tt, tcnt = tsh._spill_member_table(torch.from_numpy(assign), c_pad, 6)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        a, b = np.flatnonzero(cols.sizes() <= 4)[:2]  # clusters with room
        rows = np.array([a, b, a], np.int32)
        slots = np.array([int(cols.sizes()[a]), int(cols.sizes()[b]),
                          int(cols.sizes()[a]) + 1], np.int32)
        items = np.array([n - 1, n - 2, n - 3], np.int32)
        jt, jc = jsh._spill_table_append(jt, jc, jnp.asarray(rows),
                                         jnp.asarray(slots),
                                         jnp.asarray(items))
        tsh._spill_table_append(tt, tcnt, *(torch.from_numpy(
            a.astype(np.int64)) for a in (rows, slots, items)))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(
            tsh._sizes_from_counts(tcnt, cols.num, 6).numpy(),
            np.asarray(jsh._sizes_from_counts(jc, jnp.int32(cols.num),
                                              jnp.int32(6))))
        wc, wn = jsh._spill_cent_table(jx, jt, jc, c_pad)
        gc, gn = tsh._spill_cent_table(tx, tt, tcnt)
        np.testing.assert_array_equal(_np(gc), _jnp(wc))
        np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))

    @pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
    def test_candidates_match_jax(self, rng, dtype):
        jx, tx, _, _, _, dropped = self._state(rng, dtype)
        cents = rng.integers(-100, 100, (32, 6))
        jc, tc = _pair(cents, dtype)
        jn, tn = jsh._cent_norms(jc), tsh._cent_norms(tc)
        sizes = rng.integers(2, 7, 32).astype(np.int32)
        drop = np.asarray(dropped, np.int32)
        d64 = torch.from_numpy(drop.astype(np.int64))
        for norms in (False, True):
            want = jsh._spill_candidates(
                jx, jc, jnp.asarray(sizes), jnp.asarray(drop), 8,
                jnp.int32(6), jn if norms else None)
            got = tsh._spill_candidates(tx, tc, torch.from_numpy(sizes), d64,
                                        8, 6, tn if norms else None)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            table = rng.integers(-1, 32, (4, 7)).astype(np.int32)
            ib = rng.integers(0, 4, len(drop)).astype(np.int32)
            want = jsh._spill_candidates_local(
                jx, jc, jnp.asarray(sizes), jnp.asarray(drop),
                jnp.asarray(ib), jnp.asarray(table), 5, jnp.int32(6),
                jn if norms else None)
            got = tsh._spill_candidates_local(
                tx, tc, torch.from_numpy(sizes), d64,
                torch.from_numpy(ib.astype(np.int64)),
                torch.from_numpy(table.astype(np.int64)), 5, 6,
                tn if norms else None)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
    @pytest.mark.parametrize("table", [True, False])
    def test_spill_rounds_match_jax(self, rng, monkeypatch, dtype, table):
        """Local then global rounds on one column set: the member table is
        built once and carried between the two phases (or, past the table
        bound, the slab path runs every round; JAX's env switch picks the
        same path there)."""
        if not table:
            monkeypatch.setattr(tsh, "_SPILL_TABLE_BYTES", 0)
            monkeypatch.setenv("IMAGECLUST_SPILL_TABLE", "0")
        jx, tx, members, offsets, bucket, dropped = self._state(rng, dtype)
        bucket_of = {i: int(rng.integers(0, 4)) for i in dropped}
        jc = jsh._Clusters(members.copy(), offsets.copy(), bucket.copy())
        tc = tsh._Clusters(members.copy(), offsets.copy(), bucket.copy())
        want = jsh._spill_rounds(jx, jc, list(dropped), 6,
                                 item_bucket_of=bucket_of)
        got = tsh._spill_rounds(tx, tc, list(dropped), 6,
                                item_bucket_of=bucket_of)
        assert got == want and len(got) < len(dropped)
        assert (tc._spill_dev is not None) == table
        assert jsh._spill_rounds(jx, jc, want, 6) == tsh._spill_rounds(
            tx, tc, got, 6)
        for a, b in zip(tc.finalize(), jc.finalize()):
            np.testing.assert_array_equal(a, b)


def _blobs(rng, n_blobs, per, d, spread=8, scale=50):
    centers = rng.integers(-scale, scale + 1, (n_blobs, d)) * spread
    x = np.repeat(centers, per, axis=0) + rng.integers(-1, 2,
                                                       (n_blobs * per, d))
    return x.astype(np.float32)


def _skewed(rng):
    """Skewed blob sizes force over-capacity spills and under-min dissolves
    (tests/test_pallas_kernels.py:422-428)."""
    centers = (rng.integers(-5, 6, (6, 12)) * 8).astype(np.float32)
    sizes = [160, 90, 40, 20, 6, 2]
    x = np.concatenate([c + rng.integers(-2, 3, (s, 12)).astype(np.float32)
                        for c, s in zip(centers, sizes)])
    return x[rng.permutation(len(x))]


def _same_run(x, kw):
    want = jsh.constrained_ward_bucketed(x, min_size=3, max_size=6, **kw)
    got = tsh.constrained_ward_bucketed(x, min_size=3, max_size=6,
                                        device="cpu", **kw)
    assert got.cluster_map == want.cluster_map
    assert got.dropped == want.dropped
    np.testing.assert_array_equal(got.merges, want.merges)
    return got


class TestEngine:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("mode", ["tile", "fused", "need_only"])
    def test_identical_to_jax_on_grid_blobs(self, rng, monkeypatch, jax_init,
                                            dtype, mode):
        if mode == "fused":  # JAX: interpret mode off a TPU
            monkeypatch.setenv("IMAGECLUST_SUMMARIZE_FUSED", "1")
            monkeypatch.setattr(tsh, "_use_summarize_fused",
                                lambda dev, k: True)
        elif mode == "need_only":
            monkeypatch.setattr(jsh, "_PREF_NEED_ONLY_MIN_WORK", 10)
            monkeypatch.setattr(tsh, "_PREF_NEED_ONLY_MIN_WORK", 10)
        x = _blobs(rng, 140, 5, 8)
        got = _same_run(x, dict(bucket_size=128, feature_dtype=dtype))
        assert got.n_buckets >= 5

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_skewed_blobs_spill_and_match_jax(self, rng, jax_init, dtype):
        x = _skewed(rng)
        got = _same_run(x, dict(bucket_size=16, feature_dtype=dtype))
        placed = sum(len(m) for m in got.cluster_map.values())
        assert placed + len(got.dropped) == len(x)

    def test_need_only_mode_on_skewed_blobs(self, rng, monkeypatch,
                                            jax_init):
        monkeypatch.setattr(jsh, "_PREF_NEED_ONLY_MIN_WORK", 10)
        monkeypatch.setattr(tsh, "_PREF_NEED_ONLY_MIN_WORK", 10)
        _same_run(_skewed(rng), dict(bucket_size=16, feature_dtype="int8"))

    def test_int8_input_is_used_as_is(self, rng, jax_init):
        x = rng.integers(-100, 100, (400, 6)).astype(np.int8)
        got = _same_run(x, dict(bucket_size=128, feature_dtype="int8"))
        same = tsh.constrained_ward_bucketed(
            torch.from_numpy(x), min_size=3, max_size=6, bucket_size=128,
            feature_dtype="int8", device="cpu")
        assert same.cluster_map == got.cluster_map

    @pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
    def test_single_bucket_hands_off_grid_values(self, rng, dtype):
        x = rng.normal(size=(40, 4)).astype(np.float32)
        _same_run(x, dict(bucket_size=128, feature_dtype=dtype))
