"""K4's plain twin (``pref_topk_block_plain``) and the port's fused summarize
against the JAX package's Pallas kernel in interpret mode.

Integer-valued inputs make every f32 intermediate exact on both sides, so
indices and distances must be bit-identical for f32, bf16 and int8 rows,
ties included (ascending centroid index). The JAX wrapper needs d padded to
128 lanes and k to its centroid chunks (+inf norms on padding rows); the
port's does not, so only the JAX call is padded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageclust_tpu.cluster.sharded as jsh
from imageclust_tpu.ops.pallas_kernels import pref_topk_block as jax_k4
from imageclust_tpu_torch.cluster import sharded as tsh
from imageclust_tpu_torch.ops import pref_kernels as pk
from imageclust_tpu_torch.ops._build import launches

torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16),
       "int8": (jnp.int8, torch.int8)}


def _jax_topk(x, c, kk, block_c):
    """The Pallas kernel in interpret mode on zero-padded copies."""
    n, d = x.shape
    k = c.shape[0]
    d_pad = -(-d // 128) * 128
    k_pad = -(-k // block_c) * block_c
    cn = (c.astype(np.float64) ** 2).sum(1).astype(np.float32)
    xp = np.zeros((n, d_pad), x.dtype)
    xp[:, :d] = x
    cp = np.zeros((k_pad, d_pad), c.dtype)
    cp[:k, :d] = c
    cnp = np.full(k_pad, np.inf, np.float32)
    cnp[:k] = cn
    return xp, cp, cnp, cn


def _both(x, c, kk, block_c, dtype):
    jdt, tdt = _DT[dtype]
    xp, cp, cnp, cn = _jax_topk(x, c, kk, block_c)
    ji, jv = jax_k4(jnp.asarray(xp).astype(jdt), jnp.asarray(cp).astype(jdt),
                    jnp.asarray(cnp), kk=kk, block_c=block_c, interpret=True,
                    with_dists=True)
    ti, tv = pk.pref_topk_block(torch.from_numpy(x).to(tdt),
                                torch.from_numpy(c).to(tdt),
                                torch.from_numpy(cn), kk)
    return (np.asarray(ji), np.asarray(jv)), (ti.numpy(), tv.numpy())


@pytest.mark.parametrize("dtype", list(_DT))
@pytest.mark.parametrize("n,k,d,kk,block_c", [
    (16, 384, 128, 8, 128),   # three centroid chunks
    (40, 19, 48, 8, 128),     # k and d padded for the JAX call
    (12, 5, 20, 5, 128),      # kk = k
    (9, 70, 33, 8, 128)])     # odd d, two JAX-side chunks of k
def test_twin_bit_identical_to_pallas(rng, dtype, n, k, d, kk, block_c):
    hi = 100 if dtype == "int8" else 20
    x = rng.integers(-hi, hi, (n, d)).astype(np.float32)
    c = rng.integers(-hi, hi, (k, d)).astype(np.float32)
    (ji, jv), (ti, tv) = _both(x, c, kk, block_c, dtype)
    assert ti.dtype == np.int32 and tv.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("dtype", list(_DT))
def test_twin_ties_break_by_index_across_chunks(rng, dtype):
    """Duplicated centroids in different chunks tie exactly: lower global
    index first (tests/test_pallas_kernels.py:288-305)."""
    blk = 128
    base = rng.integers(-5, 5, (blk, 128)).astype(np.float32)
    c = np.concatenate([base, base])
    x = rng.integers(-5, 5, (8, 128)).astype(np.float32)
    (ji, jv), (ti, tv) = _both(x, c, 4, blk, dtype)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti[:, 1], ti[:, 0] + blk)
    np.testing.assert_array_equal(ti[:, 3], ti[:, 2] + blk)


def test_twin_distances_are_exact_squared_distances(rng):
    x = rng.integers(-20, 20, (16, 64)).astype(np.float32)
    c = rng.integers(-20, 20, (100, 64)).astype(np.float32)
    ct = torch.from_numpy(c)
    idx, vals = pk.pref_topk_block(torch.from_numpy(x), ct,
                                   pk.row_norms(ct), 8)
    d2 = ((x[:, None, :].astype(np.float64)
           - c[None, :, :].astype(np.float64)) ** 2).sum(-1)
    want = np.lexsort((np.broadcast_to(np.arange(100), d2.shape), d2),
                      axis=1)[:, :8]
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(
        vals.numpy(), np.take_along_axis(d2, want, 1).astype(np.float32))


def test_twin_row_blocks_do_not_change_the_result(rng, monkeypatch):
    x = torch.from_numpy(rng.normal(size=(300, 24)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(50, 24)).astype(np.float32))
    cn = pk.row_norms(c)
    one = pk.pref_topk_block_plain(x, c, cn, 8)
    monkeypatch.setattr(pk, "_TILE_BYTES", 4 * 50 * 7)  # 7-row blocks
    many = pk.pref_topk_block_plain(x, c, cn, 8)
    for a, b in zip(one, many):
        assert torch.equal(a, b)


def test_row_norms_are_blockwise_and_exact(monkeypatch):
    x = torch.arange(-60, 60, dtype=torch.float32).reshape(40, 3).to(
        torch.bfloat16)
    want = torch.sum(torch.square(x.float()), dim=1)
    monkeypatch.setattr(pk, "_NORM_BLOCK", 7)
    assert torch.equal(pk.row_norms(x), want)
    assert pk.row_norms(x[:0]).shape == (0,)
    x3 = x.reshape(10, 4, 3)  # along the last axis of any rank
    assert torch.equal(pk.row_norms(x3), want.reshape(10, 4))
    assert pk.row_norms(x3[:0]).shape == (0, 4)


def test_to_grid_rounds_half_to_even_and_clips():
    x = torch.tensor([-300.0, -2.5, -0.5, 0.5, 1.5, 2.5, 126.6, 1e9])
    assert pk.to_grid(x).tolist() == [-127, -2, 0, 0, 2, 2, 127, 127]
    assert pk.to_grid(x, 2.0).tolist() == [-127, -1, 0, 0, 1, 1, 63, 127]
    s = torch.tensor(0.5)
    assert torch.equal(pk.to_grid(x, s), pk.to_grid(x * 2.0))
    assert pk.to_grid(x).dtype == torch.int8


def test_int8_gram_is_exact_beyond_f32_integers(rng):
    """|g| above 2**24 (d = 4096 at the int8 extremes): the gram rounds the
    exact integer once, as JAX's int32 -> f32 does."""
    a = np.full((2, 4096), 127, np.int8)
    a[1, ::3] = -127
    b = rng.integers(-127, 128, (3, 4096)).astype(np.int8)
    want = (a.astype(np.int64) @ b.astype(np.int64).T)
    got = pk.gram(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(),
                                  want.astype(np.int32).astype(np.float32))
    assert got.dtype == torch.float32


def test_wrapper_counts_no_launch_on_cpu_and_checks(rng):
    x = torch.zeros((4, 8))
    c = torch.ones((10, 8))
    cn = pk.row_norms(c)
    before = launches["pref_topk_block"]
    idx, vals = pk.pref_topk_block(x, c, cn, 3)
    assert launches["pref_topk_block"] == before
    assert idx.tolist() == [[0, 1, 2]] * 4 and vals.shape == (4, 3)
    with pytest.raises(ValueError, match="kk"):
        pk.pref_topk_block(x, c, cn, 11)      # kk > k
    with pytest.raises(ValueError, match="kk"):      # kk > MAX_KK = 8
        pk.pref_topk_block(x, torch.ones((40, 8)),
                           pk.row_norms(torch.ones((40, 8))), 9)
    with pytest.raises(TypeError, match="cents"):
        pk.pref_topk_block(x, c.to(torch.bfloat16), cn, 3)
    with pytest.raises(TypeError, match="rows"):
        pk.pref_topk_block(x.double(), c.double(), cn, 3)
    with pytest.raises(TypeError, match="cnorms"):
        pk.pref_topk_block(x, c, cn[:5], 3)
    with pytest.raises(ValueError, match="share d"):
        pk.pref_topk_block(x, torch.ones((10, 9)), cn, 3)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        pk.pref_topk_block(x.to("meta"), c.to("meta"), cn.to("meta"), 3)


# -- the fused summarize ------------------------------------------------------

@pytest.mark.parametrize("dtype", list(_DT))
def test_summarize_fused_matches_jax_and_tile_path(rng, dtype):
    """assign / own_d / prefs of the port's fused summarize equal JAX's
    (interpret mode) and the port's tile path on integer-valued data, with
    d and k padded on the JAX side and a < 512-row tail
    (tests/test_pallas_kernels.py:391-414)."""
    jdt, tdt = _DT[dtype]
    n, d, k, kk = 600, 48, 19, 8
    base = rng.integers(-30, 30, (n, d)).astype(np.float32)
    x_np = base.astype(np.int8) if dtype == "int8" else base
    cents = rng.integers(-30, 30, (k, d)).astype(np.float32)
    ja, jo, jp = jsh._kmeans_summarize_fused(
        jnp.asarray(x_np).astype(jdt), jnp.asarray(cents), kk=kk,
        block_c=512, as_u16=True, interpret=True)
    xt = torch.from_numpy(x_np).to(tdt)
    ta, to, tp = tsh._kmeans_summarize_fused(xt, torch.from_numpy(cents), kk,
                                             as_u16=True)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert tp.dtype == torch.int16
    np.testing.assert_array_equal(tsh._to_host(tp), np.asarray(jp))
    blk = tsh._kmeans_block(n, k, tsh._KMEANS_BLOCK)
    a1, o1, p1 = tsh._kmeans_summarize(xt, torch.from_numpy(cents), kk, blk)
    np.testing.assert_array_equal(ta.numpy(), a1.numpy())
    np.testing.assert_array_equal(to.numpy(), o1.numpy())
    np.testing.assert_array_equal(tsh._to_host(tp), p1.numpy())


def test_kmeans_summarize_fused_flag(rng):
    """kmeans(summarize_fused=True) on the CPU runs the twin; prefs come
    back int32 when bucket ids do not fit 16 bits."""
    x = torch.from_numpy(rng.integers(-9, 9, (200, 6)).astype(np.float32))
    c1, a1, o1, p1 = tsh.kmeans(x, 12, iters=3)
    c2, a2, o2, p2 = tsh.kmeans(x, 12, iters=3, summarize_fused=True)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    np.testing.assert_array_equal(tsh._to_host(p2), p1.numpy())
    _, _, p3 = tsh._kmeans_summarize_fused(x, c1, 8, as_u16=False)
    assert p3.dtype == torch.int32


def test_summarize_fused_gate():
    assert not tsh._use_summarize_fused(torch.device("cpu"), 10**6)
    assert tsh._use_summarize_fused(torch.device("cuda"), 4096)
    assert not tsh._use_summarize_fused(torch.device("cuda"), 4095)
