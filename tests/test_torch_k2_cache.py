"""CPU rehearsal of K2's cached-minima design (csrc/merge_loop_whole.cu).

``_model_loop`` is a numpy model of the kernel's trip logic, written apart
from the plain twin: a per-row cache of the lexicographic (d, max birth,
min birth) minimum and its column, one full scan at the start of each
phase, the block minimum over the cache, row sa rescanned from dvec, row sb
cleared, the rows whose cached column was sa or sb rescanned from D, and
one new candidate (column sa) folded into every other row. Like the
kernel, it writes column sa only in the rows active before the merge and
fills the rows inactive at the end from the transpose. It must give the
twin's (``merge_loop_whole_plain``) log, step, births, sizes, active and
final D bit for bit, and the Pallas kernel's in interpret mode. The
CUDA kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageclust_tpu.ops.pallas_kernels import (
    merge_loop_whole as jax_merge_loop_whole,
)
from imageclust_tpu_torch.cluster import sharded as tsh
from imageclust_tpu_torch.ops import bucket_kernels as bk

torch.set_num_threads(2)

_BIG = 2**31 - 1
_F32 = np.float32


def _better(d, hi, lo, cur_d, cur_hi, cur_lo):
    """ic::take's test, elementwise: (d, hi, lo) < the current entry (a NaN
    never wins)."""
    return (d < cur_d) | ((d == cur_d) & ((hi < cur_hi)
                                          | ((hi == cur_hi) & (lo < cur_lo))))


def _model_bucket(D, cnt, tgt, max_size, absorb_min):
    """One bucket's main and absorb phases on the cache; D (B, B) float32 is
    updated in place. Returns (log, step, births, sizes, active, rescans):
    rescans holds, per trip, the rows other than sa whose cached column was
    sa or sb."""
    B = D.shape[0]
    j = np.arange(B)
    births = np.where(j < cnt, j, _BIG - B + j).astype(np.int64)
    sizes = (j < cnt).astype(np.int64)
    active = j < cnt
    log = np.zeros((max(B - 1, 1), 3), np.int64)
    best_d = np.full(B, np.inf, _F32)
    best_col = np.full(B, -1)
    t_sa = np.full(B, -1)  # the last trip that merged into the slot
    t_out = np.where(active, _BIG, -1)  # the trip that retired it
    st = {"counter": int(cnt), "num_active": int(cnt), "step": 0,
          "found": True}
    rescans = []

    def rescan(r, vals, amin):
        ok = active & (j != r) & (sizes[r] + sizes <= max_size)
        if amin > 0:
            ok &= (sizes[r] < amin) | (sizes < amin)
        cols = np.flatnonzero(ok & ~np.isnan(vals))
        if not len(cols):
            best_d[r], best_col[r] = np.inf, -1
            return
        hi = np.maximum(births[r], births[cols])
        lo = np.minimum(births[r], births[cols])
        k = np.lexsort((lo, hi, vals[cols]))[0]
        best_d[r], best_col[r] = vals[cols[k]], cols[k]

    def full_scan(amin):
        best_d[:] = np.inf
        best_col[:] = -1
        for r in np.flatnonzero(active):
            rescan(r, D[r], amin)

    def keys(rows):
        cols = np.maximum(best_col[rows], 0)
        has = best_col[rows] >= 0
        hi = np.where(has, np.maximum(births[rows], births[cols]), _BIG)
        lo = np.where(has, np.minimum(births[rows], births[cols]), _BIG)
        return best_d[rows], hi, lo

    def merge_once(amin):
        rows = np.flatnonzero(best_col >= 0)
        if not len(rows):
            st["found"] = False
            return
        d, hi, lo = keys(rows)
        k = np.lexsort((lo, hi, d))[0]
        st["found"] = bool(np.isfinite(d[k]))
        if not st["found"]:
            return
        r, c = rows[k], best_col[rows[k]]
        sa, sb = (r, c) if births[r] > births[c] else (c, r)
        s_a, s_b = sizes[sa], sizes[sb]
        sz = sizes.astype(_F32)
        dv = (((_F32(s_a) + sz) * D[sa] + (_F32(s_b) + sz) * D[sb])
              - sz * D[sa, sb]) / (_F32(s_a + s_b) + sz)
        dv[sa] = 0.0
        D[active, sa] = dv[active]  # column (rows active before), then row
        D[sa, :] = dv
        t_sa[sa] = t_out[sb] = st["step"]
        nb = st["counter"]
        log[st["step"]] = (births[sa], births[sb], nb)
        sizes[sa], sizes[sb] = s_a + s_b, 0
        births[sa] = nb
        active[sb] = False
        st["counter"] += 1
        st["num_active"] -= 1
        st["step"] += 1

        best_d[sb], best_col[sb] = np.inf, -1
        others = active & (j != sa)
        pointed = others & np.isin(best_col, (sa, sb))
        fold = np.flatnonzero(others & ~pointed)
        ok = sizes[fold] + sizes[sa] <= max_size
        if amin > 0:
            ok &= (sizes[fold] < amin) | (sizes[sa] < amin)
        fold = fold[ok]
        c_hi = np.maximum(births[fold], nb)
        c_lo = np.minimum(births[fold], nb)
        take = _better(dv[fold], c_hi, c_lo, *keys(fold))
        best_d[fold[take]] = dv[fold[take]]
        best_col[fold[take]] = sa
        rescan(sa, dv, amin)
        for r in np.flatnonzero(pointed):
            rescan(r, D[r], amin)
        rescans.append(int(pointed.sum()))

    for trip in range(B - 1):
        if not (st["found"] and st["num_active"] > tgt):
            break
        if trip == 0:
            full_scan(0)
        merge_once(0)
    if absorb_min > 0:
        st["found"] = True
        for trip in range(B - 1):
            if not (st["found"] and (active & (sizes < absorb_min)).any()):
                break
            if trip == 0:
                full_scan(absorb_min)
            merge_once(absorb_min)
    # fill_inactive_rows: D[j][c] = D[c][j] where column c was written after
    # row j retired
    fix = t_sa[None, :] > np.where(active, _BIG, t_out)[:, None]
    D[fix] = D.T[fix]
    return log, st["step"], births, sizes, active, rescans


def _model_loop(D, counts, targets, max_size, absorb_min):
    """Every bucket of a chunk through the model; D (C, B, B) float32 is
    updated in place. Returns the twin's five outputs as numpy arrays and
    the per-trip rescan counts of all buckets."""
    outs, rescans = [], []
    for c in range(D.shape[0]):
        *out, res = _model_bucket(D[c], int(counts[c]), int(targets[c]),
                                  max_size, absorb_min)
        outs.append(out)
        rescans += res
    log, step, births, sizes, active = (np.stack([o[i] for o in outs])
                                        for i in range(5))
    return (log.astype(np.int32), step.astype(np.int32),
            births.astype(np.int32), sizes.astype(np.int32), active), rescans


def _inputs(rng, data, B, counts, d=16):
    C = len(counts)
    if data == "grid":  # d = 2 integer grid: many exact ties
        x = rng.integers(-3, 4, (C, B, 2))
    else:
        x = rng.normal(size=(C, B, d))
    D = tsh.pairwise_ward_singleton(torch.from_numpy(x.astype(np.float32)))
    counts = np.asarray(counts, np.int32)
    targets = np.array([tsh._bucket_target(int(c), 3, 6) if c else 0
                        for c in counts], np.int32)
    return D.numpy(), counts, targets


def _twin(D, counts, targets, max_size, absorb_min):
    Dt = torch.from_numpy(D.copy())
    out = bk.merge_loop_whole_plain(Dt, torch.from_numpy(counts),
                                    torch.from_numpy(targets), max_size,
                                    absorb_min)
    return [o.numpy() for o in out], Dt.numpy()


def _assert_bits(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("B", [2, 3, 50, 128])
@pytest.mark.parametrize("data", ["normal", "grid"])
@pytest.mark.parametrize("absorb_min", [0, 3])
def test_model_matches_twin(rng, B, data, absorb_min):
    """Counts 0, 1, 2 and B in one chunk; D's final bits too."""
    D, counts, targets = _inputs(rng, data, B, [0, 1, 2, B])
    Dm = D.copy()
    got, rescans = _model_loop(Dm, counts, targets, 6, absorb_min)
    want, Dw = _twin(D, counts, targets, 6, absorb_min)
    _assert_bits(got, want)
    _assert_bits([Dm], [Dw])
    assert int(got[1][3]) > 0 and len(rescans) == int(got[1].sum())


@pytest.mark.parametrize("data", ["normal", "grid"])
@pytest.mark.parametrize("absorb_min", [0, 3])
def test_model_matches_pallas_interpret(rng, data, absorb_min):
    D, counts, targets = _inputs(rng, data, 128, [128, 37, 5, 0])
    got, _ = _model_loop(D.copy(), counts, targets, 6, absorb_min)
    want = jax_merge_loop_whole(jnp.asarray(D), jnp.asarray(counts),
                                jnp.asarray(targets), jnp.int32(6),
                                jnp.int32(absorb_min), interpret=True)
    _assert_bits(got, [np.asarray(w) for w in want])


def test_ties_point_many_rows_at_one_slot(rng):
    """On the d = 2 grid many rows share a cached column: the trips that
    rescan several rows are the case the cache must get right."""
    D, counts, targets = _inputs(rng, "grid", 128, [128, 128])
    got, rescans = _model_loop(D.copy(), counts, targets, 6, 3)
    _assert_bits(got, _twin(D, counts, targets, 6, 3)[0])
    assert max(rescans) >= 4


@pytest.mark.parametrize("absorb_min", [0, 3])
def test_max_size_blocks_the_best_pair(absorb_min):
    """Points 0, 1, 1.1, 1.3, 9, 10 on a line with max_size 2: after
    (1, 1.1) merges, the closest pairs left ({1, 1.1} with 1.3 or 0) are
    blocked, and rows 0 and 3, whose cached column was the merged slot,
    must find their next feasible column."""
    x = np.array([0.0, 1.0, 1.1, 1.3, 9.0, 10.0], np.float32)[None, :, None]
    D = tsh.pairwise_ward_singleton(torch.from_numpy(x)).numpy()
    counts = np.array([6], np.int32)
    targets = np.array([3], np.int32)
    got, rescans = _model_loop(D.copy(), counts, targets, 2, absorb_min)
    want, _ = _twin(D, counts, targets, 2, absorb_min)
    _assert_bits(got, want)
    # log rows (bhi, blo, new birth): (1, 1.1) -> 6 fills its slot, then
    # (9, 10) -> 7 and (0, 1.3) -> 8
    np.testing.assert_array_equal(got[0][0, :3], [[2, 1, 6], [5, 4, 7],
                                                  [3, 0, 8]])
    assert rescans[0] == 2


def test_rescans_per_trip_small_on_normal_data(rng):
    """Four 384-item buckets of B = 512 on normal d = 64 data, the engine's
    absorb: the model equals the twin, and the rows rescanned besides row
    sa stay few per trip (the count behind the kernel's traffic estimate;
    PERF.md records it)."""
    D, counts, targets = _inputs(rng, "normal", 512, [384] * 4, d=64)
    Dm = D.copy()
    got, rescans = _model_loop(Dm, counts, targets, 6, 3)
    want, Dw = _twin(D, counts, targets, 6, 3)
    _assert_bits(got, want)
    _assert_bits([Dm], [Dw])
    mean = float(np.mean(rescans))
    print(f"K2 cache model: {len(rescans)} trips, {mean:.3f} rows "
          f"rescanned per trip besides row sa (max {max(rescans)})")
    assert mean <= 8.0
