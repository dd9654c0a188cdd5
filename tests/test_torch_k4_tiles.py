"""A numpy model of K4's walk and epilogue (``csrc/pref_topk_block.cu``),
held against the plain twin and the JAX package's Pallas K4.

The model runs the kernel's schedule on exact integer data, thread by thread
(vectorised over the threads of a row block):

* row blocks of 128 rows, centroid tiles of 128 in ascending order, the last
  one ragged, columns at or past k never offered;
* each thread's rows and columns: on the tensor-core paths wgmma's m64nN
  accumulator layout (thread t of a warpgroup owns rows 16 (t / 32) +
  (t % 32) / 4 and +8 and columns 8 i + 2 (t % 4) + {0, 1}; the 4 lanes of
  a quad share their rows), on the f32 path 4 rows x 16 columns (rows
  t / 8 + 32 h, columns t % 8 + 8 m; 8 lanes share their rows);
* the group's bound (the least last entry of its lanes' lists, or the
  largest of their first 8 / L entries if less), taken anew after each
  drain; the scan of a tile queues per row the scores below the bound and
  drains the queues after each 16 scores; a drained score below its
  list's last goes into the list by the kernel's shift insertion, which
  puts it after every entry of equal score;
* after the last tile, the lanes of a group merge their lists by the
  kernel's xor butterfly: the kk smallest of two sorted lists as a bitonic
  sequence, then a bitonic sort, all lexicographic by (score, index).

Integer-valued inputs make every f32 intermediate exact, so the model, the
twin and the Pallas kernel (interpret mode, d and k padded as
``tests/test_torch_pref_kernel.py`` pads them) must agree bit for bit. The
mutants are copies of the model with one rule broken; each must fail cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageclust_tpu.ops.pallas_kernels import pref_topk_block as jax_k4
from imageclust_tpu_torch.ops import pref_kernels as pk

torch.set_num_threads(2)

KMAX, ROWS, COLS, QUEUE, THREADS = 8, 128, 128, 16, 256
BIG = np.iinfo(np.int64).max

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16),
       "int8": (jnp.int8, torch.int8)}


def _layout(path):
    """(rows (T, R) in the block, steps [(column offset (T,), row h)],
    checkpoints after each step index, group size L) of a kernel path."""
    t = np.arange(THREADS)
    lane = t % 32
    if path == "tc":
        q = lane % 4
        rows = np.stack([16 * (t // 32) + lane // 4,
                         16 * (t // 32) + lane // 4 + 8], 1)
        steps, checks = [], set()
        for i in range(COLS // 8):
            for e in range(2):
                steps += [(8 * i + 2 * q + e, 0), (8 * i + 2 * q + e, 1)]
            if i % 4 == 3:
                checks.add(len(steps) - 1)
        return rows, steps, checks, 4
    cg = lane % 8
    rows = np.stack([t // 8 + 32 * h for h in range(4)], 1)
    steps, checks = [], set()
    for m in range(COLS // 8):
        steps += [(cg + 8 * m, h) for h in range(4)]
        if m % 4 == 3:
            checks.add(len(steps) - 1)
    return rows, steps, checks, 8


def _before(s, j, v, x, score_only=False):
    if score_only:
        return s < v
    return (s < v) | ((s == v) & (j < x))


class _Block:
    """The lists of one row block's threads."""

    def __init__(self, rows, mut):
        self.mut = mut
        self.R = rows.shape[1]
        self.v = np.full((THREADS, self.R, KMAX), np.inf, np.float32)
        self.x = np.full((THREADS, self.R, KMAX), BIG, np.int64)
        self.t = np.full((THREADS, self.R), np.inf, np.float32)

    def bound(self, L):
        if "bound_wide" in self.mut:
            L *= 2
        lo = self.v[:, :, KMAX - 1].reshape(THREADS // L, L, self.R).min(1)
        hi = self.v[:, :, KMAX // L - 1].reshape(THREADS // L, L,
                                                 self.R).max(1)
        self.t = np.repeat(np.minimum(lo, hi), L, 0)

    def wants(self, r, s):  # the scan's test: the bound, at most the last
        tb = self.t[:, r]
        return s <= tb if "bound_le" in self.mut else s < tb

    def offer(self, mask, r, s, j):
        last = self.v[:, r, KMAX - 1]
        w = mask & (s <= last if "reject_gt" in self.mut else s < last)
        v, x = self.v[:, r], self.x[:, r]
        c = (s[:, None] <= v) if "insert_le" in self.mut else (s[:, None] < v)
        nv, nx = v.copy(), x.copy()
        for i in range(KMAX - 1, 0, -1):
            nv[:, i] = np.where(c[:, i - 1], v[:, i - 1],
                                np.where(c[:, i], s, v[:, i]))
            nx[:, i] = np.where(c[:, i - 1], x[:, i - 1],
                                np.where(c[:, i], j, x[:, i]))
        nv[:, 0] = np.where(c[:, 0], s, v[:, 0])
        nx[:, 0] = np.where(c[:, 0], j, x[:, 0])
        self.v[:, r] = np.where(w[:, None], nv, v)
        self.x[:, r] = np.where(w[:, None], nx, x)

    def merge(self, m):
        p = np.arange(THREADS) ^ m
        so = "merge_score_only" in self.mut
        v, x = self.v.copy(), self.x.copy()
        ov, ox = self.v[p], self.x[p]
        for i in range(KMAX):
            take = _before(ov[:, :, KMAX - 1 - i], ox[:, :, KMAX - 1 - i],
                           v[:, :, i], x[:, :, i], so)
            v[:, :, i] = np.where(take, ov[:, :, KMAX - 1 - i], v[:, :, i])
            x[:, :, i] = np.where(take, ox[:, :, KMAX - 1 - i], x[:, :, i])
        dd = KMAX // 2
        while dd:
            for i in range(KMAX):
                if i & dd:
                    continue
                sw = _before(v[:, :, i + dd], x[:, :, i + dd], v[:, :, i],
                             x[:, :, i], so)
                a, b = v[:, :, i].copy(), x[:, :, i].copy()
                v[:, :, i] = np.where(sw, v[:, :, i + dd], a)
                x[:, :, i] = np.where(sw, x[:, :, i + dd], b)
                v[:, :, i + dd] = np.where(sw, a, v[:, :, i + dd])
                x[:, :, i + dd] = np.where(sw, b, x[:, :, i + dd])
            dd //= 2
        self.v, self.x = v, x


def model_topk(x, c, kk, path="tc", mut=()):
    """K4's outputs for integer-valued rows x (n, d) and centroids c (k, d)
    as the kernel's schedule forms them. Returns (idx (n, kk) int32, vals
    (n, kk) f32) and the number of scores queued."""
    n, k = x.shape[0], c.shape[0]
    rows, steps, checks, L = _layout(path)
    idx = np.zeros((n, kk), np.int32)
    vals = np.zeros((n, kk), np.float32)
    tiles = range(-(-k // COLS))
    queued = 0
    for b0 in range(0, n, ROWS):
        xb = np.zeros((ROWS, x.shape[1]), np.float32)  # rows past n read 0
        xb[:min(ROWS, n - b0)] = x[b0:b0 + ROWS]
        Sb = _scores(xb, c)
        blk = _Block(rows, mut)
        for ct in (reversed(tiles) if "tiles_desc" in mut else tiles):
            j0 = ct * COLS
            per = QUEUE // blk.R  # a row's slots
            qs = np.zeros((THREADS, blk.R, per), np.float32)
            qj = np.zeros((THREADS, blk.R, per), np.int64)
            nq = np.zeros((THREADS, blk.R), np.int64)
            for si, (coff, h) in enumerate(steps):
                col = j0 + coff
                ok = col < k
                s = np.where(ok, Sb[rows[:, h], np.minimum(col, k - 1)],
                             np.float32(0))
                p = ok & blk.wants(h, s)
                at = np.nonzero(p)[0]
                qs[at, h, nq[at, h]] = s[at]
                qj[at, h, nq[at, h]] = col[at]
                nq[:, h] += p
                queued += int(p.sum())
                if si in checks:  # drain each row's queue, then the bound
                    for r in range(blk.R):
                        for e in range(int(nq[:, r].max())):
                            blk.offer(e < nq[:, r], r, qs[:, r, e],
                                      qj[:, r, e])
                    nq[:] = 0
                    blk.bound(L)
        m = 1
        while m < L:
            blk.merge(m)
            m *= 2
        for h in range(blk.R):
            g = np.arange(THREADS) % L == h  # lane h of the group writes row h
            r = rows[g, h]
            keep = r < n - b0
            idx[b0 + r[keep]] = blk.x[g, h][keep, :kk]
            vals[b0 + r[keep]] = blk.v[g, h][keep, :kk]
    return idx, vals, queued


def _scores(x, c):
    """The Pallas body's f32 scores from exact integer inputs."""
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    xx = (x64 * x64).sum(1).astype(np.float32)
    cn = (c64 * c64).sum(1).astype(np.float32)
    g = (x64 @ c64.T).astype(np.float32)
    return np.maximum((xx[:, None] + cn[None, :]) - np.float32(2) * g,
                      np.float32(0))


def _data(seed, n, k, d, hi, dup):
    """Integer grids: few values (many ties); with ``dup`` the second half
    of the centroids repeats the first, across tile boundaries."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-hi, hi + 1, (n, d)).astype(np.float32)
    c = rng.integers(-hi, hi + 1, (k, d)).astype(np.float32)
    if dup:
        c[k - k // 2:] = c[:k // 2]
    return x, c


def _twin(x, c, kk, dtype):
    tdt = _DT[dtype][1]
    ct = torch.from_numpy(c).to(tdt)
    i, v = pk.pref_topk_block_plain(torch.from_numpy(x).to(tdt), ct,
                                    pk.row_norms(ct), kk)
    return i.numpy(), v.numpy()


def _pallas(x, c, kk, dtype, block_c=128):
    """The Pallas K4 in interpret mode on zero-padded copies (+inf norms on
    the padding centroids)."""
    jdt = _DT[dtype][0]
    n, d = x.shape
    k = c.shape[0]
    d_pad, k_pad = -(-d // 128) * 128, -(-k // block_c) * block_c
    xp = np.zeros((n, d_pad), np.float32)
    xp[:, :d] = x
    cp = np.zeros((k_pad, d_pad), np.float32)
    cp[:k, :d] = c
    cnp = np.full(k_pad, np.inf, np.float32)
    cnp[:k] = (c.astype(np.float64) ** 2).sum(1).astype(np.float32)
    ji, jv = jax_k4(jnp.asarray(xp).astype(jdt), jnp.asarray(cp).astype(jdt),
                    jnp.asarray(cnp), kk=kk, block_c=block_c, interpret=True,
                    with_dists=True)
    return np.asarray(ji), np.asarray(jv)


# (n, k, d, value range, duplicated centroids, kk): tie-heavy grids, k below
# one tile (5, 89), one full tile (128), a ragged last tile (389); n not a
# multiple of the row block
CASES = [(130, 5, 16, 1, False, 5), (61, 89, 12, 1, True, 8),
         (200, 128, 8, 2, True, 3), (257, 389, 6, 1, True, 8),
         (129, 389, 24, 3, False, 1), (1, 389, 10, 1, True, 7),
         (300, 389, 4, 1, True, 2), (140, 89, 33, 2, True, 6),
         (70, 128, 20, 1, False, 4)]


@pytest.mark.parametrize("path", ["tc", "f32"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "n{}-k{}-d{}".format(
    *c[:3]))
def test_model_matches_twin(path, case):
    n, k, d, hi, dup, kk = case
    x, c = _data(n + k + d, n, k, d, hi, dup)
    got_i, got_v, _ = model_topk(x, c, kk, path)
    want_i, want_v = _twin(x, c, kk, "float32")
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_v, want_v)


@pytest.mark.parametrize("dtype", list(_DT))
@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[7]],
                         ids=lambda c: "n{}-k{}-d{}".format(*c[:3]))
def test_model_matches_pallas_interpret(dtype, case):
    """The model on the tensor-core layout (bf16, int8) or the f32 one,
    against the Pallas K4 and the twin in the residency dtype."""
    n, k, d, hi, dup, kk = case
    x, c = _data(n + k + d + 1, n, k, d, hi, dup)
    path = "f32" if dtype == "float32" else "tc"
    got_i, got_v, _ = model_topk(x, c, kk, path)
    ji, jv = _pallas(x, c, kk, dtype)
    np.testing.assert_array_equal(got_i, ji)
    np.testing.assert_array_equal(got_v, jv)
    ti, tv = _twin(x, c, kk, dtype)
    np.testing.assert_array_equal(got_i, ti)
    np.testing.assert_array_equal(got_v, tv)


def test_model_int8_grid_extremes():
    """int8 values over the whole grid (exact in f32 at d = 64)."""
    rng = np.random.default_rng(9)
    x = rng.integers(-127, 128, (150, 64)).astype(np.float32)
    c = rng.integers(-127, 128, (389, 64)).astype(np.float32)
    c[200:300] = c[:100]
    got_i, got_v, _ = model_topk(x, c, 8, "tc")
    want_i, want_v = _twin(x, c, 8, "int8")
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_v, want_v)


def test_queue_shrinks_after_the_first_tiles():
    """Normal-like integer data: after a few tiles only a small share of the
    scores passes the bounds (printed: the share queued over the run)."""
    rng = np.random.default_rng(4)
    x = rng.integers(-40, 41, (128, 32)).astype(np.float32)
    c = rng.integers(-40, 41, (2048, 32)).astype(np.float32)
    _, _, queued = model_topk(x, c, 8, "tc")
    share = queued / (128 * 2048)
    print(f"K4 model: {queued} of {128 * 2048} scores queued ({share:.4f})")
    assert share < 0.1


MUTANTS = {
    # a newcomer inserted before equal scores: later indices win ties
    "insert_le": 1,
    # the bound taken over twice the lanes that share a row: other rows'
    # lists reject this row's candidates
    "bound_wide": 1,
    # tiles walked in descending order: the rejections drop lower indices
    # that tie
    "tiles_desc": 1,
    # the group merge by score only: ties go to the lane, not the index
    "merge_score_only": 1,
}


def _mutant_failures(mut):
    fails = 0
    for path in ("tc", "f32"):
        for n, k, d, hi, dup, kk in CASES:
            x, c = _data(n + k + d, n, k, d, hi, dup)
            gi, gv, _ = model_topk(x, c, kk, path, (mut,))
            wi, wv = _twin(x, c, kk, "float32")
            fails += not (np.array_equal(gi, wi) and np.array_equal(gv, wv))
    return fails


@pytest.mark.parametrize("mut", list(MUTANTS))
def test_mutants_fail(mut):
    fails = _mutant_failures(mut)
    print(f"K4 model mutant {mut}: {fails} of {2 * len(CASES)} cases fail")
    assert fails >= MUTANTS[mut]


@pytest.mark.parametrize("mut", ["reject_gt", "bound_le"])
def test_equal_scores_need_no_insertion_work(mut):
    """Letting scores equal to the list's last (reject_gt) or to the group's
    bound (bound_le) through changes nothing: an equal score comes with a
    larger index than every entry behind the last or the bound (the bound's
    entries are from earlier tiles), so it can never be kept. Rejecting
    them only skips the work."""
    assert _mutant_failures(mut) == 0


@pytest.mark.parametrize("dtype,d", [("bfloat16", 37), ("int8", 37),
                                     ("int8", 130), ("bfloat16", 64)])
def test_tma_centroids_padding(dtype, d):
    """The wrapper's centroid copy for TMA: rows padded with zeros to the
    kernel's 128-byte slab when d x elem is not a multiple of 16; padded
    and unpadded centroids give equal twin results and row norms."""
    tdt = _DT[dtype][1]
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.integers(-9, 10, (40, d)).astype(
        np.float32)).to(tdt)
    c = torch.from_numpy(rng.integers(-9, 10, (70, d)).astype(
        np.float32)).to(tdt)
    cp, ld = pk.tma_centroids(c)
    es = c.element_size()
    if (d * es) % 16 == 0:
        assert cp is c and ld == d
        return
    assert ld * es % 128 == 0 and ld >= d and tuple(cp.shape) == (70, ld)
    assert torch.equal(cp[:, :d], c) and not cp[:, d:].any()
    assert torch.equal(pk.row_norms(cp), pk.row_norms(c))
    xp = torch.zeros((40, ld), dtype=tdt)
    xp[:, :d] = x
    cn = pk.row_norms(c)
    for a, b in zip(pk.pref_topk_block_plain(x, c, cn, 8),
                    pk.pref_topk_block_plain(xp, cp, cn, 8)):
        assert torch.equal(a, b)


def test_tma_centroids_keeps_float32():
    c = torch.zeros((5, 3))
    cp, ld = pk.tma_centroids(c)
    assert cp is c and ld == 3
