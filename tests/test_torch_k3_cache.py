"""CPU rehearsal of K3's lockstep design (csrc/merge_update_argmin_batched.cu).

``_Model`` is a numpy model of the kernel's lockstep calls, written apart
from the plain twin: per bucket and per row a cache of the lexicographic
(d, max birth, min birth) minimum and its column; each call applies every
bucket's pending row/column update (frozen buckets too), decides which
buckets run (the main phase while found and num_active > target, the
absorb phase while found and an active slot is under min_size), fills a
running bucket's cache with one full scan at its first call of a phase,
and later rescans row sa, the rows whose cached column is sa and the rows
whose cached column is retired (sb), folds the one new candidate (column
sa, under the phase's absorb mask) into every other active row, reduces
the bucket's cache and does the lockstep body's bookkeeping. Driven with
the loop's own float work (``sharded._lockstep_float``) over whole chunks,
both rules and both phases, it must give ``lockstep_step_plain``'s state
bit for bit after every iteration; each iteration's (D, dmin, bhi, blo)
must equal the Pallas K3 in interpret mode on the same inputs, and a whole
chunk's (log, step, births, sizes, active) the JAX ``_bucket_chunk_fused``.
Mutants of the model must each fail some case. The CUDA kernel itself is
held against the twin on the card (tests/test_torch_cuda.py,
chip_smoke.py phases 6-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageclust_tpu.cluster.sharded as jsh
from imageclust_tpu.ops.pallas_kernels import (
    merge_update_argmin_batched as jax_batched,
)
from imageclust_tpu_torch.cluster import sharded as tsh
from imageclust_tpu_torch.ops import merge_kernels as mk

torch.set_num_threads(2)

_BIG = 2**31 - 1
# the model's deliberate faults; each must fail some case
_MUTANTS = ("no_sb_rescan", "no_phase_refill", "frozen_update_skipped",
            "fold_without_absorb_mask", "stale_sa_birth")


def _better(d, hi, lo, cur_d, cur_hi, cur_lo):
    """ic::take's test, elementwise: (d, hi, lo) < the current entry (a NaN
    never wins)."""
    return (d < cur_d) | ((d == cur_d) & ((hi < cur_hi)
                                          | ((hi == cur_hi) & (lo < cur_lo))))


class _Model:
    """K3's lockstep calls on numpy copies of a LockstepState's arrays."""

    def __init__(self, st: mk.LockstepState, mutant=None):
        self.mutant = mutant
        self.D = st.D.numpy().copy()
        self.births = st.births.numpy().astype(np.int64)
        self.sizes = st.sizes.numpy().astype(np.int64)
        self.active = st.active.numpy() > 0
        ctl = st.ctl.numpy().astype(np.int64)
        C, B = self.births.shape
        self.C, self.B = C, B
        self.sa = ctl[:, mk.LCTL_SA].copy()
        self.do = ctl[:, mk.LCTL_DO] != 0
        self.counter = ctl[:, mk.LCTL_COUNTER].copy()
        self.step_no = ctl[:, mk.LCTL_STEP].copy()
        self.num_active = ctl[:, mk.LCTL_NUM_ACTIVE].copy()
        self.target = ctl[:, mk.LCTL_TARGET].copy()
        self.found = ctl[:, mk.LCTL_FOUND] != 0
        self.filled = np.zeros(C, bool)
        self.log = np.zeros_like(st.log.numpy())
        self.j = np.arange(B)
        self.key_d = np.full((C, B), np.inf, np.float32)
        self.key_hi = np.full((C, B), _BIG, np.int64)
        self.key_lo = np.full((C, B), _BIG, np.int64)
        self.col = np.full((C, B), -1)
        self.old_birth = self.births[np.arange(C), self.sa].copy()
        self.iters = 0
        self.any_ran = False
        self.rescans = []  # rows rescanned by each cached running call

    def begin_phase(self):
        self.found[:] = True
        if self.mutant != "no_phase_refill":
            self.filled[:] = False
        self.iters = 0
        self.any_ran = False

    def _feasible(self, c, r, cols, max_size, amin):
        s = self.sizes[c]
        ok = s[r] + s[cols] <= max_size
        if amin > 0:
            ok &= (s[r] < amin) | (s[cols] < amin)
        return ok

    def _rescan(self, c, r, max_size, amin):
        cols = np.flatnonzero(self.active[c] & (self.j != r)
                              & ~np.isnan(self.D[c, r]))
        cols = cols[self._feasible(c, r, cols, max_size, amin)]
        if not len(cols):
            self.key_d[c, r], self.key_hi[c, r] = np.inf, _BIG
            self.key_lo[c, r], self.col[c, r] = _BIG, -1
            return
        b = self.births[c]
        hi = np.maximum(b[r], b[cols])
        lo = np.minimum(b[r], b[cols])
        k = np.lexsort((lo, hi, self.D[c, r, cols]))[0]
        self.key_d[c, r], self.key_hi[c, r] = self.D[c, r, cols[k]], hi[k]
        self.key_lo[c, r], self.col[c, r] = lo[k], cols[k]

    def _fold(self, c, sa, dvec, max_size, amin):
        """The cached call's update of bucket c after the merge into sa:
        rescans, then the one-column fold into every other active row."""
        act = self.active[c]
        col = self.col[c]
        gone = (col >= 0) & ~act[np.maximum(col, 0)]
        if self.mutant == "no_sb_rescan":
            gone[:] = False
        pointed = act & ((self.j == sa) | (col == sa) | gone)
        fold = act & ~pointed & ~np.isnan(dvec)
        fold &= self.sizes[c] + self.sizes[c, sa] <= max_size
        if amin > 0 and self.mutant != "fold_without_absorb_mask":
            fold &= (self.sizes[c] < amin) | (self.sizes[c, sa] < amin)
        b_sa = (self.old_birth[c] if self.mutant == "stale_sa_birth"
                else self.births[c, sa])
        c_hi = np.maximum(self.births[c], b_sa)
        c_lo = np.minimum(self.births[c], b_sa)
        take = fold & _better(dvec, c_hi, c_lo, self.key_d[c],
                              self.key_hi[c], self.key_lo[c])
        self.key_d[c, take], self.key_hi[c, take] = dvec[take], c_hi[take]
        self.key_lo[c, take], self.col[c, take] = c_lo[take], sa
        for r in np.flatnonzero(pointed):
            self._rescan(c, r, max_size, amin)
        self.rescans.append(int(pointed.sum()))

    def step(self, dvec, max_size, amin):
        """One call with the pending rows ``dvec`` (C, B); returns the
        per-bucket outputs (out_d, out_hi, out_lo, pair, pair_f, proceed)."""
        C = self.C
        if amin < 0:
            run = self.found & (self.num_active > self.target)
        else:
            run = self.found & (self.active & (self.sizes < amin)).any(1)
        out_d = np.full(C, np.inf, np.float32)
        out_hi = np.full(C, _BIG, np.int64)
        out_lo = np.full(C, _BIG, np.int64)
        pair = np.zeros((C, 2), np.int64)
        pair_f = np.zeros((C, 3), np.float32)
        proceed = np.zeros(C, bool)
        for c in range(C):
            sa = self.sa[c]
            if self.do[c] and (run[c]
                               or self.mutant != "frozen_update_skipped"):
                self.D[c, :, sa] = dvec[c]
                self.D[c, sa, :] = dvec[c]
            if not run[c]:
                continue
            act = self.active[c]
            if not self.filled[c]:
                for r in np.flatnonzero(act):
                    self._rescan(c, r, max_size, amin)
            elif self.do[c]:
                self._fold(c, sa, dvec[c], max_size, amin)
            self.filled[c] = True

            rows = np.flatnonzero(act & (self.col[c] >= 0))
            fin = False
            if len(rows):
                k = np.lexsort((self.key_lo[c, rows], self.key_hi[c, rows],
                                self.key_d[c, rows]))[0]
                r0 = rows[k]
                c0 = self.col[c, r0]
                out_d[c] = self.key_d[c, r0]
                out_hi[c], out_lo[c] = self.key_hi[c, r0], self.key_lo[c, r0]
                fin = bool(np.isfinite(out_d[c]))
            if fin:
                b = self.births[c]
                a, s = (r0, c0) if b[r0] > b[c0] else (c0, r0)
                s_a, s_b = self.sizes[c, a], self.sizes[c, s]
                self.sizes[c, a], self.sizes[c, s] = s_a + s_b, 0
                self.active[c, s] = False
                self.old_birth[c] = b[a]
                self.births[c, a] = self.counter[c]
                row = min(self.step_no[c], self.log.shape[1] - 1)
                self.log[c, row] = (out_hi[c], out_lo[c], self.counter[c])
                self.counter[c] += 1
                self.step_no[c] += 1
                self.num_active[c] -= 1
                self.sa[c] = a
                pair[c] = (a, s)
                pair_f[c] = (s_a, s_b, s_a + s_b)
            proceed[c] = fin
            self.found[c] = fin
            self.do[c] = fin
        self.any_ran = bool(run.any())
        self.iters += self.any_ran
        return out_d, out_hi, out_lo, pair, pair_f, proceed


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_matches(model, out, st):
    """The model after a call against the twin's LockstepState after its
    step."""
    out_d, out_hi, out_lo, pair, pair_f, proceed = out
    np.testing.assert_array_equal(_bits(model.D), _bits(st.D.numpy()))
    np.testing.assert_array_equal(model.births, st.births.numpy())
    np.testing.assert_array_equal(model.sizes, st.sizes.numpy())
    np.testing.assert_array_equal(model.active, st.active.numpy() > 0)
    np.testing.assert_array_equal(model.log, st.log.numpy())
    ctl = st.ctl.numpy()
    for field, want in ((mk.LCTL_SA, model.sa), (mk.LCTL_DO, model.do),
                        (mk.LCTL_COUNTER, model.counter),
                        (mk.LCTL_STEP, model.step_no),
                        (mk.LCTL_NUM_ACTIVE, model.num_active),
                        (mk.LCTL_TARGET, model.target),
                        (mk.LCTL_FOUND, model.found),
                        (mk.LCTL_FILLED, model.filled)):
        np.testing.assert_array_equal(ctl[:, field], want.astype(np.int64))
    np.testing.assert_array_equal(_bits(out_d), _bits(st.out_d.numpy()))
    np.testing.assert_array_equal(np.stack([out_hi, out_lo], 1),
                                  st.out_pair.numpy())
    np.testing.assert_array_equal(pair, st.pair.numpy())
    np.testing.assert_array_equal(_bits(pair_f), _bits(st.pair_f.numpy()))
    np.testing.assert_array_equal(proceed, st.proceed.numpy())
    flags = st.flags.numpy()
    assert (flags[mk.LFLAG_ANY_RAN], flags[mk.LFLAG_ITERS]) == (
        int(model.any_ran), model.iters)


def _chunk(data, B, counts, seed, d=8, early=False):
    """(features, bucket index, counts, targets) as numpy arrays; "grid_d2"
    gives heavy ties, "blobs" well-separated integer-grid groups of 4.
    ``early``: targets of half the counts, so the main phase stops early and
    the absorb phase has many under-min slots to merge."""
    rng = np.random.default_rng(seed)
    C = len(counts)
    if data == "normal":
        x = rng.normal(size=(C * B, d))
    elif data == "grid":
        x = rng.integers(-3, 4, (C * B, d))
    elif data == "grid_d2":
        x = rng.integers(-3, 4, (C * B, 2))
    else:  # "blobs"
        centers = rng.integers(-50, 51, (-(-C * B // 4), d)) * 8
        x = (np.repeat(centers, 4, axis=0)[:C * B]
             + rng.integers(-1, 2, (C * B, d)))
    counts = np.asarray(counts, np.int32)
    targets = np.array([tsh._bucket_target(int(c), 3, 6) if c else 0
                        for c in counts], np.int32)
    if early:
        targets = np.maximum(targets, counts // 2)
    bidx = np.arange(C * B, dtype=np.int32).reshape(C, B)
    return x.astype(np.float32), bidx, counts, targets


def _pallas_step(st, max_size, amin):
    """The Pallas K3 in interpret mode on the state before a step: (D,
    dmin, bhi, blo). Copies: jnp.asarray may alias a numpy buffer that the
    twin step then updates in place."""
    ctl = st.ctl.numpy()
    out = jax_batched(
        jnp.asarray(st.D.numpy().copy()), jnp.asarray(st.dvec.numpy().copy()),
        jnp.asarray(ctl[:, mk.LCTL_SA].copy()),
        jnp.asarray(ctl[:, mk.LCTL_DO].copy()),
        jnp.asarray(st.births.numpy().copy()),
        jnp.asarray(st.sizes.numpy().copy()),
        jnp.asarray(st.active.numpy() > 0), jnp.int32(max_size),
        jnp.int32(amin), interpret=True)
    return [np.asarray(o) for o in out]


def _random_float(st, rng):
    """Float work that writes rows of eighths in [0, 5) (0 at sa) where a
    bucket merged: unlike a Ward rule's rows, which are never below the
    merged slots' old minima, these often win a fold and tie with cached
    keys."""
    dv = (rng.integers(0, 40, (st.C, st.B)) / 8).astype(np.float32)
    dv[np.arange(st.C), st.pair[:, 0].numpy()] = 0.0
    st.dvec.copy_(torch.where(st.proceed[:, None], torch.from_numpy(dv),
                              st.dvec))


def _run(chunk, rule, mutant=None, max_size=6, min_size=3, absorb=True,
         pallas=False):
    """The twin loop and the model in lockstep over a whole chunk, both
    phases, in the loop's own blocks of iterations (``sharded._run_eager``:
    the first iteration alone, then blocks of FOUND_READ_EVERY until one
    ends with no bucket running). ``rule`` "random" is
    :func:`_random_float`. Returns the model and the twin's state."""
    st, cents = tsh._lockstep_state(*(torch.from_numpy(a) for a in chunk))
    rng = np.random.default_rng(len(chunk[0]))
    model = _Model(st, mutant)
    go = st.flags[mk.LFLAG_ANY_RAN:mk.LFLAG_ANY_RAN + 1]
    block = None
    for amin in ((-1, min_size) if absorb else (-1,)):
        st.begin_phase(amin)
        model.begin_phase()

        def body():
            dvec = st.dvec.numpy().copy()
            want = _pallas_step(st, max_size, amin) if pallas else None
            mk.lockstep_step_plain(st, max_size)
            out = model.step(dvec, max_size, amin)
            _assert_matches(model, out, st)
            if pallas:
                np.testing.assert_array_equal(_bits(want[0]), _bits(model.D))
                ran = np.flatnonzero(out[0] != np.inf)
                for w, g in zip(want[1:], out[:3]):
                    np.testing.assert_array_equal(_bits(w[ran]), _bits(g[ran]))
            if rule == "random":
                _random_float(st, rng)
            else:
                tsh._lockstep_float(st, cents, rule)

        block = tsh._run_eager(body, go, st.B + 1, block)
    return model, st


# (B, counts): a full bucket, mid and small ones, an empty bucket, and a
# bucket of one item (every pair infeasible)
_SHAPES = [(128, (128, 96, 37, 5, 0, 1)), (256, (256, 190, 37, 0)),
           (200, (200, 150, 7, 1))]


@pytest.mark.parametrize("B,counts", _SHAPES)
@pytest.mark.parametrize("data", ["normal", "grid", "grid_d2"])
@pytest.mark.parametrize("rule", ["centroid", "lance_williams", "random"])
def test_model_matches_twin_steps(B, counts, data, rule):
    """Whole chunks, both phases: the model's state equals the twin's after
    every iteration, every bucket with pairs merges, and the cached calls
    rescan at least row sa. "random" rows exercise the fold, which Ward's
    rules rarely do (a merged slot's new distances are never below the
    old ones, so they seldom beat a row's cached minimum)."""
    model, _ = _run(_chunk(data, B, counts, B + len(data)), rule)
    _assert_merged(model, counts)


@pytest.mark.parametrize("data", ["normal", "grid_d2"])
@pytest.mark.parametrize("rule", ["centroid", "lance_williams", "random"])
def test_model_matches_twin_steps_long_absorb(data, rule):
    """Targets of half the counts: the main phase stops early, and the
    absorb phase merges many under-min slots under its mask from a cache
    refilled at its first call."""
    counts = (128, 90, 37, 5)
    model, _ = _run(_chunk(data, 128, counts, 3, early=True), rule)
    _assert_merged(model, counts)


def _assert_merged(model, counts):
    counts = np.asarray(counts)
    assert (model.step_no[counts > 1] > 0).all()
    assert (model.step_no[counts <= 1] == 0).all()
    assert min(model.rescans) >= 1


@pytest.mark.parametrize("data", ["normal", "grid_d2"])
@pytest.mark.parametrize("rule", ["centroid", "lance_williams"])
def test_model_matches_pallas_interpret(data, rule):
    """Every iteration's (D, dmin, bhi, blo) against the Pallas K3 in
    interpret mode on the same inputs (dmin, bhi, blo for the buckets that
    ran; the Pallas kernel reduces every bucket)."""
    _run(_chunk(data, 128, (60, 23, 1), 5), rule, pallas=True)


@pytest.mark.parametrize("rule,data", [("lance_williams", "grid"),
                                       ("lance_williams", "normal"),
                                       ("centroid", "blobs")])
def test_model_matches_jax_lockstep_chunk(rule, data):
    """A whole chunk's (log, step, births, sizes, active) against the JAX
    ``_bucket_chunk_fused`` (its Pallas K3 in interpret mode). The
    centroid rule on well-separated integer-grid blobs: XLA's CPU row sum
    uses fused multiply-adds where torch rounds each product
    (tests/test_torch_bucket_kernels.py says more)."""
    chunk = _chunk(data, 128, (128, 37, 5, 0), 9)
    model, _ = _run(chunk, rule)
    want = jsh._bucket_chunk_fused(
        *(jnp.asarray(a) for a in chunk), 6, 3, update_rule=rule,
        absorb=True, interpret=True)
    got = (model.log, model.step_no, model.births, model.sizes, model.active)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("mutant", _MUTANTS)
def test_mutants_fail_some_case(mutant):
    """Each fault of the model is caught by the twin comparison on some of
    these chunks (tied grids make the tie key and the rescans matter; the
    absorb phase makes its mask and the refill matter)."""
    cases = [(data, rule, B, counts, early)
             for data in ("grid_d2", "normal")
             for rule in ("centroid", "lance_williams", "random")
             for B, counts, early in ((128, (128, 37, 5, 20), False),
                                      (200, (200, 7, 1), False),
                                      (128, (128, 90, 37), True))]
    failed = 0
    for i, (data, rule, B, counts, early) in enumerate(cases):
        try:
            _run(_chunk(data, B, counts, 40 + i, early=early), rule,
                 mutant=mutant)
        except AssertionError:
            failed += 1
    print(f"K3 cache model mutant {mutant}: fails {failed} of "
          f"{len(cases)} cases")
    assert failed >= 1


def test_absorb_mask_blocks_cached_pairs():
    """Max size 2 and min size 2 on a line: the main phase pairs what it
    can, the absorb phase must refill under its mask (only pairs with an
    under-min side) rather than trust the main phase's cache."""
    x = np.array([0.0, 1.0, 1.1, 1.3, 9.0, 10.0, 20.0], np.float32)[:, None]
    B = 128
    feats = np.zeros((B, 1), np.float32)
    feats[:len(x)] = x
    chunk = (feats, np.arange(B, dtype=np.int32)[None],
             np.array([len(x)], np.int32), np.array([1], np.int32))
    model, _ = _run(chunk, "lance_williams", max_size=2, min_size=2)
    assert model.step_no[0] == 3  # 20 stays alone: no room anywhere


@pytest.mark.parametrize("data", ["normal", "grid_d2"])
def test_rescans_per_call(data):
    """A 2 x 512 chunk of 450 items a bucket: the rows a cached call
    rescans per bucket (row sa included), few on normal data, more under
    ties (PERF.md records the card's counts at C = 261, B = 512)."""
    model, _ = _run(_chunk(data, 512, (450, 450), 11, d=16), "centroid")
    mean = float(np.mean(model.rescans))
    print(f"K3 cache model ({data}, B=512): {len(model.rescans)} cached "
          f"calls, {mean:.3f} rows rescanned per bucket a call, row sa "
          f"included (max {max(model.rescans)})")
    assert min(model.rescans) >= 1
    if data == "normal":
        assert mean <= 8.0
