"""CPU rehearsal of K1's loop design (csrc/merge_update_argmin.cu).

``_Model`` is a numpy model of the kernel's loop calls, written apart from
the plain twin: a per-row cache of the lexicographic (d, max birth, min
birth) minimum and its column, one full scan at the loop's first call, then
per call the pending row/column update, row sa and the rows whose cached
column is sa or an inactive slot rescanned in full, one new candidate
(column sa) folded into every other active row, the minimum over the
cache, and the last block's integer bookkeeping gated on ``found`` and the
step limit. Driven with the loop's own float work, it must give the twin
step's (``merge_step_plain``, on ``merge_update_argmin_plain``) state bit
for bit after every step of whole runs, and each step's (D, dmin, bhi, blo)
must equal the Pallas kernel's in interpret mode on the same inputs. The
CUDA kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 2-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageclust_tpu.cluster.ward as jw
import imageclust_tpu_torch.cluster.ward as tw
from imageclust_tpu.ops.pallas_kernels import (
    merge_update_argmin as jax_merge_update_argmin,
)
from imageclust_tpu_torch.ops import merge_kernels as mk

torch.set_num_threads(2)

_BIG = 2**31 - 1


def _better(d, hi, lo, cur_d, cur_hi, cur_lo):
    """ic::take's test, elementwise: (d, hi, lo) < the current entry (a NaN
    never wins)."""
    return (d < cur_d) | ((d == cur_d) & ((hi < cur_hi)
                                          | ((hi == cur_hi) & (lo < cur_lo))))


class _Model:
    """K1's loop calls on numpy copies of a MergeState's arrays."""

    def __init__(self, st: mk.MergeState):
        self.D = st.D.numpy().copy()
        self.births = st.births.numpy().astype(np.int64)
        self.sizes = st.sizes.numpy().astype(np.int64)
        self.active = st.active.numpy() > 0
        self.max_size = st.max_size
        ctl = st.ctl.numpy()
        self.counter = int(ctl[mk.CTL_COUNTER])
        self.limit = int(ctl[mk.CTL_LIMIT])
        self.step_no = 0
        self.sa, self.do, self.filled = 0, False, False
        self.log = np.zeros_like(st.log.numpy())
        n = self.D.shape[0]
        self.j = np.arange(n)
        self.key_d = np.full(n, np.inf, np.float32)
        self.key_hi = np.full(n, _BIG, np.int64)
        self.key_lo = np.full(n, _BIG, np.int64)
        self.col = np.full(n, -1)
        self.rescans = []  # rows rescanned by each cached call that merged

    def _rescan(self, r):
        ok = (self.active & (self.j != r)
              & (self.sizes[r] + self.sizes <= self.max_size)
              & ~np.isnan(self.D[r]))
        cols = np.flatnonzero(ok)
        if not len(cols):
            self.key_d[r], self.key_hi[r], self.key_lo[r] = np.inf, _BIG, _BIG
            self.col[r] = -1
            return
        hi = np.maximum(self.births[r], self.births[cols])
        lo = np.minimum(self.births[r], self.births[cols])
        k = np.lexsort((lo, hi, self.D[r, cols]))[0]
        self.key_d[r], self.key_hi[r], self.key_lo[r] = (
            self.D[r, cols[k]], hi[k], lo[k])
        self.col[r] = cols[k]

    def step(self, dvec):
        """One call with the pending row ``dvec``; returns (dmin, bhi, blo,
        found, sa, sb, s_a, s_b)."""
        sa = self.sa
        if self.do:
            self.D[:, sa] = dvec
            self.D[sa, :] = dvec
        act = self.active
        if not self.filled:
            for r in np.flatnonzero(act):
                self._rescan(r)
        elif self.do:
            col = self.col
            gone = (col >= 0) & ~self.active[np.maximum(col, 0)]
            pointed = act & ((self.j == sa) | (col == sa) | gone)
            fold = act & ~pointed
            fold &= self.sizes + self.sizes[sa] <= self.max_size
            fold &= ~np.isnan(dvec)
            c_hi = np.maximum(self.births, self.births[sa])
            c_lo = np.minimum(self.births, self.births[sa])
            take = fold & _better(dvec, c_hi, c_lo, self.key_d, self.key_hi,
                                  self.key_lo)
            self.key_d[take], self.key_hi[take] = dvec[take], c_hi[take]
            self.key_lo[take], self.col[take] = c_lo[take], sa
            for r in np.flatnonzero(pointed):
                self._rescan(r)
            self.rescans.append(int(pointed.sum()))
        self.filled = True

        rows = np.flatnonzero(act & (self.col >= 0))
        dmin, hi, lo, found = np.float32(np.inf), _BIG, _BIG, False
        sa = sb = s_a = s_b = 0
        if len(rows):
            k = np.lexsort((self.key_lo[rows], self.key_hi[rows],
                            self.key_d[rows]))[0]
            r0 = rows[k]
            c0 = self.col[r0]
            dmin, hi, lo = self.key_d[r0], self.key_hi[r0], self.key_lo[r0]
            found = bool(np.isfinite(dmin)) and self.step_no < self.limit
            if found:
                sa, sb = ((r0, c0) if self.births[r0] > self.births[c0]
                          else (c0, r0))
                s_a, s_b = self.sizes[sa], self.sizes[sb]
                self.sizes[sa], self.sizes[sb] = s_a + s_b, 0
                self.active[sb] = False
                self.births[sa] = self.counter
                self.log[self.step_no] = (hi, lo, self.counter)
                self.counter += 1
                self.step_no += 1
        self.sa, self.do = sa, found
        return dmin, hi, lo, found, sa, sb, s_a, s_b


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_matches(model, out, st):
    """The model after a call against the twin's MergeState after its
    step."""
    dmin, hi, lo, found, sa, sb, s_a, s_b = out
    np.testing.assert_array_equal(_bits(model.D), _bits(st.D.numpy()))
    np.testing.assert_array_equal(model.births, st.births.numpy())
    np.testing.assert_array_equal(model.sizes, st.sizes.numpy())
    np.testing.assert_array_equal(model.active, st.active.numpy() > 0)
    np.testing.assert_array_equal(model.log, st.log.numpy())
    ctl = st.ctl.numpy()
    assert [ctl[mk.CTL_SA], ctl[mk.CTL_DO], ctl[mk.CTL_COUNTER],
            ctl[mk.CTL_STEP]] == [model.sa, int(model.do), model.counter,
                                  model.step_no]
    assert _bits(np.float32(dmin)) == _bits(st.out_d.numpy())[0]
    assert [hi, lo] == st.out_pair.tolist()
    assert bool(st.found) == found
    assert st.pair.tolist() == [sa, sb]
    np.testing.assert_array_equal(
        st.pair_f.numpy(), np.float32([s_a, s_b, s_a + s_b]))


def _features(data, n, seed):
    rng = np.random.default_rng(seed)
    if data == "normal":
        return rng.normal(size=(n, 16)).astype(np.float32)
    if data == "grid":
        return rng.integers(-3, 4, (n, 8)).astype(np.float32)
    return rng.integers(-3, 4, (n, 2)).astype(np.float32)  # "grid_d2"


def _run(x, rule, max_size=6, min_size=3, birth_offset=0, pallas=False,
         extra_steps=3):
    """The twin loop and the model in lockstep over a whole run (and
    ``extra_steps`` gated no-op calls past its end). Returns the model and
    the twin's state."""
    n = len(x)
    xp = torch.zeros((tw._pad_len(n), x.shape[1]))
    xp[:n] = torch.from_numpy(x)
    limit = n - tw.calculate_optimal_clusters(n, min_size, max_size)
    st, cents = tw._loop_state(xp, n, limit, max_size)
    if birth_offset:  # every stamp past the offset, as a long job's are
        st.births[:n] += birth_offset
        st.ctl[mk.CTL_COUNTER] += birth_offset
    model = _Model(st)
    for _ in range(limit + extra_steps):
        dvec = st.dvec.numpy().copy()
        if pallas:
            # copies: jnp.asarray may alias a numpy buffer that the twin
            # step then updates in place
            ctl = st.ctl.numpy()
            want = [np.asarray(w) for w in jax_merge_update_argmin(
                *(jnp.asarray(t.numpy().copy()) for t in (st.D, st.dvec)),
                jnp.int32(ctl[mk.CTL_SA]), jnp.int32(ctl[mk.CTL_DO]),
                *(jnp.asarray(t.numpy().copy())
                  for t in (st.births, st.sizes, st.active)),
                jnp.int32(max_size), interpret=True)]
        mk.merge_step_plain(st)
        out = model.step(dvec)
        _assert_matches(model, out, st)
        if pallas:
            np.testing.assert_array_equal(_bits(want[0]), _bits(model.D))
            assert (_bits(np.float32(want[1])), int(want[2]),
                    int(want[3])) == (_bits(np.float32(out[0])), out[1],
                                      out[2])
        tw._float_step(st, cents, rule)
    assert model.step_no > 0 and not out[3]
    return model, st


@pytest.mark.parametrize("n", [100, 128, 200, 256])
@pytest.mark.parametrize("data", ["normal", "grid", "grid_d2"])
@pytest.mark.parametrize("rule", ["centroid", "lance_williams"])
def test_model_matches_twin_steps(n, data, rule):
    """Whole runs at n_pad 128 and 256: the model's state equals the twin's
    after every step, and the run merges down to the target."""
    x = _features(data, n, n)
    model, st = _run(x, rule)
    assert model.step_no == n - tw.calculate_optimal_clusters(n, 3, 6)


@pytest.mark.parametrize("data", ["normal", "grid", "grid_d2"])
@pytest.mark.parametrize("rule", ["centroid", "lance_williams"])
def test_model_matches_pallas_interpret(data, rule):
    """Every step's (D, dmin, bhi, blo) against the Pallas kernel in
    interpret mode on the same inputs."""
    _run(_features(data, 120, 7), rule, pallas=True)


@pytest.mark.parametrize("offset", [9000, 70000])
@pytest.mark.parametrize("rule", ["centroid", "lance_williams"])
def test_births_past_13_and_16_bits(offset, rule):
    """Births past 2^13 (K2's packed width) and 2^16: the kernel keeps 32
    bits of each, and so must the order of ties on the d = 2 grid."""
    model, _ = _run(_features("grid_d2", 200, 3), rule, birth_offset=offset)
    assert model.log[0, 0] >= offset and model.counter > offset


@pytest.mark.parametrize("rule", ["centroid", "lance_williams"])
def test_max_size_blocks_the_best_pair(rule):
    """Points 0, 1, 1.1, 1.3, 9, 10 on a line with max_size 2: after
    (1, 1.1) merges, the closest pairs left ({1, 1.1} with 1.3 or 0) are
    blocked, and rows 0 and 3, whose cached column was the merged slot,
    must find their next feasible column."""
    x = np.array([0.0, 1.0, 1.1, 1.3, 9.0, 10.0], np.float32)[:, None]
    model, _ = _run(x, rule, max_size=2, min_size=2)
    # log rows (bhi, blo, new birth): (1, 1.1) -> 6 fills its slot, then
    # (9, 10) -> 7 and (0, 1.3) -> 8
    np.testing.assert_array_equal(model.log[:3], [[2, 1, 6], [5, 4, 7],
                                                  [3, 0, 8]])
    assert model.rescans[0] == 3  # rows 2 (sa), 0 and 3


def test_step_limit_gates_found():
    """A limit below the merges the data allows: the last calls find a
    pair but must not merge it, and nothing changes after the limit."""
    x = _features("normal", 60, 5)
    xp = torch.zeros((128, 16))
    xp[:60] = torch.from_numpy(x)
    st, cents = tw._loop_state(xp, 60, 10, 6)
    model = _Model(st)
    for _ in range(14):
        dvec = st.dvec.numpy().copy()
        mk.merge_step_plain(st)
        out = model.step(dvec)
        _assert_matches(model, out, st)
        tw._float_step(st, cents, "centroid")
    assert model.step_no == 10 and np.isfinite(out[0]) and not out[3]


@pytest.mark.parametrize("data", ["normal", "grid"])
def test_rescans_per_merge(data):
    """500 items at n_pad 512, the rows a cached call rescans (row sa
    included) on normal d = 16 and integer-grid d = 8 data: few a merge
    on normal data, more under ties (PERF.md records the card's counts at
    n = 4096)."""
    model, _ = _run(_features(data, 500, 11), "centroid")
    mean = float(np.mean(model.rescans))
    print(f"K1 cache model ({data}, n=500): {len(model.rescans)} merges, "
          f"{mean:.3f} rows rescanned per merge, row sa included "
          f"(max {max(model.rescans)})")
    assert min(model.rescans) >= 1
    if data == "normal":
        assert mean <= 8.0


@pytest.mark.parametrize("rule,d", [("centroid", 4), ("lance_williams", 16)])
def test_twin_loop_matches_jax_engine(monkeypatch, rule, d):
    """The twin loop with the plain bookkeeping, run step by step on the
    CPU, gives the JAX engine's merge log and clusters (its fused Pallas
    loop in interpret mode)."""
    monkeypatch.setenv("IMAGECLUST_FUSED_MERGE", "1")
    x = np.random.default_rng(d).integers(-3, 4, (150, d)).astype(
        np.float32)
    want = jw.constrained_ward(x, min_size=3, max_size=6, update_rule=rule)
    got = tw._constrained_ward(
        x, None, min_size=3, max_size=6, update_rule=rule,
        reassign_dropped=False, mesh=None, device="cpu",
        merge_step=mk.merge_step_plain, eager=True)
    np.testing.assert_array_equal(got.merges, want.merges)
    assert got.cluster_map == want.cluster_map
    assert got.dropped == want.dropped
