"""K2 (merge_loop_whole) and K3 (merge_update_argmin_batched) of the PyTorch
port against the JAX package.

On the CPU the port's wrappers run their plain twins. They must be
bit-identical to the Pallas kernels in interpret mode (the cases of
tests/test_pallas_kernels.py:111-256) and to the vmapped ``_bucket_chunk``;
the port's K3 lockstep loop must give K2's results under Lance-Williams.
The CUDA kernels are held against the twins on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageclust_tpu.cluster.sharded as jsh
from imageclust_tpu.ops.pallas_kernels import (
    masked_argmin_pair_xla,
    merge_loop_whole as jax_merge_loop_whole,
    merge_update_argmin_batched as jax_batched,
)
from imageclust_tpu_torch.cluster import sharded as tsh
from imageclust_tpu_torch.ops import bucket_kernels as bk
from imageclust_tpu_torch.ops import merge_kernels as mk

torch.set_num_threads(1)

_BIG = 2**31 - 1


def _bucket_states(rng, C, B, quantize):
    Ds, bs, ss, acts = [], [], [], []
    for _ in range(C):
        d = rng.random((B, B)).astype(np.float32)
        if quantize:
            d = np.round(d * 4) / 4  # exact ties
        d = (d + d.T) / 2
        np.fill_diagonal(d, 0.0)
        Ds.append(d)
        bs.append(rng.permutation(2 * B)[:B].astype(np.int32))
        ss.append(rng.integers(1, 4, B).astype(np.int32))
        a = rng.random(B) > 0.2
        a[:2] = True
        acts.append(a)
    return np.stack(Ds), np.stack(bs), np.stack(ss), np.stack(acts)


def _port_k3(D, dvec, sa, do, births, sizes, active, max_size, amin):
    Dt = torch.from_numpy(D.copy())
    out = mk.merge_update_argmin_batched(
        Dt, torch.from_numpy(dvec), torch.from_numpy(sa),
        torch.from_numpy(do), torch.from_numpy(births),
        torch.from_numpy(sizes), torch.from_numpy(active.astype(np.int32)),
        max_size, amin)
    assert out[0] is Dt  # updated in place
    return [o.numpy() for o in out]


def _jax_k3(D, dvec, sa, do, births, sizes, active, max_size, amin):
    out = jax_batched(jnp.asarray(D), jnp.asarray(dvec), jnp.asarray(sa),
                      jnp.asarray(do), jnp.asarray(births),
                      jnp.asarray(sizes), jnp.asarray(active),
                      jnp.int32(max_size), jnp.int32(amin), interpret=True)
    return [np.asarray(o) for o in out]


def _bits(a):
    return np.asarray(a).view(np.int32)


class TestK3TwinMatchesPallas:
    @pytest.mark.parametrize("quantize", [False, True])
    @pytest.mark.parametrize("amin", [-1, 2])
    def test_matches_interpret_and_xla_per_bucket(self, rng, quantize, amin):
        C, B = 3, 128
        D, births, sizes, active = _bucket_states(rng, C, B, quantize)
        active[1] = False  # a bucket where every pair is infeasible
        dvec = rng.random((C, B)).astype(np.float32)
        sa = np.array([3, 7, 127], np.int32)
        do = np.array([1, 0, 1], np.int32)
        for max_size in (2, 6):
            args = (dvec, sa, do, births, sizes, active, max_size, amin)
            got = _port_k3(D, *args)
            want = _jax_k3(D, *args)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_bits(g), _bits(w))
            assert np.isinf(got[1][1]) and got[2][1] == _BIG
            for c in range(C):
                ref = masked_argmin_pair_xla(
                    jnp.asarray(got[0][c]), jnp.asarray(births[c]),
                    jnp.asarray(sizes[c]), jnp.asarray(active[c]),
                    jnp.int32(max_size),
                    require_under=None if amin <= 0 else jnp.int32(amin))
                assert float(got[1][c]) == float(ref[0])
                if np.isfinite(float(ref[0])):
                    assert (got[2][c], got[3][c]) == (int(ref[1]),
                                                      int(ref[2]))

    def test_update_applied_per_bucket(self, rng):
        C, B = 2, 128
        D, births, sizes, active = _bucket_states(rng, C, B, False)
        dvec = rng.random((C, B)).astype(np.float32)
        out = _port_k3(D, dvec, np.array([3, 7], np.int32),
                       np.array([1, 0], np.int32), births, sizes, active, 6,
                       -1)[0]
        np.testing.assert_array_equal(out[0][3, :], dvec[0])
        np.testing.assert_array_equal(out[0][:, 3], dvec[0])
        np.testing.assert_array_equal(out[1], D[1])  # no pending update

    def test_any_bucket_width(self, rng):
        """The port takes widths the Pallas kernel cannot (B % 128 != 0):
        the twin still equals the per-bucket XLA reduction."""
        C, B = 2, 50
        D, births, sizes, active = _bucket_states(rng, C, B, True)
        got = _port_k3(D, np.zeros((C, B), np.float32),
                       np.zeros(C, np.int32), np.zeros(C, np.int32), births,
                       sizes, active, 6, 3)
        for c in range(C):
            ref = masked_argmin_pair_xla(
                jnp.asarray(D[c]), jnp.asarray(births[c]),
                jnp.asarray(sizes[c]), jnp.asarray(active[c]), jnp.int32(6),
                require_under=jnp.int32(3))
            assert (float(got[1][c]), int(got[2][c]), int(got[3][c])) == (
                float(ref[0]), int(ref[1]), int(ref[2]))


def _chunk_inputs(rng, grid, B=128, counts=(128, 37, 5), d=16):
    C = len(counts)
    feats = (rng.integers(-3, 4, (C * B, d)) if grid
             else rng.normal(size=(C * B, d))).astype(np.float32)
    bucket_idx = np.arange(C * B, dtype=np.int32).reshape(C, B)
    counts = np.asarray(counts, np.int32)
    targets = np.array([tsh._bucket_target(int(c), 3, 6) if c else 0
                        for c in counts], np.int32)
    return feats, bucket_idx, counts, targets


def _jax_chunk_args(feats, bucket_idx, counts, targets):
    return (jnp.asarray(feats), jnp.asarray(bucket_idx), jnp.asarray(counts),
            jnp.asarray(targets), jnp.int32(6), jnp.int32(3))


def _torch_args(feats, bucket_idx, counts, targets):
    return (torch.from_numpy(feats), torch.from_numpy(bucket_idx),
            torch.from_numpy(counts), torch.from_numpy(targets), 6, 3)


def _assert_same(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w))


class TestK2TwinMatchesPallas:
    @pytest.mark.parametrize("grid", [False, True])
    @pytest.mark.parametrize("absorb", [False, True])
    def test_matches_interpret_and_vmapped_loop(self, rng, grid, absorb):
        feats, bidx, counts, targets = _chunk_inputs(rng, grid)
        jargs = _jax_chunk_args(feats, bidx, counts, targets)
        vmapped = jsh._bucket_chunk(*jargs, update_rule="lance_williams",
                                    absorb=absorb)
        xs = jnp.asarray(feats)[jnp.asarray(bidx)]
        D = jnp.stack([jsh.pairwise_ward_singleton(x) for x in xs])
        interp = jax_merge_loop_whole(D, jnp.asarray(counts),
                                      jnp.asarray(targets), jnp.int32(6),
                                      jnp.int32(3 if absorb else 0),
                                      interpret=True)
        Dt = tsh.pairwise_ward_singleton(torch.from_numpy(feats[bidx]))
        got = bk.merge_loop_whole(Dt, torch.from_numpy(counts),
                                  torch.from_numpy(targets), 6,
                                  3 if absorb else 0)
        assert got[4].dtype == torch.bool
        _assert_same(got, vmapped)
        _assert_same(got, interp)
        assert int(got[1][0]) > 0

    def test_any_bucket_width_matches_vmapped(self, rng):
        feats, bidx, counts, targets = _chunk_inputs(rng, True, B=50,
                                                     counts=(50, 20, 0))
        want = jsh._bucket_chunk(
            *_jax_chunk_args(feats, bidx, counts, targets),
            update_rule="lance_williams", absorb=True)
        got = tsh._bucket_chunk_whole(
            *_torch_args(feats, bidx, counts, targets))
        _assert_same(got, want)


class TestLockstepLoop:
    """The port's K3 lockstep loop (``_bucket_chunk_fused``)."""

    @pytest.mark.parametrize("absorb", [False, True])
    def test_equals_whole_loop_under_lance_williams(self, rng, absorb):
        feats, bidx, counts, targets = _chunk_inputs(rng, False)
        args = _torch_args(feats, bidx, counts, targets)
        before = tsh.lockstep_phases
        stepped = tsh._bucket_chunk_fused(*args, update_rule="lance_williams",
                                          absorb=absorb)
        assert tsh.lockstep_phases == before + 1 + absorb
        whole = tsh._bucket_chunk_whole(*args, absorb=absorb)
        _assert_same(stepped, whole)

    @pytest.mark.parametrize("rule", ["centroid", "lance_williams"])
    def test_matches_jax_lockstep(self, rng, rule):
        """Lance-Williams on a random integer grid; the centroid rule on
        well-separated integer-grid blobs. XLA's CPU row sum of the
        centroid rule accumulates with fused multiply-adds and torch's
        rounds each product, so its distances may differ in the last bit
        where a merged centroid is not dyadic: only data whose merge order
        no such bit decides gives identical logs."""
        feats, bidx, counts, targets = _chunk_inputs(rng, True, d=8)
        if rule == "centroid":
            centers = rng.integers(-50, 51, (len(feats) // 4, 8)) * 8
            feats = (np.repeat(centers, 4, axis=0)
                     + rng.integers(-1, 2, feats.shape)).astype(np.float32)
        want = jsh._bucket_chunk_fused(
            *_jax_chunk_args(feats, bidx, counts, targets),
            update_rule=rule, absorb=True, interpret=True)
        got = tsh._bucket_chunk_fused(
            *_torch_args(feats, bidx, counts, targets), update_rule=rule,
            absorb=True)
        _assert_same(got, want)


class TestWrapperContracts:
    def test_cpu_runs_the_twins_and_counts_nothing(self, rng):
        feats, bidx, counts, targets = _chunk_inputs(rng, True,
                                                     counts=(10, 7, 0))
        k2, k3 = bk.launches, mk.batched_launches
        args = _torch_args(feats, bidx, counts, targets)
        tsh._bucket_chunk_whole(*args)
        tsh._bucket_chunk_fused(*args, update_rule="centroid")
        assert (bk.launches, mk.batched_launches) == (k2, k3)

    @pytest.mark.parametrize("bad", ["D_dtype", "D_shape", "int_dtype",
                                     "vec_shape", "device"])
    def test_k3_rejects_bad_inputs(self, bad):
        C, B = 2, 8
        D = torch.zeros((C, B, B))
        vec = torch.zeros((C, B))
        ints = torch.zeros((C, B), dtype=torch.int32)
        sa = torch.zeros(C, dtype=torch.int32)
        if bad == "D_dtype":
            D = D.double()
        elif bad == "D_shape":
            D = torch.zeros((C, B, B + 1))
        elif bad == "int_dtype":
            ints = ints.long()
        elif bad == "vec_shape":
            vec = torch.zeros((C, B + 1))
        elif bad == "device":
            D = D.to("meta")
        with pytest.raises((TypeError, ValueError)):
            mk.merge_update_argmin_batched(D, vec, sa, sa, ints, ints, ints,
                                           6, -1)

    def test_k3_rejects_other_devices(self):
        C, B = 2, 8
        t = [torch.zeros((C, B, B), device="meta"),
             torch.zeros((C, B), device="meta")] + [
            torch.zeros(s, dtype=torch.int32, device="meta")
            for s in ((C,), (C,), (C, B), (C, B), (C, B))]
        with pytest.raises(ValueError, match="cuda or cpu"):
            mk.merge_update_argmin_batched(*t, 6, -1)

    @pytest.mark.parametrize("bad", ["D_dtype", "square", "counts",
                                     "device"])
    def test_k2_rejects_bad_inputs(self, bad):
        C, B = 2, 8
        D = torch.zeros((C, B, B))
        counts = torch.zeros(C, dtype=torch.int32)
        if bad == "D_dtype":
            D = D.double()
        elif bad == "square":
            D = torch.zeros((C, B, B + 1))
        elif bad == "counts":
            counts = counts.long()
        elif bad == "device":
            D = D.to("meta")
            counts = counts.to("meta")
        with pytest.raises((TypeError, ValueError)):
            bk.merge_loop_whole(D, counts, counts, 6, 3)
