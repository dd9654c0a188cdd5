"""K1 (merge_update_argmin) in the PyTorch port against the JAX package.

On the CPU the port's wrapper runs the plain twin; it must be bit-identical
to the Pallas kernel in interpret mode and to ``masked_argmin_pair_xla`` on
the cases of tests/test_pallas_kernels.py. The CUDA kernel itself is held
against the twin on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageclust_tpu.ops.pallas_kernels import (
    masked_argmin_pair_xla,
    merge_update_argmin as jax_merge_update_argmin,
)
from imageclust_tpu_torch.ops import merge_kernels as mk
from imageclust_tpu_torch.ops._build import launches

torch.set_num_threads(1)


def _state(rng, n, quantize=False):
    d = rng.random((n, n)).astype(np.float32)
    if quantize:
        d = np.round(d * 4) / 4  # force exact ties
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    births = rng.permutation(2 * n)[:n].astype(np.int32)
    sizes = rng.integers(1, 4, n).astype(np.int32)
    active = rng.random(n) > 0.2
    if active.sum() < 2:
        active[:2] = True
    return d, births, sizes, active


def _port(d, dvec, sa, do, births, sizes, active, max_size):
    D = torch.from_numpy(d.copy())
    out = mk.merge_update_argmin(
        D, torch.from_numpy(np.asarray(dvec, np.float32)), sa, do,
        torch.from_numpy(births), torch.from_numpy(sizes),
        torch.from_numpy(active.astype(np.int32)), max_size)
    assert out[0] is D  # updated in place, as the kernel does
    return D.numpy(), float(out[1]), int(out[2]), int(out[3])


def _jax(d, dvec, sa, do, births, sizes, active, max_size):
    D2, dmin, m1, m2 = jax_merge_update_argmin(
        jnp.asarray(d), jnp.asarray(dvec, jnp.float32), sa, do,
        jnp.asarray(births), jnp.asarray(sizes), jnp.asarray(active),
        jnp.int32(max_size), interpret=True)
    return np.asarray(D2), float(dmin), int(m1), int(m2)


def _same(a, b):
    np.testing.assert_array_equal(a[0].view(np.int32), b[0].view(np.int32))
    assert a[1:] == b[1:] or (np.isinf(a[1]) and np.isinf(b[1])
                              and a[2:] == b[2:])


class TestTwinMatchesPallas:
    @pytest.mark.parametrize("n", [128, 256])
    @pytest.mark.parametrize("quantize", [False, True])
    def test_no_update_matches_xla_argmin(self, rng, n, quantize):
        for _ in range(3):
            d, births, sizes, active = _state(rng, n, quantize)
            for max_size in (2, 6, 100):
                args = (np.zeros(n), 0, 0, births, sizes, active, max_size)
                got = _port(d, *args)
                _same(got, _jax(d, *args))
                np.testing.assert_array_equal(got[0], d)
                want = masked_argmin_pair_xla(
                    jnp.asarray(d), jnp.asarray(births), jnp.asarray(sizes),
                    jnp.asarray(active), max_size)
                assert got[1:] == (float(want[0]), int(want[1]),
                                   int(want[2]))

    @pytest.mark.parametrize("n", [128, 256])
    @pytest.mark.parametrize("sa", [0, 7, 127])
    def test_update_applied_then_argmin(self, rng, n, sa):
        d, births, sizes, active = _state(rng, n)
        dvec = rng.random(n).astype(np.float32)
        dvec[sa] = 0.0
        got = _port(d, dvec, sa, 1, births, sizes, active, 6)
        _same(got, _jax(d, dvec, sa, 1, births, sizes, active, 6))
        dm = d.copy()
        dm[sa, :] = dvec
        dm[:, sa] = dvec
        np.testing.assert_array_equal(got[0], dm)

    @pytest.mark.parametrize("n", [128, 256])
    def test_all_infeasible(self, rng, n):
        d, births, sizes, active = _state(rng, n)
        got = _port(d, np.zeros(n), 0, 0, births, sizes, active, 0)
        assert np.isinf(got[1]) and got[2:] == (2**31 - 1, 2**31 - 1)
        _same(got, _jax(d, np.zeros(n), 0, 0, births, sizes, active, 0))

    @pytest.mark.parametrize("n", [128, 256])
    def test_respects_active_mask(self, rng, n):
        d, births, sizes, active = _state(rng, n)
        d[3, 7] = d[7, 3] = 0.0
        active[3] = active[7] = False
        got = _port(d, np.zeros(n), 0, 0, births, sizes, active, 100)
        _same(got, _jax(d, np.zeros(n), 0, 0, births, sizes, active, 100))
        assert got[1] > 0.0

    def test_ties_broken_by_births(self, rng):
        n = 128
        d = np.ones((n, n), np.float32)
        births = rng.permutation(n).astype(np.int32)
        sizes = np.ones(n, np.int32)
        active = np.ones(n, bool)
        got = _port(d, np.zeros(n), 0, 0, births, sizes, active, 6)
        _same(got, _jax(d, np.zeros(n), 0, 0, births, sizes, active, 6))
        assert got[2:] == (1, 0)  # the pair born first, Go scan order

    def test_plain_matches_whole_matrix_reduce(self, rng):
        d, births, sizes, active = _state(rng, 256, quantize=True)
        t = [torch.from_numpy(a) for a in (d, births, sizes,
                                           active.astype(np.int32))]
        whole = mk.masked_argmin_pair_plain(*t, 6)
        _, *stripes = mk.merge_update_argmin_plain(
            t[0].clone(), torch.zeros(256), 0, 0, *t[1:], 6)
        assert [float(v) for v in whole] == [float(v) for v in stripes]

    @pytest.mark.parametrize("require_under", [None, 2, 3])
    def test_masked_argmin_pair_plain_matches_xla(self, rng, require_under):
        d, births, sizes, active = _state(rng, 128, quantize=True)
        got = mk.masked_argmin_pair_plain(
            torch.from_numpy(d), torch.from_numpy(births),
            torch.from_numpy(sizes), torch.from_numpy(active), 6,
            require_under=require_under)
        want = masked_argmin_pair_xla(
            jnp.asarray(d), jnp.asarray(births), jnp.asarray(sizes),
            jnp.asarray(active), 6,
            require_under=None if require_under is None
            else jnp.int32(require_under))
        assert [float(g) for g in got] == [float(w) for w in want]


class TestWrapperContract:
    def _args(self, n=128):
        D = torch.zeros((n, n))
        vec = torch.zeros(n)
        ints = torch.zeros(n, dtype=torch.int32)
        return D, vec, ints

    def test_cpu_tensors_take_the_twin_and_count_nothing(self):
        D, vec, ints = self._args()
        before = launches["merge_update_argmin"]
        mk.merge_update_argmin(D, vec, 0, 0, ints, ints, ints + 1, 6)
        assert launches["merge_update_argmin"] == before

    @pytest.mark.parametrize("bad", ["dtype", "vec_dtype", "int_dtype",
                                     "square", "multiple", "vec_len"])
    def test_rejects_wrong_dtype_or_shape(self, bad):
        D, vec, ints = self._args()
        sizes = ints
        if bad == "dtype":
            D = D.double()
        elif bad == "vec_dtype":
            vec = vec.double()
        elif bad == "int_dtype":
            sizes = ints.long()
        elif bad == "square":
            D = torch.zeros((128, 256))
        elif bad == "multiple":
            D, vec, ints = self._args(100)
            sizes = ints
        elif bad == "vec_len":
            vec = torch.zeros(256)
        with pytest.raises((TypeError, ValueError)):
            mk.merge_update_argmin(D, vec, 0, 0, ints, sizes, ints, 6)

    def test_rejects_non_contiguous(self):
        D, vec, ints = self._args(256)
        with pytest.raises(ValueError, match="contiguous"):
            mk.merge_update_argmin(D[::2, ::2], vec[::2], 0, 0, ints[::2],
                                   ints[::2], ints[::2], 6)
        with pytest.raises(ValueError, match="contiguous"):
            mk.merge_update_argmin(torch.zeros(256, 512)[:, :256], vec, 0, 0,
                                   ints, ints, ints, 6)

    def test_rejects_scalar_of_wrong_type(self):
        D, vec, ints = self._args()
        with pytest.raises(TypeError):
            mk.merge_update_argmin(D, vec, torch.tensor([0.0]), 0, ints, ints,
                                   ints, 6)

    def test_rejects_other_devices(self):
        n = 128
        D = torch.zeros((n, n), device="meta")
        vec = torch.zeros(n, device="meta")
        ints = torch.zeros(n, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            mk.merge_update_argmin(D, vec, 0, 0, ints, ints, ints, 6)
