"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is False. On a GPU host
without JAX (tests/conftest.py imports it) run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from imageclust_tpu_torch.cluster import ward
from imageclust_tpu_torch.ops import merge_kernels as mk

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from imageclust_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _state(gen, n, dev, tied):
    d = (torch.randint(0, 4, (n, n), generator=gen).float() if tied
         else torch.rand((n, n), generator=gen))
    d = ((d + d.T) / 2).contiguous()
    d.fill_diagonal_(0.0)
    births = torch.randperm(2 * n, generator=gen)[:n].to(torch.int32)
    sizes = torch.randint(1, 4, (n,), generator=gen).to(torch.int32)
    active = (torch.rand(n, generator=gen) < 0.8).to(torch.int32)
    dvec = torch.rand(n, generator=gen)
    return [t.to(dev) for t in (d, dvec, births, sizes, active)]


@pytest.mark.parametrize("n", [128, 384, 2048])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("do_update", [0, 1])
def test_kernel_bit_identical_to_twin(cuda, n, tied, do_update):
    gen = torch.Generator().manual_seed(n + tied)
    D, dvec, births, sizes, active = _state(gen, n, cuda, tied)
    for sa in (0, n // 3, n - 1):
        for max_size in (0, 3, 6):
            dk, dp = D.clone(), D.clone()
            before = mk.launches
            got = mk.merge_update_argmin(dk, dvec, sa, do_update, births,
                                         sizes, active, max_size)
            assert mk.launches == before + 1
            want = mk.merge_update_argmin_plain(dp, dvec, sa, do_update,
                                                births, sizes, active,
                                                max_size)
            assert torch.equal(dk.view(torch.int32), dp.view(torch.int32))
            assert [float(v) for v in got[1:]] == [float(v)
                                                   for v in want[1:]]


def test_kernel_rejects_cpu_scalars_on_cuda(cuda):
    D = torch.zeros((128, 128), device=cuda)
    v = torch.zeros(128, device=cuda)
    i = torch.zeros(128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mk.merge_update_argmin(D, v, torch.zeros(1, dtype=torch.int32), 0,
                               i, i, i, 6)


@pytest.mark.parametrize("rule", ["centroid", "lance_williams"])
def test_engine_on_card_matches_twin_loop(cuda, rule):
    x = np.random.default_rng(3).integers(-2, 3, (700, 64)).astype(
        np.float32)
    kw = dict(min_size=3, max_size=6, update_rule=rule,
              reassign_dropped=False, mesh=None, device=cuda)
    mk.launches = 0
    got = ward._constrained_ward(x, None, merge_step=mk.merge_update_argmin,
                                 **kw)
    assert mk.launches == len(got.merges)
    want = ward._constrained_ward(
        x, None, merge_step=mk.merge_update_argmin_plain, **kw)
    np.testing.assert_array_equal(got.merges, want.merges)
    assert got.cluster_map == want.cluster_map
