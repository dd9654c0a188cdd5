"""The generator repeats bit for bit under one seed, differs across job
indices and seeds, and gives every seed the same group sizes."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import traffic, weights

TR = {"images_per_job": 50, "n_base": 6, "base_max": 200, "noise_mask": 55,
      "group_seed": 0, "sample_rows_per_job": 7}


def _images(seed, job):
    return torch.cat(list(traffic.Job(TR, seed, job, 32, 16, "cpu").chunks()))


def test_same_seed_same_images():
    a, b = _images(2 ** 31 + 3, 4), _images(2 ** 31 + 3, 4)
    assert torch.equal(a, b)
    assert a.shape == (50, 32, 32, 3) and a.dtype == torch.uint8


def test_jobs_and_seeds_differ():
    a = _images(11, 0)
    assert not torch.equal(a, _images(11, 1))
    assert not torch.equal(a, _images(12, 0))


def test_group_sizes_fixed_across_seeds():
    sizes = [np.sort(np.bincount(traffic.Job(TR, s, j, 32, 16, "cpu")
                                 .z.numpy(), minlength=6))
             for s, j in ((1, 0), (2, 0), (1, 5))]
    assert all(np.array_equal(sizes[0], s) for s in sizes[1:])
    assert sizes[0].sum() == 50


def test_noise_within_mask_and_rows():
    job = traffic.Job(TR, 5, 0, 32, 16, "cpu")
    imgs = torch.cat(list(traffic.Job(TR, 5, 0, 32, 16, "cpu").chunks()))
    diff = imgs.int() - job.base[job.z].int()
    assert diff.min() >= 0 and (diff & ~55).eq(0).all()
    idx = traffic.sample_rows(TR, 5, 0)
    assert np.array_equal(idx, traffic.sample_rows(TR, 5, 0))
    assert len(idx) == 7 and np.all(np.diff(idx) > 0)
    assert torch.equal(job.rows(idx), imgs[torch.from_numpy(idx)])


def test_weights_repeat():
    inits = [("a", (4, 3, 2, 2), "conv"), ("b", (4,), "bn_var")]
    w1, w2 = weights.make(inits, 9, "cpu"), weights.make(inits, 9, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert (w1["b"] > 0).all()
    assert not torch.equal(w1["a"], weights.make(inits, 10, "cpu")["a"])
