"""The traffic generator: jobs of synthetic photos made on the card.

A job is ``images_per_job`` uint8 BGR images at the tower's size. Each is
one of ``n_base`` base patterns (uniform in [0, ``base_max``)) plus its
own noise ``bits & noise_mask`` (199 + 55 does not wrap), made in chunks of
the tower's batch on the device. This is the generator of the port's
``bench.py`` (``bench_e2e_stream``), with one change: how many images
each base gets is the same multiset in every job and every seed (drawn once
from ``group_seed``), and the seed only permutes it, so every seed asks
the same amount of clustering and naming work. The base patterns, the
permutation and the noise come from a ``torch.Generator`` seeded from
(``--seed``, job index), so one seed gives the same images again.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.weights import mix


def group_plan(traffic: dict) -> np.ndarray:
    """The base index of every image before the job's permutation."""
    rng = np.random.default_rng(int(traffic["group_seed"]))
    return rng.integers(0, int(traffic["n_base"]),
                        int(traffic["images_per_job"])).astype(np.int64)


def sample_rows(traffic: dict, seed: int, job: int) -> np.ndarray:
    """The sorted rows of a job whose embeddings the reference checks."""
    rng = np.random.default_rng(mix(seed, "sample", job))
    n = int(traffic["images_per_job"])
    k = min(n, int(traffic["sample_rows_per_job"]))
    return np.sort(rng.choice(n, k, replace=False))


def ward_slot(traffic: dict, seed: int, job: int) -> int | None:
    """Where job ``job`` goes in the sample of ``ward_jobs_per_run`` jobs
    whose partition is compared with Ward's, or None: a reservoir sample
    drawn from the seed, so it is known before the job runs and is uniform
    over however many jobs the window holds."""
    k = int(traffic.get("ward_jobs_per_run", 0))
    if job < k:
        return job
    r = int(np.random.default_rng(mix(seed, "ward", job)).integers(job + 1))
    return r if r < k else None


class Job:
    """The images of job ``job`` under ``seed``, for a tower of input size
    ``size`` fed in chunks of ``batch``. :meth:`chunks` may be iterated
    once; make a new ``Job`` to see the same images again."""

    def __init__(self, traffic: dict, seed: int, job: int, size: int,
                 batch: int, device, plan: np.ndarray | None = None):
        self.n = int(traffic["images_per_job"])
        self.size, self.batch = size, batch
        self.mask = int(traffic["noise_mask"])
        self.gen = torch.Generator(device=device).manual_seed(
            mix(seed, "job", job))
        self.base = torch.randint(
            0, int(traffic["base_max"]),
            (int(traffic["n_base"]), size, size, 3), generator=self.gen,
            device=device, dtype=torch.uint8)
        plan = group_plan(traffic) if plan is None else plan
        perm = torch.randperm(self.n, generator=self.gen, device=device)
        self.z = torch.from_numpy(plan).to(device)[perm]

    def chunks(self):
        for start in range(0, self.n, self.batch):
            c = min(self.batch, self.n - start)
            noise = torch.randint(0, 256, (c, self.size, self.size, 3),
                                  generator=self.gen, device=self.base.device,
                                  dtype=torch.uint8)
            yield self.base[self.z[start:start + c]] + (noise & self.mask)

    def rows(self, idx: np.ndarray) -> torch.Tensor:
        """The images at sorted rows ``idx`` (consumes the chunks)."""
        out, start = [], 0
        for chunk in self.chunks():
            sel = idx[(idx >= start) & (idx < start + chunk.shape[0])]
            if len(sel):
                out.append(chunk[torch.from_numpy(sel - start).to(
                    chunk.device)])
            start += chunk.shape[0]
        return torch.cat(out)
