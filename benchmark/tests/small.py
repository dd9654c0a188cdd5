"""A cell at a size the CPU test run can hold: the published widths, the
cell's bounds and limits, a few dozen to a few hundred images a job.

The engine's partition is compared with Ward's (``ward_excess``) only in
the ResNet50 cell here, under a limit of this size's own: the bucketed
engine's cost over Ward's grows with the number of buckets (at 200 images
a job, one bucket, sound runs read 0.004-0.068 and a shuffled fifth
0.36-0.45 on three seeds; at 20,000 they read 0.37-0.44 and 0.80-0.83 on
the card, PERF.md), and the ViT cell's bounds leave a job of a CPU's size
two or three clusters, where no shuffle shows."""

from __future__ import annotations

import torch

from benchmark import control
from benchmark.manifest import Manifest

# images per base as in the cells: 20,000 / 2048 and 10,000 / 2048
SMALL = {"rn50.stream_20k": {"images_per_job": 200, "n_base": 20,
                             "ward_jobs_per_run": 1},
         "vitb32.stream_10k_coarse": {"images_per_job": 40, "n_base": 8,
                                      "ward_jobs_per_run": 0}}
WARD_LIMIT = {"rn50.stream_20k": 0.2}
BATCH = 16


def limits(cell: str) -> dict:
    """The cell's limits at this size."""
    out = dict(Manifest().limits(cell))
    out.pop("ward_excess", None)
    if cell in WARD_LIMIT:
        out["ward_excess"] = WARD_LIMIT[cell]
    return out


def reading(cell: str, side: str, fault: str = "row", seed: int = 2 ** 31 + 9):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    m = Manifest()
    tr = dict(m.traffic(m.cell(cell)["traffic"]))
    tr.update(SMALL[cell], sample_rows_per_job=SMALL[cell]["images_per_job"])
    return control.reading(m, cell, seed, side, torch.device("cpu"),
                           traffic=tr,
                           overrides={"embed": {"batch_size": BATCH}},
                           fault=fault, limits=limits(cell))
