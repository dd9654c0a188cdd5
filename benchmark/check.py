"""The comparisons that decide ``correct``.

Every job of the window is judged once the window has closed and the
program's state is freed:

* ``tower_sq_err``: the embedding rows that the timed path wrote for a
  sample of each job's images (drawn from the seed), against the plain
  float32 reference tower run on the same images with the same published
  weights: the worst row's relative squared error
  ``||program - reference||^2 / ||reference||^2``.
* ``partition_faults`` (exact): items missing, repeated or out of range,
  clusters outside ``[min_size, max_size]``, and cluster and drop counts
  that differ from the pipeline's counters.
* ``ward_excess``: how far the engine's partition is from Ward's, on a
  sample of the jobs drawn from the seed. Over the job's whole embedding
  buffer as the embed stage returned it (the sampled rows above tie it to
  the reference tower), the partition's within-cluster sum of squares
  over that of the plain constrained Ward (:mod:`benchmark.reference.ward`)
  run to the same number of clusters under the same bounds, less one.
* ``unnamed_clusters`` (exact): clusters within the naming budget without
  a title from the namer.
* ``report_faults`` (exact): report pages missing or unlisted, cluster
  cards and image tiles that differ from the partition.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import ward


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def tower_sq_err(program_rows: torch.Tensor,
                 reference_rows: torch.Tensor) -> np.ndarray:
    """Each row's ``||program - reference||^2 / ||reference||^2``."""
    p = program_rows.double()
    r = reference_rows.double()
    return (((p - r) ** 2).sum(dim=1) / (r ** 2).sum(dim=1)).cpu().numpy()


def members_of(details: dict, dropped: list[str]) -> tuple[list, np.ndarray]:
    """Cluster member indices and dropped indices from a result's image
    names (``img_<index>.jpg``)."""

    def idx(name: str) -> int:
        return int(name[4:-4])

    clusters = [np.fromiter((idx(n) for n in d.images), np.int64)
                for d in details.values()]
    return clusters, np.fromiter((idx(n) for n in dropped), np.int64)


def partition_faults(clusters: list, dropped: np.ndarray, n: int,
                     min_size: int, max_size: int, counters: dict) -> int:
    every = np.concatenate(clusters + [dropped]) if clusters else dropped
    bad = int(((every < 0) | (every >= n)).sum())
    seen = np.bincount(every[(every >= 0) & (every < n)], minlength=n)
    bad += int((seen == 0).sum()) + int(np.clip(seen - 1, 0, None).sum())
    bad += sum(1 for c in clusters if not min_size <= len(c) <= max_size)
    bad += abs(int(counters.get("clusters", -1)) - len(clusters))
    bad += abs(int(counters.get("dropped", 0)) - len(dropped))
    return bad


def labels_of(clusters: list, n: int) -> np.ndarray:
    """Each item's cluster index, -1 where dropped or in no cluster."""
    label = np.full(n, -1, np.int64)
    for c, members in enumerate(clusters):
        label[members] = c
    return label


def ward_excess(features: torch.Tensor, clusters: list, min_size: int,
                max_size: int) -> float:
    """The partition's Ward cost over the plain constrained Ward's on the
    same features, to as many clusters, less one."""
    n = features.shape[0]
    label = torch.from_numpy(labels_of(clusters, n)).to(
        features.device)
    ref = ward.constrained_ward(features, len(clusters), min_size, max_size)
    return ward.ward_cost(features, label) / ward.ward_cost(features, ref) \
        - 1.0


def unnamed_clusters(details: dict, budget: int) -> int:
    expect = min(len(details), budget) if budget else len(details)
    named = sum(1 for d in details.values()
                if d.service_outputs and d.title)
    return abs(expect - named)


_PAGE = re.compile(r"clusters_p(\d+)\.html")


def report_faults(work_dir: str, n_clusters: int, n_tiles: int,
                  page_size: int) -> int:
    index = os.path.join(work_dir, "clusters.html")
    if not os.path.exists(index):
        return 1 + n_clusters
    pages = sorted(glob.glob(os.path.join(work_dir, "clusters_p*.html")))
    bad = 0
    if n_clusters <= page_size:
        bad += len(pages)  # one self-contained file
        cards_in = [index]
    else:
        bad += abs(len(pages) - -(-n_clusters // page_size))
        listed = set()
        for path in [index] + glob.glob(
                os.path.join(work_dir, "clusters_ix*.html")):
            with open(path, encoding="utf-8") as fh:
                listed.update(_PAGE.findall(fh.read()))
        there = {_PAGE.search(os.path.basename(p)).group(1) for p in pages}
        bad += len(listed ^ there)
        cards_in = pages
    cards = tiles = 0
    for path in cards_in:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        cards += text.count('<div class="cluster">')
        tiles += text.count('<div class="image">')
    return bad + abs(cards - n_clusters) + abs(tiles - n_tiles)
