"""Plain size-constrained Ward clustering and the Ward cost of a partition.

The yardstick for the engine's partition: greedy agglomerative Ward in
float64 over the whole job, each step merging the feasible pair whose
merge raises the within-cluster sum of squares least (Lance-Williams'
Ward update), where a pair is feasible when its sizes sum to at most
``max_size``. It stops at ``n_clusters`` clusters or when no pair is
feasible; clusters under ``min_size`` then give up their items, each
joining the nearest centroid of a cluster with room, in index order.

It imports nothing of the program; it reads the program's features and
its cluster count only to judge the program's partition against its own.
"""

from __future__ import annotations

import torch

INF = float("inf")


def _masked_min(d: torch.Tensor, rows: torch.Tensor, size: torch.Tensor,
                alive: torch.Tensor, max_size: int):
    """Least feasible entry of each of ``rows`` and its column."""
    sub = d.index_select(0, rows)
    bad = ((size.index_select(0, rows)[:, None] + size[None, :] > max_size)
           | ~alive[None, :])
    sub = sub.masked_fill(bad, INF)
    sub[torch.arange(len(rows), device=d.device), rows] = INF
    return sub.min(dim=1)


def constrained_ward(x: torch.Tensor, n_clusters: int, min_size: int,
                     max_size: int) -> torch.Tensor:
    """Cluster label of each row of ``x`` (-1 where no cluster had room)."""
    dev = x.device
    x = x.double()
    x = x - x.mean(dim=0)
    n = x.shape[0]
    sq = (x * x).sum(dim=1)
    d = (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min_(0) * 0.5
    size = torch.ones(n, dtype=torch.long, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    label = torch.arange(n, device=dev)
    all_rows = torch.arange(n, device=dev)
    rmin, rarg = _masked_min(d, all_rows, size, alive, max_size)
    for _ in range(n - n_clusters):
        i = int(torch.argmin(rmin))
        if rmin[i].item() == INF:
            break
        j = int(rarg[i])
        si, sj = size[i], size[j]
        sk = size.double()
        # Lance-Williams for Ward: the merged cluster's distance to each k
        row = ((si + sk) * d[i] + (sj + sk) * d[j] - sk * d[i, j]) \
            / (si + sj + sk)
        d[i] = row
        d[:, i] = row
        size[i] = si + sj
        alive[j] = False
        label[label == j] = i
        rmin[j] = INF
        # rows whose least entry was with i or j, and i itself, rescan;
        # every other row can only have gained a nearer i
        stale = ((rarg == i) | (rarg == j)) & alive
        stale[i] = True
        idx = stale.nonzero().flatten()
        m, a = _masked_min(d, idx, size, alive, max_size)
        rmin[idx], rarg[idx] = m, a
        cand = row.masked_fill(size + size[i] > max_size, INF)
        cand[i] = INF
        better = alive & (cand < rmin)
        rmin = torch.where(better, cand, rmin)
        rarg = torch.where(better, torch.full_like(rarg, i), rarg)
    del d
    return _reassign_small(x, label, min_size, max_size)


def _reassign_small(x: torch.Tensor, label: torch.Tensor, min_size: int,
                    max_size: int) -> torch.Tensor:
    roots, label = torch.unique(label, return_inverse=True)
    size = torch.bincount(label, minlength=len(roots))
    small = size < min_size
    moving = small[label].nonzero().flatten().tolist()
    label = label.clone()
    label[small[label]] = -1
    size[small] = 0
    total = torch.zeros(len(roots), x.shape[1], dtype=x.dtype,
                        device=x.device)
    keep = label >= 0
    total.index_add_(0, label[keep], x[keep])
    for item in moving:
        cent = total / size.clamp_min(1)[:, None].double()
        gap = ((cent - x[item]) ** 2).sum(dim=1)
        gap = gap.masked_fill((size == 0) | (size >= max_size), INF)
        c = int(torch.argmin(gap))
        if gap[c].item() == INF:
            continue
        label[item] = c
        size[c] += 1
        total[c] += x[item]
    return label


def ward_cost(x: torch.Tensor, label: torch.Tensor) -> float:
    """The partition's within-cluster sum of squares in float64; an item
    in no cluster (label -1) counts its distance to the mean of all."""
    x = x.double()
    x = x - x.mean(dim=0)
    keep = label >= 0
    lab = label[keep]
    k = int(lab.max()) + 1 if len(lab) else 0
    total = torch.zeros(k, x.shape[1], dtype=x.dtype, device=x.device)
    total.index_add_(0, lab, x[keep])
    size = torch.bincount(lab, minlength=k).double()
    within = (x[keep] ** 2).sum() - ((total ** 2).sum(dim=1)
                                    / size.clamp_min(1)).sum()
    return float(within + (x[~keep] ** 2).sum())
