"""NumPy oracle: a faithful transliteration of the reference clustering engine.

This module exists ONLY as a test oracle. It mirrors, loop for loop, the Go
implementation in the reference's internal/clustering/clustering.go so the
vectorized engine (:mod:`imageclust_tpu_torch.cluster.ward`) can be checked
for assignment-level parity. Citations below are to that file. Below this
docstring the module is the JAX package's ``cluster/oracle.py``, unchanged.

Do not use this in the pipeline — it is intentionally O(n^3), like the
reference.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "calculate_optimal_clusters",
    "perform_clustering_with_constraints",
]

_MAX_FLOAT32 = np.float32(np.finfo(np.float32).max)


class _Cluster:
    """Mirror of ``Cluster`` (clustering.go:11-15)."""

    __slots__ = ("indices", "size", "centroid")

    def __init__(self, indices, size, centroid):
        self.indices = indices
        self.size = size
        self.centroid = centroid


def _new_cluster(index: int, embedding: np.ndarray) -> _Cluster:
    # clustering.go:18-26
    return _Cluster([index], 1, embedding.astype(np.float32).copy())


def _merge_clusters(a: _Cluster, b: _Cluster) -> _Cluster:
    # clustering.go:29-47 — a's indices first, then b's; weighted centroid.
    size = a.size + b.size
    centroid = (
        np.float32(a.size) * a.centroid + np.float32(b.size) * b.centroid
    ) / np.float32(size)
    return _Cluster(a.indices + b.indices, size, centroid.astype(np.float32))


def _ward_distance(a: _Cluster, b: _Cluster) -> np.float32:
    # clustering.go:136-145
    diff = a.centroid - b.centroid
    distance_squared = np.float32(np.dot(diff, diff))
    numerator = np.float32(a.size * b.size)
    denominator = np.float32(a.size + b.size)
    return np.float32((numerator / denominator) * distance_squared)


def _compute_initial_distance_matrix(clusters: list[_Cluster]) -> list[list[np.float32]]:
    # clustering.go:61-73
    n = len(clusters)
    mat = [[np.float32(0.0)] * n for _ in range(n)]
    for i in range(n):
        for j in range(i):
            d = _ward_distance(clusters[i], clusters[j])
            mat[i][j] = d
            mat[j][i] = d
    return mat


def _remove_rows_and_columns(mat, i, j):
    # clustering.go:100-116 (assumes i < j after swap)
    if i > j:
        i, j = j, i
    for row in mat:
        del row[j]
        del row[i]
    del mat[j]
    del mat[i]
    return mat


def _update_distance_matrix(mat, clusters, new_cluster, i, j):
    # clustering.go:76-96 — remove old rows/cols, append new row/col computed
    # from the merged centroid (NOT Lance-Williams; recomputed exactly).
    mat = _remove_rows_and_columns(mat, i, j)
    n = len(clusters)
    new_row = [np.float32(0.0)] * n
    for k in range(n - 1):
        new_row[k] = _ward_distance(clusters[k], new_cluster)
    new_row[n - 1] = np.float32(0.0)
    for k in range(n - 1):
        mat[k].append(new_row[k])
    mat.append(new_row)
    return mat


def _find_closest_clusters(mat) -> tuple[int, int]:
    # clustering.go:119-133 — strict '<' against MaxFloat32 init, row-major
    # scan i in 0..n-1, j in 0..i-1; first minimum wins.
    min_distance = _MAX_FLOAT32
    idx1, idx2 = -1, -1
    n = len(mat)
    for i in range(n):
        for j in range(i):
            if mat[i][j] < min_distance:
                min_distance = mat[i][j]
                idx1, idx2 = i, j
    return idx1, idx2


def calculate_optimal_clusters(total_items: int, min_size: int, max_size: int) -> int:
    """clustering.go:168-186. Raises ValueError where Go returns an error."""
    if total_items < min_size:
        raise ValueError(
            f"total items ({total_items}) less than minimum cluster size ({min_size})"
        )
    n_min = math.ceil(total_items / max_size)
    n_max = math.floor(total_items / min_size)
    if n_min > n_max:
        raise ValueError(
            f"cannot satisfy cluster size constraints with total items "
            f"({total_items}), minSize ({min_size}), and maxSize ({max_size})"
        )
    n = n_min
    if n_min < n_max:
        n = (n_min + n_max) // 2
    return n


def _merge_loop(clusters, mat, n_target, max_size):
    # clustering.go:220-246 (and the identical sub-loop :320-346)
    while len(clusters) > n_target:
        i, j = _find_closest_clusters(mat)
        if i == -1 or j == -1:
            break
        if clusters[i].size + clusters[j].size > max_size:
            mat[i][j] = _MAX_FLOAT32
            mat[j][i] = _MAX_FLOAT32
            continue
        new_cluster = _merge_clusters(clusters[i], clusters[j])
        # RemoveClusters assumes i < j internally (clustering.go:51-58)
        lo, hi = (j, i) if i > j else (i, j)
        del clusters[hi]
        del clusters[lo]
        clusters.append(new_cluster)
        mat = _update_distance_matrix(mat, clusters, new_cluster, i, j)
    return clusters, mat


def _split_cluster(cluster: _Cluster, embeddings: np.ndarray, max_size: int):
    # clustering.go:295-349 — recursive split with minSize=1.
    sub_embeddings = [embeddings[idx] for idx in cluster.indices]
    n_sub = calculate_optimal_clusters(len(sub_embeddings), 1, max_size)
    sub_clusters = [_new_cluster(i, e) for i, e in enumerate(sub_embeddings)]
    mat = _compute_initial_distance_matrix(sub_clusters)
    sub_clusters, _ = _merge_loop(sub_clusters, mat, n_sub, max_size)
    # Remap local indices back to the parent's item indices so callers see
    # global ids (the Go code keeps local indices and maps through
    # productReferenceIDs of the sub list implicitly via cluster.Indices —
    # but note it actually indexes the GLOBAL id list with LOCAL indices;
    # we reproduce the *intended* behavior here for the oracle, see
    # perform_clustering_with_constraints).
    return sub_clusters


def perform_clustering_with_constraints(
    embeddings: np.ndarray,
    product_reference_ids: list[str],
    min_size: int,
    max_size: int,
) -> tuple[dict[int, list[str]] | None, bool]:
    """clustering.go:198-284, faithful including the drop-undersized pass."""
    embeddings = np.asarray(embeddings, dtype=np.float32)
    total_items = len(embeddings)
    try:
        n_clusters = calculate_optimal_clusters(total_items, min_size, max_size)
    except ValueError:
        return None, False

    clusters = [_new_cluster(i, embeddings[i]) for i in range(total_items)]
    mat = _compute_initial_distance_matrix(clusters)
    clusters, mat = _merge_loop(clusters, mat, n_clusters, max_size)

    # clustering.go:248-262 — split oversized (unreachable in practice since
    # the merge loop never creates a cluster above max_size, but kept for
    # contract parity).
    final_clusters: list[_Cluster] = []
    for cluster in clusters:
        if cluster.size > max_size:
            subs = _split_cluster(cluster, embeddings, max_size)
            if subs is None:
                return None, False
            # NOTE: the Go code carries sub-cluster LOCAL indices straight
            # into the id lookup (clustering.go:274-277) — a latent bug that
            # is unreachable; the oracle remaps to parent indices (the
            # intended semantics) and documents the divergence.
            for sc in subs:
                sc.indices = [cluster.indices[k] for k in sc.indices]
            final_clusters.extend(subs)
        else:
            final_clusters.append(cluster)

    # clustering.go:264-280 — drop under-min clusters, renumber sequentially.
    cluster_map: dict[int, list[str]] = {}
    cluster_id = 0
    for cluster in final_clusters:
        if cluster.size < min_size:
            continue
        cluster_map[cluster_id] = [product_reference_ids[idx] for idx in cluster.indices]
        cluster_id += 1

    return cluster_map, True
