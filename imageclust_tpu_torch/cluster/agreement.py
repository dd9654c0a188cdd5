"""Partition-agreement metrics for the non-parity quality scoreboard.

The framework ships precision-caveated NON-parity modes (engine residency
``cluster.feature_dtype=bfloat16|int8``, PTQ serving ``embed.quantize=int8``,
dense label fusion ``labels.fusion=text``) whose perf wins are measured in
BASELINE.md. This module supplies the other axis: HOW DIFFERENT are their
assignments from the f32 parity path (clustering.go:198-284's semantics)?
``bench.py --quality`` emits the scoreboard; tests pin floors.

Metrics (all computed exactly from the sparse contingency table, O(nnz)):

* ``rand``  — raw Rand index: fraction of item pairs whose co-membership
  agrees. With size-capped clusters (max 6) almost every pair is apart, so
  this saturates near 1; reported for completeness.
* ``ari``   — adjusted Rand index (chance-corrected; the headline number).
* ``nmi``   — normalized mutual information (sqrt normalization).
* ``ami``   — adjusted mutual information, computed only when the cluster
  counts make the exact expected-MI sum tractable (Ka*Kb below ~1e6 —
  small tiers and tests); ``None`` above that. ARI is the chance-corrected
  score that scales to every tier.
* ``pair_recall`` / ``pair_precision`` — of pairs co-clustered in the
  BASELINE partition, the fraction co-clustered in the variant (and vice
  versa). With tiny capped clusters these are the interpretable numbers:
  "94% of the pairs the f32 engine put together, int8 also put together."
* ``same_pair_f1`` — harmonic mean of the two.

Items dropped in EITHER partition are excluded from the pair statistics
(their count is reported as ``excluded``).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["partition_vector", "agreement"]

# exact AMI needs an O(Ka*Kb) expected-MI sum — fine for tests and small
# tiers, prohibitive at 100k+ items of size-6 clusters (Ka*Kb ~ 1e9)
_AMI_MAX_CELLS = 1_000_000


def partition_vector(cluster_map: dict, ids: list) -> np.ndarray:
    """Dense cluster-index vector aligned to ``ids`` (-1 = dropped).

    ``cluster_map`` is ClusterResult.cluster_map: {cluster_id: [item ids]}.
    """
    idx = {iid: i for i, iid in enumerate(ids)}
    out = np.full(len(ids), -1, np.int64)
    for ci, (_, members) in enumerate(sorted(cluster_map.items())):
        for iid in members:
            out[idx[iid]] = ci
    return out


def _pairs(x: np.ndarray) -> float:
    x = x.astype(np.float64)
    return float((x * (x - 1.0)).sum() / 2.0)


def _entropy(counts: np.ndarray, n: int) -> float:
    p = counts.astype(np.float64) / n
    return float(-(p * np.log(p)).sum())


def _expected_mi(a_counts: np.ndarray, b_counts: np.ndarray, n: int) -> float:
    """Exact expected MI under the permutation model (Vinh et al. 2010).
    O(Ka*Kb*range) — call only below _AMI_MAX_CELLS."""
    log_n = math.log(n)
    # precompute log factorials: lg[k] = log(k!)
    emi = 0.0
    lg = np.zeros(n + 2)
    lg[1:] = np.cumsum(np.log(np.arange(1, n + 2)))

    def logfact(k):
        return lg[k]

    for ai in a_counts:
        ai = int(ai)
        for bj in b_counts:
            bj = int(bj)
            lo = max(1, ai + bj - n)
            hi = min(ai, bj)
            for nij in range(lo, hi + 1):
                log_term = (
                    logfact(ai) + logfact(bj)
                    + logfact(n - ai) + logfact(n - bj)
                    - logfact(n) - logfact(nij) - logfact(ai - nij)
                    - logfact(bj - nij) - logfact(n - ai - bj + nij)
                )
                emi += (nij / n) * (
                    math.log(nij) + log_n - math.log(ai) - math.log(bj)
                ) * math.exp(log_term)
    return emi


def agreement(labels_a: np.ndarray, labels_b: np.ndarray) -> dict:
    """Agreement scores between two partitions given as per-item cluster
    indices (-1 = dropped; dropped-in-either items are excluded)."""
    a = np.asarray(labels_a, np.int64)
    b = np.asarray(labels_b, np.int64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    keep = (a >= 0) & (b >= 0)
    excluded = int((~keep).sum())
    a, b = a[keep], b[keep]
    n = a.size
    if n < 2:
        raise ValueError("need at least 2 jointly-assigned items")

    # compact to dense ranges
    ua, a = np.unique(a, return_inverse=True)
    ub, b = np.unique(b, return_inverse=True)
    ka, kb = len(ua), len(ub)
    a_counts = np.bincount(a, minlength=ka)
    b_counts = np.bincount(b, minlength=kb)
    # sparse contingency: pair codes -> counts
    codes = a * kb + b
    _, nij = np.unique(codes, return_counts=True)

    P = _pairs(nij)          # together in both
    A = _pairs(a_counts)     # together in a
    B = _pairs(b_counts)     # together in b
    T = n * (n - 1) / 2.0

    rand = (T - A - B + 2.0 * P) / T
    exp = A * B / T
    denom = (A + B) / 2.0 - exp
    ari = 1.0 if denom == 0 else (P - exp) / denom

    # NMI from the same sparse table
    uniq_codes, nij_c = np.unique(codes, return_counts=True)
    ai_of = a_counts[uniq_codes // kb].astype(np.float64)
    bj_of = b_counts[uniq_codes % kb].astype(np.float64)
    pij = nij_c.astype(np.float64) / n
    mi = float((pij * np.log(n * nij_c / (ai_of * bj_of))).sum())
    ha, hb = _entropy(a_counts, n), _entropy(b_counts, n)
    nmi = 1.0 if ha == 0 and hb == 0 else mi / max(math.sqrt(ha * hb), 1e-30)

    ami = None
    if ka * kb <= _AMI_MAX_CELLS:
        emi = _expected_mi(a_counts, b_counts, n)
        # arithmetic-mean normalization (sklearn's default)
        d = (ha + hb) / 2.0 - emi
        ami = 1.0 if abs(d) < 1e-12 else (mi - emi) / d

    pair_recall = 1.0 if A == 0 else P / A
    pair_precision = 1.0 if B == 0 else P / B
    f1 = (0.0 if pair_recall + pair_precision == 0
          else 2 * pair_recall * pair_precision
          / (pair_recall + pair_precision))
    return {
        "n": int(n),
        "excluded": excluded,
        "rand": round(rand, 6),
        "ari": round(float(ari), 6),
        "nmi": round(float(nmi), 6),
        "ami": None if ami is None else round(float(ami), 6),
        "pair_recall": round(float(pair_recall), 6),
        "pair_precision": round(float(pair_precision), 6),
        "same_pair_f1": round(float(f1), 6),
        "clusters_a": int(ka),
        "clusters_b": int(kb),
    }
