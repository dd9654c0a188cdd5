"""Scalable constrained Ward on PyTorch: k-means buckets, then each bucket's
exact merge loop on the card (K2 or K3).

Counterpart of ``imageclust_tpu/cluster/sharded.py`` for one device, with
the same observable semantics:

1. **Bucketing.** A few Lloyd iterations of k-means over the embeddings
   (distances as matmuls over (block, k) tiles, centroid sums as one-hot
   matmuls so they add in a fixed order), one full-data summarize pass
   (assignment, own distance, each item's 8 nearest buckets), then a
   host-side capacity repair so every bucket holds between ``min_size``
   and ``bucket_size`` items. Only per-item summaries (assigned bucket,
   rank in it, preference rows of the items repair can read) leave the
   device. On CUDA at k >= ``_PREF_FUSED_MIN_K`` buckets the summarize pass
   is one launch of the fused preference kernel K4
   (:func:`imageclust_tpu_torch.ops.pref_kernels.pref_topk_block`); below
   that, and on the CPU (as the JAX package off a TPU), it runs (block, k)
   distance tiles and a stable sort. Above ``_PREF_NEED_ONLY_MIN_WORK``
   (n * k) off the K4 path, the summarize pass skips the preferences and
   repair computes them for the items it can read only (need-only mode).
   On the card, where that means k < 4096, it needs 4096+ items a bucket,
   more than K2/K3 take, so only the CPU reaches the mode (from about 5M
   images at the default bucket size), as in the JAX package off a TPU.
2. **Per-bucket exact Ward.** The buckets' rows are gathered on the device,
   chunk by chunk, into (C, B, B) Ward matrices, and every bucket runs the
   reference's merge loop (same tie-breaks, same maxSize mask) followed by
   the absorb phase that merges under-min clusters instead of dropping
   them. Lance-Williams runs the whole loop per bucket in one launch of K2
   (:mod:`imageclust_tpu_torch.ops.bucket_kernels`); the centroid rule runs
   the lockstep loop whose step is K3
   (:func:`imageclust_tpu_torch.ops.merge_kernels.lockstep_step`, 64
   iterations a CUDA graph replay on the card).
   A CUDA tensor runs the kernels, a CPU tensor their plain twins.
3. **Host tail.** Merge logs are re-stamped into one dendrogram, members
   expanded (the native ``ic_reconstruct_members`` when
   ``native/libicnative.so`` is built, else the Python walk), and items of
   clusters still under ``min_size`` spill into the nearest cluster with
   room, first inside their bucket, then anywhere.

Feature residency (``feature_dtype``): float32, bfloat16 (the resident
matrix rounded once; grams from exact upcasts, accumulated in f32) or int8
(quantized once to a symmetric per-tensor grid whose scale is discarded, or
an int8 input used as is; exact integer grams). Spill centroids live in the
residency dtype (int8 rounded back onto the grid) and, off float32, are
rebuilt each round from an on-device member table.

On a mesh (``mesh=``, one rank per device over ``torch.distributed``)
the buckets shard over the ``data`` ranks: one all_to_all moves each
bucket member from the rank holding its row to its bucket's rank, which
runs its buckets through K2 or K3 (:func:`_all_buckets_mesh`). Features
that arrive row-sharded (:class:`~imageclust_tpu_torch.core.mesh.
ShardedRows`, from the mesh ``Embedder``) stay so throughout: k-means runs
in row-block form and the spills sum centroids per rank (psums); only
per-item summaries and the rows of dropped items are gathered.

Not ported: ``_device_spill_place``. The JAX package's
``IMAGECLUST_SUMMARIZE_FUSED`` and ``IMAGECLUST_PREF_FUSED`` switches are
not ported either: on the card they swap K4 for the tile path, which the
port's runtime rules forbid. Nor is ``IMAGECLUST_PREF_NEED_ONLY``: the mode
follows from the job's size alone.

The k-means seeding draws from ``torch.Generator(seed)``, not ``jax.random``,
so the port's buckets differ from the JAX package's for the same seed; the
tests inject JAX's indices through :func:`_kmeans_init` and
:func:`_kmeans_subsample` to compare stage by stage.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
from typing import Sequence

import numpy as np
import torch

from imageclust_tpu_torch.cluster.ward import (
    FOUND_READ_EVERY,
    ClusterResult,
    DefaultIds,
    _leaf_indices,
    _run_graphed,
    calculate_optimal_clusters,
    constrained_ward,
    pairwise_ward_singleton,
    ward_update_vector,
)
from imageclust_tpu_torch.core.collectives import (
    all_gather_rows,
    all_to_all_rows,
    pmax,
    psum,
)
from imageclust_tpu_torch.core.mesh import (
    ShardedRows,
    check_mesh,
    local_rows,
)
from imageclust_tpu_torch.device import resolve_device
from imageclust_tpu_torch.ops.bucket_kernels import merge_loop_whole
from imageclust_tpu_torch.ops import merge_kernels as mk
from imageclust_tpu_torch.ops.pref_kernels import (
    gram,
    pref_topk_block,
    row_norms,
    to_grid,
)
from imageclust_tpu_torch.utils.metrics import timed

__all__ = ["constrained_ward_bucketed", "kmeans"]

log = logging.getLogger(__name__)

_BIG_I32 = 2**31 - 1

# Chunks dispatched by _all_buckets (one K2 launch, or one K3 lockstep loop,
# each), and the K3 loop's iterations in which some bucket still ran, with
# the number of loop phases: a phase launches K3 between its iterations + 1
# and its iterations + FOUND_READ_EVERY times (the first iteration, then
# whole graph replays until one ends with an iteration that ran no bucket).
chunks_dispatched = 0
lockstep_iterations = 0
lockstep_phases = 0


@contextlib.contextmanager
def _phase(phases: dict, device: torch.device, name: str):
    """One phase of an engine run: its host seconds go to ``phases[name]``
    and, under a ``torch.profiler`` trace, it is the ``record_function``
    range ``cluster/<name>``. IMAGECLUST_CLUSTER_PROFILE=1 synchronises the card
    at both ends, so the phase boundary is real (which costs pipelining),
    and logs the phase."""
    sync = bool(os.environ.get("IMAGECLUST_CLUSTER_PROFILE"))
    if sync and device.type == "cuda":
        torch.cuda.synchronize(device)
    with timed(phases, name, f"cluster/{name}"):
        yield
        if sync and device.type == "cuda":
            torch.cuda.synchronize(device)
    if sync:
        log.info("cluster phase %-16s %7.2fs", name, phases[name])


_TOP_PREF = 8  # per-item bucket preferences exported to the host

# need-only preferences (repair computes rows for its need-set only) above
# this n * n_buckets product, off the K4 path (sharded.py:2629-2660)
_PREF_NEED_ONLY_MIN_WORK = 1 << 36

# on CUDA the summarize pass is one K4 launch at k >= this many buckets
_PREF_FUSED_MIN_K = 4096

_KMEANS_BLOCK = 1 << 16  # rows per assignment block


def _kmeans_block(n_real: int, k: int, block: int) -> int:
    block = min(block, 1 << (max(n_real - 1, 1)).bit_length())
    # cap the (block, k) distance tile at ~1.5 GB
    while block > 2048 and block * k * 4 > (3 << 29):
        block //= 2
    return block


def _sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(m, k) squared distances: max(|x|^2 + |y|^2 - 2 x.y, 0) in f32."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xx = row_norms(x)[:, None]
    yy = row_norms(y)[None, :]
    g = torch.matmul(x, y.T)
    return torch.clamp_min(xx + yy - 2.0 * g, 0.0)


def _sqdist_tile(rows: torch.Tensor, cents: torch.Tensor,
                 cent_norms: torch.Tensor | None = None) -> torch.Tensor:
    """(block, k) squared distances for bucket assignment
    (sharded.py:128-182). ``cent_norms`` (precomputed (k,) squared norms of
    the stored centroids) skips the per-tile norm pass with the same values.

    int8 rows: centroids round onto the grid and the gram is exact integer
    arithmetic. bf16 rows: centroids round to bf16, norms come from the
    rounded values, the gram accumulates exact products in f32. f32 rows
    keep the f32 path."""
    if rows.dtype in (torch.int8, torch.bfloat16):
        if rows.dtype == torch.int8:
            c = cents if cents.dtype == torch.int8 else to_grid(cents)
        else:
            c = cents.to(torch.bfloat16)
        xx = row_norms(rows)[:, None]
        yy = (cent_norms if cent_norms is not None else row_norms(c))[None, :]
        return torch.clamp_min(xx + yy - 2.0 * gram(rows, c), 0.0)
    if cent_norms is None:
        return _sqdist(rows, cents)
    x = rows.to(torch.float32)
    xx = row_norms(x)[:, None]
    g = torch.matmul(x, cents.to(torch.float32).T)
    return torch.clamp_min(xx + cent_norms[None, :] - 2.0 * g, 0.0)


def _feat_int8(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """One-time symmetric per-tensor int8 quantization (sharded.py:185-194):
    scale = absmax / 127, then round(x / max(scale, 1e-30)) clipped to
    [-127, 127]. The scale is discarded (Ward's merge order does not depend
    on a global scale). Row blocks bound the f32 temporaries. With
    ``mesh``, ``x`` is a row block and absmax the largest over ``data``."""
    block = _KMEANS_BLOCK
    amax = torch.zeros((), dtype=torch.float32, device=x.device)
    for s, e in _blocks(x.shape[0], block):
        amax = torch.maximum(amax, torch.amax(torch.abs(
            x[s:e].to(torch.float32))))
    if mesh is not None:
        amax = pmax(amax.view(1), mesh)[0]
    scale = torch.clamp_min(amax / 127.0, 1e-30)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    for s, e in _blocks(x.shape[0], block):
        out[s:e] = to_grid(x[s:e], scale)
    return out


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def _kmeans_init_idx(n: int, k: int, seed) -> torch.Tensor:
    """The k rows (of n) the initial centroids are drawn from, without
    replacement (host int64)."""
    return torch.randperm(n, generator=_generator(seed))[:k]


def _kmeans_init(x: torch.Tensor, k: int, seed) -> torch.Tensor:
    """(k, d) f32 initial centroids: k rows drawn without replacement."""
    idx = _kmeans_init_idx(x.shape[0], k, seed)
    return _rows(x, idx).to(torch.float32)


def _kmeans_subsample(x, m: int, seed):
    """m rows drawn without replacement, for the Lloyd fit (whole on every
    rank when ``x`` is row-sharded)."""
    idx = torch.randperm(x.shape[0], generator=_generator(int(seed) + 1))[:m]
    return _rows(x, idx)


def _rows(x, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for global row ids ``idx``, on every rank when ``x`` is
    :class:`~imageclust_tpu_torch.core.mesh.ShardedRows`."""
    if isinstance(x, ShardedRows):
        return x.take(idx)
    return x[idx.to(x.device)]


def _blocks(n: int, block: int):
    for s in range(0, n, block):
        yield s, min(s + block, n)


def _kmeans_iter(x: torch.Tensor, cents: torch.Tensor, k: int,
                 block: int, mesh=None) -> torch.Tensor:
    """One Lloyd iteration (sharded.py:204-252) at the residency of ``x``:
    distances by :func:`_sqdist_tile`, centroid sums as one-hot matmuls,
    block by block: a fixed order of additions, so the result is the same
    on every run (an atomic scatter-add would not be). The block sums are
    f32 products of exact upcasts; on the int8 grid each is an exact
    integer (at most 65,536 * 127 < 2**24), as JAX's int32 sums are.

    With ``mesh``, ``x`` is this rank's real rows of a row-sharded matrix:
    local assignments against the replicated centroids, then the sums and
    counts psum'd over ``data``. Those sums round in another order than
    one device's (exact on integer grids of small magnitude)."""
    d = x.shape[1]
    dev = x.device
    sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
    counts = torch.zeros(k, dtype=torch.float32, device=dev)
    for s, e in _blocks(x.shape[0], block):
        rows = x[s:e]
        assign = torch.argmin(_sqdist_tile(rows, cents), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(torch.float32)
        counts = counts + torch.sum(onehot, dim=0)
        sums = sums + torch.matmul(onehot.T, rows.to(torch.float32))
    if mesh is not None:
        sums = psum(sums, mesh)
        counts = psum(counts, mesh)
    new = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, cents)


def _kmeans_summarize(x: torch.Tensor, cents: torch.Tensor, kk: int,
                      block: int):
    """Full-data pass: per-item assignment, own-centroid distance and the
    (n, kk) preference matrix (nearest buckets first, ties by ascending
    bucket index, as ``lax.top_k`` orders them: a stable sort). ``kk=0`` is
    the need-only mode: no preference matrix (None)."""
    assign, own, pref = [], [], []
    for s, e in _blocks(x.shape[0], block):
        d2 = _sqdist_tile(x[s:e], cents)
        a = torch.argmin(d2, dim=1)
        assign.append(a)
        own.append(torch.gather(d2, 1, a[:, None])[:, 0])
        if kk:
            pref.append(torch.sort(d2, dim=1, stable=True)[1][:, :kk])
    return (torch.cat(assign).to(torch.int32), torch.cat(own),
            torch.cat(pref).to(torch.int32) if kk else None)


def _pref_need_rows(x: torch.Tensor, cents: torch.Tensor, idx: torch.Tensor,
                    kk: int, block: int, as_u16: bool):
    """(m, kk) bucket preferences of the rows ``idx`` (sharded.py:313-343):
    the same centroids, :func:`_sqdist_tile` dtype path and tile height as
    the summarize pass for this k, one (block, k) tile at a time. int16
    bits of the uint16 values when ``as_u16`` (see :func:`_rank_u16`)."""
    prefs = [torch.sort(_sqdist_tile(x[idx[s:s + block]], cents), dim=1,
                        stable=True)[1][:, :kk]
             for s in range(0, idx.shape[0], block)]
    out = torch.cat(prefs).to(torch.int32) if prefs else torch.zeros(
        (0, kk), dtype=torch.int32, device=x.device)
    return _rank_u16(out) if as_u16 else out


def _use_summarize_fused(device: torch.device, k: int) -> bool:
    """Whether the summarize pass is one K4 launch (sharded.py:387-399): on
    CUDA at k >= ``_PREF_FUSED_MIN_K``. The CPU takes the tile path, as the
    JAX package does off a TPU."""
    return device.type == "cuda" and k >= _PREF_FUSED_MIN_K


def _fused_cast_cents(x_dtype: torch.dtype, cents: torch.Tensor):
    """Centroids in the residency's compute dtype and the f32 squared norms
    of those stored values (sharded.py:366-384; no padding: K4 checks its
    bounds)."""
    if x_dtype == torch.int8:
        c = to_grid(cents)
    elif x_dtype == torch.bfloat16:
        c = cents.to(torch.bfloat16)
    else:
        c = cents.to(torch.float32)
    return c.contiguous(), row_norms(c)


def _kmeans_summarize_fused(x: torch.Tensor, cents: torch.Tensor, kk: int,
                            as_u16: bool):
    """The summarize pass in one K4 call over all n rows (sharded.py:
    402-451, whose 512-row scan the kernel's grid replaces): assignment =
    nearest centroid, own distance = its score, preferences = the (n, kk)
    index block (int16 bits of the uint16 values when ``as_u16``). Same
    score expression and tie rule as :func:`_sqdist_tile` + argmin."""
    c, cn = _fused_cast_cents(x.dtype, cents)
    idx, vals = pref_topk_block(x, c, cn, kk)
    return (idx[:, 0].contiguous(), vals[:, 0].contiguous(),
            _rank_u16(idx) if as_u16 else idx)


# Lloyd fit on a subsample of fit_per_center * k rows above this n
_KMEANS_FIT_PER_CENTER = 32
_KMEANS_SUBSAMPLE_MIN_N = 1 << 20


def kmeans(x, k: int, iters: int = 8, seed: int = 0,
           top_k: int = _TOP_PREF, block: int = _KMEANS_BLOCK,
           fit_per_center: int = _KMEANS_FIT_PER_CENTER,
           summarize_fused: bool = False):
    """Lloyd's k-means on ``x``'s device, block by block over rows, at the
    residency of ``x`` (f32, bf16 or int8). Returns (centroids (k, d) f32,
    assign (n,) int32, own_d (n,) f32, top_pref (n, min(top_k, k))).
    ``top_k=0`` is the need-only mode (top_pref None). With
    ``summarize_fused`` the full-data pass is :func:`pref_topk_block` (K4 on
    CUDA, its twin on the CPU) and top_pref comes back as int16 bits of
    uint16 values when bucket ids fit.

    ``x`` may be :class:`~imageclust_tpu_torch.core.mesh.ShardedRows`: the
    subsample (or, below the subsample size, the initial rows) is gathered
    by psums of the owners' rows, a full-data fit runs in row-block form
    (:func:`_kmeans_iter` with the mesh), each rank summarizes its own rows
    and the per-item summaries (O(n) values, never the features) are
    all-gathered, so every rank returns the whole (n,) arrays."""
    if isinstance(x, ShardedRows):
        return _kmeans_rows(x, k, iters, seed, top_k, block, fit_per_center,
                            summarize_fused)
    n_real = x.shape[0]
    fit_x = x
    m = fit_per_center * k
    if (fit_per_center and m >= k
            and n_real > max(2 * m, _KMEANS_SUBSAMPLE_MIN_N)):
        fit_x = _kmeans_subsample(x, m, seed)
    fit_block = _kmeans_block(fit_x.shape[0], k, block)
    cents = _kmeans_init(fit_x, k, seed)
    for _ in range(iters):
        cents = _kmeans_iter(fit_x, cents, k, fit_block)
    del fit_x
    return (cents, *_summarize(x, cents, k, top_k, block, summarize_fused))


def _summarize(x, cents, k: int, top_k: int, block: int,
               summarize_fused: bool):
    """kmeans' full-data pass over the rows of ``x``: (assign, own_d,
    top_pref)."""
    n_real = x.shape[0]
    kk = min(top_k, k)
    if summarize_fused and kk:
        return _kmeans_summarize_fused(
            x, cents, kk, as_u16=k <= np.iinfo(np.uint16).max + 1)
    return _kmeans_summarize(x, cents, kk, _kmeans_block(n_real, k, block))


def _kmeans_rows(x: "ShardedRows", k: int, iters: int, seed, top_k: int,
                 block: int, fit_per_center: int, summarize_fused: bool):
    """:func:`kmeans` on a row-sharded matrix (see there)."""
    n = x.n
    m = fit_per_center * k
    if fit_per_center and m >= k and n > max(2 * m, _KMEANS_SUBSAMPLE_MIN_N):
        fit_x = _kmeans_subsample(x, m, seed)  # whole on every rank
        cents = _kmeans_init(fit_x, k, seed)
        fit_block = _kmeans_block(fit_x.shape[0], k, block)
        for _ in range(iters):
            cents = _kmeans_iter(fit_x, cents, k, fit_block)
        del fit_x
    else:
        cents = _rows(x, _kmeans_init_idx(n, k, seed)).to(torch.float32)
        loc = x.local[:x.n_local]
        fit_block = _kmeans_block(max(loc.shape[0], 1), k, block)
        for _ in range(iters):
            cents = _kmeans_iter(loc, cents, k, fit_block, mesh=x.mesh)
    assign, own_d, pref = _summarize(x.local, cents, k, top_k, block,
                                     summarize_fused)
    assign, own_d = (all_gather_rows(t, x.mesh)[:n] for t in (assign, own_d))
    if pref is not None:  # int16 (uint16 bits) travels as int32
        pref = all_gather_rows(pref.to(torch.int32), x.mesh)[:n].to(
            pref.dtype)
    return cents, assign, own_d, pref


# -- per-bucket merge loops -------------------------------------------------

def _gather_buckets(feats, bucket_idx):
    return feats[bucket_idx.to(torch.int64)].to(torch.float32)


def _bucket_chunk_whole(feats, bucket_idx, counts, targets, max_size: int,
                        min_size: int, absorb: bool = True):
    """One chunk through K2: gather the buckets' rows, build their Ward
    matrices, run every bucket's whole Lance-Williams loop in one launch
    (sharded.py:791-812)."""
    D = pairwise_ward_singleton(_gather_buckets(feats, bucket_idx))
    return merge_loop_whole(D, counts, targets, max_size,
                            min_size if absorb else 0)


# One lockstep iteration on a LockstepState: K3 on the card. Tests and the
# chip smoke run swap in mk.lockstep_step_plain, which the loop then runs
# step by step.
lockstep_step = mk.lockstep_step


def _lockstep_float(st: mk.LockstepState, cents: torch.Tensor,
                    update_rule: str) -> None:
    """The float work of one lockstep iteration (sharded.py:717-745 of the
    JAX package), shared by the kernel's and the twin's loops and written
    in place: each bucket's merged centroid into ``cents`` and its next
    pending row into ``st.dvec``, both where the bucket merged. The JAX
    expression tree op for op; ``sizes`` are already the merged ones, so
    s_b goes back at sb first (the row at sa is zeroed anyway)."""
    C, B = st.C, st.B
    pair, pf = st.pair, st.pair_f
    s_a_f, s_b_f, s_new_f = pf[:, 0:1], pf[:, 1:2], pf[:, 2:3]
    pro = st.proceed[:, None]
    sizes_f = st.sizes.to(torch.float32).scatter_(1, pair[:, 1:], s_b_f)
    if update_rule == "centroid":
        d = cents.shape[2]
        ab = cents.gather(1, pair[:, :, None].expand(C, 2, d))
        c_a = ab[:, 0]
        c_new = (s_a_f * c_a + s_b_f * ab[:, 1]) / s_new_f
        dvec = ward_update_vector(
            update_rule, sizes_f=sizes_f, s_a_f=s_a_f, s_b_f=s_b_f,
            s_new_f=s_new_f, cents=cents, c_new=c_new)
        cents.scatter_(1, pair[:, :1, None].expand(C, 1, d),
                       torch.where(pro, c_new, c_a)[:, None])
    else:  # Lance-Williams never reads cents
        rows = st.D.gather(1, pair[:, :, None].expand(C, 2, B))
        d_a = rows[:, 0]
        dvec = ward_update_vector(
            update_rule, sizes_f=sizes_f, s_a_f=s_a_f, s_b_f=s_b_f,
            s_new_f=s_new_f, d_a=d_a, d_b=rows[:, 1],
            d_ab=d_a.gather(1, pair[:, 1:]))
    dvec.scatter_(1, pair[:, :1], 0.0)
    st.dvec.copy_(torch.where(pro, dvec, st.dvec))


def _lockstep_phase(st: mk.LockstepState, cents: torch.Tensor,
                    update_rule: str, max_size: int, amin: int,
                    graph=None):
    """One phase of the lockstep loop: JAX's ``while_loop(any(run), body)``
    (``amin`` -1 for the main phase, the minimum size for the absorb
    phase), in blocks of :data:`FOUND_READ_EVERY` iterations, each followed
    by one host read of the chunk's "a bucket ran" flag; the phase ends
    after the first block whose last iteration ran no bucket. The
    iterations after the last bucket stopped are gated no-ops: each
    re-applies every frozen bucket's last pending update, which writes the
    same values. With the kernel's step on the card the blocks are replays
    of one CUDA graph (ward._run_graphed): the first phase runs its first
    iteration alone and captures the graph, which it returns; a later
    phase given that ``graph`` replays it from its first iteration (the
    kernel reads the phase from ``st.flags``). A capture that fails
    raises. On the CPU, or with the twin's step, the iterations run one by
    one in the same blocks (:func:`_run_eager`), so both give the same
    final state."""
    global lockstep_iterations, lockstep_phases
    step = lockstep_step
    st.begin_phase(amin)

    def body():
        step(st, max_size)
        _lockstep_float(st, cents, update_rule)

    go = st.flags[mk.LFLAG_ANY_RAN:mk.LFLAG_ANY_RAN + 1]
    limit = st.B + 1  # a bucket runs at most B iterations of a phase
    if st.D.device.type == "cuda" and step is mk.lockstep_step:
        graph = _run_graphed(body, st.D.device, go, limit, graph)
    else:
        graph = _run_eager(body, go, limit, graph)
    lockstep_iterations += int(st.flags[mk.LFLAG_ITERS])
    lockstep_phases += 1
    return graph


def _run_eager(body, go, limit: int, block=None):
    """ward._run_graphed's steps, run one by one in the same blocks (so the
    same final state): the first step alone, then blocks of
    FOUND_READ_EVERY until ``go`` reads false after one or ``limit`` steps
    have run. Given the ``block`` length that an earlier call returned, it
    runs blocks of that length from the first step. Returns the block
    length (None if the first step ended the run)."""
    done = 0
    if block is None:
        body()
        done = 1
        if done >= limit or not bool(go):
            return None
        block = min(FOUND_READ_EVERY, limit - done)
    while done < limit:
        for _ in range(block):
            body()
        done += block
        if not bool(go):
            break
    return block


def _lockstep_state(feats, bucket_idx, counts, targets):
    """A chunk's lockstep state (sharded.py:681-702 of the JAX package):
    (LockstepState, centroids (C, B, d)). Padding slots are inactive with
    births above every stamp the loop hands out."""
    xs = _gather_buckets(feats, bucket_idx)
    C, B, _ = xs.shape
    i32 = torch.int32
    col = torch.arange(B, dtype=i32, device=xs.device)[None, :]
    active0 = col < counts[:, None]
    st = mk.LockstepState(
        pairwise_ward_singleton(xs).contiguous(),
        births=torch.where(active0, col, _BIG_I32 - B + col).to(i32),
        sizes=active0.to(i32), active=active0.to(i32), counter=counts,
        num_active=counts, target=targets)
    return st, xs


def _bucket_chunk_fused(feats, bucket_idx, counts, targets, max_size: int,
                        min_size: int, update_rule: str = "lance_williams",
                        absorb: bool = True):
    """One chunk through the lockstep loop on K3 (sharded.py:665-788): each
    iteration is one :data:`lockstep_step` (every bucket's pending update,
    its next pair from the cached row minima, the bookkeeping) and the
    float work. Identical results to the whole loop (K2) under
    Lance-Williams."""
    st, cents = _lockstep_state(feats, bucket_idx, counts, targets)
    graph = _lockstep_phase(st, cents, update_rule, max_size, -1)
    if absorb:
        _lockstep_phase(st, cents, update_rule, max_size, min_size, graph)
    return (st.log, st.ctl[:, mk.LCTL_STEP].contiguous(), st.births,
            st.sizes, st.active > 0)


def _chunk_width(bucket_size: int, d: int) -> int:
    """Buckets per lockstep chunk: the gathered rows plus matrices stay
    ~<= 2 GB; as wide as that allows, since the loop runs ~B iterations per
    chunk whatever its width."""
    per_bucket = bucket_size * 4 * max(d, bucket_size)
    cap = max(1, (2 << 30) // max(1, per_bucket))
    return min(4096, 1 << (cap.bit_length() - 1))


def _chunk_width_whole(bucket_size: int, d: int) -> int:
    """Buckets per K2 launch: the launch's working set (gathered rows,
    matrices and log) stays ~<= 1 GB."""
    per_bucket = bucket_size * 4 * (d + bucket_size + 128)
    cap = max(1, (1 << 30) // max(1, per_bucket))
    return min(1024, 1 << (cap.bit_length() - 1))


def _all_buckets(feats, bucket_idx: np.ndarray, counts: np.ndarray,
                 targets: np.ndarray, max_size: int, min_size: int,
                 update_rule: str = "lance_williams", absorb: bool = True):
    """Single-device bucket engine, chunked over the bucket axis
    (sharded.py:844-925). Lance-Williams runs K2, the centroid rule the K3
    lockstep loop; any bucket width goes to the kernels. Buckets are sorted
    by count (descending) so a chunk's buckets need similar numbers of
    merges; outputs come back in the caller's order as host arrays (log,
    step, births, sizes, active)."""
    global chunks_dispatched
    B = int(bucket_idx.shape[1])
    d_feat = int(feats.shape[1])
    if update_rule == "lance_williams":
        chunk_w = _chunk_width_whole(B, d_feat)

        def chunk(bi, ct, tg):
            return _bucket_chunk_whole(feats, bi, ct, tg, max_size,
                                       min_size, absorb)
    elif update_rule == "centroid":
        chunk_w = _chunk_width(B, d_feat)

        def chunk(bi, ct, tg):
            return _bucket_chunk_fused(feats, bi, ct, tg, max_size,
                                       min_size, update_rule, absorb)
    else:
        raise ValueError(f"unknown update_rule: {update_rule}")
    nb = bucket_idx.shape[0]
    order = np.argsort(-counts, kind="stable")
    dev = feats.device
    outs = []
    for s in range(0, nb, chunk_w):
        sel = order[s:s + chunk_w]
        out = chunk(*(torch.from_numpy(np.ascontiguousarray(a[sel])).to(dev)
                      for a in (bucket_idx, counts, targets)))
        chunks_dispatched += 1
        outs.append([o.cpu().numpy() for o in out])
    inv = np.empty_like(order)
    inv[order] = np.arange(nb)
    return tuple(np.concatenate([o[i] for o in outs])[inv]
                 for i in range(len(outs[0])))


def _plan_exchange(buckets, n_pad_rows: int, ndev: int, bucket_size: int):
    """Host plan of the owner-aligned feature exchange (JAX sharded.py:
    928-963): every bucket member row moves from the rank holding its row
    block to the rank owning its bucket (bucket ``bi`` belongs to rank
    ``bi // (nb / ndev)``), as one all_to_all, so each rank receives about
    its buckets' rows and no rank holds the whole matrix.

    Returns (send_idx (D, D, K), recv_pos (D, D, K), K): rank sd sends its
    local rows send_idx[sd, dd, :] to rank dd; rank dd scatters the packet
    from sd into flat (bucket_local * B + slot) positions recv_pos[dd, sd, :]
    (out-of-range = padding, dropped). K is the largest packet: the JAX
    package rounds it up to a power of two to bound recompilation, which
    eager torch does not need."""
    r = n_pad_rows // ndev
    nb = len(buckets)
    nb_local = nb // ndev
    per: list[list[list[tuple[int, int]]]] = [
        [[] for _ in range(ndev)] for _ in range(ndev)
    ]
    for bi, members in enumerate(buckets):
        dd = bi // nb_local
        bl = bi % nb_local
        for slot, g in enumerate(members):
            per[g // r][dd].append((g % r, bl * bucket_size + slot))
    K = max(1, max(len(per[sd][dd]) for sd in range(ndev)
                   for dd in range(ndev)))
    send_idx = np.zeros((ndev, ndev, K), np.int32)
    recv_pos = np.full((ndev, ndev, K), np.int32(1 << 30), np.int32)
    for sd in range(ndev):
        for dd in range(ndev):
            for k, (src, pos) in enumerate(per[sd][dd]):
                send_idx[sd, dd, k] = src
                recv_pos[dd, sd, k] = pos
    return send_idx, recv_pos, K


def _all_buckets_mesh(local, mesh, buckets, bucket_size: int,
                      counts: np.ndarray, targets: np.ndarray,
                      max_size: int, min_size: int, update_rule: str,
                      absorb: bool):
    """The bucket engine over the mesh's ``data`` ranks (JAX
    ``_all_buckets_mesh``, sharded.py:985-1024): ``local`` is this rank's
    (rows_per, d) feature block; one all_to_all moves every bucket member
    to its bucket's rank, which scatters the rows into its own buckets and
    runs them through :func:`_all_buckets` (K2 under Lance-Williams, the K3
    lockstep loop under the centroid rule; the JAX mesh body runs the XLA
    loop instead). The per-bucket outputs are all-gathered, so every rank
    returns the host arrays of all ``nb`` buckets (a multiple of D), plus
    this rank's exchange counts."""
    ndev = mesh.shape["data"]
    me = mesh.index("data")
    dev = local.device
    rp, d = local.shape
    B = bucket_size
    nb_local = len(buckets) // ndev
    send_idx, recv_pos, K = _plan_exchange(buckets, rp * ndev, ndev, B)
    send = local[torch.from_numpy(send_idx[me]).to(dev, torch.int64)]
    recv = all_to_all_rows(send, mesh)  # (D, K, d): packet j from rank j
    flat = torch.zeros((nb_local * B + 1, d), dtype=local.dtype, device=dev)
    pos = torch.from_numpy(np.minimum(recv_pos[me], nb_local * B)).to(
        dev, torch.int64).reshape(-1)
    flat[pos] = recv.reshape(-1, d)  # padding lands on the spare last row
    sl = slice(me * nb_local, (me + 1) * nb_local)
    local_idx = (np.arange(nb_local, dtype=np.int32)[:, None] * B
                 + np.arange(B, dtype=np.int32)[None, :])
    outs = _all_buckets(flat[:nb_local * B], local_idx, counts[sl],
                        targets[sl], max_size, min_size,
                        update_rule=update_rule, absorb=absorb)
    gathered = tuple(
        all_gather_rows(torch.from_numpy(np.ascontiguousarray(o)).to(
            dev, torch.int32), mesh).cpu().numpy().astype(o.dtype)
        for o in outs)
    exchange = {
        "send_rows": int(ndev * K),
        "sent_real_rows": int(np.sum(recv_pos[:, me, :] < (1 << 30))),
        "recv_real_rows": int(np.sum(counts[sl])),
        "bytes": int(send.numel() * send.element_size())}
    return gathered, exchange


# -- capacity repair ---------------------------------------------------------

def _repair_buckets(assign: np.ndarray, own_d: np.ndarray,
                    top_pref: np.ndarray, n_buckets: int, capacity: int,
                    min_size: int) -> list[list[int]]:
    """Host-side capacity repair over per-item summaries: every bucket ends
    with min_size <= len <= capacity; spilled items go to the nearest
    preferred bucket with space. Computes counts and each item's rank in its
    bucket (by own distance, ties by item id) on the host; the oracle that
    :func:`_repair_buckets_device` is held against."""
    n = len(assign)
    counts0 = np.bincount(assign, minlength=n_buckets)
    perm = np.lexsort((own_d, assign))
    offs0 = np.concatenate([[0], np.cumsum(counts0[:-1])])
    rank = np.empty(n, np.int64)
    rank[perm] = np.arange(n) - np.repeat(offs0, counts0)
    return _repair_from_summaries(assign, rank, counts0, top_pref,
                                  n_buckets, capacity, min_size)


def _repair_from_summaries(assign: np.ndarray, rank: np.ndarray,
                           counts0: np.ndarray, top_pref, n_buckets: int,
                           capacity: int, min_size: int) -> list[list[int]]:
    """Capacity repair from (assign, rank-in-bucket, counts) summaries, with
    list bookkeeping (sharded.py:1060-1270). ``top_pref`` needs only
    ``__getitem__`` over spill items and members of under-min buckets."""
    order = np.argsort(assign, kind="stable")
    buckets: list[list[int]] = [
        s.tolist() for s in np.split(order, np.cumsum(counts0)[:-1])]

    # Spill overflow: keep the `capacity` closest items, re-home the rest
    # (first preferred bucket with room, else a monotone cursor over the
    # buckets; buckets only fill in this phase).
    over_b = np.flatnonzero(counts0 > capacity)
    spill_sorted: dict[int, np.ndarray] = {}
    if len(over_b):
        offs = np.concatenate([[0], np.cumsum(counts0)])
        mem_all = np.concatenate(
            [order[offs[b]:offs[b + 1]] for b in over_b])
        bid_all = np.repeat(over_b, counts0[over_b])
        perm = np.lexsort((rank[mem_all], bid_all))
        srt_all = mem_all[perm]
        bounds = np.concatenate([[0], np.cumsum(counts0[over_b])])
        for z, b in enumerate(over_b):
            spill_sorted[int(b)] = srt_all[bounds[z]:bounds[z + 1]]
    cnt = counts0.astype(np.int64)
    cnt[over_b] = capacity
    placed_items: list[np.ndarray] = []
    placed_into: list[np.ndarray] = []
    cursor = 0
    CH = 8192

    spills = [spill_sorted[int(b)][capacity:] for b in over_b]
    for b in over_b:
        buckets[int(b)] = spill_sorted[int(b)][:capacity].tolist()
    native_res = None
    if spills and sum(len(s) for s in spills):
        from imageclust_tpu_torch.data.native import native_spill_place

        spill_all = np.concatenate(spills)
        src_all = np.repeat(over_b.astype(np.int32),
                            [len(s) for s in spills])
        native_res = native_spill_place(
            top_pref[spill_all], src_all, cnt, capacity, cursor)
    if native_res is not None:
        placed_items.append(spill_all)
        placed_into.append(native_res[0].astype(np.int64))
        cursor = native_res[1]

    def _bulk_try(b: int, chunk: np.ndarray) -> bool:
        # a chunk applies at once iff every row finds an eligible preference
        # and no chosen bucket fills within the chunk
        prefs = top_pref[chunk]
        elig = (prefs != b) & (cnt[prefs] < capacity)
        if not elig.any(axis=1).all():
            return False
        j = np.argmax(elig, axis=1)
        chosen = prefs[np.arange(len(chunk)), j]
        hot, dem = np.unique(chosen, return_counts=True)
        if (dem > capacity - cnt[hot]).any():
            return False
        placed_items.append(chunk)
        placed_into.append(chosen.astype(np.int64))
        cnt[hot] += dem
        return True

    def _place(b: int, chunk: np.ndarray) -> None:
        nonlocal cursor
        if _bulk_try(b, chunk):
            return
        if len(chunk) > 128:  # bisect: only the offending tail replays
            h = len(chunk) // 2
            _place(b, chunk[:h])
            _place(b, chunk[h:])
            return
        seq_i: list[int] = []
        seq_t: list[int] = []
        for i in chunk:
            i = int(i)
            placed = False
            for nb in top_pref[i]:
                nb = int(nb)
                if nb != b and cnt[nb] < capacity:
                    seq_i.append(i)
                    seq_t.append(nb)
                    cnt[nb] += 1
                    placed = True
                    break
            if not placed:
                while cursor < n_buckets and cnt[cursor] >= capacity:
                    cursor += 1
                nb = cursor if cursor < n_buckets else b
                seq_i.append(i)
                seq_t.append(nb)
                cnt[nb] += 1
        placed_items.append(np.asarray(seq_i, dtype=np.int64))
        placed_into.append(np.asarray(seq_t, dtype=np.int64))

    if native_res is None:
        for z, b in enumerate(over_b):
            spill = spills[z]
            for s in range(0, len(spill), CH):
                _place(int(b), spill[s:s + CH])
    if placed_items:
        items_all = np.concatenate(placed_items)
        into_all = np.concatenate(placed_into)
        o2 = np.argsort(into_all, kind="stable")
        tgt, starts = np.unique(into_all[o2], return_index=True)
        ends = np.append(starts[1:], len(o2))
        srt_items = items_all[o2]
        for t, s0, s1 in zip(tgt.tolist(), starts.tolist(), ends.tolist()):
            buckets[t].extend(srt_items[s0:s1].tolist())

    # Dissolve under-min buckets into the members' preferred buckets, to a
    # fixpoint; the fallback only targets viable buckets, then any nonempty
    # one with room, never an emptied one.
    lens = np.fromiter((len(x) for x in buckets), np.int64, n_buckets)

    def place(i: int, avoid: int, lo: int) -> bool:
        for nb in top_pref[i]:
            nb = int(nb)
            if nb != avoid and lo <= lens[nb] < capacity:
                buckets[nb].append(i)
                lens[nb] += 1
                return True
        mask = (lens >= lo) & (lens < capacity)
        mask[avoid] = False
        nb = int(np.argmax(mask))
        if mask[nb]:
            buckets[nb].append(i)
            lens[nb] += 1
            return True
        return False

    for _ in range(n_buckets):
        changed = False
        for b in range(n_buckets):
            if 0 < lens[b] < min_size:
                members, buckets[b] = buckets[b], []
                lens[b] = 0
                for i in members:
                    if not place(i, b, min_size):
                        if not place(i, b, 1):
                            buckets[b].append(i)  # nowhere viable: keep
                            lens[b] += 1
                if not lens[b]:
                    changed = True
        if not changed:
            break
    return [b for b in buckets if b]


def _repair_from_summaries_fast(assign: np.ndarray, rank: np.ndarray,
                                counts0: np.ndarray, top_pref,
                                n_buckets: int, capacity: int,
                                min_size: int) -> list[np.ndarray] | None:
    """Array-based capacity repair, placement-identical to
    :func:`_repair_from_summaries` (sharded.py:1273-1473, without the
    device-placement inputs). Needs the native placement loop; returns None
    when ``native/libicnative.so`` is not built."""
    from imageclust_tpu_torch.data.native import available, native_spill_place

    if not available():
        return None
    counts0 = counts0.astype(np.int64)
    order = np.argsort(assign, kind="stable")
    offs = np.concatenate([[0], np.cumsum(counts0)])
    segs = np.split(order, offs[1:-1])

    over_b = np.flatnonzero(counts0 > capacity)
    cnt = counts0.copy()
    keeps: dict[int, np.ndarray] = {}
    spill_all = np.empty(0, np.int64)
    src_all = np.empty(0, np.int32)
    if len(over_b):
        # (bucket, rank) order with one scatter: rank is unique per bucket
        mem_all = np.concatenate([segs[b] for b in over_b])
        oc = counts0[over_b]
        bounds = np.concatenate([[0], np.cumsum(oc)])
        grp = np.repeat(np.arange(len(over_b)), oc)
        srt_all = np.empty(len(mem_all), mem_all.dtype)
        srt_all[bounds[grp] + rank[mem_all]] = mem_all
        keep_mask = rank[srt_all] < capacity
        keeps_all = srt_all[keep_mask]
        for z, blk in enumerate(
                np.split(keeps_all, capacity * np.arange(1, len(over_b)))):
            keeps[int(over_b[z])] = blk
        spill_all = srt_all[~keep_mask]
        src_all = np.repeat(over_b, oc)[~keep_mask].astype(np.int32)
        cnt[over_b] = capacity

    placed_by_tgt: dict[int, np.ndarray] = {}
    if len(spill_all):
        res = native_spill_place(top_pref[spill_all], src_all, cnt,
                                 capacity, 0)
        if res is None:
            return None
        into, _ = res  # cnt now equals the live bucket lengths
        o2 = np.argsort(into, kind="stable")
        tgt, starts = np.unique(into[o2], return_index=True)
        ends = np.append(starts[1:], len(o2))
        srt_items = spill_all[o2]
        for t, s0, s1 in zip(tgt.tolist(), starts.tolist(), ends.tolist()):
            placed_by_tgt[t] = srt_items[s0:s1]

    # Dissolve under-min buckets, as the oracle does; membership is
    # materialized only for the buckets that dissolve. ``lens`` IS ``cnt``.
    lens = cnt
    appends: dict[int, list] = {}
    dissolved = np.zeros(n_buckets, bool)

    def members_of(b: int) -> np.ndarray:
        parts = []
        if not dissolved[b]:
            parts.append(keeps[b] if b in keeps else segs[b])
            if b in placed_by_tgt:
                parts.append(placed_by_tgt[b])
        ap = appends.get(b)
        if ap:
            parts.append(np.asarray(ap, np.int64))
        if not parts:
            return np.empty(0, np.int64)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def place(i: int, avoid: int, lo: int) -> bool:
        for nb in top_pref[i]:
            nb = int(nb)
            if nb != avoid and lo <= lens[nb] < capacity:
                appends.setdefault(nb, []).append(i)
                lens[nb] += 1
                return True
        mask = (lens >= lo) & (lens < capacity)
        mask[avoid] = False
        nb = int(np.argmax(mask))
        if mask[nb]:
            appends.setdefault(nb, []).append(i)
            lens[nb] += 1
            return True
        return False

    # appends never push a bucket under min_size and dissolves zero it, so
    # the ascending sweep of the under-min snapshot visits exactly the
    # buckets the oracle's full sweep would
    for _ in range(n_buckets):
        changed = False
        for b in np.flatnonzero((lens > 0) & (lens < min_size)).tolist():
            if not 0 < lens[b] < min_size:
                continue
            members = members_of(b)
            dissolved[b] = True
            appends[b] = []
            lens[b] = 0
            for i in members:
                i = int(i)
                if not place(i, b, min_size):
                    if not place(i, b, 1):
                        appends[b].append(i)  # nowhere viable: keep
                        lens[b] += 1
            if not lens[b]:
                changed = True
        if not changed:
            break
    return [members_of(b) for b in range(n_buckets) if lens[b] > 0]


def _repair_summaries(assign, own_d, nb: int, capacity: int, min_size: int):
    """On-device repair summaries (sharded.py:1474-1497): bucket counts,
    each item's rank in its bucket ordered by (own distance, item id), the
    need mask (items whose preference rows repair may read: spilled members
    of over-capacity buckets, members of under-min buckets) and its count.
    ``jnp.lexsort((own_d, assign))`` is two stable sorts."""
    n = assign.shape[0]
    dev = assign.device
    a = assign.to(torch.int64)
    counts = torch.bincount(a, minlength=nb).to(torch.int32)
    offs = torch.cumsum(counts, 0) - counts
    by_d = torch.sort(own_d, stable=True)[1]
    perm = by_d[torch.sort(a[by_d], stable=True)[1]]
    rank_vals = (torch.arange(n, device=dev, dtype=torch.int32)
                 - torch.repeat_interleave(offs, counts.to(torch.int64),
                                           output_size=n))
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    rank[perm] = rank_vals.to(torch.int32)
    ca = counts[a]
    need = ((ca > capacity) & (rank >= capacity)) | (ca < min_size)
    return counts, rank, need, torch.sum(need, dtype=torch.int32)


def _need_idx(mask):
    """Ascending indices of the need mask (the device twin of the host's
    ``np.flatnonzero``; no padding: torch compiles no shapes)."""
    return torch.nonzero(mask)[:, 0]


def _gather_pref_rows(pref, idx, as_u16: bool):
    """Preference rows of the item set repair can read; 16 bits a value
    when bucket ids fit (see :func:`_to_host`)."""
    rows = pref[idx]
    return _rank_u16(rows) if as_u16 else rows


def _rank_u16(t):
    """Values below 2**16 in 16 bits for the transfer: an int16 tensor whose
    bits are the uint16 value (:func:`_to_host` views them so)."""
    return t.to(torch.int16)


def _to_host(t) -> np.ndarray:
    out = t.cpu().numpy()
    return out.view(np.uint16) if out.dtype == np.int16 else out


class _SparsePrefs:
    """Read-only stand-in for the full (n, 8) preference matrix holding
    only the rows capacity repair can touch (items spilled from
    over-capacity buckets + members of under-min buckets)."""

    def __init__(self, n: int, items: np.ndarray, rows):
        # ``rows`` may be the array or a zero-arg thunk that produces it
        self._rows = rows if isinstance(rows, np.ndarray) else None
        self._rows_thunk = None if isinstance(rows, np.ndarray) else rows
        self._idx = np.full(n, -1, np.int32)
        self._idx[items] = np.arange(len(items), dtype=np.int32)

    def __getitem__(self, i):
        if self._rows is None:
            self._rows = self._rows_thunk()
            self._rows_thunk = None
        j = self._idx[i]
        assert np.all(j >= 0), "preference row requested outside need-set"
        return self._rows[j]


def _repair_buckets_device(assign_d, own_d_d, pref_d, n_buckets: int,
                           capacity: int, min_size: int, feats=None,
                           cents=None, top_k: int = _TOP_PREF) -> list:
    """Capacity repair with device-side summaries (sharded.py:1686-1885):
    placement-identical to :func:`_repair_buckets`, but only assign, rank
    (16 bits when buckets hold < 64k items) and the preference rows repair
    can read cross to the host. Rows for the initial spill set plus the
    initial under-min membership cover every read (:class:`_SparsePrefs`
    asserts it).

    ``pref_d=None`` is the need-only mode (pass ``feats`` and ``cents``):
    the preference rows of exactly the need-set are computed here by
    :func:`_pref_need_rows`, with the summarize pass's tile geometry."""
    if pref_d is None and (feats is None or cents is None):
        raise ValueError(
            "_repair_buckets_device: need-only mode (pref_d=None) requires "
            "feats and cents")
    n = int(assign_d.shape[0])
    counts_d, rank_d, need_d, m_d = _repair_summaries(
        assign_d, own_d_d, n_buckets, capacity, min_size)
    counts0 = counts_d.cpu().numpy().astype(np.int64)
    m = int(m_d)
    log.info("repair need-set: %d of %d rows (%.1f%%)", m, n,
             100.0 * m / max(n, 1))
    as_u16 = n_buckets <= np.iinfo(np.uint16).max + 1
    rank_src = _rank_u16(rank_d) if (
        len(counts0) and counts0.max() <= np.iinfo(np.uint16).max
    ) else rank_d
    rows_d = None
    if m and pref_d is None:
        rows_d = _pref_need_rows(
            feats, cents, _need_idx(need_d), min(top_k, n_buckets),
            _kmeans_block(n, n_buckets, _KMEANS_BLOCK), as_u16)
    elif m:
        rows_d = _gather_pref_rows(pref_d, _need_idx(need_d), as_u16)
    rank = _to_host(rank_src)
    assign = assign_d.cpu().numpy()
    ca = counts0[assign]
    need = np.flatnonzero(
        ((ca > capacity) & (rank >= capacity)) | (ca < min_size))
    assert len(need) == m, (len(need), m)  # host/device predicate twins
    if m:
        prefs = _SparsePrefs(n, need, lambda: _to_host(rows_d))
    else:
        width = min(top_k, n_buckets) if pref_d is None \
            else int(pref_d.shape[1])
        prefs = _SparsePrefs(n, need, np.zeros((0, width), np.int32))
    out = _repair_from_summaries_fast(assign, rank, counts0, prefs,
                                      n_buckets, capacity, min_size)
    if out is None:  # no native library: the list-based path
        out = _repair_from_summaries(assign, rank, counts0, prefs,
                                     n_buckets, capacity, min_size)
    return out


# -- spills -------------------------------------------------------------------

def _spill_member_table(assign, c_pad: int, ms: int):
    """(c_pad, ms) member table + per-cluster counts from the assignment
    vector (sharded.py:2020-2048): row c lists cluster c's members by
    ascending item id, padded with n; unassigned items and anything past
    ``ms`` members are left out."""
    n = assign.shape[0]
    dev = assign.device
    a = torch.where(assign >= 0, assign.to(torch.int64), c_pad)
    perm = torch.argsort(a, stable=True)
    sorted_a = a[perm]
    offs = torch.searchsorted(
        sorted_a, torch.arange(c_pad + 1, device=dev, dtype=torch.int64))
    counts = torch.diff(torch.cat(
        [offs, torch.full((1,), n, dtype=offs.dtype, device=dev)]))
    slots = torch.arange(ms, device=dev)[None, :]
    pos = torch.clamp(offs[:c_pad, None] + slots, max=n - 1)
    ok = slots < counts[:c_pad, None]
    table = torch.where(ok, perm[pos], n)
    return table, counts[:c_pad]


def _table_sums(feats, table):
    """(c_pad, d) f32 sums of each table row's members, added one member
    slot at a time in table order, starting from zero (a fixed order on
    the card: no atomics). For row-sharded features each rank sums the
    members it holds and one (c_pad, d) psum adds the ranks' sums."""
    n, d = feats.shape
    sharded = isinstance(feats, ShardedRows)
    src = feats.local if sharded else feats
    lo, hi = (feats.row0, feats.row0 + feats.n_local) if sharded else (0, n)
    sums = torch.zeros((table.shape[0], d), dtype=torch.float32,
                       device=feats.device)
    for j in range(table.shape[1]):
        t = table[:, j]
        rows = src[torch.clamp(t - lo, 0, src.shape[0] - 1)].to(
            torch.float32)
        sums = sums + torch.where(((t >= lo) & (t < hi))[:, None], rows,
                                  0.0)
    return psum(sums, feats.mesh) if sharded else sums


def _residency_cents(mean, dtype):
    """f32 centroids in the residency's storage: int8 back onto the grid,
    bf16 rounded (sharded.py:1949-1952)."""
    if dtype == torch.int8:
        return to_grid(mean)
    return mean.to(dtype)


def _spill_centroids(feats, assign, sizes, c_pad: int, ms: int):
    """Once per spill round: every cluster's centroid (sharded.py:
    1887-1959). The segment sum adds each cluster's members in ascending
    item order, one member slot at a time (``ms`` = the largest cluster),
    starting from zero: the order XLA's segment_sum adds them in. Off f32
    the mean is taken in f32 and returned in the residency dtype."""
    table, _ = _spill_member_table(assign, c_pad, ms)
    mean = _table_sums(feats, table) / torch.clamp_min(
        sizes, 1)[:, None].to(torch.float32)
    return _residency_cents(mean, feats.dtype)


# member-table bound: (c_pad+1) * max_size * 4 bytes; past it the spill
# rounds take the segment sum every round (sharded.py:2014)
_SPILL_TABLE_BYTES = 1 << 28


def _spill_table_append(table, counts, rows, slots, items) -> None:
    """One round's placements into the member table, in place
    (sharded.py:2051-2060): slot = the cluster's size at append time, so
    appended members keep append order after the sorted base block."""
    table[rows, slots] = items
    counts.index_add_(0, rows, torch.ones_like(rows))


def _sizes_from_counts(counts, n_c: int, max_size: int):
    """Device sizes for the candidate masks: live counts for real clusters,
    "full" for padding rows (sharded.py:2063-2070)."""
    c_pad = counts.shape[0]
    return torch.where(torch.arange(c_pad, device=counts.device) < n_c,
                       counts, max_size)


def _spill_cent_table(feats, table, counts):
    """Every spill-round centroid and its squared norm from the member
    table (sharded.py:2073-2115): members summed in table order (sorted
    base block, then appends) in f32, divided, cast to the residency;
    norms from the cast values."""
    mean = _table_sums(feats, table) / torch.clamp_min(
        counts, 1)[:, None].to(torch.float32)
    cents = _residency_cents(mean, feats.dtype)
    return cents, _cent_norms(cents)


def _cent_norms(cents):
    """(c_pad,) f32 squared norms of the stored spill centroids, once per
    round."""
    return row_norms(cents)


def _topk_smallest(d2, kk: int):
    """(values, positions) of the kk smallest per row, ties by ascending
    position (``lax.top_k`` on -d2)."""
    vals, pos = torch.sort(d2, dim=1, stable=True)
    return vals[:, :kk], pos[:, :kk]


def _spill_candidates_local(feats, cents, sizes, drop_idx, item_bucket,
                            bucket_clusters, k: int, max_size: int,
                            cent_norms=None):
    """Bucket-local candidates (sharded.py:1962-2002): each item's own
    bucket's clusters with room, nearest first; GLOBAL cluster ids, -1
    where invalid. Grid features against grid centroids take an exact
    integer gram, everything else exact upcasts accumulated in f32."""
    dx = _rows(feats, drop_idx)
    cl = bucket_clusters[item_bucket]              # (chunk, mc), -1 padded
    safe = torch.clamp_min(cl, 0)
    cc = cents[safe]                               # (chunk, mc, d)
    xx = row_norms(dx)[:, None]
    yy = row_norms(cc) if cent_norms is None else cent_norms[safe]
    wide = torch.float64 if (dx.dtype == torch.int8
                             and cc.dtype == torch.int8) else torch.float32
    g = torch.einsum("cd,cmd->cm", dx.to(wide), cc.to(wide)).to(
        torch.float32)
    d2 = xx + yy - 2.0 * g
    valid = (cl >= 0) & (sizes[safe] < max_size)
    d2 = torch.where(valid, d2, float("inf"))
    vals, pos = _topk_smallest(d2, min(k, cl.shape[1]))
    cand = torch.gather(cl, 1, pos)
    return torch.where(torch.isfinite(vals), cand, -1)


def _spill_candidates(feats, cents, sizes, drop_idx, k: int, max_size: int,
                      cent_norms=None):
    """Global candidates (sharded.py:2118-2137): the top-k nearest clusters
    with room, over all clusters."""
    d2 = _sqdist_tile(_rows(feats, drop_idx), cents, cent_norms)
    d2 = torch.where(sizes[None, :] < max_size, d2, float("inf"))
    vals, cand = _topk_smallest(d2, k)
    return torch.where(torch.isfinite(vals), cand, -1)


def _ranges(sizes: np.ndarray) -> np.ndarray:
    """[0..s0), [0..s1), ... concatenated (vectorized per-segment arange)."""
    total = int(sizes.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes[:-1])])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, sizes)


class _Clusters:
    """Columnar cluster membership (compact ids 0..num-1) with O(1)
    appends: the spill phases' working view and the result's storage."""

    def __init__(self, members, offsets, bucket=None):
        self.members = np.asarray(members, dtype=np.int64)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.base_sizes = np.diff(self.offsets).astype(np.int32)
        self.bucket = None if bucket is None else np.asarray(
            bucket, dtype=np.int32)
        self.extra: dict[int, list[int]] = {}
        self._extra_count = np.zeros(len(self.base_sizes), np.int32)
        # the spill rounds' device member table, kept between the local and
        # global phases: ((c_pad, max_size), table, counts, appends)
        self._spill_dev = None

    @classmethod
    def from_lists(cls, clusters: list[list[int]], bucket=None):
        sizes = np.array([len(c) for c in clusters], np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        members = np.concatenate(
            [np.asarray(c, np.int64) for c in clusters]
        ) if clusters else np.zeros(0, np.int64)
        return cls(members, offsets, bucket)

    @property
    def num(self) -> int:
        return len(self.base_sizes)

    def sizes(self) -> np.ndarray:
        return self.base_sizes + self._extra_count

    def append(self, c: int, item: int) -> None:
        self.extra.setdefault(c, []).append(item)
        self._extra_count[c] += 1

    def assign_array(self, n: int) -> np.ndarray:
        """(n,) item -> cluster id, -1 for unplaced."""
        out = np.full(n, -1, np.int32)
        out[self.members] = np.repeat(
            np.arange(self.num, dtype=np.int32), self.base_sizes)
        for c, items in self.extra.items():
            out[items] = c
        return out

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """(members, offsets) with appends after each cluster's base
        segment (spill placements keep Go append order)."""
        if not self.extra:
            return self.members, self.offsets
        sizes_new = self.sizes().astype(np.int64)
        off_new = np.concatenate([[0], np.cumsum(sizes_new)])
        out = np.empty(int(off_new[-1]), np.int64)
        base_pos = np.repeat(off_new[:-1], self.base_sizes) \
            + _ranges(self.base_sizes)
        out[base_pos] = self.members
        for c, items in self.extra.items():
            s = int(off_new[c]) + int(self.base_sizes[c])
            out[s:s + len(items)] = items
        return out, off_new


def _spill_rounds(feats, cols: _Clusters, dropped_idx: list[int],
                  max_size: int,
                  item_bucket_of: dict[int, int] | None = None) -> list[int]:
    """Greedy nearest-cluster-with-room placement with the candidate search
    on the device (sharded.py:2214-2415): each round takes every leftover
    item's top-k nearest clusters with room and places greedily; rounds
    repeat (k doubling under contention) until one places nothing. With
    ``item_bucket_of``, placements stay inside each item's bucket. Off f32
    residency the centroids come from a device member table that each
    round's placements are appended to, while it stays under
    ``_SPILL_TABLE_BYTES`` (past it, the segment sum). ``cols`` is mutated
    in place; returns the still-unplaced items."""
    still = list(dropped_idx)
    K_CAP = 4096
    k = 0
    n_c = cols.num
    local = cols.bucket is not None and item_bucket_of is not None
    dev = feats.device
    table_d = None
    if local and n_c and still:
        bk = cols.bucket
        nb_max = 1 + max(
            int(bk.max()) if len(bk) else 0,
            max(item_bucket_of[i] for i in still),
        )
        order_b = np.argsort(bk, kind="stable")
        counts_b = np.bincount(bk, minlength=nb_max)
        mc = max(1, int(counts_b.max()))
        table = np.full((nb_max, mc), -1, np.int64)
        table[bk[order_b], _ranges(counts_b)] = order_b
        table_d = torch.from_numpy(table).to(dev)
    n = feats.shape[0]
    c_pad = 1 << max(n_c - 1, 1).bit_length()
    use_table = (feats.dtype != torch.float32
                 and (c_pad + 1) * max(max_size, 1) * 4 <= _SPILL_TABLE_BYTES)
    mt_d = mcounts_d = None
    for _ in range(len(still) + 1):
        if n_c == 0 or not still:
            break
        sizes = np.full(c_pad, max_size, np.int32)  # padding reads "full"
        sizes[:n_c] = cols.sizes()
        if not (sizes[:n_c] < max_size).any():
            break  # genuinely full everywhere
        k = min(max(k, 8), n_c, K_CAP)
        cents_d = cent_norms_d = None  # free the last round's first
        if use_table:
            if mt_d is None:
                cache = cols._spill_dev
                appends = int(cols._extra_count.sum())
                if (cache is not None and cache[0] == (c_pad, max_size)
                        and cache[3] == appends):
                    mt_d, mcounts_d = cache[1], cache[2]
                else:  # one assignment transfer per phase, not per round
                    mt_d, mcounts_d = _spill_member_table(
                        torch.from_numpy(cols.assign_array(n)).to(dev),
                        c_pad, max_size)
                cols._spill_dev = ((c_pad, max_size), mt_d, mcounts_d,
                                   appends)
            sizes_d = _sizes_from_counts(mcounts_d, n_c, max_size)
            cents_d, cent_norms_d = _spill_cent_table(feats, mt_d, mcounts_d)
        else:
            assign = torch.from_numpy(cols.assign_array(n)).to(dev)
            sizes_d = torch.from_numpy(sizes).to(dev)
            cents_d = _spill_centroids(feats, assign, sizes_d, c_pad,
                                       max(1, int(sizes[:n_c].max())))
            cent_norms_d = _cent_norms(cents_d)
        if local:
            budget = (1 << 27) // max(1, 4 * mc * feats.shape[1])
            CHUNK = 1 << max(3, min(10, budget.bit_length() - 1))
        else:
            budget = (1 << 28) // max(1, 4 * c_pad)
            CHUNK = 1 << max(5, min(12, budget.bit_length() - 1))
        cand_parts = []
        for s in range(0, len(still), CHUNK):
            part = still[s:s + CHUNK]
            idxs = torch.tensor(part, dtype=torch.int64, device=dev)
            if local:
                ib = torch.tensor([item_bucket_of[i] for i in part],
                                  dtype=torch.int64, device=dev)
                out = _spill_candidates_local(
                    feats, cents_d, sizes_d, idxs, ib, table_d, k, max_size,
                    cent_norms_d)
            else:
                out = _spill_candidates(feats, cents_d, sizes_d, idxs, k,
                                        max_size, cent_norms_d)
            cand_parts.append(out.cpu().numpy())
        cand = np.concatenate(cand_parts) if cand_parts else np.zeros(
            (0, k), np.int64)
        room = (max_size - sizes[:n_c]).astype(np.int64)
        next_still: list[int] = []
        pl_rows: list[int] = []
        pl_slots: list[int] = []
        pl_items: list[int] = []
        for row, item in enumerate(still):
            for p in cand[row]:
                p = int(p)
                if 0 <= p < n_c and room[p] > 0:
                    cols.append(p, item)
                    room[p] -= 1
                    if use_table:
                        pl_rows.append(p)
                        pl_slots.append(int(sizes[p]))
                        sizes[p] += 1  # the next slot; room bounds it
                        pl_items.append(item)
                    break
            else:
                next_still.append(item)
        placed = len(still) - len(next_still)
        if use_table and placed:
            _spill_table_append(
                mt_d, mcounts_d,
                *(torch.tensor(v, dtype=torch.int64, device=dev)
                  for v in (pl_rows, pl_slots, pl_items)))
            cols._spill_dev = ((c_pad, max_size), mt_d, mcounts_d,
                               int(cols._extra_count.sum()))
        if placed == 0:
            break  # no progress: every leftover's candidates are full
        if placed * 2 < len(still):  # contention: widen the search
            k = min(2 * k, n_c, K_CAP)
        still = next_still
    return still


def _spill_bucket_local(feats, buckets, cols: _Clusters,
                        dropped_idx: list[int], max_size: int) -> list[int]:
    """Item-level rescue inside each dropped item's own bucket."""
    owner = np.empty(feats.shape[0], np.int32)
    for bi, members in enumerate(buckets):
        owner[np.asarray(members, np.int64)] = bi
    bucket_of = {int(i): int(owner[i]) for i in dropped_idx}
    return _spill_rounds(feats, cols, dropped_idx, max_size,
                         item_bucket_of=bucket_of)


def _spill_global(feats, cols: _Clusters, dropped_idx: list[int],
                  max_size: int) -> list[int]:
    """Cross-bucket fallback: the nearest cluster with room anywhere."""
    return _spill_rounds(feats, cols, dropped_idx, max_size)


# -- host tail ------------------------------------------------------------------

def _native_reconstruction(buckets, logs, steps, births, active):
    """Flatten per-bucket state for the native member expansion
    (``ic_reconstruct_members``). Returns (global member indices in
    (bucket, sorted-root) order, per-root sizes, per-root bucket), the
    Python walk's order, or None without the native library."""
    from imageclust_tpu_torch.data.native import native_reconstruct_members

    nb = len(buckets)
    counts = np.asarray([len(b) for b in buckets], np.int32)
    if not counts.sum():
        return None
    B1 = logs.shape[1]
    m_per = np.minimum(steps.astype(np.int64), B1)
    row_mask = np.arange(B1)[None, :] < m_per[:, None]
    flat_logs = logs[row_mask]
    log_off = np.zeros(nb + 1, np.int64)
    log_off[1:] = np.cumsum(m_per)
    counts_off = np.zeros(nb + 1, np.int64)
    counts_off[1:] = np.cumsum(counts)
    sentinel = np.int32(_BIG_I32)
    masked = np.sort(np.where(active, births, sentinel), axis=1)
    n_roots = active.sum(axis=1).astype(np.int64)
    roots_flat = masked[np.arange(masked.shape[1])[None, :]
                        < n_roots[:, None]].astype(np.int32)
    root_off = np.zeros(nb + 1, np.int64)
    root_off[1:] = np.cumsum(n_roots)

    out = native_reconstruct_members(
        flat_logs, log_off, counts, counts_off, roots_flat, root_off)
    if out is None:
        return None
    members_loc, sizes = out
    members_flat = np.concatenate(
        [np.asarray(b, np.int64) for b in buckets if len(b)])
    bases = np.repeat(counts_off[:-1], counts)
    members_glob = members_flat[members_loc.astype(np.int64) + bases]
    return members_glob, sizes, np.repeat(np.arange(nb), n_roots)


def _restamp_logs(logs: np.ndarray, steps: np.ndarray, counts: np.ndarray,
                  bucket_idx: np.ndarray, n: int) -> np.ndarray:
    """Re-stamp the bucket-local merge logs into one global birth space
    (sharded.py:2497-2531): leaf stamps (< count) become item indices,
    internal stamps fresh ids past n, offset by each bucket's cumulative
    merge count."""
    nb, bucket_size = bucket_idx.shape
    steps = steps.astype(np.int32)
    total_merges = int(steps.sum(dtype=np.int64))
    if not total_merges:
        return np.zeros((0, 3), np.int32)
    L = logs.shape[1]
    base = np.empty(nb, np.int32)
    base[0] = n
    np.cumsum(steps[:-1], out=base[1:])
    base[1:] += n
    row_valid = np.arange(L, dtype=np.int32)[None, :] < steps[:, None]
    flat = logs[:, :, :2][row_valid]
    rows = np.repeat(np.arange(nb, dtype=np.int32), steps)
    c_r = counts.astype(np.int32)[rows][:, None]
    leaf = flat < c_r
    gathered = bucket_idx[rows[:, None], np.where(leaf, flat, 0)]
    mapped = np.where(leaf, gathered, base[rows][:, None] + (flat - c_r))
    pos = np.arange(L, dtype=np.int32)[None, :].repeat(nb, 0)[row_valid]
    out = np.empty((total_merges, 3), np.int32)
    out[:, :2] = mapped
    out[:, 2] = base[rows] + pos
    return out


def _bucket_target(count: int, min_size: int, max_size: int) -> int:
    """Per-bucket cluster-count target; ceil(count / max_size) where the
    (min, max) pair is infeasible for this count."""
    try:
        return calculate_optimal_clusters(count, min_size, max_size)
    except Exception:
        return max(1, math.ceil(count / max_size))


def constrained_ward_bucketed(
    embeddings,
    ids: Sequence[str] | None = None,
    *,
    min_size: int = 3,
    max_size: int = 6,
    bucket_size: int = 512,
    kmeans_iters: int = 8,
    update_rule: str = "lance_williams",
    mesh=None,
    seed: int = 0,
    reassign_dropped: bool = True,
    feature_dtype: str = "float32",
    device: str | torch.device | None = None,
) -> ClusterResult:
    """Scalable constrained Ward over k-means buckets on ``device``
    (default ``"cuda"``; raises without a card).

    ``embeddings`` is a numpy array or a torch tensor (a tensor already on
    the device never leaves it). ``reassign_dropped`` (default True here)
    turns on the absorb phase and the spills, so no image is lost unless
    max_size leaves it nowhere to go. The result is columnar; its
    ``phases_s`` holds each phase's host seconds (:func:`_phase`; under a
    ``torch.profiler`` trace each is a ``cluster/<phase>`` range),
    ``host_paths`` says whether placement and member walk ran natively,
    ``n_buckets`` counts buckets after repair.

    ``feature_dtype`` sets the resident matrix: "float32", "bfloat16" (one
    rounding of the inputs; a non-parity mode near ties) or "int8" (inputs
    quantized once by :func:`_feat_int8`, whose scale Ward's merge order
    does not need; an int8 input is used as is).

    ``mesh`` (a :class:`~imageclust_tpu_torch.core.mesh.Mesh`; every rank
    calls with the same arguments) shards the buckets over its ``data``
    ranks on the mesh's device, and every rank returns the same result;
    ``embeddings`` may then be row-sharded (``ShardedRows``). The result's
    ``exchange`` holds this rank's exchange counts (rows and bytes sent)."""
    if feature_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"unknown feature_dtype {feature_dtype!r}")
    mesh = check_mesh(mesh)
    if update_rule not in ("centroid", "lance_williams"):
        raise ValueError(f"unknown update_rule: {update_rule}")
    dev = mesh.device if mesh is not None else resolve_device(device)
    phases_s: dict[str, float] = {}
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}[feature_dtype]
    sharded_in = isinstance(embeddings, ShardedRows)
    if sharded_in:
        if mesh is None:
            raise ValueError("row-sharded embeddings need their mesh=")
        emb = embeddings.local.detach()
    elif isinstance(embeddings, torch.Tensor):
        emb = embeddings.detach().to(dev)
    else:
        arr = np.asarray(embeddings)
        if arr.dtype != np.int8:
            arr = arr.astype(np.float32, copy=False)
        emb = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    if emb.dim() != 2:
        raise ValueError(f"embeddings must be (n, d), got "
                         f"{tuple(emb.shape)}")
    if dt == torch.int8 and emb.dtype != torch.int8:
        with _phase(phases_s, dev, "quantize"):
            feats = _feat_int8(emb, mesh if sharded_in else None)
    else:
        feats = emb.to(dt)
    del emb
    if sharded_in:
        feats = ShardedRows(feats, embeddings.n, mesh)
    n, d = feats.shape
    if ids is None:
        ids = DefaultIds(n)
    if len(ids) != n:
        raise ValueError("ids length must match embeddings")
    calculate_optimal_clusters(n, min_size, max_size)  # global feasibility

    fill = max(min_size, int(bucket_size * 0.75))
    n_buckets = max(1, math.ceil(n / fill))
    if n_buckets == 1:
        whole = feats.gather() if sharded_in else feats
        return constrained_ward(
            whole.to(torch.float32).cpu().numpy(),  # int8 grid values: exact
            list(ids), min_size=min_size, max_size=max_size,
            update_rule=update_rule, reassign_dropped=reassign_dropped,
            mesh=mesh, device=dev)

    # The summarize pass: one K4 launch on the card at k >= 4096; else the
    # tile path, with the need-only mode above _PREF_NEED_ONLY_MIN_WORK
    # (never on row-sharded features: their preference rows are gathered
    # from the summarize pass).
    with _phase(phases_s, dev, "kmeans"):
        if _use_summarize_fused(dev, n_buckets):
            cents_d, assign_d, own_d_d, pref_d = kmeans(
                feats, n_buckets, kmeans_iters, seed, top_k=_TOP_PREF,
                summarize_fused=True)
        else:
            need_only = (n * n_buckets >= _PREF_NEED_ONLY_MIN_WORK
                         and not sharded_in)
            cents_d, assign_d, own_d_d, pref_d = kmeans(
                feats, n_buckets, kmeans_iters, seed,
                top_k=0 if need_only else _TOP_PREF)
    with _phase(phases_s, dev, "bucket-repair"):
        buckets = _repair_buckets_device(assign_d, own_d_d, pref_d,
                                         n_buckets, bucket_size, min_size,
                                         feats=feats, cents=cents_d)
        del assign_d, own_d_d, pref_d, cents_d

    with _phase(phases_s, dev, "bucket-merges"):
        nb = len(buckets)
        if mesh is not None:  # empty buckets pad to whole shards
            buckets = buckets + [[] for _ in range(-nb % mesh.shape["data"])]
            nb = len(buckets)
        counts = np.zeros(nb, np.int32)
        targets = np.zeros(nb, np.int32)
        bucket_idx = np.zeros((nb, bucket_size), np.int32)
        for bi, members in enumerate(buckets):
            c = len(members)
            counts[bi] = c
            targets[bi] = _bucket_target(c, min_size, max_size) if c else 0
            bucket_idx[bi, :c] = members

        exchange = None
        if mesh is not None:
            # owner-aligned: features row-sharded, one all_to_all moves
            # each bucket member to its bucket's rank; nothing replicates
            local = (feats if sharded_in else local_rows(feats, mesh)).local
            (logs, steps, births, _sizes, active), exchange = \
                _all_buckets_mesh(local, mesh, buckets, bucket_size, counts,
                                  targets, max_size, min_size, update_rule,
                                  reassign_dropped)
        else:
            logs, steps, births, _sizes, active = _all_buckets(
                feats, bucket_idx, counts, targets, max_size, min_size,
                update_rule=update_rule, absorb=reassign_dropped)

    dropped_idx: list[int] = []
    with _phase(phases_s, dev, "merge-restamp"):
        merges_arr = _restamp_logs(logs, steps, counts, bucket_idx, n)

    with _phase(phases_s, dev, "reconstruction"):
        rec = _native_reconstruction(buckets, logs, steps, births, active)
        if rec is not None:
            members_glob, sizes_r, root_bucket = rec
            members_glob = np.asarray(members_glob, dtype=np.int64)
            sizes_r = np.asarray(sizes_r, dtype=np.int64)
            valid = sizes_r >= min_size
            if valid.all():
                members_col = members_glob
            else:
                keep_rows = np.repeat(valid, sizes_r)
                members_col = members_glob[keep_rows]
                dropped_idx = members_glob[~keep_rows].tolist()
            offsets_col = np.concatenate([[0], np.cumsum(sizes_r[valid])])
            cols = _Clusters(members_col, offsets_col,
                             np.asarray(root_bucket)[valid])
        else:
            clusters_l: list[list[int]] = []
            bucket_l: list[int] = []
            for bi, members in enumerate(buckets):
                c = len(members)
                if c == 0:
                    continue
                log_b = logs[bi][: int(steps[bi])]
                children = {int(new): (int(hi), int(lo))
                            for hi, lo, new in log_b}
                surviving = sorted(int(b) for b in births[bi][active[bi]])
                for birth in surviving:
                    local = _leaf_indices(birth, c, children)
                    global_members = [int(members[k]) for k in local]
                    if len(global_members) < min_size:
                        dropped_idx.extend(global_members)
                        continue
                    clusters_l.append(global_members)
                    bucket_l.append(bi)
            cols = _Clusters.from_lists(clusters_l, bucket_l)
    if reassign_dropped and dropped_idx:
        with _phase(phases_s, dev, "spill-local"):
            dropped_idx = _spill_bucket_local(feats, buckets, cols,
                                              dropped_idx, max_size)
    if reassign_dropped and dropped_idx:
        with _phase(phases_s, dev, "spill-global"):
            dropped_idx = _spill_global(feats, cols, dropped_idx, max_size)

    with _phase(phases_s, dev, "finalize"):
        members_f, offsets_f = cols.finalize()
    result = ClusterResult(
        merges=merges_arr,
        n_items=n,
        n_clusters_target=sum(int(t) for t in targets),
        members=members_f,
        offsets=offsets_f,
        ids=ids,
        dropped_idx=dropped_idx,
    )
    from imageclust_tpu_torch.data.native import available

    result.n_buckets = nb  # buckets after capacity repair
    result.exchange = exchange  # this rank's exchange counts on a mesh
    result.phases_s = phases_s
    # which host paths ran: the native library's or the Python ones
    result.host_paths = {
        "placement": "native" if available() else "python",
        "reconstruction": "native" if rec is not None else "python"}
    return result
