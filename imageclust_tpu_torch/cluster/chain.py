"""Nearest-neighbor-chain constrained Ward on PyTorch: exact greedy
semantics in O(n*d) memory, with no n x n distance matrix.

The port of ``imageclust_tpu/cluster/chain.py`` (single device). The exact
engine (:mod:`imageclust_tpu_torch.cluster.ward`) runs the reference's
greedy merge loop (clustering.go:220-246) against a dense Ward matrix, so
it stops at a few thousand items. Ward linkage is *reducible* and the
reference's maxSize "poisoning" (clustering.go:228-234) keeps it so (sizes
only grow, so an infeasible pair stays infeasible). So the
nearest-neighbor-chain algorithm gives the greedy engine's dendrogram
wherever merge distances are distinct, and greedy stopped at k clusters is
the n - k lowest dendrogram nodes: the loops run to exhaustion and
:func:`_cut` cuts on the host.

Two exact loops, picked by ``IMAGECLUST_CHAIN_IMPL`` as in the JAX package
(chain.py:1175):

* ``"rnn"`` (the default): batched reciprocal-NN rounds with a cached
  nearest-neighbor table repaired exactly after each round
  (:func:`_rnn_loop`). The host drives the rounds: one read of the pending
  rows a round (``torch.nonzero``), and of the merged count after a merge
  round. Each round is an (up to 8192) x n x d Gram in tiles of 2048
  columns (:func:`_gram`: float32 on the CPU, float64 sums rounded to
  float32 on the card), plus elementwise passes in float32.
* ``"seq"``: the sequential chain (:func:`_chain_loop`), about 3n steps of
  one (n, d) pass each. The body has no host sync and no data-dependent
  shape (every write is gated with ``torch.where`` on device scalars), so
  on the card it runs as ward.py's loops do: one eager step, then CUDA
  graph replays of :data:`~imageclust_tpu_torch.cluster.ward.
  FOUND_READ_EVERY` steps with one host read of the "go" flag after each.

Same guarantee domain as the JAX package: identical to the greedy engine
wherever merge distances are distinct; tied distances may resolve
differently. This is a scale mode, not the parity mode.

On a mesh (``mesh=``) both loops keep the centroid matrix row-sharded
over the ``data`` ranks (the mesh Embedder's row blocks) with replicated
small state: the rounds scan each rank's column block and combine
(distance, index) pairs across ranks; the chain fetches two rows and
combines two minima per step. Both run eagerly, and both follow the
single device's trajectory on the same Gram values.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Sequence

import numpy as np
import torch

from imageclust_tpu_torch.cluster.ward import (
    FOUND_READ_EVERY,
    ClusterResult,
    DefaultIds,
    _BIG_I32,
    _leaf_indices,
    _pad_len,
    _run_graphed,
    calculate_optimal_clusters,
)
from imageclust_tpu_torch.core.collectives import all_gather_rows, pmin_pair
from imageclust_tpu_torch.core.mesh import (
    ShardedRows,
    check_mesh,
    local_rows,
    owned_rows,
    take_rows,
)
from imageclust_tpu_torch.device import resolve_device

__all__ = ["constrained_ward_chain"]

# per-round row caps (JAX chain.py:503-504): a typical round's invalidation
# set (about 4x the merged pairs) fits in one recompute round
_R_CAP = 8192
_P_CAP = 4096
# columns of one Gram tile (JAX chain.py:545)
_BLOCK = 2048


def _pad_features(x: torch.Tensor, n_pad: int, d_pad: int) -> torch.Tensor:
    """(n, d) features -> a FRESH f32 (n_pad, d_pad) zero-padded buffer.

    Never a view of the caller's features: the loops merge centroids in
    place, and ``x.float()`` of an f32 tensor (or ``torch.from_numpy`` of
    the caller's array) is the caller's memory, which the spill pass and
    the caller still read. Zero columns add exactly 0.0 to every norm and
    dot product and stay zero through centroid averaging."""
    n, d = x.shape
    out = torch.zeros((n_pad, d_pad), dtype=torch.float32, device=x.device)
    out[:n, :d] = x
    return out


def _births0(n_pad: int, n_items: int, dev) -> tuple[torch.Tensor, ...]:
    """(idx, active, sizes, births) of the first state: padding slots are
    inactive with births above every stamp the loops hand out."""
    idx = torch.arange(n_pad, dtype=torch.int32, device=dev)
    active = idx < n_items
    births = torch.where(active, idx, _BIG_I32 - n_pad + idx)
    return idx, active, active.to(torch.int32), births.to(torch.int32)


# -- the sequential NN-chain ----------------------------------------------------

def _chain_start(x: torch.Tensor, n_items: int,
                 n_pad: int | None = None) -> SimpleNamespace:
    """The chain loop's device state from (n_pad, d) padded f32 features
    (JAX chain.py:53-76). Scalars are one-element tensors written in place,
    so the step can be captured in a CUDA graph. On a mesh ``x`` is this
    rank's block and ``n_pad`` the padded total."""
    n_pad = x.shape[0] if n_pad is None else n_pad
    dev = x.device
    idx, active, sizes, births = _births0(n_pad, n_items, dev)
    i64 = torch.int64

    def scalar(v, dtype=i64):
        return torch.full((1,), v, dtype=dtype, device=dev)

    return SimpleNamespace(
        cents=x, sizes=sizes, births=births, active=active,
        blocked=~active, idx=idx.to(i64),
        chain=torch.zeros(n_pad + 1, dtype=i64, device=dev),
        clen=scalar(0), log=torch.zeros((n_pad, 3), dtype=torch.int32,
                                        device=dev),
        heights=torch.zeros(n_pad, dtype=torch.float32, device=dev),
        step=scalar(0), counter=scalar(n_items, torch.int32),
        n_unb=scalar(n_items), go=scalar(n_items >= 2, torch.bool),
        iters=scalar(0))


def _chain_seed(st: SimpleNamespace):
    """The start of a step: seed an empty chain with the lowest-index
    unblocked cluster. Returns (go, chain length, head, predecessor)."""
    go = st.n_unb >= 2
    need_seed = go & (st.clen == 0)
    first = torch.argmax((st.active & ~st.blocked).to(torch.int32)).view(1)
    st.chain[:1].copy_(torch.where(need_seed, first, st.chain[:1]))
    clen = torch.where(need_seed, 1, st.clen)
    top = st.chain.index_select(0, (clen - 1).clamp_min(0))
    prev = st.chain.index_select(0, (clen - 2).clamp_min(0))
    return go, clen, top, prev


def _chain_commit(st: SimpleNamespace, go, clen, top, prev, c_top, c_prev,
                  dmin, e_prev, nn_any, put_cent) -> None:
    """The end of a step, every write gated on device scalars: merge the
    head with its predecessor if they are reciprocal nearest neighbors
    (``e_prev``, the predecessor's distance, equals the minimum ``dmin``:
    the prefer-prev tie-break keeps the chain acyclic), block a head with
    no feasible partner, or push its nearest neighbor ``nn_any`` (the first
    index at the minimum). ``put_cent(keep, c_new, do_merge)`` writes the
    merged centroid."""
    sizes, births = st.sizes, st.births
    found = torch.isfinite(dmin)
    prev_is_min = (clen >= 2) & found & (e_prev <= dmin)
    nn = torch.where(prev_is_min, prev, nn_any)
    do_merge = go & prev_is_min
    do_block = go & ~found
    do_extend = go & found & ~prev_is_min

    keep = torch.minimum(top, prev)
    drop = torch.maximum(top, prev)
    s_top = sizes.index_select(0, top)
    s_b = sizes.index_select(0, prev)
    s_new = s_top + s_b
    c_new = (s_top.to(torch.float32) * c_top + s_b.to(torch.float32)
             * c_prev) / s_new.to(torch.float32)
    b_top = births.index_select(0, top)
    b_prev = births.index_select(0, prev)
    bhi = torch.maximum(b_top, b_prev)
    blo = torch.minimum(b_top, b_prev)

    put_cent(keep, c_new, do_merge)
    sizes.index_copy_(0, keep, torch.where(
        do_merge, s_new, sizes.index_select(0, keep)))
    sizes.index_copy_(0, drop, torch.where(
        do_merge, 0, sizes.index_select(0, drop)))
    births.index_copy_(0, keep, torch.where(
        do_merge, st.counter, births.index_select(0, keep)))
    st.active.index_copy_(0, drop, st.active.index_select(0, drop)
                          & ~do_merge)
    row = torch.stack([bhi, blo, st.counter], dim=1)
    st.log.index_copy_(0, st.step, torch.where(
        do_merge, row, st.log.index_select(0, st.step)))
    st.heights.index_copy_(0, st.step, torch.where(
        do_merge, dmin, st.heights.index_select(0, st.step)))
    st.blocked.index_copy_(0, top, st.blocked.index_select(0, top)
                           | do_block)
    st.chain.index_copy_(0, clen, torch.where(
        do_extend, nn, st.chain.index_select(0, clen)))

    st.clen.copy_(torch.where(do_merge, clen - 2, torch.where(
        do_block, clen - 1, torch.where(do_extend, clen + 1, clen))))
    st.counter.add_(do_merge.to(torch.int32))
    st.step.add_(do_merge.to(torch.int64))
    st.n_unb.sub_((do_merge | do_block).to(torch.int64))
    st.iters.add_(go.to(torch.int64))
    st.go.copy_(st.n_unb >= 2)


def _chain_step(st: SimpleNamespace, max_size: int) -> None:
    """One iteration of the chain (the body of JAX chain.py:102-175): seed
    an empty chain, find the head's nearest feasible cluster, then merge,
    block or push (:func:`_chain_commit`). Every write is gated on device
    scalars; with fewer than two unblocked clusters left ("go" false) the
    step changes nothing."""
    cents, sizes = st.cents, st.sizes
    go, clen, top, prev = _chain_seed(st)

    # Ward distance from the chain head to every cluster, one (n, d) pass,
    # by direct diff-square-sum as in the JAX body
    c_top = cents.index_select(0, top)
    s_top = sizes.index_select(0, top)
    s_top_f = s_top.to(torch.float32)
    diff = cents - c_top
    d2 = torch.sum(diff * diff, dim=1)
    s_j = sizes.to(torch.float32)
    w = (s_top_f * s_j / (s_top_f + s_j)) * d2
    feas = st.active & (st.idx != top) & ((s_top + sizes) <= max_size)
    e = torch.where(feas, w, float("inf"))

    def put_cent(keep, c_new, do_merge):
        cents.index_copy_(0, keep, torch.where(
            do_merge, c_new, cents.index_select(0, keep)))

    _chain_commit(st, go, clen, top, prev, c_top,
                  cents.index_select(0, prev), torch.min(e).view(1),
                  e.index_select(0, prev), torch.argmin(e).view(1), put_cent)


def _chain_loop(x_pad: torch.Tensor, n_items: int, max_size: int):
    """Run the NN-chain to exhaustion (JAX chain.py:1037-1076). On the card
    one eager step, then CUDA graph replays of FOUND_READ_EVERY steps, one
    host read of "go" after each; on the CPU the steps run one by one with
    a read every FOUND_READ_EVERY steps. Returns (log (n_pad, 3) i32
    [birth_hi, birth_lo, new_birth] in chain order, heights (n_pad,) f32,
    merge count, stats)."""
    n_pad = x_pad.shape[0]
    st = _chain_start(x_pad, n_items)

    def body():
        _chain_step(st, max_size)

    # each iteration merges, blocks or extends; pushes are bounded by pops
    # + n, so ~8n iterations bound a correct run: a backstop against a
    # logic fault turning into a hang
    limit = 8 * n_pad + 16
    if bool(st.go) and x_pad.device.type == "cuda":
        _run_graphed(body, x_pad.device, st.go, limit)
    elif bool(st.go):
        for k in range(limit):
            body()
            if (k + 1) % FOUND_READ_EVERY == 0 and not bool(st.go):
                break
    if bool(st.go):
        # a partial log would silently over-fragment the partition
        raise RuntimeError(
            f"NN-chain did not converge within {limit} iterations "
            f"(n={n_items}): loop invariant violated")
    return st.log, st.heights, int(st.step), {
        "impl": "seq", "iterations": int(st.iters)}


def _mesh_chain_step(st: SimpleNamespace, max_size: int) -> None:
    """:func:`_chain_step` with the centroid matrix row-sharded (JAX
    ``_mesh_chain_segment``, chain.py:892-1027): ``st.cents`` is this
    rank's block of rows ``[row0, row0 + rp)``, the small state is
    replicated. A step fetches the head's and its predecessor's rows with
    one (2, d) psum of the owners' rows and zeros, scans the local rows,
    and combines across ranks with one :func:`pmin_pair` of two entries:
    (minimum distance, first global index at it) and the predecessor's
    distance from its owner. Per-row arithmetic and the first-index rule
    are the single device's, so the trajectory is bit-identical to
    :func:`_chain_step`'s on the same inputs."""
    inf = float("inf")
    cents, sizes = st.cents, st.sizes
    rp, row0 = cents.shape[0], st.row0
    go, clen, top, prev = _chain_seed(st)

    li, own = owned_rows(prev, row0, rp)
    both = take_rows(cents, row0, torch.cat([top, prev]), st.mesh)
    c_top = both[:1]
    s_top = sizes.index_select(0, top)
    s_top_f = s_top.to(torch.float32)
    diff = cents - c_top
    d2 = torch.sum(diff * diff, dim=1)
    sizes_l = sizes[row0:row0 + rp]
    s_j = sizes_l.to(torch.float32)
    w = (s_top_f * s_j / (s_top_f + s_j)) * d2
    gidx = st.idx[row0:row0 + rp]
    feas = (st.active[row0:row0 + rp] & (gidx != top)
            & ((s_top + sizes_l) <= max_size))
    e = torch.where(feas, w, inf)
    nn_l = gidx.index_select(0, torch.argmin(e).view(1))
    e_prev_l = torch.where(own, e.index_select(0, li), inf)
    gd, gi = pmin_pair(torch.cat([torch.min(e).view(1), e_prev_l]),
                       torch.cat([nn_l, torch.zeros_like(nn_l)]), st.mesh)

    def put_cent(keep, c_new, do_merge):  # the owner writes its row
        lk, owned = owned_rows(keep, row0, rp)
        cents.index_copy_(0, lk, torch.where(
            do_merge & owned, c_new, cents.index_select(0, lk)))

    _chain_commit(st, go, clen, top, prev, c_top, both[1:], gd[:1], gd[1:],
                  gi[:1], put_cent)


def _mesh_chain_loop(x: ShardedRows, n_items: int, max_size: int):
    """The sequential chain over the mesh (JAX ``_chain_loop(mesh=)``,
    chain.py:1037-1077): each rank holds its block of the (zero-padded)
    rows and replicated small state, and the steps run eagerly (gloo
    collectives cannot be captured in a CUDA graph) with a host read of
    "go" every FOUND_READ_EVERY steps, the same steps on every rank.
    Returns what :func:`_chain_loop` does."""
    mesh = x.mesh
    rp = x.local.shape[0]
    n_pad = rp * mesh.shape["data"]
    st = _chain_start(_pad_features(x.local, rp, x.shape[1]), n_items,
                      n_pad=n_pad)
    st.mesh, st.row0 = mesh, x.row0
    limit = 8 * n_pad + 16  # the single device's backstop
    if bool(st.go):
        for k in range(limit):
            _mesh_chain_step(st, max_size)
            if (k + 1) % FOUND_READ_EVERY == 0 and not bool(st.go):
                break
    if bool(st.go):
        raise RuntimeError(
            f"NN-chain did not converge within {limit} iterations "
            f"(n={n_items}): loop invariant violated")
    return st.log, st.heights, int(st.step), {
        "impl": "seq", "iterations": int(st.iters)}


# -- batched reciprocal-NN rounds (the default loop) -----------------------------
#
# Merging any set of MUTUAL nearest-neighbor pairs, in any order, gives the
# greedy dendrogram wherever merge distances are distinct, and mutual pairs
# are disjoint. The nearest-neighbor table is cached across rounds with
# exact invalidation (JAX chain.py:184-209): after a round merges p pairs,
# rows whose cached partner was consumed and the p new clusters get a full
# recompute; every other row is minimized against the p new clusters only.

def _gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The (len(a), len(b)) f32 Gram tile ``a @ b.T`` (JAX chain.py:239-243
    asks XLA for ``Precision.HIGHEST``). On the CPU an f32 product, which
    rounds as XLA's CPU does. On the card the sums are formed in float64
    and rounded once to float32: cuBLAS's f32 product (TF32 off) errs by up
    to 5.8e-4 at |g| = 552 for d = 512, and at 4096 x 512 that flipped a
    nearest neighbor whose two candidates are 2.4 ulps apart, against the
    exact engine, the sequential chain and the CPU (chip_smoke.py phase
    24 prints the case). A full recompute round takes as long either way
    on an H100."""
    if a.device.type == "cuda":
        return torch.matmul(a.double(), b.double().T).to(torch.float32)
    return torch.matmul(a, b.T)


def _nn_rows(st: SimpleNamespace, unb: torch.Tensor, r_idx: torch.Tensor,
             max_size: int) -> None:
    """Full nearest-feasible-partner recompute for rows ``r_idx``
    (ascending) over every column, in (rows, _BLOCK) tiles (JAX
    chain.py:212-266). Column tiles ascend and an equal later value never
    replaces an earlier one: global first-index argmin."""
    cents, sizes = st.cents, st.sizes
    inf = float("inf")
    rows = st.take(r_idx)
    rsz = sizes.index_select(0, r_idx)
    rnorm = torch.sum(rows * rows, dim=1)
    rs_f = rsz.to(torch.float32)
    bd = torch.full_like(rnorm, inf)
    bn = torch.full_like(r_idx, _BIG_I32)
    for l0 in range(0, st.rp, st.block):  # this rank's columns
        c0 = st.row0 + l0
        cblock = cents[l0:l0 + st.block]
        csz = sizes[c0:c0 + cblock.shape[0]]
        cnorm = torch.sum(cblock * cblock, dim=1)
        g = _gram(rows, cblock)
        d2 = torch.clamp_min(rnorm[:, None] + cnorm[None, :] - 2.0 * g, 0.0)
        cs_f = csz.to(torch.float32)
        w = (rs_f[:, None] * cs_f[None, :]
             / (rs_f[:, None] + cs_f[None, :])) * d2
        gidx = st.idx64[c0:c0 + cblock.shape[0]]
        feas = (unb[c0:c0 + cblock.shape[0]][None, :]
                & (r_idx[:, None] != gidx[None, :])
                & ((rsz[:, None] + csz[None, :]) <= max_size))
        cbd, cbi = torch.min(torch.where(feas, w, inf), dim=1)
        cbn = cbi + c0
        better = (cbd < bd) | ((cbd == bd) & (cbn < bn))
        bd = torch.where(better, cbd, bd)
        bn = torch.where(better, cbn, bn)
    if st.mesh is not None:  # ranks hold ascending column blocks
        bd, bn = pmin_pair(bd, bn, st.mesh)
    st.nn.index_copy_(0, r_idx, bn)
    st.nnd.index_copy_(0, r_idx, bd)


def _nn_update(st: SimpleNamespace, unb: torch.Tensor, new_idx: torch.Tensor,
               max_size: int) -> None:
    """Minimize every row's cached partner against the round's new
    clusters ``new_idx`` (ascending), in (_BLOCK, p) tiles (JAX
    chain.py:269-321); a new distance replaces the cache only if strictly
    smaller, or equal with a smaller index."""
    cents, sizes = st.cents, st.sizes
    inf = float("inf")
    newc = st.take(new_idx)
    newsz = sizes.index_select(0, new_idx)
    nnorm = torch.sum(newc * newc, dim=1)
    ns_f = newsz.to(torch.float32)
    for l0 in range(0, st.rp, st.block):  # this rank's rows
        rows = cents[l0:l0 + st.block]
        sl = slice(st.row0 + l0, st.row0 + l0 + rows.shape[0])
        rsz = sizes[sl]
        rnn = st.nn[sl]
        rnnd = st.nnd[sl]
        rnorm = torch.sum(rows * rows, dim=1)
        g = _gram(rows, newc)
        d2 = torch.clamp_min(rnorm[:, None] + nnorm[None, :] - 2.0 * g, 0.0)
        rs_f = rsz.to(torch.float32)
        w = (rs_f[:, None] * ns_f[None, :]
             / (rs_f[:, None] + ns_f[None, :])) * d2
        gidx = st.idx64[sl]
        feas = (unb[sl][:, None]
                & (gidx[:, None] != new_idx[None, :])
                & ((rsz[:, None] + newsz[None, :]) <= max_size))
        bd, bi = torch.min(torch.where(feas, w, inf), dim=1)
        bn = new_idx.index_select(0, bi)
        better = (bd < rnnd) | ((bd == rnnd) & (bn < rnn))
        st.nn[sl] = torch.where(better, bn, rnn)
        st.nnd[sl] = torch.where(better, bd, rnnd)
    if st.mesh is not None:  # every rank's rows into the replicated cache
        mine = slice(st.row0, st.row0 + st.rp)
        st.nn.copy_(all_gather_rows(st.nn[mine], st.mesh))
        st.nnd.copy_(all_gather_rows(st.nnd[mine], st.mesh))


def _apply_pairs(st: SimpleNamespace, ga: torch.Tensor):
    """One round's merges (JAX chain.py:340-411): pair heads ``ga``
    (ascending; counter stamps follow that order) with their cached
    partners. Returns the new unblocked set, the rows to recompute (new
    clusters and rows whose cached partner was consumed: their cached
    value may be stale-small) and the new-cluster mask."""
    f32 = torch.float32
    sizes, births = st.sizes, st.births
    gb = st.nn.index_select(0, ga)
    keep = torch.minimum(ga, gb)
    dropg = torch.maximum(ga, gb)
    sa = sizes.index_select(0, ga)
    sb = sizes.index_select(0, gb)
    s_new = sa + sb
    ca = st.take(ga)
    cb = st.take(gb)
    s_new_f = torch.clamp_min(s_new, 1).to(f32)
    c_new = (sa.to(f32)[:, None] * ca + sb.to(f32)[:, None] * cb) \
        / s_new_f[:, None]
    # the logged height by direct diff-square-sum, the sequential chain's
    # rounding path
    dvec = ca - cb
    d2 = torch.sum(dvec * dvec, dim=1)
    h = (sa.to(f32) * sb.to(f32) / s_new_f) * d2
    ba = births.index_select(0, ga)
    bb = births.index_select(0, gb)
    p = ga.shape[0]
    ctr = st.counter + torch.arange(p, dtype=torch.int32, device=ga.device)
    pos = st.step + torch.arange(p, dtype=torch.int64, device=ga.device)

    sizes.index_copy_(0, keep, s_new)
    sizes.index_fill_(0, dropg, 0)
    births.index_copy_(0, keep, ctr)
    st.active.index_fill_(0, dropg, False)
    st.log.index_copy_(0, pos, torch.stack(
        [torch.maximum(ba, bb), torch.minimum(ba, bb), ctr], dim=1))
    st.heights.index_copy_(0, pos, h)
    st.put(keep, c_new)
    st.step += p
    st.counter += p

    unblocked = st.active & ~st.blocked
    changed = torch.zeros_like(unblocked)
    changed.index_fill_(0, keep, True)
    changed.index_fill_(0, dropg, True)
    is_keep = torch.zeros_like(unblocked)
    is_keep.index_fill_(0, keep, True)
    # a consumed cached partner: the cached value may be stale-small
    recompute = unblocked & (changed.index_select(0, st.nn) | is_keep)
    return unblocked, recompute, is_keep


def _recompute_round(st: SimpleNamespace, r_idx: torch.Tensor,
                     max_size: int) -> None:
    """A round while rows are pending: a full recompute of the first
    ``_R_CAP`` of them (``r_idx``), which then leave the pending set."""
    _nn_rows(st, st.active & ~st.blocked, r_idx, max_size)
    st.pending.index_fill_(0, r_idx, False)


def _merge_round(st: SimpleNamespace, max_size: int) -> tuple[int, int]:
    """A round with nothing pending (JAX chain.py:457-479): retire rows with
    no feasible partner, merge the first ``_P_CAP`` reciprocal pairs of the
    now valid cache (any subset of reciprocal pairs may merge), or the
    global-minimum row's pair when none is reciprocal, then minimize the
    cache against the new clusters and mark the invalidated rows pending.
    Returns (pairs merged, unblocked clusters left): two host reads."""
    unb = st.active & ~st.blocked
    ar = st.idx64
    finite = torch.isfinite(st.nnd) & unb
    st.blocked |= unb & ~finite
    mutual = finite & (st.nn.index_select(0, st.nn) == ar) & (ar < st.nn)
    ga = torch.nonzero(mutual).flatten()[:st.p_cap]
    if ga.numel() == 0 and bool(finite.any()):
        ga = torch.argmin(torch.where(finite, st.nnd, float("inf"))).view(1)
    p = int(ga.numel())
    if p:
        unb2, recompute, is_keep = _apply_pairs(st, ga)
        q_idx = torch.nonzero(is_keep).flatten()
        _nn_update(st, unb2, q_idx, max_size)
        st.pending = recompute
    alive = int(torch.sum(st.active & ~st.blocked))
    return p, alive


def _rnn_state(x, n_items: int, mesh=None) -> SimpleNamespace:
    """The rounds' first state on ``x``'s device (JAX chain.py:537-567):
    rows padded to a multiple of the Gram tile, columns to a multiple of
    128, every item pending. ``cents`` holds the rows ``[row0, row0 + rp)``
    (all of them on one device); ``take``/``put`` read and write centroid
    rows by global index.

    With ``mesh``, ``x`` is :class:`~imageclust_tpu_torch.core.mesh.
    ShardedRows` and ``cents`` this rank's block of its rows (the
    Embedder's layout, so nothing moves; a ragged last Gram tile); a row
    is read as a psum of its owner's row and zeros (exact), written by its
    owner alone."""
    d = x.shape[1]
    d_pad = -(-d // 128) * 128
    if mesh is None:
        n_pad0 = _pad_len(n_items)
        block = min(_BLOCK, n_pad0)
        n_pad = -(-n_pad0 // block) * block
        cents = _pad_features(x, n_pad, d_pad)
        rp, row0 = n_pad, 0
    else:
        rp, row0 = x.local.shape[0], x.row0
        n_pad = rp * mesh.shape["data"]
        block = min(_BLOCK, rp)
        cents = _pad_features(x.local, rp, d_pad)
    dev = cents.device
    idx, active, sizes, births = _births0(n_pad, n_items, dev)
    take, put = _row_access(cents, row0, mesh)
    return SimpleNamespace(
        cents=cents, rp=rp, row0=row0, mesh=mesh, take=take, put=put,
        sizes=sizes,
        births=births, active=active, blocked=~active,
        log=torch.zeros((n_pad, 3), dtype=torch.int32, device=dev),
        heights=torch.zeros(n_pad, dtype=torch.float32, device=dev),
        step=0, counter=n_items, pending=active.clone(),
        nn=torch.zeros(n_pad, dtype=torch.int64, device=dev),
        nnd=torch.full((n_pad,), float("inf"), device=dev),
        idx64=idx.to(torch.int64), n_pad=n_pad, block=block,
        p_cap=min(_P_CAP, n_pad))


def _row_access(cents: torch.Tensor, row0: int, mesh):
    """(take(idx), put(idx, rows)) of the centroid rows by global index:
    plain indexing on one device; on a mesh, a psum of the owner's rows
    and zeros (exact) and an owner-local write."""
    if mesh is None:
        return (lambda idx: cents.index_select(0, idx),
                lambda idx, v: cents.index_copy_(0, idx, v))

    def put(idx, v):
        li, own = owned_rows(idx, row0, cents.shape[0])
        cents.index_copy_(0, li[own], v[own])

    return lambda idx: take_rows(cents, row0, idx, mesh), put


def _rnn_loop(x, n_items: int, max_size: int, mesh=None):
    """Run reciprocal-NN rounds to exhaustion (JAX chain.py:531-591) on
    ``x``'s device. ``x`` is the UNPADDED (n, d) feature matrix; the state
    (:func:`_rnn_state`) pads it in one fresh buffer. The host reads the
    pending rows each round;
    the loop stops with fewer than 2 unblocked clusters or a merge round
    that merged nothing. Returns (log, heights, merge count, stats) as
    :func:`_chain_loop` does. With ``mesh`` (``x`` row-sharded, JAX
    ``_mesh_rnn_loop``, chain.py:617-891) each rank scans its own column
    block and a (distance, index) combine across ranks keeps the first
    global index at a tie, so the rounds are those of one device on the
    same Gram values; every rank drives the same rounds."""
    st = _rnn_state(x, n_items, mesh)
    r_cap = min(_R_CAP, st.n_pad)
    # every round clears min(r_cap, pending) rows or merges / blocks >= 1
    max_rounds = 4 * n_items + 2 * (n_items // r_cap + 2) + 8
    stats = {"impl": "rnn", "recompute_rounds": 0, "merge_rounds": 0,
             "rows_recomputed": 0}
    alive = n_items
    for _ in range(max_rounds):
        r_idx = torch.nonzero(st.pending).flatten()[:r_cap]
        if r_idx.numel():
            _recompute_round(st, r_idx, max_size)
            stats["recompute_rounds"] += 1
            stats["rows_recomputed"] += int(r_idx.numel())
            done = alive < 2
        else:
            p, alive = _merge_round(st, max_size)
            stats["merge_rounds"] += 1
            done = alive < 2 or p == 0
        if done:
            break
    else:  # pragma: no cover - every round merges >= 1 or blocks the rest
        raise RuntimeError(
            f"reciprocal-NN rounds did not converge (n={n_items})")
    return st.log, st.heights, st.step, stats


def _cut(
    log: np.ndarray,       # (m, 3) [hi, lo, new] birth stamps, chain order
    heights: np.ndarray,   # (m,)
    n_items: int,
    n_target: int,
) -> tuple[list[list[int]], np.ndarray]:
    """Apply the n_items - n_target smallest-height merges (all if fewer) —
    the partition the greedy loop stops at. Returns (clusters, applied log
    row indices in ascending-height order).

    Heights are first MONOTONE-CORRECTED along dendrogram paths
    (h'[parent] = max(h[parent], h'[children])): in exact arithmetic Ward
    has no inversions so this is the identity, but float32 rounding can
    order a parent's recomputed-from-centroids height a few ulps below a
    child's — an uncorrected sort could then cut a parent without its
    child, duplicating its leaves across two output clusters. The stable
    (corrected height, chain order) sort is child-before-parent by
    construction (children precede parents in the chain log)."""
    m = log.shape[0]
    take = min(m, n_items - n_target)
    h = heights.astype(np.float64).copy()
    hmap = {int(new): j for j, (_, _, new) in enumerate(log)}
    for j in range(m):  # children precede parents in chain order
        for child in (int(log[j, 0]), int(log[j, 1])):
            cj = hmap.get(child)
            if cj is not None and h[cj] > h[j]:
                h[j] = h[cj]
    order = np.lexsort((np.arange(m), h))
    children: dict[int, tuple[int, int]] = {}
    roots = set(range(n_items))
    for j in order[:take]:
        hi, lo, new = (int(v) for v in log[j])
        children[new] = (hi, lo)
        roots.discard(hi)
        roots.discard(lo)
        roots.add(new)
    clusters = [_leaf_indices(b, n_items, children) for b in sorted(roots)]
    return clusters, order[:take]


def constrained_ward_chain(
    embeddings,
    ids: Sequence[str] | None = None,
    *,
    min_size: int = 3,
    max_size: int = 6,
    reassign_dropped: bool = True,
    mesh=None,
    device: str | torch.device | None = None,
) -> ClusterResult:
    """Size-constrained Ward via nearest-neighbor chains on ``device``
    (default ``"cuda"``; raises without a card): the greedy engine's
    partition wherever merge distances are distinct, without its O(n^2)
    matrix.

    ``embeddings`` is numpy or a torch tensor (a tensor on the device stays
    there; it is never written). Always the centroid rule, as the reference
    recomputes distances from merged centroids (clustering.go:83-87).
    ``reassign_dropped`` (default True, as in the other scale mode) spills
    under-min clusters' members into the nearest clusters with room instead
    of dropping them (clustering.go:268-271). ``ids=None`` gives the lazy
    ``img_<k>`` ids. The result is columnar; ``merges`` holds the applied
    merges in ascending-height order and ``loop_stats`` the loop's counts
    (rounds, or chain iterations).

    With ``mesh`` (a :class:`~imageclust_tpu_torch.core.mesh.Mesh`; every
    rank calls with the same arguments) the centroid matrix is row-sharded
    over its ``data`` ranks on the mesh's device (``embeddings`` may already
    be ``ShardedRows``): the loops run the single device's trajectory with
    per-rank scans and cross-rank combines, and every rank returns the
    same result.

    The equivalence with the greedy engine holds in exact arithmetic: both
    run float32, and distances within a few ulps of each other can round
    into another order on the two paths (the greedy engine forms singleton
    distances by a Gram, the sequential chain by diff-square-sum)."""
    mesh = check_mesh(mesh)
    dev = mesh.device if mesh is not None else resolve_device(device)
    if isinstance(embeddings, ShardedRows):
        if mesh is None:
            raise ValueError("row-sharded embeddings need their mesh=")
        feats = embeddings.map(lambda t: t.detach().to(torch.float32))
    elif isinstance(embeddings, torch.Tensor):
        feats = embeddings.detach().to(dev, torch.float32)
    else:
        feats = torch.from_numpy(np.ascontiguousarray(
            np.asarray(embeddings, dtype=np.float32))).to(dev)
    if len(feats.shape) != 2:
        raise ValueError(f"embeddings must be (n, d), got "
                         f"{tuple(feats.shape)}")
    n, d = feats.shape
    if ids is None:
        ids = DefaultIds(n)  # lazy workflow.go:140 id scheme
    if len(ids) != n:
        raise ValueError("ids length must match embeddings")

    n_target = calculate_optimal_clusters(n, min_size, max_size)
    if mesh is not None and not isinstance(feats, ShardedRows):
        feats = local_rows(feats, mesh)
    # "rnn" (default): the batched rounds; "seq": the sequential chain, two
    # exact loops the tests hold against each other (JAX chain.py:1175)
    if os.environ.get("IMAGECLUST_CHAIN_IMPL", "rnn") != "seq":
        log, heights, steps, stats = _rnn_loop(feats, n, max_size, mesh)
    elif mesh is not None:
        log, heights, steps, stats = _mesh_chain_loop(feats, n, max_size)
    else:
        log, heights, steps, stats = _chain_loop(
            _pad_features(feats, _pad_len(n), d), n, max_size)
    log = log[:steps].cpu().numpy()
    heights = heights[:steps].cpu().numpy()

    clusters, applied = _cut(log, heights, n, n_target)

    kept: list[list[int]] = []
    dropped_idx: list[int] = []
    for members in clusters:
        if len(members) < min_size:  # clustering.go:268-271
            dropped_idx.extend(members)
            continue
        kept.append(members)

    from imageclust_tpu_torch.cluster.sharded import _Clusters, _spill_global

    cols = _Clusters.from_lists(kept)
    if reassign_dropped and dropped_idx:
        dropped_idx = _spill_global(feats, cols, dropped_idx, max_size)

    members_f, offsets_f = cols.finalize()
    result = ClusterResult(
        merges=log[applied],
        n_items=n,
        n_clusters_target=n_target,
        members=members_f,
        offsets=offsets_f,
        ids=ids,
        dropped_idx=dropped_idx,
    )
    result.loop_stats = stats
    return result
