"""Size-constrained Ward agglomerative clustering — the exact engine on
PyTorch, driven by the K1 merge kernel.

Counterpart of ``imageclust_tpu/cluster/ward.py``, with the same observable
semantics (the reference's Go engine, clustering.go:198-284):

* the n x n Ward distance matrix is one device tensor (f32 Gram at full
  float32 precision: TF32 is off, see :mod:`imageclust_tpu_torch.device`),
* each merge is one K1 step (:func:`~imageclust_tpu_torch.ops.
  merge_kernels.merge_step`): the pending row/column update of the
  previous merge applied in place, the next feasible pair with the Go
  tie-break (smallest ``(birth_hi, birth_lo)`` among the minimal distances)
  from the kernel's per-row cache, and the integer bookkeeping of the merge
  (sizes, births, active, the log row), gated on ``found``; then the float
  work (the merged centroid and the next pending row) in torch ops,
* slots never move; births reproduce the reference's list order; the
  maxSize rule is a feasibility mask; under-min drop and oversized split run
  on the host from the merge log.

The loop is the PENDING-update loop of the JAX package's
``_merge_loop_fused_impl`` (ward.py:386-480) with the same carry, kept in
place in a :class:`~imageclust_tpu_torch.ops.merge_kernels.MergeState`.
No merge waits on the host: on the card :data:`FOUND_READ_EVERY` steps are
replayed from one CUDA graph, and the host reads ``found`` once a replay
(on the CPU once every :data:`FOUND_READ_EVERY` steps) and stops once it is
false. Steps past the last feasible merge, or past ``n - n_target``
merges (the step limit the kernel gates on), are no-ops, as in the JAX
``while_loop`` body.

There is no size gate: the JAX package's 4096 limit came from TPU VMEM. A
CUDA tensor always runs K1, a CPU tensor its plain twin.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from imageclust_tpu_torch.device import resolve_device
from imageclust_tpu_torch.ops import _build
from imageclust_tpu_torch.ops import merge_kernels as mk

__all__ = [
    "ClusterResult",
    "ConstraintError",
    "DefaultIds",
    "FOUND_READ_EVERY",
    "calculate_optimal_clusters",
    "constrained_ward",
    "pairwise_ward_singleton",
    "ward_update_vector",
]

_BIG_I32 = 2**31 - 1

# Merge steps between two host reads of the loop's `found` flag (on the
# card: the steps captured in one CUDA graph). After the last feasible merge
# the loop runs at most this many gated no-op steps.
FOUND_READ_EVERY = 64


class ConstraintError(ValueError):
    """Raised where the reference returns (nil, false) on impossible sizes
    (clustering.go:168-186)."""


def calculate_optimal_clusters(total_items: int, min_size: int, max_size: int) -> int:
    """Target cluster count heuristic — parity with clustering.go:168-186."""
    if total_items < min_size:
        raise ConstraintError(
            f"total items ({total_items}) less than minimum cluster size ({min_size})"
        )
    n_min = math.ceil(total_items / max_size)
    n_max = math.floor(total_items / min_size)
    if n_min > n_max:
        raise ConstraintError(
            f"cannot satisfy cluster size constraints with total items "
            f"({total_items}), minSize ({min_size}), and maxSize ({max_size})"
        )
    if n_min < n_max:
        return (n_min + n_max) // 2
    return n_min


class DefaultIds:
    """Lazy default item-id sequence: ``ids[k] == f"img_{k}"`` — the
    reference's id scheme (workflow.go:140) without materializing n Python
    strings up front."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, k):
        if isinstance(k, slice):
            return [f"img_{i}" for i in range(*k.indices(self.n))]
        k = int(k)
        if k < 0:
            k += self.n
        if not 0 <= k < self.n:
            raise IndexError(k)
        return f"img_{k}"

    def __iter__(self):
        return (f"img_{i}" for i in range(self.n))


class ClusterResult:
    """Outcome of a constrained-Ward run.

    ``cluster_map`` maps sequential cluster ids to item-id lists in the exact
    order the reference emits (clustering.go:264-280); ``dropped`` lists items
    whose cluster fell below ``min_size`` (clustering.go:268-271); ``merges``
    is the (hi, lo, new) birth-stamp dendrogram.

    Storage is either EAGER (``cluster_map`` dict) or COLUMNAR (``members``
    item-index array + ``offsets``, cluster c =
    ``members[offsets[c]:offsets[c+1]]``); ``cluster_map`` / ``dropped`` /
    ``_index_map`` are lazy views over the columnar form.
    """

    def __init__(
        self,
        cluster_map: dict[int, list[str]] | None = None,
        dropped: list[str] | None = None,
        merges: np.ndarray | None = None,
        n_items: int = 0,
        n_clusters_target: int = 0,
        *,
        members: np.ndarray | None = None,   # concatenated item indices
        offsets: np.ndarray | None = None,   # (n_clusters + 1,)
        ids: "Sequence[str] | None" = None,
        dropped_idx: "np.ndarray | list[int] | None" = None,
    ):
        if cluster_map is None and (members is None or offsets is None
                                    or ids is None):
            raise ValueError(
                "ClusterResult needs cluster_map or (members, offsets, ids)")
        self._cluster_map = cluster_map
        self._dropped = dropped
        self.merges = merges if merges is not None else np.zeros(
            (0, 3), np.int32)
        self.n_items = n_items
        self.n_clusters_target = n_clusters_target
        self._members = members
        self._offsets = offsets
        self._ids = ids
        self._dropped_idx = dropped_idx
        self._index_map_cache: dict[int, list[int]] | None = None

    @property
    def n_clusters(self) -> int:
        """Cluster count WITHOUT materializing the dict."""
        if self._cluster_map is not None:
            return len(self._cluster_map)
        return len(self._offsets) - 1

    @property
    def cluster_map(self) -> dict[int, list[str]]:
        if self._cluster_map is None:
            ids, mem, off = self._ids, self._members, self._offsets
            self._cluster_map = {
                c: [ids[k] for k in mem[off[c]:off[c + 1]]]
                for c in range(len(off) - 1)
            }
        return self._cluster_map

    @property
    def dropped(self) -> list[str]:
        if self._dropped is None:
            self._dropped = [self._ids[k] for k in
                             (self._dropped_idx
                              if self._dropped_idx is not None else ())]
        return self._dropped

    @property
    def _index_map(self) -> dict[int, list[int]]:
        """cluster id -> item indices (set eagerly by the engine or
        materialized lazily from the columnar form)."""
        if self._index_map_cache is None:
            if self._members is None:
                raise AttributeError("_index_map was never populated")
            off = self._offsets
            self._index_map_cache = {
                c: self._members[off[c]:off[c + 1]].tolist()
                for c in range(len(off) - 1)
            }
        return self._index_map_cache

    @_index_map.setter
    def _index_map(self, value: dict[int, list[int]]) -> None:
        self._index_map_cache = value

    def assignments(self) -> np.ndarray:
        """Per-item cluster id (-1 for dropped items), by item position."""
        out = np.full(self.n_items, -1, dtype=np.int64)
        if self._members is not None:
            sizes = np.diff(self._offsets)
            out[self._members] = np.repeat(
                np.arange(len(sizes), dtype=np.int64), sizes)
        else:
            for cid, members in self._index_map.items():
                out[members] = cid
        return out


def pairwise_ward_singleton(x: torch.Tensor) -> torch.Tensor:
    """Initial Ward distances between singletons: 0.5 * ||xi - xj||^2
    (clustering.go:136-145 with |a|=|b|=1), through an f32 Gram product.
    The JAX package runs it at ``Precision.HIGHEST``; here TF32 is off.
    ``x`` is (n, d), or (C, B, d) for C buckets at once."""
    sq = torch.sum(x * x, dim=-1)
    gram = torch.matmul(x, x.transpose(-1, -2))
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * gram
    return 0.5 * torch.clamp_min(d2, 0.0)


def ward_update_vector(
    update_rule: str,
    *,
    sizes_f: torch.Tensor,   # (m,) f32 — sizes of the slots being updated
    s_a_f: torch.Tensor,
    s_b_f: torch.Tensor,
    s_new_f: torch.Tensor,
    d_a: torch.Tensor | None = None,   # (m,) D[sa, ·]
    d_b: torch.Tensor | None = None,   # (m,) D[sb, ·]
    d_ab: torch.Tensor | None = None,  # scalar D[sa, sb]
    cents: torch.Tensor | None = None,  # (m, d) centroids of those slots
    c_new: torch.Tensor | None = None,  # (d,) merged centroid
) -> torch.Tensor:
    """The merged cluster's new distance row, with the JAX package's
    expression tree op for op (ward.py:265-271): each eager op rounds once.

    "centroid" recomputes from centroids as the reference does after every
    merge (clustering.go:83-87); "lance_williams" is the O(1)-per-entry
    recurrence, identical in exact arithmetic. Leading batch dimensions
    (one per bucket) broadcast: cents (..., m, d), c_new (..., d)."""
    if update_rule == "centroid":
        diff = cents - c_new.unsqueeze(-2)
        sq = torch.sum(diff * diff, dim=-1)
        return (s_new_f * sizes_f / (s_new_f + sizes_f)) * sq
    if update_rule == "lance_williams":
        return ((s_a_f + sizes_f) * d_a + (s_b_f + sizes_f) * d_b
                - sizes_f * d_ab) / (s_new_f + sizes_f)
    raise ValueError(f"unknown update_rule: {update_rule}")


def _merge_loop(x: torch.Tensor, n_items: int, n_target: int, max_size: int,
                update_rule: str, merge_step=mk.merge_step,
                eager: bool = False):
    """The pending-update exact loop (JAX ward.py:386-480) on ``x``'s device.

    ``x`` is (n_pad, d) f32 with rows >= n_items as padding. Each step is
    ``merge_step`` on one :class:`~imageclust_tpu_torch.ops.merge_kernels.
    MergeState` (it applies merge k-1's row/column update, finds pair k and
    updates sizes, births, active and the log in place, gated on ``found``),
    then :func:`_float_step` (the merged centroid and the next pending
    row). On a CUDA device the first step runs eagerly on a side stream
    (K1's full fill, and the warm-up of every op), then
    :data:`FOUND_READ_EVERY` steps are captured in one CUDA graph and
    replayed until ``found`` reads false or the step limit is reached; a
    capture that fails raises. On the CPU, or with ``eager=True``, the
    steps run one by one. Returns host arrays (log[:steps], births, sizes,
    active)."""
    if update_rule not in ("centroid", "lance_williams"):
        raise ValueError(f"unknown update_rule: {update_rule}")
    limit = max(n_items - n_target, 0)
    st, cents = _loop_state(x, n_items, limit, max_size)

    def body():
        merge_step(st)
        _float_step(st, cents, update_rule)

    if limit and x.device.type == "cuda" and not eager:
        _run_graphed(body, st.D.device, st.found, limit)
    elif limit:
        for k in range(limit):
            body()
            if (k + 1) % FOUND_READ_EVERY == 0 and not bool(st.found):
                break

    steps = int(st.ctl[mk.CTL_STEP])
    return (st.log[:steps].cpu().numpy(), st.births.cpu().numpy(),
            st.sizes.cpu().numpy(), st.active.cpu().numpy().astype(bool))


def _loop_state(x: torch.Tensor, n_items: int, limit: int, max_size: int):
    """The loop's initial state on ``x``'s device: (MergeState, centroids).
    Padding slots are inactive with births above every stamp the loop
    hands out, as in the JAX package."""
    i32 = torch.int32
    n_pad = x.shape[0]
    idx = torch.arange(n_pad, dtype=i32, device=x.device)
    active0 = idx < n_items
    st = mk.MergeState(
        pairwise_ward_singleton(x).contiguous(),
        births=torch.where(active0, idx, _BIG_I32 - n_pad + idx).to(i32),
        sizes=torch.where(active0, 1, 0).to(i32),
        active=active0.to(i32), counter=n_items, limit=limit,
        max_size=max_size)
    return st, x.clone()


def _float_step(st, cents: torch.Tensor, update_rule: str) -> None:
    """The float work after a step, shared by the kernel's and the twin's
    loops: the merged centroid into ``cents`` (gated on ``found``) and the
    next pending row into ``st.dvec``, written in place. ``sizes`` are
    already the merged ones, which changes the row only at sa (zeroed) and
    sb (never read again: the slot is inactive)."""
    pair = st.pair
    s_a_f, s_b_f, s_new_f = st.pair_f.unbind()
    ab = cents.index_select(0, pair)
    c_new = (s_a_f * ab[0] + s_b_f * ab[1]) / s_new_f
    sizes_f = st.sizes.to(torch.float32)
    if update_rule == "centroid":
        dvec = ward_update_vector(
            update_rule, sizes_f=sizes_f, s_a_f=s_a_f, s_b_f=s_b_f,
            s_new_f=s_new_f, cents=cents, c_new=c_new)
    else:
        rows = st.D.index_select(0, pair)
        dvec = ward_update_vector(
            update_rule, sizes_f=sizes_f, s_a_f=s_a_f, s_b_f=s_b_f,
            s_new_f=s_new_f, d_a=rows[0], d_b=rows[1],
            d_ab=rows[0].index_select(0, pair[1:]))
    cents.index_copy_(0, pair[:1],
                      torch.where(st.found, c_new, ab[0])[None])
    st.dvec.copy_(dvec.index_fill_(0, pair[:1], 0.0))


def _run_graphed(body, dev, go, limit: int, graph=None):
    """Runs ``body`` (one loop step) on the card ``dev``: once eagerly on a
    side stream, then in a CUDA graph of :data:`FOUND_READ_EVERY` steps
    replayed until ``go`` (a one-element device tensor that the steps
    write) reads false or ``limit`` steps have run (the steps past either
    are gated no-ops). One host read of ``go`` per replay. Given the
    ``graph`` that an earlier call returned (the same steps on the same
    tensors), it skips the eager step and the capture and replays that
    graph from the first step. Returns the graph (None if the eager step
    ended the run). The kernel launches captured in the graph count as
    launches at every replay."""
    done = 0
    if graph is None:
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body()
        cur.wait_stream(side)
        done = 1
        if done >= limit or not bool(go):
            return None
        steps = min(FOUND_READ_EVERY, limit - done)
        graph = torch.cuda.CUDAGraph()
        before = _build.captured.copy()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for _ in range(steps):
                body()
        graph.per_replay = _build.captured - before
        graph.steps = steps
    while done < limit:
        graph.replay()
        _build.count_replay(graph.per_replay)
        done += graph.steps
        if not bool(go):
            break
    return graph


def _mesh_merge_loop(x: torch.Tensor, n_items: int, n_target: int,
                     max_size: int, update_rule: str, mesh):
    """The exact loop with the Ward matrix row-sharded over the mesh's
    ``data`` ranks (JAX ``_sharded_merge_loop``, ward.py:518-667).

    ``x`` is the (n_pad, d) padded f32 matrix every rank holds. Each rank
    forms its (n_pad / D, n_pad) row block with one Gram product; the small
    state (sizes, births, active, centroids, the log) is replicated and
    updated identically everywhere. Each merge:

    * the local feasible-pair minimum and, among its ties, the smallest
      (birth_hi, birth_lo) (two int32 passes) packed into one int64 key,
      then one global
      :func:`~imageclust_tpu_torch.core.collectives.pmin_pair`: the Go
      tie-break, as the JAX loop's three scalar ``pmin`` give it;
    * the new distances of this rank's rows to the merged cluster (from
      the replicated centroids, or Lance-Williams from the local columns
      ``sa`` and ``sb``, which symmetry makes the rows, plus one scalar
      psum for ``D[sa, sb]``), written into the local column ``sa``;
    * one (n_pad,) all_gather of those values, which the owner of row
      ``sa`` writes into it.

    Per-merge traffic is O(n) bytes plus scalars, never O(n^2). The steps
    run eagerly (gloo collectives cannot be captured in a CUDA graph), each
    gated on ``found`` on the device; the host reads ``found`` every
    :data:`FOUND_READ_EVERY` steps, the same steps on every rank. Returns
    host arrays (log[:steps], births, sizes, active), as :func:`_merge_loop`
    does."""
    from imageclust_tpu_torch.core.collectives import (
        all_gather_rows,
        pmin_pair,
        psum,
    )
    from imageclust_tpu_torch.core.mesh import owned_rows, row_block

    if update_rule not in ("centroid", "lance_williams"):
        raise ValueError(f"unknown update_rule: {update_rule}")
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    dev = x.device
    n_pad = x.shape[0]
    row0, rp = row_block(n_pad, mesh)  # n_pad splits evenly over data
    gid = row0 + torch.arange(rp, dtype=i64, device=dev)
    xs = x[row0:row0 + rp]
    sq_r = torch.sum(xs * xs, dim=1)
    sq_c = torch.sum(x * x, dim=1)
    Dl = 0.5 * torch.clamp_min(
        sq_r[:, None] + sq_c[None, :] - 2.0 * torch.matmul(xs, x.T), 0.0)

    idx = torch.arange(n_pad, dtype=i64, device=dev)
    active = idx < n_items
    births = torch.where(active, idx, _BIG_I32 - n_pad + idx).to(i32)
    sizes = active.to(i32)
    cents = x.clone()
    limit = max(n_items - n_target, 0)
    log = torch.zeros((max(limit, 1), 3), dtype=i32, device=dev)
    step = torch.zeros((), dtype=i64, device=dev)
    counter = torch.full((), n_items, dtype=i32, device=dev)
    inf = float("inf")
    not_self = gid[:, None] != idx[None, :]

    def merge():
        act_r = active[row0:row0 + rp]
        ok = (act_r[:, None] & active[None, :] & not_self
              & ((sizes[row0:row0 + rp][:, None] + sizes[None, :])
                 <= max_size))
        E = torch.where(ok, Dl, inf)
        dmin = torch.min(E)
        tie = ok & (E == dmin)
        b_r = births[row0:row0 + rp][:, None]
        bhi = torch.maximum(b_r, births[None, :])
        hi = torch.where(tie, bhi, _BIG_I32).min()
        lo = torch.where(tie & (bhi == hi),
                         torch.minimum(b_r, births[None, :]), _BIG_I32).min()
        gd, gkey = pmin_pair(dmin, hi.to(i64) * (1 << 32) + lo, mesh)
        found = torch.isfinite(gd) & (step < limit)
        m1 = (gkey // (1 << 32)).to(i32)
        m2 = (gkey % (1 << 32)).to(i32)
        sa = torch.argmax((births == m1).to(i32)).view(1)
        sb = torch.argmax((births == m2).to(i32)).view(1)
        s_a, s_b = sizes[sa], sizes[sb]
        s_new = s_a + s_b
        s_a_f, s_b_f, s_new_f = s_a.to(f32), s_b.to(f32), s_new.to(f32)
        c_new = (s_a_f * cents[sa] + s_b_f * cents[sb]) / s_new_f
        sizes_l = sizes[row0:row0 + rp].to(f32)
        if update_rule == "centroid":
            dvec = ward_update_vector(
                update_rule, sizes_f=sizes_l, s_a_f=s_a_f, s_b_f=s_b_f,
                s_new_f=s_new_f, cents=cents[row0:row0 + rp],
                c_new=c_new[0])
        else:  # every read local by symmetry, D[sa, sb] from its owner
            col_a = Dl.index_select(1, sa)[:, 0]
            col_b = Dl.index_select(1, sb)[:, 0]
            d_ab = psum(torch.sum(torch.where(gid == sa, col_b, 0.0)), mesh)
            dvec = ward_update_vector(
                update_rule, sizes_f=sizes_l, s_a_f=s_a_f, s_b_f=s_b_f,
                s_new_f=s_new_f, d_a=col_a, d_b=col_b, d_ab=d_ab)
        dvec = torch.where(gid == sa, 0.0, dvec)
        full = all_gather_rows(dvec, mesh)
        Dl.index_copy_(1, sa, torch.where(
            found, dvec, Dl.index_select(1, sa)[:, 0])[:, None])
        la, own = owned_rows(sa, row0, rp)
        Dl.index_copy_(0, la, torch.where(found & own, full, Dl.index_select(
            0, la)[0])[None])
        sizes.index_copy_(0, sa, torch.where(found, s_new, s_a))
        sizes.index_copy_(0, sb, torch.where(found, 0, sizes[sb]))
        births.index_copy_(0, sa, torch.where(found, counter, births[sa]))
        cents.index_copy_(0, sa, torch.where(found, c_new, cents[sa]))
        active.index_copy_(0, sb, active[sb] & ~found)
        si = step.clamp(max=log.shape[0] - 1).view(1)
        log.index_copy_(0, si, torch.where(
            found, torch.stack([m1, m2, counter])[None], log[si]))
        counter.add_(found.to(i32))
        step.add_(found.to(i64))
        return found

    for k in range(limit):
        found = merge()
        if (k + 1) % FOUND_READ_EVERY == 0 and not bool(found):
            break
    steps = int(step)
    return (log[:steps].cpu().numpy(), births.cpu().numpy(),
            sizes.cpu().numpy(), active.cpu().numpy())


def _pad_len(n: int) -> int:
    """Round up to a 128-aligned padded size (the K1 contract; the same
    padding as the JAX package, so births match)."""
    return max(128, int(128 * math.ceil(n / 128)))


def _leaf_indices(birth: int, n_items: int, children: dict[int, tuple[int, int]]) -> list[int]:
    """Expand a cluster birth stamp into its item indices in Go append order:
    indices(hi-child) then indices(lo-child) (clustering.go:29-47)."""
    out: list[int] = []
    stack = [birth]
    while stack:
        node = stack.pop()
        if node < n_items:
            out.append(node)
        else:
            hi, lo = children[node]
            stack.append(lo)
            stack.append(hi)
    return out


def _run_merges(
    x: np.ndarray, n_target: int, max_size: int, update_rule: str,
    device: torch.device, mesh=None, merge_step=mk.merge_step,
    eager: bool = False,
) -> tuple[list[list[int]], np.ndarray]:
    """Run the device loop; return surviving clusters' index lists in Go list
    order (birth order) plus the merge log."""
    n = x.shape[0]
    n_pad = _pad_len(n)
    if mesh is not None:  # whole row blocks of 128 on every rank
        ndev = mesh.shape["data"]
        n_pad = -(-n_pad // (128 * ndev)) * 128 * ndev
    xp = np.zeros((n_pad, x.shape[1]), np.float32)
    xp[:n] = x
    if mesh is not None:
        log, births, _sizes, active = _mesh_merge_loop(
            torch.from_numpy(xp).to(mesh.device), n, n_target, max_size,
            update_rule, mesh)
    else:
        log, births, _sizes, active = _merge_loop(
            torch.from_numpy(xp).to(device), n, n_target, max_size,
            update_rule, merge_step=merge_step, eager=eager)
    children = {int(new): (int(hi), int(lo)) for hi, lo, new in log}
    surviving = sorted(int(b) for b in births[active])
    clusters = [_leaf_indices(b, n, children) for b in surviving]
    return clusters, log


def split_oversized(
    x: np.ndarray,
    members: list[int],
    max_size: int,
    update_rule: str = "centroid",
    device: str | torch.device | None = None,
    merge_step=mk.merge_step,
) -> list[list[int]]:
    """Split one oversized cluster by re-running the merge engine on its
    members with the minSize=1 target — splitCluster semantics
    (clustering.go:295-349, sub-target heuristic at :303)."""
    sub_target = calculate_optimal_clusters(len(members), 1, max_size)
    sub_clusters, _ = _run_merges(
        np.asarray(x, np.float32)[members], sub_target, max_size, update_rule,
        resolve_device(device), merge_step=merge_step,
    )
    return [[members[k] for k in sub] for sub in sub_clusters]


def reassign_dropped_members(
    x: np.ndarray,
    index_map: dict[int, list[int]],
    dropped_idx: list[int],
    max_size: int,
) -> tuple[dict[int, list[int]], list[int]]:
    """Optional post-pass: attach each dropped item to the nearest surviving
    cluster (by centroid) that still has room. The reference silently
    discards under-min clusters (clustering.go:268-271); this recovers them
    without violating max_size. Returns the updated index map and the items
    that still could not be placed."""
    if not dropped_idx or not index_map:
        return index_map, list(dropped_idx)
    cids = sorted(index_map)
    centroids = np.stack([x[index_map[c]].mean(axis=0) for c in cids])
    still_dropped: list[int] = []
    for item in dropped_idx:
        d2 = ((centroids - x[item]) ** 2).sum(axis=1)
        placed = False
        for ci in np.argsort(d2):
            cid = cids[ci]
            if len(index_map[cid]) < max_size:
                index_map[cid].append(item)
                # keep the centroid current so subsequent placements see it
                centroids[ci] = x[index_map[cid]].mean(axis=0)
                placed = True
                break
        if not placed:
            still_dropped.append(item)
    return index_map, still_dropped


def constrained_ward(
    embeddings,
    ids: Sequence[str] | None = None,
    *,
    min_size: int = 3,
    max_size: int = 6,
    update_rule: str = "centroid",
    reassign_dropped: bool = False,
    mesh=None,
    device: str | torch.device | None = None,
) -> ClusterResult:
    """Cluster ``embeddings`` (n, d) under [min_size, max_size] Ward
    semantics on ``device`` (default ``"cuda"``; raises without a card).

    Behavioural equivalent of ``PerformClusteringWithConstraints``
    (clustering.go:198-284). Raises :class:`ConstraintError` where the
    reference returns (nil, false). ``reassign_dropped=True`` replaces the
    reference's silent image loss with nearest-cluster reassignment.
    With ``mesh`` (a :class:`~imageclust_tpu_torch.core.mesh.Mesh`; every
    rank calls with the same inputs) the Ward matrix is row-sharded over
    its ``data`` ranks (:func:`_mesh_merge_loop`) on the mesh's device, and
    every rank returns the same result. ``embeddings`` may then also be
    :class:`~imageclust_tpu_torch.core.mesh.ShardedRows` (gathered: the
    n x n matrix dwarfs the features)."""
    return _constrained_ward(
        embeddings, ids, min_size=min_size, max_size=max_size,
        update_rule=update_rule, reassign_dropped=reassign_dropped,
        mesh=mesh, device=device, merge_step=mk.merge_step)


def _constrained_ward(embeddings, ids, *, min_size, max_size, update_rule,
                      reassign_dropped, mesh, device, merge_step,
                      eager=False):
    """:func:`constrained_ward` with the merge step as a parameter. Only
    tests and the card's smoke run pass anything but K1 here (the plain
    twin, to hold the kernel's loop against it on the same device), or
    ``eager=True``, which runs the loop's steps one by one on the card
    instead of in a CUDA graph (so a graphed loop can be held against an
    eager one)."""
    from imageclust_tpu_torch.core.mesh import ShardedRows, check_mesh

    dev = check_mesh(mesh).device if mesh is not None \
        else resolve_device(device)
    if isinstance(embeddings, ShardedRows):
        embeddings = embeddings.gather()
    if isinstance(embeddings, torch.Tensor):
        embeddings = embeddings.detach().cpu().numpy()
    x = np.asarray(embeddings, dtype=np.float32)
    if x.ndim != 2:
        raise ValueError(f"embeddings must be (n, d), got {x.shape}")
    n = x.shape[0]
    if ids is None:
        ids = [f"img_{i}" for i in range(n)]  # workflow.go:140 id scheme
    if len(ids) != n:
        raise ValueError("ids length must match embeddings")

    n_target = calculate_optimal_clusters(n, min_size, max_size)
    clusters, log = _run_merges(x, n_target, max_size, update_rule, dev,
                                mesh=mesh, merge_step=merge_step, eager=eager)

    # Oversized-split pass (clustering.go:248-262). Unreachable through the
    # public path (the merge loop never exceeds max_size) but preserved.
    final: list[list[int]] = []
    for members in clusters:
        if len(members) > max_size:
            final.extend(split_oversized(x, members, max_size, update_rule,
                                         dev, merge_step))
        else:
            final.append(members)

    index_map: dict[int, list[int]] = {}
    dropped_idx: list[int] = []
    cid = 0
    for members in final:
        if len(members) < min_size:  # clustering.go:268-271
            dropped_idx.extend(members)
            continue
        index_map[cid] = members
        cid += 1

    if reassign_dropped:
        index_map, dropped_idx = reassign_dropped_members(
            x, index_map, dropped_idx, max_size
        )

    cluster_map = {c: [ids[k] for k in mem] for c, mem in index_map.items()}
    result = ClusterResult(
        cluster_map=cluster_map,
        dropped=[ids[k] for k in dropped_idx],
        merges=log,
        n_items=n,
        n_clusters_target=n_target,
    )
    result._index_map = index_map
    return result
