"""The collectives of the mesh engines, and their counters.

The JAX package writes its collectives inside ``shard_map`` bodies
(``psum``, ``pmin``, ``all_gather``, ``all_to_all``); here they are
explicit calls over an axis's process group, and every mesh engine calls
only these wrappers:

* :func:`psum` and :func:`pmax`: ``all_reduce`` (sum, max),
* :func:`pmin_pair`: the elementwise lexicographic (distance, index)
  minimum across ranks, which keeps the first global index at a tie (the
  JAX loops ``pmin`` the distance and then the index in turn),
* :func:`all_gather_rows`: blocks concatenated along dim 0 in rank order,
* :func:`all_to_all_rows`: block ``j`` of dim 0 to rank ``j`` of the axis,
* :func:`broadcast`, and :func:`broadcast_object` / :func:`gather_objects`
  for small Python values; :func:`on_rank` runs a call on one rank and
  hands its result, or its error, to every rank.

Without a process group (a world of one process) each is the identity;
an initialized group runs its collective even with one rank (an NCCL
world of one exercises the backend). Each wrapper counts its calls and
the bytes it sends (the local payload) into :data:`COUNTERS`.

Under gloo, ranks that share a card pass their CUDA tensors to gloo
itself, which stages them through the host: on an H100 it took every
collective used here with the right values, in and outside autograd's
backward (``chip_smoke.py`` phase 28 checks each raw collective on the
card every run and fails where one is refused or wrong). The host seconds
spent inside the collectives are counted in ``COUNTERS.seconds``: under
gloo, whose collectives block the host, that is their whole cost, the
staging included; under NCCL only the launch.
"""

from __future__ import annotations

import contextlib
import pickle
import time

import torch
import torch.distributed as dist

from imageclust_tpu_torch.utils.metrics import CollectiveCounters

__all__ = ["COUNTERS", "all_gather_rows",
           "all_to_all_rows", "broadcast", "broadcast_object",
           "gather_objects", "on_rank", "pmax", "pmin_pair",
           "psum"]

COUNTERS = CollectiveCounters()

_I64_MAX = torch.iinfo(torch.int64).max


def _group(mesh, axis: str | None):
    """(process group, its size): the axis's group, or the world's. The
    group is None where no process group exists (a world of one process),
    and every wrapper is then the identity; an initialized group runs its
    collective even with one rank, so that a world of one rank over NCCL
    exercises the backend."""
    if not dist.is_initialized():
        return None, 1
    if axis is None:
        return dist.group.WORLD, mesh.size
    return mesh.groups[axis], mesh.shape[axis]


@contextlib.contextmanager
def _timed():
    t0 = time.perf_counter()
    yield
    COUNTERS.seconds += time.perf_counter() - t0


def psum(x: torch.Tensor, mesh, axis: str | None = "data") -> torch.Tensor:
    """The sum of ``x`` over ``axis``'s ranks (every rank gets it)."""
    group, _ = _group(mesh, axis)
    COUNTERS.add("psum", x.numel() * x.element_size())
    if group is None:
        return x
    out = x.contiguous().clone()
    with _timed():
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def pmax(x: torch.Tensor, mesh, axis: str | None = "data") -> torch.Tensor:
    """The elementwise largest ``x`` over ``axis``'s ranks (every rank gets
    it)."""
    group, _ = _group(mesh, axis)
    COUNTERS.add("pmax", x.numel() * x.element_size())
    if group is None:
        return x
    out = x.contiguous().clone()
    with _timed():
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_gather_rows(x: torch.Tensor, mesh,
                    axis: str | None = "data") -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along dim 0 in rank
    order of ``axis``."""
    COUNTERS.add("all_gather", x.numel() * x.element_size())
    return _gather(x, mesh, axis)


def _gather(x: torch.Tensor, mesh, axis: str | None) -> torch.Tensor:
    group, size = _group(mesh, axis)
    if group is None:
        return x
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    with _timed():
        dist.all_gather(parts, src, group=group)
    return torch.cat(parts)


def all_to_all_rows(x: torch.Tensor, mesh,
                    axis: str | None = "data") -> torch.Tensor:
    """``x`` is (size, ...): block ``j`` goes to rank ``j`` of ``axis``;
    the result's block ``j`` came from rank ``j``."""
    group, size = _group(mesh, axis)
    if x.shape[0] != size:
        raise ValueError(f"all_to_all_rows wants dim 0 = {size}, got "
                         f"{tuple(x.shape)}")
    COUNTERS.add("all_to_all", x.numel() * x.element_size())
    if group is None:
        return x
    src = x.contiguous()
    out = torch.empty_like(src)
    with _timed():
        dist.all_to_all_single(out, src, group=group)
    return out


def pmin_pair(d: torch.Tensor, idx: torch.Tensor, mesh,
              axis: str | None = "data"):
    """Elementwise across ``axis``'s ranks: the smallest float32 ``d`` and,
    among the ranks that hold it, the smallest int64 ``idx`` (one
    all_gather of both, packed as int64). Returns (d, idx)."""
    group, _ = _group(mesh, axis)
    COUNTERS.add("pmin_pair", d.numel() * 16)
    if group is None:
        return d, idx
    packed = torch.stack([d.to(torch.float32).view(torch.int32).to(
        torch.int64), idx.to(torch.int64)])
    g = _gather(packed[None], mesh, axis)  # (size, 2, ...)
    ds = g[:, 0].to(torch.int32).view(torch.float32)
    dmin = torch.min(ds, dim=0).values
    imin = torch.min(torch.where(ds == dmin, g[:, 1], _I64_MAX), dim=0).values
    return dmin, imin


def broadcast(x: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank of the world."""
    group, _ = _group(mesh, None)
    COUNTERS.add("broadcast", x.numel() * x.element_size())
    if group is None:
        return x
    out = x.contiguous().clone()
    with _timed():
        dist.broadcast(out, src=src, group=group)
    return out


def broadcast_object(obj, mesh, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank of the world."""
    group, _ = _group(mesh, None)
    COUNTERS.add("broadcast_object",
                 len(pickle.dumps(obj)) if mesh.rank == src else 0)
    if group is None:
        return obj
    box = [obj]
    with _timed():
        dist.broadcast_object_list(box, src=src)
    return box[0]


def on_rank(fn, mesh, src: int = 0):
    """``fn()`` run on rank ``src`` alone, its result on every rank of the
    world. When it raises on ``src``, the error reaches every rank: ``src``
    raises its own, the others a RuntimeError that names it (they would
    otherwise wait in the broadcast until the group's timeout)."""
    box = None
    if mesh.rank == src:
        try:
            box = (True, fn())
        except Exception as exc:
            broadcast_object((False, f"{type(exc).__name__}: {exc}"), mesh,
                             src)
            raise
    ok, value = broadcast_object(box, mesh, src)
    if not ok:
        raise RuntimeError(f"rank {src} failed: {value}")
    return value


def gather_objects(obj, mesh, axis: str | None = "data") -> list:
    """Every rank's picklable ``obj`` of ``axis``, in rank order."""
    group, size = _group(mesh, axis)
    COUNTERS.add("gather_objects", len(pickle.dumps(obj)))
    if group is None:
        return [obj]
    out = [None] * size
    with _timed():
        dist.all_gather_object(out, obj, group=group)
    return out
