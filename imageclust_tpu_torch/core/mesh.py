"""The device mesh on ``torch.distributed``: one process per device.

Counterpart of ``imageclust_tpu/core/mesh.py``. JAX runs one controller per
process and sees every device through a ``Mesh``; PyTorch has no virtual
devices, so the port's mesh is one process (rank) per device, every rank
running the same program on the same host inputs (the JAX multi-process
mode). The two axes keep their names and meaning:

* ``data``: the batch and row axis (data-parallel embedding, row blocks of
  the distance matrix, bucket shards of the scale engine),
* ``model``: the tensor-parallel axis of the wide head.

Rank ``r`` sits at ``(data, model) = divmod(r, M)``, the JAX grid
``devices.reshape(data, model)``. Each axis has a process group over the
ranks that share the other coordinate. A row-sharded array is each rank's
local row block (:class:`ShardedRows`): rank ``d`` of ``data`` holds rows
``[d * rows_per, (d + 1) * rows_per)`` of ``rows_per = ceil(n / D)``, the
last block zero-padded, as the JAX package pads to ``ceil(n / D) * D``.

Backends are the caller's: NCCL with a card per rank, gloo on the CPU, and
gloo for ranks that share one card (NCCL refuses two ranks on one device in
one communicator). Nothing here moves to another device or backend when the
one asked for is missing: :func:`create_mesh` raises where the JAX one
falls back to host CPU devices.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from imageclust_tpu_torch.core.collectives import all_gather_rows, psum
from imageclust_tpu_torch.device import resolve_device

__all__ = [
    "Mesh",
    "ShardedRows",
    "axis_size",
    "check_mesh",
    "create_mesh",
    "gather_rows",
    "init_distributed",
    "local_rows",
    "local_stream",
    "owned_rows",
    "row_block",
    "rows_per",
    "take_rows",
]

_AXES = ("data", "model")


def _device_for(device: str, local_rank: int) -> torch.device:
    """The device of a rank: ``cuda:{local_rank % device_count}`` (ranks
    that share a card say so in their device) or the CPU, resolved as
    every single-device entry point resolves its own (TF32 off, bf16
    products reduced in float32), so that a rank computes what one card
    computes."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the mesh on the CPU")
        return resolve_device(
            torch.device("cuda", local_rank % torch.cuda.device_count()))
    if device == "cpu":
        return resolve_device("cpu")
    raise ValueError(f"unsupported mesh device {device!r} (want cuda or cpu)")


def _default_backend(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


def init_distributed(backend: str | None = None,
                     device: str | None = None) -> bool:
    """Join the process group described by torchrun's variables (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), or by
    :func:`imageclust_tpu_torch.parallel.launch_processes`'s (the same
    ranks, a ``file://`` store in ``IMAGECLUST_DIST_INIT``). Returns False
    and does nothing in a single process (no ``RANK``/``WORLD_SIZE``).

    ``backend`` (default ``IMAGECLUST_DIST_BACKEND``, else NCCL for
    ``device="cuda"`` and gloo for the CPU) and ``device`` (default
    ``IMAGECLUST_MP_DEVICE``, else ``"cuda"``) are the caller's: a CUDA
    device without a card raises. Collectives time out after
    ``IMAGECLUST_DIST_TIMEOUT`` seconds (default 600)."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return False
    if dist.is_initialized():
        return True
    device = device or env.get("IMAGECLUST_MP_DEVICE", "cuda")
    backend = (backend or env.get("IMAGECLUST_DIST_BACKEND")
               or _default_backend(device))
    local = int(env.get("LOCAL_RANK", env["RANK"]))
    dev = _device_for(device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = env.get("IMAGECLUST_DIST_INIT", "env://")
    timeout = datetime.timedelta(
        seconds=float(env.get("IMAGECLUST_DIST_TIMEOUT", "600")))
    dist.init_process_group(
        backend=backend, init_method=init, rank=int(env["RANK"]),
        world_size=int(env["WORLD_SIZE"]), timeout=timeout)
    return True


class Mesh:
    """A (data, model) mesh over the ranks of the process group.

    ``shape`` is ``{"data": D, "model": M}``; ``rank`` and ``coords`` (its
    (data, model) position) say where this process sits; ``groups`` holds
    the process group of each axis (None in a world of one process, where
    every collective is the identity); ``device`` is the rank's
    ``torch.device`` and ``backend`` the group's backend."""

    def __init__(self, data: int, model: int, rank: int, device: torch.device,
                 backend: str, groups: dict):
        self.shape = {"data": data, "model": model}
        self.rank = rank
        self.coords = divmod(rank, model)
        self.device = device
        self.backend = backend
        self.groups = groups

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.coords[_AXES.index(axis)]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']},"
                f" rank={self.rank}, device={self.device}, "
                f"backend={self.backend!r})")


def create_mesh(data: int = -1, model: int = 1, *, device: str = "cuda",
                backend: str | None = None) -> Mesh:
    """A (data, model) mesh over the process group's ranks (JAX
    ``create_mesh``). ``data=-1`` takes every rank not claimed by
    ``model``. In a single process, without :func:`init_distributed`, the
    world is this one rank.

    Raises ValueError where the group has too few ranks (the JAX function
    moves to host CPU devices instead), where the world is not D x M, or
    where NCCL would put two ranks on one card; RuntimeError for
    ``device="cuda"`` without a card, or a ``backend`` other than the
    group's."""
    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    rank = dist.get_rank() if init else 0
    have = dist.get_backend() if init else None
    if init and backend is not None and backend != have:
        raise RuntimeError(
            f"mesh backend {backend!r} asked for, but the process group runs "
            f"{have!r}")
    backend = have or backend or _default_backend(device)
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = _device_for(device, local)
    model = max(model, 1)
    if data <= 0:
        if world % model:
            raise ValueError(f"{world} ranks not divisible by model={model}")
        data = world // model
    if data * model > world:
        raise ValueError(
            f"mesh data={data} x model={model} needs {data * model} ranks, "
            f"have {world}")
    if data * model != world:
        raise ValueError(
            f"mesh data={data} x model={model} must cover all {world} ranks "
            "(one process per device)")
    if (backend == "nccl" and dev.type == "cuda"
            and world > torch.cuda.device_count()):
        raise ValueError(
            f"{world} NCCL ranks on {torch.cuda.device_count()} card(s): NCCL "
            "takes one rank per card; ranks that share a card need "
            "backend='gloo'")
    groups = {"data": None, "model": None}
    if init:
        grid = np.arange(world).reshape(data, model)
        d_me, m_me = divmod(rank, model)
        # every rank creates every group, in one order (new_group's rule)
        for m in range(model):
            g = dist.new_group(grid[:, m].tolist())
            if m == m_me:
                groups["data"] = g
        for d in range(data):
            g = dist.new_group(grid[d, :].tolist())
            if d == d_me:
                groups["model"] = g
    return Mesh(data, model, rank, dev, backend, groups)


def axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name]


def rows_per(n: int, mesh: Mesh) -> int:
    """Rows of one block when n rows shard over ``data``."""
    return -(-n // mesh.shape["data"])


def row_block(n: int, mesh: Mesh) -> tuple[int, int]:
    """(first global row, real rows) of this rank's block when n rows shard
    over ``data``: the last blocks may hold fewer real rows, or none."""
    rp = rows_per(n, mesh)
    row0 = mesh.index("data") * rp
    return row0, max(0, min(rp, n - row0))


def owned_rows(idx: torch.Tensor, row0: int, rows: int):
    """(local index, owned) of global row ids ``idx`` in a block of
    ``rows`` rows that starts at ``row0``: the local index clamped into the
    block (safe to read), and whether this rank holds the row."""
    li = idx - row0
    return li.clamp(0, rows - 1), (li >= 0) & (li < rows)


def take_rows(local: torch.Tensor, row0: int, idx: torch.Tensor,
              mesh: Mesh) -> torch.Tensor:
    """Rows ``idx`` (global ids) of a matrix row-sharded over ``data``, of
    which this rank holds ``local`` from global row ``row0``: each owner's
    rows and the other ranks' zeros, summed by one psum (exact), on every
    rank in ``local``'s dtype (summed in float32 below it)."""
    li, own = owned_rows(idx.to(local.device, torch.int64), row0,
                         local.shape[0])
    rows = local.index_select(0, li)
    wide = (rows if rows.dtype in (torch.float32, torch.float64)
            else rows.to(torch.float32))
    return psum(torch.where(own[:, None], wide, 0.0), mesh).to(local.dtype)


class ShardedRows:
    """An (n, ...) array row-sharded over the mesh's ``data`` axis: this
    rank's zero-padded block ``local`` of :func:`rows_per` rows, starting
    at global row ``row0``. The form in which the mesh ``Embedder`` hands
    features to the engines: no rank holds the whole matrix."""

    @classmethod
    def pad(cls, local: torch.Tensor, n: int, mesh: Mesh) -> "ShardedRows":
        """This rank's real rows ``local`` of an n-row array, zero-padded to
        its block."""
        rp = rows_per(n, mesh)
        if local.shape[0] < rp:
            local = torch.cat([local, local.new_zeros(
                (rp - local.shape[0], *local.shape[1:]))])
        return cls(local, n, mesh)

    def __init__(self, local: torch.Tensor, n: int, mesh: Mesh):
        if local.shape[0] != rows_per(n, mesh):
            raise ValueError(
                f"local block has {local.shape[0]} rows, want "
                f"{rows_per(n, mesh)} for n={n} over {mesh.shape['data']}")
        self.local = local
        self.n = n
        self.mesh = mesh
        self.row0 = mesh.index("data") * local.shape[0]

    @property
    def shape(self) -> tuple:
        return (self.n, *self.local.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def n_local(self) -> int:
        """Real (unpadded) rows of this block."""
        return row_block(self.n, self.mesh)[1]

    def take(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (global ids) on every rank (:func:`take_rows`)."""
        return take_rows(self.local, self.row0, idx, self.mesh)

    def __len__(self) -> int:
        return self.n

    def map(self, fn) -> "ShardedRows":
        """``fn`` applied to the local block (a row-wise function)."""
        return ShardedRows(fn(self.local), self.n, self.mesh)

    def gather(self) -> torch.Tensor:
        """The whole (n, ...) array on every rank (an all_gather)."""
        return all_gather_rows(self.local, self.mesh)[:self.n]


def local_rows(host, mesh: Mesh, n: int | None = None) -> ShardedRows:
    """This rank's row block of a host array (or tensor) that every rank
    holds, on the rank's device."""
    t = host if isinstance(host, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(host))
    n = t.shape[0] if n is None else n
    row0, n_local = row_block(n, mesh)
    return ShardedRows.pad(
        t[row0:row0 + n_local].to(mesh.device).contiguous(), n, mesh)


def gather_rows(x: ShardedRows) -> np.ndarray:
    """A row-sharded array back on the host, whole, on every rank."""
    return x.gather().cpu().numpy()


def check_mesh(mesh) -> Mesh | None:
    """``mesh`` itself when it is None or a :class:`Mesh`; TypeError
    otherwise (an entry point's argument check)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be an imageclust_tpu_torch Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def local_stream(chunks, n: int, mesh: Mesh):
    """The parts of a global stream of row chunks (every rank iterates the
    same ``chunks``, n rows in all) that fall in this rank's row block, in
    order."""
    lo, n_local = row_block(n, mesh)
    hi = lo + n_local
    at = 0
    for chunk in chunks:
        c = chunk.shape[0]
        s, e = max(lo, at), min(hi, at + c)
        if s < e:
            yield chunk[s - at:e - at]
        at += c
