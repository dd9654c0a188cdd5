"""K2: each bucket's whole Lance-Williams merge loop, and its plain twin.

:func:`merge_loop_whole` replaces ``imageclust_tpu/ops/pallas_kernels.py:
merge_loop_whole`` (Pallas body ``_whole_loop_kernel`` :354-487). For every
bucket c of a chunk it runs the complete constrained-Ward merge loop on the
bucket's (B, B) Ward matrix ``D[c]``:

* main phase: at most B - 1 trips while the last trip found a feasible pair
  and more than ``targets[c]`` clusters are active;
* absorb phase (``absorb_min > 0``): ``found`` is reset, then at most B - 1
  trips while an active cluster is under ``absorb_min``; only pairs with an
  under-min side are feasible.

Each trip merges the feasible pair of smallest Ward distance (ties: the
smallest ``(max birth, min birth)``, the Go scan order) with the
Lance-Williams recurrence. It returns the ``_bucket_merge_loop`` contract:
log (C, max(B - 1, 1), 3) int32, step (C,), births and sizes (C, B) int32
and active (C, B) bool.

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/merge_loop_whole.cu``; design notes there), one block per bucket,
which keeps each row's feasible minimum cached and rescans only the rows a
merge invalidates.
``D`` is the caller's temporary and is updated IN PLACE (rows and columns
of merged slots), on both paths. On a CPU tensor it runs
:func:`merge_loop_whole_plain`, the bucketed counterpart of the vmapped
``_bucket_merge_loop`` (``imageclust_tpu/cluster/sharded.py:599-648``): all
buckets step in lockstep and a bucket whose loop has ended is frozen, as
vmap's while-loop batching rule freezes it. The update is the port's
``ward_update_vector("lance_williams")``, the kernel's expression tree
rounded once per operation (the kernel is built with ``-fmad=false``), so
kernel and twin are bit-identical.
"""

from __future__ import annotations

import torch

from imageclust_tpu_torch.ops._build import launch, load_kernels
from imageclust_tpu_torch.ops.merge_kernels import _lexmin

__all__ = ["merge_loop_whole", "merge_loop_whole_plain"]

_BIG_I32 = 2**31 - 1


def merge_loop_whole_plain(D, counts, targets, max_size: int,
                           absorb_min: int):
    """The plain PyTorch version of K2 (same contract, any device)."""
    # imported here: cluster/ imports this module
    from imageclust_tpu_torch.cluster.ward import ward_update_vector

    C, B, _ = D.shape
    dev = D.device
    i32 = torch.int32
    col = torch.arange(B, dtype=i32, device=dev)
    counts = counts.to(dev, i32)
    targets = targets.to(dev, i32)
    act0 = col[None, :] < counts[:, None]
    sizes = act0.to(i32)
    births = torch.where(act0, col, _BIG_I32 - B + col).to(i32)
    active = act0.clone()
    counter = counts.clone()
    num_active = counts.clone()
    n_log = max(B - 1, 1)
    log = torch.zeros((C, n_log, 3), dtype=i32, device=dev)
    step = torch.zeros(C, dtype=i32, device=dev)
    found = torch.ones(C, dtype=torch.bool, device=dev)
    not_eye = col[:, None] != col[None, :]
    ar = torch.arange(C, device=dev)
    sa_col = lambda s: s.view(C, 1, 1).expand(C, B, 1)  # noqa: E731
    sa_row = lambda s: s.view(C, 1, 1).expand(C, 1, B)  # noqa: E731

    def merge_once(run, amin):
        nonlocal sizes, births, active, counter, num_active, step, found
        ok = active[:, :, None] & active[:, None, :] & not_eye
        ok &= (sizes[:, :, None] + sizes[:, None, :]) <= max_size
        if amin > 0:
            under = sizes < amin
            ok &= under[:, :, None] | under[:, None, :]
        dmin, m1, m2 = _lexmin(D, ok, births[:, :, None],
                               births[:, None, :], dims=(1, 2))
        fin = torch.isfinite(dmin)
        proceed = run & fin
        pro = proceed[:, None]
        sa = torch.argmax((births == m1[:, None]).to(i32), dim=1)
        sb = torch.argmax((births == m2[:, None]).to(i32), dim=1)
        s_a = sizes[ar, sa]
        s_b = sizes[ar, sb]
        s_new = s_a + s_b
        d_a = D[ar, sa]
        d_b = D[ar, sb]
        d_ab = d_a[ar, sb]
        dvec = ward_update_vector(
            "lance_williams", sizes_f=sizes.to(torch.float32),
            s_a_f=s_a.to(torch.float32)[:, None],
            s_b_f=s_b.to(torch.float32)[:, None],
            s_new_f=s_new.to(torch.float32)[:, None],
            d_a=d_a, d_b=d_b, d_ab=d_ab[:, None])
        is_sa = col[None, :] == sa[:, None]
        is_sb = col[None, :] == sb[:, None]
        dvec = torch.where(is_sa, 0.0, dvec)
        # column sa, then row sa (pallas_kernels.py:446-450), where the
        # bucket merged; elsewhere the old values are written back
        old_col = D.gather(2, sa_col(sa))[:, :, 0]
        D.scatter_(2, sa_col(sa), torch.where(pro, dvec, old_col)[:, :, None])
        D.scatter_(1, sa_row(sa), torch.where(pro, dvec, d_a)[:, None, :])

        sizes = torch.where(pro & is_sa, s_new[:, None],
                            torch.where(pro & is_sb, 0, sizes))
        births = torch.where(pro & is_sa, counter[:, None], births)
        active = torch.where(pro & is_sb, False, active)
        row = step.clamp(max=n_log - 1).to(torch.int64)
        triple = torch.stack([m1, m2, counter], dim=1)
        old = log[ar, row]
        log[ar, row] = torch.where(pro, triple, old)
        counter = counter + proceed.to(i32)
        num_active = num_active - proceed.to(i32)
        step = step + proceed.to(i32)
        found = torch.where(run, fin, found)

    for _ in range(B - 1):
        run = found & (num_active > targets)
        if not bool(run.any()):
            break
        merge_once(run, 0)
    if absorb_min > 0:
        found = torch.ones_like(found)
        for _ in range(B - 1):
            run = found & torch.any(active & (sizes < absorb_min), dim=1)
            if not bool(run.any()):
                break
            merge_once(run, absorb_min)
    return log, step, births, sizes, active


def merge_loop_whole(D, counts, targets, max_size: int, absorb_min: int):
    """K2. D (C, B, B) f32 contiguous, updated in place; counts, targets
    (C,) int32 on D's device; max_size and absorb_min Python ints
    (absorb_min <= 0: no absorb phase). The CUDA kernel takes 2 <= B <=
    4096 (its loop state and row-minimum cache live in shared memory, 144
    KB at B = 4096) and raises above.
    Returns (log, step, births, sizes, active) on D's device."""
    if D.dim() != 3 or D.shape[1] != D.shape[2]:
        raise ValueError(f"D must be (C, B, B), got {tuple(D.shape)}")
    C, B, _ = D.shape
    if D.dtype != torch.float32:
        raise TypeError(f"D must be float32, got {D.dtype}")
    if not D.is_contiguous():
        raise ValueError("D must be contiguous")
    for name, t in (("counts", counts), ("targets", targets)):
        if tuple(t.shape) != (C,) or t.dtype != torch.int32:
            raise TypeError(f"{name} must be ({C},) int32, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != D.device:
            raise ValueError(f"{name} is on {t.device}, D on {D.device}")
    if D.device.type == "cpu":
        return merge_loop_whole_plain(D, counts, targets, int(max_size),
                                      int(absorb_min))
    if D.device.type != "cuda":
        raise ValueError(f"merge_loop_whole runs on cuda or cpu, "
                         f"not {D.device}")
    max_b = load_kernels().ic_merge_loop_whole_max_b()
    if not 2 <= B <= max_b:
        raise ValueError(f"merge_loop_whole takes 2 <= B <= {max_b} on "
                         f"CUDA, got B = {B}")
    dev = D.device
    counts = counts.contiguous()
    targets = targets.contiguous()
    log = torch.empty((C, B - 1, 3), dtype=torch.int32, device=dev)
    step = torch.empty(C, dtype=torch.int32, device=dev)
    state = torch.empty((3, C, B), dtype=torch.int32, device=dev)
    launch("merge_loop_whole", dev, (), D.data_ptr(), counts.data_ptr(),
           targets.data_ptr(), C, B, int(max_size), int(absorb_min),
           log.data_ptr(), step.data_ptr(), state[0].data_ptr(),
           state[1].data_ptr(), state[2].data_ptr())
    return log, step, state[0], state[1], state[2] > 0
