"""K1: the fused constrained-Ward merge step, and its plain PyTorch twin.

:func:`merge_update_argmin` replaces
``imageclust_tpu/ops/pallas_kernels.py:merge_update_argmin`` (Pallas body
``_merge_step_kernel``). It applies the pending row/column ``sa`` update
``dvec`` to the (n, n) Ward matrix IN PLACE when ``do_update`` is set, then
returns the next feasible pair's ``(dmin, bhi, blo)`` with the Go tie-break
(lexicographically smallest ``(max birth, min birth)`` among the minima).

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/merge_update_argmin.cu``; design notes there): bound by device-memory
bytes, one read of the active rows of D per merge. On a CPU tensor it runs
:func:`merge_update_argmin_plain`, the torch translation of the Pallas body
(pallas_kernels.py:96-119) and its host reduce (:191-198). Both only select
and take exact minima, so they are bit-identical on any finite data. No
other device is accepted, and nothing falls back.

:func:`masked_argmin_pair_plain` is the twin of ``masked_argmin_pair_xla``
(pallas_kernels.py:44): the same reduction without the update.

K3, :func:`merge_update_argmin_batched`, replaces
``pallas_kernels.py:merge_update_argmin_batched`` (body
``_merge_step_kernel_batched`` :202-266, per-bucket reduce :342-350): K1 over
a chunk of C buckets, each with its own pending update, plus the absorb
phase's under-min mask. Its CUDA source is
``csrc/merge_update_argmin_batched.cu``; its twin is
:func:`merge_update_argmin_batched_plain`. It also only selects and takes
exact minima, so kernel and twin are bit-identical.
"""

from __future__ import annotations

import torch

__all__ = [
    "merge_update_argmin",
    "merge_update_argmin_plain",
    "merge_update_argmin_batched",
    "merge_update_argmin_batched_plain",
    "masked_argmin_pair_plain",
    "launches",
    "batched_launches",
]

_STRIPE = 128
_BIG_I32 = 2**31 - 1

# Launches of the CUDA kernel pair by merge_update_argmin (one per call on a
# CUDA tensor). Plain-twin calls are not counted.
launches = 0
# The same count for merge_update_argmin_batched (K3).
batched_launches = 0


def masked_argmin_pair_plain(D, births, sizes, active, max_size,
                             require_under=None):
    """Feasible-pair argmin with the Go tie-break over the whole matrix.
    Returns 0-d tensors (dmin f32, bhi i32, blo i32)."""
    n = D.shape[0]
    act = active > 0
    eye = torch.eye(n, dtype=torch.bool, device=D.device)
    ok = act[:, None] & act[None, :] & ~eye
    ok &= (sizes[:, None] + sizes[None, :]) <= max_size
    if require_under is not None:
        under = sizes < require_under
        ok &= under[:, None] | under[None, :]
    return _lexmin(D, ok, births[:, None], births[None, :], dims=(0, 1))


def _lexmin(D, ok, b_r, b_c, dims):
    """(dmin, m1, m2) over ``dims`` exactly as the Pallas body reduces."""
    inf = torch.tensor(float("inf"), dtype=D.dtype, device=D.device)
    big = torch.tensor(_BIG_I32, dtype=torch.int32, device=D.device)
    e = torch.where(ok, D, inf)
    dmin = torch.amin(e, dim=dims, keepdim=True)
    tie = ok & (e == dmin)
    bhi = torch.maximum(b_r, b_c)
    blo = torch.minimum(b_r, b_c)
    m1 = torch.amin(torch.where(tie, bhi, big), dim=dims, keepdim=True)
    m2 = torch.amin(torch.where(tie & (bhi == m1), blo, big), dim=dims,
                    keepdim=True)
    return dmin.squeeze(dims), m1.squeeze(dims), m2.squeeze(dims)


def merge_update_argmin_plain(D, dvec, sa, do_update, births, sizes, active,
                              max_size):
    """The plain PyTorch version of K1, with the same contract: updates D in
    place and returns (D, dmin, bhi, blo). Runs on any device; the port's
    wrapper uses it only for CPU tensors."""
    n = D.shape[0]
    dev = D.device
    sa = torch.as_tensor(sa, device=dev).reshape(())
    do = torch.as_tensor(do_update, device=dev).reshape(()) != 0
    idx = torch.arange(n, device=dev, dtype=torch.int32)

    # pallas_kernels.py:96-102 — column then row write, gated on do_update
    d_new = torch.where(idx[None, :] == sa, dvec[:, None], D)
    d_new = torch.where(idx[:, None] == sa, dvec[None, :], d_new)
    D.copy_(torch.where(do, d_new, D))

    # :104-119 per 128-row stripe, then the lexicographic reduce :191-198
    g = n // _STRIPE
    act = active > 0
    rows = idx.reshape(g, _STRIPE, 1)
    ok = act.reshape(g, _STRIPE, 1) & act.reshape(1, 1, n) & (rows != idx)
    ok &= (sizes.reshape(g, _STRIPE, 1) + sizes.reshape(1, 1, n)) <= max_size
    p_d, p_hi, p_lo = _lexmin(D.reshape(g, _STRIPE, n), ok,
                              births.reshape(g, _STRIPE, 1),
                              births.reshape(1, 1, n), dims=(1, 2))
    big = torch.tensor(_BIG_I32, dtype=torch.int32, device=dev)
    dmin = torch.amin(p_d)
    at = p_d == dmin
    m1 = torch.amin(torch.where(at, p_hi, big))
    m2 = torch.amin(torch.where(at & (p_hi == m1), p_lo, big))
    return D, dmin, m1, m2


def _check(D, dvec, births, sizes, active, sa, do_update):
    if D.dim() != 2 or D.shape[0] != D.shape[1]:
        raise ValueError(f"D must be square (n, n), got {tuple(D.shape)}")
    n = D.shape[0]
    if n % _STRIPE:
        raise ValueError(f"n must be a multiple of {_STRIPE}, got {n}")
    if D.dtype != torch.float32:
        raise TypeError(f"D must be float32, got {D.dtype}")
    if not D.is_contiguous():
        raise ValueError("D must be contiguous")
    for name, t, dt in (("dvec", dvec, torch.float32),
                        ("births", births, torch.int32),
                        ("sizes", sizes, torch.int32),
                        ("active", active, torch.int32)):
        if t.shape != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != D.device:
            raise ValueError(f"{name} is on {t.device}, D on {D.device}")
    for name, v in (("sa", sa), ("do_update", do_update)):
        if isinstance(v, torch.Tensor):
            if v.numel() != 1 or v.dtype != torch.int32:
                raise TypeError(f"{name} must be one int32, got "
                                f"{v.dtype} {tuple(v.shape)}")
            if v.device != D.device:
                raise ValueError(f"{name} is on {v.device}, D on {D.device}")


def _scalar(v, dev):
    if isinstance(v, torch.Tensor):
        return v.reshape(1)
    return torch.tensor([int(v)], dtype=torch.int32, device=dev)


def merge_update_argmin(D, dvec, sa, do_update, births, sizes, active,
                        max_size: int):
    """K1. D (n, n) f32 contiguous, n % 128 == 0; dvec (n,) f32; births,
    sizes, active (n,) int32; sa, do_update one int32 each (a tensor on D's
    device, or a Python int); max_size a Python int. D is updated in place;
    returns (D, dmin, bhi, blo) as 0-d tensors on D's device, without a host
    synchronisation on CUDA."""
    global launches
    _check(D, dvec, births, sizes, active, sa, do_update)
    if D.device.type == "cpu":
        return merge_update_argmin_plain(D, dvec, sa, do_update, births,
                                         sizes, active, int(max_size))
    if D.device.type != "cuda":
        raise ValueError(f"merge_update_argmin runs on cuda or cpu, "
                         f"not {D.device}")
    from imageclust_tpu_torch.ops._build import load_kernels

    lib = load_kernels()
    dev = D.device
    n = D.shape[0]
    for t in (D, dvec, births, sizes, active):
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned")
    sa_t = _scalar(sa, dev)
    do_t = _scalar(do_update, dev)
    m = n // lib.ic_merge_rows_per_block()
    part_d = torch.empty(m, dtype=torch.float32, device=dev)
    part_i = torch.empty((2, m), dtype=torch.int32, device=dev)
    out_d = torch.empty((), dtype=torch.float32, device=dev)
    out_pair = torch.empty(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ic_merge_update_argmin(
            D.data_ptr(), dvec.data_ptr(), births.data_ptr(),
            sizes.data_ptr(), active.data_ptr(), sa_t.data_ptr(),
            do_t.data_ptr(), n, int(max_size), part_d.data_ptr(),
            part_i[0].data_ptr(), part_i[1].data_ptr(), out_d.data_ptr(),
            out_pair.data_ptr(), stream)
    _raise_on(lib, rc, "merge_update_argmin")
    launches += 1
    return D, out_d, out_pair[0], out_pair[1]


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.ic_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


# -- K3 ---------------------------------------------------------------------

def merge_update_argmin_batched_plain(D, dvec, sa, do_update, births, sizes,
                                      active, max_size: int,
                                      absorb_min: int):
    """The plain PyTorch version of K3 with its contract: per bucket c,
    applies the pending update (column then row ``sa[c]`` set to ``dvec[c]``
    when ``do_update[c]``) to D in place and returns (D, dmin (C,), bhi
    (C,), blo (C,)). ``absorb_min > 0`` keeps only pairs with an under-min
    side. The Pallas body reduces 128-row stripes and then the stripe
    partials; one reduce over each bucket's whole matrix gives the same
    exact minima."""
    C, B, _ = D.shape
    dev = D.device
    idx = torch.arange(B, device=dev, dtype=torch.int32)
    sa = sa.reshape(C, 1, 1)
    do = (do_update.reshape(C, 1, 1) != 0)
    # pallas_kernels.py:231-237
    d_new = torch.where(idx.view(1, 1, B) == sa, dvec[:, :, None], D)
    d_new = torch.where(idx.view(1, B, 1) == sa, dvec[:, None, :], d_new)
    D.copy_(torch.where(do, d_new, D))

    # :239-257
    act = active > 0
    ok = act[:, :, None] & act[:, None, :] & (idx[:, None] != idx[None, :])
    ok &= (sizes[:, :, None] + sizes[:, None, :]) <= max_size
    if absorb_min > 0:
        under = sizes < absorb_min
        ok &= under[:, :, None] | under[:, None, :]
    dmin, m1, m2 = _lexmin(D, ok, births[:, :, None], births[:, None, :],
                           dims=(1, 2))
    return D, dmin, m1, m2


def _check_batched(D, dvec, sa, do_update, births, sizes, active):
    if D.dim() != 3 or D.shape[1] != D.shape[2]:
        raise ValueError(f"D must be (C, B, B), got {tuple(D.shape)}")
    C, B, _ = D.shape
    if D.dtype != torch.float32:
        raise TypeError(f"D must be float32, got {D.dtype}")
    for name, t, shape, dt in (("D", D, (C, B, B), torch.float32),
                               ("dvec", dvec, (C, B), torch.float32),
                               ("births", births, (C, B), torch.int32),
                               ("sizes", sizes, (C, B), torch.int32),
                               ("active", active, (C, B), torch.int32),
                               ("sa", sa, (C,), torch.int32),
                               ("do_update", do_update, (C,), torch.int32)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != D.device:
            raise ValueError(f"{name} is on {t.device}, D on {D.device}")


def merge_update_argmin_batched(D, dvec, sa, do_update, births, sizes,
                                active, max_size: int, absorb_min: int):
    """K3. D (C, B, B) f32 contiguous (any B >= 1); dvec (C, B) f32; births,
    sizes, active (C, B) int32; sa, do_update (C,) int32, all on D's device;
    max_size and absorb_min Python ints (absorb_min <= 0: no absorb mask).
    D is updated in place; returns (D, dmin (C,), bhi (C,), blo (C,)) on
    D's device, without a host synchronisation on CUDA."""
    global batched_launches
    _check_batched(D, dvec, sa, do_update, births, sizes, active)
    if D.device.type == "cpu":
        return merge_update_argmin_batched_plain(
            D, dvec, sa, do_update, births, sizes, active, int(max_size),
            int(absorb_min))
    if D.device.type != "cuda":
        raise ValueError(f"merge_update_argmin_batched runs on cuda or cpu, "
                         f"not {D.device}")
    from imageclust_tpu_torch.ops._build import load_kernels

    lib = load_kernels()
    dev = D.device
    C, B, _ = D.shape
    rows = lib.ic_batched_rows_per_block()
    m = (B + rows - 1) // rows
    part_d = torch.empty(C * m, dtype=torch.float32, device=dev)
    part_i = torch.empty((2, C * m), dtype=torch.int32, device=dev)
    out_d = torch.empty(C, dtype=torch.float32, device=dev)
    out_i = torch.empty((2, C), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ic_merge_update_argmin_batched(
            D.data_ptr(), dvec.data_ptr(), births.data_ptr(),
            sizes.data_ptr(), active.data_ptr(), sa.data_ptr(),
            do_update.data_ptr(), C, B, int(max_size), int(absorb_min),
            part_d.data_ptr(), part_i[0].data_ptr(), part_i[1].data_ptr(),
            out_d.data_ptr(), out_i[0].data_ptr(), out_i[1].data_ptr(),
            stream)
    _raise_on(lib, rc, "merge_update_argmin_batched")
    batched_launches += 1
    return D, out_d, out_i[0], out_i[1]
