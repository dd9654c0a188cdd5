"""K1: the constrained-Ward merge step, and its plain PyTorch twins.

:func:`merge_update_argmin` replaces
``imageclust_tpu/ops/pallas_kernels.py:merge_update_argmin`` (Pallas body
``_merge_step_kernel``). It applies the pending row/column ``sa`` update
``dvec`` to the (n, n) Ward matrix IN PLACE when ``do_update`` is set, then
returns the next feasible pair's ``(dmin, bhi, blo)`` with the Go tie-break
(lexicographically smallest ``(max birth, min birth)`` among the minima).

:func:`merge_step` is the same kernel as one step of the exact merge loop
(``cluster/ward.py``) on a :class:`MergeState`: the kernel keeps each row's
feasible minimum cached across the loop's calls and rescans only the rows a
merge invalidates, and it also does the loop's integer bookkeeping for the
pair it finds (sizes, births, active, the log row, the counters, the next
pending update), gated on ``found`` and the step limit. Its twin
:func:`merge_step_plain` does that bookkeeping in torch ops after
:func:`merge_update_argmin_plain`; both leave the state bit-identical.

On a CUDA tensor both launch the hand-written Hopper kernel
(``csrc/merge_update_argmin.cu``; design notes there), one launch a call.
On a CPU tensor they run the twins: :func:`merge_update_argmin_plain`, the
torch translation of the Pallas body (pallas_kernels.py:96-119) and its
host reduce (:191-198), and :func:`merge_step_plain`. Kernel and twins only
select, take exact minima and count, so they are bit-identical on any
finite data. No other device is accepted, and nothing falls back.

:func:`masked_argmin_pair_plain` is the twin of ``masked_argmin_pair_xla``
(pallas_kernels.py:44): the same reduction without the update.

K3, :func:`merge_update_argmin_batched`, replaces
``pallas_kernels.py:merge_update_argmin_batched`` (body
``_merge_step_kernel_batched`` :202-266, per-bucket reduce :342-350): K1 over
a chunk of C buckets, each with its own pending update, plus the absorb
phase's under-min mask. :func:`lockstep_step` is the same kernel as one
iteration of the bucketed engine's lockstep loop on a
:class:`LockstepState`, on K1's pattern: per-bucket cached row minima and
the loop's integer bookkeeping in the same launch; its twin is
:func:`lockstep_step_plain`. Its CUDA source is
``csrc/merge_update_argmin_batched.cu``; the stateless twin is
:func:`merge_update_argmin_batched_plain`. It also only selects and takes
exact minima, so kernel and twins are bit-identical.
"""

from __future__ import annotations

import torch

from imageclust_tpu_torch.ops._build import launch, load_kernels

__all__ = [
    "MergeState",
    "merge_step",
    "merge_step_plain",
    "merge_update_argmin",
    "merge_update_argmin_plain",
    "LockstepState",
    "lockstep_step",
    "lockstep_step_plain",
    "merge_update_argmin_batched",
    "merge_update_argmin_batched_plain",
    "masked_argmin_pair_plain",
]

_STRIPE = 128
_BIG_I32 = 2**31 - 1

# The int32 fields of MergeState.ctl, as csrc/merge_update_argmin.cu reads
# and writes them.
CTL_SA = 0            # pending slot of the next step's update
CTL_DO = 1            # the next step applies it
CTL_COUNTER = 2       # next birth stamp
CTL_STEP = 3          # merges performed: the next log row
CTL_LIMIT = 4         # most merges the loop may perform
CTL_FILLED = 5        # the kernel's cache is filled
CTL_TICKET = 6        # the kernel's block ticket (0 between calls)
CTL_RESCANS = 7       # the kernel's rows rescanned in the running call
CTL_RESCAN_TOTAL = 8  # rows rescanned by the kernel's cached calls
CTL_RESCAN_MAX = 9    # most rows rescanned by one cached call
CTL_LEN = 10


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


class MergeState:
    """The exact merge loop's state on one device, updated IN PLACE by every
    :func:`merge_step` (the kernel) or :func:`merge_step_plain` (the twin),
    so a CUDA graph can replay steps on it.

    ``D`` (n, n) f32, ``births``/``sizes``/``active`` (n,) int32 are taken
    as given (not copied). ``dvec`` (n,) f32 is the pending update's row,
    which the loop's float work writes between steps; ``ctl`` the
    ``CTL_*`` fields; ``log`` (max(n - 1, 1), 3) int32 the merge log. Each
    step leaves the pair it found for the float work: ``pair`` (2,) int64
    (sa, sb), ``pair_f`` (3,) f32 (size of sa, size of sb, their sum),
    ``found`` (1,) bool (all zero when nothing merged), and
    ``out_d`` (1,) f32 / ``out_pair`` (2,) int32, K1's (dmin, bhi, blo)
    before the step limit's gate. ``ws`` is the kernel's workspace (the
    per-row cache and its per-block partials), None on the CPU."""

    def __init__(self, D, births, sizes, active, counter: int, limit: int,
                 max_size: int):
        _check(D, D[0], births, sizes, active, 0, 0)  # D[0]: an (n,) f32
        dev = D.device
        n = D.shape[0]
        i32 = torch.int32
        self.D, self.births, self.sizes, self.active = D, births, sizes, active
        self.max_size = int(max_size)
        self.dvec = torch.zeros(n, dtype=torch.float32, device=dev)
        ctl = [0] * CTL_LEN
        ctl[CTL_COUNTER] = int(counter)
        ctl[CTL_LIMIT] = int(limit)
        self.ctl = torch.tensor(ctl, dtype=i32, device=dev)
        self.log = torch.zeros((max(n - 1, 1), 3), dtype=i32, device=dev)
        self.pair = torch.zeros(2, dtype=torch.int64, device=dev)
        self.pair_f = torch.zeros(3, dtype=torch.float32, device=dev)
        self.found = torch.zeros(1, dtype=torch.bool, device=dev)
        self.out_d = torch.zeros(1, dtype=torch.float32, device=dev)
        self.out_pair = torch.zeros(2, dtype=i32, device=dev)
        self.ws = None
        if dev.type == "cuda":
            self.ws = _workspace(n, dev)


def merge_step_plain(st: MergeState) -> None:
    """One step of the exact loop in torch ops, the twin of
    :func:`merge_step`: K1's plain twin, then the loop's integer
    bookkeeping for the pair, gated on ``found`` (a finite dmin, and fewer
    than ``ctl[CTL_LIMIT]`` merges so far). The JAX package's loop body
    (ward.py:386-480) with the slot lookups and gated scatters of the
    port's earlier eager loop. Runs on any device."""
    i32 = torch.int32
    ctl = st.ctl
    _, dmin, m1, m2 = merge_update_argmin_plain(
        st.D, st.dvec, ctl[CTL_SA], ctl[CTL_DO], st.births, st.sizes,
        st.active, st.max_size)
    found = torch.isfinite(dmin) & (ctl[CTL_STEP] < ctl[CTL_LIMIT])
    fi = found.to(i32)
    sa = torch.argmax((st.births == m1).to(i32))
    sb = torch.argmax((st.births == m2).to(i32))
    pair = torch.where(found, torch.stack([sa, sb]), 0)
    s = st.sizes.index_select(0, pair)  # (s_a, s_b)
    s_new = s[0] + s[1]
    sizes_ab = torch.stack([s_new, torch.zeros_like(s_new)])
    st.sizes.index_copy_(0, pair, torch.where(found, sizes_ab, s))
    sa1, sb1 = pair[:1], pair[1:]
    st.active.index_copy_(
        0, sb1, torch.where(found, 0, st.active.index_select(0, sb1)))
    counter = ctl[CTL_COUNTER:CTL_COUNTER + 1]
    st.births.index_copy_(
        0, sa1, torch.where(found, counter, st.births.index_select(0, sa1)))
    step1 = ctl[CTL_STEP:CTL_STEP + 1].to(torch.int64)
    row = torch.stack([m1, m2, counter[0]]).to(i32)[None]
    st.log.index_copy_(
        0, step1, torch.where(found, row, st.log.index_select(0, step1)))
    st.ctl[CTL_COUNTER:CTL_STEP + 1].add_(fi)
    st.ctl[CTL_SA:CTL_DO + 1].copy_(torch.stack([pair[0].to(i32), fi]))
    st.ctl[CTL_FILLED] = 1
    st.pair.copy_(pair)
    st.pair_f.copy_(torch.where(found, torch.stack([s[0], s[1], s_new]),
                                0).to(torch.float32))
    st.found.copy_(found.reshape(1))
    st.out_d.copy_(dmin.reshape(1))
    st.out_pair.copy_(torch.stack([m1, m2]))


def merge_step(st: MergeState) -> None:
    """K1 as one step of the exact loop on ``st`` (see :class:`MergeState`):
    applies the pending update, finds the next feasible pair from the
    kernel's per-row cache (filled by one full scan at the loop's first
    step) and does the loop's integer bookkeeping for it, in one launch on
    the current stream, with no host synchronisation and no allocation, so
    it can be captured in a CUDA graph. On a CPU tensor it runs
    :func:`merge_step_plain`."""
    dev = st.D.device
    if dev.type == "cpu":
        merge_step_plain(st)
        return
    if dev.type != "cuda":
        raise ValueError(f"merge_step runs on cuda or cpu, not {dev}")
    _launch(st.D, st.dvec, st.births, st.sizes, st.active, st.ctl,
            st.max_size, st.ws, st.out_d, st.out_pair, st.log, st.pair,
            st.pair_f, st.found)


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


def _workspace(n: int, dev) -> torch.Tensor:
    nbytes = load_kernels().ic_merge_workspace_bytes(n)
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _launch(D, dvec, births, sizes, active, ctl, max_size, ws, out_d,
            out_pair, log=None, pair=None, pair_f=None, found=None) -> None:
    """One K1 launch on the current stream."""
    loop = [0 if t is None else t.data_ptr()
            for t in (log, pair, pair_f, found)]
    launch("merge_update_argmin", D.device, (D, dvec, births, sizes, active),
           D.data_ptr(), dvec.data_ptr(), births.data_ptr(),
           sizes.data_ptr(), active.data_ptr(), ctl.data_ptr(), D.shape[0],
           int(max_size), ws.data_ptr(), out_d.data_ptr(),
           out_pair.data_ptr(), *loop)


def merge_update_argmin(D, dvec, sa, do_update, births, sizes, active,
                        max_size: int):
    """K1 without a loop. D (n, n) f32 contiguous, n % 128 == 0; dvec (n,)
    f32; births, sizes, active (n,) int32; sa, do_update one int32 each (a
    tensor on D's device, or a Python int); max_size a Python int. D is
    updated in place; returns (D, dmin, bhi, blo) as 0-d tensors on D's
    device, without a host synchronisation on CUDA. The kernel scans every
    active row (its cache is scratch here)."""
    _check(D, dvec, births, sizes, active, sa, do_update)
    if D.device.type == "cpu":
        return merge_update_argmin_plain(D, dvec, sa, do_update, births,
                                         sizes, active, int(max_size))
    if D.device.type != "cuda":
        raise ValueError(f"merge_update_argmin runs on cuda or cpu, "
                         f"not {D.device}")
    dev = D.device
    ctl = torch.zeros(CTL_LEN, dtype=torch.int32, device=dev)
    for field, v in ((CTL_SA, sa), (CTL_DO, do_update)):
        if isinstance(v, torch.Tensor):
            ctl[field:field + 1].copy_(v.reshape(1))
        else:
            ctl[field] = int(v)
    out_d = torch.empty(1, dtype=torch.float32, device=dev)
    out_pair = torch.empty(2, dtype=torch.int32, device=dev)
    _launch(D, dvec, births, sizes, active, ctl, max_size,
            _workspace(D.shape[0], dev), out_d, out_pair)
    return D, out_d[0], out_pair[0], out_pair[1]


# -- K3 ---------------------------------------------------------------------

# The int32 fields of LockstepState.ctl, one row per bucket, as
# csrc/merge_update_argmin_batched.cu reads and writes them.
LCTL_SA = 0            # pending slot of the next call's update
LCTL_DO = 1            # the next call applies it
LCTL_COUNTER = 2       # next birth stamp
LCTL_STEP = 3          # merges performed: the next log row
LCTL_NUM_ACTIVE = 4    # active slots
LCTL_TARGET = 5        # the main phase runs while num_active > target
LCTL_FOUND = 6         # the last running call found a pair
LCTL_FILLED = 7        # the kernel's cache is filled
LCTL_TICKET = 8        # the kernel's block ticket (0 between calls)
LCTL_RESCANS = 9       # the kernel's rows rescanned in the running call
LCTL_RESCAN_TOTAL = 10  # rows rescanned by the kernel's cached calls
LCTL_RESCAN_MAX = 11   # most rows rescanned by one cached call
LCTL_CACHED_CALLS = 12  # running calls that used the cache
LCTL_LEN = 13
# The int32 fields of LockstepState.flags, the chunk's.
LFLAG_ANY_RAN = 0      # some bucket ran in the last call
LFLAG_ITERS = 1        # calls in which some bucket ran, this phase
LFLAG_TICKET = 2       # the kernel's bucket ticket (0 between calls)
LFLAG_RAN_ACC = 3      # the kernel's "ran" in the running call
LFLAG_AMIN = 4         # the phase: -1 main, else the absorb phase's min size
LFLAG_LEN = 5


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


class LockstepState:
    """The bucketed engine's lockstep loop over a chunk of C buckets on one
    device, updated IN PLACE by every :func:`lockstep_step` (the kernel) or
    :func:`lockstep_step_plain` (the twin), so a CUDA graph can replay
    iterations on it.

    ``D`` (C, B, B) f32, ``births``/``sizes``/``active`` (C, B) int32 are
    taken as given (not copied); ``counter``, ``num_active`` and ``target``
    (C,) start the per-bucket counters. ``dvec`` (C, B) f32 is the pending
    update's row, which the loop's float work writes between iterations;
    ``ctl`` (C, LCTL_LEN) int32 the ``LCTL_*`` fields; ``log`` (C,
    max(B - 1, 1), 3) int32 the merge logs; ``flags`` (LFLAG_LEN,) int32 the
    chunk's ``LFLAG_*`` fields, among them the running phase's ``amin``
    (also kept as a Python int): the kernel reads it from device memory,
    so one CUDA graph of loop iterations serves both phases. Each
    iteration leaves, per bucket, the pair
    it merged for the float work: ``pair`` (C, 2) int64 (sa, sb),
    ``pair_f`` (C, 3) f32 (their sizes before the merge and the sum) and
    ``proceed`` (C,) bool, all zero where nothing merged; and ``out_d``
    (C,) f32 / ``out_pair`` (C, 2) int32, K3's (dmin, bhi, blo) for the
    buckets that ran, (+inf, INT32_MAX, INT32_MAX) for the others. ``ws``
    is the kernel's workspace (the per-row cache and the per-block
    partials), None on the CPU."""

    def __init__(self, D, births, sizes, active, counter, num_active,
                 target):
        dev = D.device
        i32 = torch.int32
        self.dvec = torch.zeros(D.shape[:2], dtype=torch.float32, device=dev)
        _check_batched(D, self.dvec, births, sizes, active)
        C, B, _ = D.shape
        self.C, self.B = C, B
        self.D, self.births, self.sizes, self.active = D, births, sizes, active
        self.ctl = torch.zeros((C, LCTL_LEN), dtype=i32, device=dev)
        for field, v in ((LCTL_COUNTER, counter),
                         (LCTL_NUM_ACTIVE, num_active),
                         (LCTL_TARGET, target)):
            self.ctl[:, field] = torch.as_tensor(v, device=dev).to(i32)
        self.ctl[:, LCTL_FOUND] = 1
        self.log = torch.zeros((C, max(B - 1, 1), 3), dtype=i32, device=dev)
        self.pair = torch.zeros((C, 2), dtype=torch.int64, device=dev)
        self.pair_f = torch.zeros((C, 3), dtype=torch.float32, device=dev)
        self.proceed = torch.zeros(C, dtype=torch.bool, device=dev)
        self.out_d = torch.zeros(C, dtype=torch.float32, device=dev)
        self.out_pair = torch.zeros((C, 2), dtype=i32, device=dev)
        self.flags = torch.zeros(LFLAG_LEN, dtype=i32, device=dev)
        self.amin = -1
        self.flags[LFLAG_AMIN] = -1
        self.ws = None
        if dev.type == "cuda":
            self.ws = _batched_workspace(C, B, dev)

    def begin_phase(self, amin: int) -> None:
        """Starts a loop phase, ``amin`` -1 for the main phase (run while
        num_active > target) or the minimum size for the absorb phase (run
        while an active slot is under it; pairs need an under-min side):
        every bucket's ``found`` set, every cache unfilled (the absorb
        phase changes every pair's feasibility), the chunk's counts
        cleared. Device writes only: no host synchronisation."""
        self.amin = int(amin)
        self.ctl[:, LCTL_FOUND] = 1
        self.ctl[:, LCTL_FILLED] = 0
        self.flags.zero_()
        self.flags[LFLAG_AMIN] = self.amin


def lockstep_step_plain(st: LockstepState, max_size: int) -> None:
    """One lockstep iteration in torch ops, the twin of
    :func:`lockstep_step`: which buckets run (JAX's run_fns: the main phase,
    ``st.amin < 0``, while ``found & (num_active > target)``; the absorb
    phase while ``found & any(active & (sizes < amin))``), K3's plain twin
    over every bucket, then the lockstep body's integer bookkeeping
    (sharded.py:705-765 of the JAX package) gated on ``run`` and a finite
    dmin. Runs on any device."""
    i32 = torch.int32
    ctl = st.ctl
    C = st.C
    amin = st.amin
    found = ctl[:, LCTL_FOUND] != 0
    if amin < 0:
        run = found & (ctl[:, LCTL_NUM_ACTIVE] > ctl[:, LCTL_TARGET])
    else:
        run = found & ((st.active > 0) & (st.sizes < amin)).any(dim=1)
    _, dmin, m1, m2 = merge_update_argmin_batched_plain(
        st.D, st.dvec, ctl[:, LCTL_SA], ctl[:, LCTL_DO], st.births,
        st.sizes, st.active, max_size, amin)
    fin = torch.isfinite(dmin)
    proceed = run & fin
    pro = proceed[:, None]
    sa = torch.argmax((st.births == m1[:, None]).to(i32), dim=1)
    sb = torch.argmax((st.births == m2[:, None]).to(i32), dim=1)
    pair = torch.where(pro, torch.stack([sa, sb], dim=1), 0)
    s = st.sizes.gather(1, pair)  # (s_a, s_b) before the merge
    s_new = s[:, 0] + s[:, 1]
    merged = torch.stack([s_new, torch.zeros_like(s_new)], dim=1)
    st.sizes.scatter_(1, pair, torch.where(pro, merged, s))
    sa1, sb1 = pair[:, :1], pair[:, 1:]
    st.active.scatter_(1, sb1, torch.where(pro, 0, st.active.gather(1, sb1)))
    counter = ctl[:, LCTL_COUNTER]
    st.births.scatter_(1, sa1, torch.where(pro, counter[:, None],
                                           st.births.gather(1, sa1)))
    ar = torch.arange(C, device=st.D.device)
    row = ctl[:, LCTL_STEP].clamp(max=st.log.shape[1] - 1).to(torch.int64)
    triple = torch.stack([m1, m2, counter], dim=1).to(i32)
    st.log[ar, row] = torch.where(pro, triple, st.log[ar, row])
    p = proceed.to(i32)
    ctl[:, LCTL_COUNTER] += p
    ctl[:, LCTL_STEP] += p
    ctl[:, LCTL_NUM_ACTIVE] -= p
    ctl[:, LCTL_FOUND] = torch.where(run, fin, found).to(i32)
    ctl[:, LCTL_DO] = torch.where(run, fin.to(i32), ctl[:, LCTL_DO])
    ctl[:, LCTL_SA] = torch.where(proceed, pair[:, 0].to(i32),
                                  ctl[:, LCTL_SA])
    ctl[:, LCTL_FILLED] |= run.to(i32)
    st.pair.copy_(pair)
    st.pair_f.copy_(torch.where(pro, torch.stack([s[:, 0], s[:, 1], s_new],
                                                 dim=1), 0).to(torch.float32))
    st.proceed.copy_(proceed)
    st.out_d.copy_(torch.where(run, dmin, float("inf")))
    st.out_pair.copy_(torch.where(run[:, None], torch.stack([m1, m2], dim=1),
                                  _BIG_I32))
    ran = run.any().to(i32)
    st.flags[LFLAG_ANY_RAN] = ran
    st.flags[LFLAG_ITERS] += ran


def lockstep_step(st: LockstepState, max_size: int) -> None:
    """K3 as one iteration of the lockstep loop on ``st`` in the phase that
    ``st.begin_phase`` started (see :class:`LockstepState`): applies every
    bucket's pending update, finds
    each running bucket's next pair from the kernel's per-row cache (filled
    by one full scan at the bucket's first call of a phase) and does the
    bookkeeping for it, in one launch on the current stream, with no host
    synchronisation and no allocation, so it can be captured in a CUDA
    graph. On a CPU tensor it runs :func:`lockstep_step_plain`."""
    dev = st.D.device
    if dev.type == "cpu":
        lockstep_step_plain(st, max_size)
        return
    if dev.type != "cuda":
        raise ValueError(f"lockstep_step runs on cuda or cpu, not {dev}")
    # amin 0: a loop call reads the phase from st.flags
    _launch_batched(st.D, st.dvec, st.births, st.sizes, st.active, st.ctl,
                    max_size, 0, st.ws, st.out_d, st.out_pair, st.log,
                    st.pair, st.pair_f, st.proceed, st.flags)


def _check_batched(D, dvec, births, sizes, active, sa=None, do_update=None):
    if D.dim() != 3 or D.shape[1] != D.shape[2]:
        raise ValueError(f"D must be (C, B, B), got {tuple(D.shape)}")
    C, B, _ = D.shape
    checks = [("D", D, (C, B, B), torch.float32),
              ("dvec", dvec, (C, B), torch.float32),
              ("births", births, (C, B), torch.int32),
              ("sizes", sizes, (C, B), torch.int32),
              ("active", active, (C, B), torch.int32)]
    if sa is not None:
        checks += [("sa", sa, (C,), torch.int32),
                   ("do_update", do_update, (C,), torch.int32)]
    for name, t, shape, dt in checks:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != D.device:
            raise ValueError(f"{name} is on {t.device}, D on {D.device}")


def _batched_workspace(C: int, B: int, dev) -> torch.Tensor:
    nbytes = load_kernels().ic_lockstep_workspace_bytes(C, B)
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _launch_batched(D, dvec, births, sizes, active, ctl, max_size, amin, ws,
                    out_d, out_pair, log=None, pair=None, pair_f=None,
                    proceed=None, flags=None) -> None:
    """One K3 launch on the current stream."""
    C, B, _ = D.shape
    loop = [0 if t is None else t.data_ptr()
            for t in (log, pair, pair_f, proceed, flags)]
    launch("merge_update_argmin_batched", D.device, (), D.data_ptr(),
           dvec.data_ptr(), births.data_ptr(), sizes.data_ptr(),
           active.data_ptr(), ctl.data_ptr(), C, B, int(max_size), int(amin),
           ws.data_ptr(), out_d.data_ptr(), out_pair.data_ptr(), *loop)


def merge_update_argmin_batched(D, dvec, sa, do_update, births, sizes,
                                active, max_size: int, absorb_min: int):
    """K3 without a loop. D (C, B, B) f32 contiguous (any B >= 1); dvec (C,
    B) f32; births, sizes, active (C, B) int32; sa, do_update (C,) int32,
    all on D's device; max_size and absorb_min Python ints (absorb_min <= 0:
    no absorb mask). D is updated in place; returns (D, dmin (C,), bhi
    (C,), blo (C,)) on D's device, without a host synchronisation on CUDA.
    The kernel scans every active row of every bucket (its cache is scratch
    here)."""
    _check_batched(D, dvec, births, sizes, active, sa, do_update)
    if D.device.type == "cpu":
        return merge_update_argmin_batched_plain(
            D, dvec, sa, do_update, births, sizes, active, int(max_size),
            int(absorb_min))
    if D.device.type != "cuda":
        raise ValueError(f"merge_update_argmin_batched runs on cuda or cpu, "
                         f"not {D.device}")
    dev = D.device
    C, B, _ = D.shape
    ctl = torch.zeros((C, LCTL_LEN), dtype=torch.int32, device=dev)
    ctl[:, LCTL_SA] = sa
    ctl[:, LCTL_DO] = do_update
    out_d = torch.empty(C, dtype=torch.float32, device=dev)
    out_pair = torch.empty((C, 2), dtype=torch.int32, device=dev)
    _launch_batched(D, dvec, births, sizes, active, ctl, max_size,
                    absorb_min, _batched_workspace(C, B, dev), out_d,
                    out_pair)
    return D, out_d, out_pair[:, 0], out_pair[:, 1]
