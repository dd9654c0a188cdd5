"""K4: the fused nearest-centroid top-k scan, and its plain twin.

:func:`pref_topk_block` replaces
``imageclust_tpu/ops/pallas_kernels.py:pref_topk_block`` (Pallas body
``_pref_topk_kernel``). For rows (n, d) and centroids (k, d) of one
residency dtype (float32, bfloat16 or int8) and ``cnorms`` (k,), the f32
squared norms of the stored centroids, it returns per row the ``kk``
centroids of smallest ``max(|x|² + |c|² − 2⟨x, c⟩, 0)``, ascending, ties by
ascending centroid index (``lax.top_k``'s order), as (n, kk) int32 indices
and the matching (n, kk) f32 distances: column 0 is the row's assignment
and own distance, which the bucketed engine's fused summarize uses.

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/pref_topk_block.cu``; design notes there): one pass over the rows,
``wgmma`` grams fed by TMA for bf16 (f32 accumulate) and int8 (s32
accumulate), a register-blocked IEEE f32 gram for f32, a top-k epilogue
held in registers; the (n, k) score matrix never reaches device memory. On
a CPU tensor it runs :func:`pref_topk_block_plain`, the Pallas body in
plain torch. The kernel sums each row's squared norm itself before its
centroid tiles (as the Pallas body does from its row block); the twin
takes :func:`row_norms`. The summation orders of the norms and the gram
are the only differences between them: on integer-valued data they are
bit-identical, on other data they can differ only at near ties. No other
device is accepted, and nothing falls back.

The JAX wrapper pads d to 128 lanes and k to its 512-row chunks with +inf
norms because of the TPU's tiling. The Hopper kernel's copies zero-fill
past d, n and k themselves; the wrapper only hands bf16 and int8
centroids whose rows are not a multiple of 16 bytes over as a zero-padded
copy, since TMA needs 16-byte-aligned rows (:func:`tma_centroids`; zeros
add nothing to products or norms), and the centroid norms with +inf up to
the kernel's next 128-centroid tile, so the kernel needs no bounds test
on its columns. The rows are never copied. It keeps up to 8 per row (the
JAX kernel 128), what the bucketed engine asks for.

The module also holds the two rules of the stored feature values that the
engine, the embedder and the pipeline share: :func:`to_grid` (the int8
grid) and :func:`row_norms` (f32 squared norms of stored values).
"""

from __future__ import annotations

import torch

from imageclust_tpu_torch.ops._build import launch

__all__ = ["pref_topk_block", "pref_topk_block_plain", "row_norms", "gram",
           "to_grid", "tma_centroids", "MAX_KK"]

MAX_KK = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_NORM_BLOCK = 1 << 16  # rows per row-norm reduction
_TILE_BYTES = 3 << 29  # the twin's (rows, k) tile, capped as _kmeans_block's
_SLAB_BYTES = 128  # the kernel's k-slab; padded centroid rows are multiples
_TILE_COLS = 128  # the kernel's centroid tile; its norms are read padded


def to_grid(x: torch.Tensor, scale=1.0) -> torch.Tensor:
    """int8 grid values of ``x``: clip(round(x / scale), -127, 127) in f32
    (round half to even, as ``jnp.round``). ``scale`` is a float or an f32
    tensor; 1.0 rounds values already on the grid's scale."""
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -127,
                       127).to(torch.int8)


def row_norms(x: torch.Tensor) -> torch.Tensor:
    """f32 squared norms of the stored values of ``x`` along its last axis,
    reduced in fixed blocks along the first, so every caller gets the same
    bits for a row whatever the number of rows is."""
    parts = [torch.sum(torch.square(x[s:s + _NORM_BLOCK].to(torch.float32)),
                       dim=-1)
             for s in range(0, x.shape[0], _NORM_BLOCK)]
    if not parts:
        return torch.zeros(x.shape[:-1], dtype=torch.float32,
                           device=x.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) f32 inner products of the rows of ``a`` (m, d) and ``b``
    (k, d), as the JAX package's ``preferred_element_type`` grams give
    them: int8 x int8 exactly (in float64, where every sum of 127² d-term
    products is an integer below 2⁵³, then rounded once to f32, as int32
    -> f32 rounds), everything else in f32 from exact upcasts (a bf16
    product is exact in f32; ``torch.matmul`` on bf16 would round the sum
    to bf16)."""
    if a.dtype == torch.int8 and b.dtype == torch.int8:
        return torch.matmul(a.to(torch.float64),
                            b.to(torch.float64).T).to(torch.float32)
    return torch.matmul(a.to(torch.float32), b.to(torch.float32).T)


def pref_topk_block_plain(rows, cents, cnorms, kk: int):
    """The plain PyTorch version of K4 (the Pallas body's arithmetic): the
    :func:`gram`, the score ``max((xx + cn) - 2 g, 0)`` and a stable
    ascending sort, in row blocks whose (rows, k) tile stays under ~1.5 GB.
    Returns (idx (n, kk) int32, vals (n, kk) f32)."""
    n = rows.shape[0]
    k = cents.shape[0]
    xx = row_norms(rows)
    block = max(1, min(max(n, 1), _TILE_BYTES // (4 * k)))
    idx, vals = [], []
    for s in range(0, n, block):
        g = gram(rows[s:s + block], cents)
        score = torch.clamp_min(xx[s:s + block, None] + cnorms[None, :]
                                - 2.0 * g, 0.0)
        v, i = torch.sort(score, dim=1, stable=True)
        idx.append(i[:, :kk].to(torch.int32))
        vals.append(v[:, :kk].contiguous())
    if not idx:
        return (torch.zeros((0, kk), dtype=torch.int32, device=rows.device),
                torch.zeros((0, kk), dtype=torch.float32, device=rows.device))
    return torch.cat(idx), torch.cat(vals)


def tma_centroids(cents: torch.Tensor):
    """(centroids, row stride in elements) as the kernel's TMA copies take
    them: ``cents`` itself when its rows are 16-byte multiples on a
    16-byte-aligned base (always for float32, which the kernel copies by
    cp.async), else a zero-padded copy whose rows are multiples of the
    kernel's 128-byte k-slab. The padding is zeros, so products, norms and
    scores are those of ``cents``."""
    k, d = cents.shape
    es = cents.element_size()
    if cents.dtype == torch.float32 or (
            (d * es) % 16 == 0 and cents.data_ptr() % 16 == 0):
        return cents, d
    ld = -(-d * es // _SLAB_BYTES) * _SLAB_BYTES // es
    out = torch.zeros((k, ld), dtype=cents.dtype, device=cents.device)
    out[:, :d] = cents
    return out, ld


def _padded_norms(cnorms: torch.Tensor) -> torch.Tensor:
    """The centroid norms as the kernel reads them: +inf from k to the next
    multiple of its 128-centroid tile, so those columns never score."""
    k = cnorms.shape[0]
    out = torch.full((-(-k // _TILE_COLS) * _TILE_COLS,), float("inf"),
                     dtype=torch.float32, device=cnorms.device)
    out[:k] = cnorms
    return out


def _check(rows, cents, cnorms, kk):
    if rows.dim() != 2 or cents.dim() != 2 or rows.shape[1] != cents.shape[1]:
        raise ValueError(f"rows (n, d) and cents (k, d) must share d, got "
                         f"{tuple(rows.shape)} and {tuple(cents.shape)}")
    if rows.dtype not in _DTYPES:
        raise TypeError(f"rows must be float32, bfloat16 or int8, got "
                        f"{rows.dtype}")
    if cents.dtype != rows.dtype:
        raise TypeError(f"cents are {cents.dtype}, rows {rows.dtype}")
    k = cents.shape[0]
    if tuple(cnorms.shape) != (k,) or cnorms.dtype != torch.float32:
        raise TypeError(f"cnorms must be ({k},) float32, got {cnorms.dtype} "
                        f"{tuple(cnorms.shape)}")
    if not 1 <= kk <= min(k, MAX_KK):
        raise ValueError(f"pref_topk_block takes 1 <= kk <= min(k, "
                         f"{MAX_KK}), got kk={kk} with k={k}")
    for name, t in (("cents", cents), ("cnorms", cnorms)):
        if t.device != rows.device:
            raise ValueError(f"{name} is on {t.device}, rows on "
                             f"{rows.device}")


def pref_topk_block(rows, cents, cnorms, kk: int):
    """K4. rows (n, d) and cents (k, d) of one dtype (float32, bfloat16 or
    int8), cnorms (k,) float32, all on one device; 1 <= kk <= min(k, 8).
    Returns (idx (n, kk) int32, vals (n, kk) f32), without a host
    synchronisation on CUDA."""
    _check(rows, cents, cnorms, kk)
    if rows.device.type == "cpu":
        return pref_topk_block_plain(rows, cents, cnorms, kk)
    if rows.device.type != "cuda":
        raise ValueError(f"pref_topk_block runs on cuda or cpu, not "
                         f"{rows.device}")
    n, d = rows.shape
    k = cents.shape[0]
    idx = torch.empty((n, kk), dtype=torch.int32, device=rows.device)
    vals = torch.empty((n, kk), dtype=torch.float32, device=rows.device)
    if n == 0:
        return idx, vals
    rows = rows.contiguous()
    cents, c_ld = tma_centroids(cents.contiguous())
    cnorms = _padded_norms(cnorms)
    launch("pref_topk_block", rows.device, (), rows.data_ptr(),
           cents.data_ptr(), cnorms.data_ptr(), n, k, d, c_ld, kk,
           _DTYPES[rows.dtype], idx.data_ptr(), vals.data_ptr())
    return idx, vals
