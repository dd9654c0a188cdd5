"""ctypes bindings for the repository's native host-preprocessing runtime.

The port's own copy of the JAX package's bindings (the library is C++ with
no framework). Loads ``native/libicnative.so`` at the repository root (built
with ``make -C native``). Every entry point returns None when the library is
absent — :mod:`imageclust_tpu_torch.data.loader` then takes its other
decoders, and the bucketed engine its Python placement and member walk
(identical results).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

__all__ = [
    "available",
    "native_resize_batch",
    "native_resize_u8",
    "native_preprocess_blob",
    "native_content_hash",
    "native_decode_resize",
    "native_reconstruct_members",
    "native_spill_place",
]

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    candidates = [
        os.environ.get("IMAGECLUST_NATIVE_LIB", ""),
        os.path.join(here, "native", "libicnative.so"),
    ]
    for path in candidates:
        if path and os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                continue
            lib.ic_resize_batch_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
            ]
            lib.ic_preprocess_blob.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ]
            lib.ic_content_hash.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.ic_content_hash.restype = ctypes.c_uint64
            # Refuse stale builds: the ABI (and the uint8 resize numerics)
            # are pinned to the source in native/preproc.cpp; a leftover .so
            # from an older checkout must not silently control preprocessing
            # (ADVICE r1). Rebuild with `make -C native`.
            try:
                if lib.ic_version() < 4:
                    continue
            except AttributeError:
                continue
            lib.ic_resize_batch_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
            ]
            lib.ic_reconstruct_members.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int,
            ]
            lib.ic_reconstruct_members.restype = ctypes.c_int
            lib.ic_spill_place.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ]
            _LIB = lib
            break
    return _LIB


def available() -> bool:
    return _load() is not None


def native_resize_batch(
    batch: np.ndarray, out_h: int, out_w: int, threads: int = 8
) -> np.ndarray | None:
    """(N,H,W,C) uint8 -> (N,out_h,out_w,C) float32 with OpenCV INTER_LINEAR
    semantics; None when the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    batch = np.ascontiguousarray(batch, dtype=np.uint8)
    n, h, w, c = batch.shape
    out = np.empty((n, out_h, out_w, c), np.float32)
    lib.ic_resize_batch_f32(
        batch.ctypes.data, n, h, w, c, out.ctypes.data, out_h, out_w,
        max(1, threads),
    )
    return out


def native_preprocess_blob(
    batch: np.ndarray,
    out_size: int = 224,
    scale: float = 1.0 / 255.0,
    mean: tuple[float, float, float] = (0.0, 0.0, 0.0),
    std: tuple[float, float, float] = (1.0, 1.0, 1.0),
    bgr_to_rgb: bool = True,
    threads: int = 8,
) -> np.ndarray | None:
    """(N,H,W,3) uint8 BGR -> (N,3,out,out) float32 blob — the reference's
    full BlobFromImage preprocess (embeddings.go:46-116) as one native call;
    None when the lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    batch = np.ascontiguousarray(batch, dtype=np.uint8)
    n, h, w, c = batch.shape
    if c != 3:
        raise ValueError("expected 3-channel input")
    out = np.empty((n, 3, out_size, out_size), np.float32)
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    lib.ic_preprocess_blob(
        batch.ctypes.data, n, h, w, out.ctypes.data, out_size,
        ctypes.c_float(scale), mean_a.ctypes.data, std_a.ctypes.data,
        1 if bgr_to_rgb else 0, max(1, threads),
    )
    return out


def native_content_hash(data: bytes) -> int | None:
    lib = _load()
    if lib is None:
        return None
    buf = (ctypes.c_char * len(data)).from_buffer_copy(data)
    return int(lib.ic_content_hash(buf, len(data)))


def native_resize_u8(
    batch: np.ndarray, out_h: int, out_w: int, threads: int = 8
) -> np.ndarray | None:
    """(N,H,W,C) uint8 -> (N,out_h,out_w,C) uint8, bit-exact with
    cv2.resize INTER_LINEAR's 11-bit fixed-point uint8 path; None when the
    native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    batch = np.ascontiguousarray(batch, dtype=np.uint8)
    n, h, w, c = batch.shape
    out = np.empty((n, out_h, out_w, c), np.uint8)
    lib.ic_resize_batch_u8(
        batch.ctypes.data, n, h, w, c, out.ctypes.data, out_h, out_w,
        max(1, threads),
    )
    return out


def native_decode_resize(data: bytes, size: int | None):
    """Decode is delegated to OpenCV (the same C++ codec stack the reference
    uses through gocv); the resize fast path is ours, using the fixed-point
    uint8 kernel so pixels are identical to the cv2.resize fallback whether
    or not the library loads. Returns None to let the caller fall back when
    the lib is absent or size is None."""
    lib = _load()
    if lib is None or size is None:
        return None
    import cv2

    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        return None  # let the caller's PIL fallback try (e.g. GIF)
    if img.shape[:2] == (size, size):
        return img
    if img.shape[0] >= size and img.shape[1] >= size:
        # fixed-point kernel is fuzz-proven bit-exact vs cv2.resize for
        # non-enlarging resizes; OpenCV 5.0 changed the 8U *upscale*
        # arithmetic, so tiny images take the cv2 path to stay identical.
        return native_resize_u8(img[None], size, size, threads=1)[0]
    return cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)


def native_reconstruct_members(
    logs: np.ndarray,        # (sum_m, 3) int32, buckets concatenated
    log_off: np.ndarray,     # (nb+1,) int64
    counts: np.ndarray,      # (nb,) int32 — leaves per bucket
    counts_off: np.ndarray,  # (nb+1,) int64 prefix sum of counts
    roots: np.ndarray,       # (total_roots,) int32, buckets concatenated
    root_off: np.ndarray,    # (nb+1,) int64
    threads: int = 8,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Expand per-bucket Ward merge logs into ordered member lists (the
    bucketed engine's host reconstruction — see native/preproc.cpp for the
    semantics; order matches ward._leaf_indices exactly). Returns
    (members (sum counts,) int32 local indices, sizes (total_roots,) int32)
    or None when the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    logs = np.ascontiguousarray(logs, np.int32)
    log_off = np.ascontiguousarray(log_off, np.int64)
    counts = np.ascontiguousarray(counts, np.int32)
    counts_off = np.ascontiguousarray(counts_off, np.int64)
    roots = np.ascontiguousarray(roots, np.int32)
    root_off = np.ascontiguousarray(root_off, np.int64)
    nb = counts.shape[0]
    members = np.empty(int(counts_off[-1]), np.int32)
    sizes = np.zeros(roots.shape[0], np.int32)
    rc = lib.ic_reconstruct_members(
        logs.ctypes.data, log_off.ctypes.data, counts.ctypes.data,
        counts_off.ctypes.data, roots.ctypes.data, root_off.ctypes.data,
        nb, members.ctypes.data, sizes.ctypes.data, max(1, threads),
    )
    if rc != 0:
        raise ValueError("malformed merge log in native reconstruction")
    return members, sizes


def native_spill_place(
    prefs: np.ndarray,    # (m, P) int32 preference lists, processing order
    src: np.ndarray,      # (m,) int32 source bucket per item (skipped)
    cnt: np.ndarray,      # (nb,) int64 live counts — UPDATED IN PLACE
    capacity: int,
    cursor: int,
) -> tuple[np.ndarray, int] | None:
    """Sequential capacity-repair placement (the _repair_buckets hot loop)
    at C speed — bit-identical to the per-item Python scan: first
    preference != src with room, else the monotone-cursor fallback.
    Returns (targets (m,) int32, updated cursor), or None when the native
    lib is unavailable. ``cnt`` must be a contiguous int64 array owned by
    the caller; it is mutated exactly as the Python loop would."""
    lib = _load()
    if lib is None:
        return None
    prefs = np.ascontiguousarray(prefs, np.int32)
    src = np.ascontiguousarray(src, np.int32)
    assert cnt.dtype == np.int64 and cnt.flags.c_contiguous
    m, p = prefs.shape
    out = np.empty(m, np.int32)
    cur = np.array([cursor], np.int64)
    lib.ic_spill_place(
        prefs.ctypes.data, src.ctypes.data, m, p, cnt.ctypes.data,
        cnt.shape[0], capacity, cur.ctypes.data, out.ctypes.data,
    )
    return out, int(cur[0])
