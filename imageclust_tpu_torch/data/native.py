"""ctypes bindings for the repository's native host-preprocessing runtime.

The port's own copy of the JAX package's bindings (the library is C++ with
no framework). Loads ``native/libicnative.so`` at the repository root (built
with ``make -C native``). Every entry point returns None when the library is
absent — :mod:`imageclust_tpu_torch.data.loader` then takes its other
decoders.
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
