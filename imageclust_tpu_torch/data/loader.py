"""Host-side image ingest: parallel decode + resize feeding device batches.

The port's copy of ``imageclust_tpu/data/loader.py``, with the same decode
order: the native resize (OpenCV decode + the repository's fixed-point
resize), then cv2, then PIL. Where neither cv2 nor PIL can be imported (a
GPU host may have neither), 24-bit BMP and binary PPM (P6) — formats OpenCV
accepts too — decode with numpy; an image that is not at the target size is
then resized by the native library's ``ic_resize_batch_u8`` when it is
built, and otherwise raises :class:`DecodeError`.

The reference decodes and resizes inside the per-image embedding call
(IMRead/Resize via cgo, internal/embeddings/embeddings.go:46-116), serialized
behind the DNN mutex. Here ingest is a host-side stage that produces one
uint8 BGR batch for the device: decode in a thread pool (cv2 releases the
GIL), resize to the embedder's input size with the exact OpenCV INTER_LINEAR
call the reference uses, and stack. The C++ native runtime
(:mod:`imageclust_tpu_torch.data.native`) replaces the Python pool when built.

Filename sanitization matches utils.SanitizeFilename (allowlist
[a-zA-Z0-9.-], everything else -> '_', internal/utils/utils.go:240-250).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = [
    "sanitize_filename",
    "decode_images",
    "load_image_dir",
    "stream_decode",
    "DecodeError",
    "numpy_decode_bgr",
]

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".gif", ".webp", ".bmp")


class DecodeError(ValueError):
    """Raised when an upload cannot be decoded — the reference fails the whole
    run on the first bad image (embeddings.go:50-52 error path through
    workflow.go:178-182); callers may catch per-file instead."""


def sanitize_filename(name: str) -> str:
    return "".join(
        c if (c.isascii() and (c.isalnum() or c in ".-")) else "_" for c in name
    )


def dedup_name(name: str, seen: set[str]) -> str:
    """Collision-free name among ``seen`` (the reference silently overwrites
    collisions, handlers.go:86-104): appends _1, _2, ... before the
    extension. Does NOT add the result to ``seen`` — callers do."""
    if name not in seen:
        return name
    stem, dot, ext = name.rpartition(".")
    base = stem if dot else name
    suffix = 1
    while True:
        cand = f"{base}_{suffix}{dot}{ext}" if dot else f"{base}_{suffix}"
        if cand not in seen:
            return cand
        suffix += 1


def _decode_one(data: bytes, size: int | None) -> np.ndarray:
    try:
        from imageclust_tpu_torch.data.native import native_decode_resize

        out = native_decode_resize(data, size)
        if out is not None:
            return out
    except ImportError:
        pass
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            # OpenCV has no GIF codec (the reference would fail such uploads
            # at IMRead, embeddings.go:50-52); PIL covers GIF/rare formats.
            img = _pil_decode_bgr(data)
    else:
        img = _pil_decode_bgr(data)
        if img is None and not _pil_available():
            img = numpy_decode_bgr(data)
    if img is None:
        raise DecodeError("image file might be corrupt or unreadable")
    if size is not None and img.shape[:2] != (size, size):
        img = _resize(img, size, cv2)
    return img  # BGR uint8, matching IMReadColor


def _resize(img: np.ndarray, size: int, cv2) -> np.ndarray:
    if cv2 is not None:
        return cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
    from imageclust_tpu_torch.data.native import native_resize_u8

    out = native_resize_u8(img[None], size, size, threads=1)
    if out is None:
        raise DecodeError(
            f"image is {img.shape[1]}x{img.shape[0]}, not {size}x{size}, and "
            "neither cv2 nor the native library (make -C native) is "
            "available to resize it")
    return out[0]


def _pil_available() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def numpy_decode_bgr(data: bytes) -> np.ndarray | None:
    """Decode an uncompressed 24-bit BMP or a binary PPM (P6, maxval 255) to
    BGR uint8 (H, W, 3) with numpy alone; None for any other format or a
    malformed file."""
    if data[:2] == b"BM":
        return _decode_bmp(data)
    if data[:2] == b"P6":
        return _decode_ppm(data)
    return None


def _decode_bmp(data: bytes) -> np.ndarray | None:
    if len(data) < 54:
        return None
    offset = int.from_bytes(data[10:14], "little")
    header = int.from_bytes(data[14:18], "little")
    if header < 40:
        return None
    width = int.from_bytes(data[18:22], "little", signed=True)
    height = int.from_bytes(data[22:26], "little", signed=True)
    planes = int.from_bytes(data[26:28], "little")
    bpp = int.from_bytes(data[28:30], "little")
    compression = int.from_bytes(data[30:34], "little")
    if planes != 1 or bpp != 24 or compression != 0 or width <= 0 \
            or height == 0:
        return None
    h = abs(height)
    stride = (width * 3 + 3) & ~3  # rows pad to 4 bytes
    if offset + stride * h > len(data):
        return None
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    img = rows[:, :width * 3].reshape(h, width, 3)  # stored as B, G, R
    if height > 0:  # positive height: bottom-up rows
        img = img[::-1]
    return np.ascontiguousarray(img)


def _decode_ppm(data: bytes) -> np.ndarray | None:
    fields: list[bytes] = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":  # comment to end of line
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            return None
        fields.append(data[start:pos])
    pos += 1  # exactly one whitespace byte before the raster
    try:
        width, height, maxval = (int(f) for f in fields)
    except ValueError:
        return None
    if maxval != 255 or width <= 0 or height <= 0:
        return None
    n = width * height * 3
    if pos + n > len(data):
        return None
    rgb = np.frombuffer(data, np.uint8, n, pos).reshape(height, width, 3)
    return np.ascontiguousarray(rgb[:, :, ::-1])  # RGB -> BGR


def _pil_decode_bgr(data: bytes):
    import io

    try:
        from PIL import Image

        with Image.open(io.BytesIO(data)) as im:
            rgb = np.asarray(im.convert("RGB"))
        return rgb[:, :, ::-1].copy()  # RGB -> BGR
    except Exception:
        return None


def decode_images(
    blobs: list[bytes],
    size: int | None = 224,
    workers: int = 8,
) -> np.ndarray:
    """Decode ``blobs`` to a (N, size, size, 3) uint8 BGR batch. With
    ``size=None`` images must already share a shape."""
    if not blobs:
        return np.zeros((0, size or 1, size or 1, 3), np.uint8)
    workers = max(1, min(workers, os.cpu_count() or 1, len(blobs)))
    if workers == 1:  # skip pool overhead on single-core hosts
        imgs = [_decode_one(b, size) for b in blobs]
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            imgs = list(pool.map(lambda b: _decode_one(b, size), blobs))
    shapes = {im.shape for im in imgs}
    if len(shapes) > 1:
        raise DecodeError(f"inconsistent decoded shapes: {shapes}")
    return np.stack(imgs)


def stream_decode(
    sources,
    size: int,
    batch: int,
    workers: int = 8,
    prefetch: int = 2,
):
    """Bounded-memory chunked ingest: yield ``(start, blobs, images)`` where
    ``blobs`` is the list of raw bytes and ``images`` a (b, size, size, 3)
    uint8 batch, for consecutive slices of ``sources`` of length ``batch``
    (the tail may be shorter).

    ``sources`` items are raw ``bytes`` or filesystem paths (read lazily, so
    a 100k-file job never holds more than ``prefetch+1`` chunks of bytes or
    pixels in RSS — the reference materializes nothing because it streams one
    image at a time through cgo, embeddings.go:119-163; this is the batched
    equivalent). A background producer thread reads+decodes ahead of the
    consumer, so host decode overlaps the device forward pass the caller
    dispatches (JAX dispatch is async).
    """
    import queue
    import threading

    n = len(sources)
    if n == 0:
        return
    q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up when the consumer is gone — a plain
        q.put() can block forever after the consumer abandons the generator
        (its finally drains once, the producer refills the slot, then the
        terminal put has no reader), leaking the thread and a pixel chunk."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            with ThreadPoolExecutor(
                max_workers=max(1, min(workers, os.cpu_count() or 1))
            ) as pool:
                for start in range(0, n, batch):
                    if stop.is_set():
                        return
                    chunk = sources[start:start + batch]
                    blobs = [
                        s if isinstance(s, (bytes, bytearray))
                        else _read_file(s)
                        for s in chunk
                    ]
                    imgs = list(pool.map(lambda b: _decode_one(b, size), blobs))
                    if not _put((start, blobs, np.stack(imgs))):
                        return
            _put(None)
        except BaseException as exc:  # surface in the consumer
            _put(exc)

    t = threading.Thread(target=produce, name="ingest-decode", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # unblock a producer waiting on a full queue so it can observe stop
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break


def _read_file(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def load_image_dir(path: str, size: int | None = 224, workers: int = 8):
    """Load every image file under ``path`` (sorted); returns
    (filenames, batch)."""
    names = sorted(
        f for f in os.listdir(path)
        if f.lower().endswith(_IMAGE_EXTS)
        and os.path.isfile(os.path.join(path, f))
    )
    blobs = []
    for name in names:
        with open(os.path.join(path, name), "rb") as fh:
            blobs.append(fh.read())
    return names, decode_images(blobs, size=size, workers=workers)
