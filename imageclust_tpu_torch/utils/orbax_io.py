"""Orbax checkpoints without Orbax: read and write the layout the JAX
package's ``save_variables`` / ``restore_variables`` use
(``ocp.StandardCheckpointer``), with numpy, ctypes and the standard
library only.

A checkpoint is a directory holding

* ``_METADATA``: JSON ``tree_metadata``, one entry per leaf with its key
  path (``key_type`` 2 for a dict key, 1 for a sequence index) and its
  value type (``"None"`` leaves carry ``skip_deserialize``), plus
  ``use_ocdbt`` and ``use_zarr3``;
* ``_CHECKPOINT_METADATA``: the handler's name and timestamps;
* one zarr v2 array per leaf, named by its keys joined with ``.``
  (``params.dense0.kernel/.zarray`` and the chunk ``params.dense0.kernel/0.0``),
  held either in plain files (``use_ocdbt: false``, one directory per
  leaf) or in an OCDBT key-value store read from ``manifest.ocdbt``
  (Orbax's default; https://google.github.io/tensorstore/kvstore/ocdbt/).

Every OCDBT file (manifest or B-tree node) is a header (a 4-byte magic,
its length as u64 LE, a format version and a compression byte), a body
that is a zstd frame when the compression byte is 1, and a CRC-32C of all
that precedes it. The reader checks every CRC. A zstd frame made only of
raw or RLE blocks decodes here in Python; a frame with compressed blocks
(what Orbax writes) goes through the system's ``libzstd`` and raises,
naming the file, when there is none.

:func:`save_variables` writes the per-leaf layout, each chunk one zstd
frame of raw blocks, into a temporary sibling directory that replaces
``path`` once complete. Orbax reads it as it reads its own.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import itertools
import json
import math
import os
import shutil
import struct
import time
from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["save_variables", "restore_variables", "crc32c", "zstd_decode",
           "zstd_encode_raw", "libzstd_path"]

_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
_DICT, _SEQ = 2, 1  # orbax key_type values

# zarr v2 dtype strings <-> numpy; bfloat16 has no numpy type of its own
_ZARR_DTYPES = {"<f4": np.float32, "<f2": np.float16, "<i4": np.int32,
                "<i8": np.int64, "|b1": np.bool_, "|u1": np.uint8}
_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE


# -- CRC-32C (Castagnoli) ----------------------------------------------------

def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (reflected polynomial 0x82F63B78), the checksum OCDBT files
    end with; ``zlib.crc32`` uses another polynomial."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- zstd --------------------------------------------------------------------

class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


@functools.lru_cache(maxsize=None)
def _libzstd():
    """The system's libzstd through ctypes, or None when there is none."""
    name = ctypes.util.find_library("zstd")
    if not name:
        return None
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_getFrameContentSize.argtypes = [vp, size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_decompress.argtypes = [vp, size_t, vp, size_t]
    lib.ZSTD_decompress.restype = size_t
    lib.ZSTD_isError.argtypes = [size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_getErrorName.argtypes = [size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_createDStream.argtypes = []
    lib.ZSTD_createDStream.restype = vp
    lib.ZSTD_freeDStream.argtypes = [vp]
    lib.ZSTD_freeDStream.restype = size_t
    lib.ZSTD_initDStream.argtypes = [vp]
    lib.ZSTD_initDStream.restype = size_t
    lib.ZSTD_decompressStream.argtypes = [
        vp, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)]
    lib.ZSTD_decompressStream.restype = size_t
    lib._path = name
    return lib


def libzstd_path() -> str:
    """The libzstd that :func:`zstd_decode` uses, or "" when none is
    found."""
    lib = _libzstd()
    return lib._path if lib is not None else ""


_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2


def _frames_python(data: bytes) -> bytes | None:
    """Decode zstd frames made only of raw and RLE blocks; None when a
    frame holds a compressed block."""
    out = []
    pos = 0
    while pos < len(data):
        if data[pos:pos + 4] != _ZSTD_MAGIC:
            raise ValueError(f"not a zstd frame at byte {pos}")
        fhd = data[pos + 4]
        pos += 5
        fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
        checksum, dict_flag = (fhd >> 2) & 1, fhd & 3
        if fhd & 0x08:
            raise ValueError("zstd frame header has its reserved bit set")
        pos += (0 if single else 1) + (0, 1, 2, 4)[dict_flag]
        pos += (1 if single else 0, 2, 4, 8)[fcs_flag]
        while True:
            if pos + 3 > len(data):
                raise ValueError("truncated zstd frame")
            hdr = int.from_bytes(data[pos:pos + 3], "little")
            pos += 3
            last, btype, size = hdr & 1, (hdr >> 1) & 3, hdr >> 3
            if btype == 0:
                if pos + size > len(data):
                    raise ValueError("truncated zstd raw block")
                out.append(data[pos:pos + size])
                pos += size
            elif btype == 1:
                out.append(data[pos:pos + 1] * size)
                pos += 1
            elif btype == 2:
                return None
            else:
                raise ValueError("reserved zstd block type")
            if last:
                break
        pos += 4 if checksum else 0
    return b"".join(out)


def _frames_libzstd(lib, data: bytes) -> bytes:
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("libzstd: not a valid zstd frame")
    if size != _CONTENTSIZE_UNKNOWN:
        buf = ctypes.create_string_buffer(max(size, 1))
        got = lib.ZSTD_decompress(buf, size, data, len(data))
        if lib.ZSTD_isError(got):
            raise ValueError(
                f"libzstd: {lib.ZSTD_getErrorName(got).decode()}")
        return buf.raw[:got]
    # no content size in the header (tensorstore writes none): stream
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("ZSTD_createDStream failed")
    try:
        lib.ZSTD_initDStream(stream)
        src = ctypes.create_string_buffer(data, len(data))
        inp = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        chunk = 1 << 20
        dst = ctypes.create_string_buffer(chunk)
        pieces = []
        ret = 1
        while inp.pos < inp.size or ret != 0:
            out = _OutBuffer(ctypes.cast(dst, ctypes.c_void_p), chunk, 0)
            before = inp.pos
            ret = lib.ZSTD_decompressStream(stream, ctypes.byref(out),
                                            ctypes.byref(inp))
            if lib.ZSTD_isError(ret):
                raise ValueError(
                    f"libzstd: {lib.ZSTD_getErrorName(ret).decode()}")
            pieces.append(dst.raw[:out.pos])
            if (inp.pos == inp.size and ret != 0 and out.pos < chunk
                    and inp.pos == before):
                raise ValueError("libzstd: truncated zstd frame")
        return b"".join(pieces)
    finally:
        lib.ZSTD_freeDStream(stream)


def zstd_decode(data: bytes, what: str = "zstd data") -> bytes:
    """Decode one or more zstd frames. Raw and RLE blocks decode in
    Python; compressed blocks need the system's libzstd, and without it
    this raises RuntimeError naming ``what`` (the file being read)."""
    plain = _frames_python(data)
    if plain is not None:
        return plain
    lib = _libzstd()
    if lib is None:
        raise RuntimeError(
            f"{what}: zstd frame with compressed blocks and no libzstd "
            f"found (ctypes.util.find_library('zstd')); install libzstd "
            f"to read checkpoints that Orbax wrote")
    try:
        return _frames_libzstd(lib, data)
    except ValueError as exc:
        raise ValueError(f"{what}: {exc}") from exc


def zstd_encode_raw(data: bytes) -> bytes:
    """One zstd frame of raw (stored) blocks holding ``data``: valid zstd
    that any decoder reads, written without a compressor."""
    # single segment with an 8-byte content size; blocks of at most 128 KiB
    parts = [_ZSTD_MAGIC, b"\xe0", struct.pack("<Q", len(data))]
    block = 1 << 17
    n = len(data)
    starts = range(0, n, block) if n else [0]
    for start in starts:
        piece = data[start:start + block]
        last = start + block >= n
        parts.append((int(last) | (len(piece) << 3)).to_bytes(3, "little"))
        parts.append(piece)
    return b"".join(parts)


# -- OCDBT -------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data = data
        self.pos = 0
        self.what = what

    def varint(self) -> int:
        shift = value = 0
        while True:
            if self.pos >= len(self.data):
                raise ValueError(f"{self.what}: truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]


def _ocdbt_body(blob: bytes, magic: int, what: str) -> bytes:
    """Check an OCDBT file's header and CRC-32C; return its body."""
    if len(blob) < 18:
        raise ValueError(f"{what}: too short for an OCDBT file")
    got_magic = int.from_bytes(blob[:4], "big")
    if got_magic != magic:
        raise ValueError(f"{what}: magic {got_magic:#010x} != {magic:#010x}")
    length = struct.unpack("<Q", blob[4:12])[0]
    if length != len(blob):
        raise ValueError(f"{what}: header length {length} != {len(blob)}")
    want = struct.unpack("<I", blob[-4:])[0]
    if crc32c(blob[:-4]) != want:
        raise ValueError(f"{what}: CRC-32C mismatch")
    r = _Reader(blob[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version} unknown")
    compression = r.varint()
    body = blob[r.pos:-4]
    if compression == 1:
        return zstd_decode(body, what)
    if compression != 0:
        raise ValueError(f"{what}: unknown compression {compression}")
    return body


def _data_file_table(r: _Reader) -> list[str]:
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    r.varints(n)  # base-path lengths: the split does not matter here
    paths: list[str] = []
    prev = b""
    for i in range(n):
        full = prev[:prefix[i]] + r.take(suffix[i])
        paths.append(full.decode())
        prev = full
    return paths


def _keys(r: _Reader, n: int) -> tuple[list[int], list[int]]:
    """The prefix-compression columns of ``n`` keys: each key's shared
    prefix length with the key before it, and its suffix length."""
    return [0] + r.varints(max(n - 1, 0)), r.varints(n)


class _Ocdbt:
    """Read-only view of an OCDBT store rooted at ``root``: every key of the
    latest version, as inline bytes or a (file, offset, length) reference."""

    def __init__(self, root: str):
        self.root = root
        self.entries: dict[bytes, Any] = {}
        path = os.path.join(root, "manifest.ocdbt")
        r = _Reader(_ocdbt_body(_read(path), _MANIFEST_MAGIC, path), path)
        r.take(16)  # uuid
        if r.varint() != 0:
            raise ValueError(f"{path}: numbered manifests are not supported")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.u8()  # version_tree_arity_log2
        if r.varint() == 1:  # zstd: its level, int32 LE
            r.take(4)
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            return  # an empty store
        r.varints(n)  # generation numbers
        heights = [r.u8() for _ in range(n)]
        ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        num_keys = r.varints(n)
        # the newest version is the last; an empty tree has no keys
        if num_keys[-1]:
            self._walk(files[ids[-1]], offs[-1], lens[-1], heights[-1], b"")

    def _walk(self, file: str, off: int, length: int, height: int,
              prefix: bytes) -> None:
        path = os.path.join(self.root, file)
        what = f"{path}@{off}"
        r = _Reader(_ocdbt_body(_read(path, off, length), _NODE_MAGIC,
                                what), what)
        if r.u8() != height:
            raise ValueError(f"{what}: node height != its reference's")
        files = _data_file_table(r)
        n = r.varint()
        kprefix, ksuffix = _keys(r, n)
        common = r.varints(n) if height else None
        keys: list[bytes] = []
        prev = b""
        for i in range(n):
            prev = prev[:kprefix[i]] + r.take(ksuffix[i])
            keys.append(prev)
        if height:
            ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            for i in range(n):
                self._walk(files[ids[i]], offs[i], lens[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        vlens = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids = r.varints(len(indirect))
        offs = r.varints(len(indirect))
        refs = dict(zip(indirect, zip(ids, offs)))
        for i in range(n):
            if kinds[i] == 0:
                self.entries[prefix + keys[i]] = r.take(vlens[i])
            elif kinds[i] == 1:
                fid, voff = refs[i]
                self.entries[prefix + keys[i]] = (files[fid], voff, vlens[i])
            else:
                raise ValueError(f"{what}: unknown value kind {kinds[i]}")

    def get(self, key: str) -> bytes | None:
        ref = self.entries.get(key.encode())
        if ref is None or isinstance(ref, bytes):
            return ref
        file, off, length = ref
        return _read(os.path.join(self.root, file), off, length)

    def name(self, key: str) -> str:
        return f"{self.root} (OCDBT key {key})"


class _Files:
    """The per-leaf layout: one file per key."""

    def __init__(self, root: str):
        self.root = root

    def get(self, key: str) -> bytes | None:
        path = os.path.join(self.root, *key.split("/"))
        return _read(path) if os.path.isfile(path) else None

    def name(self, key: str) -> str:
        return os.path.join(self.root, key)


def _read(path: str, offset: int = 0, length: int | None = None) -> bytes:
    with open(path, "rb") as fh:
        fh.seek(offset)
        data = fh.read() if length is None else fh.read(length)
    if length is not None and len(data) != length:
        raise ValueError(f"{path}: wanted {length} bytes at {offset}, "
                         f"file ends after {len(data)}")
    return data


# -- zarr v2 -----------------------------------------------------------------

def _fill(fill):
    if fill is None:
        return 0
    if isinstance(fill, str):
        return {"NaN": math.nan, "Infinity": math.inf,
                "-Infinity": -math.inf}[fill]
    return fill


def _read_array(store, name: str):
    meta_raw = store.get(f"{name}/.zarray")
    if meta_raw is None:
        raise ValueError(f"{store.name(name + '/.zarray')}: leaf {name!r} "
                         f"has no .zarray")
    meta = json.loads(meta_raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}")
    dt = meta["dtype"]
    if dt == "bfloat16":
        raw_dtype, bf16 = np.dtype(np.uint16), True
    elif dt in _ZARR_DTYPES:
        raw_dtype, bf16 = np.dtype(_ZARR_DTYPES[dt]), False
    else:
        raise ValueError(f"{name}: zarr dtype {dt!r} is not supported "
                         f"(want one of {sorted(_ZARR_DTYPES)} or bfloat16)")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters are not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp.get('id')!r} is not "
                         f"supported (want zstd or none)")
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    fill = _fill(meta.get("fill_value"))
    if bf16:  # the fill value's bfloat16 bits
        fill = torch.tensor(float(fill), dtype=torch.bfloat16).view(
            torch.uint16).item()
    out = np.full(shape, fill, dtype=raw_dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        blob = store.get(key)
        if blob is None:
            continue  # a missing chunk reads as the fill value
        if comp is not None:
            blob = zstd_decode(blob, store.name(key))
        want = int(np.prod(chunks, dtype=np.int64)) * raw_dtype.itemsize
        if len(blob) != want:
            raise ValueError(f"{store.name(key)}: chunk holds {len(blob)} "
                             f"bytes, expected {want}")
        arr = np.frombuffer(blob, raw_dtype).reshape(chunks, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = arr[tuple(slice(0, s.stop - s.start) for s in sl)]
    if bf16:
        return torch.from_numpy(out.copy()).view(torch.bfloat16)
    return out


# -- the tree ------------------------------------------------------------------

def _checkpoint_leaves(path: str) -> list[tuple[list[dict], dict]]:
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"{path}: no _METADATA (not an Orbax "
                                f"checkpoint)")
    with open(meta_path) as fh:
        meta = json.load(fh)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr v3 checkpoints are not supported")
    return meta, [(v["key_metadata"], v.get("value_metadata", {}))
                  for v in meta["tree_metadata"].values()]


def _open_store(path: str, meta: dict):
    if meta.get("use_ocdbt", True):
        return _Ocdbt(path)
    return _Files(path)


def _insert(tree, keys: list[dict], value) -> Any:
    """Place ``value`` at ``keys`` in a tree of dicts (key_type 2) and
    index dicts (key_type 1, turned into lists afterwards)."""
    node = tree
    for i, km in enumerate(keys):
        key = km["key"]
        last = i == len(keys) - 1
        if km["key_type"] not in (_DICT, _SEQ):
            raise ValueError(f"unknown key_type {km['key_type']} at {key!r}")
        if last:
            node[key] = value
        else:
            node = node.setdefault(key, {"__seq__": keys[i + 1]["key_type"]
                                         == _SEQ})
    return tree


def _finish(node):
    if not isinstance(node, dict):
        return node
    seq = node.pop("__seq__", False)
    items = {k: _finish(v) for k, v in node.items()}
    if seq:
        return [items[str(i)] for i in range(len(items))]
    return items


def _to_template(template, found: dict, path: tuple) -> Any:
    name = "/".join(path) or "<root>"
    if template is None:
        return None
    if isinstance(template, Mapping):
        return {k: _to_template(v, found, path + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_to_template(v, found, path + (str(i),))
                              for i, v in enumerate(template))
    if path not in found:
        raise ValueError(f"checkpoint has no leaf {name}")
    arr = found[path]
    if arr is None:
        raise ValueError(f"checkpoint leaf {name} is None, template wants "
                         f"an array")
    want_shape = tuple(template.shape)
    if tuple(arr.shape) != want_shape:
        raise ValueError(f"checkpoint leaf {name}: shape {tuple(arr.shape)} "
                         f"!= template {want_shape}")
    if isinstance(template, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
        return t.to(template.dtype)
    if isinstance(arr, torch.Tensor):  # a bfloat16 leaf into numpy
        arr = arr.float().numpy()
    return np.asarray(arr).astype(template.dtype, copy=False)


def restore_variables(path: str, template: Any = None) -> Any:
    """Read an Orbax checkpoint (the JAX package's ``save_variables``
    output, or this module's) as nested dicts and lists of numpy arrays;
    bfloat16 leaves come back as ``torch.bfloat16`` tensors, numpy having
    no such type, and ``None`` leaves (``skip_deserialize``) as None.

    With ``template`` (nested dicts, lists or tuples of numpy arrays,
    tensors or None), the result takes the template's structure and each
    leaf its template's type (numpy or tensor) and dtype; a missing leaf or
    a wrong shape raises ValueError naming the leaf."""
    path = os.path.abspath(path)
    meta, leaves = _checkpoint_leaves(path)
    store = _open_store(path, meta)
    found: dict[tuple, Any] = {}
    tree: dict = {"__seq__": bool(leaves) and leaves[0][0][0]["key_type"]
                  == _SEQ}
    for keys, vmeta in leaves:
        names = tuple(str(k["key"]) for k in keys)
        if vmeta.get("skip_deserialize") or vmeta.get("value_type") == "None":
            value = None
        else:
            value = _read_array(store, ".".join(names))
        found[names] = value
        _insert(tree, keys, value)
    if template is None:
        return _finish(tree)
    return _to_template(template, found, ())


# -- writing ------------------------------------------------------------------

def _zarr_dtype(arr) -> tuple[str, np.ndarray]:
    """(zarr dtype string, a numpy view of the leaf's bits)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.uint16).numpy()
        arr = t.numpy()
    arr = np.asarray(arr)  # tobytes() writes C order from any layout
    if arr.dtype.name == "bfloat16":
        return "bfloat16", arr.view(np.uint16)
    for name, np_type in _ZARR_DTYPES.items():
        if arr.dtype == np.dtype(np_type):
            return name, arr
    raise ValueError(f"dtype {arr.dtype} is not supported (want one of "
                     f"{sorted(_ZARR_DTYPES)} or bfloat16)")


def _flatten(tree, keys: tuple = ()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, keys + ((str(k), _DICT),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, keys + ((str(i), _SEQ),))
    else:
        if not keys:
            raise ValueError("save_variables needs a tree of dicts or lists")
        yield keys, tree


def _write_leaf(root: str, name: str, arr) -> None:
    dt, data = _zarr_dtype(arr)
    shape = list(data.shape)
    leaf_dir = os.path.join(root, name)
    os.makedirs(leaf_dir)
    zarray = {"chunks": shape, "compressor": {"id": "zstd", "level": 1},
              "dimension_separator": ".", "dtype": dt, "fill_value": None,
              "filters": None, "order": "C", "shape": shape,
              "zarr_format": 2}
    with open(os.path.join(leaf_dir, ".zarray"), "w") as fh:
        json.dump(zarray, fh, separators=(",", ":"))
    chunk = ".".join("0" for _ in shape) or "0"
    with open(os.path.join(leaf_dir, chunk), "wb") as fh:
        fh.write(zstd_encode_raw(data.tobytes()))


def save_variables(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dicts and lists/tuples of numpy arrays,
    tensors or None) as an Orbax checkpoint in the per-leaf layout
    (``use_ocdbt: false``) that the JAX package's ``restore_variables``
    reads. The checkpoint is built in a temporary sibling directory and
    renamed into place, replacing any checkpoint at ``path`` (Orbax's
    ``force=True``)."""
    path = os.path.abspath(path)
    t0 = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}-{t0}"
    os.makedirs(tmp)
    try:
        tree_meta = {}
        for keys, leaf in _flatten(tree):
            names = tuple(k for k, _ in keys)
            if leaf is None:
                vmeta = {"value_type": "None", "skip_deserialize": True}
            else:
                _write_leaf(tmp, ".".join(names), leaf)
                vmeta = {"value_type": "np.ndarray",
                         "skip_deserialize": False}
            tree_meta[str(names)] = {
                "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
                "value_metadata": vmeta}
        with open(os.path.join(tmp, "_METADATA"), "w") as fh:
            json.dump({"tree_metadata": tree_meta, "use_ocdbt": False,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, fh)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as fh:
            json.dump({"item_handlers": _HANDLER, "metrics": {},
                       "performance_metrics": {},
                       "init_timestamp_nsecs": t0,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, fh)
        if os.path.lexists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
