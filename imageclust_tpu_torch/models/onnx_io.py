"""Minimal pure-Python ONNX (protobuf) reader and writer.

The ``onnx`` package is not in this image and the framework must ingest the
reference's checkpoint format (resnet50-v1-7.onnx — the file the reference
loads at internal/workflow/workflow.go:49 via gocv.ReadNetFromONNX,
internal/embeddings/embeddings.go:30). ONNX files are protobuf messages with
a small, stable wire format, so this module implements exactly the subset
needed:

* :func:`read_onnx_initializers` — name -> numpy array for every initializer
  (weights) in the graph,
* :func:`read_onnx_graph` — nodes (op_type, inputs, outputs, attrs) for
  structural checks,
* :func:`write_onnx_model` — enough of a writer to synthesize checkpoints in
  tests (round-trip validation, and OpenCV-DNN cross-checks since cv2 can
  load what we write).

Wire format reference: protobuf encoding spec (varint / 64-bit / bytes /
32-bit wire types). Field numbers from onnx.proto3 (public schema).
"""

from __future__ import annotations

import struct
from typing import Any, Iterator

import numpy as np

__all__ = [
    "read_onnx_initializers",
    "read_onnx_graph",
    "write_onnx_model",
]

# TensorProto.DataType (onnx.proto3)
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            value = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            value = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    data_type = 1
    name = ""
    raw = b""
    float_data: list[float] = []
    int32_data: list[int] = []
    int64_data: list[int] = []
    for field, wire, value in _fields(buf):
        if field == 1:  # dims (repeated int64; may be packed)
            if wire == 0:
                dims.append(value)
            else:
                pos = 0
                while pos < len(value):
                    v, pos = _read_varint(value, pos)
                    dims.append(v)
        elif field == 2:
            data_type = value
        elif field == 4:  # float_data, packed
            if wire == 5:
                float_data.append(struct.unpack("<f", value)[0])
            else:
                float_data.extend(np.frombuffer(value, "<f4").tolist())
        elif field == 5:  # int32_data
            if wire == 0:
                int32_data.append(value)
            else:
                pos = 0
                while pos < len(value):
                    v, pos = _read_varint(value, pos)
                    int32_data.append(v)
        elif field == 7:  # int64_data
            if wire == 0:
                int64_data.append(value)
            else:
                pos = 0
                while pos < len(value):
                    v, pos = _read_varint(value, pos)
                    int64_data.append(v)
        elif field == 8:
            name = value.decode("utf-8")
        elif field == 9:
            raw = value
    dtype = _DTYPES.get(data_type)
    if dtype is None:
        raise ValueError(f"unsupported tensor dtype code {data_type} for {name}")
    if raw:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=dtype)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=dtype)
    elif int32_data:
        arr = np.asarray(int32_data, dtype=dtype)
    else:
        arr = np.zeros(0, dtype=dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def _graph_bytes(model_bytes: bytes) -> bytes:
    for field, _, value in _fields(model_bytes):
        if field == 7:  # ModelProto.graph
            return value
    raise ValueError("no GraphProto found — not an ONNX model?")


def read_onnx_initializers(path: str) -> dict[str, np.ndarray]:
    """All graph initializers as name -> ndarray."""
    with open(path, "rb") as fh:
        model = fh.read()
    out: dict[str, np.ndarray] = {}
    for field, _, value in _fields(_graph_bytes(model)):
        if field == 5:  # GraphProto.initializer
            name, arr = _parse_tensor(value)
            out[name] = arr
    return out


def _parse_attribute(buf: bytes) -> tuple[str, Any]:
    name = ""
    val: Any = None
    ints: list[int] = []
    floats: list[float] = []
    for field, wire, value in _fields(buf):
        if field == 1:
            name = value.decode("utf-8")
        elif field == 2:  # f
            val = struct.unpack("<f", value)[0]
        elif field == 3:  # i
            val = value
        elif field == 4:  # s
            val = value
        elif field == 8:  # ints (repeated int64)
            if wire == 0:
                ints.append(value)
            else:
                pos = 0
                while pos < len(value):
                    v, pos = _read_varint(value, pos)
                    ints.append(v)
        elif field == 7:  # floats (repeated float)
            if wire == 5:
                floats.append(struct.unpack("<f", value)[0])
            else:
                floats.extend(np.frombuffer(value, "<f4").tolist())
    if ints:
        val = ints
    elif floats:
        val = floats
    return name, val


def read_onnx_graph(path: str) -> list[dict[str, Any]]:
    """Graph nodes: [{op_type, name, inputs, outputs, attrs}, ...]."""
    with open(path, "rb") as fh:
        model = fh.read()
    nodes = []
    for field, _, value in _fields(_graph_bytes(model)):
        if field != 1:  # GraphProto.node
            continue
        node = {"op_type": "", "name": "", "inputs": [], "outputs": [],
                "attrs": {}}
        for f2, _, v2 in _fields(value):
            if f2 == 1:
                node["inputs"].append(v2.decode("utf-8"))
            elif f2 == 2:
                node["outputs"].append(v2.decode("utf-8"))
            elif f2 == 3:
                node["name"] = v2.decode("utf-8")
            elif f2 == 4:
                node["op_type"] = v2.decode("utf-8")
            elif f2 == 5:
                k, v = _parse_attribute(v2)
                node["attrs"][k] = v
        nodes.append(node)
    return nodes


# ---------------------------------------------------------------------------
# Writer (tests / checkpoint synthesis)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    if v < 0:
        # protobuf encodes negative int64 as a 10-byte two's-complement
        # varint; without this, `v >>= 7` never terminates for v < 0.
        v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _vi(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    code = _DTYPE_CODES[arr.dtype]
    msg = b"".join(_vi(1, int(d)) for d in arr.shape)
    msg += _vi(2, code)
    msg += _ld(8, name.encode())
    msg += _ld(9, arr.tobytes())
    return msg


def _attr(name: str, value: Any) -> bytes:
    msg = _ld(1, name.encode())
    if isinstance(value, bytes):
        msg += _ld(4, value) + _vi(20, 3)  # type=STRING
    elif isinstance(value, str):
        msg += _ld(4, value.encode()) + _vi(20, 3)
    elif isinstance(value, float):
        msg += _tag(2, 5) + struct.pack("<f", value) + _vi(20, 1)  # FLOAT
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            for v in value:
                msg += _tag(7, 5) + struct.pack("<f", v)
            msg += _vi(20, 6)  # FLOATS
        else:
            for v in value:
                msg += _vi(8, int(v))
            msg += _vi(20, 7)  # INTS
    else:
        msg += _vi(3, int(value)) + _vi(20, 2)  # INT
    return msg


def _value_info(name: str, shape: tuple[int, ...]) -> bytes:
    dims = b"".join(_ld(1, _vi(1, int(d))) for d in shape)  # Dimension.dim_value
    shape_proto = dims
    tensor_type = _vi(1, 1) + _ld(2, shape_proto)  # elem_type=FLOAT, shape
    type_proto = _ld(1, tensor_type)  # TypeProto.tensor_type
    return _ld(1, name.encode()) + _ld(2, type_proto)


def write_onnx_model(
    path: str,
    nodes: list[dict[str, Any]],
    initializers: dict[str, np.ndarray],
    inputs: dict[str, tuple[int, ...]],
    outputs: dict[str, tuple[int, ...]],
    opset: int = 12,
) -> None:
    """Write a loadable ONNX model (readable by cv2.dnn and this module)."""
    graph = b""
    for node in nodes:
        msg = b""
        for i in node.get("inputs", []):
            msg += _ld(1, i.encode())
        for o in node.get("outputs", []):
            msg += _ld(2, o.encode())
        msg += _ld(3, node.get("name", "").encode())
        msg += _ld(4, node["op_type"].encode())
        for k, v in node.get("attrs", {}).items():
            msg += _ld(5, _attr(k, v))
        graph += _ld(1, msg)
    graph += _ld(2, b"imageclust_tpu_graph")
    for name, arr in initializers.items():
        graph += _ld(5, _tensor_proto(name, arr))
    for name, shape in inputs.items():
        graph += _ld(11, _value_info(name, shape))
    for name, shape in outputs.items():
        graph += _ld(12, _value_info(name, shape))

    model = _vi(1, 7)  # ModelProto.ir_version = 1
    model += _ld(2, b"imageclust_tpu")  # producer_name = 2
    model += _ld(7, graph)  # graph = 7
    # opset_import = 8: OperatorSetIdProto {domain=1, version=2}
    model += _ld(8, _ld(1, b"") + _vi(2, opset))
    with open(path, "wb") as fh:
        fh.write(model)
