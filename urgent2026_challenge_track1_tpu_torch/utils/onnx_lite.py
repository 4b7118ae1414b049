"""Dependency-free ONNX model reader and writer in numpy (counterpart of
``utils/onnx_lite.py``).

The reference scores DNSMOS through onnxruntime.  This module decodes the
ONNX ``ModelProto`` container directly from the protobuf wire format into a
small graph IR that ``ops/onnx_torch.py`` executes with torch, so the
metric models need neither ``onnx`` nor ``onnxruntime``.

Only the fields needed to run inference are decoded (graph topology,
attributes, initializer tensors); everything else is skipped field by
field, so models with metadata, docstrings or external-data references
parse (the last fail loudly when their tensor is materialised).  A writer
for the same subset serves the tests and tooling: the bytes it writes are
the JAX package's for the same model.

Field numbers follow the public onnx.proto3 schema (stable since IR v3).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Model", "Graph", "Node", "load", "loads", "dumps"]

# TensorProto.DataType → numpy
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

# AttributeProto.AttributeType
_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_TENSOR = 1, 2, 3, 4
_ATTR_FLOATS, _ATTR_INTS, _ATTR_STRINGS = 6, 7, 8


@dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, object]
    name: str = ""


@dataclass
class Graph:
    nodes: List[Node] = field(default_factory=list)
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    input_shapes: Dict[str, tuple] = field(default_factory=dict)
    name: str = ""


@dataclass
class Model:
    graph: Graph
    ir_version: int = 8
    opset: int = 17


# ---------------------------------------------------------------------------
# wire-format primitives


def _read_varint(buf: memoryview, pos: int):
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
            raise ValueError("corrupt varint")


def _iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a message buffer.

    value: int for varint(0)/fixed64(1)/fixed32(5), memoryview for bytes(2).
    """
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wtype == 5:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            if len(val) != ln:
                raise ValueError("truncated length-delimited field")
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _zigzag_i64(v: int) -> int:
    """Interpret a varint as two's-complement int64 (protobuf int64, not sint64)."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _packed_ints(val, wtype):
    if wtype == 0:  # single unpacked element
        return [_zigzag_i64(val)]
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(_zigzag_i64(v))
    return out


def _packed_floats(val, wtype):
    if wtype == 5:
        return [struct.unpack("<f", struct.pack("<I", val))[0]]
    return list(np.frombuffer(bytes(val), "<f4"))


def _packed_doubles(val, wtype):
    if wtype == 1:
        return [struct.unpack("<d", struct.pack("<Q", val))[0]]
    return list(np.frombuffer(bytes(val), "<f8"))


# ---------------------------------------------------------------------------
# message decoders


def _decode_tensor(buf) -> tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code = 1
    name = ""
    raw: Optional[bytes] = None
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    double_data: List[float] = []
    external = False
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            dims.extend(_packed_ints(val, wtype))
        elif fnum == 2:
            dtype_code = val
        elif fnum == 4:
            float_data.extend(_packed_floats(val, wtype))
        elif fnum == 5:
            int32_data.extend(_packed_ints(val, wtype))
        elif fnum == 7:
            int64_data.extend(_packed_ints(val, wtype))
        elif fnum == 8:
            name = bytes(val).decode()
        elif fnum == 9:
            raw = bytes(val)
        elif fnum == 10:
            double_data.extend(_packed_doubles(val, wtype))
        elif fnum == 13:
            external = True
    if external:
        raise ValueError(f"tensor '{name}' uses external data (unsupported)")
    dtype = _DTYPES.get(dtype_code)
    if dtype is None:
        raise ValueError(f"tensor '{name}': unsupported data_type {dtype_code}")
    if raw is not None:
        arr = np.frombuffer(raw, np.dtype(dtype).newbyteorder("<")).astype(dtype)
    elif float_data:
        arr = np.asarray(float_data, np.float32).astype(dtype)
    elif double_data:
        arr = np.asarray(double_data, np.float64).astype(dtype)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64).astype(dtype)
    elif int32_data:
        # int32_data also carries (u)int8/16, bool and float16 payloads
        if dtype == np.float16:
            arr = np.asarray(int32_data, np.uint16).view(np.float16)
        else:
            arr = np.asarray(int32_data, np.int64).astype(dtype)
    else:
        arr = np.zeros(0, dtype)
    if dims:
        arr = arr.reshape(dims)
    elif arr.size == 1:
        arr = arr.reshape(())
    return name, arr


def _decode_attr(buf):
    name = ""
    atype = None
    single = {}
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            name = bytes(val).decode()
        elif fnum == 20:
            atype = val
        elif fnum == 2:
            single[_ATTR_FLOAT] = struct.unpack("<f", struct.pack("<I", val))[0]
        elif fnum == 3:
            single[_ATTR_INT] = _zigzag_i64(val)
        elif fnum == 4:
            single[_ATTR_STRING] = bytes(val)
        elif fnum == 5:
            single[_ATTR_TENSOR] = _decode_tensor(val)[1]
        elif fnum == 7:
            floats.extend(_packed_floats(val, wtype))
        elif fnum == 8:
            ints.extend(_packed_ints(val, wtype))
        elif fnum == 9:
            strings.append(bytes(val))
    if atype is None:  # infer (older exporters may omit type)
        if _ATTR_FLOAT in single:
            atype = _ATTR_FLOAT
        elif _ATTR_INT in single:
            atype = _ATTR_INT
        elif _ATTR_STRING in single:
            atype = _ATTR_STRING
        elif _ATTR_TENSOR in single:
            atype = _ATTR_TENSOR
        elif floats:
            atype = _ATTR_FLOATS
        elif strings:
            atype = _ATTR_STRINGS
        else:
            atype = _ATTR_INTS
    if atype in single:
        v = single[atype]
        return name, v.decode() if atype == _ATTR_STRING else v
    if atype == _ATTR_FLOATS:
        return name, list(floats)
    if atype == _ATTR_INTS:
        return name, list(ints)
    if atype == _ATTR_STRINGS:
        return name, [s.decode() for s in strings]
    raise ValueError(f"attribute '{name}': unsupported type {atype}")


def _decode_node(buf) -> Node:
    node = Node("", [], [], {})
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            node.inputs.append(bytes(val).decode())
        elif fnum == 2:
            node.outputs.append(bytes(val).decode())
        elif fnum == 3:
            node.name = bytes(val).decode()
        elif fnum == 4:
            node.op_type = bytes(val).decode()
        elif fnum == 5:
            k, v = _decode_attr(val)
            node.attrs[k] = v
    return node


def _decode_value_info(buf):
    name = ""
    shape = None
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            name = bytes(val).decode()
        elif fnum == 2:  # TypeProto
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _iter_fields(v2):
                        if f3 == 2:  # shape
                            dims = []
                            for f4, _w4, v4 in _iter_fields(v3):
                                if f4 == 1:  # dim
                                    dv = None
                                    for f5, _w5, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dv = _zigzag_i64(v5)
                                        elif f5 == 2:
                                            dv = bytes(v5).decode()
                                    dims.append(dv)
                            shape = tuple(dims)
    return name, shape


def _decode_graph(buf) -> Graph:
    g = Graph()
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            g.nodes.append(_decode_node(val))
        elif fnum == 2:
            g.name = bytes(val).decode()
        elif fnum == 5:
            name, arr = _decode_tensor(val)
            g.initializers[name] = arr
        elif fnum == 11:
            name, shape = _decode_value_info(val)
            g.inputs.append(name)
            if shape is not None:
                g.input_shapes[name] = shape
        elif fnum == 12:
            name, _ = _decode_value_info(val)
            g.outputs.append(name)
    # graph inputs that have initializers are parameters, not runtime inputs
    g.inputs = [i for i in g.inputs if i not in g.initializers]
    return g


def loads(data: bytes) -> Model:
    """Parse serialized ONNX ModelProto bytes."""
    buf = memoryview(data)
    graph = None
    ir_version = 0
    opset = 0
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            ir_version = val
        elif fnum == 7:
            graph = _decode_graph(val)
        elif fnum == 8:  # OperatorSetIdProto
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 2:
                    opset = max(opset, _zigzag_i64(v2))
    if graph is None:
        raise ValueError("no graph in ONNX model (is this an ONNX file?)")
    return Model(graph=graph, ir_version=ir_version, opset=opset)


def load(path: str) -> Model:
    with open(path, "rb") as f:
        return loads(f.read())


# ---------------------------------------------------------------------------
# writer (tests/tooling)


def _tag(fnum: int, wtype: int) -> bytes:
    return _write_varint((fnum << 3) | wtype)


def _write_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld(fnum: int, payload: bytes) -> bytes:
    return _tag(fnum, 2) + _write_varint(len(payload)) + payload


def _encode_tensor(name: str, arr: np.ndarray) -> bytes:
    code = _DTYPE_CODES[np.dtype(arr.dtype)]
    out = b""
    for d in arr.shape:
        out += _tag(1, 0) + _write_varint(d)
    out += _tag(2, 0) + _write_varint(code)
    out += _ld(8, name.encode())
    out += _ld(9, np.ascontiguousarray(arr).astype(arr.dtype).tobytes())
    return out


def _encode_attr(name: str, value) -> bytes:
    out = _ld(1, name.encode())
    if isinstance(value, float):
        out += _tag(2, 5) + struct.pack("<f", value)
        out += _tag(20, 0) + _write_varint(_ATTR_FLOAT)
    elif isinstance(value, (bool, int, np.integer)):
        out += _tag(3, 0) + _write_varint(int(value))
        out += _tag(20, 0) + _write_varint(_ATTR_INT)
    elif isinstance(value, str):
        out += _ld(4, value.encode())
        out += _tag(20, 0) + _write_varint(_ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += _ld(5, _encode_tensor("", value))
        out += _tag(20, 0) + _write_varint(_ATTR_TENSOR)
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        for v in value:
            out += _tag(7, 5) + struct.pack("<f", v)
        out += _tag(20, 0) + _write_varint(_ATTR_FLOATS)
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], str):
        for v in value:
            out += _ld(9, v.encode())
        out += _tag(20, 0) + _write_varint(_ATTR_STRINGS)
    elif isinstance(value, (list, tuple)):
        for v in value:
            out += _tag(8, 0) + _write_varint(int(v))
        out += _tag(20, 0) + _write_varint(_ATTR_INTS)
    else:
        raise TypeError(f"cannot encode attribute {name}={value!r}")
    return out


def _encode_value_info(name: str, shape=None, elem_type: int = 1) -> bytes:
    dims = b""
    for d in shape or ():
        if isinstance(d, str):
            dim = _ld(2, d.encode())
        else:
            dim = _tag(1, 0) + _write_varint(int(d))
        dims += _ld(1, dim)
    tensor_type = _tag(1, 0) + _write_varint(elem_type) + _ld(2, dims)
    return _ld(1, name.encode()) + _ld(2, _ld(1, tensor_type))


def dumps(model: Model) -> bytes:
    g = model.graph
    gb = b""
    for node in g.nodes:
        nb = b""
        for i in node.inputs:
            nb += _ld(1, i.encode())
        for o in node.outputs:
            nb += _ld(2, o.encode())
        if node.name:
            nb += _ld(3, node.name.encode())
        nb += _ld(4, node.op_type.encode())
        for k, v in node.attrs.items():
            nb += _ld(5, _encode_attr(k, v))
        gb += _ld(1, nb)
    gb += _ld(2, (g.name or "graph").encode())
    for name, arr in g.initializers.items():
        gb += _ld(5, _encode_tensor(name, arr))
    for name in g.inputs:
        gb += _ld(11, _encode_value_info(name, g.input_shapes.get(name)))
    for name in g.outputs:
        gb += _ld(12, _encode_value_info(name))
    out = _tag(1, 0) + _write_varint(model.ir_version)
    out += _ld(7, gb)
    out += _ld(8, _tag(2, 0) + _write_varint(model.opset))
    return out
