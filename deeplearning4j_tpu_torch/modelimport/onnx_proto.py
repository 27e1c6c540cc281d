"""ONNX protobuf wire codec, decode and encode (↔ deeplearning4j_tpu/modelimport/onnx_proto.py).

The port's own copy of the JAX package's codec: the protobuf wire format
(varint / fixed32 / fixed64 / length-delimited) for the ONNX schema subset
the importer reads and the fixtures write: ModelProto, GraphProto,
NodeProto, AttributeProto (graph-valued attributes included: If branches,
Loop and Scan bodies), TensorProto, ValueInfoProto and the nested
type/shape messages. Field numbers follow the public onnx.proto3 schema
(stable since IR v3). It imports ``struct`` and ``numpy`` only: no
``onnx``, no protobuf, no torch, so it runs where none of them is
installed.

One difference from the JAX package's copy: numpy has no bfloat16, so a
bfloat16 tensor decodes to its exact float32 values
(``TensorProto.to_numpy``); the importer holds it as a ``torch.bfloat16``
constant again. Encoding writes the same bytes as the JAX package's codec
for the same message (``tests/test_torch_onnx_proto.py``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# --- wire primitives -------------------------------------------------------

_WT_VARINT, _WT_64BIT, _WT_LEN, _WT_32BIT = 0, 1, 2, 5


def _write_varint(buf: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement 64-bit, proto int64 rule
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _write_tag(buf: bytearray, num: int, wt: int) -> None:
    _write_varint(buf, (num << 3) | wt)


def _write_len_delim(buf: bytearray, num: int, payload: bytes) -> None:
    _write_tag(buf, num, _WT_LEN)
    _write_varint(buf, len(payload))
    buf.extend(payload)


def _skip(data: bytes, pos: int, wt: int) -> int:
    if wt == _WT_VARINT:
        _, pos = _read_varint(data, pos)
    elif wt == _WT_64BIT:
        pos += 8
    elif wt == _WT_LEN:
        n, pos = _read_varint(data, pos)
        pos += n
    elif wt == _WT_32BIT:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wt}")
    return pos


def _iter_fields(data: bytes):
    """Yield (field_number, wire_type, value_or_span) over a message."""
    pos = 0
    end = len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        num, wt = tag >> 3, tag & 7
        if wt == _WT_VARINT:
            val, pos = _read_varint(data, pos)
            yield num, wt, val
        elif wt == _WT_64BIT:
            yield num, wt, data[pos:pos + 8]
            pos += 8
        elif wt == _WT_LEN:
            n, pos = _read_varint(data, pos)
            yield num, wt, data[pos:pos + n]
            pos += n
        elif wt == _WT_32BIT:
            yield num, wt, data[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _packed_or_single_varints(wt: int, val) -> List[int]:
    """proto3 packed-by-default repeated ints; accept both encodings."""
    if wt == _WT_VARINT:
        return [val]
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


def _packed_or_single_f32(wt: int, val) -> List[float]:
    if wt == _WT_32BIT:
        return [struct.unpack("<f", val)[0]]
    return list(np.frombuffer(val, "<f4").tolist())


def _packed_or_single_f64(wt: int, val) -> List[float]:
    if wt == _WT_64BIT:
        return [struct.unpack("<d", val)[0]]
    return list(np.frombuffer(val, "<f8").tolist())


def _write_packed_varints(buf: bytearray, num: int, values) -> None:
    if not values:
        return
    payload = bytearray()
    for v in values:
        _write_varint(payload, int(v))
    _write_len_delim(buf, num, bytes(payload))


# --- messages --------------------------------------------------------------


@dataclass
class TensorShapeProto:
    # Each dim: int (dim_value), str (dim_param), or None (unknown).
    dims: List[Any] = field(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        for d in self.dims:
            inner = bytearray()
            if isinstance(d, int):
                _write_tag(inner, 1, _WT_VARINT)
                _write_varint(inner, d)
            elif isinstance(d, str):
                _write_len_delim(inner, 2, d.encode())
            _write_len_delim(buf, 1, bytes(inner))
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "TensorShapeProto":
        dims = []
        for num, wt, val in _iter_fields(data):
            if num == 1 and wt == _WT_LEN:
                dim: Any = None
                for n2, wt2, v2 in _iter_fields(val):
                    if n2 == 1 and wt2 == _WT_VARINT:
                        dim = _signed64(v2)
                    elif n2 == 2 and wt2 == _WT_LEN:
                        dim = v2.decode()
                dims.append(dim)
        return cls(dims)


@dataclass
class TypeProto:
    elem_type: int = 0
    shape: Optional[TensorShapeProto] = None

    def encode(self) -> bytes:
        tensor = bytearray()
        if self.elem_type:
            _write_tag(tensor, 1, _WT_VARINT)
            _write_varint(tensor, self.elem_type)
        if self.shape is not None:
            _write_len_delim(tensor, 2, self.shape.encode())
        buf = bytearray()
        _write_len_delim(buf, 1, bytes(tensor))  # tensor_type oneof
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "TypeProto":
        out = cls()
        for num, wt, val in _iter_fields(data):
            if num == 1 and wt == _WT_LEN:  # tensor_type
                for n2, wt2, v2 in _iter_fields(val):
                    if n2 == 1 and wt2 == _WT_VARINT:
                        out.elem_type = v2
                    elif n2 == 2 and wt2 == _WT_LEN:
                        out.shape = TensorShapeProto.decode(v2)
        return out


@dataclass
class ValueInfoProto:
    name: str = ""
    type: Optional[TypeProto] = None

    def encode(self) -> bytes:
        buf = bytearray()
        if self.name:
            _write_len_delim(buf, 1, self.name.encode())
        if self.type is not None:
            _write_len_delim(buf, 2, self.type.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "ValueInfoProto":
        out = cls()
        for num, wt, val in _iter_fields(data):
            if num == 1 and wt == _WT_LEN:
                out.name = val.decode()
            elif num == 2 and wt == _WT_LEN:
                out.type = TypeProto.decode(val)
        return out


# onnx TensorProto.DataType values
TENSOR_DTYPES: Dict[int, str] = {
    1: "float32", 2: "uint8", 3: "int8", 4: "uint16", 5: "int16",
    6: "int32", 7: "int64", 9: "bool", 10: "float16", 11: "float64",
    12: "uint32", 13: "uint64", 16: "bfloat16",
}
_DTYPE_TO_ONNX = {v: k for k, v in TENSOR_DTYPES.items()}


@dataclass
class TensorProto:
    dims: List[int] = field(default_factory=list)
    data_type: int = 0
    raw_data: bytes = b""
    float_data: List[float] = field(default_factory=list)
    int32_data: List[int] = field(default_factory=list)
    int64_data: List[int] = field(default_factory=list)
    double_data: List[float] = field(default_factory=list)
    name: str = ""

    def encode(self) -> bytes:
        buf = bytearray()
        _write_packed_varints(buf, 1, self.dims)
        if self.data_type:
            _write_tag(buf, 2, _WT_VARINT)
            _write_varint(buf, self.data_type)
        if self.float_data:
            _write_len_delim(
                buf, 4, np.asarray(self.float_data, "<f4").tobytes())
        _write_packed_varints(buf, 5, self.int32_data)
        _write_packed_varints(buf, 7, self.int64_data)
        if self.name:
            _write_len_delim(buf, 8, self.name.encode())
        if self.raw_data:
            _write_len_delim(buf, 9, self.raw_data)
        if self.double_data:
            _write_len_delim(
                buf, 10, np.asarray(self.double_data, "<f8").tobytes())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "TensorProto":
        out = cls()
        for num, wt, val in _iter_fields(data):
            if num == 1:
                out.dims.extend(_signed64(v)
                                for v in _packed_or_single_varints(wt, val))
            elif num == 2 and wt == _WT_VARINT:
                out.data_type = val
            elif num == 4:
                out.float_data.extend(_packed_or_single_f32(wt, val))
            elif num == 5:
                out.int32_data.extend(
                    _signed64(v) for v in _packed_or_single_varints(wt, val))
            elif num == 7:
                out.int64_data.extend(
                    _signed64(v) for v in _packed_or_single_varints(wt, val))
            elif num == 8 and wt == _WT_LEN:
                out.name = val.decode()
            elif num == 9 and wt == _WT_LEN:
                out.raw_data = val
            elif num == 10:
                out.double_data.extend(_packed_or_single_f64(wt, val))
        return out

    # -- numpy bridge --

    def to_numpy(self) -> np.ndarray:
        if self.data_type not in TENSOR_DTYPES:
            raise ValueError(f"unsupported ONNX tensor dtype {self.data_type}")
        np_dtype = TENSOR_DTYPES[self.data_type]
        shape = tuple(self.dims)
        if np_dtype == "bfloat16":
            return _bfloat16_values(self).reshape(shape)
        if self.raw_data:
            arr = np.frombuffer(self.raw_data, np.dtype(np_dtype).newbyteorder("<"))
            return arr.reshape(shape).astype(np_dtype)
        if self.float_data:
            return np.asarray(self.float_data, "float32").reshape(shape).astype(np_dtype)
        if self.double_data:
            return np.asarray(self.double_data, "float64").reshape(shape).astype(np_dtype)
        if self.int64_data:
            return np.asarray(self.int64_data, "int64").reshape(shape).astype(np_dtype)
        if self.int32_data:
            # int32_data also carries bool/int8/int16/uint8/uint16/float16/
            # bfloat16 per spec; the 16-bit float types are stored as raw
            # bit patterns in the low uint16, NOT as numeric values.
            raw = np.asarray(self.int32_data, "int64")
            if np_dtype == "float16":
                return raw.astype(np.uint16).view(np.float16).reshape(shape)
            return raw.reshape(shape).astype(np_dtype)
        return np.zeros(shape, np_dtype)

    @classmethod
    def from_numpy(cls, arr: np.ndarray, name: str = "") -> "TensorProto":
        arr = np.ascontiguousarray(arr)
        key = arr.dtype.name
        if key not in _DTYPE_TO_ONNX:
            raise ValueError(f"unsupported numpy dtype {arr.dtype}")
        return cls(dims=list(arr.shape), data_type=_DTYPE_TO_ONNX[key],
                   raw_data=arr.astype(arr.dtype.newbyteorder("<")).tobytes(),
                   name=name)


def _bfloat16_values(t: TensorProto) -> np.ndarray:
    """A bfloat16 tensor's values as float32 (exact: a bfloat16 is the
    high half of a float32), from raw_data or int32_data's bit patterns."""
    if t.raw_data:
        bits = np.frombuffer(t.raw_data, "<u2")
    elif t.int32_data:
        bits = np.asarray(t.int32_data, "int64").astype(np.uint16)
    else:
        bits = np.zeros(int(np.prod(t.dims, dtype=np.int64)), np.uint16)
    return (bits.astype(np.uint32) << 16).view(np.float32)


# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_GRAPH = 5
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


@dataclass
class AttributeProto:
    name: str = ""
    type: int = 0
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional[TensorProto] = None
    g: Optional["GraphProto"] = None  # control-flow branch/body graphs
    floats: List[float] = field(default_factory=list)
    ints: List[int] = field(default_factory=list)
    strings: List[bytes] = field(default_factory=list)

    def value(self):
        if self.type == ATTR_FLOAT:
            return self.f
        if self.type == ATTR_INT:
            return self.i
        if self.type == ATTR_STRING:
            return self.s.decode()
        if self.type == ATTR_TENSOR:
            return self.t
        if self.type == ATTR_GRAPH:
            return self.g
        if self.type == ATTR_FLOATS:
            return list(self.floats)
        if self.type == ATTR_INTS:
            return list(self.ints)
        if self.type == ATTR_STRINGS:
            return [s.decode() for s in self.strings]
        raise ValueError(f"unsupported attribute type {self.type} ({self.name})")

    def encode(self) -> bytes:
        buf = bytearray()
        if self.name:
            _write_len_delim(buf, 1, self.name.encode())
        if self.type == ATTR_FLOAT:
            _write_tag(buf, 2, _WT_32BIT)
            buf.extend(struct.pack("<f", self.f))
        elif self.type == ATTR_INT:
            _write_tag(buf, 3, _WT_VARINT)
            _write_varint(buf, self.i)
        elif self.type == ATTR_STRING:
            _write_len_delim(buf, 4, self.s)
        elif self.type == ATTR_TENSOR:
            _write_len_delim(buf, 5, self.t.encode())
        elif self.type == ATTR_GRAPH:
            _write_len_delim(buf, 6, self.g.encode())
        elif self.type == ATTR_FLOATS:
            _write_len_delim(buf, 7, np.asarray(self.floats, "<f4").tobytes())
        elif self.type == ATTR_INTS:
            _write_packed_varints(buf, 8, self.ints)
        elif self.type == ATTR_STRINGS:
            for s in self.strings:
                _write_len_delim(buf, 9, s)
        _write_tag(buf, 20, _WT_VARINT)
        _write_varint(buf, self.type)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "AttributeProto":
        out = cls()
        for num, wt, val in _iter_fields(data):
            if num == 1 and wt == _WT_LEN:
                out.name = val.decode()
            elif num == 2 and wt == _WT_32BIT:
                out.f = struct.unpack("<f", val)[0]
            elif num == 3 and wt == _WT_VARINT:
                out.i = _signed64(val)
            elif num == 4 and wt == _WT_LEN:
                out.s = val
            elif num == 5 and wt == _WT_LEN:
                out.t = TensorProto.decode(val)
            elif num == 6 and wt == _WT_LEN:
                # GraphProto is defined later in this module; by decode
                # time (runtime) the name resolves
                out.g = GraphProto.decode(val)
            elif num == 7:
                out.floats.extend(_packed_or_single_f32(wt, val))
            elif num == 8:
                out.ints.extend(
                    _signed64(v) for v in _packed_or_single_varints(wt, val))
            elif num == 9 and wt == _WT_LEN:
                out.strings.append(val)
            elif num == 20 and wt == _WT_VARINT:
                out.type = val
        if not out.type:
            # Pre-IR3 writers omit `type`; infer from the populated field.
            if out.t is not None:
                out.type = ATTR_TENSOR
            elif out.g is not None:
                out.type = ATTR_GRAPH
            elif out.floats:
                out.type = ATTR_FLOATS
            elif out.ints:
                out.type = ATTR_INTS
            elif out.strings:
                out.type = ATTR_STRINGS
            elif out.s:
                out.type = ATTR_STRING
        return out


@dataclass
class NodeProto:
    input: List[str] = field(default_factory=list)
    output: List[str] = field(default_factory=list)
    name: str = ""
    op_type: str = ""
    attribute: List[AttributeProto] = field(default_factory=list)
    domain: str = ""

    def attrs(self) -> Dict[str, Any]:
        return {a.name: a.value() for a in self.attribute}

    def encode(self) -> bytes:
        buf = bytearray()
        for s in self.input:
            _write_len_delim(buf, 1, s.encode())
        for s in self.output:
            _write_len_delim(buf, 2, s.encode())
        if self.name:
            _write_len_delim(buf, 3, self.name.encode())
        if self.op_type:
            _write_len_delim(buf, 4, self.op_type.encode())
        for a in self.attribute:
            _write_len_delim(buf, 5, a.encode())
        if self.domain:
            _write_len_delim(buf, 7, self.domain.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "NodeProto":
        out = cls()
        for num, wt, val in _iter_fields(data):
            if num == 1 and wt == _WT_LEN:
                out.input.append(val.decode())
            elif num == 2 and wt == _WT_LEN:
                out.output.append(val.decode())
            elif num == 3 and wt == _WT_LEN:
                out.name = val.decode()
            elif num == 4 and wt == _WT_LEN:
                out.op_type = val.decode()
            elif num == 5 and wt == _WT_LEN:
                out.attribute.append(AttributeProto.decode(val))
            elif num == 7 and wt == _WT_LEN:
                out.domain = val.decode()
        return out


@dataclass
class GraphProto:
    node: List[NodeProto] = field(default_factory=list)
    name: str = ""
    initializer: List[TensorProto] = field(default_factory=list)
    input: List[ValueInfoProto] = field(default_factory=list)
    output: List[ValueInfoProto] = field(default_factory=list)
    value_info: List[ValueInfoProto] = field(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        for n in self.node:
            _write_len_delim(buf, 1, n.encode())
        if self.name:
            _write_len_delim(buf, 2, self.name.encode())
        for t in self.initializer:
            _write_len_delim(buf, 5, t.encode())
        for v in self.input:
            _write_len_delim(buf, 11, v.encode())
        for v in self.output:
            _write_len_delim(buf, 12, v.encode())
        for v in self.value_info:
            _write_len_delim(buf, 13, v.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "GraphProto":
        out = cls()
        for num, wt, val in _iter_fields(data):
            if num == 1 and wt == _WT_LEN:
                out.node.append(NodeProto.decode(val))
            elif num == 2 and wt == _WT_LEN:
                out.name = val.decode()
            elif num == 5 and wt == _WT_LEN:
                out.initializer.append(TensorProto.decode(val))
            elif num == 11 and wt == _WT_LEN:
                out.input.append(ValueInfoProto.decode(val))
            elif num == 12 and wt == _WT_LEN:
                out.output.append(ValueInfoProto.decode(val))
            elif num == 13 and wt == _WT_LEN:
                out.value_info.append(ValueInfoProto.decode(val))
        return out


@dataclass
class OperatorSetIdProto:
    domain: str = ""
    version: int = 0

    def encode(self) -> bytes:
        buf = bytearray()
        if self.domain:
            _write_len_delim(buf, 1, self.domain.encode())
        if self.version:
            _write_tag(buf, 2, _WT_VARINT)
            _write_varint(buf, self.version)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "OperatorSetIdProto":
        out = cls()
        for num, wt, val in _iter_fields(data):
            if num == 1 and wt == _WT_LEN:
                out.domain = val.decode()
            elif num == 2 and wt == _WT_VARINT:
                out.version = _signed64(val)
        return out


@dataclass
class ModelProto:
    ir_version: int = 8
    producer_name: str = ""
    graph: Optional[GraphProto] = None
    opset_import: List[OperatorSetIdProto] = field(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        if self.ir_version:
            _write_tag(buf, 1, _WT_VARINT)
            _write_varint(buf, self.ir_version)
        if self.producer_name:
            _write_len_delim(buf, 2, self.producer_name.encode())
        if self.graph is not None:
            _write_len_delim(buf, 7, self.graph.encode())
        for op in self.opset_import:
            _write_len_delim(buf, 8, op.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "ModelProto":
        out = cls(ir_version=0)
        for num, wt, val in _iter_fields(data):
            if num == 1 and wt == _WT_VARINT:
                out.ir_version = _signed64(val)
            elif num == 2 and wt == _WT_LEN:
                out.producer_name = val.decode()
            elif num == 7 and wt == _WT_LEN:
                out.graph = GraphProto.decode(val)
            elif num == 8 and wt == _WT_LEN:
                out.opset_import.append(OperatorSetIdProto.decode(val))
        return out
