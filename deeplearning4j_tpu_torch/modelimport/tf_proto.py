"""TensorFlow GraphDef wire codec — no ``tensorflow`` / ``protobuf`` needed.

The JAX package's TF importer reads TensorFlow's own proto objects and
``tensor_util.MakeNdarray`` (deeplearning4j_tpu/modelimport/tf.py). The
port's importer must run where neither TensorFlow nor the protobuf package
is installed, so this module implements the protobuf wire format (varint /
fixed32 / fixed64 / length-delimited, as ``onnx_proto.py`` does for ONNX)
for the subset of the public schema the importer reads:

- ``graph.proto``        GraphDef {node = 1, library = 2, version = 3,
                         versions = 4, debug_info = 5}
- ``function.proto``     FunctionDefLibrary {function = 1, gradient = 2,
                         registered_gradients = 3}, FunctionDef
                         {signature = 1, node_def = 3, ret = 4 (map<string,
                         string>), attr = 5, control_ret = 6, arg_attr = 7,
                         resource_arg_unique_id = 8}
- ``op_def.proto``       OpDef {name = 1, input_arg = 2, output_arg = 3,
                         attr = 4, ...}, ArgDef {name = 1, description = 2,
                         type = 3, type_attr = 4, number_attr = 5,
                         type_list_attr = 6, handle_data = 7, ...}
- ``node_def.proto``     NodeDef {name = 1, op = 2, input = 3, device = 4,
                         attr = 5 (map<string, AttrValue>), ...}
- ``attr_value.proto``   AttrValue (oneof list = 1, s = 2, i = 3, f = 4,
                         b = 5, type = 6, shape = 7, tensor = 8,
                         placeholder = 9, func = 10), ListValue,
                         NameAttrList
- ``tensor.proto``       TensorProto {dtype = 1, tensor_shape = 2,
                         version_number = 3, tensor_content = 4, the typed
                         ``*_val`` fields 5-17}
- ``tensor_shape.proto`` TensorShapeProto {dim = 2 {size = 1, name = 2},
                         unknown_rank = 3}

Fields outside the subset (versions, debug info, an OpDef's attrs) are
kept as raw bytes and written back unchanged after the decoded fields.
Each message writes its fields in field-number order and its maps in the
order of protobuf's deterministic serialization (``_map_keys``), so decode
→ encode of a TensorFlow graph gives ``SerializeToString(deterministic=
True)`` of the parsed graph, byte for byte. A function-valued attr
(``While``'s ``cond``/``body``, ``If``'s branches) is a ``NameAttrList``;
a list attr of types or shapes (``T``, ``output_shapes``) a ``ListValue``.

``make_ndarray`` is ``tensor_util.MakeNdarray``'s rule: the
bytes of ``tensor_content`` when present (a read-only numpy view into the
decoded buffer: a 440 MB graph is not copied), else the typed values, a
short list padded with its last value to the full shape. bfloat16 has no
numpy dtype: such a tensor comes back as a ``torch.bfloat16`` tensor.

Both directions are implemented: decode (the importer) and encode (the
card check writes its frozen GraphDefs with it). Encoding collects
byte chunks and joins them once, so a large ``tensor_content`` is copied
once.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# --- wire primitives -------------------------------------------------------

_WT_VARINT, _WT_64BIT, _WT_LEN, _WT_32BIT = 0, 1, 2, 5


def _varint(value: int) -> bytes:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement 64-bit, proto int64 rule
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data, pos: int) -> Tuple[int, int]:
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


def _iter_fields(data):
    """Yield (field_number, wire_type, value, raw) over a message held in
    a memoryview: value is an int (varint), or a memoryview slice; raw is
    the field's bytes, tag included (kept for unknown fields)."""
    pos = 0
    end = len(data)
    while pos < end:
        start = pos
        tag, pos = _read_varint(data, pos)
        num, wt = tag >> 3, tag & 7
        if wt == _WT_VARINT:
            val, pos = _read_varint(data, pos)
        elif wt == _WT_64BIT:
            val = data[pos:pos + 8]
            pos += 8
        elif wt == _WT_LEN:
            n, pos = _read_varint(data, pos)
            val = data[pos:pos + n]
            pos += n
        elif wt == _WT_32BIT:
            val = data[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        if pos > end:
            raise ValueError("truncated message")
        yield num, wt, val, data[start:pos]


def _varints(wt: int, val) -> List[int]:
    if wt == _WT_VARINT:
        return [val]
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


class _Writer:
    """Byte chunks of one message and their total length: a nested
    message is a tag, a length and its chunks, never re-copied."""

    def __init__(self):
        self.chunks: List[Any] = []
        self.size = 0

    def _put(self, b) -> None:
        self.chunks.append(b)
        self.size += len(b) if not isinstance(b, memoryview) else b.nbytes

    def varint(self, num: int, value: int) -> None:
        self._put(_varint(num << 3 | _WT_VARINT) + _varint(int(value)))

    def fixed32f(self, num: int, value: float) -> None:
        self._put(_varint(num << 3 | _WT_32BIT) + struct.pack("<f", value))

    def raw(self, raw) -> None:
        self._put(raw)

    def bytes_(self, num: int, payload) -> None:
        n = payload.nbytes if isinstance(payload, memoryview) else len(payload)
        self._put(_varint(num << 3 | _WT_LEN) + _varint(n))
        if n:
            self._put(payload)

    def message(self, num: int, sub: "_Writer") -> None:
        self._put(_varint(num << 3 | _WT_LEN) + _varint(sub.size))
        self.chunks.extend(sub.chunks)
        self.size += sub.size

    def packed(self, num: int, arr: np.ndarray) -> None:
        if len(arr):
            self.bytes_(num, np.ascontiguousarray(arr).tobytes())

    def packed_varints(self, num: int, values) -> None:
        if len(values):
            self.bytes_(num, b"".join(_varint(int(v)) for v in values))

    def join(self) -> bytes:
        return b"".join(self.chunks)


# --- dtypes ----------------------------------------------------------------

# DataType enum (types.proto) → numpy dtype name
DT_NUMPY = {
    1: "float32", 2: "float64", 3: "int32", 4: "uint8", 5: "int16",
    6: "int8", 8: "complex64", 9: "int64", 10: "bool", 11: "int8",
    12: "uint8", 13: "int32", 14: "bfloat16", 15: "int16", 16: "uint16",
    17: "uint16", 18: "complex128", 19: "float16", 22: "uint32",
    23: "uint64",
}
DT_STRING = 7
NUMPY_DT = {"float32": 1, "float64": 2, "int32": 3, "uint8": 4, "int16": 5,
            "int8": 6, "complex64": 8, "int64": 9, "bool": 10,
            "bfloat16": 14, "uint16": 17, "complex128": 18, "float16": 19,
            "uint32": 22, "uint64": 23}


# --- messages --------------------------------------------------------------


@dataclass
class Dim:
    size: int = 0
    name: str = ""


@dataclass
class TensorShapeProto:
    dim: List[Dim] = field(default_factory=list)
    unknown_rank: bool = False

    @classmethod
    def decode(cls, data) -> "TensorShapeProto":
        out = cls()
        for num, wt, val, _ in _iter_fields(data):
            if num == 2 and wt == _WT_LEN:
                d = Dim()
                for n2, wt2, v2, _ in _iter_fields(val):
                    if n2 == 1 and wt2 == _WT_VARINT:
                        d.size = _signed64(v2)
                    elif n2 == 2 and wt2 == _WT_LEN:
                        d.name = bytes(v2).decode()
                out.dim.append(d)
            elif num == 3 and wt == _WT_VARINT:
                out.unknown_rank = bool(val)
        return out

    def writer(self) -> _Writer:
        w = _Writer()
        for d in self.dim:
            dw = _Writer()
            if d.size:
                dw.varint(1, d.size)
            if d.name:
                dw.bytes_(2, d.name.encode())
            w.message(2, dw)
        if self.unknown_rank:
            w.varint(3, 1)
        return w

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(d.size for d in self.dim)


# the typed value fields of TensorProto: field -> (name, numpy dtype of the
# packed wire values, or None for varints)
_VAL_FIELDS = {
    5: ("float_val", "<f4"), 6: ("double_val", "<f8"),
    7: ("int_val", None), 9: ("scomplex_val", "<f4"),
    10: ("int64_val", None), 11: ("bool_val", None),
    12: ("dcomplex_val", "<f8"), 13: ("half_val", None),
    16: ("uint32_val", None), 17: ("uint64_val", None),
}


@dataclass
class TensorProto:
    dtype: int = 0
    tensor_shape: TensorShapeProto = field(default_factory=TensorShapeProto)
    version_number: int = 0
    tensor_content: Any = b""
    # typed values, by field name (``float_val``...): numpy arrays
    vals: Dict[str, np.ndarray] = field(default_factory=dict)
    string_val: List[bytes] = field(default_factory=list)
    unknown: List[Any] = field(default_factory=list)

    @classmethod
    def decode(cls, data) -> "TensorProto":
        out = cls()
        parts: Dict[str, list] = {}
        for num, wt, val, raw in _iter_fields(data):
            if num == 1 and wt == _WT_VARINT:
                out.dtype = val
            elif num == 2 and wt == _WT_LEN:
                out.tensor_shape = TensorShapeProto.decode(val)
            elif num == 3 and wt == _WT_VARINT:
                out.version_number = _signed64(val)
            elif num == 4 and wt == _WT_LEN:
                out.tensor_content = val  # a view into the decoded buffer
            elif num == 8 and wt == _WT_LEN:
                out.string_val.append(bytes(val))
            elif num in _VAL_FIELDS:
                name, np_dtype = _VAL_FIELDS[num]
                if np_dtype is None:
                    vals = _varints(wt, val)
                    if name in ("int_val", "int64_val"):
                        vals = [_signed64(v) for v in vals]
                    arr = np.asarray(vals, np.uint64 if name == "uint64_val"
                                     else np.int64)
                else:  # fixed width, packed or one value
                    arr = np.frombuffer(bytes(val), np_dtype)
                parts.setdefault(name, []).append(arr)
            else:
                out.unknown.append(raw)
        out.vals = {k: np.concatenate(v) for k, v in parts.items()}
        return out

    def writer(self) -> _Writer:
        w = _Writer()
        if self.dtype:
            w.varint(1, self.dtype)
        w.message(2, self.tensor_shape.writer())
        if self.version_number:
            w.varint(3, self.version_number)
        content = self.tensor_content
        if len(content):
            w.bytes_(4, content)
        for num, (name, np_dtype) in _VAL_FIELDS.items():
            arr = self.vals.get(name)
            if arr is None or not len(arr):
                continue
            if np_dtype is None:
                w.packed_varints(num, arr)
            else:
                w.packed(num, np.asarray(arr, np_dtype))
        for s in self.string_val:
            w.bytes_(8, s)
        for raw in self.unknown:
            w.raw(raw)
        return w


@dataclass
class ListValue:
    s: List[bytes] = field(default_factory=list)
    i: List[int] = field(default_factory=list)
    f: List[float] = field(default_factory=list)
    b: List[bool] = field(default_factory=list)
    type: List[int] = field(default_factory=list)
    shape: List[TensorShapeProto] = field(default_factory=list)
    tensor: List[TensorProto] = field(default_factory=list)
    func: List["NameAttrList"] = field(default_factory=list)

    @classmethod
    def decode(cls, data) -> "ListValue":
        out = cls()
        for num, wt, val, _ in _iter_fields(data):
            if num == 2:
                out.s.append(bytes(val))
            elif num == 3:
                out.i.extend(_signed64(v) for v in _varints(wt, val))
            elif num == 4:
                out.f.extend(float(v) for v in np.frombuffer(
                    bytes(val), "<f4"))
            elif num == 5:
                out.b.extend(bool(v) for v in _varints(wt, val))
            elif num == 6:
                out.type.extend(_varints(wt, val))
            elif num == 7:
                out.shape.append(TensorShapeProto.decode(val))
            elif num == 8:
                out.tensor.append(TensorProto.decode(val))
            elif num == 9:
                out.func.append(NameAttrList.decode(val))
        return out

    def writer(self) -> _Writer:
        w = _Writer()
        for s in self.s:
            w.bytes_(2, s)
        w.packed_varints(3, self.i)
        w.packed(4, np.asarray(self.f, "<f4"))
        w.packed_varints(5, [int(v) for v in self.b])
        w.packed_varints(6, self.type)
        for s in self.shape:
            w.message(7, s.writer())
        for t in self.tensor:
            w.message(8, t.writer())
        for fn in self.func:
            w.message(9, fn.writer())
        return w


_ATTR_KINDS = {1: "list", 2: "s", 3: "i", 4: "f", 5: "b", 6: "type",
               7: "shape", 8: "tensor", 9: "placeholder", 10: "func"}
_KIND_NUM = {k: n for n, k in _ATTR_KINDS.items()}


@dataclass
class AttrValue:
    """The ``value`` oneof: ``kind`` names the set field (``"i"``,
    ``"list"``, ``"tensor"``...), ``value`` holds it."""

    kind: Optional[str] = None
    value: Any = None

    @classmethod
    def decode(cls, data) -> "AttrValue":
        out = cls()
        for num, wt, val, _ in _iter_fields(data):
            kind = _ATTR_KINDS.get(num)
            if kind is None:
                continue
            out.kind = kind
            if kind == "list":
                out.value = ListValue.decode(val)
            elif kind in ("s",):
                out.value = bytes(val)
            elif kind == "placeholder":
                out.value = bytes(val).decode()
            elif kind == "i":
                out.value = _signed64(val)
            elif kind == "f":
                out.value = struct.unpack("<f", bytes(val))[0]
            elif kind == "b":
                out.value = bool(val)
            elif kind == "type":
                out.value = val
            elif kind == "shape":
                out.value = TensorShapeProto.decode(val)
            elif kind == "tensor":
                out.value = TensorProto.decode(val)
            elif kind == "func":
                out.value = NameAttrList.decode(val)
        return out

    def writer(self) -> _Writer:
        w = _Writer()
        num = _KIND_NUM.get(self.kind)
        if num is None:
            return w
        v = self.value
        if self.kind in ("i", "b", "type"):
            w.varint(num, int(v))
        elif self.kind == "f":
            w.fixed32f(num, v)
        elif self.kind == "s":
            w.bytes_(num, v)
        elif self.kind == "placeholder":
            w.bytes_(num, v.encode())
        else:
            w.message(num, v.writer())
        return w


def _decode_attr_map(data, into: Dict[str, AttrValue]) -> None:
    key, value = "", AttrValue()
    for n2, _, v2, _ in _iter_fields(data):
        if n2 == 1:
            key = bytes(v2).decode()
        elif n2 == 2:
            value = AttrValue.decode(v2)
    into[key] = value


def _map_keys(keys):
    """Map keys in the order protobuf's deterministic serialization
    writes them (the upb runtime's): string keys by their bytes, a key
    after every longer key it is a prefix of ("Tidx" before "T");
    integer keys descending."""
    keys = list(keys)
    if keys and isinstance(keys[0], int):
        return sorted(keys, reverse=True)
    return sorted(keys, key=lambda k: k.encode() + b"\xff")


def _write_attr_map(w: _Writer, num: int, attrs: Dict[str, AttrValue]) -> None:
    for key in _map_keys(attrs):
        entry = _Writer()
        entry.bytes_(1, key.encode())
        entry.message(2, attrs[key].writer())
        w.message(num, entry)


@dataclass
class NameAttrList:
    name: str = ""
    attr: Dict[str, AttrValue] = field(default_factory=dict)

    @classmethod
    def decode(cls, data) -> "NameAttrList":
        out = cls()
        for num, wt, val, _ in _iter_fields(data):
            if num == 1:
                out.name = bytes(val).decode()
            elif num == 2:
                _decode_attr_map(val, out.attr)
        return out

    def writer(self) -> _Writer:
        w = _Writer()
        if self.name:
            w.bytes_(1, self.name.encode())
        _write_attr_map(w, 2, self.attr)
        return w


@dataclass
class NodeDef:
    name: str = ""
    op: str = ""
    input: List[str] = field(default_factory=list)
    device: str = ""
    attr: Dict[str, AttrValue] = field(default_factory=dict)
    unknown: List[Any] = field(default_factory=list)

    @classmethod
    def decode(cls, data) -> "NodeDef":
        out = cls()
        for num, wt, val, raw in _iter_fields(data):
            if num == 1:
                out.name = bytes(val).decode()
            elif num == 2:
                out.op = bytes(val).decode()
            elif num == 3:
                out.input.append(bytes(val).decode())
            elif num == 4:
                out.device = bytes(val).decode()
            elif num == 5:
                _decode_attr_map(val, out.attr)
            else:
                out.unknown.append(raw)
        return out

    def writer(self) -> _Writer:
        w = _Writer()
        w.bytes_(1, self.name.encode())
        w.bytes_(2, self.op.encode())
        for i in self.input:
            w.bytes_(3, i.encode())
        if self.device:
            w.bytes_(4, self.device.encode())
        _write_attr_map(w, 5, self.attr)
        for raw in self.unknown:
            w.raw(raw)
        return w


@dataclass
class ArgDef:
    """OpDef.ArgDef: one input or output of a function's signature."""

    name: str = ""
    description: str = ""
    type: int = 0
    type_attr: str = ""
    number_attr: str = ""
    type_list_attr: str = ""
    unknown: List[Any] = field(default_factory=list)  # fields 7, 16, 17

    @classmethod
    def decode(cls, data) -> "ArgDef":
        out = cls()
        for num, wt, val, raw in _iter_fields(data):
            if num == 3 and wt == _WT_VARINT:
                out.type = val
            elif num in (1, 2, 4, 5, 6) and wt == _WT_LEN:
                setattr(out, _ARG_STR[num], bytes(val).decode())
            else:
                out.unknown.append(raw)
        return out

    def writer(self) -> _Writer:
        w = _Writer()
        for num in (1, 2, 3, 4, 5, 6):
            if num == 3:
                if self.type:
                    w.varint(3, self.type)
                continue
            v = getattr(self, _ARG_STR[num])
            if v:
                w.bytes_(num, v.encode())
        for raw in self.unknown:
            w.raw(raw)
        return w


_ARG_STR = {1: "name", 2: "description", 4: "type_attr", 5: "number_attr",
            6: "type_list_attr"}


@dataclass
class OpDef:
    """A function's signature: its name and typed inputs and outputs (the
    attrs, summary and flags after them kept raw)."""

    name: str = ""
    input_arg: List[ArgDef] = field(default_factory=list)
    output_arg: List[ArgDef] = field(default_factory=list)
    unknown: List[Any] = field(default_factory=list)

    @classmethod
    def decode(cls, data) -> "OpDef":
        out = cls()
        for num, wt, val, raw in _iter_fields(data):
            if num == 1 and wt == _WT_LEN:
                out.name = bytes(val).decode()
            elif num == 2 and wt == _WT_LEN:
                out.input_arg.append(ArgDef.decode(val))
            elif num == 3 and wt == _WT_LEN:
                out.output_arg.append(ArgDef.decode(val))
            else:
                out.unknown.append(raw)
        return out

    def writer(self) -> _Writer:
        w = _Writer()
        if self.name:
            w.bytes_(1, self.name.encode())
        for a in self.input_arg:
            w.message(2, a.writer())
        for a in self.output_arg:
            w.message(3, a.writer())
        for raw in self.unknown:
            w.raw(raw)
        return w


def _decode_str_map(data, into: Dict[str, str]) -> None:
    key, value = "", ""
    for n2, _, v2, _ in _iter_fields(data):
        if n2 == 1:
            key = bytes(v2).decode()
        elif n2 == 2:
            value = bytes(v2).decode()
    into[key] = value


@dataclass
class FunctionDef:
    """A function of the library: ``signature`` (an OpDef), its body
    ``node_def`` (inputs named ``node:out_arg:idx`` or by argument name)
    and ``ret`` mapping each output argument to a body tensor."""

    signature: OpDef = field(default_factory=OpDef)
    node_def: List[NodeDef] = field(default_factory=list)
    ret: Dict[str, str] = field(default_factory=dict)
    attr: Dict[str, AttrValue] = field(default_factory=dict)
    control_ret: Dict[str, str] = field(default_factory=dict)
    arg_attr: Dict[int, Dict[str, AttrValue]] = field(default_factory=dict)
    resource_arg_unique_id: Dict[int, int] = field(default_factory=dict)

    @classmethod
    def decode(cls, data) -> "FunctionDef":
        out = cls()
        for num, wt, val, raw in _iter_fields(data):
            if num == 1:
                out.signature = OpDef.decode(val)
            elif num == 3:
                out.node_def.append(NodeDef.decode(val))
            elif num == 4:
                _decode_str_map(val, out.ret)
            elif num == 5:
                _decode_attr_map(val, out.attr)
            elif num == 6:
                _decode_str_map(val, out.control_ret)
            elif num == 7:
                key, attrs = 0, {}
                for n2, _, v2, _ in _iter_fields(val):
                    if n2 == 1:
                        key = v2
                    elif n2 == 2:  # ArgAttrs {attr = 1}
                        for n3, _, v3, _ in _iter_fields(v2):
                            if n3 == 1:
                                _decode_attr_map(v3, attrs)
                out.arg_attr[key] = attrs
            elif num == 8:
                key = value = 0
                for n2, _, v2, _ in _iter_fields(val):
                    if n2 == 1:
                        key = v2
                    elif n2 == 2:
                        value = v2
                out.resource_arg_unique_id[key] = value
        return out

    def writer(self) -> _Writer:
        w = _Writer()
        w.message(1, self.signature.writer())
        for n in self.node_def:
            w.message(3, n.writer())
        _write_str_map(w, 4, self.ret)
        _write_attr_map(w, 5, self.attr)
        _write_str_map(w, 6, self.control_ret)
        for key in _map_keys(self.arg_attr):
            entry, arg_attrs = _Writer(), _Writer()
            entry.varint(1, key)  # a map entry writes its key and value
            _write_attr_map(arg_attrs, 1, self.arg_attr[key])
            entry.message(2, arg_attrs)
            w.message(7, entry)
        for key in _map_keys(self.resource_arg_unique_id):
            entry = _Writer()
            entry.varint(1, key)
            entry.varint(2, self.resource_arg_unique_id[key])
            w.message(8, entry)
        return w


def _write_str_map(w: _Writer, num: int, m: Dict[str, str]) -> None:
    for key in _map_keys(m):
        entry = _Writer()
        entry.bytes_(1, key.encode())
        entry.bytes_(2, m[key].encode())
        w.message(num, entry)


@dataclass
class FunctionDefLibrary:
    function: List[FunctionDef] = field(default_factory=list)
    unknown: List[Any] = field(default_factory=list)  # gradients, raw

    @classmethod
    def decode(cls, data) -> "FunctionDefLibrary":
        out = cls()
        for num, wt, val, raw in _iter_fields(data):
            if num == 1 and wt == _WT_LEN:
                out.function.append(FunctionDef.decode(val))
            else:
                out.unknown.append(raw)
        return out

    def writer(self) -> _Writer:
        w = _Writer()
        for f in self.function:
            w.message(1, f.writer())
        for raw in self.unknown:
            w.raw(raw)
        return w


@dataclass
class GraphDef:
    node: List[NodeDef] = field(default_factory=list)
    library: Optional[FunctionDefLibrary] = None  # None: the field is absent
    # version, versions, debug_info: raw, written back unchanged
    unknown: List[Any] = field(default_factory=list)

    @classmethod
    def decode(cls, data) -> "GraphDef":
        data = memoryview(data).cast("B")
        out = cls()
        for num, wt, val, raw in _iter_fields(data):
            if num == 1 and wt == _WT_LEN:
                out.node.append(NodeDef.decode(val))
            elif num == 2 and wt == _WT_LEN:
                out.library = FunctionDefLibrary.decode(val)
            else:
                out.unknown.append(raw)
        return out

    def encode(self) -> bytes:
        w = _Writer()
        for n in self.node:
            w.message(1, n.writer())
        if self.library is not None:
            w.message(2, self.library.writer())
        for raw in self.unknown:
            w.raw(raw)
        return w.join()

    SerializeToString = encode


def as_graph_def(graph) -> GraphDef:
    """A GraphDef from serialized bytes, a path to a ``.pb`` file, any
    object with ``SerializeToString()`` (TensorFlow's own proto), or a
    decoded GraphDef."""
    if isinstance(graph, GraphDef):
        return graph
    if isinstance(graph, (bytes, bytearray, memoryview)):
        return GraphDef.decode(graph)
    if isinstance(graph, (str, Path)):
        return GraphDef.decode(Path(graph).read_bytes())
    if hasattr(graph, "SerializeToString"):
        return GraphDef.decode(graph.SerializeToString())
    raise TypeError(f"not a GraphDef: {type(graph).__name__}")


# --- tensors ---------------------------------------------------------------

_FIELD_OF_DTYPE = {
    "float32": "float_val", "float64": "double_val", "int32": "int_val",
    "uint8": "int_val", "int16": "int_val", "int8": "int_val",
    "uint16": "int_val", "int64": "int64_val", "bool": "bool_val",
    "complex64": "scomplex_val", "complex128": "dcomplex_val",
    "float16": "half_val", "bfloat16": "half_val", "uint32": "uint32_val",
    "uint64": "uint64_val",
}


def make_ndarray(t: TensorProto):
    """``tensor_util.MakeNdarray``: the tensor's value, shaped. A numpy
    array (read-only when it views ``tensor_content``), or a CPU
    ``torch.bfloat16`` tensor for DT_BFLOAT16."""
    shape = t.tensor_shape.shape
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if t.dtype == DT_STRING:
        vals = list(t.string_val)
        vals += vals[-1:] * (count - len(vals)) if vals else [b""] * count
        return np.asarray(vals, dtype=object).reshape(shape)
    name = DT_NUMPY.get(t.dtype)
    if name is None:
        raise ValueError(f"unsupported TF dtype enum {t.dtype}")
    bf16 = name == "bfloat16"
    np_name = "uint16" if bf16 else name
    if len(t.tensor_content):
        arr = np.frombuffer(t.tensor_content, np_name).reshape(shape)
    else:
        vals = t.vals.get(_FIELD_OF_DTYPE[name])
        if name in ("complex64", "complex128") and vals is not None:
            vals = vals[0::2] + 1j * vals[1::2]
        if vals is None or not len(vals):
            arr = np.zeros(shape, np_name)
        else:
            vals = np.asarray(vals)
            if name in ("float16", "bfloat16"):
                vals = vals.astype(np.uint16)
                if name == "float16":
                    vals = vals.view(np.float16)
            vals = vals.astype(np_name, copy=False)
            if len(vals) < count:  # MakeNdarray pads with the last value
                vals = np.concatenate(
                    [vals, np.full(count - len(vals), vals[-1], np_name)])
            arr = vals[:count].reshape(shape)
    if bf16:
        import torch

        return torch.from_numpy(arr.astype(np.int16)).view(torch.bfloat16)
    return arr


def make_tensor_proto(arr) -> TensorProto:
    """A TensorProto holding the numpy array ``arr`` in ``tensor_content``,
    viewed without a copy where it is contiguous."""
    arr = np.ascontiguousarray(arr)
    name = str(arr.dtype)
    if name not in NUMPY_DT:
        raise ValueError(f"no TF dtype for {arr.dtype}")
    shape = TensorShapeProto([Dim(int(d)) for d in arr.shape])
    content = memoryview(arr.reshape(-1)).cast("B") if arr.size else b""
    return TensorProto(dtype=NUMPY_DT[name], tensor_shape=shape,
                       tensor_content=content)
