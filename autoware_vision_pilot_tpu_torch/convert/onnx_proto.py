"""Pure-Python ONNX protobuf wire-format codec (no `onnx` package needed).

The reference's model-interchange contract is the ONNX file produced by
``Models/exports/convert_pytorch_to_onnx.py:45-97`` (opset 18,
export_params=True): all released VisionPilot weights ship as ``.pth`` or
``.onnx``.  The bench/test hosts here have neither ``onnx`` nor
``onnxruntime`` installed, so this module implements the subset of the
public ONNX protobuf schema needed to (a) read initializers + graph
structure out of any real ``.onnx`` file and (b) write valid ``.onnx``
files carrying a parameter set.  Field numbers and wire types follow the
public onnx.proto3 specification; byte-level correctness is validated
independently against ``protoc --decode_raw`` in tests/test_onnx_import.py.

Only protobuf wire-format logic lives here; the mapping from ONNX
initializers onto the port's modules is in ``onnx_import.py``. A copy of
autoware_vision_pilot_tpu/convert/onnx_proto.py for the port (which imports
nothing of the JAX package); tests/test_torch_convert_import.py holds its
bytes to that module's.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

# --- ONNX TensorProto.DataType enum (public spec values) -------------------
FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64 = 1, 2, 3, 4, 5, 6, 7
STRING, BOOL, FLOAT16, DOUBLE, UINT32, UINT64 = 8, 9, 10, 11, 12, 13
BFLOAT16 = 16

_DTYPE_TO_NP = {
    FLOAT: np.float32, UINT8: np.uint8, INT8: np.int8, UINT16: np.uint16,
    INT16: np.int16, INT32: np.int32, INT64: np.int64, BOOL: np.bool_,
    FLOAT16: np.float16, DOUBLE: np.float64, UINT32: np.uint32,
    UINT64: np.uint64,
}
_NP_TO_DTYPE = {np.dtype(v): k for k, v in _DTYPE_TO_NP.items()}


# --- wire-format primitives -------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
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
            raise ValueError("varint too long (corrupt protobuf)")


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement 64-bit, per proto spec
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_tag(buf: bytes, pos: int) -> Tuple[int, int, int]:
    tag, pos = _read_varint(buf, pos)
    return tag >> 3, tag & 0x7, pos


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:  # varint
        _, pos = _read_varint(buf, pos)
    elif wire == 1:  # 64-bit
        pos += 8
    elif wire == 2:  # length-delimited
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == 5:  # 32-bit
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _iter_fields(buf: bytes) -> Iterable[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over a message's bytes.

    Length-delimited values are returned as memoryview slices; varints as
    ints; fixed32/64 as raw 4/8-byte slices.
    """
    view = memoryview(buf)
    pos = 0
    end = len(buf)
    while pos < end:
        fnum, wire, pos = _read_tag(buf, pos)
        if wire == 0:
            v, pos = _read_varint(buf, pos)
            yield fnum, wire, v
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            yield fnum, wire, view[pos:pos + n]
            pos += n
        elif wire == 5:
            yield fnum, wire, view[pos:pos + 4]
            pos += 4
        elif wire == 1:
            yield fnum, wire, view[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _packed_varints(data) -> List[int]:
    buf = bytes(data)
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _zigzag64_signed(v: int) -> int:
    """Interpret a varint as a signed int64 (plain two's complement)."""
    return v - (1 << 64) if v >= (1 << 63) else v


# --- message dataclasses (ONNX subset) --------------------------------------

@dataclass
class Tensor:
    name: str = ""
    dims: Tuple[int, ...] = ()
    data_type: int = FLOAT
    raw_data: bytes = b""
    # typed repeated fields (used when raw_data is absent)
    float_data: List[float] = field(default_factory=list)
    int32_data: List[int] = field(default_factory=list)
    int64_data: List[int] = field(default_factory=list)
    double_data: List[float] = field(default_factory=list)

    def to_numpy(self) -> np.ndarray:
        np_dtype = _DTYPE_TO_NP.get(self.data_type)
        if np_dtype is None and self.data_type == BFLOAT16:
            # bfloat16 raw bytes: upcast via uint16 -> float32 bit trick
            u16 = np.frombuffer(self.raw_data, dtype=np.uint16)
            f32 = (u16.astype(np.uint32) << 16).view(np.float32)
            return f32.reshape(self.dims)
        if np_dtype is None:
            raise ValueError(f"unsupported ONNX data_type {self.data_type} "
                             f"for tensor {self.name!r}")
        if self.raw_data:
            return np.frombuffer(self.raw_data, dtype=np_dtype).reshape(
                self.dims).copy()
        if self.data_type == FLOAT:
            arr = np.asarray(self.float_data, dtype=np.float32)
        elif self.data_type == DOUBLE:
            arr = np.asarray(self.double_data, dtype=np.float64)
        elif self.data_type == INT64:
            arr = np.asarray(self.int64_data, dtype=np.int64)
        elif self.data_type in (INT32, INT16, INT8, UINT16, UINT8, BOOL):
            arr = np.asarray(self.int32_data).astype(np_dtype)
        else:
            raise ValueError(
                f"tensor {self.name!r}: no data for type {self.data_type}")
        return arr.reshape(self.dims)

    @classmethod
    def from_numpy(cls, name: str, arr: np.ndarray) -> "Tensor":
        arr = np.ascontiguousarray(arr)
        dt = _NP_TO_DTYPE.get(arr.dtype)
        if dt is None:
            raise ValueError(f"no ONNX data_type for numpy dtype {arr.dtype}")
        return cls(name=name, dims=tuple(arr.shape), data_type=dt,
                   raw_data=arr.tobytes())


@dataclass
class Attribute:
    name: str = ""
    type: int = 0  # AttributeProto.AttributeType
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional[Tensor] = None
    floats: List[float] = field(default_factory=list)
    ints: List[int] = field(default_factory=list)
    strings: List[bytes] = field(default_factory=list)

    # AttributeType enum values (public spec)
    FLOAT_T, INT_T, STRING_T, TENSOR_T = 1, 2, 3, 4
    FLOATS_T, INTS_T, STRINGS_T = 6, 7, 8

    @property
    def value(self):
        return {
            self.FLOAT_T: self.f, self.INT_T: self.i, self.STRING_T: self.s,
            self.TENSOR_T: self.t, self.FLOATS_T: self.floats,
            self.INTS_T: self.ints, self.STRINGS_T: self.strings,
        }.get(self.type)


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attributes: Dict[str, Attribute] = field(default_factory=dict)

    def attr(self, name: str, default=None):
        a = self.attributes.get(name)
        return default if a is None else a.value


@dataclass
class ValueInfo:
    name: str = ""
    elem_type: int = FLOAT
    # each dim: int (fixed) or str (symbolic, e.g. 'batch_size')
    shape: List[Any] = field(default_factory=list)


@dataclass
class Graph:
    name: str = ""
    nodes: List[Node] = field(default_factory=list)
    initializers: Dict[str, Tensor] = field(default_factory=dict)
    inputs: List[ValueInfo] = field(default_factory=list)
    outputs: List[ValueInfo] = field(default_factory=list)


@dataclass
class Model:
    ir_version: int = 8
    producer_name: str = ""
    producer_version: str = ""
    opset_version: int = 18
    opset_domain: str = ""
    graph: Graph = field(default_factory=Graph)


# --- parsing -----------------------------------------------------------------

def _parse_tensor(buf) -> Tensor:
    t = Tensor()
    dims: List[int] = []
    for fnum, wire, v in _iter_fields(buf):
        if fnum == 1:  # dims (repeated int64; may be packed)
            if wire == 0:
                dims.append(_zigzag64_signed(v))
            else:
                dims.extend(_zigzag64_signed(x) for x in _packed_varints(v))
        elif fnum == 2:
            t.data_type = v
        elif fnum == 4:  # float_data (packed floats)
            t.float_data.extend(
                np.frombuffer(bytes(v), dtype="<f4").tolist() if wire == 2
                else [struct.unpack("<f", bytes(v))[0]])
        elif fnum == 5:  # int32_data
            if wire == 0:
                t.int32_data.append(_zigzag64_signed(v))
            else:
                t.int32_data.extend(
                    _zigzag64_signed(x) for x in _packed_varints(v))
        elif fnum == 7:  # int64_data
            if wire == 0:
                t.int64_data.append(_zigzag64_signed(v))
            else:
                t.int64_data.extend(
                    _zigzag64_signed(x) for x in _packed_varints(v))
        elif fnum == 8:
            t.name = bytes(v).decode("utf-8")
        elif fnum == 9:
            t.raw_data = bytes(v)
        elif fnum == 10:  # double_data (packed doubles)
            t.double_data.extend(
                np.frombuffer(bytes(v), dtype="<f8").tolist() if wire == 2
                else [struct.unpack("<d", bytes(v))[0]])
        elif fnum == 13:  # external_data — not supported here
            raise ValueError(
                f"tensor {t.name!r} uses external data files; re-export with "
                "external_data=False (the reference exporter does)")
        # else: skip (segment, doc_string, data_location, ...)
    t.dims = tuple(dims)
    return t


def _parse_attribute(buf) -> Attribute:
    a = Attribute()
    for fnum, wire, v in _iter_fields(buf):
        if fnum == 1:
            a.name = bytes(v).decode("utf-8")
        elif fnum == 2:
            a.f = struct.unpack("<f", bytes(v))[0]
        elif fnum == 3:
            a.i = _zigzag64_signed(v)
        elif fnum == 4:
            a.s = bytes(v)
        elif fnum == 5:
            a.t = _parse_tensor(v)
        elif fnum == 7:
            a.floats.extend(
                np.frombuffer(bytes(v), dtype="<f4").tolist() if wire == 2
                else [struct.unpack("<f", bytes(v))[0]])
        elif fnum == 8:
            if wire == 0:
                a.ints.append(_zigzag64_signed(v))
            else:
                a.ints.extend(_zigzag64_signed(x) for x in _packed_varints(v))
        elif fnum == 9:
            a.strings.append(bytes(v))
        elif fnum == 20:
            a.type = v
    if a.type == 0:  # older exporters omit `type`; infer from populated field
        if a.t is not None:
            a.type = Attribute.TENSOR_T
        elif a.ints:
            a.type = Attribute.INTS_T
        elif a.floats:
            a.type = Attribute.FLOATS_T
        elif a.s:
            a.type = Attribute.STRING_T
    return a


def _parse_node(buf) -> Node:
    n = Node()
    for fnum, wire, v in _iter_fields(buf):
        if fnum == 1:
            n.inputs.append(bytes(v).decode("utf-8"))
        elif fnum == 2:
            n.outputs.append(bytes(v).decode("utf-8"))
        elif fnum == 3:
            n.name = bytes(v).decode("utf-8")
        elif fnum == 4:
            n.op_type = bytes(v).decode("utf-8")
        elif fnum == 5:
            a = _parse_attribute(v)
            n.attributes[a.name] = a
    return n


def _parse_value_info(buf) -> ValueInfo:
    vi = ValueInfo()
    for fnum, _, v in _iter_fields(buf):
        if fnum == 1:
            vi.name = bytes(v).decode("utf-8")
        elif fnum == 2:  # TypeProto
            for f2, _, v2 in _iter_fields(v):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:  # TensorShapeProto
                            for f4, _, v4 in _iter_fields(v3):
                                if f4 == 1:  # Dimension
                                    dim: Any = None
                                    for f5, _, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dim = _zigzag64_signed(v5)
                                        elif f5 == 2:
                                            dim = bytes(v5).decode("utf-8")
                                    vi.shape.append(dim)
    return vi


def _parse_graph(buf) -> Graph:
    g = Graph()
    for fnum, _, v in _iter_fields(buf):
        if fnum == 1:
            g.nodes.append(_parse_node(v))
        elif fnum == 2:
            g.name = bytes(v).decode("utf-8")
        elif fnum == 5:
            t = _parse_tensor(v)
            g.initializers[t.name] = t
        elif fnum == 11:
            g.inputs.append(_parse_value_info(v))
        elif fnum == 12:
            g.outputs.append(_parse_value_info(v))
    return g


def parse_model(data: bytes) -> Model:
    m = Model()
    for fnum, _, v in _iter_fields(data):
        if fnum == 1:
            m.ir_version = v
        elif fnum == 2:
            m.producer_name = bytes(v).decode("utf-8")
        elif fnum == 3:
            m.producer_version = bytes(v).decode("utf-8")
        elif fnum == 7:
            m.graph = _parse_graph(v)
        elif fnum == 8:  # opset_import
            for f2, _, v2 in _iter_fields(v):
                if f2 == 1:
                    m.opset_domain = bytes(v2).decode("utf-8")
                elif f2 == 2:
                    m.opset_version = v2
    return m


def load_model(path) -> Model:
    with open(path, "rb") as f:
        return parse_model(f.read())


# --- serialization -----------------------------------------------------------

def _emit_bytes(out: bytearray, fnum: int, data: bytes) -> None:
    _write_varint(out, (fnum << 3) | 2)
    _write_varint(out, len(data))
    out.extend(data)


def _emit_str(out: bytearray, fnum: int, s: str) -> None:
    _emit_bytes(out, fnum, s.encode("utf-8"))


def _emit_varint_field(out: bytearray, fnum: int, v: int) -> None:
    _write_varint(out, fnum << 3)
    _write_varint(out, v)


def _ser_tensor(t: Tensor) -> bytes:
    out = bytearray()
    for d in t.dims:
        _emit_varint_field(out, 1, d)
    _emit_varint_field(out, 2, t.data_type)
    if t.name:
        _emit_str(out, 8, t.name)
    _emit_bytes(out, 9, t.raw_data)
    return bytes(out)


def _ser_value_info(vi: ValueInfo) -> bytes:
    shape_out = bytearray()
    for d in vi.shape:
        dim_out = bytearray()
        if isinstance(d, str):
            _emit_str(dim_out, 2, d)
        else:
            _emit_varint_field(dim_out, 1, int(d))
        _emit_bytes(shape_out, 1, bytes(dim_out))
    tt = bytearray()
    _emit_varint_field(tt, 1, vi.elem_type)
    _emit_bytes(tt, 2, bytes(shape_out))
    tp = bytearray()
    _emit_bytes(tp, 1, bytes(tt))
    out = bytearray()
    _emit_str(out, 1, vi.name)
    _emit_bytes(out, 2, bytes(tp))
    return bytes(out)


def _ser_attribute(a: Attribute) -> bytes:
    out = bytearray()
    _emit_str(out, 1, a.name)
    if a.type == Attribute.FLOAT_T:
        _write_varint(out, (2 << 3) | 5)
        out.extend(struct.pack("<f", a.f))
    elif a.type == Attribute.INT_T:
        _emit_varint_field(out, 3, a.i & ((1 << 64) - 1) if a.i < 0 else a.i)
    elif a.type == Attribute.STRING_T:
        _emit_bytes(out, 4, a.s)
    elif a.type == Attribute.TENSOR_T:
        _emit_bytes(out, 5, _ser_tensor(a.t))
    elif a.type == Attribute.FLOATS_T:
        _emit_bytes(out, 7, np.asarray(a.floats, dtype="<f4").tobytes())
    elif a.type == Attribute.INTS_T:
        packed = bytearray()
        for i in a.ints:
            _write_varint(packed, i)
        _emit_bytes(out, 8, bytes(packed))
    elif a.type == Attribute.STRINGS_T:
        for s in a.strings:
            _emit_bytes(out, 9, s)
    _emit_varint_field(out, 20, a.type)
    return bytes(out)


def _ser_node(n: Node) -> bytes:
    out = bytearray()
    for i in n.inputs:
        _emit_str(out, 1, i)
    for o in n.outputs:
        _emit_str(out, 2, o)
    if n.name:
        _emit_str(out, 3, n.name)
    _emit_str(out, 4, n.op_type)
    for a in n.attributes.values():
        _emit_bytes(out, 5, _ser_attribute(a))
    return bytes(out)


def serialize_model(m: Model) -> bytes:
    g = bytearray()
    for n in m.graph.nodes:
        _emit_bytes(g, 1, _ser_node(n))
    if m.graph.name:
        _emit_str(g, 2, m.graph.name)
    for t in m.graph.initializers.values():
        _emit_bytes(g, 5, _ser_tensor(t))
    for vi in m.graph.inputs:
        _emit_bytes(g, 11, _ser_value_info(vi))
    for vi in m.graph.outputs:
        _emit_bytes(g, 12, _ser_value_info(vi))

    out = bytearray()
    _emit_varint_field(out, 1, m.ir_version)
    if m.producer_name:
        _emit_str(out, 2, m.producer_name)
    if m.producer_version:
        _emit_str(out, 3, m.producer_version)
    _emit_bytes(out, 7, bytes(g))
    opset = bytearray()
    if m.opset_domain:
        _emit_str(opset, 1, m.opset_domain)
    _emit_varint_field(opset, 2, m.opset_version)
    _emit_bytes(out, 8, bytes(opset))
    return bytes(out)


def save_model(m: Model, path) -> None:
    with open(path, "wb") as f:
        f.write(serialize_model(m))
