"""Minimal pure-Python ONNX protobuf implementation (a copy of
`mxnet_tpu/contrib/onnx_proto.py`, which holds no JAX; the port keeps its
own copy instead of importing the JAX package).

The reference gates ONNX interchange on the `onnx` pip package
(python/mxnet/contrib/onnx/__init__.py). ONNX files are ordinary
protobufs, and the subset of the schema the translation tables need
(ModelProto/GraphProto/NodeProto/AttributeProto/TensorProto/
ValueInfoProto) is small, so this module implements the protobuf wire
format for exactly those messages, plus the slivers of the `onnx.helper`
/ `onnx.numpy_helper` API that contrib/onnx.py uses.

contrib/onnx.py prefers the real `onnx` package when importable and falls
back to this shim, so artifacts written here are standard .onnx files
readable by onnxruntime, netron and the JAX package alike.

Field numbers follow the public onnx.proto3 schema (onnx/onnx.proto).
"""
from __future__ import annotations

import struct

import numpy as _np

# -- protobuf wire format ---------------------------------------------------

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _enc_varint(v):
    out = bytearray()
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _dec_varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            if result >= 1 << 63:
                result -= 1 << 64
            return result, pos
        shift += 7


def _tag(field, wire):
    return _enc_varint((field << 3) | wire)


class Field:
    def __init__(self, num, kind, repeated=False, message=None):
        self.num = num
        self.kind = kind          # int|float|double|bytes|string|message
        self.repeated = repeated
        self.message = message


class Message:
    """Declarative protobuf message: subclasses define FIELDS =
    {py_name: Field}. Unknown fields are skipped on decode (forward
    compatibility with full onnx files)."""

    FIELDS = {}

    def __init__(self, **kwargs):
        for name, f in self.FIELDS.items():
            setattr(self, name, [] if f.repeated else _default(f))
        for k, v in kwargs.items():
            if k not in self.FIELDS:
                raise AttributeError("%s has no field %r"
                                     % (type(self).__name__, k))
            setattr(self, k, v)

    # -- encoding ----------------------------------------------------------
    def SerializeToString(self):
        out = bytearray()
        for name, f in self.FIELDS.items():
            val = getattr(self, name)
            if f.repeated:
                if not val:
                    continue
                if f.kind in ("int", "float", "double"):
                    # proto3 packs repeated scalars
                    payload = bytearray()
                    for v in val:
                        payload += _enc_scalar(f.kind, v)
                    out += _tag(f.num, _LEN) + _enc_varint(len(payload)) \
                        + payload
                else:
                    for v in val:
                        out += _enc_field(f, v)
            else:
                if _is_default(f, val):
                    continue
                out += _enc_field(f, val)
        return bytes(out)

    # -- decoding ----------------------------------------------------------
    @classmethod
    def FromString(cls, data):
        msg = cls()
        pos, end = 0, len(data)
        while pos < end:
            key, pos = _dec_varint(data, pos)
            field_num, wire = key >> 3, key & 7
            f = cls._by_num().get(field_num)
            if f is None:
                pos = _skip(data, pos, wire)
                continue
            name = f._name
            if wire == _LEN:
                ln, pos = _dec_varint(data, pos)
                chunk = data[pos:pos + ln]
                pos += ln
                if f.kind == "message":
                    v = f.message.FromString(chunk)
                elif f.kind == "bytes":
                    v = bytes(chunk)
                elif f.kind == "string":
                    v = chunk.decode("utf-8")
                elif f.kind in ("int", "float", "double"):
                    # packed repeated scalars
                    vs, p2 = [], 0
                    while p2 < len(chunk):
                        if f.kind == "int":
                            v2, p2 = _dec_varint(chunk, p2)
                        elif f.kind == "float":
                            v2 = struct.unpack_from("<f", chunk, p2)[0]
                            p2 += 4
                        else:
                            v2 = struct.unpack_from("<d", chunk, p2)[0]
                            p2 += 8
                        vs.append(v2)
                    if f.repeated:
                        getattr(msg, name).extend(vs)
                        continue
                    v = vs[-1] if vs else _default(f)
                else:
                    raise ValueError("bad LEN field %s" % name)
            elif wire == _VARINT:
                v, pos = _dec_varint(data, pos)
            elif wire == _I32:
                v = struct.unpack_from("<f", data, pos)[0]
                pos += 4
            elif wire == _I64:
                v = struct.unpack_from("<d", data, pos)[0]
                pos += 8
            else:
                raise ValueError("unsupported wire type %d" % wire)
            if f.repeated:
                getattr(msg, name).append(v)
            else:
                setattr(msg, name, v)
        return msg

    @classmethod
    def _by_num(cls):
        cached = cls.__dict__.get("_num_index")
        if cached is None:
            cached = {}
            for name, f in cls.FIELDS.items():
                f._name = name
                cached[f.num] = f
            cls._num_index = cached
        return cached

    def __repr__(self):
        parts = []
        for name, f in self.FIELDS.items():
            v = getattr(self, name)
            if (f.repeated and v) or (not f.repeated
                                      and not _is_default(f, v)):
                parts.append("%s=%r" % (name, v))
        return "%s(%s)" % (type(self).__name__, ", ".join(parts))


def _default(f):
    return {"int": 0, "float": 0.0, "double": 0.0, "bytes": b"",
            "string": "", "message": None}[f.kind]


def _is_default(f, v):
    if f.kind == "message":
        return v is None
    return v == _default(f)


def _enc_scalar(kind, v):
    if kind == "int":
        return _enc_varint(int(v))
    if kind == "float":
        return struct.pack("<f", float(v))
    return struct.pack("<d", float(v))


def _enc_field(f, v):
    if f.kind == "int":
        return _tag(f.num, _VARINT) + _enc_varint(int(v))
    if f.kind == "float":
        return _tag(f.num, _I32) + struct.pack("<f", float(v))
    if f.kind == "double":
        return _tag(f.num, _I64) + struct.pack("<d", float(v))
    if f.kind == "bytes":
        b = bytes(v)
        return _tag(f.num, _LEN) + _enc_varint(len(b)) + b
    if f.kind == "string":
        b = v.encode("utf-8")
        return _tag(f.num, _LEN) + _enc_varint(len(b)) + b
    if f.kind == "message":
        b = v.SerializeToString()
        return _tag(f.num, _LEN) + _enc_varint(len(b)) + b
    raise ValueError(f.kind)


def _skip(data, pos, wire):
    if wire == _VARINT:
        _, pos = _dec_varint(data, pos)
        return pos
    if wire == _I64:
        return pos + 8
    if wire == _I32:
        return pos + 4
    if wire == _LEN:
        ln, pos = _dec_varint(data, pos)
        return pos + ln
    raise ValueError("unsupported wire type %d" % wire)


# -- ONNX messages (field numbers from onnx/onnx.proto) ---------------------

class TensorShapeDim(Message):
    FIELDS = {"dim_value": Field(1, "int"),
              "dim_param": Field(2, "string")}


class TensorShapeProto(Message):
    FIELDS = {"dim": Field(1, "message", repeated=True,
                           message=TensorShapeDim)}


class TensorTypeProto(Message):
    FIELDS = {"elem_type": Field(1, "int"),
              "shape": Field(2, "message", message=TensorShapeProto)}


class TypeProto(Message):
    FIELDS = {"tensor_type": Field(1, "message", message=TensorTypeProto)}


class ValueInfoProto(Message):
    FIELDS = {"name": Field(1, "string"),
              "type": Field(2, "message", message=TypeProto),
              "doc_string": Field(3, "string")}


class TensorProto(Message):
    # DataType enum values (onnx.proto TensorProto.DataType)
    FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64, STRING, BOOL, \
        FLOAT16, DOUBLE, UINT32, UINT64 = range(1, 14)

    FIELDS = {"dims": Field(1, "int", repeated=True),
              "data_type": Field(2, "int"),
              "float_data": Field(4, "float", repeated=True),
              "int32_data": Field(5, "int", repeated=True),
              "string_data": Field(6, "bytes", repeated=True),
              "int64_data": Field(7, "int", repeated=True),
              "name": Field(8, "string"),
              "raw_data": Field(9, "bytes"),
              "double_data": Field(10, "double", repeated=True),
              "uint64_data": Field(11, "int", repeated=True),
              "doc_string": Field(12, "string")}


class AttributeProto(Message):
    # AttributeType enum
    UNDEFINED, FLOAT, INT, STRING, TENSOR, GRAPH, \
        FLOATS, INTS, STRINGS, TENSORS, GRAPHS = range(11)

    FIELDS = {"name": Field(1, "string"),
              "f": Field(2, "float"),
              "i": Field(3, "int"),
              "s": Field(4, "bytes"),
              "t": Field(5, "message", message=TensorProto),
              "floats": Field(7, "float", repeated=True),
              "ints": Field(8, "int", repeated=True),
              "strings": Field(9, "bytes", repeated=True),
              "tensors": Field(10, "message", repeated=True,
                               message=TensorProto),
              "doc_string": Field(13, "string"),
              "type": Field(20, "int")}


class NodeProto(Message):
    FIELDS = {"input": Field(1, "string", repeated=True),
              "output": Field(2, "string", repeated=True),
              "name": Field(3, "string"),
              "op_type": Field(4, "string"),
              "attribute": Field(5, "message", repeated=True,
                                 message=AttributeProto),
              "doc_string": Field(6, "string"),
              "domain": Field(7, "string")}


class GraphProto(Message):
    FIELDS = {"node": Field(1, "message", repeated=True, message=NodeProto),
              "name": Field(2, "string"),
              "initializer": Field(5, "message", repeated=True,
                                   message=TensorProto),
              "doc_string": Field(10, "string"),
              "input": Field(11, "message", repeated=True,
                             message=ValueInfoProto),
              "output": Field(12, "message", repeated=True,
                              message=ValueInfoProto),
              "value_info": Field(13, "message", repeated=True,
                                  message=ValueInfoProto)}


class OperatorSetIdProto(Message):
    FIELDS = {"domain": Field(1, "string"),
              "version": Field(2, "int")}


class ModelProto(Message):
    FIELDS = {"ir_version": Field(1, "int"),
              "producer_name": Field(2, "string"),
              "producer_version": Field(3, "string"),
              "domain": Field(4, "string"),
              "model_version": Field(5, "int"),
              "doc_string": Field(6, "string"),
              "graph": Field(7, "message", message=GraphProto),
              "opset_import": Field(8, "message", repeated=True,
                                    message=OperatorSetIdProto)}


# -- onnx-package-compatible API surface ------------------------------------

def load(path_or_bytes):
    raw = path_or_bytes
    if isinstance(raw, str):
        with open(raw, "rb") as f:
            raw = f.read()
    return ModelProto.FromString(raw)


def save(model, path):
    with open(path, "wb") as f:
        f.write(model.SerializeToString())


_NP_TO_ONNX = {
    _np.dtype(_np.float32): TensorProto.FLOAT,
    _np.dtype(_np.float64): TensorProto.DOUBLE,
    _np.dtype(_np.float16): TensorProto.FLOAT16,
    _np.dtype(_np.int32): TensorProto.INT32,
    _np.dtype(_np.int64): TensorProto.INT64,
    _np.dtype(_np.int8): TensorProto.INT8,
    _np.dtype(_np.uint8): TensorProto.UINT8,
    _np.dtype(_np.bool_): TensorProto.BOOL,
}
_ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}


class numpy_helper:
    @staticmethod
    def from_array(arr, name=""):
        arr = _np.asarray(arr)
        dt = _NP_TO_ONNX.get(arr.dtype)
        if dt is None:
            raise ValueError("unsupported dtype %s" % arr.dtype)
        return TensorProto(dims=list(arr.shape), data_type=dt, name=name,
                           raw_data=_np.ascontiguousarray(arr).tobytes())

    @staticmethod
    def to_array(tensor):
        dt = _ONNX_TO_NP.get(tensor.data_type)
        if dt is None:
            raise ValueError("unsupported TensorProto data_type %d"
                             % tensor.data_type)
        shape = tuple(tensor.dims)
        if tensor.raw_data:
            return _np.frombuffer(tensor.raw_data, dtype=dt).reshape(shape)
        if tensor.data_type == TensorProto.FLOAT:
            return _np.asarray(tensor.float_data, _np.float32).reshape(shape)
        if tensor.data_type == TensorProto.DOUBLE:
            return _np.asarray(tensor.double_data,
                               _np.float64).reshape(shape)
        if tensor.data_type == TensorProto.INT64:
            return _np.asarray(tensor.int64_data, _np.int64).reshape(shape)
        return _np.asarray(tensor.int32_data, dt).reshape(shape)


class helper:
    @staticmethod
    def make_node(op_type, inputs, outputs, name=None, domain=None,
                  **attrs):
        node = NodeProto(op_type=op_type, input=list(inputs),
                         output=list(outputs), name=name or "")
        if domain:
            node.domain = domain
        for k in sorted(attrs):
            node.attribute.append(helper.make_attribute(k, attrs[k]))
        return node

    @staticmethod
    def make_attribute(key, value):
        a = AttributeProto(name=key)
        if isinstance(value, bool):
            a.i, a.type = int(value), AttributeProto.INT
        elif isinstance(value, int):
            a.i, a.type = value, AttributeProto.INT
        elif isinstance(value, float):
            a.f, a.type = value, AttributeProto.FLOAT
        elif isinstance(value, str):
            a.s, a.type = value.encode("utf-8"), AttributeProto.STRING
        elif isinstance(value, bytes):
            a.s, a.type = value, AttributeProto.STRING
        elif isinstance(value, TensorProto):
            a.t, a.type = value, AttributeProto.TENSOR
        elif isinstance(value, (list, tuple)):
            if all(isinstance(v, (int, _np.integer)) for v in value):
                a.ints, a.type = [int(v) for v in value], AttributeProto.INTS
            elif all(isinstance(v, (int, float, _np.floating, _np.integer))
                     for v in value):
                a.floats = [float(v) for v in value]
                a.type = AttributeProto.FLOATS
            elif all(isinstance(v, (str, bytes)) for v in value):
                a.strings = [v.encode("utf-8") if isinstance(v, str) else v
                             for v in value]
                a.type = AttributeProto.STRINGS
            else:
                raise ValueError("mixed attribute list %r" % (value,))
        else:
            raise ValueError("unsupported attribute value %r" % (value,))
        return a

    @staticmethod
    def get_attribute_value(attr):
        t = attr.type
        if t == AttributeProto.FLOAT:
            return attr.f
        if t == AttributeProto.INT:
            return attr.i
        if t == AttributeProto.STRING:
            return attr.s
        if t == AttributeProto.TENSOR:
            return attr.t
        if t == AttributeProto.FLOATS:
            return list(attr.floats)
        if t == AttributeProto.INTS:
            return list(attr.ints)
        if t == AttributeProto.STRINGS:
            return list(attr.strings)
        raise ValueError("unsupported attribute type %d" % t)

    @staticmethod
    def make_tensor_value_info(name, elem_type, shape):
        tshape = TensorShapeProto()
        for d in (shape or ()):
            if d is None or (isinstance(d, str)):
                tshape.dim.append(TensorShapeDim(dim_param=str(d or "?")))
            else:
                tshape.dim.append(TensorShapeDim(dim_value=int(d)))
        return ValueInfoProto(
            name=name,
            type=TypeProto(tensor_type=TensorTypeProto(
                elem_type=elem_type, shape=tshape)))

    @staticmethod
    def make_graph(nodes, name, inputs, outputs, initializer=None):
        return GraphProto(node=list(nodes), name=name, input=list(inputs),
                          output=list(outputs),
                          initializer=list(initializer or []))

    @staticmethod
    def make_model(graph, opset_version=13,
                   producer_name="mxnet_tpu_torch"):
        return ModelProto(
            ir_version=8, producer_name=producer_name, graph=graph,
            opset_import=[OperatorSetIdProto(domain="",
                                             version=opset_version)])


__version__ = "shim-1.0"
