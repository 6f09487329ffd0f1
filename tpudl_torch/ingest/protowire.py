"""The protobuf wire format of TF's graph, SavedModel and bundle protos,
read in numpy and plain Python.

``tpudl_torch`` imports neither ``tensorflow`` nor ``google.protobuf``, so
the GraphDef, SavedModel and checkpoint routes of
:class:`~tpudl_torch.ingest.TFInputGraph` read their files here. Only the
messages those routes need have a schema (:data:`SCHEMAS`; field numbers
from TF's ``.proto`` files): ``GraphDef``, ``NodeDef``, ``AttrValue``
(``ListValue``, ``NameAttrList``), ``TensorProto``, ``TensorShapeProto``,
``FunctionDefLibrary``, ``FunctionDef``, ``OpDef`` and its ``ArgDef``,
``SavedModel``, ``MetaGraphDef`` (``MetaInfoDef``), ``SignatureDef``,
``TensorInfo``, ``SaverDef``, ``BundleHeaderProto`` and
``BundleEntryProto``.

:func:`parse` returns a :class:`Message`, read as a generated proto is
read: an unset scalar is its default (0, ``False``, ``""``, ``b""``), an
unset message is an empty one, a repeated field is a list, and a map field
(``NodeDef.attr``, ``FunctionDef.ret``, ``SignatureDef.inputs``, ...) a
dict whose missing keys read as the default value (``node.attr["x"].b`` is
``False``). Unknown fields are skipped by wire type; groups raise.
Repeated scalars are read packed or unpacked. :func:`make_ndarray` is
``tf.make_ndarray``.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["Message", "SCHEMAS", "parse", "new", "make_ndarray",
           "tensor_proto", "np_dtype", "DT", "ProtoError"]


class ProtoError(ValueError):
    """The bytes are not a well-formed message of the expected type."""


# DataType enum (tensorflow/core/framework/types.proto); ``_REF`` variants
# are these plus 100
DT = {"DT_INVALID": 0, "DT_FLOAT": 1, "DT_DOUBLE": 2, "DT_INT32": 3,
      "DT_UINT8": 4, "DT_INT16": 5, "DT_INT8": 6, "DT_STRING": 7,
      "DT_COMPLEX64": 8, "DT_INT64": 9, "DT_BOOL": 10, "DT_QINT8": 11,
      "DT_QUINT8": 12, "DT_QINT32": 13, "DT_BFLOAT16": 14, "DT_QINT16": 15,
      "DT_QUINT16": 16, "DT_UINT16": 17, "DT_COMPLEX128": 18, "DT_HALF": 19,
      "DT_RESOURCE": 20, "DT_VARIANT": 21, "DT_UINT32": 22, "DT_UINT64": 23}

_NP = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
       6: np.int8, 7: object, 8: np.complex64, 9: np.int64, 10: np.bool_,
       11: np.int8, 12: np.uint8, 13: np.int32, 15: np.int16, 16: np.uint16,
       17: np.uint16, 18: np.complex128, 19: np.float16, 22: np.uint32,
       23: np.uint64}


def np_dtype(tf_enum: int):
    """The numpy dtype of a TF ``DataType`` (a ``_REF`` variant as its
    base). ``DT_BFLOAT16`` has none without ml_dtypes: it reads as
    ``"bfloat16"``, and :func:`make_ndarray` gives a torch tensor."""
    base = tf_enum - 100 if tf_enum > 100 else tf_enum
    if base == 14:
        return "bfloat16"
    if base not in _NP:
        raise NotImplementedError(f"TF DataType {tf_enum} has no numpy dtype")
    return np.dtype(_NP[base])


# -- schemas ----------------------------------------------------------------
# field number -> (name, kind, repeated); kind is a scalar kind, "msg:<Type>"
# or "map:<key kind>:<value kind>"
_R = True
SCHEMAS: dict[str, dict[int, tuple]] = {
    "GraphDef": {1: ("node", "msg:NodeDef", _R),
                 2: ("library", "msg:FunctionDefLibrary", False)},
    "NodeDef": {1: ("name", "string", False), 2: ("op", "string", False),
                3: ("input", "string", _R),
                5: ("attr", "map:string:msg:AttrValue", False)},
    "AttrValue": {1: ("list", "msg:ListValue", False),
                  2: ("s", "bytes", False), 3: ("i", "int64", False),
                  4: ("f", "float", False), 5: ("b", "bool", False),
                  6: ("type", "enum", False),
                  7: ("shape", "msg:TensorShapeProto", False),
                  8: ("tensor", "msg:TensorProto", False),
                  10: ("func", "msg:NameAttrList", False)},
    "ListValue": {2: ("s", "bytes", _R), 3: ("i", "int64", _R),
                  4: ("f", "float", _R), 5: ("b", "bool", _R),
                  6: ("type", "enum", _R),
                  7: ("shape", "msg:TensorShapeProto", _R),
                  8: ("tensor", "msg:TensorProto", _R),
                  9: ("func", "msg:NameAttrList", _R)},
    "NameAttrList": {1: ("name", "string", False),
                     2: ("attr", "map:string:msg:AttrValue", False)},
    "TensorProto": {1: ("dtype", "enum", False),
                    2: ("tensor_shape", "msg:TensorShapeProto", False),
                    4: ("tensor_content", "bytes", False),
                    5: ("float_val", "float", _R),
                    6: ("double_val", "double", _R),
                    7: ("int_val", "int32", _R),
                    8: ("string_val", "bytes", _R),
                    9: ("scomplex_val", "float", _R),
                    10: ("int64_val", "int64", _R),
                    11: ("bool_val", "bool", _R),
                    12: ("dcomplex_val", "double", _R),
                    13: ("half_val", "int32", _R),
                    16: ("uint32_val", "uint32", _R),
                    17: ("uint64_val", "uint64", _R)},
    "TensorShapeProto": {2: ("dim", "msg:Dim", _R),
                         3: ("unknown_rank", "bool", False)},
    "Dim": {1: ("size", "int64", False), 2: ("name", "string", False)},
    "FunctionDefLibrary": {1: ("function", "msg:FunctionDef", _R)},
    "FunctionDef": {1: ("signature", "msg:OpDef", False),
                    3: ("node_def", "msg:NodeDef", _R),
                    4: ("ret", "map:string:string", False)},
    "OpDef": {1: ("name", "string", False),
              2: ("input_arg", "msg:ArgDef", _R),
              3: ("output_arg", "msg:ArgDef", _R)},
    "ArgDef": {1: ("name", "string", False), 3: ("type", "enum", False)},
    "SavedModel": {1: ("saved_model_schema_version", "int64", False),
                   2: ("meta_graphs", "msg:MetaGraphDef", _R)},
    "MetaGraphDef": {1: ("meta_info_def", "msg:MetaInfoDef", False),
                     2: ("graph_def", "msg:GraphDef", False),
                     3: ("saver_def", "msg:SaverDef", False),
                     5: ("signature_def", "map:string:msg:SignatureDef",
                         False)},
    "MetaInfoDef": {4: ("tags", "string", _R)},
    "SignatureDef": {1: ("inputs", "map:string:msg:TensorInfo", False),
                     2: ("outputs", "map:string:msg:TensorInfo", False)},
    "TensorInfo": {1: ("name", "string", False)},
    "SaverDef": {3: ("restore_op_name", "string", False)},
    "BundleHeaderProto": {1: ("num_shards", "int32", False),
                          2: ("endianness", "enum", False)},
    "BundleEntryProto": {1: ("dtype", "enum", False),
                         2: ("shape", "msg:TensorShapeProto", False),
                         3: ("shard_id", "int32", False),
                         4: ("offset", "int64", False),
                         5: ("size", "int64", False),
                         6: ("crc32c", "fixed32", False),
                         7: ("slices", "msg:TensorSliceProto", _R)},
    "TensorSliceProto": {},
}

_VARINT = {"int32", "int64", "uint32", "uint64", "bool", "enum"}
_FIXED = {"float": ("<f", 4), "double": ("<d", 8), "fixed32": ("<I", 4)}
_DEFAULT = {"int32": 0, "int64": 0, "uint32": 0, "uint64": 0, "bool": False,
            "enum": 0, "float": 0.0, "double": 0.0, "fixed32": 0,
            "string": "", "bytes": b""}
_NAMES = {t: {v[0]: (k, v[1], v[2]) for k, v in s.items()}
          for t, s in SCHEMAS.items()}


def _default(kind: str):
    if kind.startswith("msg:"):
        return Message(kind[4:])
    return _DEFAULT[kind]


class _Map(dict):
    """A proto map: a missing key reads as the value's default (and is
    not inserted)."""

    def __init__(self, value_kind: str, *args):
        super().__init__(*args)
        self._value_kind = value_kind

    def __missing__(self, key):
        return _default(self._value_kind)


class Message:
    """One parsed message of type ``type_name``: set fields as attributes,
    unset ones read as their defaults."""

    def __init__(self, type_name: str, **fields):
        self.__dict__["_type"] = type_name
        for k, v in fields.items():
            setattr(self, k, v)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        try:
            _num, kind, rep = _NAMES[self._type][name]
        except KeyError:
            raise AttributeError(
                f"{self._type} has no field {name!r}") from None
        if kind.startswith("map:"):
            v = _Map(kind.split(":", 2)[2])
        elif rep:
            v = []
        else:
            return _default(kind)
        self.__dict__[name] = v      # a container reads as itself again
        return v

    def __setattr__(self, name, value):
        if name not in _NAMES[self._type]:
            raise AttributeError(f"{self._type} has no field {name!r}")
        kind = _NAMES[self._type][name][1]
        if kind.startswith("map:") and not isinstance(value, _Map):
            value = _Map(kind.split(":", 2)[2], value)
        self.__dict__[name] = value

    def __repr__(self):
        body = ", ".join(f"{k}={v!r}" for k, v in self.__dict__.items()
                         if k != "_type")
        return f"{self._type}({body})"


def new(type_name: str, **fields) -> Message:
    """A message built in Python (``new("NodeDef", name="x", op="Const")``)."""
    return Message(type_name, **fields)


# -- the wire format ----------------------------------------------------------
def _varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ProtoError("varint longer than 10 bytes")


def _signed(v, kind):
    if kind in ("int64", "int32", "enum") and v >= 1 << 63:
        return v - (1 << 64)   # a negative int takes 10 bytes, sign-extended
    return v


def _scalar_varint(v, kind):
    if kind == "bool":
        return bool(v)
    if kind == "uint32":
        return v & 0xFFFFFFFF
    v = _signed(v, kind)
    if kind == "int32" and not -(1 << 31) <= v < (1 << 31):
        v = ((v + (1 << 31)) % (1 << 32)) - (1 << 31)
    return v


def _skip(buf, pos, wt, end):
    if wt == 0:
        _v, pos = _varint(buf, pos)
    elif wt == 1:
        pos += 8
    elif wt == 2:
        n, pos = _varint(buf, pos)
        pos += n
    elif wt == 5:
        pos += 4
    elif wt in (3, 4):
        raise ProtoError("protobuf groups (wire types 3 and 4) are not read")
    else:
        raise ProtoError(f"unknown wire type {wt}")
    if pos > end:
        raise ProtoError("field runs past the end of its message")
    return pos


def _parse(type_name, buf, pos, end):
    schema = SCHEMAS[type_name]
    msg = Message(type_name)
    d = msg.__dict__
    while pos < end:
        key, pos = _varint(buf, pos)
        num, wt = key >> 3, key & 7
        spec = schema.get(num)
        if spec is None:
            pos = _skip(buf, pos, wt, end)
            continue
        name, kind, rep = spec
        if kind.startswith("msg:"):
            if wt != 2:
                raise ProtoError(f"{type_name}.{name}: wire type {wt}")
            n, pos = _varint(buf, pos)
            if pos + n > end:
                raise ProtoError(f"{type_name}.{name} runs past its end")
            sub = _parse(kind[4:], buf, pos, pos + n)
            pos += n
            if rep:
                d.setdefault(name, []).append(sub)
            else:
                d[name] = sub
        elif kind.startswith("map:"):
            if wt != 2:
                raise ProtoError(f"{type_name}.{name}: wire type {wt}")
            n, pos = _varint(buf, pos)
            k, v = _map_entry(kind, buf, pos, pos + n)
            pos += n
            m = d.get(name)
            if m is None:
                m = d[name] = _Map(kind.split(":", 2)[2])
            m[k] = v
        elif kind in ("string", "bytes"):
            if wt != 2:
                raise ProtoError(f"{type_name}.{name}: wire type {wt}")
            n, pos = _varint(buf, pos)
            if pos + n > end:
                raise ProtoError(f"{type_name}.{name} runs past its end")
            raw = bytes(buf[pos:pos + n])
            pos += n
            v = raw.decode("utf-8") if kind == "string" else raw
            if rep:
                d.setdefault(name, []).append(v)
            else:
                d[name] = v
        elif kind in _VARINT:
            if wt == 0:
                v, pos = _varint(buf, pos)
                v = _scalar_varint(v, kind)
                if rep:
                    d.setdefault(name, []).append(v)
                else:
                    d[name] = v
            elif wt == 2 and rep:          # packed
                n, pos = _varint(buf, pos)
                stop = pos + n
                out = d.setdefault(name, [])
                while pos < stop:
                    v, pos = _varint(buf, pos)
                    out.append(_scalar_varint(v, kind))
            else:
                raise ProtoError(f"{type_name}.{name}: wire type {wt}")
        else:
            fmt, size = _FIXED[kind]
            if wt == 2 and rep:            # packed
                n, pos = _varint(buf, pos)
                vals = np.frombuffer(bytes(buf[pos:pos + n]),
                                     dtype=fmt).tolist()
                pos += n
                d.setdefault(name, []).extend(vals)
            elif wt == (5 if size == 4 else 1):
                (v,) = struct.unpack_from(fmt, buf, pos)
                pos += size
                if rep:
                    d.setdefault(name, []).append(v)
                else:
                    d[name] = v
            else:
                raise ProtoError(f"{type_name}.{name}: wire type {wt}")
    if pos != end:
        raise ProtoError(f"{type_name} runs past its end")
    return msg


def _map_entry(kind, buf, pos, end):
    _m, key_kind, value_kind = kind.split(":", 2)
    key, value = _default(key_kind), None
    while pos < end:
        tag, pos = _varint(buf, pos)
        num, wt = tag >> 3, tag & 7
        if num in (1, 2) and wt == 2:
            n, pos = _varint(buf, pos)
            if num == 1:
                key = bytes(buf[pos:pos + n]).decode("utf-8")
            elif value_kind.startswith("msg:"):
                value = _parse(value_kind[4:], buf, pos, pos + n)
            else:
                value = bytes(buf[pos:pos + n]).decode("utf-8")
            pos += n
        else:
            pos = _skip(buf, pos, wt, end)
    return key, value if value is not None else _default(value_kind)


def parse(type_name: str, data) -> Message:
    """``data`` (bytes) read as one message of ``type_name``."""
    if type_name not in SCHEMAS:
        raise KeyError(f"no schema for {type_name!r}; known: "
                       f"{sorted(SCHEMAS)}")
    buf = memoryview(data).cast("B") if not isinstance(data, bytes) else data
    try:
        return _parse(type_name, buf, 0, len(buf))
    except IndexError:
        raise ProtoError(f"truncated {type_name}") from None


# -- TensorProto <-> numpy ------------------------------------------------------
def shape_of(shape_proto) -> tuple:
    """A ``TensorShapeProto`` as a tuple (-1 for an unknown size)."""
    return tuple(int(d.size) for d in shape_proto.dim)


def make_ndarray(tensor):
    """``tf.make_ndarray``: a ``TensorProto`` as a numpy array (a bfloat16
    tensor as a torch tensor). ``tensor_content`` is raw little-endian
    bytes; else the typed field, whose last value repeats when it holds
    fewer values than the shape has elements."""
    shape = shape_of(tensor.tensor_shape)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    base = tensor.dtype - 100 if tensor.dtype > 100 else tensor.dtype
    if base == 14:
        import torch

        if tensor.tensor_content:
            bits = np.frombuffer(tensor.tensor_content, "<u2").copy()
        else:
            bits = _fill(np.asarray(tensor.half_val, np.int64).astype(
                np.uint16), n)
        return torch.from_numpy(bits.astype(np.int16)).view(
            torch.bfloat16).reshape(shape)
    dt = np_dtype(tensor.dtype)
    if tensor.tensor_content and dt != object:
        return np.frombuffer(tensor.tensor_content,
                             dt.newbyteorder("<")).astype(dt).reshape(shape)
    if base == 19:
        vals = np.asarray(tensor.half_val, np.int64).astype(
            np.uint16).view(np.float16)
    elif base == 1:
        vals = np.asarray(tensor.float_val, np.float32)
    elif base == 2:
        vals = np.asarray(tensor.double_val, np.float64)
    elif base in (3, 4, 5, 6, 11, 12, 13, 15, 16, 17):
        vals = np.asarray(tensor.int_val, np.int64).astype(dt)
    elif base == 9:
        vals = np.asarray(tensor.int64_val, np.int64)
    elif base == 22:
        vals = np.asarray(tensor.uint32_val, np.uint32)
    elif base == 23:
        vals = np.asarray(tensor.uint64_val, np.uint64)
    elif base == 10:
        vals = np.asarray(tensor.bool_val, np.bool_)
    elif base == 7:
        vals = np.empty(len(tensor.string_val), dtype=object)
        vals[:] = list(tensor.string_val)
    elif base in (8, 18):
        flat = np.asarray(tensor.scomplex_val if base == 8
                          else tensor.dcomplex_val, np.float64)
        vals = (flat[0::2] + 1j * flat[1::2]).astype(dt)
    else:
        raise NotImplementedError(f"TensorProto dtype {tensor.dtype}")
    return _fill(vals.astype(dt), n).reshape(shape)


def _fill(vals, n):
    if vals.size == n:
        return vals
    if vals.size == 0:
        return np.zeros(n, vals.dtype) if vals.dtype != object else \
            np.full(n, b"", dtype=object)
    if vals.size > n:
        raise ProtoError(f"TensorProto holds {vals.size} values for {n} "
                         "elements")
    return np.concatenate([vals, np.repeat(vals[-1:], n - vals.size)])


_ENUM_OF = {np.dtype(v): k for k, v in _NP.items()
            if k not in (11, 12, 13, 15, 16) and v is not object}


def tensor_proto(array, dtype_enum: int | None = None) -> Message:
    """A numpy array as a ``TensorProto`` (``tensor_content`` holds its
    little-endian bytes)."""
    a = np.asarray(array, order="C")
    enum = dtype_enum if dtype_enum is not None else _ENUM_OF[a.dtype]
    shape = new("TensorShapeProto",
                dim=[new("Dim", size=int(s)) for s in a.shape])
    return new("TensorProto", dtype=enum, tensor_shape=shape,
               tensor_content=a.astype(a.dtype.newbyteorder("<")).tobytes())
