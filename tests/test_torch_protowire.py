"""The port's protobuf wire reader (``tpudl_torch.ingest.protowire``)
against TensorFlow's own parse of the same bytes: every schema field
number against the ``_pb2`` descriptors of the tensorflow on this host,
every node, attr and tensor of each committed fixture
(``tests/fixtures/tf``), ``make_ndarray`` against ``tf.make_ndarray``,
and the wire format's corners (10-byte negative varints, packed and
unpacked repeated scalars, unknown fields, groups)."""

import gzip
from pathlib import Path

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from google.protobuf.descriptor import FieldDescriptor as FD  # noqa: E402
from tensorflow.core.framework import (attr_value_pb2, function_pb2,  # noqa: E402
                                       graph_pb2, node_def_pb2, op_def_pb2,
                                       tensor_pb2, tensor_shape_pb2)
from tensorflow.core.protobuf import (meta_graph_pb2, saved_model_pb2,  # noqa: E402
                                      saver_pb2, tensor_bundle_pb2)

from tpudl_torch.ingest import protowire as pw  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "tf"

TF_TYPES = {
    "GraphDef": graph_pb2.GraphDef, "NodeDef": node_def_pb2.NodeDef,
    "AttrValue": attr_value_pb2.AttrValue,
    "ListValue": attr_value_pb2.AttrValue.ListValue,
    "NameAttrList": attr_value_pb2.NameAttrList,
    "TensorProto": tensor_pb2.TensorProto,
    "TensorShapeProto": tensor_shape_pb2.TensorShapeProto,
    "Dim": tensor_shape_pb2.TensorShapeProto.Dim,
    "FunctionDefLibrary": function_pb2.FunctionDefLibrary,
    "FunctionDef": function_pb2.FunctionDef, "OpDef": op_def_pb2.OpDef,
    "ArgDef": op_def_pb2.OpDef.ArgDef,
    "SavedModel": saved_model_pb2.SavedModel,
    "MetaGraphDef": meta_graph_pb2.MetaGraphDef,
    "MetaInfoDef": meta_graph_pb2.MetaGraphDef.MetaInfoDef,
    "SignatureDef": meta_graph_pb2.SignatureDef,
    "TensorInfo": meta_graph_pb2.TensorInfo,
    "SaverDef": saver_pb2.SaverDef,
    "BundleHeaderProto": tensor_bundle_pb2.BundleHeaderProto,
    "BundleEntryProto": tensor_bundle_pb2.BundleEntryProto,
}
_KIND = {FD.TYPE_INT32: "int32", FD.TYPE_INT64: "int64",
         FD.TYPE_UINT32: "uint32", FD.TYPE_UINT64: "uint64",
         FD.TYPE_BOOL: "bool", FD.TYPE_ENUM: "enum", FD.TYPE_FLOAT: "float",
         FD.TYPE_DOUBLE: "double", FD.TYPE_FIXED32: "fixed32",
         FD.TYPE_STRING: "string", FD.TYPE_BYTES: "bytes"}


@pytest.mark.parametrize("name", sorted(TF_TYPES))
def test_field_numbers_match_tf_descriptors(name):
    desc = TF_TYPES[name].DESCRIPTOR
    for num, (field, kind, rep) in pw.SCHEMAS[name].items():
        f = desc.fields_by_name[field]
        assert f.number == num, (name, field)
        if kind.startswith("map:"):
            assert f.message_type.GetOptions().map_entry, (name, field)
            continue
        assert f.is_repeated == rep, (name, field)
        if kind.startswith("msg:"):
            assert f.message_type.name == kind[4:], (name, field)
        else:
            assert _KIND[f.type] == kind, (name, field)


def _same(mine, theirs, path):
    """Every schema field of ``mine`` equals TF's message ``theirs``."""
    for num, (field, kind, rep) in pw.SCHEMAS[mine._type].items():
        a, b = getattr(mine, field), getattr(theirs, field)
        where = f"{path}.{field}"
        if kind.startswith("map:"):
            assert sorted(a) == sorted(b), where
            for k in b:
                if kind.endswith("string"):
                    assert a[k] == b[k], where
                else:
                    _same(a[k], b[k], f"{where}[{k}]")
        elif kind.startswith("msg:"):
            if rep:
                assert len(a) == len(b), where
                for i, (x, y) in enumerate(zip(a, b)):
                    _same(x, y, f"{where}[{i}]")
            else:
                _same(a, b, where)
        elif kind == "float":
            assert np.array_equal(np.float32(a), np.float32(list(b) if rep
                                                            else b)), where
        else:
            assert (list(a) if rep else a) == (list(b) if rep else b), where


def _fixture_bytes():
    out = {}
    for p in sorted(FIXTURES.rglob("saved_model.pb")):
        out[str(p.relative_to(FIXTURES))] = ("SavedModel", p.read_bytes())
    out["inception_v3_tl/saved_model.pb.gz"] = ("SavedModel", gzip.decompress(
        (FIXTURES / "inception_v3_tl" / "saved_model.pb.gz").read_bytes()))
    out["factory.pb"] = ("GraphDef", (FIXTURES / "factory.pb").read_bytes())
    out["factory_ckpt/model.meta"] = (
        "MetaGraphDef", (FIXTURES / "factory_ckpt" / "model.meta").read_bytes())
    return out


FIXTURE_BYTES = _fixture_bytes()


@pytest.mark.parametrize("name", sorted(FIXTURE_BYTES))
def test_fixture_parses_as_tf_parses_it(name):
    type_name, data = FIXTURE_BYTES[name]
    theirs = TF_TYPES[type_name]()
    theirs.ParseFromString(data)
    _same(pw.parse(type_name, data), theirs, type_name)


@pytest.mark.parametrize("name", sorted(FIXTURE_BYTES))
def test_every_const_tensor_reads_as_tf_make_ndarray(name):
    type_name, data = FIXTURE_BYTES[name]
    theirs = TF_TYPES[type_name]()
    theirs.ParseFromString(data)
    mine = pw.parse(type_name, data)
    graphs = ([(m.graph_def, t.graph_def) for m, t in
               zip(mine.meta_graphs, theirs.meta_graphs)]
              if type_name == "SavedModel" else
              [(mine.graph_def, theirs.graph_def)]
              if type_name == "MetaGraphDef" else [(mine, theirs)])
    n = 0
    for g, tg in graphs:
        nodes = [(a, b) for a, b in zip(g.node, tg.node)]
        for f, tfn in zip(g.library.function, tg.library.function):
            nodes += list(zip(f.node_def, tfn.node_def))
        for a, b in nodes:
            if b.op != "Const":
                continue
            want = tf.make_ndarray(b.attr["value"].tensor)
            got = pw.make_ndarray(a.attr["value"].tensor)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want), b.name
            n += 1
    assert n > 0


@pytest.mark.parametrize("value", [
    np.float32(2.5), np.arange(6, dtype=np.float32).reshape(2, 3),
    np.array([1.5, -2.25]), np.arange(-3, 3, dtype=np.int32),
    np.array([-(2 ** 40), 7], dtype=np.int64), np.array([1, 255], np.uint8),
    np.array([-5, 5], np.int8), np.array([3, 60000], np.uint16),
    np.array([True, False]), np.array([0.5, -1.5], np.float16),
    np.array([1 + 2j, -3j], np.complex64), np.array([b"ab", b""]),
], ids=lambda v: str(np.asarray(v).dtype))
def test_make_ndarray_matches_tf(value):
    for proto in (tf.make_tensor_proto(value),
                  tf.make_tensor_proto(value, shape=(2,) + np.shape(value))):
        got = pw.make_ndarray(pw.parse("TensorProto",
                                       proto.SerializeToString()))
        want = tf.make_ndarray(proto)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


def test_fewer_values_than_elements_repeat_the_last():
    proto = tensor_pb2.TensorProto(dtype=1)
    proto.tensor_shape.dim.add(size=5)
    proto.float_val.extend([1.0, 2.0])
    got = pw.make_ndarray(pw.parse("TensorProto", proto.SerializeToString()))
    np.testing.assert_array_equal(got, tf.make_ndarray(proto))
    np.testing.assert_array_equal(got, [1, 2, 2, 2, 2])


def test_bfloat16_and_half_bits():
    import torch

    bits = np.array([0x3FC0, 0xC000, 0x7F80], np.uint16)   # 1.5, -2, inf
    proto = tensor_pb2.TensorProto(dtype=14)
    proto.tensor_shape.dim.add(size=3)
    proto.half_val.extend(bits.tolist())
    got = pw.make_ndarray(pw.parse("TensorProto", proto.SerializeToString()))
    assert got.dtype == torch.bfloat16
    assert got.float().tolist() == [1.5, -2.0, float("inf")]
    proto.tensor_content = bits.tobytes()
    del proto.half_val[:]
    got = pw.make_ndarray(pw.parse("TensorProto", proto.SerializeToString()))
    assert got.float().tolist() == [1.5, -2.0, float("inf")]


def _varint(v):
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def test_negative_varints_unpacked_lists_and_unknown_fields():
    # AttrValue.list.i = [1, -1] unpacked (field 3, wire type 0 each), then
    # an unknown field 99 (varint) the reader skips
    neg = _varint(-1)
    assert len(neg) == 10
    lst = b"\x18\x01" + b"\x18" + neg
    data = b"\x0a" + bytes([len(lst)]) + lst + _varint(99 << 3) + b"\x05"
    mine = pw.parse("AttrValue", data)
    theirs = attr_value_pb2.AttrValue()
    theirs.ParseFromString(data)
    assert mine.list.i == list(theirs.list.i) == [1, -1]
    # the same list packed, as TF writes it
    packed = theirs.SerializeToString()
    assert pw.parse("AttrValue", packed).list.i == [1, -1]
    # a shape dim of -1
    shape = tensor_shape_pb2.TensorShapeProto()
    shape.dim.add(size=-1)
    shape.dim.add(size=3)
    assert pw.shape_of(pw.parse("TensorShapeProto",
                                shape.SerializeToString())) == (-1, 3)


def test_groups_and_truncation_raise():
    with pytest.raises(pw.ProtoError, match="groups"):
        pw.parse("NodeDef", _varint((7 << 3) | 3) + _varint((7 << 3) | 4))
    node = node_def_pb2.NodeDef(name="abc", op="Const").SerializeToString()
    with pytest.raises(pw.ProtoError):
        pw.parse("NodeDef", node[:-1])


def test_maps_read_missing_keys_as_defaults():
    node = pw.parse("NodeDef", node_def_pb2.NodeDef(
        name="n", op="MatMul").SerializeToString())
    assert node.attr["transpose_a"].b is False
    assert "transpose_a" not in node.attr
    assert node.attr["strides"].list.i == []
    assert node.input == []
