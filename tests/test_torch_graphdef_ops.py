"""The port's GraphDef evaluator op by op: every op of tpudl's ``_OPS`` runs
through ``tpudl_torch.ingest.graphdef.build_torch_fn`` and tpudl's
``build_jax_fn`` on the same GraphDef (written by TF here, read by the
port from its wire bytes) and the same numpy inputs: float32 within 1e-5
relative, float64 within 1e-12 (tpudl under ``jax.enable_x64``),
integers and booleans exactly. Where tpudl's jax semantics differ from
TF's (``Mod`` on negatives, ``Select`` with a vector condition, a
shrinking ``ResizeBilinear``, ``Cumsum``'s ``exclusive``/``reverse``,
``SplitV`` with -1 before the end), the case is held to TF's session
instead (ROADMAP Queue 3, reference caveats)."""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402

from tpudl.ingest import graphdef as jg  # noqa: E402
from tpudl_torch.ingest import graphdef as tg  # noqa: E402
from tpudl_torch.ingest import protowire as pw  # noqa: E402

R = np.random.default_rng(0)


def f32(*shape, lo=-2.0, hi=2.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


def f64(*shape, lo=-2.0, hi=2.0):
    return R.uniform(lo, hi, shape)


def ph(name, value):
    return tf.compat.v1.placeholder(tf.as_dtype(value.dtype), value.shape,
                                    name=name)


# -- cases: name -> (build(feeds) -> fetch tensors, feeds, reference) -------
CASES = {}


def case(name, feeds, ref="tpudl"):
    def deco(build):
        CASES[name] = (build, feeds, ref)
        return build
    return deco


UNARY = {"Relu": None, "Relu6": None, "Elu": None, "Selu": None,
         "Softplus": None, "Softsign": None, "Sigmoid": None, "Tanh": None,
         "Exp": None, "Log": (0.1, 3), "Log1p": (0.1, 3), "Sqrt": (0.1, 3),
         "Rsqrt": (0.1, 3), "Square": None, "Neg": None, "Abs": None,
         "Sign": None, "Floor": None, "Ceil": None, "Round": None,
         "Erf": None, "Sin": None, "Cos": None, "Reciprocal": (0.1, 3),
         "Identity": None, "StopGradient": None, "ZerosLike": None,
         "OnesLike": None, "Snapshot": None}
_ARG = {"Relu": "features", "Relu6": "features", "Elu": "features",
        "Selu": "features", "Softplus": "features", "Softsign": "features",
        "Identity": "input", "StopGradient": "input", "Snapshot": "input"}
for _op, _dom in UNARY.items():
    lo, hi = _dom or (-7.0, 7.0)
    for _dt, _make in (("f32", f32), ("f64", f64)):
        if _dt == "f64" and _op not in ("Relu", "Elu", "Selu", "Softplus",
                                        "Sigmoid", "Tanh", "Exp", "Log",
                                        "Rsqrt", "Erf", "Round"):
            continue
        case(f"{_op}-{_dt}", {"a": _make(3, 5, lo=lo, hi=hi)})(
            lambda a, _op=_op: getattr(tf.raw_ops, _op)(
                **{_ARG.get(_op, "x"): a}))

case("LogicalNot", {"a": R.random((4, 3)) > 0.5})(
    lambda a: tf.raw_ops.LogicalNot(x=a))

BINARY = {"Add": None, "AddV2": None, "Sub": None, "Mul": None,
          "RealDiv": (0.5, 3), "Div": (0.5, 3), "FloorDiv": (0.5, 3),
          "FloorMod": (0.5, 3), "Mod": (0.5, 3), "Pow": (0.5, 2),
          "Maximum": None, "Minimum": None, "SquaredDifference": None,
          "Greater": None, "GreaterEqual": None, "Less": None,
          "LessEqual": None, "Equal": None, "NotEqual": None}
for _op, _dom in BINARY.items():
    for _dt, _make in (("f32", f32), ("f64", f64)):
        if _dt == "f64" and _op not in ("Add", "Mul", "RealDiv", "Pow",
                                        "FloorMod"):
            continue
        lo, hi = _dom or (-3.0, 3.0)
        b = _make(3, 4, lo=lo, hi=hi)
        a = _make(3, 4, lo=0.1 if _op in ("Pow", "Mod") else -3.0, hi=3.0)
        if _op in ("Equal", "NotEqual", "GreaterEqual", "LessEqual"):
            a[0] = b[0]
        case(f"{_op}-{_dt}", {"a": a, "b": b})(
            lambda a, b, _op=_op: getattr(tf.raw_ops, _op)(x=a, y=b))

case("Add-broadcast-const", {"a": f32(2, 3)})(
    lambda a: tf.raw_ops.AddV2(x=a, y=tf.constant([1.0, 2.0, 3.0])))
case("Mul-scalar-const", {"a": f32(2, 3)})(
    lambda a: tf.raw_ops.Mul(x=tf.constant(2.5), y=a))
case("DivNoNan", {"a": f32(3, 4), "b": np.where(R.random((3, 4)) > 0.5,
                                                 f32(3, 4), 0).astype(
                                                     np.float32)})(
    lambda a, b: tf.raw_ops.DivNoNan(x=a, y=b))
case("Mod-negative", {"a": f32(3, 4, lo=-5, hi=5),
                      "b": f32(3, 4, lo=0.5, hi=2)}, ref="tf")(
    lambda a, b: tf.raw_ops.Mod(x=a, y=b))
for _op in ("LogicalAnd", "LogicalOr"):
    case(_op, {"a": R.random((3, 4)) > 0.5, "b": R.random((3, 4)) > 0.5})(
        lambda a, b, _op=_op: getattr(tf.raw_ops, _op)(x=a, y=b))
for _op in ("BitwiseAnd", "BitwiseOr", "LeftShift", "RightShift"):
    case(_op, {"a": R.integers(0, 64, (3, 4), dtype=np.int32),
               "b": R.integers(0, 5, (3, 4), dtype=np.int32)})(
        lambda a, b, _op=_op: getattr(tf.raw_ops, _op)(x=a, y=b))
case("FloorDiv-int", {"a": R.integers(-9, 9, (3, 4), dtype=np.int32),
                      "b": R.integers(1, 4, (3, 4), dtype=np.int32)})(
    lambda a, b: tf.raw_ops.FloorDiv(x=a, y=b))


@case("Const", {"a": f32(2, 2)})
def _c(a):
    return tf.raw_ops.AddV2(x=a, y=tf.constant(
        np.arange(4, dtype=np.float32).reshape(2, 2)))


@case("CheckNumerics-PreventGradient", {"a": f32(2, 3)})
def _cn(a):
    return tf.raw_ops.PreventGradient(input=tf.raw_ops.CheckNumerics(
        tensor=a, message="m"))


for _src, _dst in (("f32", tf.int32), ("f32", tf.float64),
                   ("f64", tf.float32), ("f32", tf.bool)):
    case(f"Cast-{_src}-{_dst.name}",
         {"a": (f32 if _src == "f32" else f64)(3, 4, lo=-4, hi=4)})(
        lambda a, _dst=_dst: tf.raw_ops.Cast(x=a, DstT=_dst))

case("AddN", {"a": f32(2, 3), "b": f32(2, 3), "c": f32(2, 3)})(
    lambda a, b, c: tf.raw_ops.AddN(inputs=[a, b, c]))
for _ta in (False, True):
    for _tb in (False, True):
        case(f"MatMul-{_ta:d}{_tb:d}", {"a": f32(3, 3), "b": f32(3, 3)})(
            lambda a, b, _ta=_ta, _tb=_tb: tf.raw_ops.MatMul(
                a=a, b=b, transpose_a=_ta, transpose_b=_tb))
case("MatMul-f64", {"a": f64(4, 5), "b": f64(5, 3)})(
    lambda a, b: tf.raw_ops.MatMul(a=a, b=b))
case("BatchMatMul", {"a": f32(2, 3, 4), "b": f32(2, 3, 5)})(
    lambda a, b: tf.raw_ops.BatchMatMul(x=a, y=b, adj_x=True))
case("BatchMatMulV2", {"a": f32(2, 3, 4), "b": f32(4, 5)})(
    lambda a, b: tf.raw_ops.BatchMatMulV2(x=a, y=b))
case("BatchMatMulV3", {"a": f32(2, 3, 4), "b": f32(2, 5, 4)})(
    lambda a, b: tf.raw_ops.BatchMatMulV3(x=a, y=b, Tout=tf.float32,
                                          adj_y=True))
case("Einsum", {"a": f32(2, 3, 4), "b": f32(4, 5)})(
    lambda a, b: tf.raw_ops.Einsum(inputs=[a, b], equation="bij,jk->bik"))
case("BiasAdd-NHWC", {"a": f32(2, 3, 3, 4), "b": f32(4)})(
    lambda a, b: tf.raw_ops.BiasAdd(value=a, bias=b))
case("BiasAdd-NCHW", {"a": f32(2, 4, 3, 3), "b": f32(4)})(
    lambda a, b: tf.raw_ops.BiasAdd(value=a, bias=b, data_format="NCHW"))

CONVS = {  # name: (input shape, kernel, strides, padding, dilations)
    "Conv2D-SAME-s1": ((2, 7, 7, 3), (3, 3, 3, 4), 1, "SAME", 1),
    "Conv2D-SAME-s2-odd": ((2, 7, 9, 3), (3, 3, 3, 4), 2, "SAME", 1),
    "Conv2D-SAME-s2-even-asym": ((2, 8, 8, 3), (3, 3, 3, 4), 2, "SAME", 1),
    "Conv2D-SAME-1x7": ((1, 9, 9, 2), (1, 7, 2, 3), 1, "SAME", 1),
    "Conv2D-VALID-s2": ((2, 9, 9, 3), (3, 3, 3, 4), 2, "VALID", 1),
    "Conv2D-SAME-dilated": ((1, 9, 9, 2), (3, 3, 2, 3), 1, "SAME", 2),
}
for _n, (_xs, _ks, _s, _p, _d) in CONVS.items():
    case(_n, {"a": f32(*_xs)})(
        lambda a, _ks=_ks, _s=_s, _p=_p, _d=_d: tf.raw_ops.Conv2D(
            input=a, filter=tf.constant(f32(*_ks)), strides=[1, _s, _s, 1],
            padding=_p, dilations=[1, _d, _d, 1]))
case("Conv2D-EXPLICIT", {"a": f32(1, 6, 6, 2)})(
    lambda a: tf.raw_ops.Conv2D(
        input=a, filter=tf.constant(f32(3, 3, 2, 3)), strides=[1, 1, 1, 1],
        padding="EXPLICIT", explicit_paddings=[0, 0, 1, 2, 0, 1, 0, 0]))
case("Conv2D-f64", {"a": f64(1, 5, 5, 2)})(
    lambda a: tf.raw_ops.Conv2D(input=a, filter=tf.constant(f64(3, 3, 2, 3)),
                                strides=[1, 2, 2, 1], padding="SAME"))
case("Depthwise-mult2-SAME-s2", {"a": f32(2, 7, 7, 3)})(
    lambda a: tf.raw_ops.DepthwiseConv2dNative(
        input=a, filter=tf.constant(f32(3, 3, 3, 2)), strides=[1, 2, 2, 1],
        padding="SAME"))
case("Depthwise-VALID", {"a": f32(1, 6, 6, 4)})(
    lambda a: tf.raw_ops.DepthwiseConv2dNative(
        input=a, filter=tf.constant(f32(3, 3, 4, 1)), strides=[1, 1, 1, 1],
        padding="VALID"))
for _p, _out in (("SAME", (2, 8, 8, 3)), ("VALID", (2, 9, 9, 3))):
    case(f"Conv2DBackpropInput-{_p}", {"a": f32(2, 4, 4, 5)})(
        lambda a, _p=_p, _out=_out: tf.raw_ops.Conv2DBackpropInput(
            input_sizes=tf.constant(_out, tf.int32),
            filter=tf.constant(f32(3, 3, 3, 5)), out_backprop=a,
            strides=[1, 2, 2, 1], padding=_p))
POOLS = {"SAME-3x3-s1": (3, 1, "SAME", (2, 7, 7, 3)),
         "SAME-3x3-s2-odd": (3, 2, "SAME", (2, 9, 7, 3)),
         "SAME-2x2-s2-odd": (2, 2, "SAME", (1, 5, 5, 2)),
         "VALID-3x3-s2": (3, 2, "VALID", (2, 9, 9, 3))}
for _op in ("MaxPool", "AvgPool"):
    for _n, (_k, _s, _p, _shape) in POOLS.items():
        case(f"{_op}-{_n}", {"a": f32(*_shape)})(
            lambda a, _op=_op, _k=_k, _s=_s, _p=_p: getattr(tf.raw_ops, _op)(
                **{"input" if _op == "MaxPool" else "value": a},
                ksize=[1, _k, _k, 1], strides=[1, _s, _s, 1], padding=_p))
for _op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
    case(_op, {"a": f32(2, 4, 4, 3)})(
        lambda a, _op=_op: getattr(tf.raw_ops, _op)(
            x=a, scale=tf.constant(f32(3, lo=0.5, hi=1.5)),
            offset=tf.constant(f32(3)), mean=tf.constant(f32(3)),
            variance=tf.constant(f32(3, lo=0.5, hi=1.5)), epsilon=1e-3,
            is_training=False)[0])
case("Softmax", {"a": f32(3, 5)})(lambda a: tf.raw_ops.Softmax(logits=a))
case("LogSoftmax", {"a": f32(3, 5)})(
    lambda a: tf.raw_ops.LogSoftmax(logits=a))
case("LeakyRelu", {"a": f32(3, 5)})(
    lambda a: tf.raw_ops.LeakyRelu(features=a, alpha=0.1))


@case("Reshape-flatten-chain", {"a": f32(2, 3, 4)})
def _flatten(a):
    s = tf.shape(a)
    return tf.reshape(a, tf.stack([s[0], -1]))


case("Reshape-const", {"a": f32(2, 6)})(
    lambda a: tf.reshape(a, tf.constant([3, -1])))
case("Squeeze", {"a": f32(2, 1, 3, 1)})(
    lambda a: tf.raw_ops.Squeeze(input=a, axis=[1]))
case("Squeeze-all", {"a": f32(2, 1, 3, 1)})(
    lambda a: tf.raw_ops.Squeeze(input=a))
case("ExpandDims", {"a": f32(2, 3)})(
    lambda a: tf.raw_ops.ExpandDims(input=a, axis=tf.constant(-1)))
case("Transpose", {"a": f32(2, 3, 4)})(
    lambda a: tf.raw_ops.Transpose(x=a, perm=tf.constant([2, 0, 1])))
case("ConcatV2", {"a": f32(2, 3), "b": f32(2, 2)})(
    lambda a, b: tf.raw_ops.ConcatV2(values=[a, b], axis=tf.constant(1)))
case("Concat", {"a": f32(2, 3), "b": f32(1, 3)})(
    lambda a, b: tf.raw_ops.Concat(concat_dim=tf.constant(0), values=[a, b]))
case("Pack", {"a": f32(2, 3), "b": f32(2, 3)})(
    lambda a, b: tf.raw_ops.Pack(values=[a, b], axis=-1))
case("Unpack", {"a": f32(3, 2, 4)})(
    lambda a: tf.raw_ops.Unpack(value=a, num=2, axis=1))
case("Split", {"a": f32(2, 6)})(
    lambda a: tf.raw_ops.Split(axis=tf.constant(1), value=a, num_split=3))
case("SplitV", {"a": f32(2, 6)})(
    lambda a: tf.raw_ops.SplitV(value=a, size_splits=tf.constant([1, 2, 3]),
                                axis=tf.constant(1), num_split=3))
case("SplitV-minus-one", {"a": f32(2, 6)}, ref="tf")(
    lambda a: tf.raw_ops.SplitV(value=a, size_splits=tf.constant([1, -1, 2]),
                                axis=tf.constant(1), num_split=3))
case("Slice", {"a": f32(4, 5)})(
    lambda a: tf.raw_ops.Slice(input=a, begin=tf.constant([1, 2]),
                               size=tf.constant([2, -1])))
STRIDED = {  # begin, end, strides, masks (begin, end, ellipsis, new, shrink)
    "basic": ([1, 0], [3, 4], [1, 2], (0, 0, 0, 0, 0)),
    "masks": ([1, 1], [0, 3], [1, 1], (1, 2, 0, 0, 0)),
    "shrink": ([1, 0], [2, 5], [1, 1], (0, 2, 0, 0, 1)),
    "new-axis": ([0, 0, 1], [0, 0, 3], [1, 1, 1], (0, 0, 0, 1, 0)),
    "ellipsis": ([0, 1], [0, 3], [1, 1], (0, 0, 1, 0, 0)),
    "negative-step": ([3, 4], [0, 0], [-1, -2], (0, 0, 0, 0, 0)),
    "negative-begin": ([-2, 0], [0, 0], [1, 1], (0, 3, 0, 0, 0)),
}
for _n, (_b, _e, _s, (_bm, _em, _el, _na, _sa)) in STRIDED.items():
    case(f"StridedSlice-{_n}", {"a": f32(4, 5)})(
        lambda a, _b=_b, _e=_e, _s=_s, _bm=_bm, _em=_em, _el=_el, _na=_na,
        _sa=_sa: tf.raw_ops.StridedSlice(
            input=a, begin=tf.constant(_b), end=tf.constant(_e),
            strides=tf.constant(_s), begin_mask=_bm, end_mask=_em,
            ellipsis_mask=_el, new_axis_mask=_na, shrink_axis_mask=_sa))
case("Shape", {"a": f32(2, 3, 4)})(lambda a: tf.raw_ops.Shape(input=a))
case("Shape-int64", {"a": f32(2, 3)})(
    lambda a: tf.raw_ops.Shape(input=a, out_type=tf.int64))
case("Size", {"a": f32(2, 3, 4)})(lambda a: tf.raw_ops.Size(input=a))
case("Rank", {"a": f32(2, 3, 4)})(lambda a: tf.raw_ops.Rank(input=a))
case("Fill", {"a": f32(2, 3)})(
    lambda a: tf.raw_ops.AddV2(x=a, y=tf.raw_ops.Fill(
        dims=tf.shape(a), value=tf.constant(1.5))))
case("Fill-const", {"a": f32(2, 3)})(
    lambda a: a + tf.raw_ops.Fill(dims=tf.constant([2, 3]),
                                  value=tf.constant(0.5)))
case("Range", {"a": f32(5)})(
    lambda a: a * tf.cast(tf.raw_ops.Range(
        start=tf.constant(0), limit=tf.shape(a)[0], delta=tf.constant(1)),
        tf.float32))
case("Tile", {"a": f32(2, 3)})(
    lambda a: tf.raw_ops.Tile(input=a, multiples=tf.constant([2, 3])))
case("Pad", {"a": f32(2, 3)})(
    lambda a: tf.raw_ops.Pad(input=a, paddings=tf.constant([[1, 0], [2, 1]])))
case("PadV2", {"a": f32(2, 3)})(
    lambda a: tf.raw_ops.PadV2(input=a, paddings=tf.constant([[0, 1], [1, 1]]),
                               constant_values=tf.constant(-1.5)))
for _mode in ("REFLECT", "SYMMETRIC"):
    case(f"MirrorPad-{_mode}", {"a": f32(3, 4)})(
        lambda a, _mode=_mode: tf.raw_ops.MirrorPad(
            input=a, paddings=tf.constant([[1, 2], [2, 1]]), mode=_mode))
for _op in ("Mean", "Sum", "Max", "Min", "Prod"):
    for _keep in (False, True):
        case(f"{_op}-keep{_keep:d}", {"a": f32(2, 3, 4, lo=0.5, hi=1.5)})(
            lambda a, _op=_op, _keep=_keep: getattr(tf.raw_ops, _op)(
                input=a, axis=tf.constant([1, 2]), keep_dims=_keep))
case("Mean-f64", {"a": f64(3, 4)})(
    lambda a: tf.raw_ops.Mean(input=a, axis=tf.constant(0)))
for _op in ("All", "Any"):
    case(_op, {"a": R.random((3, 4, 2)) > 0.3})(
        lambda a, _op=_op: getattr(tf.raw_ops, _op)(
            input=a, axis=tf.constant([0, 2])))
case("ArgMax", {"a": f32(3, 5)})(
    lambda a: tf.raw_ops.ArgMax(input=a, dimension=tf.constant(1)))
case("ArgMin", {"a": f32(3, 5)})(
    lambda a: tf.raw_ops.ArgMin(input=a, dimension=tf.constant(0)))
case("Select", {"c": R.random((3, 4)) > 0.5, "a": f32(3, 4), "b": f32(3, 4)})(
    lambda c, a, b: tf.raw_ops.Select(condition=c, x=a, y=b))
case("Select-vector-condition", {"c": R.random(3) > 0.5, "a": f32(3, 4),
                                 "b": f32(3, 4)}, ref="tf")(
    lambda c, a, b: tf.raw_ops.Select(condition=c, x=a, y=b))
case("SelectV2", {"c": R.random((1, 4)) > 0.5, "a": f32(3, 4),
                  "b": f32(3, 1)})(
    lambda c, a, b: tf.raw_ops.SelectV2(condition=c, t=a, e=b))
case("GatherV2", {"a": f32(3, 5, 2)})(
    lambda a: tf.raw_ops.GatherV2(params=a, indices=tf.constant([[0, 4],
                                                                 [2, 2]]),
                                  axis=tf.constant(1)))
case("Gather", {"a": f32(4, 3)})(
    lambda a: tf.raw_ops.Gather(params=a, indices=tf.constant([3, 0, 1])))
case("TopKV2", {"a": f32(3, 6)})(
    lambda a: tf.raw_ops.TopKV2(input=a, k=tf.constant(3)))
case("ResizeBilinear-up", {"a": f32(1, 4, 5, 2)})(
    lambda a: tf.raw_ops.ResizeBilinear(images=a, size=tf.constant([7, 9]),
                                        half_pixel_centers=True))
case("ResizeBilinear-down", {"a": f32(1, 8, 9, 2)}, ref="tf")(
    lambda a: tf.raw_ops.ResizeBilinear(images=a, size=tf.constant([3, 4]),
                                        half_pixel_centers=True))
case("ResizeNearestNeighbor", {"a": f32(1, 4, 5, 2)})(
    lambda a: tf.raw_ops.ResizeNearestNeighbor(
        images=a, size=tf.constant([8, 10]), half_pixel_centers=True))
case("L2Loss", {"a": f32(3, 4)})(lambda a: tf.raw_ops.L2Loss(t=a))
case("Cumsum", {"a": f32(3, 4)})(
    lambda a: tf.raw_ops.Cumsum(x=a, axis=tf.constant(1)))
case("Cumsum-exclusive-reverse", {"a": f32(3, 4)}, ref="tf")(
    lambda a: tf.raw_ops.Cumsum(x=a, axis=tf.constant(1), exclusive=True,
                                reverse=True))
case("DecodeRaw", {"a": f32(4)})(
    lambda a: a + tf.raw_ops.DecodeRaw(
        bytes=tf.constant(np.arange(4, dtype=np.float32).tobytes()),
        out_type=tf.float32))


def _build(name):
    build, feeds, ref = CASES[name]
    g = tf.Graph()
    with g.as_default():
        phs = [ph(k, v) for k, v in feeds.items()]
        out = build(*phs)
    fetches = [t.name for t in (out if isinstance(out, (list, tuple))
                                else [out])]
    return g, feeds, fetches, ref


def _tpudl(gdef, feeds, fetches):
    x64 = any(v.dtype == np.float64 for v in feeds.values())
    with jax.enable_x64(x64):
        out = jg.build_jax_fn(gdef, list(feeds), fetches)(*feeds.values())
        out = out if isinstance(out, tuple) else (out,)
        return [np.asarray(o) for o in out]


def _tf(g, feeds, fetches):
    with tf.compat.v1.Session(graph=g) as sess:
        return sess.run(fetches, {f"{k}:0": v for k, v in feeds.items()})


def _port(gdef, feeds, fetches):
    fn = tg.build_torch_fn(pw.parse("GraphDef", gdef.SerializeToString()),
                           list(feeds), fetches)
    out = fn(*[torch.from_numpy(np.array(v)) for v in feeds.values()])
    out = out if isinstance(out, tuple) else (out,)
    return [o.numpy() for o in out]


def _assert_close(got, want, name):
    want = np.asarray(want)
    assert got.shape == want.shape, name
    if want.dtype.kind in "biu" or got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    tol = 1e-12 if got.dtype == np.float64 else 1e-5
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(name):
    g, feeds, fetches, ref = _build(name)
    gdef = g.as_graph_def()
    got = _port(gdef, feeds, fetches)
    want = _tpudl(gdef, feeds, fetches) if ref == "tpudl" else _tf(
        g, feeds, fetches)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _assert_close(a, b, name)
    # each output has the dtype TF declares for it (float64 stays float64)
    assert [a.dtype for a in got] == [
        np.dtype(g.get_tensor_by_name(f).dtype.as_numpy_dtype)
        for f in fetches], name


def test_every_op_of_tpudl_has_a_handler_and_no_other():
    assert set(tg._OPS) == set(jg._OPS)
    assert set(tg._NP_FAST) == set(jg._NP_FAST)


@pytest.mark.parametrize("name", ["Mod-negative", "Select-vector-condition",
                                  "ResizeBilinear-down",
                                  "Cumsum-exclusive-reverse",
                                  "SplitV-minus-one"])
def test_where_tpudl_differs_from_tf_the_port_follows_tf(name):
    """The cases held to TF: the port agrees with TF (above), and tpudl
    does not (or raises), so these are reference caveats."""
    g, feeds, fetches, _ref = _build(name)
    want = _tf(g, feeds, fetches)
    try:
        got = _tpudl(g.as_graph_def(), feeds, fetches)
    except Exception:
        return
    assert any(np.asarray(a).shape != np.asarray(b).shape
               or not np.allclose(a, b, rtol=1e-5, atol=1e-5)
               for a, b in zip(got, want))


def _raw_graph(op, n_inputs=1):
    """A GraphDef whose node ``op`` reads placeholders ``a``...: ops TF
    will not build through its Python API on float tensors."""
    gdef = tf.compat.v1.GraphDef()
    for i in range(n_inputs):
        n = gdef.node.add(name="ab"[i], op="Placeholder")
        n.attr["dtype"].type = tf.float32.as_datatype_enum
    n = gdef.node.add(name="y", op=op)
    n.input.extend(["ab"[i] for i in range(n_inputs)])
    return gdef


@pytest.mark.parametrize("op", ["ReadVariableOp", "Assert", "NoOp"])
def test_pass_through_ops(op):
    gdef = _raw_graph(op)
    feeds = {"a": f32(2, 3)}
    got = _port(gdef, feeds, ["y"])
    want = _tpudl(gdef, feeds, ["y"])
    _assert_close(got[0], want[0], op)


def test_unsupported_op_names_the_op_and_node():
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, shape=[2, 2], name="x")
        tf.raw_ops.MatrixInverse(input=x, name="inv")
    gdef = pw.parse("GraphDef", g.as_graph_def().SerializeToString())
    fn = tg.build_torch_fn(gdef, ["x"], ["inv"])
    with pytest.raises(tg.UnsupportedOpError,
                       match="'MatrixInverse' \\(node 'inv'\\) has no torch"):
        fn(torch.eye(2))
    # lazy: a fetch before the unsupported op runs
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, shape=[3], name="x")
        mid = tf.nn.relu(x, name="mid")
        tf.raw_ops.MatrixInverse(input=tf.reshape(tf.tile(mid, [3]), (3, 3)),
                                 name="bad")
    fn = tg.build_torch_fn(pw.parse("GraphDef", g.as_graph_def(
    ).SerializeToString()), ["x"], ["mid"])
    np.testing.assert_array_equal(fn(torch.tensor([-1.0, 0.0, 2.0])).numpy(),
                                  [0.0, 0.0, 2.0])


def test_dynamic_shape_operand_is_refused_by_name():
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, [2, 3], name="x")
        s = tf.compat.v1.placeholder(tf.int32, [2], name="s")
        tf.reshape(x, s, name="y")
    fn = tg.build_torch_fn(pw.parse("GraphDef", g.as_graph_def(
    ).SerializeToString()), ["x", "s"], ["y"])
    with pytest.raises(tg.UnsupportedOpError, match="dynamic reshape target"):
        fn(torch.ones(2, 3), torch.tensor([3, 2], dtype=torch.int32))


def test_feeds_take_their_placeholders_dtype_and_constants_upload_once():
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float64, [None, 3], name="x")
        tf.add(x, tf.constant(np.ones(3)), name="y")
    fn = tg.build_torch_fn(pw.parse("GraphDef", g.as_graph_def(
    ).SerializeToString()), ["x"], ["y"])
    y = fn(torch.zeros(2, 3, dtype=torch.float32))
    assert y.dtype == torch.float64
    uploads = fn.__closure__  # the graph's caches live with the function
    shared = next(c.cell_contents for c in uploads
                  if isinstance(c.cell_contents, tg._Shared))
    n = len(shared.uploads)
    fn(torch.zeros(4, 3, dtype=torch.float64))
    assert len(shared.uploads) == n == 1
