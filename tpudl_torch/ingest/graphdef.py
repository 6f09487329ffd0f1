"""GraphDef → torch: TF graphs evaluated op by op on torch tensors.

Port of ``tpudl/ingest/graphdef.py``. tpudl translates a GraphDef into a
jax function that ``jit`` stages into one XLA program; the port evaluates
the same graph eagerly in torch on the feeds' device. The names are
tpudl's (``UnsupportedOpError``, ``tensor_name``, ``op_name``,
``node_op_map``, ``validated_input``, ``validated_output``) and
``build_torch_fn`` takes ``build_jax_fn``'s place. The op set is tpudl's
``_OPS`` exactly, with its numpy fast path for shape math (``_NP_FAST``):
an op whose inputs are all host values (constants, shapes) runs in numpy,
so a Flatten's ``Shape → StridedSlice → Pack → Reshape`` chain stays
static. ``PartitionedCall``/``StatefulPartitionedCall`` evaluate library
``FunctionDef`` bodies, ``IdentityN``, ``Placeholder`` and
``PlaceholderWithDefault`` as tpudl does.

What torch asks for that jax did not:

- **Function-body tensor names** are ``node:out_arg:idx``. They map to a
  node's flat output index through a table of the ops in the set with
  several output args (``FusedBatchNorm*``, ``TopKV2``); every other op
  has one output arg (a list for ``Unpack``, ``Split``, ``SplitV``,
  ``IdentityN`` and the call ops). tpudl's evaluator looks such names up
  as they are and cannot run a graph that keeps its functions (ROADMAP
  Queue 3, reference caveats).
- **Layout.** TF graphs are NHWC. Convolutions and pools get NCHW views
  (``permute``, channels_last memory, no copy) and hand back NHWC views;
  kernels go to OIHW (channels_last) once. SAME padding is TF's:
  asymmetric pads (the extra row at the end) are explicit ``F.pad`` calls,
  and a SAME ``AvgPool`` divides by the count of in-bounds cells.
  ``DepthwiseConv2dNative`` orders output channels c-major.
- **Constants live on the device once** per graph and device: a
  ``Const``'s numpy value is uploaded on first use there and reused by
  every later batch, with derived forms (OIHW kernels) cached beside it.
  A batch function captured as a CUDA graph (``fuseSteps``) then records
  no pageable host-to-device copy. Shape math stays on the host; no
  handler reads a CUDA tensor's value.
- **dtype.** Each feed is cast to its ``Placeholder``'s dtype, so a
  float64 graph runs in float64. The function runs under
  :func:`tpudl_torch.device.full_f32` (no TF32 products).

Where tpudl's jax semantics differ from TF's (``Mod``, ``ArgMin``'s
output type, ``Select`` with a vector condition, shrinking
``ResizeBilinear``, ``Cumsum``'s ``exclusive``/``reverse``, ``SplitV``
with -1, ``FusedBatchNorm``'s default epsilon), the port follows TF.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F

from tpudl_torch.device import full_f32
from tpudl_torch.ingest import protowire as pw

__all__ = ["UnsupportedOpError", "build_torch_fn", "tensor_name", "op_name",
           "node_op_map", "validated_input", "validated_output"]


class UnsupportedOpError(NotImplementedError):
    def __init__(self, op: str, node: str):
        super().__init__(
            f"GraphDef op {op!r} (node {node!r}) has no torch translation; "
            "supported ops are the TF2/Keras inference set — see "
            "tpudl_torch/ingest/graphdef.py:_OPS"
        )
        self.op = op


# copied from tpudl/ingest/graphdef.py:tensor_name
def tensor_name(name: str) -> str:
    """Canonicalize ``"x"`` → ``"x:0"`` (graph-output tensor form)."""
    name = name.lstrip("^")
    return name if ":" in name else name + ":0"


# copied from tpudl/ingest/graphdef.py:op_name
def op_name(name: str) -> str:
    """Canonicalize ``"x:0"`` → ``"x"`` (op/node form)."""
    name = name.lstrip("^")
    return name.split(":")[0]


# copied from tpudl/ingest/graphdef.py:node_op_map
def node_op_map(graph_def) -> dict:
    """{node name → op type}, built once per graph."""
    return {n.name: n.op for n in graph_def.node}


# copied from tpudl/ingest/graphdef.py:validated_input
def validated_input(graph_def, name: str, nodes: dict | None = None) -> str:
    """Canonical tensor name for a FEED, verified to be a genuine graph
    input (a Placeholder node): feeding an interior tensor is refused."""
    nodes = nodes if nodes is not None else node_op_map(graph_def)
    op = op_name(name)
    if op not in nodes:
        raise ValueError(
            f"input {name!r} not found in graph ({len(nodes)} nodes)")
    if nodes[op] not in ("Placeholder", "PlaceholderWithDefault"):
        raise ValueError(
            f"input {name!r} is a {nodes[op]!r} node, not a graph "
            "input (Placeholder); feeds must be genuine inputs")
    return tensor_name(name)


# copied from tpudl/ingest/graphdef.py:validated_output
def validated_output(graph_def, name: str, nodes: dict | None = None) -> str:
    """Canonical tensor name for a FETCH, verified to exist in the graph."""
    nodes = nodes if nodes is not None else node_op_map(graph_def)
    if op_name(name) not in nodes:
        raise ValueError(
            f"output {name!r} not found in graph ({len(nodes)} nodes)")
    return tensor_name(name)


# -- dtypes -------------------------------------------------------------------
_TORCH = {1: torch.float32, 2: torch.float64, 3: torch.int32, 4: torch.uint8,
          5: torch.int16, 6: torch.int8, 8: torch.complex64, 9: torch.int64,
          10: torch.bool, 14: torch.bfloat16, 17: torch.uint16,
          18: torch.complex128, 19: torch.float16, 22: torch.uint32,
          23: torch.uint64}


def torch_dtype(tf_enum: int) -> torch.dtype:
    base = tf_enum - 100 if tf_enum > 100 else tf_enum
    if base not in _TORCH:
        raise NotImplementedError(f"TF DataType {tf_enum} has no torch dtype")
    return _TORCH[base]


def _np_dtype(tf_enum: int):
    return pw.np_dtype(tf_enum)


def _is_host(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, int, float, bool, bytes))


def _static(x, node, what):
    """A shape-like operand's host value; a tensor (on any device, so the
    CPU runs as the card does) is refused."""
    if isinstance(x, torch.Tensor):
        raise UnsupportedOpError(
            f"dynamic {what}", f"{node.name} (shape-like operands must be "
            "host values: constants or shape math)")
    return np.asarray(x)


# -- the run context ------------------------------------------------------------
class _Shared:
    """What one graph keeps across calls: each Const's numpy value, its
    upload per device, derived forms (OIHW kernels) per device, and the
    function bodies translated to graph names. Guarded by one lock."""

    def __init__(self, library):
        self.library = library
        self.lock = threading.Lock()
        self.node_values: dict = {}     # id(Const node) -> ndarray
        self.arrays: dict = {}          # id(ndarray) -> ndarray (a Const's)
        self.uploads: dict = {}         # (device, id(ndarray)) -> tensor
        self.upload_src: dict = {}      # id(tensor) -> id(ndarray)
        self.derived: dict = {}         # (device, id(ndarray), tag)
        self.folded: dict = {}          # (id(node), device, input ids)
        self.folded_ids: dict = {}      # id(value) -> value (a fold's)
        self.functions: dict = {}

    def const(self, node):
        v = self.node_values.get(id(node))
        if v is None:
            v = pw.make_ndarray(node.attr["value"].tensor)
            with self.lock:
                v = self.node_values.setdefault(id(node), v)
                self.arrays[id(v)] = v
        return v


def _torch_dtype_of(dt) -> torch.dtype:
    return torch.from_numpy(np.zeros(1, dt)).dtype


class _Run:
    """One call's device and the graph's caches."""

    def __init__(self, shared: _Shared, device: torch.device):
        self.shared = shared
        self.device = device

    def _const_id(self, x):
        """id of the Const value behind ``x`` (an array or its upload)."""
        if isinstance(x, torch.Tensor) and id(x) in self.shared.upload_src:
            return self.shared.upload_src[id(x)]
        if self.shared.arrays.get(id(x)) is x or \
                self.shared.folded_ids.get(id(x)) is x:
            return id(x)       # a Const's or a fold's value
        return None

    def t(self, x) -> torch.Tensor:
        """``x`` as a tensor on the run's device. A Const's value is
        uploaded once per device; another host scalar becomes a device
        fill (no host-to-device copy)."""
        if isinstance(x, torch.Tensor) and x.device == self.device:
            return x
        cid = self._const_id(x)
        if cid is not None:
            key = (self.device, cid)
            t = self.shared.uploads.get(key)
            if t is None:
                t = _to_torch(x).to(self.device)
                with self.shared.lock:
                    t = self.shared.uploads.setdefault(key, t)
                    self.shared.upload_src[id(t)] = cid
            return t
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        a = np.asarray(x)
        if a.ndim == 0 and a.dtype != object:
            return torch.full((), a.item(), dtype=_torch_dtype_of(a.dtype),
                              device=self.device)
        return _to_torch(a).to(self.device)

    def derive(self, x, tag, fn):
        """``fn(self.t(x))``, made once per device when ``x`` is a Const's
        value or its upload (a kernel's OIHW form)."""
        cid = self._const_id(x)
        if cid is None:
            return fn(self.t(x))
        key = (self.device, cid, tag)
        y = self.shared.derived.get(key)
        if y is None:
            y = fn(self.t(x))
            with self.shared.lock:
                y = self.shared.derived.setdefault(key, y)
        return y


def _to_torch(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    if a.dtype == object:
        raise UnsupportedOpError("string tensor on the device", "(value)")
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.ascontiguousarray(a).copy()
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# op handlers: (node, inputs, ctx: _Run) -> value or tuple of values
# ---------------------------------------------------------------------------
_OPS = {}


def op(*names):
    def deco(fn):
        for n in names:
            _OPS[n] = fn
        return fn
    return deco


def _unary(fn):
    return lambda node, xs, ctx: fn(ctx.t(xs[0]))


def _binary(fn):
    return lambda node, xs, ctx: fn(ctx.t(xs[0]), ctx.t(xs[1]))


def _passthrough(node, xs, ctx):
    return xs[0]


def _div(x, y):
    if x.is_floating_point() or x.is_complex():
        return torch.true_divide(x, y)
    return torch.div(x, y, rounding_mode="trunc")


def _div_no_nan(x, y):
    zero = y == 0
    return torch.where(zero, torch.zeros_like(x), x / torch.where(
        zero, torch.ones_like(y), y))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


for _name, _fn in {
    "Relu": torch.relu, "Relu6": lambda x: torch.clamp(x, 0, 6),
    "Elu": F.elu, "Selu": torch.selu, "Softplus": _softplus,
    "Softsign": F.softsign, "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh, "Exp": torch.exp, "Log": torch.log,
    "Log1p": torch.log1p, "Sqrt": torch.sqrt, "Rsqrt": torch.rsqrt,
    "Square": torch.square, "Neg": torch.neg, "Abs": torch.abs,
    "Sign": torch.sign, "Floor": torch.floor, "Ceil": torch.ceil,
    "Round": torch.round, "Erf": torch.erf, "Sin": torch.sin,
    "Cos": torch.cos, "Reciprocal": torch.reciprocal,
    "LogicalNot": torch.logical_not, "ZerosLike": torch.zeros_like,
    "OnesLike": torch.ones_like, "StopGradient": torch.Tensor.detach,
}.items():
    _OPS[_name] = _unary(_fn)

_OPS["Identity"] = _passthrough
_OPS["Snapshot"] = _passthrough

for _name, _fn in {
    "Add": torch.add, "AddV2": torch.add, "Sub": torch.sub,
    "Mul": torch.mul, "RealDiv": _div, "Div": _div,
    "DivNoNan": _div_no_nan,
    "FloorDiv": lambda x, y: torch.div(x, y,
                                       rounding_mode="floor"),
    "FloorMod": lambda x, y: torch.remainder(x, y),
    "Mod": lambda x, y: torch.fmod(x, y),
    "Pow": lambda x, y: torch.pow(x, y),
    "Maximum": lambda x, y: torch.maximum(x, y),
    "Minimum": lambda x, y: torch.minimum(x, y),
    "SquaredDifference": lambda x, y: torch.square(x - y),
    "Greater": torch.gt, "GreaterEqual": torch.ge,
    "Less": torch.lt, "LessEqual": torch.le,
    "Equal": torch.eq, "NotEqual": torch.ne,
    "LogicalAnd": lambda x, y: torch.logical_and(x, y),
    "LogicalOr": lambda x, y: torch.logical_or(x, y),
    "BitwiseAnd": lambda x, y: torch.bitwise_and(x, y),
    "BitwiseOr": lambda x, y: torch.bitwise_or(x, y),
    "LeftShift": lambda x, y: torch.bitwise_left_shift(x, y),
    "RightShift": torch.bitwise_right_shift,
}.items():
    _OPS[_name] = _binary(_fn)


@op("Const")
def _const(node, xs, ctx):
    return ctx.shared.const(node)


@op("NoOp", "Assert", "PreventGradient", "CheckNumerics")
def _noop(node, xs, ctx):
    return xs[0] if xs else None


@op("ReadVariableOp")
def _read_var(node, xs, ctx):
    return xs[0]  # the resource input is already the variable's value


@op("Cast")
def _cast(node, xs, ctx):
    return ctx.t(xs[0]).to(torch_dtype(node.attr["DstT"].type))


@op("AddN")
def _addn(node, xs, ctx):
    out = ctx.t(xs[0])
    for x in xs[1:]:
        out = out + ctx.t(x)
    return out


@op("MatMul")
def _matmul(node, xs, ctx):
    a, b = ctx.t(xs[0]), ctx.t(xs[1])
    if node.attr["transpose_a"].b:
        a = a.T
    if node.attr["transpose_b"].b:
        b = b.T
    return a @ b


@op("BatchMatMul", "BatchMatMulV2", "BatchMatMulV3")
def _batch_matmul(node, xs, ctx):
    a, b = ctx.t(xs[0]), ctx.t(xs[1])
    if node.attr["adj_x"].b:
        a = a.transpose(-1, -2)
    if node.attr["adj_y"].b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


@op("Einsum")
def _einsum(node, xs, ctx):
    return torch.einsum(node.attr["equation"].s.decode(),
                        *[ctx.t(x) for x in xs])


def _nchw_fmt(node) -> bool:
    return (node.attr["data_format"].s or b"NHWC") == b"NCHW"


@op("BiasAdd")
def _bias_add(node, xs, ctx):
    x, b = ctx.t(xs[0]), ctx.t(xs[1])
    if _nchw_fmt(node):
        return x + b.reshape((1, -1) + (1,) * (x.ndim - 2))
    return x + b


def _to_nchw(node, x):
    """An NHWC tensor as an NCHW view (channels_last memory)."""
    return x if _nchw_fmt(node) else x.permute(0, 3, 1, 2)


def _from_nchw(node, y):
    return y if _nchw_fmt(node) else y.permute(0, 2, 3, 1)


def _spatial(node, values):
    """The (h, w) entries of a 4-long data-format list."""
    return (values[2], values[3]) if _nchw_fmt(node) else (values[1],
                                                           values[2])


def _same_pads(size, window, strides, dilation=(1, 1)):
    pads = []
    for n, k, s, d in zip(size, window, strides, dilation):
        eff = (k - 1) * d + 1
        total = max((-(-n // s) - 1) * s + eff - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pads(node, x_nchw, window, strides, dilation=(1, 1)):
    """((top, bottom), (left, right)) of a conv or pool."""
    pad = node.attr["padding"].s.decode()
    if pad == "VALID":
        return [(0, 0), (0, 0)]
    if pad == "SAME":
        return _same_pads(x_nchw.shape[2:], window, strides, dilation)
    if pad == "EXPLICIT":
        ep = list(node.attr["explicit_paddings"].list.i)
        if _nchw_fmt(node):
            return [(ep[4], ep[5]), (ep[6], ep[7])]
        return [(ep[2], ep[3]), (ep[4], ep[5])]
    raise UnsupportedOpError(f"padding {pad!r}", node.name)


def _apply_pads(x, pads, value=0.0):
    """(x with the asymmetric part padded in, symmetric pad for the op)."""
    (t, b), (l, r) = pads
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def _oihw(k):
    return k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


@op("Conv2D")
def _conv2d(node, xs, ctx):
    x = _to_nchw(node, ctx.t(xs[0]))
    k = ctx.derive(xs[1], "oihw", _oihw)
    s = _spatial(node, list(node.attr["strides"].list.i))
    d = _spatial(node, list(node.attr["dilations"].list.i) or [1, 1, 1, 1])
    x, pad = _apply_pads(x, _pads(node, x, k.shape[2:], s, d))
    y = F.conv2d(x, k.to(x.dtype), stride=s, padding=pad, dilation=d)
    return _from_nchw(node, y)


def _depthwise_kernel(k):
    kh, kw, cin, mult = k.shape
    # TF's output channel c * mult + m (c-major) is a plain reshape
    return k.reshape(kh, kw, cin * mult).permute(2, 0, 1).unsqueeze(
        1).contiguous(memory_format=torch.channels_last)


@op("DepthwiseConv2dNative")
def _depthwise(node, xs, ctx):
    x = _to_nchw(node, ctx.t(xs[0]))
    k = ctx.derive(xs[1], "depthwise", _depthwise_kernel)
    s = _spatial(node, list(node.attr["strides"].list.i))
    d = _spatial(node, list(node.attr["dilations"].list.i) or [1, 1, 1, 1])
    x, pad = _apply_pads(x, _pads(node, x, k.shape[2:], s, d))
    y = F.conv2d(x, k.to(x.dtype), stride=s, padding=pad, dilation=d,
                 groups=x.shape[1])
    return _from_nchw(node, y)


@op("Conv2DBackpropInput")
def _conv2d_transpose(node, xs, ctx):
    out_shape = [int(v) for v in _static(xs[0], node, "output shape")]
    k = ctx.t(xs[1])                        # (kh, kw, out_c, in_c)
    x = ctx.t(xs[2]).permute(0, 3, 1, 2)
    s = _spatial(node, list(node.attr["strides"].list.i))
    oh, ow = out_shape[1], out_shape[2]
    kh, kw = k.shape[0], k.shape[1]
    pad = node.attr["padding"].s.decode()
    if pad == "SAME":
        (t, _b), (l, _r) = _same_pads((oh, ow), (kh, kw), s)
    elif pad == "VALID":
        t = l = 0
    else:
        raise UnsupportedOpError(f"Conv2DBackpropInput padding {pad!r}",
                                 node.name)
    y = F.conv_transpose2d(x, k.permute(3, 2, 0, 1).to(x.dtype), stride=s)
    if y.shape[2] < t + oh or y.shape[3] < l + ow:
        y = F.pad(y, (0, max(0, l + ow - y.shape[3]), 0,
                      max(0, t + oh - y.shape[2])))
    y = y[:, :, t:t + oh, l:l + ow].permute(0, 2, 3, 1)
    if list(y.shape) != out_shape:
        raise UnsupportedOpError("Conv2DBackpropInput shape mismatch",
                                 node.name)
    return y


def _pool_geometry(node, x):
    ks = list(node.attr["ksize"].list.i)
    st = list(node.attr["strides"].list.i)
    if ks[0] != 1 or st[0] != 1 or ks[1 if _nchw_fmt(node) else 3] != 1:
        raise UnsupportedOpError("pooling over the batch or channels",
                                 node.name)
    return _spatial(node, ks), _spatial(node, st)


@op("MaxPool")
def _max_pool(node, xs, ctx):
    x = _to_nchw(node, ctx.t(xs[0]))
    k, s = _pool_geometry(node, x)
    (t, b), (l, r) = _pads(node, x, k, s)
    if t or b or l or r:
        x = F.pad(x, (l, r, t, b), value=float("-inf"))
    return _from_nchw(node, F.max_pool2d(x, k, s))


@op("AvgPool")
def _avg_pool(node, xs, ctx):
    # TF AvgPool divides by the count of *in-bounds* elements under SAME
    x = _to_nchw(node, ctx.t(xs[0]))
    k, s = _pool_geometry(node, x)
    (t, b), (l, r) = _pads(node, x, k, s)
    if (t, b, l, r) == (0, 0, 0, 0):
        return _from_nchw(node, F.avg_pool2d(x, k, s))
    if t == b and l == r and t <= k[0] // 2 and l <= k[1] // 2:
        return _from_nchw(node, F.avg_pool2d(
            x, k, s, padding=(t, l), count_include_pad=False))
    sums = F.avg_pool2d(F.pad(x, (l, r, t, b)), k, s, divisor_override=1)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    counts = F.avg_pool2d(F.pad(ones, (l, r, t, b)), k, s,
                          divisor_override=1)
    return _from_nchw(node, sums / counts)


@op("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
def _fused_bn(node, xs, ctx):
    x, scale, offset, mean, var = [ctx.t(v) for v in xs[:5]]
    if node.attr["is_training"].b:
        raise UnsupportedOpError("FusedBatchNorm(is_training=True)", node.name)
    eps = node.attr["epsilon"].f if "epsilon" in node.attr else 1e-4
    shape = (1, -1, 1, 1) if _nchw_fmt(node) else (-1,)
    y = ((x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
         * scale.reshape(shape) + offset.reshape(shape))
    return (y, mean, var, mean, var, var)  # aux outputs per TF signature


@op("Softmax")
def _softmax(node, xs, ctx):
    return torch.softmax(ctx.t(xs[0]), dim=-1)


@op("LogSoftmax")
def _log_softmax(node, xs, ctx):
    return torch.log_softmax(ctx.t(xs[0]), dim=-1)


@op("LeakyRelu")
def _leaky_relu(node, xs, ctx):
    alpha = node.attr["alpha"].f if "alpha" in node.attr else 0.2
    return F.leaky_relu(ctx.t(xs[0]), alpha)


@op("Reshape")
def _reshape(node, xs, ctx):
    shape = _static(xs[1], node, "reshape target").astype(np.int64)
    return ctx.t(xs[0]).reshape(tuple(int(d) for d in shape))


@op("Squeeze")
def _squeeze(node, xs, ctx):
    dims = list(node.attr["squeeze_dims"].list.i)
    x = ctx.t(xs[0])
    return x.squeeze(tuple(dims)) if dims else x.squeeze()


@op("ExpandDims")
def _expand_dims(node, xs, ctx):
    axis = int(_static(xs[1], node, "axis"))
    return ctx.t(xs[0]).unsqueeze(axis)


@op("Transpose")
def _transpose(node, xs, ctx):
    perm = _static(xs[1], node, "perm")
    return ctx.t(xs[0]).permute(tuple(int(p) for p in perm))


def _cat(ctx, xs, axis):
    ts = [ctx.t(x) for x in xs]
    return torch.cat(ts, dim=axis)


@op("ConcatV2")
def _concat(node, xs, ctx):
    return _cat(ctx, xs[:-1], int(_static(xs[-1], node, "axis")))


@op("Concat")
def _concat_v1(node, xs, ctx):
    return _cat(ctx, xs[1:], int(_static(xs[0], node, "axis")))


@op("Pack")
def _pack(node, xs, ctx):
    return torch.stack([ctx.t(x) for x in xs], dim=node.attr["axis"].i)


@op("Unpack")
def _unpack(node, xs, ctx):
    return tuple(torch.unbind(ctx.t(xs[0]), dim=node.attr["axis"].i))


@op("Split")
def _split(node, xs, ctx):
    axis = int(_static(xs[0], node, "axis"))
    x = ctx.t(xs[1])
    n = node.attr["num_split"].i
    return tuple(torch.split(x, x.shape[axis] // n, dim=axis))


@op("SplitV")
def _splitv(node, xs, ctx):
    x = ctx.t(xs[0])
    sizes = [int(v) for v in _static(xs[1], node, "split sizes")]
    axis = int(_static(xs[2], node, "axis"))
    if -1 in sizes:
        sizes[sizes.index(-1)] = x.shape[axis] - (sum(sizes) + 1)
    return tuple(torch.split(x, sizes, dim=axis))


@op("Slice")
def _slice(node, xs, ctx):
    begin = _static(xs[1], node, "begin")
    size = _static(xs[2], node, "size")
    x = xs[0] if _is_host(xs[0]) else ctx.t(xs[0])
    idx = tuple(slice(int(b), None if s == -1 else int(b) + int(s))
                for b, s in zip(begin, size))
    return x[idx]


@op("StridedSlice")
def _strided_slice(node, xs, ctx):
    begin = _static(xs[1], node, "begin")
    end = _static(xs[2], node, "end")
    strides = _static(xs[3], node, "strides")
    bm = node.attr["begin_mask"].i
    em = node.attr["end_mask"].i
    ell = node.attr["ellipsis_mask"].i
    na = node.attr["new_axis_mask"].i
    sa = node.attr["shrink_axis_mask"].i
    idx = []
    for i in range(len(begin)):
        if ell & (1 << i):
            idx.append(Ellipsis)
        elif na & (1 << i):
            idx.append(None)
        elif sa & (1 << i):
            idx.append(int(begin[i]))
        else:
            b = None if bm & (1 << i) else int(begin[i])
            e = None if em & (1 << i) else int(end[i])
            idx.append(slice(b, e, int(strides[i])))
    if _is_host(xs[0]):
        return np.asarray(xs[0])[tuple(idx)]
    return _index(ctx.t(xs[0]), idx)


def _index(x: torch.Tensor, idx: list):
    """``x[idx]`` for basic indices, negative steps included (torch
    slices take none: they become a flip of the kept range)."""
    consumed = sum(1 for i in idx if i is not None and i is not Ellipsis)
    basic, flips = [], []
    d_in = d_out = 0
    for i in idx:
        if i is None:
            basic.append(None)
            d_out += 1
        elif i is Ellipsis:
            n = x.ndim - consumed
            basic.append(Ellipsis)
            d_in += n
            d_out += n
        elif isinstance(i, int):
            basic.append(i)
            d_in += 1
        else:
            if i.step is not None and i.step < 0:
                start, stop, step = i.indices(x.shape[d_in])
                keep = range(start, stop, step)
                if len(keep):
                    basic.append(slice(keep[-1], keep[0] + 1, -step))
                else:
                    basic.append(slice(0, 0))
                flips.append(d_out)
            else:
                basic.append(i)
            d_in += 1
            d_out += 1
    y = x[tuple(basic)]
    return y.flip(flips) if flips else y


@op("Shape")
def _shape(node, xs, ctx):
    dt = _np_dtype(node.attr["out_type"].type) if node.attr[
        "out_type"].type else np.int32
    return np.asarray(tuple(xs[0].shape), dtype=dt)


@op("Size")
def _size(node, xs, ctx):
    return np.asarray(int(np.prod(tuple(xs[0].shape))), dtype=np.int32)


@op("Rank")
def _rank(node, xs, ctx):
    return np.asarray(len(xs[0].shape), dtype=np.int32)


@op("Fill")
def _fill(node, xs, ctx):
    dims = tuple(int(d) for d in _static(xs[0], node, "fill dims"))
    v = xs[1]
    if isinstance(v, torch.Tensor):
        return v.to(ctx.device).expand(dims).clone()
    v = np.asarray(v)
    return torch.full(dims, v.item(), dtype=_to_torch(v.reshape(1)).dtype,
                      device=ctx.device)


@op("Range")
def _range(node, xs, ctx):
    s, l, d = (_static(v, node, "range operand") for v in xs)
    return ctx.t(np.arange(s.item(), l.item(), d.item()))


@op("Tile")
def _tile(node, xs, ctx):
    reps = _static(xs[1], node, "multiples")
    return ctx.t(xs[0]).repeat(tuple(int(r) for r in reps))


def _mirror(x, dim, before, after, symmetric):
    n = x.shape[dim]
    lo = 0 if symmetric else 1
    hi = n - after if symmetric else n - 1 - after
    parts = []
    if before:
        parts.append(x.narrow(dim, lo, before).flip(dim))
    parts.append(x)
    if after:
        parts.append(x.narrow(dim, hi, after).flip(dim))
    return torch.cat(parts, dim=dim) if len(parts) > 1 else x


@op("Pad", "PadV2", "MirrorPad")
def _pad(node, xs, ctx):
    pads = _static(xs[1], node, "paddings")
    cfg = [(int(a), int(b)) for a, b in pads]
    x = ctx.t(xs[0])
    if node.op == "MirrorPad":
        mode = node.attr["mode"].s.decode().lower()
        if mode not in ("symmetric", "reflect"):
            raise UnsupportedOpError(f"MirrorPad mode {mode!r}", node.name)
        for dim, (a, b) in enumerate(cfg):
            x = _mirror(x, dim, a, b, mode == "symmetric")
        return x
    flat = [p for a, b in reversed(cfg) for p in (a, b)]
    cval = xs[2] if len(xs) > 2 else 0
    if isinstance(cval, torch.Tensor):
        return F.pad(x - cval, flat) + cval
    return F.pad(x, flat, value=np.asarray(cval).item())


def _reduction(fn):
    def handler(node, xs, ctx):
        axes = _static(xs[1], node, "reduction axes")
        keep = node.attr["keep_dims"].b
        ax = tuple(int(a) for a in np.atleast_1d(axes))
        x = ctx.t(xs[0])
        if not ax:
            return x
        return fn(x, ax, keep)
    return handler


def _each_axis(fn):
    """A reduction torch takes one axis at a time, over several."""
    def run(x, ax, keep):
        for a in sorted((a % x.ndim for a in ax), reverse=True):
            x = fn(x, a, keepdim=keep)
        return x
    return run


_OPS["Mean"] = _reduction(lambda x, ax, k: torch.mean(x, dim=ax, keepdim=k))
_OPS["Sum"] = _reduction(lambda x, ax, k: torch.sum(x, dim=ax, keepdim=k))
_OPS["Max"] = _reduction(lambda x, ax, k: torch.amax(x, dim=ax, keepdim=k))
_OPS["Min"] = _reduction(lambda x, ax, k: torch.amin(x, dim=ax, keepdim=k))
_OPS["Prod"] = _reduction(_each_axis(torch.prod))
_OPS["All"] = _reduction(_each_axis(torch.all))
_OPS["Any"] = _reduction(_each_axis(torch.any))


@op("ArgMax")
def _argmax(node, xs, ctx):
    axis = int(_static(xs[1], node, "axis"))
    dt = node.attr["output_type"].type or pw.DT["DT_INT64"]
    return torch.argmax(ctx.t(xs[0]), dim=axis).to(torch_dtype(dt))


@op("ArgMin")
def _argmin(node, xs, ctx):
    axis = int(_static(xs[1], node, "axis"))
    dt = node.attr["output_type"].type or pw.DT["DT_INT64"]
    return torch.argmin(ctx.t(xs[0]), dim=axis).to(torch_dtype(dt))


@op("Select", "SelectV2")
def _select(node, xs, ctx):
    c, a, b = ctx.t(xs[0]), ctx.t(xs[1]), ctx.t(xs[2])
    if node.op == "Select" and c.ndim == 1 and a.ndim > 1:
        c = c.reshape((-1,) + (1,) * (a.ndim - 1))   # TF: selects rows
    return torch.where(c, a, b)


@op("GatherV2")
def _gather(node, xs, ctx):
    axis = int(_static(xs[2], node, "axis"))
    return _take(ctx.t(xs[0]), ctx.t(xs[1]).long(), axis)


@op("Gather")
def _gather_v1(node, xs, ctx):
    return _take(ctx.t(xs[0]), ctx.t(xs[1]).long(), 0)


def _take(x, idx, axis):
    axis %= x.ndim
    y = x.movedim(axis, 0)[idx]
    return y.movedim(tuple(range(idx.ndim)),
                     tuple(range(axis, axis + idx.ndim)))


@op("TopKV2")
def _topk(node, xs, ctx):
    k = int(_static(xs[1], node, "k"))
    vals, idxs = torch.topk(ctx.t(xs[0]), k, dim=-1, largest=True,
                            sorted=True)
    return vals, idxs.to(torch.int32)


def _resize_size(node, xs, ctx):
    size = _static(xs[1], node, "size")
    if node.attr["align_corners"].b:
        raise UnsupportedOpError(f"{node.op}(align_corners=True)", node.name)
    return ctx.t(xs[0]), (int(size[0]), int(size[1]))


@op("ResizeBilinear")
def _resize_bilinear(node, xs, ctx):
    x, size = _resize_size(node, xs, ctx)
    if not node.attr["half_pixel_centers"].b:
        raise UnsupportedOpError("ResizeBilinear(align_corners legacy)",
                                 node.name)
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=size,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).to(x.dtype if x.is_floating_point()
                                    else torch.float32)


@op("ResizeNearestNeighbor")
def _resize_nearest(node, xs, ctx):
    x, size = _resize_size(node, xs, ctx)
    mode = "nearest-exact" if node.attr["half_pixel_centers"].b else "nearest"
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode=mode)
    return y.permute(0, 2, 3, 1)


@op("L2Loss")
def _l2loss(node, xs, ctx):
    return torch.sum(torch.square(ctx.t(xs[0]))) / 2


@op("Cumsum")
def _cumsum(node, xs, ctx):
    axis = int(_static(xs[1], node, "axis"))
    x = ctx.t(xs[0])
    if node.attr["reverse"].b:
        x = x.flip(axis)
    y = torch.cumsum(x, dim=axis)
    if node.attr["exclusive"].b:
        y = y - x
    return y.flip(axis) if node.attr["reverse"].b else y


@op("DecodeRaw")
def _decode_raw(node, xs, ctx):
    # image-struct bytes -> tensor; host-side only: the bytes are a value
    raw = _static(xs[0], node, "raw bytes")
    dt = _np_dtype(node.attr["out_type"].type)
    payload = raw.item() if raw.dtype == object or raw.shape == () else \
        raw.tobytes()
    if not isinstance(payload, bytes):
        payload = bytes(payload)
    return np.frombuffer(payload, dtype=dt)


# ---------------------------------------------------------------------------
# numpy fast paths for shape math: every input a host value -> numpy
# ---------------------------------------------------------------------------
# copied from tpudl/ingest/graphdef.py:_np_cast
def _np_cast(node, xs):
    return np.asarray(xs[0]).astype(_np_dtype(node.attr["DstT"].type))


# copied from tpudl/ingest/graphdef.py:_NP_FAST
_NP_FAST = {
    "Pack": lambda node, xs: np.stack(xs, axis=node.attr["axis"].i),
    "Unpack": lambda node, xs: tuple(
        np.squeeze(p, axis=node.attr["axis"].i)
        for p in np.split(xs[0], node.attr["num"].i, axis=node.attr["axis"].i)),
    "ConcatV2": lambda node, xs: np.concatenate(xs[:-1], axis=int(xs[-1])),
    "Cast": _np_cast,
    "Add": lambda node, xs: np.add(*xs), "AddV2": lambda node, xs: np.add(*xs),
    "Sub": lambda node, xs: np.subtract(*xs),
    "Mul": lambda node, xs: np.multiply(*xs),
    "RealDiv": lambda node, xs: np.divide(*xs),
    "FloorDiv": lambda node, xs: np.floor_divide(*xs),
    "FloorMod": lambda node, xs: np.mod(*xs),
    "Maximum": lambda node, xs: np.maximum(*xs),
    "Minimum": lambda node, xs: np.minimum(*xs),
    "Neg": lambda node, xs: np.negative(xs[0]),
    "Equal": lambda node, xs: np.equal(*xs),
    "Greater": lambda node, xs: np.greater(*xs),
    "Less": lambda node, xs: np.less(*xs),
    "Squeeze": lambda node, xs: np.squeeze(
        xs[0], axis=tuple(node.attr["squeeze_dims"].list.i) or None),
    "ExpandDims": lambda node, xs: np.expand_dims(xs[0], int(xs[1])),
    "Reshape": lambda node, xs: np.reshape(
        xs[0], tuple(int(d) for d in np.asarray(xs[1]))),
    "Transpose": lambda node, xs: np.transpose(
        xs[0], tuple(int(p) for p in xs[1])),
    "GatherV2": lambda node, xs: np.take(xs[0], xs[1], axis=int(xs[2])),
    "Range": lambda node, xs: np.arange(xs[0].item(), xs[1].item(), xs[2].item()),
    "Fill": lambda node, xs: np.full(tuple(int(d) for d in xs[0]), xs[1]),
    "Prod": lambda node, xs: np.prod(
        xs[0], axis=tuple(int(a) for a in np.atleast_1d(xs[1])),
        keepdims=node.attr["keep_dims"].b),
    "Sum": lambda node, xs: np.sum(
        xs[0], axis=tuple(int(a) for a in np.atleast_1d(xs[1])),
        keepdims=node.attr["keep_dims"].b),
    "Tile": lambda node, xs: np.tile(xs[0], tuple(int(r) for r in xs[1])),
    "Select": lambda node, xs: np.where(*xs),
    "SelectV2": lambda node, xs: np.where(*xs),
}


def _all_static(xs):
    return all(_is_host(x) for x in xs)


# -- function-body tensor names ------------------------------------------------
# ops of the set with several output args: arg name -> first flat index
_OUTPUT_ARGS = {
    "FusedBatchNorm": ("y", "batch_mean", "batch_variance",
                       "reserve_space_1", "reserve_space_2"),
    "FusedBatchNormV2": ("y", "batch_mean", "batch_variance",
                         "reserve_space_1", "reserve_space_2"),
    "FusedBatchNormV3": ("y", "batch_mean", "batch_variance",
                         "reserve_space_1", "reserve_space_2",
                         "reserve_space_3"),
    "TopKV2": ("values", "indices"),
}


def graph_input_name(name: str, body_ops: dict) -> str:
    """A FunctionDef input (``node:out_arg:idx``, an arg name, or a
    control input) in graph form (``node:flat index``)."""
    if name.startswith("^"):
        return "^" + op_name(name)
    parts = name.split(":")
    if len(parts) != 3:
        return name
    node, arg, idx = parts
    args = _OUTPUT_ARGS.get(body_ops.get(node), ())
    return f"{node}:{(args.index(arg) if arg in args else 0) + int(idx)}"


def function_graph(fdef):
    """A FunctionDef's body as graph nodes: inputs renamed to graph form,
    and its outputs' graph names (one per output arg)."""
    body_ops = {n.name: n.op for n in fdef.node_def}
    nodes = []
    for n in fdef.node_def:
        m = pw.new("NodeDef", name=n.name, op=n.op,
                   input=[graph_input_name(i, body_ops) for i in n.input],
                   attr=n.attr)
        nodes.append(m)
    rets = [graph_input_name(fdef.ret[a.name], body_ops)
            for a in fdef.signature.output_arg]
    return nodes, [tensor_name(r) for r in rets]


# ---------------------------------------------------------------------------
# graph evaluation
# ---------------------------------------------------------------------------
_CALL_OPS = ("PartitionedCall", "StatefulPartitionedCall")


class _GraphEval:
    """One GraphDef (plus its function library) evaluated lazily into an
    env of tensor values. Iterative DFS — no recursion limit on the
    thousands of nodes of an InceptionV3 body."""

    def __init__(self, nodes, shared: _Shared):
        self.nodes = {n.name: n for n in nodes}
        self.shared = shared

    def run(self, env: dict, fetches: list[str], ctx: _Run):
        for f in fetches:
            self._eval(env, f, ctx)
        return [env[tensor_name(f)] for f in fetches]

    def _eval(self, env, fetch, ctx):
        stack = [op_name(fetch)]
        applied = set()
        while stack:
            name = stack[-1]
            if name in applied or tensor_name(name) in env:
                stack.pop()
                continue
            node = self.nodes.get(name)
            if node is None:
                raise KeyError(f"GraphDef has no node {name!r}")
            deps = [i for i in node.input if not i.startswith("^")]
            missing = [d for d in deps if tensor_name(d) not in env]
            if missing:
                for d in missing:
                    if op_name(d) in applied:
                        raise KeyError(f"{d!r} is not an output of node "
                                       f"{op_name(d)!r}")
                stack.extend(op_name(d) for d in missing)
                continue
            stack.pop()
            self._apply(env, node, [env[tensor_name(d)] for d in deps], ctx)
            applied.add(name)

    def _apply(self, env, node, xs, ctx):
        key = None
        if xs and node.op not in _CALL_OPS and all(
                ctx._const_id(x) is not None for x in xs):
            # every input a constant: fold once per device and input set
            key = (id(node), ctx.device, tuple(id(x) for x in xs))
            out = self.shared.folded.get(key)
            if out is not None:
                self._bind(env, node, out)
                return
        out = self._compute(env, node, xs, ctx)
        if key is not None:
            with self.shared.lock:
                out = self.shared.folded.setdefault(key, out)
                for v in (out if isinstance(out, tuple) else (out,)):
                    if isinstance(v, (np.ndarray, torch.Tensor)):
                        self.shared.folded_ids[id(v)] = v
        self._bind(env, node, out)

    @staticmethod
    def _bind(env, node, out):
        if isinstance(out, tuple):
            for i, v in enumerate(out):
                env[f"{node.name}:{i}"] = v
        else:
            env[tensor_name(node.name)] = out

    def _compute(self, env, node, xs, ctx):
        if node.op in _CALL_OPS:
            out = self._call_function(node.attr["f"].func.name, xs, ctx)
        elif node.op == "IdentityN":
            out = tuple(xs)
        elif node.op == "Placeholder" or node.op == "PlaceholderWithDefault":
            if node.op == "PlaceholderWithDefault" and tensor_name(
                    node.name) not in env:
                out = xs[0]
            else:
                raise KeyError(
                    f"placeholder {node.name!r} was not fed (feeds are bound "
                    "before evaluation; is it missing from the input map?)")
        elif node.op in _NP_FAST and xs and _all_static(xs):
            out = _NP_FAST[node.op](node, xs)
        else:
            handler = _OPS.get(node.op)
            if handler is None:
                raise UnsupportedOpError(node.op, node.name)
            out = handler(node, xs, ctx)
        return out

    def _call_function(self, fname, xs, ctx):
        shared = self.shared
        entry = shared.functions.get(fname)
        if entry is None:
            fdef = shared.library.get(fname)
            if fdef is None:
                raise KeyError(f"function {fname!r} is not in the graph's "
                               "library")
            nodes, rets = function_graph(fdef)
            entry = (_GraphEval(nodes, shared),
                     [a.name for a in fdef.signature.input_arg], rets)
            with shared.lock:
                entry = shared.functions.setdefault(fname, entry)
        sub, args, rets = entry
        env = {f"{a}:0": v for a, v in zip(args, xs)}
        outs = sub.run(env, rets, ctx)
        return tuple(outs) if len(outs) != 1 else outs[0]


def _placeholder_dtypes(graph_def, feeds):
    nodes = {n.name: n for n in graph_def.node}
    out = []
    for f in feeds:
        n = nodes.get(op_name(f))
        t = n.attr["dtype"].type if n is not None else 0
        out.append(torch_dtype(t) if t else None)
    return out


def build_torch_fn(graph_def, feeds, fetches):
    """``graph_def`` as a torch callable ``fn(*feed_values)`` → the fetches
    (one tensor for one fetch, else a tuple), run on the feeds' device.

    feeds/fetches: tensor names (``"x"`` or ``"x:0"``). Each feed is cast
    to its Placeholder's dtype. Evaluation is lazy, so a call visits
    exactly the subgraph the fetches reach. Constants are uploaded once
    per device and kept with the function."""
    feeds = [tensor_name(f) for f in feeds]
    fetches = [tensor_name(f) for f in fetches]
    shared = _Shared({f.signature.name: f
                      for f in graph_def.library.function})
    ev = _GraphEval(graph_def.node, shared)
    dtypes = _placeholder_dtypes(graph_def, feeds)

    def fn(*args):
        if len(args) != len(feeds):
            raise TypeError(f"expected {len(feeds)} inputs {feeds}, got "
                            f"{len(args)}")
        vals = []
        for a, dt in zip(args, dtypes):
            t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
                np.asarray(a))
            if dt is not None and t.dtype != dt:
                t = t.to(dt)
            vals.append(t)
        device = vals[0].device if vals else torch.device("cpu")
        ctx = _Run(shared, device)
        with full_f32():
            out = ev.run(dict(zip(feeds, vals)), fetches, ctx)
        out = [ctx.t(o) if not isinstance(o, torch.Tensor) else o
               for o in out]
        return tuple(out) if len(out) != 1 else out[0]

    fn.input_names = feeds
    fn.output_names = fetches
    return fn
