"""A Keras ``config.json`` as a torch function ``fn(params, x)``.

The port's counterpart of what ``tpudl/ingest/graphdef.py:build_jax_fn``
computes for a Keras-traced graph: tpudl traces the model into a TF
GraphDef and evaluates it op by op in jax; without TensorFlow, the layer
graph in ``config.json`` is the only description of the model there is,
so this module evaluates that, layer by layer, in Keras's inference
semantics (BatchNormalization on its moving statistics, Dropout off).

``params`` is ``{variable path: tensor}`` in Keras's layout (``conv2d/
kernel`` HWIO, ``dense/kernel`` ``(in, out)``), as
:func:`tpudl_torch.ingest.kerasfile.load_keras_file` reads it and as
tpudl's ``TFInputGraph.fromKerasTrainable`` keys it, so gradients come
back in the same layout; ``layout="h5"`` takes the keys of a legacy
``.h5`` file (:func:`~tpudl_torch.ingest.kerasfile.layer_keys`). ``x`` is
the model's input as Keras takes it (NHWC images, ``(batch, features)``
rows); a 4-D output comes back NHWC. Inside, a 4-D tensor is NCHW in
contiguous (NCHW) memory, and layer axes are mapped to it. Not
channels_last, as the zoo runs: on NHWC memory cuDNN (FFT engines) and
the CPU's convolutions compute an f32 training step's gradients less
accurately, up to 8.4e-2 of the largest gradient off a float64 run in
InceptionV3's BN shifts on the H100 against 1.9e-3 in NCHW (PERF.md).

Layers: InputLayer, Dense, Conv2D (dilation, groups), DepthwiseConv2D,
SeparableConv2D, BatchNormalization, Normalization, Rescaling,
Activation, ReLU, LeakyReLU, MaxPooling2D, AveragePooling2D,
GlobalAveragePooling2D, GlobalMaxPooling2D, Concatenate, Add, Multiply,
Reshape, Flatten, Dropout (identity) and ZeroPadding2D; the activations
of ``KERAS_ACTIVATIONS``; Sequential and Functional models with one input
and one output, and such models nested as a layer of another, each called
once. Anything else, and any option of these layers the module does not
compute (channels_first, a mixed precision policy, a shared layer),
raises ``NotImplementedError`` naming it: an uncovered layer fails, it
does not run wrong.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpudl_torch.ingest.kerasfile import is_model, layer_keys, model_layers
from tpudl_torch.zoo import nn

__all__ = ["build_torch_fn", "graph_steps", "KERAS_LAYERS",
           "KERAS_ACTIVATIONS"]


def _hard_sigmoid(x):
    # Keras 3: relu6(x + 3) / 6
    return F.relu6(x + 3.0) / 6.0


# relu6 is F.relu6, not a clamp: TF's Relu6 passes no gradient at exactly 0
# or 6, as F.relu6 does, where a clamp passes it (exact zeros are common
# at Keras's initialization, where BN shifts are 0)
KERAS_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "relu6": F.relu6,
    "softmax": lambda x: torch.softmax(x, dim=_axis(-1, x.ndim)),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "silu": F.silu,
    "swish": F.silu,
    "gelu": F.gelu,                 # Keras's default: exact (erf)
    "elu": F.elu,
    "selu": F.selu,
    "softplus": F.softplus,
    "hard_sigmoid": _hard_sigmoid,
    "hard_silu": lambda x: x * _hard_sigmoid(x),
    "hard_swish": lambda x: x * _hard_sigmoid(x),
}


def _unsupported(what: str):
    raise NotImplementedError(
        f"{what} is not supported by tpudl_torch's Keras evaluator "
        "(ROADMAP Queue 1, 'The rest of the sparkdl surface')")


def _axis(axis: int, ndim: int) -> int:
    """A Keras (NHWC) axis → the torch axis of the stored tensor."""
    axis = axis % ndim
    if ndim == 4:
        return (0, 2, 3, 1)[axis]
    return axis


def _activation(name, where: str):
    if not isinstance(name, str) or name not in KERAS_ACTIVATIONS:
        _unsupported(f"activation {name!r} ({where})")
    return KERAS_ACTIVATIONS[name]


def _channels_last(c: dict, where: str):
    if c.get("data_format", "channels_last") != "channels_last":
        _unsupported(f"data_format={c['data_format']!r} ({where})")


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _padding(c: dict) -> str:
    padding = c.get("padding", "valid")
    if padding not in ("valid", "same"):
        _unsupported(f"padding={padding!r} ({c['name']})")
    return padding.upper()


def _channel(v, x):
    """A per-channel (NHWC last-axis) vector broadcast over the stored
    tensor ``x``."""
    return v.reshape(1, -1, 1, 1) if x.ndim == 4 else v


def _depthwise_oihw(k):
    """A Keras depthwise kernel ``(kh, kw, cin, mult)`` → ``(cin * mult, 1,
    kh, kw)``, output channel ``c * mult + m`` (TF's order)."""
    kh, kw, cin, mult = k.shape
    return k.reshape(kh, kw, cin * mult).permute(2, 0, 1).unsqueeze(1)


def _const(v, x, cache: dict):
    """The config constant ``v`` as a tensor on ``x``'s device and dtype,
    per-channel when it is a vector; made once per device and dtype (a
    CUDA-graph capture records no copy from host memory)."""
    key = (x.device, x.dtype)
    if key not in cache:
        cache[key] = torch.as_tensor(v, dtype=x.dtype).to(x.device)
    t = cache[key]
    return _channel(t, x) if t.ndim else t


def _conv(x, w, b, strides, padding, dilation, groups):
    """TF's conv on NCHW: OIHW ``w``, SAME padding over the dilated
    window (asymmetric pads applied with zeros)."""
    pad = 0
    if padding == "SAME":
        window = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dilation)]
        (t, bo), (le, r) = nn.same_pads(x.shape[2:], window, strides)
        if (t, le) == (bo, r):
            pad = (t, le)
        else:
            x = F.pad(x, (le, r, t, bo))
    y = F.conv2d(x, w.to(x.dtype), stride=strides, padding=pad,
                 dilation=dilation, groups=groups)
    return y if b is None else y + b.to(y.dtype).reshape(1, -1, 1, 1)


def _conv_options(kind, name, c):
    _channels_last(c, name)
    strides, dilation = _pair(c.get("strides", 1)), \
        _pair(c.get("dilation_rate", 1))
    if dilation != (1, 1) and strides != (1, 1):
        _unsupported(f"{kind} with both strides and dilation_rate ({name})")
    return (_activation(c.get("activation", "linear"), name), strides,
            _padding(c), dilation, c.get("use_bias", True))


def _dense(name, c, keys):
    act = _activation(c.get("activation", "linear"), name)
    for key in ("lora_rank", "quantization_config"):
        if c.get(key):
            _unsupported(f"Dense {key} ({name})")
    use_bias = c.get("use_bias", True)

    def op(p, x):
        b = p[keys["bias"]] if use_bias else None
        if x.ndim == 4:                        # Keras: over the last axis
            y = nn.dense(x.permute(0, 2, 3, 1), p[keys["kernel"]], b)
            return act(y.permute(0, 3, 1, 2))
        return act(nn.dense(x, p[keys["kernel"]], b))

    return op


def _conv2d(name, c, keys):
    act, strides, padding, dilation, use_bias = _conv_options(
        "Conv2D", name, c)
    groups = int(c.get("groups", 1))

    def op(p, x):
        return act(_conv(x, p[keys["kernel"]].permute(3, 2, 0, 1),
                         p[keys["bias"]] if use_bias else None,
                         strides, padding, dilation, groups))

    return op


def _depthwise(name, c, keys):
    act, strides, padding, dilation, use_bias = _conv_options(
        "DepthwiseConv2D", name, c)

    def op(p, x):
        w = _depthwise_oihw(p[keys["kernel"]])
        return act(_conv(x, w, p[keys["bias"]] if use_bias else None,
                         strides, padding, dilation, x.shape[1]))

    return op


def _separable(name, c, keys):
    act, strides, padding, dilation, use_bias = _conv_options(
        "SeparableConv2D", name, c)

    def op(p, x):
        dw = _depthwise_oihw(p[keys["depthwise_kernel"]])
        y = _conv(x, dw, None, strides, padding, dilation, x.shape[1])
        pw = p[keys["pointwise_kernel"]].permute(3, 2, 0, 1)
        return act(_conv(y, pw, p[keys["bias"]] if use_bias else None,
                         (1, 1), "VALID", (1, 1), 1))

    return op


def _last_axis(axis, name, what):
    """``axis`` (an int or a one-element list) must be the last (channel)
    axis: the axis these layers act on in every named model."""
    if isinstance(axis, (list, tuple)):
        if len(axis) != 1:
            _unsupported(f"{what} over axes {axis} ({name})")
        axis = axis[0]
    return axis


def _batch_norm(name, c, keys):
    axis = _last_axis(c.get("axis", -1), name, "BatchNormalization")
    eps = float(c.get("epsilon", 1e-3))
    if c.get("renorm") or c.get("synchronized"):
        _unsupported(f"BatchNormalization renorm/synchronized ({name})")
    scale, center = c.get("scale", True), c.get("center", True)

    def op(p, x):
        if _axis(axis, x.ndim) != 1:
            _unsupported(f"BatchNormalization on axis {axis} of a rank "
                         f"{x.ndim} tensor ({name})")
        leaves = {"moving_mean": p[keys["moving_mean"]],
                  "moving_var": p[keys["moving_variance"]],
                  "gamma": p[keys["gamma"]] if scale else None,
                  "beta": p[keys["beta"]] if center else None}
        if x.ndim == 4:
            return nn.batch_norm(x, leaves, epsilon=eps)
        return nn.batch_norm(x[:, :, None, None], leaves,
                             epsilon=eps)[:, :, 0, 0]

    return op


def _normalization(name, c, keys):
    """Keras 3: ``(x - mean) / maximum(sqrt(variance), 1e-7)`` (``invert``:
    ``mean + x * maximum(...)``), the statistics stored as variables or
    given in the config, over the last axis."""
    axis = _last_axis(c.get("axis", -1), name, "Normalization")
    invert = bool(c.get("invert", False))
    fixed = c.get("mean") is not None
    caches = ({}, {})

    def op(p, x):
        if x.ndim not in (2, 4) or _axis(axis, x.ndim) != 1:
            _unsupported(f"Normalization on axis {axis} of a rank {x.ndim} "
                         f"tensor ({name})")
        if fixed:
            mean = _const(c["mean"], x, caches[0])
            var = _const(c["variance"], x, caches[1])
        else:
            mean = _channel(p[keys["mean"]].to(x.dtype), x)
            var = _channel(p[keys["variance"]].to(x.dtype), x)
        std = torch.clamp(torch.sqrt(var), min=1e-7)
        return mean + x * std if invert else (x - mean) / std

    return op


def _rescaling(name, c, keys):
    scale, offset = c.get("scale", 1.0), c.get("offset", 0.0)
    for v in (scale, offset):
        if isinstance(v, (list, tuple)) and any(
                isinstance(e, (list, tuple)) for e in v):
            _unsupported(f"Rescaling with a multi-axis scale or offset "
                         f"({name})")
    caches = ({}, {})
    return lambda p, x: (x * _const(scale, x, caches[0])
                         + _const(offset, x, caches[1]))


def _relu(name, c, keys):
    """Keras 3's ``ReLU.static_call``, branch for branch (its gradients
    too: ``relu6`` for ``max_value=6`` without a threshold, else a relu
    and then a clip)."""
    slope = float(c.get("negative_slope") or 0.0)
    top = c.get("max_value")
    thr = float(c.get("threshold") or 0.0)
    six = top is not None and float(top) == 6.0 and not thr

    def op(p, x):
        if slope and top is None and not thr:
            return F.leaky_relu(x, slope)
        neg = F.relu(thr - x) if slope else None
        if thr:
            y = x * (x > thr).to(x.dtype)
        else:
            y = F.relu6(x) if six else F.relu(x)
        if top is not None and not six:
            y = torch.clamp(y, 0.0, float(top))
        return y - slope * neg if slope else y

    return op


def _leaky_relu(name, c, keys):
    slope = float(c.get("negative_slope", c.get("alpha", 0.3)))
    return lambda p, x: F.leaky_relu(x, slope)


def _pool(kind):
    def make(name, c, keys):
        _channels_last(c, name)
        window = _pair(c["pool_size"])
        strides = _pair(c.get("strides") or window)
        padding = _padding(c)
        f = nn.max_pool if kind == "max" else nn.avg_pool
        return lambda p, x: f(x, window, strides=strides, padding=padding)
    return make


def _global_pool(kind):
    def make(name, c, keys):
        _channels_last(c, name)
        keep = bool(c.get("keepdims", False))
        if kind == "max":
            return lambda p, x: x.amax(dim=(2, 3), keepdim=keep)
        return lambda p, x: x.mean(dim=(2, 3), keepdim=keep)
    return make


def _concatenate(name, c, keys):
    axis = c.get("axis", -1)
    return lambda p, *xs: torch.cat(xs, dim=_axis(axis, xs[0].ndim))


def _merge(kind):
    def make(name, c, keys):
        def op(p, *xs):
            if len({x.ndim for x in xs}) != 1:
                _unsupported(f"{kind} of tensors of different ranks "
                             f"({name})")
            y = xs[0]
            for x in xs[1:]:
                y = y + x if kind == "Add" else y * x
            return y
        return op
    return make


def _reshape(name, c, keys):
    target = tuple(int(d) for d in c["target_shape"])

    def op(p, x):
        if x.ndim == 4:                       # to Keras's NHWC order
            x = x.permute(0, 2, 3, 1)
        y = x.reshape((x.shape[0],) + target)
        return y.permute(0, 3, 1, 2).contiguous() if y.ndim == 4 else y

    return op


def _flatten(name, c, keys):
    _channels_last(c, name)

    def op(p, x):
        if x.ndim == 4:
            return nn.flatten_nhwc(x)
        return x.reshape(x.shape[0], -1)
    return op


def _zero_pad(name, c, keys):
    _channels_last(c, name)
    pad = c["padding"]
    if isinstance(pad, int):
        pad = ((pad, pad), (pad, pad))
    pad = tuple(_pair(v) for v in pad)
    return lambda p, x: nn.zero_pad(x, pad)


def _identity(name, c, keys):
    return lambda p, x: x


def _activation_layer(name, c, keys):
    act = _activation(c.get("activation"), name)
    return lambda p, x: act(x)


KERAS_LAYERS = {
    "InputLayer": _identity,
    "Dense": _dense,
    "Conv2D": _conv2d,
    "DepthwiseConv2D": _depthwise,
    "SeparableConv2D": _separable,
    "BatchNormalization": _batch_norm,
    "Normalization": _normalization,
    "Rescaling": _rescaling,
    "Activation": _activation_layer,
    "ReLU": _relu,
    "LeakyReLU": _leaky_relu,
    "MaxPooling2D": _pool("max"),
    "AveragePooling2D": _pool("avg"),
    "GlobalAveragePooling2D": _global_pool("avg"),
    "GlobalMaxPooling2D": _global_pool("max"),
    "Concatenate": _concatenate,
    "Add": _merge("Add"),
    "Multiply": _merge("Multiply"),
    "Reshape": _reshape,
    "Flatten": _flatten,
    "Dropout": _identity,       # noise_shape too: off at inference
    "ZeroPadding2D": _zero_pad,
}


def _check_dtype(c: dict, name: str):
    dtype = c.get("dtype")
    policy = dtype.get("config", {}).get("name") if isinstance(dtype, dict) \
        else dtype
    if policy not in (None, "float32"):
        _unsupported(f"dtype policy {policy!r} ({name})")


def _layer_op(layer: dict, parent: dict, layout: str):
    cls, c = layer["class_name"], layer["config"]
    name = c["name"]
    _check_dtype(c, name)
    if is_model(layer):
        return _nested(layer, layout)
    if cls not in KERAS_LAYERS:
        _unsupported(f"Keras layer class {cls!r} ({name})")
    return KERAS_LAYERS[cls](name, c, layer_keys(layer, parent, layout))


def _nested(config: dict, layout: str):
    """A model called as one layer of another: its own graph, run on the
    stored (NCHW) tensor."""
    steps, src, outs = graph_steps(config, layout)
    if len(outs) != 1:
        _unsupported(f"a nested model with {len(outs)} outputs "
                     f"({config['config']['name']!r})")
    run = _runner(steps, src, outs)
    return lambda p, x: run(p, x)[0]


def _history(t) -> tuple:
    if not (isinstance(t, dict) and t.get("class_name") == "__keras_tensor__"):
        _unsupported(f"a non-tensor layer argument {t!r}")
    lname, node, index = t["config"]["keras_history"]
    if node != 0 or index != 0:
        _unsupported(f"a shared layer or multi-output layer ({lname!r})")
    return lname


def _inbound(layer: dict) -> list[str]:
    nodes = layer.get("inbound_nodes", [])
    if len(nodes) > 1:
        _unsupported(f"a shared layer ({layer['config']['name']!r})")
    if not nodes:
        return []
    node = nodes[0]
    if not isinstance(node, dict):
        _unsupported(f"Keras 2-era inbound nodes ({layer['config']['name']})")
    for k, v in node.get("kwargs", {}).items():
        # training=False (or unset) is the inference call evaluated here
        if v is not None and not (k == "training" and v is False):
            _unsupported(f"a layer call with {k}={v!r} "
                         f"({layer['config']['name']})")
    args = node["args"]
    if len(args) != 1:
        _unsupported(f"a layer called with {len(args)} positional arguments "
                     f"({layer['config']['name']})")
    arg = args[0]
    return [_history(t) for t in (arg if isinstance(arg, list) else [arg])]


def _endpoints(spec) -> list[str]:
    """``input_layers``/``output_layers`` → their layer names."""
    specs = spec if spec and isinstance(spec[0], list) else [spec]
    return [_history({"class_name": "__keras_tensor__",
                      "config": {"keras_history": s}}) for s in specs]


def _endpoint(spec) -> str:
    """``input_layers`` → the one input layer's name."""
    names = _endpoints(spec)
    if len(names) != 1:
        _unsupported(f"a model with {len(names)} inputs")
    return names[0]


def graph_steps(config: dict, layout: str = "keras"):
    """``(steps, input, outputs)``: ``steps`` is ``[(name, op, inputs)]`` in
    an order where each layer follows its inputs; ``outputs`` lists the
    model's output layers. A nested model is one step."""
    cls = config.get("class_name")
    layers = config["config"]["layers"]
    if cls == "Sequential":
        src = "input"
        if layers and layers[0]["class_name"] == "InputLayer":
            src = layers[0]["config"]["name"]
        steps, prev = [], src
        for layer in model_layers(config):
            steps.append((layer["config"]["name"],
                          _layer_op(layer, config, layout), [prev]))
            prev = layer["config"]["name"]
        return steps, src, [prev]
    if cls not in ("Functional", "Model"):
        _unsupported(f"a {cls!r} model")
    by_name = {layer["config"]["name"]: layer for layer in layers}
    inputs = {n: _inbound(layer) for n, layer in by_name.items()}
    # Kahn's order over the layer graph
    order, done = [], set()
    pending = list(by_name)
    while pending:
        ready = [n for n in pending if all(i in done for i in inputs[n])]
        if not ready:
            raise ValueError("the model config's layer graph has a cycle or "
                             "a missing layer")
        for n in ready:
            order.append(n)
            done.add(n)
        pending = [n for n in pending if n not in done]
    src = _endpoint(config["config"]["input_layers"])
    outs = _endpoints(config["config"]["output_layers"])
    steps = [(n, _layer_op(by_name[n], config, layout), inputs[n])
             for n in order if by_name[n]["class_name"] != "InputLayer"]
    return steps, src, outs


def _runner(steps, src, outs):
    """``run(params, x) -> [output, ...]`` over stored tensors, each
    intermediate freed after its last use."""
    last_use = {}
    for i, (_n, _op, ins) in enumerate(steps):
        for name in ins:
            last_use[name] = i

    def run(params, x):
        env = {src: x}
        for i, (name, op, ins) in enumerate(steps):
            env[name] = op(params, *(env[n] for n in ins))
            for n in ins:
                if last_use[n] == i and n not in outs:
                    env.pop(n, None)
        return [env[o] for o in outs]

    return run


def build_torch_fn(config: dict, outputs=None, layout: str = "keras"):
    """``fn(params, x)`` computing the model of ``config`` (see the module
    docstring): the output layers named in ``outputs`` (default: the
    model's), one tensor for one output, else a tuple in that order."""
    steps, src, model_outs = graph_steps(config, layout)
    outs = list(outputs) if outputs is not None else model_outs
    unknown = [o for o in outs if o not in model_outs]
    if unknown:
        raise ValueError(f"{unknown} are not outputs of the model "
                         f"({model_outs})")
    run = _runner(steps, src, outs)

    def nhwc(y):
        return y.permute(0, 2, 3, 1) if y.ndim == 4 else y

    def fn(params, x):
        ys = run(params, x.permute(0, 3, 1, 2).contiguous() if x.ndim == 4
                 else x)
        if len(ys) == 1:
            return nhwc(ys[0])
        return tuple(nhwc(y) for y in ys)

    return fn
