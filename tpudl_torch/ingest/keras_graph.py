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
back in the same layout. ``x`` is the model's input as Keras takes it
(NHWC images, ``(batch, features)`` rows); a 4-D output comes back NHWC.
Inside, a 4-D tensor is NCHW in contiguous (NCHW) memory, and layer axes
are mapped to it. Not channels_last, as the zoo runs: on NHWC memory
cuDNN (FFT engines) and the CPU's convolutions compute an f32 training
step's gradients less accurately, up to 8.4e-2 of the largest gradient
off a float64 run in InceptionV3's BN shifts on the H100 against 1.9e-3
in NCHW (PERF.md).

Layers: InputLayer, Dense, Conv2D, BatchNormalization, Activation, ReLU,
MaxPooling2D, AveragePooling2D, GlobalAveragePooling2D, Concatenate, Add,
Flatten, Dropout (identity) and ZeroPadding2D; activations linear, relu,
softmax, sigmoid and tanh; Sequential and Functional models with one
input and one output. Anything else, and any option of these layers the
module does not compute (dilation, groups, channels_first, a mixed
precision policy, a shared layer), raises ``NotImplementedError`` naming
it: an uncovered layer fails, it does not run wrong.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpudl_torch.ingest.kerasfile import model_layers
from tpudl_torch.zoo import nn

__all__ = ["build_torch_fn", "graph_steps", "KERAS_LAYERS",
           "KERAS_ACTIVATIONS"]

KERAS_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "softmax": lambda x: torch.softmax(x, dim=_axis(-1, x.ndim)),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
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
    return {"valid": "VALID", "same": "SAME"}[c.get("padding", "valid")]


def _hwio_to_oihw(k):
    return k.permute(3, 2, 0, 1)


def _dense(name, c):
    act = _activation(c.get("activation", "linear"), name)
    for key in ("lora_rank", "quantization_config"):
        if c.get(key):
            _unsupported(f"Dense {key} ({name})")
    kernel, bias = f"{name}/kernel", f"{name}/bias"
    use_bias = c.get("use_bias", True)

    def op(p, x):
        if x.ndim == 4:                        # Keras: over the last axis
            x = x.permute(0, 2, 3, 1)
            y = nn.dense(x, p[kernel], p[bias] if use_bias else None)
            return act(y).permute(0, 3, 1, 2)
        return act(nn.dense(x, p[kernel], p[bias] if use_bias else None))

    return op


def _conv2d(name, c):
    _channels_last(c, name)
    if _pair(c.get("dilation_rate", 1)) != (1, 1):
        _unsupported(f"Conv2D dilation_rate ({name})")
    if c.get("groups", 1) != 1:
        _unsupported(f"Conv2D groups ({name})")
    act = _activation(c.get("activation", "linear"), name)
    strides, padding = _pair(c["strides"]), _padding(c)
    kernel, bias = f"{name}/kernel", f"{name}/bias"
    use_bias = c.get("use_bias", True)

    def op(p, x):
        return act(nn.conv2d(x, _hwio_to_oihw(p[kernel]),
                             p[bias] if use_bias else None,
                             strides=strides, padding=padding))

    return op


def _batch_norm(name, c):
    axis, eps = c.get("axis", -1), float(c.get("epsilon", 1e-3))
    if isinstance(axis, list):
        if len(axis) != 1:
            _unsupported(f"BatchNormalization over axes {axis} ({name})")
        axis = axis[0]
    if c.get("renorm") or c.get("synchronized"):
        _unsupported(f"BatchNormalization renorm/synchronized ({name})")
    keys = {v: f"{name}/{v}" for v in ("gamma", "beta", "moving_mean",
                                       "moving_variance")}
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


def _relu(name, c):
    if c.get("negative_slope") or c.get("threshold"):
        _unsupported(f"ReLU negative_slope/threshold ({name})")
    top = c.get("max_value")
    if top is None:
        return lambda p, x: F.relu(x)
    return lambda p, x: torch.clamp(x, 0.0, float(top))


def _pool(kind):
    def make(name, c):
        _channels_last(c, name)
        window = _pair(c["pool_size"])
        strides = _pair(c.get("strides") or window)
        padding = _padding(c)
        f = nn.max_pool if kind == "max" else nn.avg_pool
        return lambda p, x: f(x, window, strides=strides, padding=padding)
    return make


def _global_avg(name, c):
    _channels_last(c, name)
    keep = bool(c.get("keepdims", False))
    return lambda p, x: x.mean(dim=(2, 3), keepdim=keep)


def _concatenate(name, c):
    axis = c.get("axis", -1)
    return lambda p, *xs: torch.cat(xs, dim=_axis(axis, xs[0].ndim))


def _add(name, c):
    def op(p, *xs):
        y = xs[0]
        for x in xs[1:]:
            y = y + x
        return y
    return op


def _flatten(name, c):
    _channels_last(c, name)

    def op(p, x):
        if x.ndim == 4:
            return nn.flatten_nhwc(x)
        return x.reshape(x.shape[0], -1)
    return op


def _zero_pad(name, c):
    _channels_last(c, name)
    pad = c["padding"]
    if isinstance(pad, int):
        pad = ((pad, pad), (pad, pad))
    pad = tuple(_pair(v) for v in pad)
    return lambda p, x: nn.zero_pad(x, pad)


def _identity(name, c):
    return lambda p, x: x


def _activation_layer(name, c):
    act = _activation(c.get("activation"), name)
    return lambda p, x: act(x)


KERAS_LAYERS = {
    "InputLayer": _identity,
    "Dense": _dense,
    "Conv2D": _conv2d,
    "BatchNormalization": _batch_norm,
    "Activation": _activation_layer,
    "ReLU": _relu,
    "MaxPooling2D": _pool("max"),
    "AveragePooling2D": _pool("avg"),
    "GlobalAveragePooling2D": _global_avg,
    "Concatenate": _concatenate,
    "Add": _add,
    "Flatten": _flatten,
    "Dropout": _identity,
    "ZeroPadding2D": _zero_pad,
}


def _layer_op(layer: dict):
    cls, c = layer["class_name"], layer["config"]
    name = c["name"]
    if cls not in KERAS_LAYERS:
        _unsupported(f"Keras layer class {cls!r} ({name})")
    dtype = c.get("dtype")
    policy = dtype.get("config", {}).get("name") if isinstance(dtype, dict) \
        else dtype
    if policy not in (None, "float32"):
        _unsupported(f"dtype policy {policy!r} ({name})")
    return KERAS_LAYERS[cls](name, c)


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


def graph_steps(config: dict):
    """``(steps, input, outputs)``: ``steps`` is ``[(name, op, inputs)]`` in
    an order where each layer follows its inputs; ``outputs`` lists the
    model's output layers."""
    cls = config.get("class_name")
    layers = config["config"]["layers"]
    if cls == "Sequential":
        src = "input"
        if layers and layers[0]["class_name"] == "InputLayer":
            src = layers[0]["config"]["name"]
        steps, prev = [], src
        for layer in model_layers(config):
            steps.append((layer["config"]["name"], _layer_op(layer), [prev]))
            prev = layer["config"]["name"]
        return steps, src, [prev]
    if cls not in ("Functional", "Model"):
        _unsupported(f"a {cls!r} model")
    by_name = {layer["config"]["name"]: layer for layer in layers}
    inputs = {n: _inbound(layer) for n, layer in by_name.items()}
    for layer in layers:
        if layer["class_name"] in ("Sequential", "Functional", "Model"):
            _unsupported(f"a nested model ({layer['config']['name']!r})")
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
    steps = [(n, _layer_op(by_name[n]), inputs[n]) for n in order
             if by_name[n]["class_name"] != "InputLayer"]
    return steps, src, outs


def build_torch_fn(config: dict, outputs=None):
    """``fn(params, x)`` computing the model of ``config`` (see the module
    docstring): the output layers named in ``outputs`` (default: the
    model's), one tensor for one output, else a tuple in that order."""
    steps, src, model_outs = graph_steps(config)
    outs = list(outputs) if outputs is not None else model_outs
    unknown = [o for o in outs if o not in model_outs]
    if unknown:
        raise ValueError(f"{unknown} are not outputs of the model "
                         f"({model_outs})")
    last_use = {}
    for i, (_n, _op, ins) in enumerate(steps):
        for name in ins:
            last_use[name] = i

    def nhwc(y):
        return y.permute(0, 2, 3, 1) if y.ndim == 4 else y

    def fn(params, x):
        env = {src: x.permute(0, 3, 1, 2).contiguous() if x.ndim == 4
               else x}
        for i, (name, op, ins) in enumerate(steps):
            env[name] = op(params, *(env[n] for n in ins))
            for n in ins:
                if last_use[n] == i and n not in outs:
                    env.pop(n, None)
        if len(outs) == 1:
            return nhwc(env[outs[0]])
        return tuple(nhwc(env[o]) for o in outs)

    return fn
