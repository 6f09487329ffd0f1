"""Functional NN ops with TF/Keras numerics, in torch.

Port of ``tpudl/zoo/nn.py`` (every function of its ``__all__``), plus
the ops tpudl's models call from ``jax.nn`` or spell inline: ``swish``,
``sigmoid``, Keras's ``Flatten`` (:func:`flatten_nhwc`) and
``correct_pad`` (MobileNetV2's and EfficientNet's ``_correct_pad``).

**Layout.** Activations are NCHW tensors; on the card they stay in
``torch.channels_last`` memory (an NHWC batch seen through
``permute(0, 3, 1, 2)`` already is), which cuDNN's convolutions prefer.
Convolution kernels are torch's OIHW, converted once from the Keras HWIO
arrays of a param pytree (:func:`tpudl_torch.zoo.core.torch_layout`);
depthwise kernels are ``(cin * mult, 1, kh, kw)``; dense kernels keep
Keras's ``(in, out)`` and multiply as ``x @ W``.

The TF semantics tpudl gets from ``lax`` are spelled out here:

- SAME padding is TF's: ``pad = max((ceil(n / s) - 1) * s + k - n, 0)``
  per spatial dim, ``pad // 2`` before and the rest after (asymmetric
  on stride > 1). A symmetric pad goes to the op itself; an asymmetric
  one is an explicit ``F.pad`` (``-inf`` for max pooling).
- SAME average pooling leaves padded cells out of the divisor.
- Batch norm is Keras's (eps 1e-3): inference folds the moving stats
  into one scale and shift in f32, then casts both to ``x.dtype``; train
  mode uses the batch's stats and returns the moving-average updates.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "conv2d",
    "depthwise_conv2d",
    "separable_conv2d",
    "dense",
    "batch_norm",
    "max_pool",
    "avg_pool",
    "global_avg_pool",
    "global_max_pool",
    "zero_pad",
    "correct_pad",
    "relu",
    "relu6",
    "swish",
    "sigmoid",
    "flatten_nhwc",
    "softmax",
]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(size, window, strides):
    """TF SAME padding of an NCHW tensor's spatial ``size`` (h, w):
    ``((top, bottom), (left, right))``."""
    pads = []
    for n, k, s in zip(size, window, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _padding(x, window, strides, padding):
    """``(x, symmetric padding for the op)``: VALID is 0; a symmetric SAME
    pad goes to the op; an asymmetric one is applied here with zeros."""
    if padding == "VALID":
        return x, 0
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    (t, b), (l, r) = same_pads(x.shape[2:], window, strides)
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b)), 0


def _add_bias(y, bias):
    if bias is None:
        return y
    return y + bias.to(y.dtype).reshape(1, -1, 1, 1)


def conv2d(x, kernel, bias=None, *, strides=(1, 1), padding="SAME"):
    """NCHW conv with an OIHW kernel (Keras Conv2D, TF padding)."""
    s = _pair(strides)
    x, pad = _padding(x, kernel.shape[2:], s, padding)
    return _add_bias(F.conv2d(x, kernel.to(x.dtype), stride=s, padding=pad),
                     bias)


def depthwise_conv2d(x, kernel, bias=None, *, strides=(1, 1),
                     padding="SAME"):
    """Depthwise conv; ``kernel`` is ``(cin * mult, 1, kh, kw)`` with output
    channel ``c * mult + m`` reading input channel ``c`` (TF's
    DepthwiseConv2dNative order, as tpudl reshapes Keras's
    ``(kh, kw, cin, mult)``)."""
    s = _pair(strides)
    cin = x.shape[1]
    x, pad = _padding(x, kernel.shape[2:], s, padding)
    return _add_bias(F.conv2d(x, kernel.to(x.dtype), stride=s, padding=pad,
                              groups=cin), bias)


def separable_conv2d(x, depth_kernel, point_kernel, bias=None, *,
                     strides=(1, 1), padding="SAME"):
    """Keras SeparableConv2D: depthwise, then a 1x1 pointwise conv (+bias)."""
    y = depthwise_conv2d(x, depth_kernel, strides=strides, padding=padding)
    return conv2d(y, point_kernel, bias, strides=(1, 1), padding="VALID")


def dense(x, kernel, bias=None):
    y = x @ kernel.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _bc(v):
    return v.reshape(1, -1, 1, 1)


def batch_norm(x, p: dict, *, train: bool = False, epsilon: float = 1e-3,
               momentum: float = 0.99):
    """Keras BatchNormalization over the channel axis (1).

    ``p`` holds ``gamma`` (absent or None for scale=False, as in
    InceptionV3), ``beta``, ``moving_mean``, ``moving_var``. Train mode
    returns ``(y, new_stats)`` with Keras's moving-average update."""
    gamma = p.get("gamma")
    beta = p.get("beta")
    f32 = torch.float32
    if not train:
        inv = torch.rsqrt(p["moving_var"].to(f32) + epsilon)
        if gamma is not None:
            inv = inv * gamma.to(f32)
        shift = -p["moving_mean"].to(f32) * inv
        if beta is not None:
            shift = shift + beta.to(f32)
        return x * _bc(inv.to(x.dtype)) + _bc(shift.to(x.dtype))
    xf = x.to(f32)
    mean = xf.mean(dim=(0, 2, 3))
    var = xf.var(dim=(0, 2, 3), unbiased=False)
    inv = torch.rsqrt(var + epsilon)
    if gamma is not None:
        inv = inv * gamma.to(f32)
    y = (xf - _bc(mean)) * _bc(inv)
    if beta is not None:
        y = y + _bc(beta.to(f32))
    new_stats = {
        "moving_mean": p["moving_mean"] * momentum + mean * (1 - momentum),
        "moving_var": p["moving_var"] * momentum + var * (1 - momentum),
    }
    return y.to(x.dtype), new_stats


def max_pool(x, window, *, strides, padding="VALID"):
    """Max pooling; SAME pads with -inf, so a pad never wins."""
    w, s = _pair(window), _pair(strides)
    if padding == "SAME":
        (t, b), (l, r) = same_pads(x.shape[2:], w, s)
        if (t, l) != (b, r) or 2 * t > w[0] or 2 * l > w[1]:
            x = F.pad(x, (l, r, t, b), value=float("-inf"))
            t = l = 0
        return F.max_pool2d(x, w, s, padding=(t, l))
    if padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return F.max_pool2d(x, w, s)


def avg_pool(x, window, *, strides, padding="VALID"):
    """TF average pooling: SAME leaves padded cells out of the divisor."""
    w, s = _pair(window), _pair(strides)
    if padding == "VALID":
        return F.avg_pool2d(x, w, s)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    (t, b), (l, r) = same_pads(x.shape[2:], w, s)
    if (t, l) == (b, r) and 2 * t <= w[0] and 2 * l <= w[1]:
        return F.avg_pool2d(x, w, s, padding=(t, l), count_include_pad=False)
    # the general case, as tpudl computes it: a window sum over the
    # zero-padded input divided by a window count of the real cells
    pads = (l, r, t, b)
    sums = F.avg_pool2d(F.pad(x, pads), w, s, divisor_override=1)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    counts = F.avg_pool2d(F.pad(ones, pads), w, s, divisor_override=1)
    return sums / counts


def global_avg_pool(x):
    return x.mean(dim=(2, 3))


def global_max_pool(x):
    return x.amax(dim=(2, 3))


def zero_pad(x, pad):
    """Keras ZeroPadding2D: pad = ((top, bottom), (left, right))."""
    (t, b), (l, r) = pad
    return F.pad(x, (l, r, t, b))


def correct_pad(x, kernel):
    """Keras ``imagenet_utils.correct_pad`` of an NCHW map: the zero pad
    ``((top, bottom), (left, right))`` that puts a stride-2 VALID conv on
    the grid a SAME one would use. tpudl reads (h, w) off NHWC axes 1 and
    2; here they are axes 2 and 3."""
    h, w = x.shape[2], x.shape[3]
    c = kernel // 2
    return ((c - (1 - h % 2), c), (c - (1 - w % 2), c))


def relu(x):
    return F.relu(x)


def relu6(x):
    """Keras ReLU(6.0), the MobileNet activation."""
    return torch.clamp(x, 0.0, 6.0)


def swish(x):
    """Keras swish (``jax.nn.silu``), the EfficientNet activation."""
    return F.silu(x)


def sigmoid(x):
    return torch.sigmoid(x)


def flatten_nhwc(x):
    """Keras ``Flatten`` of an NCHW map: the rows in Keras's NHWC row-major
    order, so a dense layer after it reads the weights tpudl trained or
    converted (a plain reshape of NCHW would permute its inputs)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def softmax(x):
    return torch.softmax(x, dim=-1)
