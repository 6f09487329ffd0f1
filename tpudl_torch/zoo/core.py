"""Define-by-run parameter store — the zoo's graph builder.

Port of ``tpudl/zoo/core.py`` (``Namer``, ``glorot_uniform``'s numpy
branch, ``Store`` with its init, apply and train modes and every layer
method, ``norm_stats`` included). Each
architecture is one build function over a ``Store``:

- init: ``Store(rng=np.random.Generator)`` — layer calls draw Keras-
  initialized numpy params in Keras's layout (HWIO kernels), keyed by
  canonical Keras layer names, in tpudl's order, so ``init(seed)`` is
  bit-equal to tpudl's. Run the build on a ``device="meta"`` tensor and
  the shapes flow through without any arithmetic (tpudl uses
  ``jax.eval_shape`` for the same).
- apply: ``Store(params=p)`` — ``p`` is the port's layout of the same
  tree (:func:`tpudl_torch.zoo.convert.torch_params`): torch tensors,
  OIHW conv kernels.
- train: ``Store(params=p, train=True)`` — BN uses batch stats and the
  updated moving averages collect in ``store.bn_updates``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudl_torch.zoo import nn
from tpudl_torch.zoo.convert import torch_layout

__all__ = ["Namer", "Store", "glorot_uniform"]


class Namer:
    """Reproduces Keras auto-naming: first unnamed Conv2D in a fresh process
    is ``conv2d``, then ``conv2d_1``, ... Per-type counters."""

    def __init__(self):
        self._counts: dict[str, int] = {}

    def __call__(self, base: str, explicit: str | None = None) -> str:
        if explicit is not None:
            return explicit
        i = self._counts.get(base, 0)
        self._counts[base] = i + 1
        return base if i == 0 else f"{base}_{i}"


def glorot_uniform(rng: np.random.Generator, shape, dtype=np.float32):
    """Keras's default kernel initializer, drawn from a numpy Generator
    (tpudl's host branch, the same draws)."""
    if len(shape) == 2:
        fan_in, fan_out = shape
    else:  # conv HWIO: receptive field × channels
        rf = int(np.prod(shape[:-2]))
        fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return rng.uniform(-limit, limit, size=shape).astype(dtype)


def _pair(k):
    return (k, k) if isinstance(k, int) else tuple(k)


class Store:
    """One object, three modes (see the module docstring). In init mode
    ``params`` collects numpy arrays; layer calls see them in the port's
    layout on the input's device."""

    def __init__(self, params=None, rng=None, *, train: bool = False,
                 param_dtype=np.float32):
        if (params is None) == (rng is None):
            raise ValueError("pass exactly one of params= (apply) or rng= (init)")
        if rng is not None and not isinstance(rng, np.random.Generator):
            raise TypeError("init takes a np.random.Generator (tpudl's jax "
                            f"PRNG keys have no port), got {type(rng).__name__}")
        self.initializing = params is None
        self.params = {} if self.initializing else params
        self._rng = rng
        self.train = train and not self.initializing
        self.param_dtype = param_dtype
        self.name = Namer()
        self.bn_updates: dict[str, dict] = {}

    def _get(self, name: str, make, device) -> dict:
        if self.initializing:
            if name in self.params:
                raise ValueError(f"duplicate layer name {name!r}")
            self.params[name] = make()
            return {k: torch_layout(k, v).to(device)
                    for k, v in self.params[name].items()}
        if name not in self.params:
            raise KeyError(f"missing params for layer {name!r}")
        return self.params[name]

    def _zeros(self, shape):
        return np.zeros(shape, self.param_dtype)

    def _ones(self, shape):
        return np.ones(shape, self.param_dtype)

    # -- layers (each mirrors the matching Keras layer's weight layout) ----
    def conv(self, x, filters, kernel_size, *, strides=(1, 1), padding="SAME",
             use_bias=True, name=None):
        kh, kw = _pair(kernel_size)
        lname = self.name("conv2d", name)
        cin = x.shape[1]

        def make():
            p = {"kernel": glorot_uniform(self._rng, (kh, kw, cin, filters),
                                          self.param_dtype)}
            if use_bias:
                p["bias"] = self._zeros((filters,))
            return p

        p = self._get(lname, make, x.device)
        return nn.conv2d(x, p["kernel"], p.get("bias"), strides=strides,
                         padding=padding)

    def sep_conv(self, x, filters, kernel_size, *, strides=(1, 1),
                 padding="SAME", use_bias=True, name=None):
        kh, kw = _pair(kernel_size)
        lname = self.name("separable_conv2d", name)
        cin = x.shape[1]

        def make():
            p = {
                "depthwise_kernel": glorot_uniform(
                    self._rng, (kh, kw, cin, 1), self.param_dtype),
                "pointwise_kernel": glorot_uniform(
                    self._rng, (1, 1, cin, filters), self.param_dtype),
            }
            if use_bias:
                p["bias"] = self._zeros((filters,))
            return p

        p = self._get(lname, make, x.device)
        return nn.separable_conv2d(x, p["depthwise_kernel"],
                                   p["pointwise_kernel"], p.get("bias"),
                                   strides=strides, padding=padding)

    def depthwise_conv(self, x, kernel_size, *, strides=(1, 1),
                       padding="SAME", use_bias=True, name=None):
        """Keras DepthwiseConv2D (depth multiplier 1): param key
        ``depthwise_kernel`` (kh, kw, cin, 1)."""
        kh, kw = _pair(kernel_size)
        lname = self.name("depthwise_conv2d", name)
        cin = x.shape[1]

        def make():
            p = {"depthwise_kernel": glorot_uniform(
                self._rng, (kh, kw, cin, 1), self.param_dtype)}
            if use_bias:
                p["bias"] = self._zeros((cin,))
            return p

        p = self._get(lname, make, x.device)
        return nn.depthwise_conv2d(x, p["depthwise_kernel"], p.get("bias"),
                                   strides=strides, padding=padding)

    def bn(self, x, *, scale=True, epsilon=1e-3, momentum=0.99, name=None):
        lname = self.name("batch_normalization", name)
        c = x.shape[1]

        def make():
            p = {
                "beta": self._zeros((c,)),
                "moving_mean": self._zeros((c,)),
                "moving_var": self._ones((c,)),
            }
            if scale:
                p["gamma"] = self._ones((c,))
            return p

        p = self._get(lname, make, x.device)
        if self.train:
            y, new_stats = nn.batch_norm(x, p, train=True, epsilon=epsilon,
                                         momentum=momentum)
            self.bn_updates[lname] = new_stats
            return y
        return nn.batch_norm(x, p, train=False, epsilon=epsilon)

    def norm_stats(self, x, *, name=None):
        """Keras ``Normalization`` over the channel axis (1): ``(x - mean)
        / max(sqrt(variance), 1e-7)`` with mean and variance as weights
        (EfficientNet normalizes inside the model this way). Init is the
        identity, mean 0 and variance 1; the clamp keeps a zero-variance
        channel finite, as Keras does."""
        lname = self.name("normalization", name)
        c = x.shape[1]

        def make():
            return {"mean": self._zeros((c,)), "variance": self._ones((c,))}

        p = self._get(lname, make, x.device)
        mean = p["mean"].to(x.dtype).reshape(1, -1, 1, 1)
        std = torch.sqrt(p["variance"].to(x.dtype)).clamp_min(1e-7)
        return (x - mean) / std.reshape(1, -1, 1, 1)

    def dense(self, x, units, *, use_bias=True, name=None):
        lname = self.name("dense", name)
        cin = x.shape[-1]

        def make():
            p = {"kernel": glorot_uniform(self._rng, (cin, units),
                                          self.param_dtype)}
            if use_bias:
                p["bias"] = self._zeros((units,))
            return p

        p = self._get(lname, make, x.device)
        return nn.dense(x, p["kernel"], p.get("bias"))

    def merged_params(self) -> dict:
        """Params with train-mode BN moving stats folded back in."""
        out = dict(self.params)
        for lname, stats in self.bn_updates.items():
            out[lname] = {**out[lname], **stats}
        return out
