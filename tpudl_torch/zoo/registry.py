"""Named pretrained-model registry — the zoo's public surface.

Port of ``tpudl/zoo/registry.py`` (``NamedModel``, ``cast_params``,
``SUPPORTED_MODELS``, ``getKerasApplicationModel``): all ten of tpudl's
names, each with its architecture (``inception_v3``, ``xception``,
``resnet`` for ResNet50/101/152, ``vgg`` for VGG16/19, ``mobilenet_v2``,
``densenet``, ``efficientnet``), input size, feature width and
preprocessing mode. ``featurize`` cuts VGG16/19 at the post-ReLU ``fc2``
(4096-d) and every other model at its global average pool.

``NamedModel.init`` returns tpudl's numpy param pytree (Keras names and
layout), bit-equal to tpudl's ``init`` for the same seed. ``apply``,
``featurize`` and ``predict`` take that tree in the port's layout
(:func:`tpudl_torch.zoo.convert.torch_params`) and an NHWC float batch, as
tpudl's do; inside, the model runs NCHW in channels_last memory (a view
of the NHWC batch, no copy). :class:`ImageModel` holds the converted
weights of one model as an ``nn.Module`` on one device in one dtype; in
float32 it runs its convolutions and products in full f32, never TF32
(:func:`tpudl_torch.device.full_f32`, kept importable from here).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from tpudl_torch.device import full_f32, resolve_device
from tpudl_torch.zoo import (densenet, efficientnet, inception_v3,
                             mobilenet_v2, resnet, vgg, xception)
from tpudl_torch.zoo.convert import torch_params
from tpudl_torch.zoo.core import Store
from tpudl_torch.zoo.preprocessing import preprocess_input

__all__ = ["NamedModel", "ImageModel", "SUPPORTED_MODELS",
           "getKerasApplicationModel", "cast_params", "full_f32"]


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Cast the floating leaves of a port param tree to ``dtype`` (round to
    nearest even, as tpudl's host-side numpy cast); other leaves are
    kept."""
    return {layer: {k: v.to(dtype) if v.is_floating_point() else v
                    for k, v in leaves.items()}
            for layer, leaves in params.items()}


@dataclasses.dataclass(frozen=True)
class NamedModel:
    name: str
    build_fn: Callable
    input_size: tuple[int, int]
    feature_dim: int
    preprocess_mode: str
    classes: int = 1000

    # -- params ----------------------------------------------------------
    def init(self, rng, *, image_size: tuple[int, int] | None = None,
             include_top: bool = True) -> dict:
        """Random-init param pytree (Keras initializers), numpy, Keras
        layout. ``rng`` is an int seed or a ``np.random.Generator``; the
        build runs on a meta tensor, so only the draws cost anything."""
        h, w = image_size or self.input_size
        gen = np.random.default_rng(rng) if isinstance(rng, int) else rng
        s = Store(rng=gen)
        self.build_fn(s, torch.empty((1, 3, h, w), device="meta"),
              include_top=include_top, classes=self.classes)
        return s.params

    # -- forward (x: NHWC float) -----------------------------------------
    def apply(self, params: dict, x, *, include_top=True, pooling=None,
              train: bool = False):
        """Forward pass over preprocessed input ``x`` ``(B, H, W, C)``; a
        4-D result comes back NHWC. ``train=True`` returns ``(y,
        bn_updates)``."""
        s = Store(params=params, train=train)
        y = self.build_fn(s, x.permute(0, 3, 1, 2), include_top=include_top,
                  pooling=pooling, classes=self.classes)
        if y.ndim == 4:
            y = y.permute(0, 2, 3, 1)
        if train:
            return y, s.bn_updates
        return y

    def preprocess(self, x):
        """float RGB [0,255] → the model's input domain."""
        return preprocess_input(x, self.preprocess_mode)

    def featurize(self, params: dict, x):
        """Penultimate-layer features (the DeepImageFeaturizer vector): the
        post-ReLU ``fc2`` for VGG, the global average pool otherwise."""
        if self.build_fn in (vgg.build_vgg16, vgg.build_vgg19):
            return self.apply(params, x, include_top="features")
        return self.apply(params, x, include_top=False, pooling="avg")

    def predict(self, params: dict, x):
        """Softmax class scores (the DeepImagePredictor path)."""
        return self.apply(params, x, include_top=True)


class ImageModel(torch.nn.Module):
    """One named model's weights on one device in one dtype: tpudl's param
    pytree converted once (OIHW kernels in channels_last, floating leaves
    cast as :func:`cast_params` casts them), ``layers.<keras
    layer>.<param>``. Every floating leaf is a trainable ``nn.Parameter``,
    BN's moving statistics included: tpudl trains the whole tree, and its
    ``predict`` normalizes with the moving statistics, so they get
    gradients and the optimizer moves them. Other leaves are buffers. The
    inference stages call it under ``torch.inference_mode``, so their
    forwards record no autograd."""

    def __init__(self, model: NamedModel, params: dict, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model = model
        self.dtype = dtype
        tree = cast_params(torch_params(params), dtype)
        dev = resolve_device(device)
        self.layers = torch.nn.ModuleDict()
        for lname, leaves in tree.items():
            holder = torch.nn.Module()
            for k, t in leaves.items():
                if t.is_floating_point():
                    holder.register_parameter(
                        k, torch.nn.Parameter(t.to(dev)))
                else:
                    holder.register_buffer(k, t.to(dev))
            self.layers[lname] = holder

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def tree(self) -> dict:
        """The weights as ``NamedModel.apply`` takes them (the tensors in
        place for the call under :func:`tpudl_torch.train.
        with_compute_dtype`)."""
        return {lname: {**dict(holder.named_parameters()),
                        **dict(holder.named_buffers())}
                for lname, holder in self.layers.items()}

    def _precision(self):
        if self.dtype == torch.float32:
            return full_f32()
        return contextlib.nullcontext()

    def featurize(self, x):
        with self._precision():
            return self.model.featurize(self.tree(), x)

    def predict(self, x):
        with self._precision():
            return self.model.predict(self.tree(), x)


SUPPORTED_MODELS: dict[str, NamedModel] = {
    m.name: m
    for m in [
        NamedModel("InceptionV3", inception_v3.build, inception_v3.INPUT_SIZE,
                   inception_v3.FEATURE_DIM, inception_v3.PREPROCESS_MODE),
        NamedModel("Xception", xception.build, xception.INPUT_SIZE,
                   xception.FEATURE_DIM, xception.PREPROCESS_MODE),
        NamedModel("ResNet50", resnet.build, resnet.INPUT_SIZE,
                   resnet.FEATURE_DIM, resnet.PREPROCESS_MODE),
        NamedModel("VGG16", vgg.build_vgg16, vgg.INPUT_SIZE, vgg.FEATURE_DIM,
                   vgg.PREPROCESS_MODE),
        NamedModel("VGG19", vgg.build_vgg19, vgg.INPUT_SIZE, vgg.FEATURE_DIM,
                   vgg.PREPROCESS_MODE),
        NamedModel("MobileNetV2", mobilenet_v2.build,
                   mobilenet_v2.INPUT_SIZE, mobilenet_v2.FEATURE_DIM,
                   mobilenet_v2.PREPROCESS_MODE),
        NamedModel("DenseNet121", densenet.build, densenet.INPUT_SIZE,
                   densenet.FEATURE_DIM, densenet.PREPROCESS_MODE),
        NamedModel("ResNet101", resnet.build_resnet101, resnet.INPUT_SIZE,
                   resnet.FEATURE_DIM, resnet.PREPROCESS_MODE),
        NamedModel("ResNet152", resnet.build_resnet152, resnet.INPUT_SIZE,
                   resnet.FEATURE_DIM, resnet.PREPROCESS_MODE),
        NamedModel("EfficientNetB0", efficientnet.build,
                   efficientnet.INPUT_SIZE, efficientnet.FEATURE_DIM,
                   efficientnet.PREPROCESS_MODE),
    ]
}


def getKerasApplicationModel(name: str) -> NamedModel:
    if name not in SUPPORTED_MODELS:
        raise ValueError(
            f"unsupported model {name!r}; supported: {sorted(SUPPORTED_MODELS)}"
        )
    return SUPPORTED_MODELS[name]
