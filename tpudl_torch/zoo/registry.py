"""Named pretrained-model registry — the zoo's public surface.

Port of ``tpudl/zoo/registry.py`` (``NamedModel``, ``cast_params``,
``SUPPORTED_MODELS``, ``getKerasApplicationModel``). All ten of tpudl's
names are listed, so a name is validated as tpudl validates it; only
InceptionV3 builds so far, and the other nine raise
``NotImplementedError`` when built (ROADMAP Queue 1, 'Image path').

``NamedModel.init`` returns tpudl's numpy param pytree (Keras names and
layout), bit-equal to tpudl's ``init`` for the same seed. ``apply``,
``featurize`` and ``predict`` take that tree in the port's layout
(:func:`tpudl_torch.zoo.convert.torch_params`) and an NHWC float batch, as
tpudl's do; inside, the model runs NCHW in channels_last memory (a view
of the NHWC batch, no copy). :class:`ImageModel` holds the converted
weights of one model as an ``nn.Module`` on one device in one dtype; in
float32 it runs its convolutions and products in full f32, never TF32
(:func:`full_f32`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from tpudl_torch.device import resolve_device
from tpudl_torch.zoo import inception_v3
from tpudl_torch.zoo.convert import torch_params
from tpudl_torch.zoo.core import Store
from tpudl_torch.zoo.preprocessing import preprocess_input

__all__ = ["NamedModel", "ImageModel", "SUPPORTED_MODELS",
           "getKerasApplicationModel", "cast_params", "full_f32"]


@contextlib.contextmanager
def full_f32():
    """Switch TF32 off for cuDNN convolutions and cuBLAS products while the
    block runs, and restore the process's settings after. PyTorch lets
    cuDNN run f32 convolutions in TF32 (10-bit mantissa) by default, so a
    float32 model would otherwise not compute in f32."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


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
    build_fn: Callable | None    # None: not ported yet
    input_size: tuple[int, int]
    feature_dim: int
    preprocess_mode: str
    classes: int = 1000

    def _build(self):
        if self.build_fn is None:
            raise NotImplementedError(
                f"{self.name} is not ported to tpudl_torch yet (ROADMAP "
                "Queue 1, 'Image path'); InceptionV3 is")
        return self.build_fn

    # -- params ----------------------------------------------------------
    def init(self, rng, *, image_size: tuple[int, int] | None = None,
             include_top: bool = True) -> dict:
        """Random-init param pytree (Keras initializers), numpy, Keras
        layout. ``rng`` is an int seed or a ``np.random.Generator``; the
        build runs on a meta tensor, so only the draws cost anything."""
        build = self._build()
        h, w = image_size or self.input_size
        gen = np.random.default_rng(rng) if isinstance(rng, int) else rng
        s = Store(rng=gen)
        build(s, torch.empty((1, 3, h, w), device="meta"),
              include_top=include_top, classes=self.classes)
        return s.params

    # -- forward (x: NHWC float) -----------------------------------------
    def apply(self, params: dict, x, *, include_top=True, pooling=None,
              train: bool = False):
        """Forward pass over preprocessed input ``x`` ``(B, H, W, C)``; a
        4-D result comes back NHWC. ``train=True`` returns ``(y,
        bn_updates)``."""
        build = self._build()
        s = Store(params=params, train=train)
        y = build(s, x.permute(0, 3, 1, 2), include_top=include_top,
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
        """Penultimate-layer features (the DeepImageFeaturizer vector)."""
        return self.apply(params, x, include_top=False, pooling="avg")

    def predict(self, params: dict, x):
        """Softmax class scores (the DeepImagePredictor path)."""
        return self.apply(params, x, include_top=True)


class ImageModel(torch.nn.Module):
    """One named model's weights on one device in one dtype: tpudl's param
    pytree converted once (OIHW kernels in channels_last, floating leaves
    cast as :func:`cast_params` casts them) and registered as buffers,
    ``layers.<keras layer>.<param>``."""

    def __init__(self, model: NamedModel, params: dict, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        model._build()
        self.model = model
        self.dtype = dtype
        tree = cast_params(torch_params(params), dtype)
        dev = resolve_device(device)
        self.layers = torch.nn.ModuleDict()
        for lname, leaves in tree.items():
            holder = torch.nn.Module()
            for k, t in leaves.items():
                holder.register_buffer(k, t.to(dev))
            self.layers[lname] = holder

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    def tree(self) -> dict:
        """The weights as ``NamedModel.apply`` takes them."""
        return {lname: dict(holder.named_buffers())
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


def _unported(name, input_size, feature_dim, mode):
    return NamedModel(name, None, input_size, feature_dim, mode)


SUPPORTED_MODELS: dict[str, NamedModel] = {
    m.name: m
    for m in [
        NamedModel("InceptionV3", inception_v3.build, inception_v3.INPUT_SIZE,
                   inception_v3.FEATURE_DIM, inception_v3.PREPROCESS_MODE),
        _unported("Xception", (299, 299), 2048, "tf"),
        _unported("ResNet50", (224, 224), 2048, "caffe"),
        _unported("VGG16", (224, 224), 4096, "caffe"),
        _unported("VGG19", (224, 224), 4096, "caffe"),
        _unported("MobileNetV2", (224, 224), 1280, "tf"),
        _unported("DenseNet121", (224, 224), 1024, "torch"),
        _unported("ResNet101", (224, 224), 2048, "caffe"),
        _unported("ResNet152", (224, 224), 2048, "caffe"),
        _unported("EfficientNetB0", (224, 224), 1280, "raw"),
    ]
}


def getKerasApplicationModel(name: str) -> NamedModel:
    if name not in SUPPORTED_MODELS:
        raise ValueError(
            f"unsupported model {name!r}; supported: {sorted(SUPPORTED_MODELS)}"
        )
    return SUPPORTED_MODELS[name]
