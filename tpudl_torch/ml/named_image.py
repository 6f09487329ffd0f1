"""DeepImageFeaturizer / DeepImagePredictor — the named image models.

Port of ``tpudl/ml/named_image.py`` (``load_named_params``,
``_NamedImageTransformer``, ``DeepImageFeaturizer``,
``DeepImagePredictor``), with tpudl's constructor names plus ``device=``
(default ``"cuda"``). Each batch runs one function on the device, as
tpudl's one jitted program: packed uint8 BGR batch → float32 → RGB →
antialiased resize to the model's geometry (``image.ops.to_model_input``)
→ ``preprocess`` in f32 → cast to ``computeDtype`` → ``featurize`` or
``predict`` (:class:`~tpudl_torch.zoo.registry.ImageModel`, convolutions
on cuDNN) → float32 rows. Every name of the registry runs, each at its
own input size; a featurizer row is the model's ``feature_dim`` wide
(the post-ReLU ``fc2`` of VGG16/19, the pooled map of the others) and a
predictor row holds 1000 class scores.

Weights: ``"random"`` is ``init(0)``; ``"imagenet"`` reads
``$TPUDL_WEIGHTS_DIR/<model>.npz`` and nothing else (the port never
downloads); a path ending in ``.npz`` is read as it is; any other path
is a Keras model file of the named model (``.keras`` or a legacy ``.h5``,
read by ``zoo.convert.params_from_keras`` without keras, as tpudl reads
it with keras). The stage loads the weights onto its device once and
reuses them while the model, weights (a file's mtime too), dtype and
device stay the same.

The executor knobs ``prefetchDepth``, ``prepareWorkers``, ``fuseSteps``
and ``dispatchDepth``, and the data layer's ``wireCodec`` (an instance or
a name), ``cacheDir`` and ``deviceCache``, pass to ``Frame.map_batches``
(None: its ``TPUDL_FRAME_*``, ``TPUDL_WIRE_CODEC`` and ``TPUDL_DATA_*``
defaults). The per-batch function is built once per loaded model, so
that a fused CUDA graph cached on it serves every later ``transform``.

With the program store armed (``TPUDL_COMPILE_AOT``) each batch dispatches
through it (one CUDA graph a batch shape; ``warmup`` captures the
executor's key ahead of traffic), keyed across processes by the per-batch
function's ``aot_token``: the stage, the model name, the weights' host
identity (``init(0)`` for ``"random"``, else the file's path, size and
mtime), ``computeDtype`` and the BGR→RGB channel order.

``mesh`` (a local :class:`~tpudl_torch.mesh.Mesh`) runs the stage
data-parallel over the mesh's cards: the weights load on its first card
and are replicated to the others once (:func:`tpudl_torch.mesh.
replicate`, tpudl's replicated placement), and each card's shard of a
batch runs on that card's replica; ``device`` is then unused.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpudl_torch.image import ops as image_ops
from tpudl_torch.ml.params import (HasInputCol, HasOutputCol, Param,
                                   TypeConverters, keyword_only)
from tpudl_torch.ml.pipeline import Transformer
from tpudl_torch.ml.tf_image import ImageBatchWarmup, _pack_image_structs
from tpudl_torch.zoo.convert import load_params_npz, params_from_keras
from tpudl_torch.zoo.preprocessing import decode_predictions
from tpudl_torch.zoo.registry import (SUPPORTED_MODELS, ImageModel,
                                      getKerasApplicationModel)

__all__ = ["DeepImageFeaturizer", "DeepImagePredictor", "load_named_params"]

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float16": torch.float16}
_STAGE_ATTRS = ("weights", "batchSize", "computeDtype", "device")


def load_named_params(model_name: str, weights: str = "random") -> dict:
    """A named model's param pytree (numpy, Keras names and layout)."""
    model = getKerasApplicationModel(model_name)
    if weights == "random":
        return model.init(0)
    if weights == "imagenet":
        wdir = os.environ.get("TPUDL_WEIGHTS_DIR")
        art = os.path.join(wdir, f"{model_name}.npz") if wdir else None
        if art and os.path.exists(art):
            return load_params_npz(art)
        raise RuntimeError(
            f"imagenet weights for {model_name} need the offline artifact "
            f"{art or '$TPUDL_WEIGHTS_DIR/' + model_name + '.npz'!r} "
            "(tpudl.zoo.convert.save_named_params writes it on a host with "
            "keras); tpudl_torch never downloads weights")
    if weights.endswith(".npz"):
        # an explicitly named artifact is the user vouching for the file
        return load_params_npz(weights, allow_legacy_pickle=True)
    # a Keras model file (.keras or .h5) of the named model
    return params_from_keras(weights)


def _check_compute_dtype(value: str) -> str:
    if value not in _COMPUTE_DTYPES:
        raise ValueError(f"computeDtype must be one of "
                         f"{tuple(_COMPUTE_DTYPES)}, got {value!r}")
    return value


class _NamedImageTransformer(ImageBatchWarmup, Transformer, HasInputCol,
                             HasOutputCol):
    """Shared engine: packs the image column and runs one function per
    batch (see the module docstring)."""

    modelName = Param(None, "modelName", "named model from the zoo registry",
                      TypeConverters.supportedNameConverter(SUPPORTED_MODELS))

    def setModelName(self, value):
        return self.set(self.modelName, value)

    def getModelName(self):
        return self.getOrDefault(self.modelName)

    def _init_stage(self, weights, batchSize, computeDtype, device):
        kwargs = dict(self._input_kwargs)
        self._set_pipeline_opts(kwargs)
        self.weights = weights
        self.batchSize = int(batchSize)
        self.computeDtype = _check_compute_dtype(computeDtype)
        self.device = device
        for k in _STAGE_ATTRS:
            kwargs.pop(k, None)
        self._set(**kwargs)
        self._loaded = None  # (key, ImageModel) of the last load

    def _head(self, net: ImageModel):  # pragma: no cover - abstract
        raise NotImplementedError

    def _net_key(self) -> tuple:
        key = (self.getModelName(), self.weights, self.computeDtype,
               str(self._home_device()))
        if self.weights not in ("random", "imagenet"):
            # a weights file may be rewritten between calls
            key += (os.path.getmtime(self.weights),)
        return key

    def _weights_id(self) -> str | None:
        """The weights' identity taken on the host: ``init(0)``, or the
        file's absolute path, size and mtime (None if it cannot be read)."""
        if self.weights == "random":
            return "init0"
        path = self.weights
        if self.weights == "imagenet":
            path = os.path.join(os.environ.get("TPUDL_WEIGHTS_DIR", ""),
                                f"{self.getModelName()}.npz")
        try:
            st = os.stat(path)
        except OSError:
            return None
        return f"{os.path.abspath(path)}:{st.st_size}:{st.st_mtime_ns}"

    def _net(self) -> ImageModel:
        name = self.getModelName()
        key = self._net_key()
        if self._loaded is None or self._loaded[0] != key:
            net = ImageModel(getKerasApplicationModel(name),
                             load_named_params(name, self.weights),
                             device=self._home_device(),
                             dtype=_COMPUTE_DTYPES[self.computeDtype])
            self._loaded = (key, net)
        return self._loaded[1]

    def _batch_fn(self):
        """The per-batch function: uint8 BGR (B, H, W, C) on the device →
        float32 model outputs; built once per loaded model (under a mesh,
        once a card, over that card's replica)."""
        def build(device):
            net = self._net()
            if self.mesh is not None:
                from tpudl_torch import mesh as M

                net = M.replicate(net, self.mesh)[torch.device(device)]
            model = net.model
            h, w = model.input_size
            head = self._head(net)

            def fn(batch):
                x = image_ops.to_model_input(batch, h, w, "BGR", "RGB")
                x = model.preprocess(x)
                return head(x.to(net.dtype)).to(torch.float32)

            wid = self._weights_id()
            if wid is not None:
                fn.aot_token = (f"{type(self).__name__}:{self.getModelName()}"
                                f":{wid}:{self.computeDtype}:BGR>RGB")
            return fn

        return self._device_fn(self._net_key(), build)

    def _apply_batches(self, frame, out_col):
        fn = self._batch_fn()
        with torch.inference_mode():
            return frame.map_batches(
                fn, [self.getInputCol()], [out_col],
                batch_size=self.batchSize, pack=_pack_image_structs,
                device=self.device, **self._pipeline_opts())


class DeepImageFeaturizer(_NamedImageTransformer):
    """Penultimate-layer feature vectors for transfer learning."""

    @keyword_only
    def __init__(self, *, inputCol=None, outputCol=None, modelName=None,
                 weights="random", batchSize=64, computeDtype="float32",
                 device="cuda", mesh=None, prefetchDepth=None,
                 prepareWorkers=None, fuseSteps=None, dispatchDepth=None,
                 wireCodec=None, cacheDir=None, deviceCache=None):
        super().__init__()
        self._init_stage(weights, batchSize, computeDtype, device)

    def _head(self, net):
        return net.featurize

    def _transform(self, frame):
        return self._apply_batches(frame, self.getOutputCol())


class DeepImagePredictor(_NamedImageTransformer):
    """ImageNet class scores, optionally decoded to (wnid, label, score)
    topK rows."""

    decodePredictions = Param(None, "decodePredictions",
                              "decode scores to (wnid,label,score) topK",
                              TypeConverters.toBoolean)
    topK = Param(None, "topK", "how many predictions to keep",
                 TypeConverters.toInt)

    @keyword_only
    def __init__(self, *, inputCol=None, outputCol=None, modelName=None,
                 decodePredictions=False, topK=5, weights="random",
                 batchSize=64, computeDtype="float32", device="cuda",
                 mesh=None, prefetchDepth=None, prepareWorkers=None,
                 fuseSteps=None, dispatchDepth=None, wireCodec=None,
                 cacheDir=None, deviceCache=None):
        super().__init__()
        self._setDefault(decodePredictions=False, topK=5)
        self._init_stage(weights, batchSize, computeDtype, device)

    def _head(self, net):
        return net.predict

    def _transform(self, frame):
        out_col = self.getOutputCol()
        out = self._apply_batches(frame, out_col)
        if self.getOrDefault(self.decodePredictions):
            scores = np.stack(list(out[out_col]))
            decoded = decode_predictions(scores,
                                         top=self.getOrDefault(self.topK))
            col = np.empty(len(decoded), dtype=object)  # rows of tuples
            col[:] = decoded
            out = out.drop(out_col).with_column(out_col, col)
        return out
