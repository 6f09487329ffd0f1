"""TFImageTransformer — a model graph over an image-struct column.

Port of ``tpudl/ml/tf_image.py``: ``TFImageTransformer``, and the parts
the named-image stages share, ``_pack_image_structs`` (host side of the
struct → tensor conversion, with its refusal of mixed shapes) and
``ImageBatchWarmup``. The transformer's per-batch function is tpudl's
composition, ``sp_image_converter`` → the graph → flatten (``outputMode=
"vector"``) or the image itself (``"image"``: rows come back as image
structs), run by ``Frame.map_batches`` on ``device`` (default
``"cuda"``) in f32 (``device.full_f32``). It is built once per ``(graph,
inputTensor, outputTensor, channelOrder, outputMode, device)``
(``Transformer._cached_fn``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpudl_torch.device import full_f32, resolve_device
from tpudl_torch.image import imageIO
from tpudl_torch.image import ops as image_ops
from tpudl_torch.ml.params import (EXECUTOR_KNOBS, HasInputCol, HasOutputCol,
                                   HasOutputMode, Param, TypeConverters,
                                   keyword_only, refuse_unported)
from tpudl_torch.ml.pipeline import Transformer

__all__ = ["ImageBatchWarmup", "TFImageTransformer"]


class ImageBatchWarmup:
    """Mixin: warm an image stage without reading a result.

    Requires ``_batch_fn()`` (the stage's per-batch function),
    ``batchSize`` and ``device`` on the host class."""

    def warmup(self, height, width, nChannels=3, dtype=np.uint8):
        """Run the stage's per-batch function once on a synthetic batch of
        ``batchSize`` images of (height, width, nChannels) on its device
        and discard the result: loads the weights and wakes cuDNN. tpudl's
        AOT program store has no counterpart yet (ROADMAP Queue 1,
        'Compile'). Returns ``self``."""
        fn = self._batch_fn()
        x = torch.from_numpy(np.zeros(
            (self.batchSize, height, width, nChannels), dtype)).to(
                resolve_device(self.device))
        with torch.inference_mode():
            fn(x)
        return self


class TFImageTransformer(ImageBatchWarmup, Transformer, HasInputCol,
                         HasOutputCol, HasOutputMode):
    """Applies a model to an image column (tpudl's params and spelling).

    - ``graph``: a :class:`~tpudl_torch.ingest.TFInputGraph` (frozen or
      trainable) **or** any torch callable on a ``(B, H, W, C)`` float32
      batch.
    - ``inputTensor``/``outputTensor``: tensor names of a
      ``TFInputGraph`` of any route (an output of a model with several);
      default its declared input and first output.
    - ``channelOrder``: what the model expects: 'RGB', 'BGR' or 'L'.
    - ``outputMode``: 'vector' (a flattened float32 vector a row) or
      'image' (an image struct a row).

    ``mesh`` (ROADMAP Queue 1, 'Training, rest'), ``cacheDir``,
    ``deviceCache`` and a ``wireCodec`` given by name ('Data layer')
    raise.
    """

    graph = Param(None, "graph", "TFInputGraph or torch-callable model")
    inputTensor = Param(None, "inputTensor", "input tensor name",
                        TypeConverters.toString)
    outputTensor = Param(None, "outputTensor", "output tensor name",
                         TypeConverters.toString)
    channelOrder = Param(None, "channelOrder",
                         "channel order the model expects: RGB, BGR or L",
                         TypeConverters.toChannelOrder)

    @keyword_only
    def __init__(self, *, inputCol=None, outputCol=None, graph=None,
                 inputTensor=None, outputTensor=None, channelOrder="RGB",
                 outputMode="vector", batchSize=64, device="cuda", mesh=None,
                 prefetchDepth=None, prepareWorkers=None, fuseSteps=None,
                 dispatchDepth=None, wireCodec=None, cacheDir=None,
                 deviceCache=None):
        super().__init__()
        self._setDefault(channelOrder="RGB", outputMode="vector")
        kwargs = dict(self._input_kwargs)
        refuse_unported(type(self).__name__, kwargs, EXECUTOR_KNOBS)
        self.batchSize = int(kwargs.pop("batchSize", batchSize))
        self.device = kwargs.pop("device", device)
        self._set_pipeline_opts(kwargs)
        self._set(**kwargs)

    def _model_fn(self):
        from tpudl_torch.ingest import TFInputGraph
        from tpudl_torch.ml.tf_tensor import graph_batch_fn

        g = self.getOrDefault(self.graph)
        if isinstance(g, TFInputGraph):
            feeds = self._paramMap.get(self.inputTensor)
            fetches = self._paramMap.get(self.outputTensor)

            return graph_batch_fn(g, self.device,
                                  None if feeds is None else [feeds],
                                  None if fetches is None else [fetches])
        if callable(g):
            return g
        raise TypeError(f"graph param must be TFInputGraph or callable, got "
                        f"{type(g).__name__}")

    def _batch_fn(self):
        order = self.getOrDefault(self.channelOrder)
        mode = self.getOutputMode()

        def build():
            model = self._model_fn()

            def fn(batch):
                with full_f32():
                    x = (image_ops.sp_image_converter(batch, "BGR", order)
                         if order != "L" else batch.to(torch.float32))
                    y = model(x)
                if isinstance(y, tuple):
                    y = y[0]
                return image_ops.flattener(y) if mode == "vector" else y

            return fn

        return self._cached_fn(
            (self.getOrDefault(self.graph),
             self._paramMap.get(self.inputTensor),
             self._paramMap.get(self.outputTensor), order, mode,
             str(self.device)), build)

    def _transform(self, frame):
        out_col = self.getOutputCol()
        with torch.inference_mode():
            out = frame.map_batches(
                self._batch_fn(), [self.getInputCol()], [out_col],
                batch_size=self.batchSize, pack=_pack_image_structs,
                device=self.device, **self._pipeline_opts())
        if self.getOutputMode() == "image":
            structs = np.empty(len(out), dtype=object)
            structs[:] = [
                imageIO.imageArrayToStruct(np.asarray(a, dtype=np.float32))
                for a in out[out_col]]
            out = out.drop(out_col).with_column(out_col, structs)
        return out


# copied from tpudl/ml/tf_image.py:_pack_image_structs
def _pack_image_structs(sl: np.ndarray) -> np.ndarray:
    """image-struct column slice → stacked (B, H, W, C) batch."""
    arrays = []
    for row in sl:
        if row is None:
            raise ValueError("null image row; dropna() the frame first")
        if isinstance(row, dict):
            arrays.append(imageIO.imageStructToArray(row, copy=False))
        else:
            arrays.append(np.asarray(row))
    shapes = {a.shape for a in arrays}
    if len(shapes) > 1:
        raise ValueError(
            f"mixed image shapes {sorted(shapes)} in one column; resize "
            "first (imageIO.resizeImage / createResizeImageUDF)")
    return np.stack(arrays)


# stateless: the executor's prepare pool may pack several batches at once
_pack_image_structs.thread_safe = True
_pack_image_structs.cache_token = "image_structs_v1"
