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
(``Transformer._cached_fn``). With the program store armed
(``TPUDL_COMPILE_AOT``) each batch dispatches through it, keyed across
processes by the function's ``aot_token``: a content hash of a
``TFInputGraph``'s config and weights (or GraphDef) taken on the host,
its tensor names, the channel order and the output mode (a plain torch
callable has no host identity: its signatures are recorded but not
restored in another process).
"""

from __future__ import annotations

import numpy as np
import torch

from tpudl_torch.device import full_f32, resolve_device
from tpudl_torch.image import imageIO
from tpudl_torch.image import ops as image_ops
from tpudl_torch.ml.params import (HasInputCol, HasOutputCol,
                                   HasOutputMode, Param, TypeConverters,
                                   keyword_only)
from tpudl_torch.ml.pipeline import Transformer

__all__ = ["ImageBatchWarmup", "TFImageTransformer"]


class ImageBatchWarmup:
    """Mixin: warm an image stage without reading a result.

    Requires ``_batch_fn()`` (the stage's per-batch function),
    ``batchSize``, ``device`` and ``mesh`` on the host class."""

    def warmup(self, height, width, nChannels=3, dtype=np.uint8):
        """Make the stage's first ``transform`` of (height, width,
        nChannels) images fast, reading no result to the host: loads the
        weights and wakes cuDNN. Returns ``self``.

        With the program store armed (``TPUDL_COMPILE_AOT``) this captures
        the exact program the executor's dispatch will hit, as tpudl's
        warm-up compiles it: the rung the batch pads to under
        ``TPUDL_COMPILE_BUCKETS`` (under a mesh, rounded up to the data
        axis and cut into one shard a card), and the fused graph of
        ``fuseSteps`` batches unless the batch size is no rung or the
        device cache disarms fusion. Otherwise it runs the per-batch
        function once on a synthetic batch of ``batchSize`` images on its
        device (under a mesh, one shard's rows on each of its cards) and
        discards the result."""
        import os

        from tpudl_torch.compile import store as _store
        from tpudl_torch.mesh import on_device

        fn = self._batch_fn()
        mesh = getattr(self, "mesh", None)
        if mesh is None:
            devices, multiple = [resolve_device(self.device)], 1
        else:
            devices, multiple = mesh.distinct_devices(), mesh.size
        killed = os.environ.get("TPUDL_FRAME_PREFETCH", "1") == "0"
        if _store.aot_enabled() and not killed:
            from tpudl_torch.compile.buckets import resolve_ladder
            from tpudl_torch.frame import frame as _frame

            store = _store.get_program_store()
            fuse = getattr(self, "fuseSteps", None)
            if fuse is None:
                fuse = _frame._env_int("TPUDL_FRAME_FUSE_STEPS", 1)
            dcache = getattr(self, "deviceCache", None)
            if dcache is None:
                dcache = os.environ.get("TPUDL_DATA_DEVICE_CACHE",
                                        "0") == "1"
            warm_fused = (int(fuse) > 1 and not dcache
                          and _frame.mesh_fuse_ok(self.batchSize, mesh))
            ladder = resolve_ladder(None)
            rows = int(self.batchSize)
            if ladder is not None:
                rows = ladder.pick(rows)
            rows = -(-rows // multiple) * multiple
            if rows != int(self.batchSize):
                warm_fused = False   # every full batch pads: no fusion
            for dev in devices:
                x = torch.zeros((rows // multiple, height, width, nChannels),
                                dtype=getattr(torch, np.dtype(dtype).name),
                                device=dev)
                with torch.inference_mode(), on_device(dev):
                    store.compile_signature(
                        fn, (x,), mesh=mesh,
                        bucketed=ladder is not None and mesh is None)
                    if warm_fused:
                        store.compile_signature(fn, (x,), mesh=mesh,
                                                micro=int(fuse),
                                                single=False)
            return self
        rows = -(-self.batchSize // multiple)
        for dev in devices:
            x = torch.from_numpy(np.zeros(
                (rows, height, width, nChannels), dtype)).to(dev)
            with torch.inference_mode(), on_device(dev):
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

    The data layer's ``wireCodec``, ``cacheDir`` and ``deviceCache`` pass
    to ``Frame.map_batches``; ``mesh`` runs the stage over its cards, one
    per-batch function a card (a callable ``graph`` is then called on each
    card's shard, so it must compute on its input's device).
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
        self.batchSize = int(kwargs.pop("batchSize", batchSize))
        self.device = kwargs.pop("device", device)
        self._set_pipeline_opts(kwargs)
        self._set(**kwargs)

    def _model_fn(self, device):
        from tpudl_torch.ingest import TFInputGraph
        from tpudl_torch.ml.tf_tensor import graph_batch_fn

        g = self.getOrDefault(self.graph)
        if isinstance(g, TFInputGraph):
            feeds = self._paramMap.get(self.inputTensor)
            fetches = self._paramMap.get(self.outputTensor)

            return graph_batch_fn(g, device,
                                  None if feeds is None else [feeds],
                                  None if fetches is None else [fetches])
        if callable(g):
            return g
        raise TypeError(f"graph param must be TFInputGraph or callable, got "
                        f"{type(g).__name__}")

    def _graph_identity(self) -> str | None:
        """A host-side content hash of the ``graph`` param: a
        ``TFInputGraph``'s config, weights, GraphDef and tensor names;
        None for anything else (a torch callable's weights sit on the
        card)."""
        from tpudl_torch.compile.store import content_token
        from tpudl_torch.ingest import TFInputGraph

        g = self.getOrDefault(self.graph)
        if not isinstance(g, TFInputGraph):
            return None
        return content_token((g.config, getattr(g, "_weights", None),
                              g.graph_def, g.input_names, g.output_names))

    def _batch_fn(self):
        order = self.getOrDefault(self.channelOrder)
        mode = self.getOutputMode()

        def build(device):
            model = self._model_fn(device)

            def fn(batch):
                with full_f32():
                    x = (image_ops.sp_image_converter(batch, "BGR", order)
                         if order != "L" else batch.to(torch.float32))
                    y = model(x)
                if isinstance(y, tuple):
                    y = y[0]
                return image_ops.flattener(y) if mode == "vector" else y

            ident = self._graph_identity()
            if ident is not None:
                fn.aot_token = (f"TFImageTransformer:{ident}:"
                                f"{self._paramMap.get(self.inputTensor)}:"
                                f"{self._paramMap.get(self.outputTensor)}:"
                                f"{order}:{mode}")
            return fn

        return self._device_fn(
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
