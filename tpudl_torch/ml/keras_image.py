"""KerasImageFileTransformer — a Keras model over image *files*.

Port of ``tpudl/ml/keras_image.py``: params ``inputCol`` (URI column),
``outputCol``, ``modelFile`` (a ``.keras`` or legacy ``.h5`` model file),
``imageLoader`` (URI → ndarray) and ``outputMode`` (``"vector"``: each
row flattened; ``"image"``: an image struct). The file is ingested with
``TFInputGraph.fromKeras`` and its per-batch function is built once per
``(file, mtime, mode, device)``, as tpudl's ``_cached_jit``; URIs load in
the executor's pack stage (in the prepare pool when the loader is marked
``thread_safe``, as ``createNativeImageLoader`` is), and the model runs
on ``device`` (default ``"cuda"``) in f32.

Refused by name: ``mesh`` (ROADMAP Queue 1, 'Training, rest'),
``cacheDir``, ``deviceCache``, a ``wireCodec`` given by name and uint8
loaders ('Data layer').
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpudl_torch.image import imageIO
from tpudl_torch.ml.image_params import CanLoadImage, _refuse_u8, \
    load_uri_batch
from tpudl_torch.ml.params import (EXECUTOR_KNOBS, HasInputCol, HasKerasModel,
                                   HasOutputCol, HasOutputMode, keyword_only,
                                   refuse_unported)
from tpudl_torch.ml.pipeline import Transformer

__all__ = ["KerasImageFileTransformer"]


class KerasImageFileTransformer(Transformer, HasInputCol, HasOutputCol,
                                HasKerasModel, HasOutputMode, CanLoadImage):
    @keyword_only
    def __init__(self, *, inputCol=None, outputCol=None, modelFile=None,
                 imageLoader=None, outputMode="vector", batchSize=64,
                 device="cuda", mesh=None, prefetchDepth=None,
                 prepareWorkers=None, fuseSteps=None, dispatchDepth=None,
                 wireCodec=None, cacheDir=None, deviceCache=None):
        super().__init__()
        self._setDefault(outputMode="vector")
        kwargs = dict(self._input_kwargs)
        refuse_unported(type(self).__name__, kwargs, EXECUTOR_KNOBS)
        self.batchSize = int(kwargs.pop("batchSize", batchSize))
        self.device = kwargs.pop("device", device)
        self._set_pipeline_opts(kwargs)
        self._set(**kwargs)

    def _batch_fn(self, model_file, mode):
        from tpudl_torch.ingest import TFInputGraph
        from tpudl_torch.ml.tf_tensor import graph_batch_fn

        def build():
            model = graph_batch_fn(TFInputGraph.fromKeras(model_file),
                                   self.device)

            def fn(batch):
                y = model(batch)
                return y.reshape(y.shape[0], -1) if mode == "vector" else y

            return fn

        return self._cached_fn(
            (model_file, os.path.getmtime(model_file), mode,
             str(self.device)), build)

    def _transform(self, frame):
        mode = self.getOutputMode()
        loader = self.getImageLoader()
        _refuse_u8(loader)

        def pack(sl: np.ndarray) -> np.ndarray:
            return load_uri_batch(loader, sl)

        # only a loader that declares itself thread-safe lets the prepare
        # pool run this pack for several batches at once
        pack.thread_safe = bool(getattr(loader, "thread_safe", False))
        out_col = self.getOutputCol()
        fn = self._batch_fn(self.getModelFile(), mode)
        with torch.inference_mode():
            out = frame.map_batches(
                fn, [self.getInputCol()], [out_col],
                batch_size=self.batchSize, pack=pack, device=self.device,
                **self._pipeline_opts())
        if mode == "image":
            structs = np.empty(len(out), dtype=object)
            structs[:] = [
                imageIO.imageArrayToStruct(np.asarray(a, dtype=np.float32))
                for a in out[out_col]]
            out = out.drop(out_col).with_column(out_col, structs)
        return out
