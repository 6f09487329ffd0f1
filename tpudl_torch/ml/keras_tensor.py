"""KerasTransformer — a saved Keras model over an array column.

Port of ``tpudl/ml/keras_tensor.py``: params ``modelFile`` (a ``.keras``
or legacy ``.h5`` model file), ``inputCol`` (array column) and ``outputCol``; the file is
ingested (``TFInputGraph.fromKeras``) and run by a
:class:`~tpudl_torch.ml.tf_tensor.TFTransformer`, as tpudl delegates.
The ingested graph and its per-batch function are kept while the file's
path and mtime stay the same. ``device`` defaults to ``"cuda"``; ``mesh``
passes to the delegate, which runs over the mesh's cards.
"""

from __future__ import annotations

import os

from tpudl_torch.ml.params import (HasInputCol, HasKerasModel, HasOutputCol,
                                   keyword_only)
from tpudl_torch.ml.pipeline import Transformer

__all__ = ["KerasTransformer"]


class KerasTransformer(Transformer, HasInputCol, HasOutputCol,
                       HasKerasModel):
    @keyword_only
    def __init__(self, *, inputCol=None, outputCol=None, modelFile=None,
                 batchSize=256, device="cuda", mesh=None, prefetchDepth=None,
                 prepareWorkers=None, fuseSteps=None, dispatchDepth=None):
        super().__init__()
        kwargs = dict(self._input_kwargs)
        self.batchSize = int(kwargs.pop("batchSize", batchSize))
        self.device = kwargs.pop("device", device)
        self._set_pipeline_opts(kwargs)
        self._set(**kwargs)
        self._delegate = None   # (key, TFTransformer) of the loaded file

    def _transform(self, frame):
        from tpudl_torch.ingest import TFInputGraph
        from tpudl_torch.ml.tf_tensor import TFTransformer

        path = self.getModelFile()
        in_col, out_col = self.getInputCol(), self.getOutputCol()
        key = (path, os.path.getmtime(path), in_col, out_col,
               str(self.device), self.batchSize,
               tuple(sorted(self._pipeline_opts().items())))
        if self._delegate is None or self._delegate[0] != key:
            self._delegate = None    # the old graph goes first
            gin = TFInputGraph.fromKeras(path)
            self._delegate = (key, TFTransformer(
                tfInputGraph=gin,
                inputMapping={in_col: gin.input_names[0]},
                outputMapping={gin.output_names[0]: out_col},
                batchSize=self.batchSize, device=self.device,
                mesh=self.mesh, prefetchDepth=self.prefetchDepth,
                prepareWorkers=self.prepareWorkers,
                fuseSteps=self.fuseSteps,
                dispatchDepth=self.dispatchDepth))
        return self._delegate[1].transform(frame)
