"""TFTransformer — an ingested graph over tensor columns.

Port of ``tpudl/ml/tf_tensor.py``: params ``tfInputGraph`` (a
:class:`~tpudl_torch.ingest.TFInputGraph`), ``inputMapping`` {column →
input tensor name} and ``outputMapping`` {output tensor name → column};
the graph runs as one function per batch through ``Frame.map_batches``
with the executor knobs, on ``device`` (default ``"cuda"``), in f32
(``device.full_f32``: no TF32 products). A Keras graph has one input and
takes it in its ``InputLayer``'s dtype (integer ids stay integers); a
GraphDef, SavedModel or checkpoint graph may have several (one
``inputMapping`` column each), each cast to its
placeholder's dtype (a float64 graph runs in float64). Signature logical
names are accepted wherever tensor names are, as in tpudl.
``mesh`` runs the graph over the mesh's cards, one per-batch function a
card (a trainable graph's weights placed on each); like tpudl's, the
stage takes no data-layer knobs of its own, and ``Frame.map_batches``
reads ``TPUDL_WIRE_CODEC`` and ``TPUDL_DATA_*``.
"""

from __future__ import annotations

import torch

from tpudl_torch.device import full_f32, resolve_device
from tpudl_torch.ml.params import Param, TypeConverters, keyword_only
from tpudl_torch.ml.pipeline import Transformer

__all__ = ["TFTransformer", "graph_batch_fn", "function_batch_fn"]


def graph_batch_fn(gin, device, feeds=None, fetches=None):
    """The per-batch function of an ingested graph on ``device``: the
    graph's first fetch out, computed in f32. A Keras graph casts its feed
    to its input layer's dtype; a proto graph casts each feed to its
    placeholder's dtype."""
    fn = gin.make_fn(feeds, fetches)
    if gin.trainable:
        dev = resolve_device(device)
        params = {k: torch.as_tensor(v).to(dev) for k, v in gin.params.items()}
        model = lambda *xs: fn(params, *xs)  # noqa: E731
    else:
        model = fn
    dtypes = gin.input_dtypes if gin.graph_def is None else None

    def batch_fn(*xs):
        if dtypes is not None:
            xs = [x if x.dtype == d else x.to(d) for x, d in zip(xs, dtypes)]
        with full_f32():
            y = model(*xs)
        return y[0] if isinstance(y, tuple) else y

    return batch_fn


def function_batch_fn(fn):
    """A ``GraphFunction``'s callable as a per-batch function: its first
    output, computed in f32."""
    def batch_fn(*xs):
        with full_f32():
            y = fn(*xs)
        return y[0] if isinstance(y, (tuple, list)) else y

    return batch_fn


class TFTransformer(Transformer):
    tfInputGraph = Param(None, "tfInputGraph", "ingested TFInputGraph",
                         TypeConverters.toTFInputGraph)
    inputMapping = Param(None, "inputMapping", "{column -> input tensor name}",
                         TypeConverters.asColumnToTensorNameMap)
    outputMapping = Param(None, "outputMapping",
                          "{output tensor name -> column}",
                          TypeConverters.asTensorNameToColumnMap)

    @keyword_only
    def __init__(self, *, tfInputGraph=None, inputMapping=None,
                 outputMapping=None, batchSize=256, device="cuda", mesh=None,
                 prefetchDepth=None, prepareWorkers=None, fuseSteps=None,
                 dispatchDepth=None):
        super().__init__()
        kwargs = dict(self._input_kwargs)
        self.batchSize = int(kwargs.pop("batchSize", batchSize))
        self.device = kwargs.pop("device", device)
        self._set_pipeline_opts(kwargs)
        self._set(**kwargs)

    def setTfInputGraph(self, value):
        return self.set(self.tfInputGraph, value)

    def setInputMapping(self, value):
        return self.set(self.inputMapping, value)

    def setOutputMapping(self, value):
        return self.set(self.outputMapping, value)

    def _transform(self, frame):
        gin = self.getOrDefault(self.tfInputGraph)
        in_map = self.getOrDefault(self.inputMapping)    # col -> tensor
        out_map = self.getOrDefault(self.outputMapping)  # tensor -> col

        # copied from tpudl/ml/tf_tensor.py:TFTransformer._transform.resolve
        def resolve(tname, sig):
            if sig and tname.split(":")[0] in sig:
                return sig[tname.split(":")[0]]
            return tname

        feeds = [resolve(t, gin.input_tensor_name_from_signature)
                 for t in in_map.values()]
        fetches = [resolve(t, gin.output_tensor_name_from_signature)
                   for t in out_map.keys()]
        fn = self._device_fn(
            (gin, tuple(feeds), tuple(fetches), str(self.device)),
            lambda device: graph_batch_fn(gin, device, feeds, fetches))
        with torch.inference_mode():
            return frame.map_batches(fn, list(in_map), list(out_map.values()),
                                     batch_size=self.batchSize,
                                     device=self.device,
                                     **self._pipeline_opts())
