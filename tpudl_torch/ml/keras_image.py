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

The data layer's knobs pass to ``Frame.map_batches`` as tpudl's do: a
loader that declares raw uint8 output installs ``U8Codec(scale=
loader.wire_scale)``, whose prologue applies the deferred normalize on
the card (a ``wireCodec`` that would skip it is refused); with
``cacheDir`` the shards are keyed on the files' paths, sizes and mtimes;
``deviceCache`` keeps the prepared batches on the card. ``mesh`` runs the
model over the mesh's cards, the file ingested once and its weights
placed on each card.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpudl_torch.image import imageIO
from tpudl_torch.ml.image_params import CanLoadImage, load_uri_batch
from tpudl_torch.ml.params import (HasInputCol, HasKerasModel, HasOutputCol,
                                   HasOutputMode, keyword_only)
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
        self.batchSize = int(kwargs.pop("batchSize", batchSize))
        self.device = kwargs.pop("device", device)
        self._set_pipeline_opts(kwargs)
        self._set(**kwargs)

    def _batch_fn(self, model_file, mode):
        from tpudl_torch.ingest import TFInputGraph
        from tpudl_torch.ml.tf_tensor import graph_batch_fn

        gin = []    # the file, ingested once for every card

        def build(device):
            if not gin:
                gin.append(TFInputGraph.fromKeras(model_file))
            model = graph_batch_fn(gin[0], device)

            def fn(batch):
                y = model(batch)
                return y.reshape(y.shape[0], -1) if mode == "vector" else y

            return fn

        return self._device_fn(
            (model_file, os.path.getmtime(model_file), mode,
             str(self.device)), build)

    def _transform(self, frame):
        from tpudl_torch.data import U8Codec
        from tpudl_torch.data.dataset import _loader_token
        from tpudl_torch.image.imageIO import _uri_fingerprint

        mode = self.getOutputMode()
        loader = self.getImageLoader()

        def pack(sl: np.ndarray) -> np.ndarray:
            return load_uri_batch(loader, sl)

        # the pack's cache identity is the loader's (geometry, scale,
        # dtype): another loader over the same URIs re-keys the cache
        pack.cache_token = "uri_pack:" + _loader_token(loader)
        # only a loader that declares itself thread-safe lets the prepare
        # pool run this pack for several batches at once
        pack.thread_safe = bool(getattr(loader, "thread_safe", False))
        out_col = self.getOutputCol()
        fn = self._batch_fn(self.getModelFile(), mode)
        opts = self._pipeline_opts()
        if getattr(loader, "output_dtype", None) == "uint8":
            # a raw-uint8 loader defers its `* scale` normalize to the
            # card: the u8 codec's prologue applies it. A codec that
            # cannot carry it (identity, bf16, a bare 'u8'/'auto' that
            # would infer scale 1) would feed the model 255×-too-large
            # pixels; a U8Codec instance is the user owning the scale
            if opts.get("wire_codec") is None:
                opts["wire_codec"] = U8Codec(
                    scale=getattr(loader, "wire_scale", 1.0),
                    offset=getattr(loader, "wire_offset", 0.0))
            elif not isinstance(opts["wire_codec"], U8Codec):
                raise ValueError(
                    f"imageLoader defers its normalize (output_dtype="
                    f"'uint8', wire_scale={getattr(loader, 'wire_scale', 1.0)!r}) "
                    f"but wireCodec={opts['wire_codec']!r} would skip it; "
                    "drop wireCodec (the matching u8 codec installs "
                    "automatically) or pass U8Codec(scale=...) explicitly")
        dc_on = (bool(opts["device_cache"])
                 if opts.get("device_cache") is not None
                 else os.environ.get("TPUDL_DATA_DEVICE_CACHE", "0") == "1")
        if (opts.get("cache_dir") or os.environ.get("TPUDL_DATA_CACHE_DIR")
                or dc_on):
            # URI columns name files the frame fingerprint cannot see
            # into: key the shard cache AND the device cache on
            # path+size+mtime, so a file rewritten in place re-keys
            # (tpudl keys residency on the URI strings alone)
            opts["cache_key"] = _uri_fingerprint(frame[self.getInputCol()])
        with torch.inference_mode():
            out = frame.map_batches(
                fn, [self.getInputCol()], [out_col],
                batch_size=self.batchSize, pack=pack, device=self.device,
                **opts)
        if mode == "image":
            structs = np.empty(len(out), dtype=object)
            structs[:] = [
                imageIO.imageArrayToStruct(np.asarray(a, dtype=np.float32))
                for a in out[out_col]]
            out = out.drop(out_col).with_column(out_col, structs)
        return out
