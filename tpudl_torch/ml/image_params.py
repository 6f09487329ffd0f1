"""Image params: ``CanLoadImage`` and ``load_uri_batch``.

Port of ``tpudl/ml/image_params.py``: the user's URI → ndarray
``imageLoader`` and the load of a URI column into one stacked batch, the
glue ``KerasImageFileTransformer`` and ``KerasImageFileEstimator`` use:
float32, or raw uint8 for a loader that declares it (its deferred
normalize is the u8 codec's prologue), and through the sharded cache
(:func:`~tpudl_torch.data.cached_uri_load`) when a cache directory is
given or ``TPUDL_DATA_CACHE_DIR`` names one.
"""

from __future__ import annotations

import numpy as np

from tpudl_torch.ml.params import Param, Params
from tpudl_torch.obs import metrics as _obs_metrics

__all__ = ["CanLoadImage", "load_uri_batch"]


class CanLoadImage(Params):
    imageLoader = Param(
        None, "imageLoader",
        "callable URI -> ndarray (H, W, C) float/uint8 RGB, typically "
        "decode+resize+preprocess for the target model")

    def setImageLoader(self, value):
        if not callable(value):
            raise TypeError("imageLoader must be callable (URI -> ndarray)")
        return self.set(self.imageLoader, value)

    def getImageLoader(self):
        return self.getOrDefault(self.imageLoader)

    def loadImagesInternal(self, frame, inputCol: str,
                           cache_dir: str | None = None):
        """URI column → stacked batch (N, H, W, C), float32 or the raw
        uint8 of a loader that declares ``output_dtype='uint8'``.
        Unloadable URIs raise. With ``cache_dir`` (default
        ``TPUDL_DATA_CACHE_DIR``) the load goes through the shard cache,
        so a repeat fit over the same files decodes nothing."""
        loader = self.getImageLoader()
        uris = frame[inputCol]
        if cache_dir is None:
            import os

            cache_dir = os.environ.get("TPUDL_DATA_CACHE_DIR") or None
        if cache_dir:
            from tpudl_torch.data import cached_uri_load

            return cached_uri_load(loader, uris, cache_dir)
        return load_uri_batch(loader, uris)


# copied from tpudl/ml/image_params.py:load_uri_batch
def load_uri_batch(loader, uris) -> np.ndarray:
    """Apply ``loader`` to each URI and stack into one batch: float32,
    unless the loader declares raw uint8 output (``loader.output_dtype ==
    'uint8'``), which is kept so the u8 wire codec ships 4× fewer bytes.
    A loader with a ``batch_decode`` attribute (``createNativeImageLoader``)
    gets the whole batch in one call. ``imageio.uris_loaded`` counts the
    URIs decoded here (a cached replay leaves it unchanged)."""
    uris = list(uris)
    if uris:
        _obs_metrics.counter("imageio.uris_loaded").inc(len(uris))
    keep_u8 = getattr(loader, "output_dtype", None) == "uint8"
    batched = getattr(loader, "batch_decode", None)
    if batched is not None:
        out = np.asarray(batched(uris))
        if not (keep_u8 and out.dtype == np.uint8):
            out = out.astype(np.float32, copy=False)
        if out.ndim != 4:
            raise ValueError(
                f"batch_decode returned shape {out.shape}; expected "
                "(N, H, W, C)")
        return out
    arrays = []
    for uri in uris:
        arr = np.asarray(loader(uri))
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.ndim != 3:
            raise ValueError(
                f"imageLoader returned shape {arr.shape} for {uri!r}; "
                "expected (H, W, C)")
        if not (keep_u8 and arr.dtype == np.uint8):
            arr = arr.astype(np.float32, copy=False)
        arrays.append(arr)
    if not arrays:
        return np.zeros((0, 1, 1, 1), np.uint8 if keep_u8 else np.float32)
    shapes = {a.shape for a in arrays}
    if len(shapes) > 1:
        raise ValueError(
            f"imageLoader produced mixed shapes {sorted(shapes)}; the "
            "loader must resize to a fixed geometry")
    return np.stack(arrays)
