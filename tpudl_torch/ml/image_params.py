"""Image params: ``CanLoadImage`` and ``load_uri_batch``.

Port of ``tpudl/ml/image_params.py``: the user's URI → ndarray
``imageLoader`` and the load of a URI column into one stacked batch, the
glue ``KerasImageFileTransformer`` and ``KerasImageFileEstimator`` use.
Not ported yet, and refused: the sharded cache of the bulk load
(``cache_dir``; ROADMAP Queue 1, 'Data layer') and loaders that declare
raw uint8 output (their deferred normalize needs the ``U8Codec``, 'Data
layer').
"""

from __future__ import annotations

import numpy as np

from tpudl_torch.ml.params import Param, Params
from tpudl_torch.obs import metrics as _obs_metrics

__all__ = ["CanLoadImage", "load_uri_batch"]


def _refuse_u8(loader):
    if getattr(loader, "output_dtype", None) == "uint8":
        raise NotImplementedError(
            "an imageLoader with output_dtype='uint8' needs the u8 wire "
            "codec, which is not ported to tpudl_torch yet (ROADMAP Queue 1, "
            "'Data layer')")


class CanLoadImage(Params):
    imageLoader = Param(
        None, "imageLoader",
        "callable URI -> ndarray (H, W, C) float RGB, typically "
        "decode+resize+preprocess for the target model")

    def setImageLoader(self, value):
        if not callable(value):
            raise TypeError("imageLoader must be callable (URI -> ndarray)")
        return self.set(self.imageLoader, value)

    def getImageLoader(self):
        return self.getOrDefault(self.imageLoader)

    def loadImagesInternal(self, frame, inputCol: str,
                           cache_dir: str | None = None):
        """URI column → stacked float32 batch (N, H, W, C). Unloadable URIs
        raise."""
        if cache_dir:
            raise NotImplementedError(
                "loadImagesInternal(cache_dir=...) is not ported to "
                "tpudl_torch yet (ROADMAP Queue 1, 'Data layer')")
        return load_uri_batch(self.getImageLoader(), frame[inputCol])


# copied from tpudl/ml/image_params.py:load_uri_batch (float32 output)
def load_uri_batch(loader, uris) -> np.ndarray:
    """Apply ``loader`` to each URI and stack into one float32 batch. A
    loader with a ``batch_decode`` attribute (``createNativeImageLoader``)
    gets the whole batch in one call. ``imageio.uris_loaded`` counts the
    URIs."""
    _refuse_u8(loader)
    uris = list(uris)
    if uris:
        _obs_metrics.counter("imageio.uris_loaded").inc(len(uris))
    batched = getattr(loader, "batch_decode", None)
    if batched is not None:
        out = np.asarray(batched(uris)).astype(np.float32, copy=False)
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
        arrays.append(arr.astype(np.float32, copy=False))
    if not arrays:
        return np.zeros((0, 1, 1, 1), np.float32)
    shapes = {a.shape for a in arrays}
    if len(shapes) > 1:
        raise ValueError(
            f"imageLoader produced mixed shapes {sorted(shapes)}; the "
            "loader must resize to a fixed geometry")
    return np.stack(arrays)
