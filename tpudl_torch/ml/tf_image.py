"""Image-batch helpers of the image stages.

Port of the parts of ``tpudl/ml/tf_image.py`` that the named-image stages
use: ``_pack_image_structs`` (host side of the struct → tensor
conversion, with its refusal of mixed shapes) and ``ImageBatchWarmup``.
``TFImageTransformer`` needs model ingestion and is not ported yet
(ROADMAP Queue 1, 'The rest of the sparkdl surface').
"""

from __future__ import annotations

import numpy as np
import torch

from tpudl_torch.device import resolve_device
from tpudl_torch.image import imageIO

__all__ = ["ImageBatchWarmup"]


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
