"""registerKerasImageUDF — a Keras model as a SQL UDF over images.

Port of ``tpudl/udf/keras_image_model.py``: the per-batch function is
image structs (packed on the host by ``_pack_image_structs``) →
``sp_image_converter("BGR", channel_order)`` → the optional
``preprocessor`` (a torch function on the ``(B, H, W, C)`` float32
batch) → the Keras graph (``TFInputGraph.fromKeras`` of a ``.keras`` or
legacy ``.h5`` model file, read by :mod:`tpudl_torch.ingest`) → flatten, on ``device``
(default ``"cuda"``) in f32, registered with
:mod:`tpudl_torch.udf.registry`:

    registerKerasImageUDF("inception_udf", "/path/model.keras")
    sql("SELECT inception_udf(image) AS preds FROM images", {"images": frame})

Each call is counted as makeGraphUDF's are (``udf.<name>.calls``,
``.rows``, ``.seconds``; tpudl counts none for this UDF). A live keras
model is refused (save it to ``.keras`` or ``.h5``). ``mesh`` (a local
:class:`~tpudl_torch.mesh.Mesh`) runs each query's batches over the
mesh's cards: the frozen graph places its weights on each card it meets.
"""

from __future__ import annotations

import torch

from tpudl_torch.device import full_f32
from tpudl_torch.image import ops as image_ops
from tpudl_torch.udf.registry import metered, register_udf

__all__ = ["registerKerasImageUDF"]


def registerKerasImageUDF(udf_name: str, keras_model_or_file,
                          preprocessor=None, *, channel_order: str = "RGB",
                          batch_size: int = 64, device="cuda",
                          mesh=None):
    from tpudl_torch.ingest import TFInputGraph
    from tpudl_torch.ml.tf_image import _pack_image_structs

    model_fn = TFInputGraph.fromKeras(keras_model_or_file).make_fn()

    def fused(batch):
        with full_f32():
            x = image_ops.sp_image_converter(batch, "BGR", channel_order)
            if preprocessor is not None:
                x = preprocessor(x)
            y = model_fn(x)
        if isinstance(y, tuple):
            y = y[0]
        return y.reshape(y.shape[0], -1)

    out_col = f"{udf_name}_out"

    @torch.inference_mode()
    def run(frame):
        return frame.map_batches(fused, ["image"], [out_col],
                                 batch_size=batch_size,
                                 pack=_pack_image_structs, device=device,
                                 mesh=mesh)

    return register_udf(udf_name, metered(udf_name, run), "image", out_col)
