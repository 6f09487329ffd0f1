"""Models as SQL UDFs: the registry (:mod:`~tpudl_torch.udf.registry`),
``makeGraphUDF`` over an ingested graph, ``registerKerasImageUDF`` over a
``.keras`` image model and ``register_text_udfs`` over the LM stages.
Port of ``tpudl/udf``; call them from :func:`tpudl_torch.frame.sql`."""

from tpudl_torch.udf import registry  # noqa: F401
from tpudl_torch.udf.keras_image_model import registerKerasImageUDF
from tpudl_torch.udf.registry import (UDF, get_udf, list_udfs, register_udf,
                                      unregister_udf)
from tpudl_torch.udf.tensorframes_udf import makeGraphUDF
from tpudl_torch.udf.text_udf import register_text_udfs

__all__ = ["UDF", "register_udf", "get_udf", "list_udfs", "unregister_udf",
           "makeGraphUDF", "registerKerasImageUDF", "register_text_udfs"]
