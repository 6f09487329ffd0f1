"""The port's ``Frame`` container, lazy columns, pipelined batch executor
and the tiny SQL layer (:func:`sql`) over registered UDFs."""

from tpudl_torch.frame.frame import Frame, LazyColumn, concat, null_mask
from tpudl_torch.frame.sql import sql

__all__ = ["Frame", "LazyColumn", "concat", "null_mask", "sql"]
