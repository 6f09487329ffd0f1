"""The port's ``Frame`` container, lazy columns and pipelined batch
executor."""

from tpudl_torch.frame.frame import Frame, LazyColumn, concat

__all__ = ["Frame", "LazyColumn", "concat"]
