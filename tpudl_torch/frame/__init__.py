"""The port's ``Frame`` container, lazy columns and serial batch executor."""

from tpudl_torch.frame.frame import Frame, LazyColumn

__all__ = ["Frame", "LazyColumn"]
