"""The port's ``Frame`` container and serial batch executor."""

from tpudl_torch.frame.frame import Frame

__all__ = ["Frame"]
