"""Wire codecs: the host→device representation of prepared batches.

Copied from ``tpudl/data/codec.py`` (``CodecError`` and the ``WireCodec``
contract only; the image codecs and the plan machinery come with the
image path). A codec ``encode``s a packed numpy batch host-side into a
smaller wire form; ``prologue`` restores it on the device as the first
step of the batch's computation.
"""

from __future__ import annotations

import numpy as np

__all__ = ["CodecError", "WireCodec"]


class CodecError(ValueError):
    """A codec cannot represent this batch losslessly."""


class WireCodec:
    """One host→device wire representation. Subclasses implement
    ``encode`` (host, numpy → numpy), ``prologue`` (device, torch tensor
    → the tensor the model consumes) and ``key`` (a JSON-serialisable
    identity tuple)."""

    name = "abstract"

    def encode(self, arr: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def prologue(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def key(self) -> tuple:
        return (self.name,)

    def __repr__(self):
        return f"{type(self).__name__}({self.key()!r})"
