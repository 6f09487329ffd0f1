"""Data layer of the port: the wire-codec contract (``codec``)."""

from tpudl_torch.data.codec import CodecError, WireCodec

__all__ = ["CodecError", "WireCodec"]
