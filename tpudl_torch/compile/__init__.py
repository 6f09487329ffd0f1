"""Shape buckets for the port (``buckets``)."""

from tpudl_torch.compile.buckets import (DEFAULT_SPEC, BucketLadder,
                                         resolve_ladder)

__all__ = ["BucketLadder", "resolve_ladder", "DEFAULT_SPEC"]
