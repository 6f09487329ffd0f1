"""Shape buckets for the port (``buckets``)."""

from tpudl_torch.compile.buckets import (DEFAULT_SPEC, BucketLadder,
                                         count_pad_rows, pad_to,
                                         resolve_ladder)

__all__ = ["BucketLadder", "resolve_ladder", "DEFAULT_SPEC", "pad_to",
           "count_pad_rows"]
