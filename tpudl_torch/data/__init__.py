"""tpudl_torch.data — the wire-aware dataset layer of the port.

Port of ``tpudl/data`` (DATA.md is its operator guide), under the frame
executor, every stage and the estimator:

- :mod:`tpudl_torch.data.codec` — wire codecs (``u8``: uint8 pixels +
  scale/offset, 4× fewer bytes; ``bf16``: 2×; ``identity``; ``tokens``;
  ``auto``) with a restoring prologue in torch on the batch's device;
- :mod:`tpudl_torch.data.shards` — the sharded prepared-batch cache:
  checksummed, memory-mapped ``.npy`` shards under an atomic JSON
  manifest, in tpudl's format, so one directory serves both packages;
- :mod:`tpudl_torch.data.device_cache` — prepared batches resident in the
  card's memory under a budget (``TPUDL_DATA_HBM_BUDGET_MB``): epochs ≥ 2
  ship zero wire bytes;
- :mod:`tpudl_torch.data.dataset` — the ``Dataset`` facade (epoch replay)
  and :func:`cached_uri_load` (the estimator's bulk-load cache).
"""

from __future__ import annotations

from tpudl_torch.data.codec import (BF16Codec, CodecError, CodecPlan,
                                    IdentityCodec, U8Codec, WireCodec,
                                    codec_from_key, probe_wire_mbps,
                                    resolve_codec)
from tpudl_torch.data.dataset import Dataset, cached_uri_load
from tpudl_torch.data.device_cache import (DeviceBatchCache,
                                           get_device_cache,
                                           reset_device_cache)
from tpudl_torch.data.shards import ShardCache, ShardCorruption, cache_key

__all__ = [
    # codecs
    "WireCodec", "IdentityCodec", "U8Codec", "BF16Codec", "CodecError",
    "CodecPlan", "resolve_codec", "codec_from_key", "probe_wire_mbps",
    # shard cache
    "ShardCache", "ShardCorruption", "cache_key",
    # device cache
    "DeviceBatchCache", "get_device_cache", "reset_device_cache",
    # facade
    "Dataset", "cached_uri_load",
]
