"""tpudl_torch.compile — the port's compile-cost subsystem (tpudl's
``tpudl.compile``, COMPILE.md's three knobs).

The port's fixed costs are not XLA's: the ``nvcc`` build of the hand
kernels, CUDA-graph captures and the eager host loop. Three tiers, with
tpudl's knobs, precedence, counters and report fields:

1. the **kernel-build cache** (:func:`enable_compilation_cache`,
   ``TPUDL_COMPILE_CACHE_DIR``): where the kernel libraries persist, so a
   process that finds them loads instead of running ``nvcc``;
2. the **program store** (:class:`ProgramStore`, ``TPUDL_COMPILE_AOT``):
   CUDA graphs keyed by function fingerprint + argument signature, and a
   manifest of those signatures that a fresh process captures ahead of
   traffic (:func:`warm_start`);
3. **shape buckets** (:class:`BucketLadder`, ``TPUDL_COMPILE_BUCKETS``):
   ragged sizes snap to O(log n) rungs, so the store has a bounded
   signature set to be warm for.

``Frame.map_batches(aot=)`` consults the store at dispatch;
``ImageBatchWarmup.warmup``, ``TinyCausalLM.precompile_generate`` and
``precompile_serve`` capture signatures ahead of traffic.
"""

from tpudl_torch.compile.buckets import (BucketLadder, count_pad_rows, pad_to,
                                         resolve_ladder)
from tpudl_torch.compile.cache import DEFAULT_CACHE_DIR, enable_compilation_cache
from tpudl_torch.compile.store import (MANIFEST_NAME, MANIFEST_SCHEMA,
                                       MANIFEST_VERSION, ProgramStore,
                                       aot_enabled, backend_token,
                                       fn_fingerprint, get_program_store,
                                       reset_program_store, store_dir,
                                       warm_start)

__all__ = [
    "enable_compilation_cache", "DEFAULT_CACHE_DIR",
    "BucketLadder", "resolve_ladder", "pad_to", "count_pad_rows",
    "ProgramStore", "get_program_store", "reset_program_store",
    "aot_enabled", "store_dir", "warm_start", "fn_fingerprint",
    "backend_token", "MANIFEST_NAME", "MANIFEST_SCHEMA",
    "MANIFEST_VERSION",
]
