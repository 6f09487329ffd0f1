// Pieces shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the finite -inf stand-in, bf16/f32 loads and stores,
// and the causal tile-skip predicates, which are tpudl/pallas_ops.py's
// _tile_live (a (Q tile, K tile) pair is live iff the tile's first key lies
// at or before its last query, on global positions) solved for the first or
// last live tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpudl_flash {

constexpr float NEG_INF = -1e30f;  // finite -inf stand-in, as in the TPU kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Number of leading K tiles (of bk rows, n_kt in all) that hold a key some
// row of a Q tile can see, the tile's last row being local row q_last: the
// K tiles after them lie wholly in the causal future and are skipped.
__device__ __forceinline__ int live_k_tiles(int n_kt, int bk, int causal,
                                            int q_offset, int k_offset,
                                            int q_last) {
  if (!causal) return n_kt;
  // local index of the last key any row of the Q tile can see
  const long long lim = (long long)q_offset + q_last - k_offset;
  return lim < 0 ? 0 : (int)min((long long)n_kt, lim / bk + 1);
}

// First Q tile (of bq rows) that holds a query able to see the key at local
// row k0: the Q tiles before it lie wholly in that key's causal past.
__device__ __forceinline__ int first_live_q_tile(int bq, int causal,
                                                 int q_offset, int k_offset,
                                                 int k0) {
  if (!causal) return 0;
  // local index of the first query that sees key k0
  const long long need = (long long)k_offset + k0 - q_offset;
  return need <= 0 ? 0 : (int)min(need / bq, (long long)0x7fffffff);
}

}  // namespace tpudl_flash

extern "C" const char* tpudl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
