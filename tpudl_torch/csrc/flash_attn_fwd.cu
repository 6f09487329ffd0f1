// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry
// point (loaded through ctypes by tpudl_torch/cuda_ops.py).
//
// Replaces tpudl/pallas_ops.py:_flash_kernel (launched by _launch /
// _pallas_flash_bh / flash_attention). Same function: per (batch, head) row
// block, s = QK^T * scale in f32, causal mask on GLOBAL positions
// q_offset + i >= k_offset + j (offsets are runtime ints), online softmax with
// running max m, normaliser l and an f32 accumulator, K tiles wholly in the
// causal future of the Q tile skipped, rows that see no key written as 0 with
// lse = -1e30. Outputs O (input dtype) and lse = m + log(l) (f32, [B, Sq, H]).
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, H, D] read through the caller's
// strides (last dim contiguous), so the head-major transposes of the TPU
// version are not needed. O is written contiguous [B, Sq, H, D].
//
// Design (simple and right first): one thread block per (Q tile of 64 rows,
// batch*head); a loop inside the block over 64-row K/V tiles takes the place
// of the TPU's sequential innermost grid dimension. Tiles are staged in shared
// memory as f32 (bf16 is widened on load); four threads own one Q row, hold
// its running m/l in registers and D/4 accumulator columns each. The ragged
// last Q and K tiles are handled by bounds checks, so any sequence length
// works (no gcd shrink of the block size).
//
// What bounds it on the card: at the serving shape [16, 1024, 16, 64] causal
// the work is 34.4 GFLOP against 268 MB of f32 traffic, so the f32 kernel is
// bound by operations (67 TFLOP/s non-tensor f32: about 0.51 ms) and in bf16
// by bytes (134 MB at 3.35 TB/s: about 40 us). This version issues scalar
// FMAs from shared memory (about one shared load per FMA), so shared-memory
// bandwidth, not the FMA rate, limits it. wgmma on bf16 tiles fed by TMA, with
// a producer warp and a ring of tiles, is the work of a later change.

#include "flash_attn_common.cuh"

namespace {

using namespace tpudl_flash;

constexpr int BQ = 64;          // Q rows per block
constexpr int BK = 64;          // K/V rows per inner tile
constexpr int THREADS = 256;    // 4 threads per Q row

template <int D>
constexpr size_t smem_bytes() {
  // sQ [BQ][D+1], sK [BK][D+1], sV [BK][D], sP [BQ][BK+1]; the +1 pads keep
  // column reads across rows on distinct banks
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk,
                 long long qb, long long qs, long long qh,
                 long long kb, long long ks, long long kh,
                 long long vb, long long vs, long long vh,
                 int causal, int q_offset, int k_offset, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DPT = D / 4;  // accumulator columns per thread
  constexpr int CPT = BK / 4; // score columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * D;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;   // Q row of this thread within the tile
  const int quarter = tid & 3;

  const T* qbase = q + b * qb + h * qh;
  const T* kbase = k + b * kb + h * kh;
  const T* vbase = v + b * vb + h * vh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int gq = q0 + r;
    sQ[r * DP + c] = gq < Sq ? to_f32(qbase[gq * qs + c]) : 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const long long qpos = (long long)q_offset + q0 + row;

  const int n_kt = live_k_tiles((Sk + BK - 1) / BK, BK, causal, q_offset,
                                k_offset, q_last);

  float m = NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // sQ ready; the previous tile's sK/sV are consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const int gk = k0 + r;
      const bool in = gk < Sk;
      sK[r * DP + c] = in ? to_f32(kbase[gk * ks + c]) : 0.f;
      sV[r * D + c] = in ? to_f32(vbase[gk * vs + c]) : 0.f;
    }
    __syncthreads();

    float s[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[row * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        s[j] = fmaf(qd, sK[(quarter + 4 * j) * DP + d], s[j]);
    }

    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int gk = k0 + quarter + 4 * j;
      const bool visible =
          gk < Sk && (!causal || qpos >= (long long)k_offset + gk);
      s[j] = visible ? s[j] * scale : NEG_INF;
      tmax = fmaxf(tmax, s[j]);
    }
    // the four threads of a row are adjacent lanes of one warp
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));

    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    // a row with no visible key yet keeps l == 0 (reported as fully masked,
    // not as mean(V)): its weights are zeroed, as in the TPU kernel
    const bool dead = m_new <= NEG_INF * 0.5f;
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = dead ? 0.f : expf(s[j] - m_new);
      sP[row * PP + quarter + 4 * j] = p;
      rsum += p;
    }
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
    l = l * corr + rsum;
    m = m_new;
    __syncwarp();  // a row's P is written and read by the same four lanes

#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[c] *= corr;
    for (int j = 0; j < BK; ++j) {
      const float p = sP[row * PP + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c)
        acc[c] = fmaf(p, sV[j * D + quarter + 4 * c], acc[c]);
    }
  }

  const int gq = q0 + row;
  if (gq < Sq) {
    const float safe_l = l == 0.f ? 1.f : l;
    const long long orow = ((long long)b * Sq + gq) * H + h;
    T* out = o + orow * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) store(out + quarter + 4 * c, acc[c] / safe_l);
    if (quarter == 0) lse[orow] = l == 0.f ? NEG_INF : m + logf(safe_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Sq, int Sk, const long long* st, int causal,
           int q_offset, int k_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Sq, Sk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      q_offset, k_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Sq, int Sk, const long long* st,
               int causal, int q_offset, int k_offset, float scale,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, Sq, Sk, st, causal, q_offset, k_offset, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Sq, Sk, st, causal, q_offset, k_offset, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Sk, st, causal, q_offset, k_offset, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Sk, st, causal, q_offset, k_offset, scale, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides (in elements): q batch/seq/head,
// k batch/seq/head, v batch/seq/head. Returns 0, a cudaError_t code, or -1
// for a head_dim / dtype this file has no instance of. Does not synchronise.
int tpudl_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int dtype, int B, int H, int Sq, int Sk,
                         int D, long long qb, long long qs, long long qh,
                         long long kb, long long ks, long long kh,
                         long long vb, long long vs, long long vh, int causal,
                         int q_offset, int k_offset, float scale,
                         void* stream) {
  const long long st[9] = {qb, qs, qh, kb, ks, kh, vb, vs, vh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, lse, B, H, Sq, Sk, st, causal, q_offset, k_offset, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, H, Sq, Sk, st, causal, q_offset, k_offset, scale, s);
  return -1;
}

}  // extern "C"
