// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, CUDA C++ with plain C entry points (loaded through ctypes by
// tpudl_torch/cuda_ops.py).
//
// Replaces tpudl/pallas_ops.py:_bwd_dq_kernel and _bwd_dkv_kernel (launched
// by _pallas_flash_bwd). Same function: with s = QK^T * scale under the
// causal mask on GLOBAL positions (q_offset + i >= k_offset + j, offsets are
// runtime ints), p = exp(s - lse) rebuilt from the forward's saved lse (a row
// whose lse is -1e30 saw no key and gets p = 0, as _bwd_p does: exp(s - lse)
// would overflow there), dp = dO V^T and ds = p * (dp - dlt) * scale, where
// dlt = rowsum(dO * O) - dlse is the per-row constant the caller computes once
// (the lse cotangent folds in there). Then
//   dq = ds K            (dq kernel: one block per (Q tile, batch*head), a
//                         loop over K tiles inside)
//   dk = ds^T Q, dv = p^T dO   (dk/dv kernel: one block per (K tile,
//                         batch*head), a loop over Q tiles inside)
// Each kernel rebuilds s and p itself, so every output tile has exactly one
// owning block and nothing is accumulated across blocks (no atomics). Tiles
// wholly in the causal future are skipped with _tile_live's predicate
// (flash_attn_common.cuh).
//
// Layout: q/dO [B, Sq, H, D] and k/v [B, Sk, H, D] read through the caller's
// strides (last dim contiguous); lse and dlt f32 [B, Sq, H] contiguous; dq,
// dk, dv written contiguous in the inputs' shapes and dtype.
//
// Design (simple and right first), as the forward: 64-row tiles staged in
// shared memory as f32 (bf16 widened on load), 4 threads per owned row, each
// holding 16 of the tile's 64 score columns and D/4 accumulator columns in
// registers; p and ds go through shared memory only between the 4 lanes of
// one row (a warp-local exchange). The ragged last tiles are masked by bounds
// checks, so any length works. Shared memory at D = 64: 83 KB (dq) and 100 KB
// (dk/dv); at D = 128: 149 KB and 165 KB, under the 227 KB a block may take.
//
// What bounds it on the card: at the training shape [8, 1024, 8, 64] causal
// (64 batch*heads x 524,800 visible pairs) dq does 6 D flops a pair
// (12.9 GFLOP) and dk/dv 8 D (17.2 GFLOP) against a few tens of MB, so both
// are bound by operations (67 TFLOP/s f32 non-tensor: about 0.19 ms and
// 0.26 ms). Like the forward, these issue scalar FMAs with about one shared
// load each, so shared-memory bandwidth limits them well above that bound;
// wgmma on bf16 tiles is the work of a later change.

#include "flash_attn_common.cuh"

namespace {

using namespace tpudl_flash;

constexpr int BQ = 64;         // Q rows per tile
constexpr int BK = 64;         // K/V rows per tile
constexpr int THREADS = 256;   // 4 threads per owned row

// a row whose lse is the -1e30 stand-in saw no key
__device__ __forceinline__ bool row_alive(float lse) { return lse > NEG_INF * 0.5f; }

template <int D>
constexpr size_t dq_smem_bytes() {
  // sQ, sdO [BQ][D+1]; sK, sV [BK][D+1]; sDS [BQ][BK+1]. The +1 pads keep
  // column reads across rows on distinct banks.
  return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // sK, sV [BK][D+1]; sQ, sdO [BQ][D+1]; sP, sDS [BK][BQ+1]; lse, dlt [BQ]
  return sizeof(float) *
         (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}

// Strides in elements: q, k, v, dO, each batch / seq / head.
struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dlt, T* __restrict__ dq, int H,
                    int Sq, int Sk, Strides st, int causal, int q_offset,
                    int k_offset, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DPT = D / 4;   // dq columns per thread
  constexpr int CPT = BK / 4;  // score columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + BQ * DP;    // dO
  float* sK = sO + BQ * DP;
  float* sV = sK + BK * DP;
  float* sDS = sV + BK * DP;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;    // Q row of this thread within the tile
  const int quarter = tid & 3;

  const T* qbase = q + b * st.qb + h * st.qh;
  const T* obase = dout + b * st.ob + h * st.oh;
  const T* kbase = k + b * st.kb + h * st.kh;
  const T* vbase = v + b * st.vb + h * st.vh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int gq = q0 + r;
    const bool in = gq < Sq;
    sQ[r * DP + c] = in ? to_f32(qbase[gq * st.qs + c]) : 0.f;
    sO[r * DP + c] = in ? to_f32(obase[gq * st.os + c]) : 0.f;
  }

  const int gq = q0 + row;
  const long long qpos = (long long)q_offset + gq;
  float row_lse = NEG_INF, row_dlt = 0.f;
  if (gq < Sq) {
    const long long i = ((long long)b * Sq + gq) * H + h;
    row_lse = lse[i];
    row_dlt = dlt[i];
  }
  const bool alive = row_alive(row_lse);
  const int n_kt = live_k_tiles((Sk + BK - 1) / BK, BK, causal, q_offset,
                                k_offset, min(q0 + BQ, Sq) - 1);

  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // sQ/sdO ready; the previous tile's sK/sV/sDS consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const int gk = k0 + r;
      const bool in = gk < Sk;
      sK[r * DP + c] = in ? to_f32(kbase[gk * st.ks + c]) : 0.f;
      sV[r * DP + c] = in ? to_f32(vbase[gk * st.vs + c]) : 0.f;
    }
    __syncthreads();

    float s[CPT], dp[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[row * DP + d];
      const float od = sO[row * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = (quarter + 4 * j) * DP + d;
        s[j] = fmaf(qd, sK[r], s[j]);
        dp[j] = fmaf(od, sV[r], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = quarter + 4 * j;
      const int gk = k0 + col;
      const bool visible = alive && gk < Sk &&
                           (!causal || qpos >= (long long)k_offset + gk);
      const float p = visible ? expf(s[j] * scale - row_lse) : 0.f;
      sDS[row * PP + col] = p * (dp[j] - row_dlt) * scale;
    }
    __syncwarp();  // a row's ds is written and read by the same four lanes

    for (int j = 0; j < BK; ++j) {
      const float ds = sDS[row * PP + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c)
        acc[c] = fmaf(ds, sK[j * DP + quarter + 4 * c], acc[c]);
    }
  }

  if (gq < Sq) {
    T* out = dq + (((long long)b * Sq + gq) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) store(out + quarter + 4 * c, acc[c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dlt, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, Strides st,
                     int causal, int q_offset, int k_offset, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BQ + 1;
  constexpr int DPT = D / 4;   // dk/dv columns per thread
  constexpr int CPT = BQ / 4;  // score columns (Q rows) per thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * DP;
  float* sQ = sV + BK * DP;
  float* sO = sQ + BQ * DP;    // dO
  float* sP = sO + BQ * DP;
  float* sDS = sP + BK * PP;
  float* sL = sDS + BK * PP;   // lse of the Q tile's rows
  float* sD = sL + BQ;         // dlt of the Q tile's rows

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int row = tid >> 2;    // K row of this thread within the tile
  const int quarter = tid & 3;

  const T* qbase = q + b * st.qb + h * st.qh;
  const T* obase = dout + b * st.ob + h * st.oh;
  const T* kbase = k + b * st.kb + h * st.kh;
  const T* vbase = v + b * st.vb + h * st.vh;

  for (int e = tid; e < BK * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int gk = k0 + r;
    const bool in = gk < Sk;
    sK[r * DP + c] = in ? to_f32(kbase[gk * st.ks + c]) : 0.f;
    sV[r * DP + c] = in ? to_f32(vbase[gk * st.vs + c]) : 0.f;
  }

  const int gk = k0 + row;
  const bool k_in = gk < Sk;
  const long long kpos = (long long)k_offset + gk;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt0 = first_live_q_tile(BQ, causal, q_offset, k_offset, k0);

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // sK/sV ready; the previous tile's sQ/sdO/sP/sDS consumed
    for (int e = tid; e < BQ * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const int gq = q0 + r;
      const bool in = gq < Sq;
      sQ[r * DP + c] = in ? to_f32(qbase[gq * st.qs + c]) : 0.f;
      sO[r * DP + c] = in ? to_f32(obase[gq * st.os + c]) : 0.f;
    }
    if (tid < BQ) {
      const int gq = q0 + tid;
      const bool in = gq < Sq;
      const long long i = ((long long)b * Sq + gq) * H + h;
      sL[tid] = in ? lse[i] : NEG_INF;
      sD[tid] = in ? dlt[i] : 0.f;
    }
    __syncthreads();

    float s[CPT], dp[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = sK[row * DP + d];
      const float vd = sV[row * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = (quarter + 4 * j) * DP + d;
        s[j] = fmaf(kd, sQ[r], s[j]);
        dp[j] = fmaf(vd, sO[r], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = quarter + 4 * j;  // Q row within the tile
      const int gq = q0 + col;
      const float l = sL[col];
      const bool visible = k_in && gq < Sq && row_alive(l) &&
                           (!causal || (long long)q_offset + gq >= kpos);
      const float p = visible ? expf(s[j] * scale - l) : 0.f;
      sP[row * PP + col] = p;
      sDS[row * PP + col] = p * (dp[j] - sD[col]) * scale;
    }
    __syncwarp();  // a row's p and ds are written and read by the same lanes

    for (int j = 0; j < BQ; ++j) {
      const float p = sP[row * PP + j];
      const float ds = sDS[row * PP + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = j * DP + quarter + 4 * c;
        dv_acc[c] = fmaf(p, sO[col], dv_acc[c]);
        dk_acc[c] = fmaf(ds, sQ[col], dk_acc[c]);
      }
    }
  }

  if (k_in) {
    const long long o = (((long long)b * Sk + gk) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      store(dk + o + quarter + 4 * c, dk_acc[c]);
      store(dv + o + quarter + 4 * c, dv_acc[c]);
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dlt, void* dq, int B, int H,
              int Sq, int Sk, const Strides& st, int causal, int q_offset,
              int k_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dlt,
      static_cast<T*>(dq), H, Sq, Sk, st, causal, q_offset, k_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* dlt, void* dk, void* dv, int B,
               int H, int Sq, int Sk, const Strides& st, int causal,
               int q_offset, int k_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sk + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dlt,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, st, causal,
      q_offset, k_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T_, int D_>
struct Instance {
  using T = T_;
  static constexpr int D = D_;
};

// Calls f(Instance<T, D>{}) for dtype (0 = float32, 1 = bfloat16) and head
// dim D; -1 when this file has no such instance.
template <typename F>
int dispatch(int dtype, int D, F&& f) {
  if (dtype == 0) {
    switch (D) {
      case 16: return f(Instance<float, 16>{});
      case 32: return f(Instance<float, 32>{});
      case 64: return f(Instance<float, 64>{});
      case 128: return f(Instance<float, 128>{});
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return f(Instance<__nv_bfloat16, 16>{});
      case 32: return f(Instance<__nv_bfloat16, 32>{});
      case 64: return f(Instance<__nv_bfloat16, 64>{});
      case 128: return f(Instance<__nv_bfloat16, 128>{});
    }
  }
  return -1;
}

}  // namespace

extern "C" {

// Strides (in elements): q, k, v, dO, each batch / seq / head. Both return 0,
// a cudaError_t code, or -1 for a head_dim / dtype with no instance. Neither
// synchronises.
int tpudl_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* dlt, void* dq, int dtype, int B,
                            int H, int Sq, int Sk, int D, long long qb,
                            long long qs, long long qh, long long kb,
                            long long ks, long long kh, long long vb,
                            long long vs, long long vh, long long ob,
                            long long os, long long oh, int causal,
                            int q_offset, int k_offset, float scale,
                            void* stream) {
  const Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, [&](auto inst) {
    using I = decltype(inst);
    return launch_dq<typename I::T, I::D>(q, k, v, dout, lse, dlt, dq, B, H,
                                          Sq, Sk, st, causal, q_offset,
                                          k_offset, scale, s);
  });
}

int tpudl_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* dlt, void* dk, void* dv, int dtype,
                             int B, int H, int Sq, int Sk, int D,
                             long long qb, long long qs, long long qh,
                             long long kb, long long ks, long long kh,
                             long long vb, long long vs, long long vh,
                             long long ob, long long os, long long oh,
                             int causal, int q_offset, int k_offset,
                             float scale, void* stream) {
  const Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, [&](auto inst) {
    using I = decltype(inst);
    return launch_dkv<typename I::T, I::D>(q, k, v, dout, lse, dlt, dk, dv,
                                           B, H, Sq, Sk, st, causal, q_offset,
                                           k_offset, scale, s);
  });
}

}  // extern "C"
