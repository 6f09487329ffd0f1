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
// owning block and nothing is accumulated across blocks: no atomics, and a
// launch repeats bit for bit. Tiles wholly in the causal future are skipped
// with _tile_live's predicate (flash_attn_common.cuh).
//
// Layout: q/dO [B, Sq, H, D] and k/v [B, Sk, H, D] read through the caller's
// strides (last dim contiguous); lse and dlt f32 [B, Sq, H] contiguous; dq,
// dk, dv written contiguous in the inputs' shapes and dtype.
//
// What bounds it: at the training shape [8, 1024, 8, 64] causal (64
// batch*heads x 524,800 visible pairs) dq does 6 D flops a pair (12.9 GFLOP,
// S = QK^T, dP = dO V^T, dQ = dS K) and dk/dv 8 D (17.2 GFLOP, S^T = K Q^T,
// dP^T = V dO^T, dV = P^T dO, dK = dS^T Q) against a few tens of MB, so both
// are bound by operations. f32-accurate products on the tensor cores cost
// three TF32 passes (flash_attn_mma.cuh), so the least time is 3 x flops at
// the 495 TFLOP/s TF32 rate: 0.078 ms (dq) and 0.104 ms (dk/dv), against
// 0.19 and 0.26 ms for the same flops as f32 FMAs at 67 TFLOP/s.
//
// The design, for that bound:
// - All seven products run on mma.sync.m16n8k8 TF32 with the 3xTF32 split;
//   bf16 inputs are exact in TF32 and drop the passes of their small parts
//   (p and ds stay f32 and keep all three).
// - 4 warps a block; each warp owns 16 rows of the block's 64-row tile (Q
//   rows in dq, K rows in dk/dv) and sweeps the looped 64-row tile in n8
//   steps, SUB columns at a time (sub_cols: at D = 64, 32 in dq and 16 in
//   dk/dv, whose thread already holds 32 floats each of dK and dV), so that
//   scores and accumulators stay in registers with no spill. Fragments are
//   streamed from shared memory, not kept resident.
// - dQ, dK and dV sum over up to the whole sequence, and the tensor cores'
//   f32 accumulation truncates: each k step's three passes go into a zeroed
//   fragment that is then added to the accumulator in round-to-nearest f32
//   (mma_3xtf32_add). On an H100 at the training shape, one chain over the
//   1024 queries left dv 8.3e-5 off the plain version (0.8 of the f32
//   tolerance); the separate adds leave 1.1e-5.
// - S and dP come out in the accumulator layout and are turned into p and
//   ds in place; the next product takes them as its A operand in the paired
//   k order (flash_attn_mma.cuh), so they never go through shared memory.
//   S^T is computed directly in dk/dv, so lse and dlt index by column.
// - Tiles in shared memory: pitch D + 16 bytes (D + 4 floats, D + 8 bf16),
//   which keeps both the row-major fragment reads and the transposed ones
//   (K in dS K, dO in P^T dO, Q in dS^T Q) on distinct banks with no swizzle
//   (flash_attn_mma.cuh). bf16 is stored raw and widened as fragments are
//   built.
// - The looped operand is double-buffered with 16-byte cp.async: K and V in
//   dq, Q and dO with their lse and dlt in dk/dv. Tile i + 1 is issued
//   before tile i is computed. Every row of q, k, v and dO must start on a
//   16-byte boundary; cuda_ops copies an operand whose rows do not.
// - Causal load balance: the blocks with the most live partner tiles are
//   issued first (the last Q tiles in dq, the first K tiles in dk/dv), so
//   the last wave is made of short blocks.
// Shared memory: 6 tiles of 64 x pitch, 102 KB (dq) and 103 KB (dk/dv) at
// f32 D = 64, two blocks an SM; 198 and 199 KB at f32 D = 128; half that for
// bf16. A 32-row looped tile fits three blocks an SM but caps registers at
// 168 and spills; it measured slower.

#include "flash_attn_mma.cuh"

namespace {

using namespace tpudl_flash;

constexpr int ROWS = 64;      // rows of the block's own tile (Q or K)
constexpr int LOOP = 64;      // rows of each tile of the looped operand
constexpr int WARPS = 4;      // each owns 16 of the ROWS
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 2; // blocks an SM at f32 D <= 64 (shared memory)

// Looped-tile columns a warp scores at once. A thread holds SUB floats of
// scores and dp and D / 2 floats of each output accumulator, and SUB * D is
// kept to 2048 in dq (one accumulator) and 1024 in dk/dv (two), which keeps
// every f32 instance free of spills (-Xptxas=-v).
template <int D, bool kDkv>
__host__ __device__ constexpr int sub_cols() {
  constexpr int c = (kDkv ? 1024 : 2048) / D;
  return c < LOOP ? c : LOOP;
}

// a row whose lse is the -1e30 stand-in saw no key
__device__ __forceinline__ bool row_alive(float lse) { return lse > NEG_INF * 0.5f; }

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  // sQ, sdO [ROWS][P]; sK, sV two buffers each of [LOOP][P]
  return sizeof(T) * (2 * ROWS + 4 * LOOP) * tile_pitch<T>(D);
}

template <typename T, int D>
constexpr size_t dkv_smem_bytes() {
  // sK, sV [ROWS][P]; sQ, sdO two buffers each of [LOOP][P]; lse, dlt two
  // buffers each of [LOOP] f32
  return sizeof(T) * (2 * ROWS + 4 * LOOP) * tile_pitch<T>(D) +
         sizeof(float) * 4 * LOOP;
}

// Strides in elements: q, k, v, dO, each batch / seq / head.
struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dlt, T* __restrict__ dq, int H,
                    int Sq, int Sk, Strides st, int causal, int q_offset,
                    int k_offset, float scale) {
  constexpr int P = tile_pitch<T>(D);
  constexpr int SUB = sub_cols<D, false>();
  constexpr bool kExact = !std::is_same<T, float>::value;  // bf16
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sO = sQ + ROWS * P;        // dO
  T* sK = sO + ROWS * P;        // [2][LOOP][P]
  T* sV = sK + 2 * LOOP * P;    // [2][LOOP][P]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // longest rows first
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wr = (tid >> 5) * 16;  // the warp's first row in the tile

  const T* qbase = q + b * st.qb + h * st.qh;
  const T* obase = dout + b * st.ob + h * st.oh;
  const T* kbase = k + b * st.kb + h * st.kh;
  const T* vbase = v + b * st.vb + h * st.vh;
  const int n_kt = live_k_tiles((Sk + LOOP - 1) / LOOP, LOOP, causal,
                                q_offset, k_offset, min(q0 + ROWS, Sq) - 1);

  load_rows<T, D, ROWS, P, THREADS>(sQ, qbase, st.qs, q0, Sq, tid);
  load_rows<T, D, ROWS, P, THREADS>(sO, obase, st.os, q0, Sq, tid);
  if (n_kt > 0) {
    load_rows<T, D, LOOP, P, THREADS>(sK, kbase, st.ks, 0, Sk, tid);
    load_rows<T, D, LOOP, P, THREADS>(sV, vbase, st.vs, 0, Sk, tid);
  }
  cp_async_commit();

  // this thread's two rows, g and g + 8 of the warp's 16: lse, dlt and the
  // last key each sees (-1: none, for a dead row or one past Sq)
  float row_lse[2], row_dlt[2];
  int last[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gq = q0 + wr + g + 8 * i;
    row_lse[i] = NEG_INF;
    row_dlt[i] = 0.f;
    if (gq < Sq) {
      const long long idx = ((long long)b * Sq + gq) * H + h;
      row_lse[i] = lse[idx];
      row_dlt[i] = dlt[idx];
    }
    const long long lim =
        causal ? min((long long)q_offset + gq - k_offset, (long long)Sk - 1)
               : (long long)Sk - 1;
    last[i] = gq < Sq && row_alive(row_lse[i]) ? (int)max(lim, -1LL) : -1;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {  // issue the next tile before computing this one
      const int nb = (kt + 1) & 1;
      load_rows<T, D, LOOP, P, THREADS>(sK + nb * LOOP * P, kbase, st.ks,
                                        (kt + 1) * LOOP, Sk, tid);
      load_rows<T, D, LOOP, P, THREADS>(sV + nb * LOOP * P, vbase, st.vs,
                                        (kt + 1) * LOOP, Sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the group just issued have landed
    __syncthreads();
    const T* K = sK + (kt & 1) * LOOP * P;
    const T* V = sV + (kt & 1) * LOOP * P;
    const int k0 = kt * LOOP;

#pragma unroll 1
    for (int c0 = 0; c0 < LOOP; c0 += SUB) {
      float s[SUB / 8][4], dp[SUB / 8][4];
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;

      // S = Q K^T and dP = dO V^T for the warp's 16 rows x SUB keys
#pragma unroll 1
      for (int kk = 0; kk < D; kk += 8) {
        const FragA qa = load_a<kExact>(sQ, P, wr, kk, g, t);
        const FragA oa = load_a<kExact>(sO, P, wr, kk, g, t);
#pragma unroll
        for (int n = 0; n < SUB / 8; ++n) {
          const FragB kb = load_bt<kExact>(K, P, c0 + 8 * n, kk, g, t);
          mma_3xtf32<kExact, kExact>(s[n], qa, kb);
          const FragB vb = load_bt<kExact>(V, P, c0 + 8 * n, kk, g, t);
          mma_3xtf32<kExact, kExact>(dp[n], oa, vb);
        }
      }

      // p, then ds in place of dp
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;  // row g or g + 8
          const int gk = k0 + c0 + 8 * n + 2 * t + (e & 1);
          const float p =
              gk <= last[i] ? expf(s[n][e] * scale - row_lse[i]) : 0.f;
          dp[n][e] = p * (dp[n][e] - row_dlt[i]) * scale;
        }
      }

      // dQ += dS K over these SUB keys
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n) {
        const FragA da = acc_as_a(dp[n]);
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const FragB kb = load_b_paired<kExact>(K, P, c0 + 8 * n, 8 * nd, g, t);
          mma_3xtf32_add<false, kExact>(acc[nd], da, kb);
        }
      }
    }
    __syncthreads();  // the next iteration refills this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gq = q0 + wr + g + 8 * i;
    if (gq < Sq) {
      T* out = dq + (((long long)b * Sq + gq) * H + h) * D + 2 * t;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        store2(out + 8 * nd, acc[nd][2 * i], acc[nd][2 * i + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dlt, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, Strides st,
                     int causal, int q_offset, int k_offset, float scale) {
  constexpr int P = tile_pitch<T>(D);
  constexpr int SUB = sub_cols<D, true>();
  constexpr bool kExact = !std::is_same<T, float>::value;  // bf16
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + ROWS * P;
  T* sQ = sV + ROWS * P;        // [2][LOOP][P]
  T* sO = sQ + 2 * LOOP * P;    // dO, [2][LOOP][P]
  float* sL = reinterpret_cast<float*>(sO + 2 * LOOP * P);  // lse, [2][LOOP]
  float* sD = sL + 2 * LOOP;                                // dlt, [2][LOOP]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * ROWS;  // the first K tiles see the most Q tiles
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wr = (tid >> 5) * 16;  // the warp's first row in the tile

  const T* qbase = q + b * st.qb + h * st.qh;
  const T* obase = dout + b * st.ob + h * st.oh;
  const T* kbase = k + b * st.kb + h * st.kh;
  const T* vbase = v + b * st.vb + h * st.vh;
  const int n_qt = (Sq + LOOP - 1) / LOOP;
  const int qt0 = first_live_q_tile(LOOP, causal, q_offset, k_offset, k0);

  // the Q tile starting at row q0 with its lse and dlt into buffer nb
  auto load_q_tile = [&](int q0, int nb) {
    load_rows<T, D, LOOP, P, THREADS>(sQ + nb * LOOP * P, qbase, st.qs, q0,
                                      Sq, tid);
    load_rows<T, D, LOOP, P, THREADS>(sO + nb * LOOP * P, obase, st.os, q0,
                                      Sq, tid);
    if (tid < LOOP) {
      const int gq = q0 + tid;
      const bool in = gq < Sq;
      const long long idx = ((long long)b * Sq + (in ? gq : 0)) * H + h;
      cp_async4(sL + nb * LOOP + tid, lse + idx, in ? 4 : 0);
      cp_async4(sD + nb * LOOP + tid, dlt + idx, in ? 4 : 0);
    }
  };

  load_rows<T, D, ROWS, P, THREADS>(sK, kbase, st.ks, k0, Sk, tid);
  load_rows<T, D, ROWS, P, THREADS>(sV, vbase, st.vs, k0, Sk, tid);
  if (qt0 < n_qt) load_q_tile(qt0 * LOOP, 0);
  cp_async_commit();

  // this thread's two rows, keys g and g + 8 of the warp's 16: the first
  // query each is seen by (Sq: none, for a key past Sk)
  int first[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gk = k0 + wr + g + 8 * i;
    const long long need = causal ? (long long)k_offset + gk - q_offset : 0;
    first[i] = gk < Sk ? (int)min(max(need, 0LL), (long long)Sq) : Sq;
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int buf = (qt - qt0) & 1;
    if (qt + 1 < n_qt) load_q_tile((qt + 1) * LOOP, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the group just issued have landed
    __syncthreads();
    const T* Q = sQ + buf * LOOP * P;
    const T* O = sO + buf * LOOP * P;
    const float* L = sL + buf * LOOP;
    const float* Dl = sD + buf * LOOP;
    const int q0 = qt * LOOP;

#pragma unroll 1
    for (int c0 = 0; c0 < LOOP; c0 += SUB) {
      float s[SUB / 8][4], dp[SUB / 8][4];
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;

      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x SUB queries
#pragma unroll 1
      for (int kk = 0; kk < D; kk += 8) {
        const FragA ka = load_a<kExact>(sK, P, wr, kk, g, t);
        const FragA va = load_a<kExact>(sV, P, wr, kk, g, t);
#pragma unroll
        for (int n = 0; n < SUB / 8; ++n) {
          const FragB qb = load_bt<kExact>(Q, P, c0 + 8 * n, kk, g, t);
          mma_3xtf32<kExact, kExact>(s[n], ka, qb);
          const FragB ob = load_bt<kExact>(O, P, c0 + 8 * n, kk, g, t);
          mma_3xtf32<kExact, kExact>(dp[n], va, ob);
        }
      }

      // p in place of s, ds in place of dp; lse and dlt index by column
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;  // key g or g + 8
          const int col = c0 + 8 * n + 2 * t + (e & 1);  // Q row in the tile
          const int gq = q0 + col;
          const float l = L[col];
          const bool visible = gq >= first[i] && gq < Sq && row_alive(l);
          const float p = visible ? expf(s[n][e] * scale - l) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - Dl[col]) * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q over these SUB queries
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n) {
        const FragA pa = acc_as_a(s[n]);
        const FragA da = acc_as_a(dp[n]);
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const FragB ob = load_b_paired<kExact>(O, P, c0 + 8 * n, 8 * nd, g, t);
          mma_3xtf32_add<false, kExact>(dv_acc[nd], pa, ob);
          const FragB qb = load_b_paired<kExact>(Q, P, c0 + 8 * n, 8 * nd, g, t);
          mma_3xtf32_add<false, kExact>(dk_acc[nd], da, qb);
        }
      }
    }
    __syncthreads();  // the next iteration refills this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gk = k0 + wr + g + 8 * i;
    if (gk < Sk) {
      const long long o = (((long long)b * Sk + gk) * H + h) * D + 2 * t;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        store2(dk + o + 8 * nd, dk_acc[nd][2 * i], dk_acc[nd][2 * i + 1]);
        store2(dv + o + 8 * nd, dv_acc[nd][2 * i], dv_acc[nd][2 * i + 1]);
      }
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dlt, void* dq, int B, int H,
              int Sq, int Sk, const Strides& st, int causal, int q_offset,
              int k_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + ROWS - 1) / ROWS);
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
  constexpr size_t smem = dkv_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sk + ROWS - 1) / ROWS);
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

// Strides (in elements): q, k, v, dO, each batch / seq / head; every row of
// q, k, v and dO starts on a 16-byte boundary. Both return 0,
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
