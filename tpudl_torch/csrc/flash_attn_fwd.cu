// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry
// point (loaded through ctypes by tpudl_torch/cuda_ops.py).
//
// Replaces tpudl/pallas_ops.py:_flash_kernel (launched by _launch /
// _pallas_flash_bh / flash_attention). Same function: per (batch, head) row
// block, s = QK^T * scale in f32 (the scale applied after the product), causal
// mask on GLOBAL positions q_offset + i >= k_offset + j (offsets are runtime
// ints), online softmax with running max m, normaliser l and an f32
// accumulator, K tiles wholly in the causal future of the Q tile skipped, rows
// that see no key written as 0 with lse = -1e30. Outputs O (input dtype) and
// lse = m + log(l) (f32, [B, Sq, H]).
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, H, D] read through the caller's
// strides (last dim contiguous, every row on a 16-byte boundary: cuda_ops
// copies an operand whose rows are not), so the head-major transposes of the
// TPU version are not needed. O is written contiguous [B, Sq, H, D].
//
// What bounds it: at the serving shape [16, 1024, 16, 64] causal (256
// batch*heads x 524,800 visible pairs, 4 D flops a pair: S = QK^T and P V)
// the work is 34.4 GFLOP against 268 MB of f32 traffic, so it is bound by
// operations. f32-accurate products on the tensor cores cost three TF32
// passes (flash_attn_mma.cuh): 0.2084 ms at the 495 TFLOP/s TF32 rate,
// against 0.5133 ms for the same flops as f32 FMAs at 67 TFLOP/s. In bf16
// (134 MB, one pass for S, two for P V) the bytes, 40 us, are the bound.
//
// The design, for that bound (the dq kernel's, flash_attn_bwd.cu, with the
// online softmax added):
// - Both products run on mma.sync.m16n8k8 TF32 with the 3xTF32 split; bf16
//   Q, K and V are exact in TF32 and drop the passes of their small parts (p
//   stays f32 and keeps all three).
// - One block per (64-row Q tile, batch*head), the longest causal rows
//   issued first; 4 warps, each owning 16 Q rows, sweep the 64-row K/V tiles
//   of a loop inside the block, SUB = min(64, 2048 / D) keys at a time, so
//   that scores and the O accumulator stay in registers.
// - The Q tile is the same for every K tile, so its fragments are split into
//   TF32 big and small parts once per block and kept in registers (D <= 64;
//   64 registers at D = 64). Their shared-memory tile is then free and holds
//   the second K buffer. At D = 128 they would not fit: Q stays in shared
//   memory and is split as it is read.
// - S = Q K^T reads Q and K in the paired k order on both operands
//   (load_a_paired, load_bt_paired): each row's two values come in one 8-byte
//   load, half the shared loads of the scalar reads. K's tile has the pitch
//   D + 8 that those loads need; V's keeps D + 16 bytes for the transposed
//   paired reads of P V (flash_attn_mma.cuh).
// - Online softmax in the accumulator layout: a thread holds rows g and
//   g + 8, columns 2t and 2t + 1 of each n8 tile; the row max and row sum
//   reduce over the 4 lanes t with two shuffles; O and l are rescaled by
//   exp(m_old - m_new) once a chunk. Each row's causal mask is one "last
//   visible key" limit, computed once. While m_new <= -0.5e30 the row has
//   seen no key and p = 0, as in the TPU kernel. The exponentials are
//   __expf (ex2.approx of x log2(e)): within a few ulps of expf for the
//   arguments <= 0 that p and the rescale take, and on an H100 about a tenth
//   of the kernel's time less than expf.
// - O += P V takes p from the score accumulators as its A operand in the
//   paired k order (acc_as_a), so P never goes through shared memory.
// - The tensor cores' f32 accumulation truncates, so in both products each k
//   step's three passes go into a zeroed fragment that is added to S or O in
//   round-to-nearest f32 (mma_3xtf32_add). O sums over up to the whole key
//   length; S over only D, but one chain of 3 D / 8 truncating passes there
//   left lse 3.4e-5 off the plain version on large scores (q, k x3; an
//   H100), over the 2e-5 tolerance.
// - K and V are double-buffered with 16-byte cp.async: tile i + 1 is issued
//   before tile i is computed; rows at or past Sk are zeros.
// - No atomics: a launch repeats bit for bit.
// Shared memory: 4 tiles (2 K, 2 V), 71,680 B at f32 D = 64 (Q aliased into
// the second K buffer), half that in bf16; 5 tiles, 172,032 B, at f32
// D = 128 (one block an SM).

#include "flash_attn_mma.cuh"

namespace {

using namespace tpudl_flash;

constexpr int ROWS = 64;      // Q rows a block
constexpr int LOOP = 64;      // rows of each K/V tile
constexpr int WARPS = 4;      // each owns 16 of the ROWS
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 2; // blocks an SM at f32 D <= 64 (registers)

// Keys a warp scores at once: a thread holds SUB / 2 floats of scores and
// D / 2 of the O accumulator
template <int D>
__host__ __device__ constexpr int sub_cols() { return 2048 / D < LOOP ? 2048 / D : LOOP; }

// Q's fragments stay in registers (D floats a thread, split) for D <= 64
template <int D>
__host__ __device__ constexpr bool q_in_regs() { return D <= 64; }

template <typename T, int D>
constexpr size_t smem_bytes() {
  // sK [2][LOOP][KP], sV [2][LOOP][VP]; sQ [ROWS][KP] in sK's second buffer
  // when its fragments live in registers, else after sV
  return sizeof(T) * ((2 * LOOP + (q_in_regs<D>() ? 0 : ROWS)) *
                          paired_pitch(D) +
                      2 * LOOP * tile_pitch<T>(D));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk,
                 long long qb, long long qs, long long qh,
                 long long kb, long long ks, long long kh,
                 long long vb, long long vs, long long vh,
                 int causal, int q_offset, int k_offset, float scale) {
  constexpr int KP = paired_pitch(D);
  constexpr int VP = tile_pitch<T>(D);
  constexpr int SUB = sub_cols<D>();
  constexpr bool kQRegs = q_in_regs<D>();
  constexpr bool kExact = !std::is_same<T, float>::value;  // bf16
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [2][LOOP][KP]
  T* sV = sK + 2 * LOOP * KP;              // [2][LOOP][VP]
  T* sQ = kQRegs ? sK + LOOP * KP : sV + 2 * LOOP * VP;  // [ROWS][KP]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // longest rows first
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wr = (tid >> 5) * 16;  // the warp's first row in the tile

  const T* qbase = q + b * qb + h * qh;
  const T* kbase = k + b * kb + h * kh;
  const T* vbase = v + b * vb + h * vh;
  const int n_kt = live_k_tiles((Sk + LOOP - 1) / LOOP, LOOP, causal,
                                q_offset, k_offset, min(q0 + ROWS, Sq) - 1);

  load_rows<T, D, ROWS, KP, THREADS>(sQ, qbase, qs, q0, Sq, tid);
  cp_async_commit();
  if (n_kt > 0) {
    load_rows<T, D, LOOP, KP, THREADS>(sK, kbase, ks, 0, Sk, tid);
    load_rows<T, D, LOOP, VP, THREADS>(sV, vbase, vs, 0, Sk, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  FragA qf[kQRegs ? D / 8 : 1];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      qf[kk] = load_a_paired<kExact>(sQ, KP, wr, 8 * kk, g, t);
    __syncthreads();  // sQ is sK's second buffer, which tile 1 refills
  }

  // this thread's two rows, g and g + 8 of the warp's 16: the last key each
  // sees (-1: none, also for a row past Sq)
  int last[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gq = q0 + wr + g + 8 * i;
    const long long lim =
        causal ? min((long long)q_offset + gq - k_offset, (long long)Sk - 1)
               : (long long)Sk - 1;
    last[i] = gq < Sq ? (int)max(lim, -1LL) : -1;
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {  // issue the next tile before computing this one
      const int nb = (kt + 1) & 1;
      load_rows<T, D, LOOP, KP, THREADS>(sK + nb * LOOP * KP, kbase, ks,
                                         (kt + 1) * LOOP, Sk, tid);
      load_rows<T, D, LOOP, VP, THREADS>(sV + nb * LOOP * VP, vbase, vs,
                                         (kt + 1) * LOOP, Sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the group just issued have landed
    __syncthreads();
    const T* K = sK + (kt & 1) * LOOP * KP;
    const T* V = sV + (kt & 1) * LOOP * VP;
    const int k0 = kt * LOOP;

#pragma unroll 1
    for (int c0 = 0; c0 < LOOP; c0 += SUB) {
      float s[SUB / 8][4];
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;

      // S = Q K^T for the warp's 16 rows x SUB keys
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        FragA qa;
        if constexpr (kQRegs)
          qa = qf[kk];
        else
          qa = load_a_paired<kExact>(sQ, KP, wr, 8 * kk, g, t);
#pragma unroll
        for (int n = 0; n < SUB / 8; ++n) {
          const FragB kf = load_bt_paired<kExact>(K, KP, c0 + 8 * n, 8 * kk,
                                                  g, t);
          mma_3xtf32_add<kExact, kExact>(s[n], qa, kf);
        }
      }

      // online softmax: s -> p in place; element e of an n8 tile is row
      // g + 8 * (e >> 1), key 2t + (e & 1)
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int gk = k0 + c0 + 8 * n + 2 * t + (e & 1);
          s[n][e] = gk <= last[i] ? s[n][e] * scale : NEG_INF;
          mx[i] = fmaxf(mx[i], s[n][e]);
        }
      }
      float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // the four lanes t of a row are lanes 4g..4g+3 of the warp
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = __expf(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          // a row that has seen no key yet keeps l == 0 (reported as fully
          // masked, not as mean(V)): its weights are zeroed
          const float p = m[i] <= NEG_INF * 0.5f ? 0.f : __expf(s[n][e] - m[i]);
          s[n][e] = p;
          rsum[i] += p;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
        l[i] = l[i] * corr[i] + rsum[i];
      }
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] *= corr[e >> 1];

      // O += P V over these SUB keys
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n) {
        const FragA pa = acc_as_a(s[n]);
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const FragB vf = load_b_paired<kExact>(V, VP, c0 + 8 * n, 8 * nd,
                                                 g, t);
          mma_3xtf32_add<false, kExact>(acc[nd], pa, vf);
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
      const float safe_l = l[i] == 0.f ? 1.f : l[i];
      const long long row = ((long long)b * Sq + gq) * H + h;
      T* out = o + row * D + 2 * t;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        store2(out + 8 * nd, acc[nd][2 * i] / safe_l,
               acc[nd][2 * i + 1] / safe_l);
      if (t == 0) lse[row] = l[i] == 0.f ? NEG_INF : m[i] + logf(safe_l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Sq, int Sk, const long long* st, int causal,
           int q_offset, int k_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + ROWS - 1) / ROWS);
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
// k batch/seq/head, v batch/seq/head; every row of q, k and v starts on a
// 16-byte boundary. Returns 0, a cudaError_t code, or -1 for a head_dim /
// dtype this file has no instance of. Does not synchronise.
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
