// Tensor-core building blocks for the flash-attention kernels on Hopper
// (sm_90a): f32-accurate products as three TF32 mma.sync passes (3xTF32),
// the fragment loaders that feed them from shared-memory tiles, and the
// cp.async tile copy that double-buffers those tiles.
//
// 3xTF32: every f32 operand x is split into big = cvt.rna.tf32.f32(x) and
// small = cvt.rna.tf32.f32(x - big) (the rounding done on the bits, tf32_rna),
// and a*b is taken as
// a_small*b_big + a_big*b_small + a_big*b_big in an f32 accumulator, small
// terms first (the dropped a_small*b_small is about 2^-22 of a*b). This is
// the scheme of CUTLASS's OpMultiplyAddFastF32, which PyTorch's
// memory-efficient attention runs for f32 on sm80+. A bf16 value is exact in
// TF32, so its small part is zero and the passes that use it are dropped at
// compile time (kExact).
//
// Fragments of mma.sync.m16n8k8 (lane = 4g + t): A (16 x 8) holds rows g and
// g + 8 at columns t and t + 4; B (8 x 8) holds column g at rows t and t + 4;
// the accumulator C (16 x 8) holds rows g and g + 8 at columns 2t and 2t + 1.
// C is not laid out as A. A product whose A operand is the accumulator of an
// earlier one (p and ds) therefore sums over its k in the "paired" order:
// fragment slot t is k = 2t and slot t + 4 is k = 2t + 1. The sum over k does
// not depend on the order, C then serves as A with no data movement
// (acc_as_a), and the B operand is read in the same order (load_b_paired).
//
// Shared-memory tiles are row-major with a pitch of D + 16 / sizeof(T)
// elements (D + 4 floats, D + 8 bf16 values): 16 bytes of pad keep every row
// 16-byte aligned for cp.async, and put the rows that one fragment read
// touches on distinct banks, both for the row-major reads (load_a, load_bt:
// eight rows g at bank offsets 4g, four columns t) and for the transposed,
// paired reads (load_b_paired: rows 2t and 2t + 1 at bank offsets 8t, eight
// columns g). One pitch serves both, so a tile that is read both ways needs
// no swizzle and no transposed copy.

#pragma once

#include <stdint.h>

#include <type_traits>

#include "flash_attn_common.cuh"

namespace tpudl_flash {

template <typename T>
__host__ __device__ constexpr int tile_pitch(int d) { return d + 16 / (int)sizeof(T); }

// Pitch of a tile read with load_a_paired / load_bt_paired (below): rows stay
// 16-byte aligned for cp.async
__host__ __device__ constexpr int paired_pitch(int d) { return d + 8; }

// ---- 3xTF32 ---------------------------------------------------------------

// f32 -> TF32, round to nearest with ties away from zero: cvt.rna.tf32.f32
// done on the bits (add half a TF32 ulp to the magnitude, clear the 13 low
// mantissa bits), which gives the same value for every finite x in two
// integer instructions; the PTX cvt measured slower on the card. The result
// is an f32 value, so it can be subtracted from x.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <int N>
struct Frag {
  uint32_t big[N], small[N];
};
using FragA = Frag<4>;
using FragB = Frag<2>;

template <bool kExact, int N>
__device__ __forceinline__ Frag<N> split(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (kExact) {
      f.big[i] = __float_as_uint(x[i]);
      f.small[i] = 0u;
    } else {
      f.big[i] = tf32_rna(x[i]);
      f.small[i] = tf32_rna(x[i] - __uint_as_float(f.big[i]));
    }
  }
  return f;
}

// c += a b on the tensor cores, one TF32 pass
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b at f32 accuracy: the small terms first, then big * big. An operand
// that is exact in TF32 (kExact) has no small term.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a,
                                           const FragB& b) {
  if constexpr (!kExactA) mma_tf32(c, a.small, b.big);
  if constexpr (!kExactB) mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// acc += a b at f32 accuracy, for an accumulator that sums many k steps. The
// tensor cores add into their f32 accumulator with truncation, so one chain
// of mma.sync over a long k loses accuracy in proportion to its length and
// in one direction; here each k step's three passes go into a zeroed
// fragment, which is then added to acc with round-to-nearest f32 adds.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma_3xtf32_add(float (&acc)[4], const FragA& a,
                                               const FragB& b) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32<kExactA, kExactB>(c, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

// ---- fragment loaders (tiles of T in shared memory, widened to f32) ------

// A = rows r0..r0+15, columns k0..k0+7 of a row-major tile
template <bool kExact, typename T>
__device__ __forceinline__ FragA load_a(const T* tile, int pitch, int r0,
                                        int k0, int g, int t) {
  const T* p = tile + (r0 + g) * pitch + k0 + t;
  const float x[4] = {to_f32(p[0]), to_f32(p[8 * pitch]), to_f32(p[4]),
                      to_f32(p[8 * pitch + 4])};
  return split<kExact>(x);
}

// B with B[k][n] = tile[n0 + n][k0 + k]: rows n0..n0+7 of a row-major tile,
// read transposed (the K operand of Q K^T)
template <bool kExact, typename T>
__device__ __forceinline__ FragB load_bt(const T* tile, int pitch, int n0,
                                         int k0, int g, int t) {
  const T* p = tile + (n0 + g) * pitch + k0 + t;
  const float x[2] = {to_f32(p[0]), to_f32(p[4])};
  return split<kExact>(x);
}

// B with B[k][n] = tile[k0 + k][n0 + n], in the paired k order of acc_as_a
template <bool kExact, typename T>
__device__ __forceinline__ FragB load_b_paired(const T* tile, int pitch,
                                               int k0, int n0, int g, int t) {
  const T* p = tile + (k0 + 2 * t) * pitch + n0 + g;
  const float x[2] = {to_f32(p[0]), to_f32(p[pitch])};
  return split<kExact>(x);
}

// Two neighbouring elements of a row, widened to f32, in one 8-byte (f32) or
// 4-byte (bf16) shared-memory load; p must be aligned to the pair
__device__ __forceinline__ float2 load_f32x2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_f32x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The paired k order on BOTH operands of a product of two row-major tiles
// (Q K^T in the forward): slot t holds column k0 + 2t and slot t + 4 column
// k0 + 2t + 1, so each row's two values come in one vector load. The sum over
// k is the same; the accumulator layout does not change. The tile wants the
// pitch paired_pitch: an 8-byte load is served a half-warp (rows g = 0..3) at
// a time, and D + 8 elements puts those rows 8 banks apart, where
// tile_pitch's D + 4 floats would put rows g and g + 1 two-way on one bank
// (bf16's 4-byte loads are conflict-free at either pitch).
// A = rows r0..r0+15, columns k0..k0+7
template <bool kExact, typename T>
__device__ __forceinline__ FragA load_a_paired(const T* tile, int pitch,
                                               int r0, int k0, int g, int t) {
  const T* p = tile + (r0 + g) * pitch + k0 + 2 * t;
  const float2 lo = load_f32x2(p), hi = load_f32x2(p + 8 * pitch);
  const float x[4] = {lo.x, hi.x, lo.y, hi.y};
  return split<kExact>(x);
}

// B with B[k][n] = tile[n0 + n][k0 + k] (rows n0..n0+7 read transposed)
template <bool kExact, typename T>
__device__ __forceinline__ FragB load_bt_paired(const T* tile, int pitch,
                                                int n0, int k0, int g, int t) {
  const float2 x2 = load_f32x2(tile + (n0 + g) * pitch + k0 + 2 * t);
  const float x[2] = {x2.x, x2.y};
  return split<kExact>(x);
}

// The accumulator of one n8 tile of an earlier product (f32) as the A operand
// of the next, in the paired k order: C's (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1) are A's slots (g, t), (g, t+4), (g+8, t), (g+8, t+4).
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  return split<false>(x);
}

// Two neighbouring columns of one output row
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- cp.async tile copies ------------------------------------------------

// 16 bytes global -> shared; bytes < 16 zero-fills the rest (0: all zeros)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's groups are still in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Rows row0..row0+ROWS-1 of one (batch, head) slice of a [B, S, H, D]
// operand (src at row 0, row_stride elements apart) into a [ROWS][PITCH]
// tile, as 16-byte cp.async chunks in the caller's open group. Every row
// must start on a 16-byte boundary (cuda_ops copies an operand whose rows do
// not). Rows at or past S are zeros, so a ragged tile computes on zeros and
// never on stale values.
template <typename T, int D, int ROWS, int PITCH, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long row_stride, int row0,
                                          int S, int tid) {
  constexpr int CH = 16 / sizeof(T);  // elements per chunk
  constexpr int CPR = D / CH;         // chunks per row
#pragma unroll 4
  for (int c = tid; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR, e = (c % CPR) * CH;
    const int gr = row0 + r;
    const bool in = gr < S;
    cp_async16(dst + r * PITCH + e,
               in ? src + (long long)gr * row_stride + e : src, in ? 16 : 0);
  }
}

}  // namespace tpudl_flash
