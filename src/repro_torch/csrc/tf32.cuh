// 3xTF32 building blocks of the SSD chunk kernels (ssd_chunk.cu and
// ssd_chunk_bwd.cu): f32 products on the tensor cores within f32's 1e-4.
//
// Each f32 operand is split as v = hi + lo, both rounded to TF32 (cvt.rna's
// rounding), and lo.hi + hi.lo + hi.hi are summed into one f32 accumulator
// (only lo.lo, ~2^-22 relative, is dropped): mma.sync m16n8k8 for a warp's
// tile, wgmma m64nNk8 with A from registers for a warpgroup's.  Also the
// 16-byte cp.async that feeds both kernels' shared-memory tiles.
#pragma once

#include <stdint.h>

#include "hopper.cuh"

namespace tf32x3 {

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero) of a finite
// value, in two integer operations: on sm_90 the instruction compiles to the
// same two plus an infinity test and a select, which the finite operands
// here do not need.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both TF32: lo keeps the bits that hi rounds away.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// m16n8k8 fragments (g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// The register A operand of wgmma m64nNk8 (TF32) holds the same A layout for
// each warp's 16 rows.
struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

// f(row, k) -> the A element.
template <class F>
__device__ __forceinline__ FragA load_a(F f, int g, int t) {
  FragA a;
  split(f(g, t), a.hi[0], a.lo[0]);
  split(f(g + 8, t), a.hi[1], a.lo[1]);
  split(f(g, t + 4), a.hi[2], a.lo[2]);
  split(f(g + 8, t + 4), a.hi[3], a.lo[3]);
  return a;
}

// f(k, col) -> the B element.
template <class F>
__device__ __forceinline__ FragB load_b(F f, int g, int t) {
  FragB b;
  split(f(t, g), b.hi[0], b.lo[0]);
  split(f(t + 4, g), b.hi[1], b.lo[1]);
  return b;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: d += a b, the small products first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d (64 x N, f32) += a (64 x 8, TF32 in registers) b (8 x N, TF32 in shared
// memory behind the descriptor, K-major): N = 8, 16, 32 or 64.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "wgmma width");
  if constexpr (N == 64) hopper::wgmma_tf32_rs_n64(d, a, db);
  else if constexpr (N == 32) hopper::wgmma_tf32_rs_n32(d, a, db);
  else if constexpr (N == 16) hopper::wgmma_tf32_rs_n16(d, a, db);
  else hopper::wgmma_tf32_rs_n8(d, a, db);
}

// 3xTF32 on the warpgroup: d += a b with only lo.lo dropped, the small
// products first; b's halves behind the descriptors b_hi and b_lo.
template <int N>
__device__ __forceinline__ void wgmma3(float (&d)[N / 2], const FragA& a,
                                       uint64_t b_hi, uint64_t b_lo) {
  wgmma_tf32<N>(d, a.lo, b_hi);
  wgmma_tf32<N>(d, a.hi, b_lo);
  wgmma_tf32<N>(d, a.hi, b_hi);
}

// Pin a fragment's registers here: the compiler neither reuses them nor
// writes them before this point (a wgmma still reads them until its wait).
__device__ __forceinline__ void pin(FragA& f) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    asm volatile("" : "+r"(f.hi[e]), "+r"(f.lo[e])::"memory");
}

}  // namespace tf32x3
