// SSD intra-chunk block (Mamba2) for Hopper (sm_90a), f32 in and out.
//
// Replaces the TPU kernel `ssd_chunk_pallas` / `_ssd_chunk_kernel`
// (src/repro/kernels/ssd/kernel.py:44).  For one (batch, chunk), with
// cum_h = cumsum(a_h) over the chunk (l <= 256 steps) and G = C B^T (l x l;
// B and C are one group, shared by every head):
//   y_h[i, :] = sum_{j <= i} G[i, j] * exp(cum_h[i] - cum_h[j]) * x_h[j, :]
//   state_h   = sum_j x_h[j, :] (x) (B[j, :] * exp(cum_h[last] - cum_h[j]))
// Outputs: y (b, c, l, h, p) and states (b, c, h, p, n), the layout
// `ssd_chunk_pallas` returns (not its docstring's).  Inputs are read in
// place, in the layouts ssd/ops.py builds: x (b, c, l, h, p), a (b, c, l, h),
// B and C (b, c, l, n), contiguous.
//
// What bounds it on the H100: with the products on the tensor cores, bytes
// at zamba2's shape (b4 c4 l256 h64 p64 n64: 154 MB read and written once,
// 0.046 ms) and the bytes/operations ridge at mamba2's (h32 n128).  One
// kernel, one launch; 256 threads, one CTA an SM:
//   * One CTA per (b*c, 64-row i-tile, group of up to 8 heads), heaviest
//     i-tiles first (blockIdx.x -> (i-tile, b*c, group), as `plan()` in
//     kernels/ssd/kernel.py lays it out).  The CTA forms its row block of G
//     once, G[i-tile, j-tile] for every j-tile <= i-tile (mma.sync), and
//     reuses it for every head of its group: C B^T is computed ceil(h / 8)
//     times per (b, c), not h times.
//   * 3xTF32 for every product: each f32 operand is split as v = hi + lo,
//     both rounded to TF32 (cvt.rna's rounding), and lo.hi + hi.lo + hi.hi
//     are summed into one f32 accumulator (only lo.lo, ~2^-22 relative, is
//     dropped).  The tolerance is 1e-4 in f32, and one TF32 product (11
//     significant bits) over sums of 256 terms misses it (5.8e-4 on y at
//     zamba2's shape, emulated in tests/test_torch_ssd_plan.py).
//   * y and the states on wgmma: the two warpgroups take the two heads of a
//     pair; each converts its head's x tile into TF32 halves in shared
//     memory (K-major core matrices, no swizzle: TF32 wgmma reads B only
//     K-major, and x is stored p-contiguous), then runs m64nPk8 with A = S
//     (or B^T for the states) from registers, built for k-step ks + 1 while
//     ks runs.  G = C B^T stays on mma.sync m16n8k8 (a tenth of the work).
//   * The decay: on the diagonal tile S = G * exp(cum_i - cum_j), taken from
//     the difference and only for j <= i (exp(cum_i) * exp(-cum_j) overflows,
//     and exponentiating the masked half gives inf * 0 = NaN).  Off the
//     diagonal (j < i0 <= i, i0 the i-tile's first row) it is split at i0:
//     exp(cum_i - cum_i0) * exp(cum_i0 - cum_j), both <= 1 for a <= 0 (a =
//     dt * A with A < 0).  The column factor scales x as it is converted, the
//     row factor scales y once, before the diagonal tile: the off-diagonal G
//     tiles are used as they are, whatever the head.
//   * End states fused: the CTA of the last i-tile converts every x tile of
//     its heads anyway; it also forms state_h^T = B^T (x_h * decay) from the
//     same x halves (off the diagonal, decay = exp(cum_last - cum_i0) * the
//     column factor: B is used as it is and the sum is scaled before the
//     diagonal tile).
//   * Loads: B and C tiles by 16-byte cp.async.cg through a ring of two
//     stages (rows past l zero-filled); x through registers, one item ahead.
#include "common.cuh"
#include "hopper.cuh"

#include <limits.h>

namespace {

constexpr int kT = 64;          // rows of an i- or j-tile
constexpr int kThreads = 256;   // two warpgroups
constexpr int kMaxL = 256;      // longest chunk: one a value per thread
constexpr int kMaxHG = 8;       // heads of a group
constexpr int kGroupSteps = 2;      // k-steps a wgmma group, y alone
constexpr int kGroupStepsLast = 1;  // ... y and the states
// Dynamic shared memory a block may use: 232,448 bytes on the H100, less the
// kernel's static `wsum`.
constexpr size_t kSmemLimit = 232448 - 256;

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

// Rows [0, 64) of a (rows x cols) f32 tile, source row stride `ld_src`, into
// shared memory with row stride `ld_dst`; rows >= `valid` read zeros.
__device__ __forceinline__ void load_tile(float* dst, int ld_dst,
                                          const float* src, long long ld_src,
                                          int cols, int valid) {
  const int vec = cols / 4;
  for (int e = threadIdx.x; e < kT * vec; e += kThreads) {
    const int r = e / vec, c = (e % vec) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * ld_dst + c, ok ? src + r * ld_src + c : src, ok);
  }
}

// Shared memory, in floats: the prefix sums of the group's heads, the row
// block of G (one 64 x 64 tile per j-tile <= the i-tile, rows padded by 4),
// the TF32 halves of two heads' x tiles in wgmma's K-major core-matrix
// layout (the C tile, rows padded by 4, lives there while G is formed), and
// a ring of two B tiles (rows padded by 8).
template <int P, int N>
struct Smem {
  static constexpr int CLD = N + 4;   // C rows: A fragments conflict-free
  static constexpr int BLD = N + 8;   // B rows: fragments of B and B^T
  static constexpr int GLD = kT + 4;
  static constexpr int XT = kT * P;   // one TF32 half of one x tile
  static constexpr int CUM = 0;                       // [kMaxHG][kMaxL]
  static constexpr int GS = CUM + kMaxHG * kMaxL;     // G tiles, kT x GLD
  static constexpr int XAREA = 4 * XT > kT * CLD ? 4 * XT : kT * CLD;
  __host__ __device__ static constexpr int xs(int n_it) {
    return GS + n_it * kT * GLD;
  }
  __host__ __device__ static constexpr int ring(int n_it) {
    return xs(n_it) + XAREA;
  }
  __host__ __device__ static constexpr size_t bytes(int n_it) {
    return sizeof(float) * (ring(n_it) + 2 * kT * BLD);
  }
  static_assert(bytes(kMaxL / kT) <= kSmemLimit, "shared memory");
};

// The x halves are B operands (K = j, N = p) in wgmma's K-major core-matrix
// layout without swizzle: element (j, p) at float (j / 4) * 32 + (p / 8) *
// 512 + (p % 8) * 4 + j % 4, so a descriptor has lbo = 128 bytes (next 4
// columns j) and sbo = 2048 bytes (next 8 rows p), and moves 256 bytes a
// k-step of 8.

template <int P>
__device__ __forceinline__ void wgmma_tf32(float (&d)[P / 2],
                                           const uint32_t (&a)[4], uint64_t db) {
  if constexpr (P == 64) hopper::wgmma_tf32_rs_n64(d, a, db);
  else hopper::wgmma_tf32_rs_n16(d, a, db);
}

// 3xTF32 on the warpgroup: d += a b with only lo.lo dropped, the small
// products first.
template <int P>
__device__ __forceinline__ void wgmma3(float (&d)[P / 2], const FragA& a,
                                       uint64_t b_hi, uint64_t b_lo) {
  wgmma_tf32<P>(d, a.lo, b_hi);
  wgmma_tf32<P>(d, a.hi, b_lo);
  wgmma_tf32<P>(d, a.hi, b_hi);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin a fragment's registers here: the compiler neither reuses them nor
// writes them before this point (a wgmma still reads them until its wait).
__device__ __forceinline__ void pin(FragA& f) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    asm volatile("" : "+r"(f.hi[e]), "+r"(f.lo[e])::"memory");
}

// One head item's products on the warpgroup: y += S x_jt and, in the last
// i-tile's CTA, state^T += B_jt^T x_jt, x_jt's TF32 halves behind the
// descriptors x_hi / x_lo.  DIAG: the diagonal tile (S = G * exp(cum_i -
// cum_j) for j <= i); otherwise S = G (x carries the column factor).  The
// thread's rows are i and i + 8 (i = 16 w4 + g) of y and of each m64 tile of
// state^T.  The fragments of k-step ks + 1 are built while the products of
// k-step ks run.
template <int P, int N, bool DIAG, bool LAST>
__device__ __forceinline__ void head_products(
    float (&yd)[P / 2], float (&sd)[(N >= 64 ? N / 64 : 1)][P / 2],
    const float* Gt, const float* Bt, const float* cq, int i0, int j0, int l,
    int i, int t, uint64_t x_hi, uint64_t x_lo) {
  using S = Smem<P, N>;
  constexpr int MM = N >= 64 ? N / 64 : 1;
  constexpr int KS = kT / 8;
  const float clast = cq[l - 1];
  auto build = [&](int ks, FragA& s, FragA (&b)[MM]) {
    const int ja = 8 * ks + t, jb = ja + 4;
    // S: rows i, i + 8; columns ja, jb.
    float v[4] = {Gt[i * S::GLD + ja], Gt[(i + 8) * S::GLD + ja],
                  Gt[i * S::GLD + jb], Gt[(i + 8) * S::GLD + jb]};
    if (DIAG) {
      const float c0 = cq[i0 + i], c1 = cq[i0 + i + 8];
      const float d0 = cq[i0 + ja], d1 = cq[i0 + jb];
      v[0] = ja <= i ? v[0] * __expf(c0 - d0) : 0.f;
      v[1] = ja <= i + 8 ? v[1] * __expf(c1 - d0) : 0.f;
      v[2] = jb <= i ? v[2] * __expf(c0 - d1) : 0.f;
      v[3] = jb <= i + 8 ? v[3] * __expf(c1 - d1) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) split(v[e], s.hi[e], s.lo[e]);
    if (LAST) {
      // B^T: rows n, n + 8; columns ja, jb; on the diagonal tile B carries
      // the decay exp(cum_last - cum_j).
      float da = 1.f, db = 1.f;
      if (DIAG) {
        da = __expf(clast - cq[j0 + ja]);
        db = __expf(clast - cq[j0 + jb]);
      }
#pragma unroll
      for (int m = 0; m < MM; ++m) {
        const int n = 64 * m + i;
        const float w[4] = {n < N ? Bt[ja * S::BLD + n] * da : 0.f,
                            n + 8 < N ? Bt[ja * S::BLD + n + 8] * da : 0.f,
                            n < N ? Bt[jb * S::BLD + n] * db : 0.f,
                            n + 8 < N ? Bt[jb * S::BLD + n + 8] * db : 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) split(w[e], b[m].hi[e], b[m].lo[e]);
      }
    }
  };
  // KB k-steps a wgmma group; two groups of fragments in turn.
  constexpr int KB = LAST ? kGroupStepsLast : kGroupSteps;
  FragA fs[2][KB], fb[2][KB][MM];
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) build(kb, fs[0][kb], fb[0][kb]);
#pragma unroll
  for (int gr = 0; gr < KS / KB; ++gr) {
    const int c = gr & 1;
    hopper::wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const uint64_t step = (uint64_t)(256 * (gr * KB + kb)) >> 4;
      wgmma3<P>(yd, fs[c][kb], x_hi + step, x_lo + step);
      if (LAST) {
#pragma unroll
        for (int m = 0; m < MM; ++m)
          wgmma3<P>(sd[m], fb[c][kb][m], x_hi + step, x_lo + step);
      }
    }
    hopper::wgmma_commit();
    if (gr + 1 < KS / KB) {
      wgmma_wait<1>();                 // group gr - 1 is done with c ^ 1
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        pin(fs[c ^ 1][kb]);
#pragma unroll
        for (int m = 0; m < MM; ++m) pin(fb[c ^ 1][kb][m]);
        build((gr + 1) * KB + kb, fs[c ^ 1][kb], fb[c ^ 1][kb]);
      }
    }
  }
  wgmma_wait<0>();
  hopper::fence_regs(yd);
#pragma unroll
  for (int m = 0; m < MM; ++m) hopper::fence_regs(sd[m]);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ B, const float* __restrict__ C,
                 float* __restrict__ y, float* __restrict__ st, int bcs, int l,
                 int h, int hg, int groups) {
  using S = Smem<P, N>;
  constexpr int ND = P / 2;                    // accumulator floats a thread
  constexpr int MM = N >= 64 ? N / 64 : 1;     // m64 tiles of state^T
  constexpr int XE = kT * P / 128;             // x elements a thread converts
  extern __shared__ __align__(16) float smem[];
  __shared__ float wsum[kThreads / 32][kMaxHG];
  float* cum = smem + S::CUM;
  float* Gs = smem + S::GS;
  const int n_it = (l + kT - 1) / kT;
  float* xts = smem + S::xs(n_it);
  float* Cs = xts;                             // while G is formed
  float* ring = smem + S::ring(n_it);

  // blockIdx.x -> (i-tile, b*c, group), heaviest i-tiles first.
  const int per_tile = bcs * groups;
  const int it = n_it - 1 - (int)(blockIdx.x / per_tile);
  const int rem = (int)(blockIdx.x % per_tile);
  const long long bc = rem / groups;
  const int h0 = (rem % groups) * hg;
  const int nh = min(hg, h - h0);              // a ragged last group
  const int i0 = it * kT;
  const bool last = it == n_it - 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long xld = (long long)h * P;      // stride between x / y rows
  const float* Bb = B + bc * l * N;

  // Items: it + 1 B tiles for G, then per pair of heads it + 1 x tiles each.
  // The ring carries the B tiles (for the states, in the last i-tile's CTA,
  // again with every x tile); x comes through registers (xr), one item ahead.
  const int n_j = it + 1;
  const int pairs = (nh + 1) / 2;
  const int items = n_j + pairs * n_j;
  auto issue = [&](int q) {
    float* stage = ring + (q & 1) * kT * S::BLD;
    const int jt = q < n_j ? q : (q - n_j) % n_j;
    if (q < n_j || last)
      load_tile(stage, S::BLD, Bb + (long long)jt * kT * N, N, N, l - jt * kT);
  };

  // Warpgroup `slot` takes head 2 pr + slot of each pair; its warp w4 holds
  // rows 16 w4 .. + 15 of y and of each m64 tile of state^T.
  const int slot = warp >> 2, w4 = warp & 3;
  float xr[XE];
  // x element e of the thread: core matrix (p / 8, j / 4) = (e / 4, w4 +
  // 4 (e % 4)), row g, column t: p = 8 (e / 4) + g, j = 4 w4 + 16 (e % 4) + t.
  auto load_x = [&](int q) {
    const int pr = (q - n_j) / n_j, jt = (q - n_j) % n_j;
    const int hq = 2 * pr + slot;
    if (hq >= nh) return;
    const float* xb = x + (bc * l + jt * kT) * xld + (long long)(h0 + hq) * P;
    const int valid = l - jt * kT;
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      const int j = 4 * w4 + 16 * (e & 3) + t, p = 8 * (e >> 2) + g;
      xr[e] = j < valid ? xb[j * xld + p] : 0.f;
    }
  };

  load_tile(Cs, S::CLD, C + (bc * l + i0) * N, N, N, l - i0);
  issue(0);
  cp_async_commit();

  // Inclusive prefix sums of the group's a over the chunk, one row a thread
  // (a past l reads 0, so cum stays at cum[l - 1] there).
  {
    float v[kMaxHG];
#pragma unroll
    for (int q = 0; q < kMaxHG; ++q)
      v[q] = tid < l && q < nh ? a[(bc * l + tid) * h + h0 + q] : 0.f;
#pragma unroll
    for (int q = 0; q < kMaxHG; ++q) {
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v[q], o);
        if (lane >= o) v[q] += u;
      }
      if (lane == 31) wsum[warp][q] = v[q];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kMaxHG; ++q) {
      float off = 0.f;
      for (int w = 0; w < warp; ++w) off += wsum[w][q];
      cum[q * kMaxL + tid] = v[q] + off;
    }
  }

  float yd[ND];
  float sd[MM][ND];
  float* xt_hi = xts + slot * 2 * S::XT;
  float* xt_lo = xt_hi + S::XT;
  const uint64_t d_hi = hopper::noswz_desc(xt_hi, 128, 2048);
  const uint64_t d_lo = hopper::noswz_desc(xt_lo, 128, 2048);

  for (int q = 0; q < items; ++q) {
    // CTA-wide barriers only where the ring or G is shared: the G items, and
    // every item of the last i-tile's CTA (its B tiles).  Otherwise the two
    // warpgroups run their heads' items on their own.
    const bool sync = q < n_j || last;
    if (q + 1 < items) issue(q + 1);
    cp_async_commit();
    if (q + 1 == n_j) load_x(q + 1);           // the first x tiles
    cp_async_wait<1>();
    if (sync) __syncthreads();
    const float* Bt = ring + (q & 1) * kT * S::BLD;

    if (q < n_j) {
      // G[i-tile, q] = C B^T with mma.sync: 8 warps of 16 rows x 32 columns;
      // on the diagonal tile the n8 tiles wholly above the diagonal are 0.
      const int jt = q, gm = warp & 3, gn = warp >> 2;
      float acc[4][4] = {};
#pragma unroll 2
      for (int ks = 0; ks < N / 8; ++ks) {
        const FragA fa = load_a([&](int r, int k) {
          return Cs[(16 * gm + r) * S::CLD + 8 * ks + k];
        }, g, t);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (jt == it && 32 * gn + 8 * nt > 16 * gm + 15) continue;
          const FragB fb = load_b([&](int k, int n) {
            return Bt[(32 * gn + 8 * nt + n) * S::BLD + 8 * ks + k];
          }, g, t);
          mma3(acc[nt], fa, fb);
        }
      }
      float* Gt = Gs + jt * kT * S::GLD;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int r = 16 * gm + g, c = 32 * gn + 8 * nt + 2 * t;
        Gt[r * S::GLD + c] = acc[nt][0];
        Gt[r * S::GLD + c + 1] = acc[nt][1];
        Gt[(r + 8) * S::GLD + c] = acc[nt][2];
        Gt[(r + 8) * S::GLD + c + 1] = acc[nt][3];
      }
    } else {
      const int pr = (q - n_j) / n_j, jt = (q - n_j) % n_j;
      const int hq = 2 * pr + slot;            // the warpgroup's head
      const bool diag = jt == it, mine = hq < nh;
      const float* cq = cum + hq * kMaxL;
      const int j0 = jt * kT;
      if (mine) {
        // x's TF32 halves; off the diagonal x carries the column factor
        // exp(cum_i0 - cum_j) (four columns j a thread).
        float sc[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          sc[u] = diag ? 1.f : __expf(cq[i0] - cq[j0 + 4 * w4 + 16 * u + t]);
        const int base = w4 * 32 + g * 4 + t;
#pragma unroll
        for (int e = 0; e < XE; ++e) {
          uint32_t hi, lo;
          split(xr[e] * sc[e & 3], hi, lo);
          const int k = base + (e & 3) * 128 + (e >> 2) * 512;
          xt_hi[k] = __uint_as_float(hi);
          xt_lo[k] = __uint_as_float(lo);
        }
        hopper::fence_async_smem();
        hopper::named_barrier(1 + slot, 128);
      }
      if (q + 1 < items) load_x(q + 1);        // in flight during the products
      if (mine) {
        if (jt == 0) {
#pragma unroll
          for (int e = 0; e < ND; ++e) yd[e] = 0.f;
#pragma unroll
          for (int m = 0; m < MM; ++m)
#pragma unroll
            for (int e = 0; e < ND; ++e) sd[m][e] = 0.f;
        }
        const int i = 16 * w4 + g;             // the thread's rows i, i + 8
        if (diag) {
          // The off-diagonal sums carry exp(cum_i0 - cum_j): scale y's rows
          // by exp(cum_i - cum_i0), the state by exp(cum_last - cum_i0).
          const float r0 = expf(cq[i0 + i] - cq[i0]);
          const float r1 = expf(cq[i0 + i + 8] - cq[i0]);
#pragma unroll
          for (int e = 0; e < ND; ++e) yd[e] *= (e & 2) ? r1 : r0;
          if (last) {
            const float rl = expf(cq[l - 1] - cq[i0]);
#pragma unroll
            for (int m = 0; m < MM; ++m)
#pragma unroll
              for (int e = 0; e < ND; ++e) sd[m][e] *= rl;
          }
        }
        const float* Gt = Gs + jt * kT * S::GLD;
        if (diag) {
          if (last)
            head_products<P, N, true, true>(yd, sd, Gt, Bt, cq, i0, j0, l, i,
                                            t, d_hi, d_lo);
          else
            head_products<P, N, true, false>(yd, sd, Gt, Bt, cq, i0, j0, l, i,
                                             t, d_hi, d_lo);
        } else {
          if (last)
            head_products<P, N, false, true>(yd, sd, Gt, Bt, cq, i0, j0, l, i,
                                             t, d_hi, d_lo);
          else
            head_products<P, N, false, false>(yd, sd, Gt, Bt, cq, i0, j0, l,
                                              i, t, d_hi, d_lo);
        }
        if (diag) {
          // Accumulator element e: row i (+ 8 for e & 2), column 8 (e / 4) +
          // 2 t + (e & 1).
          float* yb = y + bc * l * xld + (long long)(h0 + hq) * P;
#pragma unroll
          for (int e = 0; e < ND; e += 2) {
            const int r = i0 + i + ((e & 2) ? 8 : 0), c = 8 * (e >> 2) + 2 * t;
            if (r < l)
              *reinterpret_cast<float2*>(yb + r * xld + c) =
                  make_float2(yd[e], yd[e + 1]);
          }
          if (last) {
            // sd holds state^T (rows n, columns p); states are (p, n).
            float* sb = st + (bc * h + h0 + hq) * (long long)P * N;
#pragma unroll
            for (int m = 0; m < MM; ++m)
#pragma unroll
              for (int e = 0; e < ND; ++e) {
                const int n = 64 * m + i + ((e & 2) ? 8 : 0);
                const int c = 8 * (e >> 2) + 2 * t + (e & 1);
                if (n < N) sb[c * N + n] = sd[m][e];
              }
          }
        }
      }
    }
    if (sync) __syncthreads();  // the stage is read: issue may refill it
  }
}

template <int P, int N>
cudaError_t launch(const float* x, const float* a, const float* B,
                   const float* C, float* y, float* st, int bc, int l, int h,
                   cudaStream_t stream) {
  auto kern = ssd_chunk_kernel<P, N>;
  // The same arithmetic as plan() in kernels/ssd/kernel.py.
  const int n_it = (l + kT - 1) / kT;
  const int groups = (h + kMaxHG - 1) / kMaxHG;
  const int hg = (h + groups - 1) / groups;
  const long long blocks = (long long)n_it * bc * groups;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = Smem<P, N>::bytes(n_it);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(x, a, B, C, y, st, bc, l,
                                                     h, hg, groups);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_p(int n, const float* x, const float* a, const float* B,
                     const float* C, float* y, float* st, int bc, int l, int h,
                     cudaStream_t s) {
  switch (n) {
    case 8: return launch<P, 8>(x, a, B, C, y, st, bc, l, h, s);
    case 16: return launch<P, 16>(x, a, B, C, y, st, bc, l, h, s);
    case 64: return launch<P, 64>(x, a, B, C, y, st, bc, l, h, s);
    case 128: return launch<P, 128>(x, a, B, C, y, st, bc, l, h, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int P>
long long smem_p(int n, int n_it) {
  switch (n) {
    case 8: return (long long)Smem<P, 8>::bytes(n_it);
    case 16: return (long long)Smem<P, 16>::bytes(n_it);
    case 64: return (long long)Smem<P, 64>::bytes(n_it);
    case 128: return (long long)Smem<P, 128>::bytes(n_it);
    default: return 0;
  }
}

}  // namespace

// Dynamic shared memory, in bytes, that ssd_chunk_fwd gives one block at
// (l, p, n); 0 for what no kernel takes.  plan().smem_bytes in
// kernels/ssd/kernel.py mirrors it, and chip_smoke.py holds the two equal.
extern "C" long long ssd_chunk_smem_bytes(int l, int p, int n) {
  if (l <= 0 || l > kMaxL) return 0;
  const int n_it = (l + kT - 1) / kT;
  switch (p) {
    case 16: return smem_p<16>(n, n_it);
    case 64: return smem_p<64>(n, n_it);
    default: return 0;
  }
}

// x, y: (bc, l, h, p); a: (bc, l, h); B, C: (bc, l, n); st: (bc, h, p, n);
// f32, contiguous, 16-byte aligned; bc = batch * chunks.  p in {16, 64}, n in
// {8, 16, 64, 128}, 1 <= l <= 256.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int ssd_chunk_fwd(const void* x, const void* a, const void* B,
                             const void* C, void* y, void* st, int bc, int l,
                             int h, int p, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc <= 0 || h <= 0 || l <= 0 || l > kMaxL)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  const float* Bf = static_cast<const float*>(B);
  const float* Cf = static_cast<const float*>(C);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(st);
  switch (p) {
    case 16: return (int)launch_p<16>(n, xf, af, Bf, Cf, yf, sf, bc, l, h, s);
    case 64: return (int)launch_p<64>(n, xf, af, Bf, Cf, yf, sf, bc, l, h, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
