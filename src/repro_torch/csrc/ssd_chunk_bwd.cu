// SSD intra-chunk block (Mamba2), backward, for Hopper (sm_90a), f32.
//
// The gradient of `ssd_chunk_pallas` / `_ssd_chunk_kernel`
// (src/repro/kernels/ssd/kernel.py:44), which has no backward: the JAX
// package trains through its plain `ssd_ref`.  For one (batch, chunk, head),
// with cum = cumsum(a), L[i, j] = exp(cum_i - cum_j) for j <= i (else 0),
// G = C B^T (shared by every head), M = G * L and w_j = exp(cum_last - cum_j),
// given dy (l x p) and dS (p x n, the end state's gradient in the layout
// the forward returns, (b, c, h, p, n)):
//   dM   = dy x^T on j <= i
//   dx   = M^T dy + (B * w) dS^T
//   dG   = sum_h dM * L;   dC = dG B;   dB = dG^T C + sum_h w * (x dS)
//   dseg = dM * G * L: its row sums add to dcum_i, its column sums come off
//          dcum_j; the end state adds sum_j dw_j w_j to dcum_last and takes
//          dw_j w_j off dcum_j, dw_j = sum_{p,n} x_jp B_jn dS_pn
//   da   = the reverse cumsum of dcum over the chunk.
// The plain version is `ssd_chunk_bwd_ref` (kernels/ssd/ref.py).
//
// What bounds it on the H100: the FLOPs.  13.1 GFLOP at zamba2's train shape
// (b4 c4 l256 h64 p64 n64; 0.196 ms at 67 TFLOP/s in f32, 0.080 ms as 3xTF32
// at 495) against 224 MB read and written once (0.067 ms); mamba2's (h32
// n128) 9.0 GFLOP.  Every product runs on the tensor cores in 3xTF32, as in
// the forward (tf32.cuh): one TF32 product misses the 1e-4 check.
// Three launches on one stream:
//   1. ssd_chunk_bwd_kernel, one CTA per (b*c, 64-row j-tile, group of up to
//      8 heads), heaviest j-tiles first (`bwd_plan()` in kernels/ssd/kernel.py
//      mirrors it); 256 threads, one CTA an SM.  Transposed, rows = j: every
//      tile the CTA keeps is 64 rows j by 64 columns i, and warpgroup s owns
//      columns i in [32 s, 32 s + 32) of it, each thread the same 16 (j, i)
//      positions of every tile (those of a wgmma accumulator), so G^T and the
//      sum over heads of dM^T * L^T live in shared memory per thread, without
//      padding or conflicts, and never cross threads.  In turn:
//      a. G^T = B_j C_i^T for every i-tile >= the j-tile, once for the group
//         (mma.sync; C tiles by 16-byte cp.async through a ring of two).
//      b. Per head, per i-tile, both warpgroups at once on their halves of
//         i: dx_j += M^T dy_i (wgmma, A = M^T = G^T * L^T from registers: the
//         k-step's A columns t and t + 4 are the accumulator's i = 2t and
//         2t + 1, and dy's rows are stored in that order, so L and M are
//         computed once, at the accumulator's positions), dM^T = x_j dy_i^T
//         (wgmma, A = x_j's TF32 halves in registers, read once a head),
//         then dG^T += dM^T * L^T and dseg^T = dM^T * M^T: its sums over i
//         stay in the thread (rows j, for dcum_j), its sums over j cross the
//         warpgroup's four warps through shared memory (columns i, for
//         dcum_i).  The two warpgroups' dx sums (K = their rows i) meet once
//         a head in shared memory, in a fixed order, and go to dx.  dy_i is
//         converted once into TF32 halves in two layouts (K = p for dM^T,
//         K = i for dx); its raw rows come by cp.async while the previous
//         item computes, and x_j the same way at each head's end.
//      c. Per head, the state terms, after b: x_j dS (wgmma, warpgroup s
//         taking half of n) gives dB's state part (summed over the heads in
//         registers) and dw; B_j dS^T (half of p each) scaled by w_j is
//         added to b's dx, read back by cp.async with dS and x (the next
//         head's while this one computes), and dx is written.  dS is
//         converted twice, as both products need it K-major (K = p, then K
//         = n).  The j-tile's dcum rows, which need dw, are finished here.
//      The CTA writes its group's dG tiles, its state part of dB and per
//      head the dcum rows it sees.  G^T (64 KB), the dG^T sums (64 KB) and
//      dy's halves in two layouts for both warpgroups (68 KB) fill the
//      block's shared memory: a second stage of converted dy does not fit,
//      and c runs apart from b, in the scratch b leaves.
//   2. ssd_chunk_bwd_bc_kernel, one CTA per (b*c, 64-row tile, dB or dC):
//      sums the groups' dG partials in a fixed order, then dC = dG B and
//      dB = dG^T C plus the groups' state parts (f32 FMA).  So dB and dC,
//      shared by every head, are summed across head groups by a second pass
//      over per-group partials, never by atomics: two runs give the same bits.
//   3. ssd_chunk_bwd_da_kernel, one CTA per (b*c, head): dcum from the
//      j-tiles' partial rows (in j-tile order), then its reverse scan.
// The decay is taken from the difference and only for j <= i (exp(cum_i) *
// exp(-cum_j) overflows, and exponentiating the masked half gives inf * 0 =
// NaN).  Rows past l read as zeros, so they add nothing.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; examples/bwd_bench_torch.py and
// examples/ssd_bwd_phases_torch.py): 0.503 ms a call at zamba2's shape and
// 0.341 at mamba2's (the f32 FMA kernel before it: 1.400 / 0.927), 26 TFLOP/s
// of the useful FLOPs, 2.6x the f32 bound and 6.3x the 3xTF32 floor.  Of
// it, b takes 0.256 / 0.130 ms, c 0.139 / 0.118, a 0.030 / 0.023, the two
// finishing kernels ~0.04.  What holds it: short steps.  A (head, i-tile)
// item does 3.1 MFLOP of TF32 products in ~3.3 us (~1,500 clocks of them
// at the tensor cores' peak); the rest is the dy conversion, the decay and
// the sums, two warpgroup barriers, and each head's hand-over, which no
// second CTA hides (one fills the SM's shared memory).
#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

#include <limits.h>

// The phases ssd_chunk_bwd_kernel runs, as bits: 1 G^T, 2 the main loop, 4
// the state terms; all by default.  examples/ssd_bwd_phases_torch.py builds
// copies with some left out, to time the others (their results are wrong).
#ifndef SSD_BWD_PHASES
#define SSD_BWD_PHASES 7
#endif

namespace {

using namespace tf32x3;

constexpr int kT = 64;          // rows of an i- or j-tile
constexpr int kThreads = 256;   // two warpgroups; the finishing kernels: a
                                // 16 x 16 grid of threads (ty, tx)
constexpr int kMaxL = 256;      // longest chunk: one row a thread in the scan
constexpr int kMaxIt = kMaxL / kT;
constexpr int kHG = 8;          // heads of a group
constexpr int kGL = kT + 1;     // row stride of a 64 x 64 tile (finishing)
// Dynamic shared memory a block may use: 232,448 bytes on the H100, less the
// kernel's static `wsum`.
constexpr size_t kSmemLimit = 232448 - 256;

// Shared memory of ssd_chunk_bwd_kernel, in floats: the prefix sums of the
// group's heads; G^T of each i-tile, thread-private (a tile is [4][256
// threads][4]: float4 k of thread tid holds its positions (j, i), (j, i + 1),
// (j + 8, i), (j + 8, i + 1), j = 16 (warp % 4) + lane / 4, i = 32 (warp / 4)
// + 8 k + 2 (lane % 4)); then a scratch area, which in the main phase holds
// the dG^T sums (the same layout), each warpgroup's dy halves (dyP hi, lo,
// dyI hi, lo: 32 rows i x p each) and its raw dy rows (32 x (p + 4), by
// cp.async), and in the set-up the B j-tile (rows padded by 4), a ring of
// two C tiles or dS's TF32 halves, and the raw dS (p x (n + 8), by
// cp.async); last, small per-head and per-warpgroup sums.
template <int P, int N>
struct BwdSmem {
  static constexpr int BLD = N + 4;
  static constexpr int RLD = P + 4;   // raw dy rows: float2 reads conflict-free
  static constexpr int SLD = N + 8;   // raw dS rows: ... scalar reads
  static constexpr int TILE = 4 * kThreads * 4;
  static constexpr int DYH = 32 * P;        // one half of dyP
  static constexpr int DYI = P / 8 * 288;   // one half of dyI
  static constexpr int DYW = 2 * DYH + 2 * DYI;   // a warpgroup's dy halves
  static constexpr int MAIN = kMaxIt * TILE + 2 * DYW + 2 * 32 * RLD;
  static constexpr int SET = kT * BLD +
                             (2 * kT * BLD > 2 * P * N ? 2 * kT * BLD
                                                       : 2 * P * N) +
                             P * SLD;
  static constexpr int CUM = 0;                       // [kHG][kMaxL]
  static constexpr int GP = CUM + kHG * kMaxL;        // [kMaxIt] tiles
  static constexpr int SCR = GP + kMaxIt * TILE;
  static constexpr int DG = SCR;                      // [kMaxIt] tiles
  static constexpr int DY = DG + kMaxIt * TILE;       // [2][DYW]
  static constexpr int RAW = DY + 2 * DYW;            // [2][32][RLD]
  static constexpr int BJ = SCR;                      // kT x BLD
  static constexpr int ST = BJ + kT * BLD;            // ring or dS halves
  static constexpr int RDS = SCR + SET - P * SLD;     // P x SLD
  static constexpr int REC = SCR + (MAIN > SET ? MAIN : SET);  // [kHG][kT]
  static constexpr int LASTV = REC + kHG * kT;        // [kHG]
  static constexpr int DWQ = LASTV + kHG;             // [kT]
  static constexpr int DWH = DWQ + kT;                // [2][kT]
  static constexpr int CSUM = DWH + 2 * kT;           // [2][2][4][32]
  static constexpr int RSUM = CSUM + 2 * 2 * 4 * 32;  // [2][kT]
  static constexpr int DCLC = RSUM + 2 * kT;          // [kT]
  static constexpr int FLOATS = DCLC + kT;
  static constexpr size_t bytes() { return sizeof(float) * FLOATS; }
  static_assert(bytes() <= kSmemLimit, "shared memory");
  static_assert(kT * (P + 4) + 2 * kT * (P + 8) <= kMaxIt * TILE,
                "c's x and dx tiles fit in the G^T region");
};

// acc[r][c] += sum_{k < K} a(ty + 16 r, k) * b(k, tx + 16 c).
template <int K, int RM, int CN, class FA, class FB>
__device__ __forceinline__ void fma_tile(float (&acc)[RM][CN], FA a, FB b,
                                         int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RM], bv[CN];
#pragma unroll
    for (int r = 0; r < RM; ++r) av[r] = a(ty + 16 * r, k);
#pragma unroll
    for (int c = 0; c < CN; ++c) bv[c] = b(k, tx + 16 * c);
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// Rows [0, 64) of a (64 x cols) f32 tile by 16-byte cp.async, source row
// stride `ld_src`, shared row stride `ld_dst`; rows >= `valid` read zeros.
__device__ __forceinline__ void load_tile_async(float* dst, int ld_dst,
                                                const float* src,
                                                long long ld_src, int cols,
                                                int valid) {
  const int vec = cols / 4;
  for (int e = threadIdx.x; e < kT * vec; e += kThreads) {
    const int r = e / vec, c = (e % vec) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * ld_dst + c, ok ? src + r * ld_src + c : src, ok);
  }
}

__host__ __device__ __forceinline__ int tri(int it, int jt) {
  return it * (it + 1) / 2 + jt;   // (i-tile, j-tile <= i-tile) -> slot
}

// Workspace, in floats: dg [bc][group][tri][kT][kT] (sum_h dM * L, rows i),
// dbs [bc][group][l][N] (sum_h w * (x dS)), dcum [bc][h][j-tile][l] (the
// rows of dcum that one j-tile's CTA sees).  `bwd_plan()` mirrors the sizes.
struct Workspace {
  long long dg, dbs, dcum;
  __host__ __device__ Workspace(int bc, int l, int h, int n, int groups) {
    const int n_it = (l + kT - 1) / kT;
    dg = (long long)bc * groups * (n_it * (n_it + 1) / 2) * kT * kT;
    dbs = (long long)bc * groups * l * n;
    dcum = (long long)bc * h * n_it * l;
  }
  long long floats() const { return dg + dbs + dcum; }
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_bwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                     const float* __restrict__ B, const float* __restrict__ C,
                     const float* __restrict__ dy,
                     const float* __restrict__ dst, float* __restrict__ dx,
                     float* __restrict__ ws_dg, float* __restrict__ ws_dbs,
                     float* __restrict__ ws_dcum, int bcs, int l, int h,
                     int hg, int groups) {
  using S = BwdSmem<P, N>;
  constexpr int KP = P / 8;                  // k-steps over p
  constexpr int PH = P / 2;                  // dx columns of a warpgroup
  constexpr int KH = P / 16;                 // ... in accumulator blocks
  constexpr int NSH = N >= 16 ? N / 2 : N;   // x dS columns of a warpgroup
  extern __shared__ __align__(16) float smem[];
  __shared__ float wsum[kThreads / 32][kHG];
  float* cum = smem + S::CUM;
  float* Gp = smem + S::GP;
  float* dGp = smem + S::DG;
  float* Bj = smem + S::BJ;
  float* st = smem + S::ST;
  float* rec = smem + S::REC;
  float* lastv = smem + S::LASTV;
  float* dwq = smem + S::DWQ;
  float* dwh = smem + S::DWH;
  float* csum = smem + S::CSUM;
  float* rsum = smem + S::RSUM;
  float* dclc = smem + S::DCLC;

  // blockIdx.x -> (j-tile, b*c, group), the heaviest j-tile (0) first.
  const int n_it = (l + kT - 1) / kT;
  const int per_tile = bcs * groups;
  const int jt = (int)(blockIdx.x / per_tile);
  const int rem = (int)(blockIdx.x % per_tile);
  const long long bc = rem / groups;
  const int grp = rem % groups;
  const int h0 = grp * hg;
  const int nh = min(hg, h - h0);              // a ragged last group
  const int j0 = jt * kT;
  const int n_i = n_it - jt;                   // i-tiles the j-tile meets

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int slot = warp >> 2, w4 = warp & 3, tw = tid & 127;
  const int jr = 16 * w4 + g;                  // the thread's rows jr, jr + 8
  const long long xld = (long long)h * P;      // stride between x / dy rows
  const float* Bb = B + bc * l * N;
  const float* Cb = C + bc * l * N;

  load_tile_async(Bj, S::BLD, Bb + (long long)j0 * N, N, N, l - j0);

  // Inclusive prefix sums of the group's a over the chunk, one row a thread
  // (a past l reads 0, so cum stays at cum[l - 1] there).
  {
    float v[kHG];
#pragma unroll
    for (int q = 0; q < kHG; ++q)
      v[q] = tid < l && q < nh ? a[(bc * l + tid) * h + h0 + q] : 0.f;
#pragma unroll
    for (int q = 0; q < kHG; ++q) {
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v[q], o);
        if (lane >= o) v[q] += u;
      }
      if (lane == 31) wsum[warp][q] = v[q];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kHG; ++q) {
      float off = 0.f;
      for (int w = 0; w < warp; ++w) off += wsum[w][q];
      cum[q * kMaxL + tid] = v[q] + off;
    }
  }

  // a. G^T[j-tile, i-tile] for every i-tile >= the j-tile: warp (w4, slot)
  // forms rows 16 w4 .. + 15 and columns 32 slot .. + 31, the positions it
  // keeps (an n8 tile wholly above the diagonal, i < j, stays 0).
  load_tile_async(st, S::BLD, Cb + (long long)j0 * N, N, N, l - j0);
  cp_async_commit();
  for (int q = 0; q < ((SSD_BWD_PHASES & 1) ? n_i : 0); ++q) {
    if (q + 1 < n_i) {
      const int i1 = j0 + (q + 1) * kT;
      load_tile_async(st + ((q + 1) & 1) * kT * S::BLD, S::BLD,
                      Cb + (long long)i1 * N, N, N, l - i1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Ct = st + (q & 1) * kT * S::BLD;
    float acc[4][4] = {};
#pragma unroll 2
    for (int ks = 0; ks < N / 8; ++ks) {
      const FragA fa = load_a([&](int r, int k) {
        return Bj[(16 * w4 + r) * S::BLD + 8 * ks + k];
      }, g, t);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (q == 0 && 32 * slot + 8 * nt + 7 < 16 * w4) continue;
        const FragB fb = load_b([&](int k, int n) {
          return Ct[(32 * slot + 8 * nt + n) * S::BLD + 8 * ks + k];
        }, g, t);
        mma3(acc[nt], fa, fb);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      *reinterpret_cast<float4*>(Gp + ((q * 4 + nt) * kThreads + tid) * 4) =
          make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
    __syncthreads();                 // the stage is read: the next may refill it
  }
  cp_async_wait<0>();


  const long long x_head = (bc * l + j0) * xld; // x at (b*c, j0, head 0)
  // b. Per head, per i-tile: warpgroup `slot` takes columns i in [32 slot,
  // + 32) of the tile.  Its raw dy rows arrive by cp.async (the next item's
  // while this one computes; rows past l zero-filled) and are converted
  // into TF32 halves twice: dyP, the B operand of dM^T (N = i, K = p;
  // element (i, p) at (p / 4) * 32 + (i / 8) * 8P + (i % 8) * 4 + p % 4)
  // and dyI, the B operand of dx (N = p, K = i; element (i, p) at (k / 4) *
  // 36 + (p / 8) * 288 + (p % 8) * 4 + k % 4, k = 8 (i / 8) + 4 (i % 2) +
  // (i % 8) / 2: the order of M^T's A columns; core matrices 144 bytes
  // apart along K, so the conversion's stores meet no bank twice).
  float* dyP_hi = smem + S::DY + slot * S::DYW;
  float* dyP_lo = dyP_hi + S::DYH;
  float* dyI_hi = dyP_lo + S::DYH;
  float* dyI_lo = dyI_hi + S::DYI;
  float* raw = smem + S::RAW + slot * 32 * S::RLD;
  const uint64_t dP_hi = hopper::noswz_desc(dyP_hi, 128, 32 * P);
  const uint64_t dP_lo = hopper::noswz_desc(dyP_lo, 128, 32 * P);
  const uint64_t dI_hi = hopper::noswz_desc(dyI_hi, 144, 1152);
  const uint64_t dI_lo = hopper::noswz_desc(dyI_lo, 144, 1152);
  // The thread's share of a dy tile in the conversion: row ni of the
  // warpgroup's 32, columns p = 8 u + pc, + 1.
  const int ni = 8 * w4 + (lane & 7);
  const int pc = 4 * (lane >> 4) + 2 * ((lane >> 3) & 1);
  const int ki = 8 * (ni / 8) + 4 * (ni % 2) + (ni % 8) / 2;
  const int items = (SSD_BWD_PHASES & 2) ? nh * n_i : 0;
  auto fetch = [&](int k) {
    const int q = k / n_i, qi = k % n_i;
    const int i0 = (jt + qi) * kT + 32 * slot;
    const float* src = dy + (bc * l + i0) * xld + (long long)(h0 + q) * P;
    for (int e = tw; e < 32 * (P / 4); e += 128) {
      const int r = e / (P / 4), c = 4 * (e % (P / 4));
      const bool ok = i0 + r < l;
      cp_async16(raw + r * S::RLD + c, ok ? src + r * xld + c : src, ok);
    }
    cp_async_commit();
  };
  // x's j-tile, all 64 rows, into this warpgroup's dy area past the dx
  // hand-over (before the first item, then at each head's end for the
  // next head); xf, the A fragments of dM^T, are read from it.
  float* xw = smem + S::DY + slot * S::DYW + KH * 128 * 4;
  auto fetch_xw = [&](int hh) {
    const float* xb = x + x_head + (long long)hh * P;
#pragma unroll 1   // issue only: unrolled, its addresses spill
    for (int e = tw; e < kT * (P / 4); e += 128) {
      const int r = e / (P / 4), c = 4 * (e % (P / 4));
      const bool ok = j0 + r < l;
      cp_async16(xw + r * (P + 4) + c, ok ? xb + r * xld + c : xb, ok);
    }
  };
  FragA xf[KP];
  auto read_xw = [&]() {
#pragma unroll
    for (int ks = 0; ks < KP; ++ks)
      xf[ks] = load_a([&](int r, int k) {
        return xw[(16 * w4 + r) * (P + 4) + 8 * ks + k];
      }, g, t);
  };
  fetch_xw(h0);
  fetch(0);
  cp_async_wait<0>();
  hopper::named_barrier(1 + slot, 128);      // the first head's x has landed
  read_xw();
  float dxa[P / 2];
  float rs0 = 0.f, rs1 = 0.f;
  int cbuf = 0;
  for (int k = 0; k < items; ++k) {
    const int q = k / n_i, qi = k % n_i;
    const int hh = h0 + q, i0 = (jt + qi) * kT;
    const float* cq = cum + q * kMaxL;
    if (qi == 0) {
#pragma unroll
      for (int e = 0; e < P / 2; ++e) dxa[e] = 0.f;
      rs0 = rs1 = 0.f;
    }
    cp_async_wait<0>();
    hopper::named_barrier(1 + slot, 128);      // the raw rows have landed
    // dy's halves (the previous item's products are done with them).
#pragma unroll
    for (int u = 0; u < KP; ++u) {
      const int p = 8 * u + pc;
      const float2 v = *reinterpret_cast<const float2*>(raw + ni * S::RLD + p);
      uint32_t hx, lx, hy, ly;
      split(v.x, hx, lx);
      split(v.y, hy, ly);
      const int oP = (p / 4) * 32 + (ni / 8) * (8 * P) + (ni % 8) * 4 + p % 4;
      *reinterpret_cast<uint2*>(dyP_hi + oP) = make_uint2(hx, hy);
      *reinterpret_cast<uint2*>(dyP_lo + oP) = make_uint2(lx, ly);
      const int oI = (ki / 4) * 36 + (p / 8) * 288 + (p % 8) * 4 + ki % 4;
      dyI_hi[oI] = __uint_as_float(hx);
      dyI_hi[oI + 4] = __uint_as_float(hy);
      dyI_lo[oI] = __uint_as_float(lx);
      dyI_lo[oI + 4] = __uint_as_float(ly);
    }
    hopper::fence_async_smem();
    hopper::named_barrier(1 + slot, 128);      // ... converted; raw is free
    if (k + 1 < items) fetch(k + 1);           // in flight during the products

    // L and M^T = G^T * L^T at the thread's 16 positions (accumulator order:
    // e = 4 kk + c is row jr + 8 (c / 2), column 32 slot + 8 kk + 2 t + c % 2).
    float L[16], M[16];
    {
      const float cj0 = cq[j0 + jr], cj1 = cq[j0 + jr + 8];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 gv = *reinterpret_cast<const float4*>(
            Gp + ((qi * 4 + kk) * kThreads + tid) * 4);
        const int il = 32 * slot + 8 * kk + 2 * t;
        const float ci0 = cq[i0 + il], ci1 = cq[i0 + il + 1];
        const float d[4] = {ci0 - cj0, ci1 - cj0, ci0 - cj1, ci1 - cj1};
        const bool keep[4] = {qi > 0 || il >= jr, qi > 0 || il + 1 >= jr,
                              qi > 0 || il >= jr + 8,
                              qi > 0 || il + 1 >= jr + 8};
        const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          L[4 * kk + c] = keep[c] ? __expf(d[c]) : 0.f;
          M[4 * kk + c] = gg[c] * L[4 * kk + c];
        }
      }
    }
    // dx += M^T dy_i over the warpgroup's 32 rows i; the A columns t, t + 4
    // of k-step kk are the accumulator's columns 2t, 2t + 1.
    auto mfrag = [&](int kk, FragA& f) {
      split(M[4 * kk + 0], f.hi[0], f.lo[0]);
      split(M[4 * kk + 2], f.hi[1], f.lo[1]);
      split(M[4 * kk + 1], f.hi[2], f.lo[2]);
      split(M[4 * kk + 3], f.hi[3], f.lo[3]);
    };
    FragA mf[2];
    mfrag(0, mf[0]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::wgmma_fence();
      wgmma3<P>(dxa, mf[kk & 1], dI_hi + 18 * kk, dI_lo + 18 * kk);
      hopper::wgmma_commit();
      if (kk < 3) {
        hopper::wgmma_wait<1>();               // kk - 1 is done
        pin(mf[(kk + 1) & 1]);
        mfrag(kk + 1, mf[(kk + 1) & 1]);
      }
    }
    // dM^T = x_j dy_i^T over the warpgroup's 32 columns i.
    float dm[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) dm[e] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KP; ++ks)
      wgmma3<32>(dm, xf[ks], dP_hi + 16 * ks, dP_lo + 16 * ks);
    hopper::wgmma_commit();
    // No accumulator is read before every product of the item is done:
    // ptxas serializes every wgmma of a kernel that reads one earlier (C7514).
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dm);
    hopper::fence_regs(dxa);
    pin(mf[0]);
    pin(mf[1]);
#pragma unroll
    for (int ks = 0; ks < KP; ++ks) pin(xf[ks]);

    // dG^T += dM^T * L^T (this tile's sum over the group's heads, in head
    // order); dseg^T = dM^T * M^T.
    float cs[8];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float dg[4], ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dg[c] = dm[4 * kk + c] * L[4 * kk + c];
        ds[c] = dm[4 * kk + c] * M[4 * kk + c];
      }
      float4* gp = reinterpret_cast<float4*>(
          dGp + ((qi * 4 + kk) * kThreads + tid) * 4);
      if (q == 0) {
        *gp = make_float4(dg[0], dg[1], dg[2], dg[3]);
      } else {
        const float4 o = *gp;
        *gp = make_float4(o.x + dg[0], o.y + dg[1], o.z + dg[2], o.w + dg[3]);
      }
      rs0 += ds[0] + ds[1];
      rs1 += ds[2] + ds[3];
      cs[2 * kk] = ds[0] + ds[2];
      cs[2 * kk + 1] = ds[1] + ds[3];
    }
    // Column sums over the warp's 16 rows j, then over the four warps.
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        cs[c] += __shfl_xor_sync(0xffffffffu, cs[c], o);
    float* cb = csum + (slot * 2 + cbuf) * 4 * 32;
    if (g == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        cb[w4 * 32 + 8 * kk + 2 * t] = cs[2 * kk];
        cb[w4 * 32 + 8 * kk + 2 * t + 1] = cs[2 * kk + 1];
      }
    }
    hopper::named_barrier(1 + slot, 128);
    if (tw < 32) {
      // Row i of dcum as this j-tile sees it; c adds dw w to the rows of
      // the j-tile and sum_j dw_j w_j to row l - 1.
      const float v = ((cb[tw] + cb[32 + tw]) + cb[64 + tw]) + cb[96 + tw];
      const int i = i0 + 32 * slot + tw;
      if (qi == 0)
        dclc[32 * slot + tw] = v;
      else if (i == l - 1)
        lastv[q] = v;
      else if (i < l)
        ws_dcum[((bc * h + hh) * n_it + jt) * (long long)l + i] = v;
    }
    cbuf ^= 1;

    if (qi == n_i - 1) {
      // The head is done: the two warpgroups' sums over their rows i meet.
      // Each warpgroup writes columns [slot PH, + PH) of dx: it hands the
      // other half of its sum over through its own dy area (c adds the
      // state part).
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, o);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, o);
      }
      if (t == 0) {
        rsum[slot * kT + jr] = rs0;
        rsum[slot * kT + jr + 8] = rs1;
      }
      if (q + 1 < nh) fetch_xw(hh + 1);
      cp_async_commit();
      // dxa's blocks [0, KH) are columns [0, PH), [KH, 2 KH) the rest; the
      // selects keep dxa's indices constant (a runtime index would put it
      // in local memory).
      float* xo = smem + S::DY + slot * S::DYW;
#pragma unroll
      for (int kb = 0; kb < KH; ++kb) {
        const int e0 = 4 * kb, e1 = 4 * (KH + kb);  // other half: e1 if slot 0
        *reinterpret_cast<float4*>(xo + (kb * 128 + tw) * 4) =
            slot ? make_float4(dxa[e0], dxa[e0 + 1], dxa[e0 + 2], dxa[e0 + 3])
                 : make_float4(dxa[e1], dxa[e1 + 1], dxa[e1 + 2], dxa[e1 + 3]);
      }
      __syncthreads();
      const float* xi = smem + S::DY + (1 - slot) * S::DYW;
      float* xb = dx + (bc * l + j0) * xld + (long long)hh * P + slot * PH;
#pragma unroll
      for (int kb = 0; kb < KH; ++kb) {
        const int e0 = 4 * kb, e1 = 4 * (KH + kb);  // own half: e0 if slot 0
        const float4 d = slot ? make_float4(dxa[e1], dxa[e1 + 1], dxa[e1 + 2],
                                            dxa[e1 + 3])
                              : make_float4(dxa[e0], dxa[e0 + 1], dxa[e0 + 2],
                                            dxa[e0 + 3]);
        const float4 o = *reinterpret_cast<const float4*>(xi + (kb * 128 + tw) * 4);
        if (j0 + jr < l)
          *reinterpret_cast<float2*>(xb + jr * xld + 8 * kb + 2 * t) =
              make_float2(d.x + o.x, d.y + o.y);
        if (j0 + jr + 8 < l)
          *reinterpret_cast<float2*>(xb + (jr + 8) * xld + 8 * kb + 2 * t) =
              make_float2(d.z + o.z, d.w + o.w);
      }
      if (tid < kT)
        rec[q * kT + tid] = dclc[tid] - (rsum[tid] + rsum[kT + tid]);
      cp_async_wait<0>();
      __syncthreads();               // the hand-over and the sums are read;
      if (q + 1 < nh) read_xw();     // the next head's x has landed
    }
  }

  // The group's dG tiles, rows i (the layout the finishing kernel reads).
  const int tri_n = n_it * (n_it + 1) / 2;
  for (int qi = 0; qi < n_i; ++qi) {
    float* out = ws_dg + ((bc * groups + grp) * tri_n + tri(jt + qi, jt)) *
                             (long long)(kT * kT);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 v = *reinterpret_cast<const float4*>(
          dGp + ((qi * 4 + kk) * kThreads + tid) * 4);
      const int il = 32 * slot + 8 * kk + 2 * t;
      out[il * kT + jr] = v.x;
      out[(il + 1) * kT + jr] = v.y;
      out[il * kT + jr + 8] = v.z;
      out[(il + 1) * kT + jr + 8] = v.w;
    }
  }
  __syncthreads();                   // the scratch and G^T are free

  // c. The state terms, per head.  dS arrives raw by cp.async (the next
  // head's while this one computes; the first with B_j) and is converted
  // into TF32 halves at st: first as the B operand of x dS (N = n, K = p;
  // element (p, m) at (p / 4) * 32 + (m / 8) * 8P + (m % 8) * 4 + p % 4),
  // then of B dS^T (N = p, K = n; element (m, p) at (m / 4) * 32 + (p / 8)
  // * 8N + (p % 8) * 4 + m % 4).  x's j-tile comes the same way, into the
  // G^T region, and its A fragments are read from there; so does b's sum of
  // the head's dx (two buffers), to which (B_j dS^T) * w is added before dx
  // is written.  B_j is loaded again.
  float* s_hi = st;
  float* s_lo = st + P * N;
  float* rds = smem + S::RDS;
  const bool xds_mine = slot == 0 || N >= 16;  // n = 8: warpgroup 0 alone
  float dbs[NSH / 2];
#pragma unroll
  for (int e = 0; e < NSH / 2; ++e) dbs[e] = 0.f;
  float* xt = smem + S::GP;                    // x's j-tile, rows of P + 4
  auto fetch_xt = [&](int hh) {
    const float* xb = x + x_head + (long long)hh * P;
#pragma unroll 1   // issue only: unrolled, its addresses spill
    for (int e = tid; e < kT * (P / 4); e += kThreads) {
      const int r = e / (P / 4), c = 4 * (e % (P / 4));
      const bool ok = j0 + r < l;
      cp_async16(xt + r * (P + 4) + c, ok ? xb + r * xld + c : xb, ok);
    }
  };
  auto fetch_ds = [&](int hh) {
    const float* dsq = dst + (bc * h + hh) * (long long)(P * N);
#pragma unroll 1   // issue only: unrolled, its addresses spill
    for (int e = tid; e < P * N / 4; e += kThreads) {
      const int p = e / (N / 4), c = 4 * (e % (N / 4));
      cp_async16(rds + p * S::SLD + c, dsq + p * N + c, true);
    }
  };
  float* dxt = xt + kT * (P + 4);             // b's dx, 2 x rows of P + 8
  auto fetch_dx = [&](int hh, float* buf) {
    const float* xb = dx + x_head + (long long)hh * P;
#pragma unroll 1   // issue only: unrolled, its addresses spill
    for (int e = tid; e < kT * (P / 4); e += kThreads) {
      const int r = e / (P / 4), c = 4 * (e % (P / 4));
      const bool ok = j0 + r < l;
      cp_async16(buf + r * (P + 8) + c, ok ? xb + r * xld + c : xb, ok);
    }
  };
  load_tile_async(Bj, S::BLD, Bb + (long long)j0 * N, N, N, l - j0);
  fetch_ds(h0);
  fetch_xt(h0);
  fetch_dx(h0, dxt);
  cp_async_commit();
  for (int q = 0; q < ((SSD_BWD_PHASES & 4) ? nh : 0); ++q) {
    const int hh = h0 + q;
    const float* cq = cum + q * kMaxL;
    cp_async_wait<0>();
    __syncthreads();                 // this head's dS and x have landed
    // (Loops with constant trip counts, unrolled: a loop of one load and
    // its use waits out each load in turn.)
    constexpr int S1_BLOCKS = (N / 8) * (P / 4);     // 32 elements each
#pragma unroll 4
    for (int u = 0; u < (S1_BLOCKS + 7) / 8; ++u) {
      const int b = warp + 8 * u;
      if (S1_BLOCKS % 8 == 0 || b < S1_BLOCKS) {
        const int m = (b % (N / 8)) * 8 + (lane & 7);
        const int p = (b / (N / 8)) * 4 + (lane >> 3);
        uint32_t hi, lo;
        split(rds[p * S::SLD + m], hi, lo);
        const int o = (p / 4) * 32 + (m / 8) * (8 * P) + (m % 8) * 4 + p % 4;
        s_hi[o] = __uint_as_float(hi);
        s_lo[o] = __uint_as_float(lo);
      }
    }
    hopper::fence_async_smem();
    __syncthreads();
    const float clast = cq[l - 1];
    const float w0 = expf(clast - cq[j0 + jr]);
    const float w1 = expf(clast - cq[j0 + jr + 8]);
    if (xds_mine) {
      // x dS over this warpgroup's columns [slot NSH, + NSH) of n; A = x's
      // rows from the tile, KX k-steps a wgmma group, the next group's
      // fragments built while one runs.
      constexpr int KX = KP < 2 ? KP : 2;
      float acc[NSH / 2];
#pragma unroll
      for (int e = 0; e < NSH / 2; ++e) acc[e] = 0.f;
      const int off = slot * (NSH / 8) * 8 * P;
      const uint64_t d_hi = hopper::noswz_desc(s_hi + off, 128, 32 * P);
      const uint64_t d_lo = hopper::noswz_desc(s_lo + off, 128, 32 * P);
      auto xfrag = [&](int ks) {
        return load_a([&](int r, int k) {
          return xt[(16 * w4 + r) * (P + 4) + 8 * ks + k];
        }, g, t);
      };
      FragA xf[2][KX];
#pragma unroll
      for (int kb = 0; kb < KX; ++kb) xf[0][kb] = xfrag(kb);
#pragma unroll
      for (int gb = 0; gb < KP / KX; ++gb) {
        hopper::wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < KX; ++kb) {
          const int ks = gb * KX + kb;
          wgmma3<NSH>(acc, xf[gb & 1][kb], d_hi + 16 * ks, d_lo + 16 * ks);
        }
        hopper::wgmma_commit();
        if (gb + 1 < KP / KX) {
          hopper::wgmma_wait<1>();           // gb - 1 is done with its half
#pragma unroll
          for (int kb = 0; kb < KX; ++kb) {
            pin(xf[(gb + 1) & 1][kb]);
            xf[(gb + 1) & 1][kb] = xfrag((gb + 1) * KX + kb);
          }
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
#pragma unroll
      for (int kb = 0; kb < KX; ++kb) {
        pin(xf[0][kb]);
        pin(xf[1][kb]);
      }
      float dw0 = 0.f, dw1 = 0.f;
#pragma unroll
      for (int e = 0; e < NSH / 2; ++e) {
        const int m = slot * NSH + 8 * (e / 4) + 2 * t + (e & 1);
        const int r = jr + ((e & 2) ? 8 : 0);
        dbs[e] = fmaf((e & 2) ? w1 : w0, acc[e], dbs[e]);
        const float bv = Bj[r * S::BLD + m] * acc[e];
        if (e & 2) dw1 += bv; else dw0 += bv;
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        dw0 += __shfl_xor_sync(0xffffffffu, dw0, o);
        dw1 += __shfl_xor_sync(0xffffffffu, dw1, o);
      }
      if (t == 0) {
        dwh[slot * kT + jr] = dw0;
        dwh[slot * kT + jr + 8] = dw1;
      }
    }
    __syncthreads();                 // the first halves are read; dwh is full
    if (tid < kT) {
      const float wj = expf(clast - cq[j0 + tid]);
      dwq[tid] = (dwh[tid] + (N >= 16 ? dwh[kT + tid] : 0.f)) * wj;
    }
    constexpr int S2_VECS = P * N / 4;
#pragma unroll 4
    for (int u = 0; u < (S2_VECS + kThreads - 1) / kThreads; ++u) {
      const int e = tid + kThreads * u;
      if (S2_VECS % kThreads != 0 && e >= S2_VECS) break;
      const int p = e % P, m = (e / P) * 4;
      const float4 v = *reinterpret_cast<const float4*>(rds + p * S::SLD + m);
      uint32_t h4[4], l4[4];
      split(v.x, h4[0], l4[0]);
      split(v.y, h4[1], l4[1]);
      split(v.z, h4[2], l4[2]);
      split(v.w, h4[3], l4[3]);
      const int o = (m / 4) * 32 + (p / 8) * (8 * N) + (p % 8) * 4;
      *reinterpret_cast<uint4*>(s_hi + o) = make_uint4(h4[0], h4[1], h4[2], h4[3]);
      *reinterpret_cast<uint4*>(s_lo + o) = make_uint4(l4[0], l4[1], l4[2], l4[3]);
    }
    hopper::fence_async_smem();
    __syncthreads();                 // the raw dS and x are read: refill
    if (q + 1 < nh) {
      fetch_ds(hh + 1);
      fetch_xt(hh + 1);
      fetch_dx(hh + 1, dxt + ((q + 1) & 1) * kT * (P + 8));
    }
    cp_async_commit();
    // The head's dcum rows of the j-tile: b's row sums less dw w; row l - 1
    // also gets sum_j dw_j w_j (b kept its part when l - 1 lies past the
    // j-tile).
    {
      float* wc = ws_dcum + ((bc * h + hh) * n_it + jt) * (long long)l;
      if (tid < kT && j0 + tid < l - 1)
        wc[j0 + tid] = rec[q * kT + tid] - dwq[tid];
      if (tid == 0) {
        float s = 0.f;
#pragma unroll 16
        for (int j = 0; j < kT; ++j) s += dwq[j];
        const int r = l - 1 - j0;
        wc[l - 1] = r < kT ? (rec[q * kT + r] + s) - dwq[r] : lastv[q] + s;
      }
    }
    {
      // (B_j dS^T) * w over this warpgroup's columns [slot PH, + PH) of p,
      // A = B_j from registers, KB k-steps a wgmma group (2 at n = 128: 4
      // spill), the next group's fragments built while one runs.
      constexpr int KS = N / 8, KB = KS < 4 ? KS : (N > 64 ? 2 : 4);
      float acc[PH / 2];
#pragma unroll
      for (int e = 0; e < PH / 2; ++e) acc[e] = 0.f;
      const int off = slot * (PH / 8) * 8 * N;
      const uint64_t d_hi = hopper::noswz_desc(s_hi + off, 128, 32 * N);
      const uint64_t d_lo = hopper::noswz_desc(s_lo + off, 128, 32 * N);
      auto bfrag = [&](int ks) {
        return load_a([&](int r, int k) {
          return Bj[(16 * w4 + r) * S::BLD + 8 * ks + k];
        }, g, t);
      };
      FragA bf[2][KB];
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) bf[0][kb] = bfrag(kb);
#pragma unroll
      for (int gb = 0; gb < KS / KB; ++gb) {
        hopper::wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          const int ks = gb * KB + kb;
          wgmma3<PH>(acc, bf[gb & 1][kb], d_hi + 16 * ks, d_lo + 16 * ks);
        }
        hopper::wgmma_commit();
        if (gb + 1 < KS / KB) {
          hopper::wgmma_wait<1>();           // gb - 1 is done with its half
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            pin(bf[(gb + 1) & 1][kb]);
            bf[(gb + 1) & 1][kb] = bfrag((gb + 1) * KB + kb);
          }
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        pin(bf[0][kb]);
        pin(bf[1][kb]);
      }
      float* xb = dx + x_head + (long long)hh * P + slot * PH;
      const float* db = dxt + (q & 1) * kT * (P + 8) + slot * PH;
#pragma unroll
      for (int e = 0; e < PH / 2; e += 2) {
        const int r = jr + ((e & 2) ? 8 : 0), c = 8 * (e / 4) + 2 * t;
        const float wr = (e & 2) ? w1 : w0;
        const float2 o = *reinterpret_cast<const float2*>(db + r * (P + 8) + c);
        if (j0 + r < l)
          *reinterpret_cast<float2*>(xb + r * xld + c) =
              make_float2(o.x + acc[e] * wr, o.y + acc[e + 1] * wr);
      }
    }
    __syncthreads();                 // the second halves are read
  }
  if (xds_mine) {
    float* out = ws_dbs + ((bc * groups + grp) * l + j0) * (long long)N;
#pragma unroll
    for (int e = 0; e < NSH / 2; e += 2) {
      const int r = jr + ((e & 2) ? 8 : 0);
      const int m = slot * NSH + 8 * (e / 4) + 2 * t;
      if (j0 + r < l)
        *reinterpret_cast<float2*>(out + (long long)r * N + m) =
            make_float2(dbs[e], dbs[e + 1]);
    }
  }
}

// dC (kind 0) or dB (kind 1) rows of one 64-row tile r of one (b, c):
// dC[r] = sum_{jt <= r} dG(r, jt) B[jt], dB[r] = sum_{it >= r} dG(it, r)^T
// C[it] + the state part, each dG tile and the state part summed over the
// head groups in group order, a group's loads all in flight together (a
// loop of one load and one add a group waits out each load in turn); the B
// or C tile by cp.async, in flight during the sums.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_bwd_bc_kernel(const float* __restrict__ B,
                        const float* __restrict__ C,
                        const float* __restrict__ ws_dg,
                        const float* __restrict__ ws_dbs,
                        float* __restrict__ dB, float* __restrict__ dC, int l,
                        int groups) {
  constexpr int NL = N + 4;          // B / C rows: 16-byte aligned
  constexpr int CN = (N + 15) / 16;
  constexpr int EPT = kT * kT / kThreads;   // dG elements a thread sums
  extern __shared__ __align__(16) float smem[];
  float* Gt = smem;                  // kT x kGL
  float* Tt = smem + kT * kGL;       // kT x NL: a B or C tile
  const int n_it = (l + kT - 1) / kT;
  const int tri_n = n_it * (n_it + 1) / 2;
  const int kind = blockIdx.x & 1;
  const int rt = (int)((blockIdx.x >> 1) % n_it);
  const long long bc = (blockIdx.x >> 1) / n_it;
  const int r0 = rt * kT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long tile = (long long)kT * kT;

  float acc[4][CN] = {};
  if (kind == 1) {
    for (int g = 0; g < groups; ++g) {
      const float* src = ws_dbs + ((bc * groups + g) * l + r0) * (long long)N;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          const int j = ty + 16 * r, n = tx + 16 * c;
          if (r0 + j < l && n < N) acc[r][c] += src[(long long)j * N + n];
        }
    }
  }
  const int lo = kind ? rt : 0, hi = kind ? n_it - 1 : rt;
  for (int o = lo; o <= hi; ++o) {
    const int it = kind ? o : rt, jt = kind ? rt : o;
    const int t0 = (kind ? it : jt) * kT;
    load_tile_async(Tt, NL, (kind ? C : B) + (bc * l + t0) * N, N, N,
                    l - t0);
    cp_async_commit();
    const float* src = ws_dg + (bc * groups * tri_n + tri(it, jt)) * tile;
    float gs[EPT] = {};
    for (int g = 0; g < groups; ++g) {
#pragma unroll
      for (int u = 0; u < EPT; ++u)
        gs[u] += src[g * tri_n * tile + tid + u * kThreads];
    }
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int e = tid + u * kThreads;
      Gt[(e / kT) * kGL + e % kT] = gs[u];
    }
    cp_async_wait<0>();
    __syncthreads();
    auto tb = [&](int k, int n) { return n < N ? Tt[k * NL + n] : 0.f; };
    if (kind == 0)
      fma_tile<kT>(acc, [&](int i, int k) { return Gt[i * kGL + k]; }, tb, ty,
                   tx);
    else
      fma_tile<kT>(acc, [&](int j, int k) { return Gt[k * kGL + j]; }, tb, ty,
                   tx);
    __syncthreads();
  }
  float* out = (kind ? dB : dC) + (bc * l + r0) * N;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      const int i = ty + 16 * r, n = tx + 16 * c;
      if (r0 + i < l && n < N) out[(long long)i * N + n] = acc[r][c];
    }
}

// da of one (b*c, head): dcum[i] = sum over the j-tiles <= i's tile of their
// partial rows, then da = its reverse inclusive scan over the chunk.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_da_kernel(const float* __restrict__ ws_dcum,
                        float* __restrict__ da, int l, int h) {
  __shared__ float wsum[kThreads / 32];
  const long long bh = blockIdx.x;
  const long long bc = bh / h;
  const int hh = (int)(bh % h);
  const int n_it = (l + kT - 1) / kT;
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  float v = 0.f;
  if (i < l)
    for (int jt = 0; jt <= i / kT; ++jt)
      v += ws_dcum[(bh * n_it + jt) * l + i];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v += u;
  }
  if (lane == 0) wsum[warp] = v;
  __syncthreads();
  for (int w = warp + 1; w < kThreads / 32; ++w) v += wsum[w];
  if (i < l) da[(bc * l + i) * h + hh] = v;
}

struct Args {
  const float *x, *a, *B, *C, *dy, *dst;
  float *dx, *da, *dB, *dC, *ws;
  int bc, l, h;
};

template <int P, int N>
cudaError_t launch_bwd(const Args& g, long long ws_floats, cudaStream_t s) {
  // The same arithmetic as bwd_plan() in kernels/ssd/kernel.py.
  const int n_it = (g.l + kT - 1) / kT;
  const int groups = (g.h + kHG - 1) / kHG;
  const int hg = (g.h + groups - 1) / groups;
  const Workspace w(g.bc, g.l, g.h, N, groups);
  if (ws_floats < w.floats()) return cudaErrorInvalidValue;
  const long long blocks = (long long)n_it * g.bc * groups;
  if (blocks > INT_MAX || (long long)g.bc * g.h > INT_MAX)
    return cudaErrorInvalidValue;
  float* ws_dg = g.ws;
  float* ws_dbs = ws_dg + w.dg;
  float* ws_dcum = ws_dbs + w.dbs;

  auto k1 = ssd_chunk_bwd_kernel<P, N>;
  const size_t smem1 = BwdSmem<P, N>::bytes();
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  k1<<<(unsigned)blocks, kThreads, smem1, s>>>(g.x, g.a, g.B, g.C, g.dy,
                                               g.dst, g.dx, ws_dg, ws_dbs,
                                               ws_dcum, g.bc, g.l, g.h, hg,
                                               groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto k2 = ssd_chunk_bwd_bc_kernel<N>;
  const size_t smem2 = sizeof(float) * (kT * kGL + kT * (N + 4));
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  k2<<<(unsigned)(2 * n_it * g.bc), kThreads, smem2, s>>>(
      g.B, g.C, ws_dg, ws_dbs, g.dB, g.dC, g.l, groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_chunk_bwd_da_kernel<<<(unsigned)(g.bc * g.h), kThreads, 0, s>>>(
      ws_dcum, g.da, g.l, g.h);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_bwd_p(int n, const Args& g, long long ws, cudaStream_t s) {
  switch (n) {
    case 8: return launch_bwd<P, 8>(g, ws, s);
    case 16: return launch_bwd<P, 16>(g, ws, s);
    case 64: return launch_bwd<P, 64>(g, ws, s);
    case 128: return launch_bwd<P, 128>(g, ws, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int P>
long long bwd_smem_p(int n) {
  switch (n) {
    case 8: return (long long)BwdSmem<P, 8>::bytes();
    case 16: return (long long)BwdSmem<P, 16>::bytes();
    case 64: return (long long)BwdSmem<P, 64>::bytes();
    case 128: return (long long)BwdSmem<P, 128>::bytes();
    default: return 0;
  }
}

}  // namespace

// Dynamic shared memory, in bytes, of one ssd_chunk_bwd_kernel block at
// (l, p, n); 0 for what no kernel takes.  bwd_plan().smem_bytes in
// kernels/ssd/kernel.py mirrors it, and chip_smoke.py holds the two equal.
extern "C" long long ssd_chunk_bwd_smem_bytes(int l, int p, int n) {
  if (l <= 0 || l > kMaxL) return 0;
  switch (p) {
    case 16: return bwd_smem_p<16>(n);
    case 64: return bwd_smem_p<64>(n);
    default: return 0;
  }
}

// Gradients of ssd_chunk_fwd.  x, dy, dx: (bc, l, h, p); a, da: (bc, l, h);
// B, C, dB, dC: (bc, l, n); dst: (bc, h, p, n); ws: `ws_floats` f32 of
// scratch (bwd_plan().ws_floats; every entry read is written first).  All
// f32, contiguous; bc = batch * chunks.  p in {16, 64}, n in {8, 16, 64,
// 128}, 1 <= l <= 256.  Three launches on `stream`; returns
// cudaGetLastError() after them (0 on success).
extern "C" int ssd_chunk_bwd(const void* x, const void* a, const void* B,
                             const void* C, const void* dy, const void* dst,
                             void* dx, void* da, void* dB, void* dC, void* ws,
                             long long ws_floats, int bc, int l, int h, int p,
                             int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc <= 0 || h <= 0 || l <= 0 || l > kMaxL)
    return (int)cudaErrorInvalidValue;
  const Args g{static_cast<const float*>(x),  static_cast<const float*>(a),
               static_cast<const float*>(B),  static_cast<const float*>(C),
               static_cast<const float*>(dy), static_cast<const float*>(dst),
               static_cast<float*>(dx),       static_cast<float*>(da),
               static_cast<float*>(dB),       static_cast<float*>(dC),
               static_cast<float*>(ws),       bc, l, h};
  switch (p) {
    case 16: return (int)launch_bwd_p<16>(n, g, ws_floats, s);
    case 64: return (int)launch_bwd_p<64>(n, g, ws_floats, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
