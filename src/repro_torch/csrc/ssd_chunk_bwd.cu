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
// (b4 c4 l256 h64 p64 n64; 0.196 ms at 67 TFLOP/s in f32) against 224 MB
// read and written once (0.067 ms); mamba2's (h32 n128) 9.0 GFLOP.  This
// first kernel is the simple one: every product is f32 FMA over shared-memory
// tiles (exact f32, inside the 1e-4 tolerance without any splitting), each
// thread a 4 x 4 (or 4 x N/16) block of the output at rows ty + 16 r and
// columns tx + 16 c, rows padded to an odd stride so neither operand's reads
// conflict.  Nothing l x l is kept between the passes: G and L are
// recomputed from the saved inputs, as the flash backward recomputes P, and
// G once for a group of 4 heads.  On an H100 SXM at 700 W it takes 1.39 /
// 0.92 ms at those shapes, 7x the f32 bound: each product reads 8 shared
// floats for 16 FMAs, x and dy tiles load synchronously, and one CTA of 8
// warps an SM hides little latency; 3xTF32 on the tensor cores, as in the
// forward, is the way to the bound.
// Three launches on one stream:
//   1. ssd_chunk_bwd_kernel, one CTA per (b*c, 64-row j-tile, group of up to
//      4 heads), heaviest j-tiles first (`bwd_plan()` in kernels/ssd/kernel.py
//      mirrors it).  The CTA owns dx of its j-tile for its heads (summed in
//      shared memory over every i-tile >= its j-tile, then written once), and
//      loops i-tile by i-tile: G[i-tile, j-tile] once for the group (kept in
//      registers, each thread its own elements), then per head dM, L, the
//      dseg row and column sums and M^T dy.  It writes per-group partials:
//      sum_h dM * L of each (i-tile, j-tile), the state part of dB, and per
//      head the dcum rows that this j-tile's CTA sees.
//   2. ssd_chunk_bwd_bc_kernel, one CTA per (b*c, 64-row tile, dB or dC):
//      sums the groups' dG partials in a fixed order, then dC = dG B and
//      dB = dG^T C plus the groups' state parts.  So dB and dC, shared by
//      every head, are summed across head groups by a second pass over
//      per-group partials, never by atomics: two runs give the same bits.
//   3. ssd_chunk_bwd_da_kernel, one CTA per (b*c, head): dcum from the
//      j-tiles' partial rows (in j-tile order), then its reverse scan.
// The decay is taken from the difference and only for j <= i (exp(cum_i) *
// exp(-cum_j) overflows, and exponentiating the masked half gives inf * 0 =
// NaN).  Rows past l read as zeros, so they add nothing.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kT = 64;          // rows of an i- or j-tile
constexpr int kThreads = 256;   // a 16 x 16 grid of threads (ty, tx)
constexpr int kMaxL = 256;      // longest chunk: one row a thread in the scan
constexpr int kHG = 4;          // heads of a group
constexpr int kGL = kT + 1;     // row stride of a 64 x 64 tile
constexpr size_t kSmemLimit = 232448 - 128;   // H100, less the static `wsum`

// Shared memory of ssd_chunk_bwd_kernel, in floats: the prefix sums of the
// group's heads, the B j-tile, the C i-tile (or one head's dS, P x N, in the
// state phase), M of one (i-tile, head), the x j-tile and dy i-tile of one
// head (rows padded to odd strides), dx of each head's j-tile, the warps'
// column sums, and the j-tile rows' dcum of each head.
template <int P, int N>
struct BwdSmem {
  static constexpr int PL = P + 1;
  static constexpr int NL = N + 1;
  static constexpr int CUM = 0;                   // [kHG][kMaxL]
  static constexpr int BJ = CUM + kHG * kMaxL;    // kT x NL
  static constexpr int CI = BJ + kT * NL;         // kT x NL (dS: P x NL)
  static constexpr int MS = CI + kT * NL;         // kT x kGL
  static constexpr int XS = MS + kT * kGL;        // kT x PL
  static constexpr int DY = XS + kT * PL;         // kT x PL
  static constexpr int DX = DY + kT * PL;         // [kHG][kT][P]
  static constexpr int COL = DX + kHG * kT * P;   // [8 warps][kT]
  static constexpr int DCL = COL + 8 * kT;        // [kHG][kT]
  static constexpr int DW = DCL + kHG * kT;       // [kT]: dw_j w_j
  static constexpr int LAST = DW + kT;            // [kHG]: to dcum_last
  static constexpr int FLOATS = LAST + kHG;
  static constexpr size_t bytes() { return sizeof(float) * FLOATS; }
  static_assert(bytes() <= kSmemLimit, "shared memory");
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

// Rows [0, rows) of a (rows x COLS) f32 tile at `src` (row stride ld_src)
// into shared memory with row stride `ld_dst`; rows >= `valid` read 0.
template <int COLS>
__device__ __forceinline__ void load_tile(float* dst, int ld_dst,
                                          const float* src, long long ld_src,
                                          int rows, int valid) {
  for (int e = threadIdx.x; e < rows * COLS; e += kThreads) {
    const int r = e / COLS, c = e % COLS;
    float v = 0.f;
    if (r < valid) v = src[r * ld_src + c];
    dst[r * ld_dst + c] = v;
  }
}

// Sum over the 16 lanes of a half warp (one tx row of the thread grid).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ int tri(int it, int jt) {
  return it * (it + 1) / 2 + jt;   // (i-tile, j-tile <= i-tile) -> slot
}

// Workspace, in floats: dg [bc][group][tri][kT][kT] (sum_h dM * L), dbs
// [bc][group][l][N] (sum_h w * (x dS)), dcum [bc][h][j-tile][l] (the rows of
// dcum that one j-tile's CTA sees).  `bwd_plan()` mirrors the sizes.
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
  constexpr int CP = P / 16;                   // column groups of 64 x P
  constexpr int CN = (N + 15) / 16;            // ... of 64 x N
  extern __shared__ float smem[];
  __shared__ float wsum[kThreads / 32][kHG];
  float* cum = smem + S::CUM;
  float* Bj = smem + S::BJ;
  float* Ci = smem + S::CI;
  float* Ds = Ci;                              // in the state phase
  float* Ms = smem + S::MS;
  float* Xs = smem + S::XS;
  float* Dy = smem + S::DY;
  float* DX = smem + S::DX;
  float* col = smem + S::COL;
  float* dcl = smem + S::DCL;
  float* dwv = smem + S::DW;
  float* last = smem + S::LAST;

  // blockIdx.x -> (j-tile, b*c, group), the heaviest j-tile (0) first.
  const int n_it = (l + kT - 1) / kT;
  const int per_tile = bcs * groups;
  const int jt = (int)(blockIdx.x / per_tile);
  const int rem = (int)(blockIdx.x % per_tile);
  const long long bc = rem / groups;
  const int g = rem % groups;
  const int h0 = g * hg;
  const int nh = min(hg, h - h0);              // a ragged last group
  const int j0 = jt * kT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const long long xld = (long long)h * P;      // stride between x / dy rows
  const float* Bb = B + bc * l * N;
  const float* Cb = C + bc * l * N;

  // Inclusive prefix sums of the group's a over the chunk, one row a thread
  // (a past l reads 0, so cum stays at cum[l - 1] there).
  {
    float v[kHG];
#pragma unroll
    for (int q = 0; q < kHG; ++q) {
      v[q] = 0.f;
      if (tid < l && q < nh) v[q] = a[(bc * l + tid) * h + h0 + q];
    }
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
  load_tile<N>(Bj, S::NL, Bb + (long long)j0 * N, N, kT, l - j0);

  // The state terms, per head: x dS gives dB's state part and dw; (B * w)
  // dS^T starts dx.
  float dbs[4][CN];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CN; ++c) dbs[r][c] = 0.f;
  for (int q = 0; q < nh; ++q) {
    const float* cq = cum + q * kMaxL;
    const int hh = h0 + q;
    __syncthreads();                 // the previous head is done with Xs, Ds
    load_tile<P>(Xs, S::PL, x + (bc * l + j0) * xld + (long long)hh * P, xld,
                 kT, l - j0);
    load_tile<N>(Ds, S::NL, dst + (bc * h + hh) * (long long)(P * N), N, P, P);
    __syncthreads();
    const float clast = cq[l - 1];
    float wr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) wr[r] = expf(clast - cq[j0 + ty + 16 * r]);
    float xs[4][CN] = {};
    fma_tile<P>(xs, [&](int j, int k) { return Xs[j * S::PL + k]; },
                [&](int k, int n) { return n < N ? Ds[k * S::NL + n] : 0.f; },
                ty, tx);
    float dwp[4] = {};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int n = tx + 16 * c;
        if (n < N) {
          dbs[r][c] = fmaf(wr[r], xs[r][c], dbs[r][c]);
          dwp[r] = fmaf(Bj[(ty + 16 * r) * S::NL + n], xs[r][c], dwp[r]);
        }
      }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = sum16(dwp[r]) * wr[r];
      if (tx == 0) {
        dcl[q * kT + ty + 16 * r] = -v;
        dwv[ty + 16 * r] = v;
      }
    }
    float acc[4][CP] = {};
    fma_tile<N>(acc, [&](int j, int k) { return Bj[j * S::NL + k]; },
                [&](int k, int p) { return Ds[p * S::NL + k]; }, ty, tx);
    float* dxq = DX + q * kT * P;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CP; ++c)
        dxq[(ty + 16 * r) * P + tx + 16 * c] = acc[r][c] * wr[r];
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int j = 0; j < kT; ++j) s += dwv[j];
      last[q] = s;
    }
  }
  {
    float* out = ws_dbs + (bc * groups + g) * (long long)l * N;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int j = j0 + ty + 16 * r, n = tx + 16 * c;
        if (j < l && n < N) out[(long long)j * N + n] = dbs[r][c];
      }
  }

  const int tri_n = n_it * (n_it + 1) / 2;
  for (int it = jt; it < n_it; ++it) {
    const int i0 = it * kT;
    __syncthreads();                 // Ci / Ds and `last` are free
    load_tile<N>(Ci, S::NL, Cb + (long long)i0 * N, N, kT, l - i0);
    __syncthreads();
    // G[i-tile, j-tile] at the thread's (i, j), for every head of the group.
    float gr[4][4] = {};
    fma_tile<N>(gr, [&](int i, int k) { return Ci[i * S::NL + k]; },
                [&](int k, int j) { return Bj[j * S::NL + k]; }, ty, tx);
    float dgs[4][4] = {};
    for (int q = 0; q < nh; ++q) {
      const float* cq = cum + q * kMaxL;
      const int hh = h0 + q;
      load_tile<P>(Xs, S::PL, x + (bc * l + j0) * xld + (long long)hh * P,
                   xld, kT, l - j0);
      load_tile<P>(Dy, S::PL, dy + (bc * l + i0) * xld + (long long)hh * P,
                   xld, kT, l - i0);
      __syncthreads();
      float dm[4][4] = {};
      fma_tile<P>(dm, [&](int i, int k) { return Dy[i * S::PL + k]; },
                  [&](int k, int j) { return Xs[j * S::PL + k]; }, ty, tx);
      float rs[4] = {}, cs[4] = {};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const float ci = cq[i0 + i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          const bool keep = it > jt || j <= i;
          const float Lv = keep ? expf(ci - cq[j0 + j]) : 0.f;
          const float dG = dm[r][c] * Lv;
          dgs[r][c] += dG;
          const float ds = dG * gr[r][c];
          rs[r] += ds;
          cs[c] += ds;
          Ms[i * kGL + j] = gr[r][c] * Lv;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        cs[c] += __shfl_xor_sync(0xffffffffu, cs[c], 16);
        if (lane < 16) col[warp * kT + tx + 16 * c] = cs[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v = sum16(rs[r]);
        const int i = i0 + ty + 16 * r;
        if (tx == 0 && i < l) {
          const float vl = v + (i == l - 1 ? last[q] : 0.f);
          if (it == jt)
            dcl[q * kT + ty + 16 * r] += vl;
          else
            ws_dcum[((bc * h + hh) * n_it + jt) * (long long)l + i] = vl;
        }
      }
      __syncthreads();
      if (tid < kT) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kThreads / 32; ++w) s += col[w * kT + tid];
        dcl[q * kT + tid] -= s;
      }
      // dx[j-tile] += M^T dy[i-tile].
      float* dxq = DX + q * kT * P;
      float acc[4][CP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CP; ++c)
          acc[r][c] = dxq[(ty + 16 * r) * P + tx + 16 * c];
      fma_tile<kT>(acc, [&](int j, int k) { return Ms[k * kGL + j]; },
                   [&](int k, int p) { return Dy[k * S::PL + p]; }, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CP; ++c)
          dxq[(ty + 16 * r) * P + tx + 16 * c] = acc[r][c];
      __syncthreads();               // Xs, Dy, Ms and col are free
    }
    float* out = ws_dg + ((bc * groups + g) * tri_n + tri(it, jt)) *
                             (long long)(kT * kT);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[(ty + 16 * r) * kT + tx + 16 * c] = dgs[r][c];
  }

  // dx of the j-tile and the j-tile rows' dcum, each head's.
  for (int q = 0; q < nh; ++q) {
    const float* dxq = DX + q * kT * P;
    float* dxb = dx + (bc * l + j0) * xld + (long long)(h0 + q) * P;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const int j = ty + 16 * r, p = tx + 16 * c;
        if (j0 + j < l) dxb[j * xld + p] = dxq[j * P + p];
      }
  }
  for (int e = tid; e < nh * kT; e += kThreads) {
    const int q = e / kT, j = e % kT;
    if (j0 + j < l)
      ws_dcum[((bc * h + h0 + q) * n_it + jt) * (long long)l + j0 + j] = dcl[e];
  }
}

// dC (kind 0) or dB (kind 1) rows of one 64-row tile r of one (b, c):
// dC[r] = sum_{jt <= r} dG(r, jt) B[jt], dB[r] = sum_{it >= r} dG(it, r)^T
// C[it] + the state part, each dG tile and the state part summed over the
// head groups in group order.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_bwd_bc_kernel(const float* __restrict__ B,
                        const float* __restrict__ C,
                        const float* __restrict__ ws_dg,
                        const float* __restrict__ ws_dbs,
                        float* __restrict__ dB, float* __restrict__ dC, int l,
                        int groups) {
  constexpr int NL = N + 1;
  constexpr int CN = (N + 15) / 16;
  extern __shared__ float smem[];
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
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int j = r0 + ty + 16 * r, n = tx + 16 * c;
        if (j < l && n < N) {
          float s = 0.f;
          for (int g = 0; g < groups; ++g)
            s += ws_dbs[((bc * groups + g) * l + j) * (long long)N + n];
          acc[r][c] = s;
        }
      }
  }
  const int lo = kind ? rt : 0, hi = kind ? n_it - 1 : rt;
  for (int o = lo; o <= hi; ++o) {
    const int it = kind ? o : rt, jt = kind ? rt : o;
    const float* src = ws_dg + (bc * groups * tri_n + tri(it, jt)) * tile;
    for (int e = tid; e < kT * kT; e += kThreads) {
      float s = 0.f;
      for (int g = 0; g < groups; ++g) s += src[g * tri_n * tile + e];
      Gt[(e / kT) * kGL + e % kT] = s;
    }
    const int t0 = (kind ? it : jt) * kT;
    load_tile<N>(Tt, NL, (kind ? C : B) + (bc * l + t0) * N, N, kT, l - t0);
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
  const size_t smem2 = sizeof(float) * (kT * kGL + kT * (N + 1));
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
