// SSD intra-chunk block (Mamba2) for Hopper (sm_90a), f32 in and out.
//
// Replaces the TPU kernel `ssd_chunk_pallas` / `_ssd_chunk_kernel`
// (src/repro/kernels/ssd/kernel.py).  For one (batch, chunk, head), with
// cum = cumsum(a) over the chunk (l <= 256 steps):
//   y_diag[i, :]   = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * x[j, :]
//   state[:, k]    = sum_j x[j, :] * exp(cum_last - cum_j) * B[j, k]
// B and C are shared by all heads.  Outputs: y (b, c, l, h, p) and states
// (b, c, h, p, n), the layout `ssd_chunk_pallas` returns (not its docstring's).
//
// Bound on the H100: f32 operations (two chained products under a decay
// mask; 67 TFLOP/s without the tensor cores), since the inputs are read once
// and the scores never leave the SM.  No TF32 and no bf16: the reference's
// tolerance is 1e-4 in f32.  Two kernels, launched together:
//   * ssd_ydiag_kernel: one CTA per (b*c, h, 64-row tile of i), heaviest tiles
//     first.  The CTA takes the prefix sum of a into shared memory, holds its C
//     tile, and walks the B / x tiles j <= i: each 64 x 64 score tile is formed
//     with f32 FMA (4 x 4 per thread), masked and scaled by exp(cum_i - cum_j)
//     (taken from the difference, and only for j <= i: exp(cum_i) * exp(-cum_j)
//     overflows, and exponentiating the masked half gives inf * 0 = NaN), kept
//     in shared memory, and multiplied into y held in registers.  The score
//     C . B is recomputed for every head (the TPU kernel does the same);
//     sharing it across heads is later work.
//   * ssd_states_kernel: one CTA per (b*c, h), the chunk's end state as a sum
//     of outer products x_j (x) (B_j * exp(cum_last - cum_j)), register-tiled.
// Inputs are read in place, in the layouts ssd/ops.py builds: x (b, c, l, h,
// p), a (b, c, l, h), B and C (b, c, l, n), all contiguous; nothing is
// transposed first.  A chunk length that is not a multiple of the 64-row tile
// is masked.
#include "common.cuh"

namespace {

constexpr int kT = 64;          // rows of a tile (i and j)
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kMaxL = 256;      // longest chunk: one a value per thread

// Inclusive prefix sum of a[0..l) (stride `stride`) into cum[0..l); l <= 256.
// Warp scans by shuffles, then the warp totals.  Ends with a barrier.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ a,
                                             long long stride, int l,
                                             float* cum) {
  __shared__ float wsum[kThreads / 32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  float v = t < l ? a[t * stride] : 0.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[w] = v;
  __syncthreads();
  float off = 0.f;
  for (int i = 0; i < w; ++i) off += wsum[i];
  if (t < l) cum[t] = v + off;
  __syncthreads();
}

template <int P, int N>
struct YSmem {
  static constexpr int CB_LD = N + 1;   // conflict-free reads along rows
  static constexpr int S_LD = kT + 1;
  static constexpr int CUM = 0;
  static constexpr int CS = CUM + kMaxL;
  static constexpr int BS = CS + kT * CB_LD;
  static constexpr int XS = BS + kT * CB_LD;
  static constexpr int SS = XS + kT * P;
  static constexpr int FLOATS = SS + kT * S_LD;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_ydiag_kernel(const float* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ B, const float* __restrict__ C,
                 float* __restrict__ y, int l, int h) {
  using S = YSmem<P, N>;
  constexpr int PC = P / 16;            // y columns per thread
  extern __shared__ __align__(16) float smem[];
  float* cum = smem + S::CUM;
  float* Cs = smem + S::CS;
  float* Bs = smem + S::BS;
  float* Xs = smem + S::XS;
  float* Ss = smem + S::SS;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int it = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int hh = blockIdx.y;
  const long long bc = blockIdx.z;
  const int i0 = it * kT;
  const long long xld = (long long)h * P;      // stride between x / y rows
  const float* xb = x + bc * l * xld + (long long)hh * P;
  float* yb = y + bc * l * xld + (long long)hh * P;
  const float* Bb = B + bc * l * N;
  const float* Cb = C + bc * l * N;

  chunk_cumsum(a + bc * l * h + hh, h, l, cum);
  for (int e = tid; e < kT * N; e += kThreads) {
    const int r = e / N, k = e % N;
    Cs[r * S::CB_LD + k] = i0 + r < l ? Cb[(long long)(i0 + r) * N + k] : 0.f;
  }

  float acc[4][PC];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int kk = 0; kk < PC; ++kk) acc[ii][kk] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();  // the last tile's readers are done (and Cs is visible)
    for (int e = tid; e < kT * N; e += kThreads) {
      const int r = e / N, k = e % N;
      Bs[r * S::CB_LD + k] = j0 + r < l ? Bb[(long long)(j0 + r) * N + k] : 0.f;
    }
    for (int e = tid; e < kT * P; e += kThreads) {
      const int r = e / P, c = e % P;
      Xs[r * P + c] = j0 + r < l ? xb[(j0 + r) * xld + c] : 0.f;
    }
    __syncthreads();

    // Scores of rows ty + 16 ii against columns tx + 16 jj.
    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 8
    for (int k = 0; k < N; ++k) {
      float cr[4], br[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        cr[q] = Cs[(ty + 16 * q) * S::CB_LD + k];
        br[q] = Bs[(tx + 16 * q) * S::CB_LD + k];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[ii][jj] = fmaf(cr[ii], br[jj], s[ii][jj]);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int i = i0 + ty + 16 * ii;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + tx + 16 * jj;
        float v = 0.f;
        if (j <= i && i < l) v = s[ii][jj] * expf(cum[i] - cum[j]);
        Ss[(ty + 16 * ii) * S::S_LD + tx + 16 * jj] = v;
      }
    }
    __syncthreads();

    // y rows ty + 16 ii, columns tx + 16 kk, += scores @ x.
#pragma unroll 4
    for (int c = 0; c < kT; ++c) {
      float sr[4], xr[PC];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) sr[ii] = Ss[(ty + 16 * ii) * S::S_LD + c];
#pragma unroll
      for (int kk = 0; kk < PC; ++kk) xr[kk] = Xs[c * P + tx + 16 * kk];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int kk = 0; kk < PC; ++kk) acc[ii][kk] = fmaf(sr[ii], xr[kk], acc[ii][kk]);
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = i0 + ty + 16 * ii;
    if (i < l) {
#pragma unroll
      for (int kk = 0; kk < PC; ++kk) yb[i * xld + tx + 16 * kk] = acc[ii][kk];
    }
  }
}

template <int P, int N>
struct StSmem {
  static constexpr int CUM = 0;
  static constexpr int XS = CUM + kMaxL;
  static constexpr int BS = XS + kT * P;
  static constexpr int FLOATS = BS + kT * N;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_states_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ B, float* __restrict__ st, int l,
                  int h) {
  using S = StSmem<P, N>;
  constexpr int PC = P / 16;             // state rows (p) per thread
  constexpr int NC = (N + 15) / 16;      // state columns (n) per thread
  extern __shared__ __align__(16) float smem[];
  float* cum = smem + S::CUM;
  float* Xs = smem + S::XS;
  float* Bs = smem + S::BS;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int hh = blockIdx.x;
  const long long bc = blockIdx.y;
  const long long xld = (long long)h * P;
  const float* xb = x + bc * l * xld + (long long)hh * P;
  const float* Bb = B + bc * l * N;

  chunk_cumsum(a + bc * l * h + hh, h, l, cum);
  const float last = cum[l - 1];

  float acc[PC][NC];
#pragma unroll
  for (int q = 0; q < PC; ++q)
#pragma unroll
    for (int r = 0; r < NC; ++r) acc[q][r] = 0.f;

  for (int j0 = 0; j0 < l; j0 += kT) {
    __syncthreads();  // the last tile's readers are done
    for (int e = tid; e < kT * P; e += kThreads) {
      const int r = e / P, c = e % P;
      Xs[e] = j0 + r < l ? xb[(j0 + r) * xld + c] : 0.f;
    }
    for (int e = tid; e < kT * N; e += kThreads) {
      const int r = e / N, k = e % N;
      const int j = j0 + r;
      // last - cum[j] <= 0 for a <= 0: the decay never overflows.
      Bs[e] = j < l ? Bb[(long long)j * N + k] * expf(last - cum[j]) : 0.f;
    }
    __syncthreads();
    const int rows = min(kT, l - j0);
    for (int r = 0; r < rows; ++r) {
      float xr[PC], br[NC];
#pragma unroll
      for (int q = 0; q < PC; ++q) xr[q] = Xs[r * P + ty + 16 * q];
#pragma unroll
      for (int k = 0; k < NC; ++k)
        br[k] = tx + 16 * k < N ? Bs[r * N + tx + 16 * k] : 0.f;
#pragma unroll
      for (int q = 0; q < PC; ++q)
#pragma unroll
        for (int k = 0; k < NC; ++k) acc[q][k] = fmaf(xr[q], br[k], acc[q][k]);
    }
  }

  float* sb = st + (bc * h + hh) * (long long)P * N;
#pragma unroll
  for (int q = 0; q < PC; ++q)
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (tx + 16 * k < N) sb[(ty + 16 * q) * N + tx + 16 * k] = acc[q][k];
}

template <int P, int N>
cudaError_t launch(const float* x, const float* a, const float* B,
                   const float* C, float* y, float* st, int bc, int l, int h,
                   cudaStream_t stream) {
  auto ykern = ssd_ydiag_kernel<P, N>;
  auto skern = ssd_states_kernel<P, N>;
  const size_t ysmem = YSmem<P, N>::BYTES, ssmem = StSmem<P, N>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ykern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ysmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      skern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ssmem);
  if (err != cudaSuccess) return err;
  const dim3 ygrid((l + kT - 1) / kT, h, bc), sgrid(h, bc);
  ykern<<<ygrid, kThreads, ysmem, stream>>>(x, a, B, C, y, l, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  skern<<<sgrid, kThreads, ssmem, stream>>>(x, a, B, st, l, h);
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

}  // namespace

// x, y: (bc, l, h, p); a: (bc, l, h); B, C: (bc, l, n); st: (bc, h, p, n);
// f32, contiguous; bc = batch * chunks.  p in {16, 64}, n in {8, 16, 64, 128},
// 1 <= l <= 256.  Returns cudaGetLastError() after the launches (0 on success).
extern "C" int ssd_chunk_fwd(const void* x, const void* a, const void* B,
                             const void* C, void* y, void* st, int bc, int l,
                             int h, int p, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc <= 0 || bc > 65535 || h <= 0 || h > 65535 || l <= 0 || l > kMaxL)
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
