// Row RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `rmsnorm_pallas` / `_rmsnorm_kernel`
// (src/repro/kernels/rmsnorm/kernel.py).  y = x * rsqrt(mean(x^2) + eps) * w,
// the mean taken in f32, the result cast back to the input type.
//
// Bound on the H100: bytes.  Each row is read and written once (2 * rows * d
// * sizeof(T) bytes over 3.35 TB/s); the arithmetic is a few FLOPs a byte.
// The design therefore only tries to move bytes at full width: 16-byte
// vector loads and stores when the row allows them, the x^2 sum reduced in
// registers and warp shuffles, one warp per row for short rows (d <= 1024,
// e.g. the d = 128 q/k norms over B*S*heads rows) and one CTA per row for long
// rows (d = 2048 .. 16384).  The second pass over the row re-reads it, which
// hits L1/L2 rather than device memory.  Any row count works (no padding to
// a row block as on the TPU).
#include "common.cuh"

namespace {

template <typename T, bool VEC>
__device__ __forceinline__ float row_sumsq(const T* __restrict__ x, int d,
                                           int t, int nt) {
  float acc = 0.f;
  if (VEC) {
    constexpr int N = 16 / sizeof(T);
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int i = t; i < d / N; i += nt) {
      float f[N];
      unpack16<T>(xv[i], f);
#pragma unroll
      for (int j = 0; j < N; ++j) acc += f[j] * f[j];
    }
  } else {
    for (int i = t; i < d; i += nt) {
      const float f = to_f(x[i]);
      acc += f * f;
    }
  }
  return acc;
}

template <typename T, bool VEC>
__device__ __forceinline__ void row_scale(const T* __restrict__ x,
                                          const T* __restrict__ w,
                                          T* __restrict__ y, int d, float r,
                                          int t, int nt) {
  if (VEC) {
    constexpr int N = 16 / sizeof(T);
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    uint4* yv = reinterpret_cast<uint4*>(y);
    for (int i = t; i < d / N; i += nt) {
      float fx[N], fw[N];
      unpack16<T>(xv[i], fx);
      unpack16<T>(wv[i], fw);
      uint4 out;
      T* e = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < N; ++j) e[j] = from_f<T>(fx[j] * r * fw[j]);
      yv[i] = out;
    }
  } else {
    for (int i = t; i < d; i += nt) y[i] = from_f<T>(to_f(x[i]) * r * to_f(w[i]));
  }
}

// 1 / sqrt(mean + eps) with IEEE sqrt and division, as the plain version.
__device__ __forceinline__ float inv_rms(float sumsq, int d, float eps) {
  return 1.0f / sqrtf(sumsq / (float)d + eps);
}

// One warp per row; blockDim.x / 32 rows per CTA.
template <typename T, bool VEC>
__global__ void rmsnorm_warp_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w, T* __restrict__ y,
                                    long long rows, int d, float eps) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * d;
  const float s = warp_sum(row_sumsq<T, VEC>(xr, d, lane, 32));
  row_scale<T, VEC>(xr, w, y + row * d, d, inv_rms(s, d, eps), lane, 32);
}

// One CTA per row.
template <typename T, bool VEC>
__global__ void rmsnorm_block_kernel(const T* __restrict__ x,
                                     const T* __restrict__ w,
                                     T* __restrict__ y, int d, float eps) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const float s = warp_sum(row_sumsq<T, VEC>(xr, d, threadIdx.x, blockDim.x));
  if (lane == 0) red[wid] = s;
  __syncthreads();
  if (wid == 0) {
    float v = lane < int(blockDim.x >> 5) ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  row_scale<T, VEC>(xr, w, y + row * d, d, inv_rms(red[0], d, eps),
                    threadIdx.x, blockDim.x);
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, const void* w, void* y, long long rows,
                   int d, float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (d <= 1024) {
    constexpr int kThreads = 256;  // 8 rows per CTA
    const long long rows_per_cta = kThreads / 32;
    const unsigned grid = (unsigned)((rows + rows_per_cta - 1) / rows_per_cta);
    rmsnorm_warp_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(xp, wp, yp, rows,
                                                               d, eps);
  } else {
    const int units = VEC ? d / int(16 / sizeof(T)) : d;
    int threads = ((units + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
    rmsnorm_block_kernel<T, VEC><<<(unsigned)rows, threads, 0, stream>>>(
        xp, wp, yp, d, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x, w, y: device pointers; x and y are (rows, d) row-major, w is (d,).
// vec != 0: all three are 16-byte aligned and d * sizeof(T) % 16 == 0.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y,
                           long long rows, int d, float eps, int dtype, int vec,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return (int)(vec ? launch<float, true>(x, w, y, rows, d, eps, s)
                     : launch<float, false>(x, w, y, rows, d, eps, s));
  if (dtype == kBF16)
    return (int)(vec ? launch<__nv_bfloat16, true>(x, w, y, rows, d, eps, s)
                     : launch<__nv_bfloat16, false>(x, w, y, rows, d, eps, s));
  return (int)cudaErrorInvalidValue;
}
