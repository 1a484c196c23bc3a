// Row RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `rmsnorm_pallas` / `_rmsnorm_kernel`
// (src/repro/kernels/rmsnorm/kernel.py).  y = x * rsqrt(mean(x^2) + eps) * w,
// the mean taken in f32, the result cast back to the input type.
//
// Bound on the H100: bytes.  Each row is read and written once (2 * rows * d
// * sizeof(T) bytes over 3.35 TB/s); the arithmetic is a few FLOPs a byte.
// The design therefore only tries to keep enough bytes in flight and to
// touch each once.  When the row allows 16-byte vectors and holds at most
// 1024 of them (d <= 8192 bf16, 4096 f32), `rmsnorm_reg_kernel` gives each
// row TPR lanes (8, 16 or 32: the d = 128 q/k norms take 16 lanes, two rows
// a warp) and each lane NV vectors; a lane issues all of its loads (marked
// evict-first in L2: x is read once, so its lines, not other data's dirty
// lines, make room for the rows that follow), of ROWS rows at a time when NV
// is small, before the x^2 sum, reduces it with
// shuffles inside its lane group and writes the scaled row from the same
// registers, so each row is read once.  The weight's vectors are loaded once
// per lane and kept across a grid-stride loop over rows (for NV <= 8; longer
// rows re-read them from L1), with as many CTAs as fit on the SMs.  Longer
// rows (llama3-405b's 16384) take one CTA per row, and rows that do not
// allow vectors take the scalar kernels; both read the row twice (the second
// pass hits L1/L2).  Any row count works (no padding to a row block as on
// the TPU).
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

// Vector kernel: TPR lanes per row, NV 16-byte vectors per lane, ROWS rows
// per lane group at a time, 256 threads a CTA; the grid strides over rows.
constexpr int kRegThreads = 256;

template <typename T, int NV, int TPR, int ROWS>
__global__ void __launch_bounds__(kRegThreads)
rmsnorm_reg_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, long long rows, int d, float eps) {
  constexpr int N = 16 / sizeof(T);       // elements per vector
  constexpr bool KEEP_W = NV <= 8;        // weight held in registers
  constexpr int GROUPS = 32 / TPR;        // lane groups (rows) per warp
  const int lane = threadIdx.x & 31, sub = lane % TPR;
  const int nvec = d / N;
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4 wr[KEEP_W ? NV : 1];
  if constexpr (KEEP_W) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = sub + i * TPR;
      wr[i] = c < nvec ? wv[c] : make_uint4(0, 0, 0, 0);
    }
  }
  const long long warps = (long long)gridDim.x * (kRegThreads / 32);
  const long long per_warp = (long long)GROUPS * ROWS;  // rows a warp takes at once
  const long long warp0 = (long long)blockIdx.x * (kRegThreads / 32) + (threadIdx.x >> 5);
  for (long long base = warp0 * per_warp; base < rows; base += warps * per_warp) {
    if constexpr (KEEP_W) {
      // Keep the weight packed: without this the compiler hoists its f32
      // unpacking out of the loop, which doubles the registers it holds.
#pragma unroll
      for (int i = 0; i < NV; ++i)
        asm volatile("" : "+r"(wr[i].x), "+r"(wr[i].y), "+r"(wr[i].z), "+r"(wr[i].w));
    }
    uint4 xr[ROWS][NV];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long long row = base + r * GROUPS + lane / TPR;
      const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = sub + i * TPR;
        xr[r][i] = row < rows && c < nvec ? __ldcs(xv + c) : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long long row = base + r * GROUPS + lane / TPR;
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float f[N];
        unpack16<T>(xr[r][i], f);
#pragma unroll
        for (int j = 0; j < N; ++j) ss += f[j] * f[j];
      }
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float inv = inv_rms(ss, d, eps);
      if (row >= rows) continue;
      uint4* yv = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = sub + i * TPR;
        if (c >= nvec) continue;
        float fx[N], fw[N];
        unpack16<T>(xr[r][i], fx);
        unpack16<T>(KEEP_W ? wr[KEEP_W ? i : 0] : wv[c], fw);
        uint4 out;
        T* e = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < N; ++j) e[j] = from_f<T>(fx[j] * inv * fw[j]);
        yv[c] = out;
      }
    }
  }
}

template <typename T, int NV, int TPR, int ROWS>
cudaError_t launch_reg(const T* x, const T* w, T* y, long long rows, int d,
                       float eps, cudaStream_t stream) {
  auto kern = rmsnorm_reg_kernel<T, NV, TPR, ROWS>;
  static int ctas_per_sm = 0, sms = 0;  // per instantiation, asked once
  if (!ctas_per_sm) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas_per_sm, kern,
                                                          kRegThreads, 0);
    if (err != cudaSuccess) return err;
  }
  const long long rows_per_cta = (kRegThreads / 32) * (32 / TPR) * ROWS;
  const long long need = (rows + rows_per_cta - 1) / rows_per_cta;
  const long long fit = (long long)sms * (ctas_per_sm > 0 ? ctas_per_sm : 1);
  kern<<<(unsigned)(need < fit ? need : fit), kRegThreads, 0, stream>>>(x, w, y, rows,
                                                                     d, eps);
  return cudaGetLastError();
}

// Lanes per row and vectors per lane for a row of nvec vectors (nvec <=
// 1024): the fewest lanes (at least 8) that leave each at most one vector,
// up to a whole warp, then more vectors per lane.  ROWS keeps at least four
// vectors of loads in flight per lane, and at d = 2048 bf16 (8 vectors) two
// rows when there are many, so that 4096 rows are all in flight at once (2
// CTAs of 16 rows an SM); a few rows (decode's 4) take one row a lane group.
template <typename T>
cudaError_t launch_vec_rows(const T* x, const T* w, T* y, long long rows, int d,
                            float eps, cudaStream_t s) {
  const int nvec = d / int(16 / sizeof(T));
  if (nvec <= 8) return launch_reg<T, 1, 8, 4>(x, w, y, rows, d, eps, s);
  if (nvec <= 16) return launch_reg<T, 1, 16, 4>(x, w, y, rows, d, eps, s);
  if (nvec <= 32) return launch_reg<T, 1, 32, 4>(x, w, y, rows, d, eps, s);
  if (nvec <= 64) return launch_reg<T, 2, 32, 2>(x, w, y, rows, d, eps, s);
  if (nvec <= 128) return launch_reg<T, 4, 32, 1>(x, w, y, rows, d, eps, s);
  if (nvec <= 256)
    return rows >= 2048 ? launch_reg<T, 8, 32, 2>(x, w, y, rows, d, eps, s)
                        : launch_reg<T, 8, 32, 1>(x, w, y, rows, d, eps, s);
  if (nvec <= 512) return launch_reg<T, 16, 32, 1>(x, w, y, rows, d, eps, s);
  return launch_reg<T, 32, 32, 1>(x, w, y, rows, d, eps, s);
}

// Scalar kernel: one warp per row; blockDim.x / 32 rows per CTA.
template <typename T>
__global__ void rmsnorm_warp_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w, T* __restrict__ y,
                                    long long rows, int d, float eps) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * d;
  const float s = warp_sum(row_sumsq<T, false>(xr, d, lane, 32));
  row_scale<T, false>(xr, w, y + row * d, d, inv_rms(s, d, eps), lane, 32);
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
  const int units = VEC ? d / int(16 / sizeof(T)) : d;
  if (VEC && units <= 1024) return launch_vec_rows<T>(xp, wp, yp, rows, d, eps, stream);
  if (!VEC && d <= 1024) {
    constexpr int kThreads = 256;  // 8 rows per CTA
    const long long rows_per_cta = kThreads / 32;
    const unsigned grid = (unsigned)((rows + rows_per_cta - 1) / rows_per_cta);
    rmsnorm_warp_kernel<T><<<grid, kThreads, 0, stream>>>(xp, wp, yp, rows, d, eps);
  } else {
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
