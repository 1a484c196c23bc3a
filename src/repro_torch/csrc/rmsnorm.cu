// Row RMSNorm forward and backward for Hopper (sm_90a).  The backward is
// described where it starts, below the forward.
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

// ------------------------------------------------------------------ backward
//
// The JAX package has no backward kernel (its CPU path differentiates
// rmsnorm_ref); this computes that gradient in f32:
//   r = 1 / sqrt(mean(x^2) + eps),  x^ = x r,  g = dy w,
//   dx = r (g - x^ mean(g x^)),     dw = sum over rows of dy x^.
// Bound on the H100: bytes (x and dy read once, dx written once, plus dw).
// The forward's register-row pattern: TPR lanes hold a row of x and of dy in
// registers (16-byte loads, evict-first), reduce x^2 and g x with shuffles
// and write dx from the same registers, over a grid-stride loop; each lane
// keeps its columns' share of dw in f32 registers across its rows.  At the
// end the CTA's lanes add their shares into one row in shared memory, which
// goes to dw_part[blockIdx.x]; a second small kernel sums the CTAs' rows per
// column (32 columns a CTA) and casts to w's type.  Rows must allow 16-byte
// vectors and hold at most 512 of them (d <= 4096 bf16, 2048 f32); the
// wrapper refuses others.

template <typename T, int NV, int TPR>
__global__ void __launch_bounds__(kRegThreads)
rmsnorm_bwd_reg_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ dw_part, long long rows, int d,
                       float eps) {
  constexpr int N = 16 / sizeof(T);
  constexpr int GROUPS = 32 / TPR;
  extern __shared__ float dw_row[];  // d floats
  const int lane = threadIdx.x & 31, sub = lane % TPR;
  const int nvec = d / N;
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  for (int i = threadIdx.x; i < d; i += kRegThreads) dw_row[i] = 0.f;
  float dwa[NV][N];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) dwa[i][j] = 0.f;

  const long long warps = (long long)gridDim.x * (kRegThreads / 32);
  const long long warp0 = (long long)blockIdx.x * (kRegThreads / 32) + (threadIdx.x >> 5);
  for (long long base = warp0 * GROUPS; base < rows; base += warps * GROUPS) {
    const long long row = base + lane / TPR;
    const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
    const uint4* gv = reinterpret_cast<const uint4*>(dy + row * d);
    uint4 xr[NV], gr[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = sub + i * TPR;
      const bool in = row < rows && c < nvec;
      xr[i] = in ? __ldcs(xv + c) : make_uint4(0, 0, 0, 0);
      gr[i] = in ? __ldcs(gv + c) : make_uint4(0, 0, 0, 0);
    }
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = sub + i * TPR;
      float fx[N], fg[N], fw[N];
      unpack16<T>(xr[i], fx);
      unpack16<T>(gr[i], fg);
      unpack16<T>(c < nvec ? wv[c] : make_uint4(0, 0, 0, 0), fw);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        ss += fx[j] * fx[j];
        gx += fg[j] * fw[j] * fx[j];
      }
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      gx += __shfl_xor_sync(0xffffffffu, gx, o);
    }
    if (row >= rows) continue;
    const float r = inv_rms(ss, d, eps);
    const float mean_gxh = r * gx / (float)d;  // mean(g x^)
    T* dxr = dx + row * d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = sub + i * TPR;
      if (c >= nvec) continue;
      float fx[N], fg[N], fw[N];
      unpack16<T>(xr[i], fx);
      unpack16<T>(gr[i], fg);
      unpack16<T>(wv[c], fw);
      uint4 out;
      T* e = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xh = fx[j] * r;
        e[j] = from_f<T>(r * (fg[j] * fw[j] - xh * mean_gxh));
        dwa[i][j] += fg[j] * xh;
      }
      reinterpret_cast<uint4*>(dxr)[c] = out;
    }
  }
  __syncthreads();  // dw_row is zeroed
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = sub + i * TPR;
    if (c >= nvec) continue;
#pragma unroll
    for (int j = 0; j < N; ++j) atomicAdd(&dw_row[c * N + j], dwa[i][j]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d; i += kRegThreads)
    dw_part[(long long)blockIdx.x * d + i] = dw_row[i];
}

// dw[c] = sum over the CTAs' rows of dw_part[:, c], cast to w's type: a CTA
// takes 32 columns, its 8 warps stride over the rows (coalesced 128-byte
// reads), and shared memory sums the warps.
constexpr int kReduceRowsPar = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kReduceRowsPar)
rmsnorm_dw_reduce_kernel(const float* __restrict__ dw_part, int parts, int d,
                         T* __restrict__ dw) {
  __shared__ float acc[kReduceRowsPar][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < d)
    for (int p = threadIdx.y; p < parts; p += kReduceRowsPar)
      s += dw_part[(long long)p * d + c];
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
#pragma unroll
    for (int y = 1; y < kReduceRowsPar; ++y) s += acc[y][threadIdx.x];
    dw[c] = from_f<T>(s);
  }
}

template <typename T, int NV, int TPR>
cudaError_t launch_bwd_reg(const T* x, const T* w, const T* dy, T* dx, T* dw,
                           float* dw_part, int parts, long long rows, int d,
                           float eps, cudaStream_t stream) {
  auto kern = rmsnorm_bwd_reg_kernel<T, NV, TPR>;
  const size_t smem = (size_t)d * sizeof(float);
  kern<<<parts, kRegThreads, smem, stream>>>(x, w, dy, dx, dw_part, rows, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dw_reduce_kernel<T><<<(d + 31) / 32, dim3(32, kReduceRowsPar), 0, stream>>>(
      dw_part, parts, d, dw);
  return cudaGetLastError();
}

// Lanes per row and vectors per lane, as the forward's launch_vec_rows.
template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx,
                       void* dw, float* dw_part, int parts, long long rows,
                       int d, float eps, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* gp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  T* dwp = static_cast<T*>(dw);
  const int nvec = d / int(16 / sizeof(T));
#define BWD(NV_, TPR_) \
  launch_bwd_reg<T, NV_, TPR_>(xp, wp, gp, dxp, dwp, dw_part, parts, rows, d, eps, s)
  if (nvec <= 8) return BWD(1, 8);
  if (nvec <= 16) return BWD(1, 16);
  if (nvec <= 32) return BWD(1, 32);
  if (nvec <= 64) return BWD(2, 32);
  if (nvec <= 128) return BWD(4, 32);
  if (nvec <= 256) return BWD(8, 32);
  if (nvec <= 512) return BWD(16, 32);
#undef BWD
  return cudaErrorInvalidValue;
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

// Backward of rmsnorm_fwd.  x, dy, dx: (rows, d) row-major; w, dw: (d,); all
// of dtype, 16-byte aligned, d * sizeof(T) % 16 == 0 and at most 512 vectors
// a row.  dw_part: (parts, d) f32 scratch, one row per CTA; `parts` CTAs
// (rmsnorm_bwd_parts() in kernels/rmsnorm/kernel.py).  Two launches on
// `stream`.  Returns cudaGetLastError() after them (0 on success).
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, float* dw_part, int parts,
                           long long rows, int d, float eps, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0 || parts <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == kF32 && d % 4 == 0)
    return (int)launch_bwd<float>(x, w, dy, dx, dw, dw_part, parts, rows, d, eps, s);
  if (dtype == kBF16 && d % 8 == 0)
    return (int)launch_bwd<__nv_bfloat16>(x, w, dy, dx, dw, dw_part, parts, rows, d,
                                          eps, s);
  return (int)cudaErrorInvalidValue;
}
