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
// Bound on the H100: bytes (x and dy read once, dx written once, plus w and
// dw).  A row takes TPR threads (8 to 256) of V 16-byte vectors each (V = 2
// from 64 vectors a row up: at d = 2048 bf16, 128 threads), so a thread
// holds only its vectors of x, dy and w and its columns' f32 dw share: at
// most 64 registers, so that four CTAs of 256 threads fit an SM
// (__launch_bounds__), and the grid is exactly those resident CTAs (one
// wave), each row group striding over the rows.  The next row's x and dy go
// by cp.async into a shared-memory double buffer while the current one is
// reduced and written (a ring of three or four measured slower); each thread
// copies only the vectors it reads itself, so waiting on its own copies is
// enough (no barrier).  The row sums (x^2,
// g x) reduce with shuffles, and across a row group's warps through shared
// memory and a named barrier.  w is read once per CTA and kept in registers
// (in shared memory it measured slower).  At the end the
// CTA's row groups fold their dw shares into one row in shared memory,
// which goes with red.global.add.v4.f32 into one of kDwRows f32 rows of the
// workspace, which the launcher zeroes first (CTA i into row i % kDwRows,
// so that fewer CTAs
// contend for each address); the last CTA to finish (a counter after the
// rows) sums the rows and casts to w's type.  So the dw partials never
// reach device memory as one row a CTA.
// Rows must allow 16-byte vectors and hold at most 512 of them (d <= 4096
// bf16, 2048 f32) for this kernel; longer rows, up to d = 8192 in either
// type (llama-3.2-vision's d_model), take rmsnorm_bwd_long_kernel below,
// and rows up to d = 16384 (mistral-large's 12288, llama3-405b's 16384)
// rmsnorm_bwd_wide_kernel after it.  The wrapper refuses others.

constexpr int kBwdThreads = 256;
constexpr int kBwdCtasPerSm = 4;  // resident CTAs an SM: the plan's grid
constexpr int kDwRows = 8;        // f32 dw rows the CTAs' reduce-adds spread over

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// After a CTA's dw share has gone into the workspace rows: the last CTA to
// finish (a counter after the rows) sums the kDwRows rows and casts dw.
template <typename T>
__device__ __forceinline__ void dw_finish(float* __restrict__ ws,
                                          T* __restrict__ dw, int d) {
  __shared__ bool last_cta;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_cta = atomicAdd(reinterpret_cast<unsigned*>(ws + kDwRows * d), 1u) ==
               gridDim.x - 1;
  __syncthreads();
  if (last_cta) {
    __threadfence();
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kDwRows; ++j) sum += __ldcg(ws + (long long)j * d + c);
      dw[c] = from_f<T>(sum);
    }
  }
}

template <typename T, int V, int TPR>
__global__ void __launch_bounds__(kBwdThreads, kBwdCtasPerSm)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ dw,
                   float* __restrict__ ws, long long rows, int d, float eps) {
  constexpr int N = 16 / sizeof(T);          // elements per vector
  constexpr int GPC = kBwdThreads / TPR;     // row groups per CTA
  constexpr int WPG = TPR / 32;              // warps per group (TPR > 32)
  __shared__ uint4 buf[2][2][V][kBwdThreads];  // [stage][x, dy][vector][thread]
  __shared__ float red[2][kBwdThreads / 32][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / TPR, sub = tid % TPR;
  const int nvec = d / N;

  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4 wr[V];
  float dwa[V][N];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = sub + i * TPR;
    wr[i] = c < nvec ? wv[c] : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < N; ++j) dwa[i][j] = 0.f;
  }

  // This group's rows: g, g + stride, ...; the loop runs on the warp's
  // first group (rows past the end load zeros and store nothing), so every
  // lane of a warp takes the same trips and the shuffles stay whole.
  const long long stride = (long long)gridDim.x * GPC;
  const long long g_mine = (long long)blockIdx.x * GPC + grp;
  const long long g_warp =
      (long long)blockIdx.x * GPC + (TPR >= 32 ? grp : warp * (32 / TPR));
  auto prefetch = [&](long long row, int st) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = sub + i * TPR;
      const bool in = row < rows && c < nvec;
      const long long off = in ? row * d + (long long)c * N : 0;
      cp_async16(&buf[st][0][i][tid], x + off, in);
      cp_async16(&buf[st][1][i][tid], dy + off, in);
    }
    cp_async_commit();
  };
  prefetch(g_mine, 0);
  int k = 0;
  for (long long base = g_warp; base < rows; base += stride, ++k) {
    const long long row = g_mine + (long long)k * stride;
    const int st = k & 1;
    prefetch(row + stride, st ^ 1);
    cp_async_wait<1>();  // this row's copies have landed
    // Keep w packed: unpacked once out of the loop it would take N V
    // registers more.
#pragma unroll
    for (int i = 0; i < V; ++i)
      asm volatile("" : "+r"(wr[i].x), "+r"(wr[i].y), "+r"(wr[i].z), "+r"(wr[i].w));
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float fx[N], fg[N], fw[N];
      unpack16<T>(buf[st][0][i][tid], fx);
      unpack16<T>(buf[st][1][i][tid], fg);
      unpack16<T>(wr[i], fw);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        ss += fx[j] * fx[j];
        gx += fg[j] * fw[j] * fx[j];
      }
    }
#pragma unroll
    for (int o = (TPR < 32 ? TPR : 32) / 2; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      gx += __shfl_xor_sync(0xffffffffu, gx, o);
    }
    if constexpr (TPR > 32) {
      if (lane == 0) {
        red[k & 1][warp][0] = ss;
        red[k & 1][warp][1] = gx;
      }
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(TPR) : "memory");
      ss = gx = 0.f;
#pragma unroll
      for (int i = 0; i < WPG; ++i) {
        ss += red[k & 1][grp * WPG + i][0];
        gx += red[k & 1][grp * WPG + i][1];
      }
    }
    if (row >= rows) continue;
    const float r = inv_rms(ss, d, eps);
    const float mean_gxh = r * gx / (float)d;  // mean(g x^)
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = sub + i * TPR;
      if (c >= nvec) continue;
      // x and dy again from shared memory (a few cycles), rather than held
      // in registers across the row's reductions.
      uint4 xv, gv;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(xv.x), "=r"(xv.y), "=r"(xv.z), "=r"(xv.w)
                   : "r"(static_cast<uint32_t>(
                       __cvta_generic_to_shared(&buf[st][0][i][tid]))));
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(gv.x), "=r"(gv.y), "=r"(gv.z), "=r"(gv.w)
                   : "r"(static_cast<uint32_t>(
                       __cvta_generic_to_shared(&buf[st][1][i][tid]))));
      float fx[N], fg[N], fw[N];
      unpack16<T>(xv, fx);
      unpack16<T>(gv, fg);
      unpack16<T>(wr[i], fw);
      uint4 out;
      T* e = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xh = fx[j] * r;
        e[j] = from_f<T>(r * (fg[j] * fw[j] - xh * mean_gxh));
        dwa[i][j] += fg[j] * xh;
      }
      __stcs(dxr + c, out);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Fold the CTA's dw shares into one row (the copy buffer is free now).
  float* dw_row = reinterpret_cast<float*>(&buf[0][0][0][0]);  // d floats
  for (int c = tid; c < d; c += kBwdThreads) dw_row[c] = 0.f;
  __syncthreads();
  // The thread's first vector again (held across the row loop it took a
  // spill at d = 2048).
  int sub_again = threadIdx.x % TPR;
  asm volatile("" : "+r"(sub_again));
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = sub_again + i * TPR;
    if (c >= nvec) continue;
#pragma unroll
    for (int j = 0; j < N; ++j) atomicAdd(&dw_row[c * N + j], dwa[i][j]);
  }
  __syncthreads();
  float* ws_row = ws + (long long)(blockIdx.x % kDwRows) * d;
  for (int c = 4 * tid; c < d; c += 4 * kBwdThreads) {
    const float4 v = *reinterpret_cast<const float4*>(dw_row + c);
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(ws_row + c),
                 "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
                 : "memory");
  }
  dw_finish(ws, dw, d);
}

// Long rows (513 to 2048 vectors: d in (4096, 8192] bf16, (2048, 8192] f32).
// One row at a time per CTA of kBwdThreads threads, each thread V vectors
// of the row (V = 4 or 8, its columns tid + i * kBwdThreads), so no row
// group shares a CTA.  The thread loads all of its x and dy vectors into
// registers at once (up to 2 * 8 16-byte loads in flight), reduces the two
// row sums (shuffles, then the CTA's 8 warps through shared memory, double
// buffered by the row's parity so one barrier a row is enough), and writes
// dx from the same registers: each byte is read once.  w is read per row
// through L1 (a 16-32 KB row that every CTA keeps reading).  Each thread
// owns its columns' dw share across the CTA's rows in registers, and adds it
// to the workspace with red.global.add at the end, then dw_finish.  The
// register bound is 128 a thread, two CTAs an SM (the plan's one-wave
// grid); the next row is not prefetched, so the second CTA of an SM is what
// hides a row's load latency.
constexpr int kBwdLongCtasPerSm = 2;

template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads, kBwdLongCtasPerSm)
rmsnorm_bwd_long_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        T* __restrict__ dw, float* __restrict__ ws,
                        long long rows, int d, float eps) {
  constexpr int N = 16 / sizeof(T);          // elements per vector
  constexpr int kWarps = kBwdThreads / 32;
  __shared__ float red[2][kWarps][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvec = d / N;
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  float dwa[V][N];
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) dwa[i][j] = 0.f;

  int k = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x, ++k) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + row * d);
    uint4 xv[V], gv[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = tid + i * kBwdThreads;
      xv[i] = c < nvec ? __ldcs(xr + c) : zero;
      gv[i] = c < nvec ? __ldcs(gr + c) : zero;
    }
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = tid + i * kBwdThreads;
      float fx[N], fg[N], fw[N];
      unpack16<T>(xv[i], fx);
      unpack16<T>(gv[i], fg);
      unpack16<T>(c < nvec ? __ldg(wv + c) : zero, fw);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        ss += fx[j] * fx[j];
        gx += fg[j] * fw[j] * fx[j];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      gx += __shfl_xor_sync(0xffffffffu, gx, o);
    }
    if (lane == 0) {
      red[k & 1][warp][0] = ss;
      red[k & 1][warp][1] = gx;
    }
    __syncthreads();
    ss = gx = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      ss += red[k & 1][i][0];
      gx += red[k & 1][i][1];
    }
    const float r = inv_rms(ss, d, eps);
    const float mean_gxh = r * gx / (float)d;  // mean(g x^)
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = tid + i * kBwdThreads;
      if (c >= nvec) continue;
      float fx[N], fg[N], fw[N];
      unpack16<T>(xv[i], fx);
      unpack16<T>(gv[i], fg);
      unpack16<T>(__ldg(wv + c), fw);
      uint4 out;
      T* e = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xh = fx[j] * r;
        e[j] = from_f<T>(r * (fg[j] * fw[j] - xh * mean_gxh));
        dwa[i][j] += fg[j] * xh;
      }
      __stcs(dxr + c, out);
    }
  }
  float* ws_row = ws + (long long)(blockIdx.x % kDwRows) * d;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = tid + i * kBwdThreads;
    if (c >= nvec) continue;
#pragma unroll
    for (int j = 0; j < N; j += 4)
      asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(
                       ws_row + c * N + j),
                   "f"(dwa[i][j]), "f"(dwa[i][j + 1]), "f"(dwa[i][j + 2]),
                   "f"(dwa[i][j + 3])
                   : "memory");
  }
  dw_finish(ws, dw, d);
}

// Wide rows (d in (8192, 16384] in either type: mistral-large-123b's 12288
// and llama3-405b's 16384 d_model).  The long kernel above cannot take them:
// at 256 threads a bf16 thread would hold 8 vectors of x and 8 of dy (64
// registers) beside its columns' dw share (64 floats), an f32 thread 12-16
// vectors of each (96-128 registers) beside 48-64 floats, past the 128
// registers a thread has at two CTAs an SM.  So a row takes a CTA of
// kBwdWideThreads (512) threads of 32 elements each (V = 4 bf16 or 8 f32
// vectors, 32-64 registers, and 32 floats of dw: the long kernel's f32 case
// at d 8192), one CTA an SM (512 threads of at most 128 registers fill the
// register file).  With
// no second CTA on the SM to hide a row's load latency, the next row is
// staged once through shared memory: each thread copies its own vectors of
// the next row's x and dy by cp.async (into its own slots, so waiting on
// its own copies is enough, as in rmsnorm_bwd_kernel) while it reduces and
// writes the current row from registers.  The slots hold one row: 2 V x
// 512 x 16 bytes, 64 KB bf16 and 128 KB f32 (a second row would pass the
// 227 KB an SM offers in f32), so a thread moves its vectors of the row into
// registers and uses them (the partial sums) before it asks for the next
// row's copies into the same slots.  Each byte of x and dy is read from HBM
// once; w is read per row through L1 (its 24-64 KB fit beside the slots);
// the row sums go through shared memory as in the long kernel; dw as there.
constexpr int kBwdWideThreads = 512;
constexpr int kBwdWideCtasPerSm = 1;
constexpr int kBwdWideElems = 32;  // row elements a thread: 512 x 32 = 16384

template <typename T, int V>
__global__ void __launch_bounds__(kBwdWideThreads, kBwdWideCtasPerSm)
rmsnorm_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        T* __restrict__ dw, float* __restrict__ ws,
                        long long rows, int d, float eps) {
  constexpr int N = 16 / sizeof(T);          // elements per vector
  static_assert(V * N == kBwdWideElems, "a thread holds 32 elements");
  constexpr int kWarps = kBwdWideThreads / 32;
  extern __shared__ uint4 slots[];           // [x, dy][vector][thread]
  __shared__ float red[2][kWarps][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvec = d / N;
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  float dwa[V][N];
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) dwa[i][j] = 0.f;

  auto stage = [&](long long row) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = tid + i * kBwdWideThreads;
      const bool in = row < rows && c < nvec;
      const long long off = in ? row * d + (long long)c * N : 0;
      cp_async16(&slots[i * kBwdWideThreads + tid], x + off, in);
      cp_async16(&slots[(V + i) * kBwdWideThreads + tid], dy + off, in);
    }
    cp_async_commit();
  };
  stage(blockIdx.x);
  int k = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x, ++k) {
    cp_async_wait<0>();  // this thread's copies of the row have landed
    uint4 xv[V], gv[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      xv[i] = slots[i * kBwdWideThreads + tid];
      gv[i] = slots[(V + i) * kBwdWideThreads + tid];
    }
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = tid + i * kBwdWideThreads;
      float fx[N], fg[N], fw[N];
      unpack16<T>(xv[i], fx);
      unpack16<T>(gv[i], fg);
      unpack16<T>(c < nvec ? __ldg(wv + c) : zero, fw);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        ss += fx[j] * fx[j];
        gx += fg[j] * fw[j] * fx[j];
      }
    }
    // The slots' values are in registers and used: the next row's copies
    // may overwrite them (cp_async16's "memory" clobber keeps the loads
    // above it).
    stage(row + gridDim.x);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      gx += __shfl_xor_sync(0xffffffffu, gx, o);
    }
    if (lane == 0) {
      red[k & 1][warp][0] = ss;
      red[k & 1][warp][1] = gx;
    }
    __syncthreads();
    ss = gx = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      ss += red[k & 1][i][0];
      gx += red[k & 1][i][1];
    }
    const float r = inv_rms(ss, d, eps);
    const float mean_gxh = r * gx / (float)d;  // mean(g x^)
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = tid + i * kBwdWideThreads;
      if (c >= nvec) continue;
      float fx[N], fg[N], fw[N];
      unpack16<T>(xv[i], fx);
      unpack16<T>(gv[i], fg);
      unpack16<T>(__ldg(wv + c), fw);
      uint4 out;
      T* e = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xh = fx[j] * r;
        e[j] = from_f<T>(r * (fg[j] * fw[j] - xh * mean_gxh));
        dwa[i][j] += fg[j] * xh;
      }
      __stcs(dxr + c, out);
    }
  }
  cp_async_wait<0>();  // the copies past the last row (all zero-filled)
  float* ws_row = ws + (long long)(blockIdx.x % kDwRows) * d;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = tid + i * kBwdWideThreads;
    if (c >= nvec) continue;
#pragma unroll
    for (int j = 0; j < N; j += 4)
      asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(
                       ws_row + c * N + j),
                   "f"(dwa[i][j]), "f"(dwa[i][j + 1]), "f"(dwa[i][j + 2]),
                   "f"(dwa[i][j + 3])
                   : "memory");
  }
  dw_finish(ws, dw, d);
}

// The resident CTAs an SM that `kern` must reach for the plan's one-wave
// grid (asked once per instantiation, after allowing `smem` bytes of dynamic
// shared memory), then a memset of the workspace and the launch.
template <typename K>
cudaError_t launch_bwd_kernel(K kern, int min_ctas_per_sm, int& ctas_per_sm,
                              float* ws, int d, int grid, cudaStream_t stream,
                              int threads = kBwdThreads, int smem = 0) {
  if (!ctas_per_sm) {
    cudaError_t err = smem > 0 ? cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) : cudaSuccess;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas_per_sm, kern,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
  }
  // Refuse a build that fits fewer CTAs an SM (it would run in two waves).
  if (ctas_per_sm < min_ctas_per_sm) return cudaErrorInvalidConfiguration;
  return cudaMemsetAsync(ws, 0, ((size_t)kDwRows * d + 1) * sizeof(float), stream);
}

template <typename T, int V>
cudaError_t launch_bwd_long(const T* x, const T* w, const T* dy, T* dx, T* dw,
                            float* ws, int grid, long long rows, int d, float eps,
                            cudaStream_t stream) {
  auto kern = rmsnorm_bwd_long_kernel<T, V>;
  static int ctas_per_sm = 0;  // per instantiation
  cudaError_t err = launch_bwd_kernel(kern, kBwdLongCtasPerSm, ctas_per_sm, ws,
                                      d, grid, stream);
  if (err != cudaSuccess) return err;
  kern<<<grid, kBwdThreads, 0, stream>>>(x, w, dy, dx, dw, ws, rows, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_wide(const T* x, const T* w, const T* dy, T* dx, T* dw,
                            float* ws, int grid, long long rows, int d, float eps,
                            cudaStream_t stream) {
  constexpr int V = kBwdWideElems * int(sizeof(T)) / 16;
  constexpr int smem = 2 * V * kBwdWideThreads * 16;  // x and dy of one row
  auto kern = rmsnorm_bwd_wide_kernel<T, V>;
  static int ctas_per_sm = 0;  // per instantiation
  cudaError_t err = launch_bwd_kernel(kern, kBwdWideCtasPerSm, ctas_per_sm, ws,
                                      d, grid, stream, kBwdWideThreads, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kBwdWideThreads, smem, stream>>>(x, w, dy, dx, dw, ws, rows, d,
                                               eps);
  return cudaGetLastError();
}

template <typename T, int V, int TPR>
cudaError_t launch_bwd_rows(const T* x, const T* w, const T* dy, T* dx, T* dw,
                            float* ws, int grid, long long rows, int d, float eps,
                            cudaStream_t stream) {
  auto kern = rmsnorm_bwd_kernel<T, V, TPR>;
  static int ctas_per_sm = 0;  // per instantiation
  cudaError_t err = launch_bwd_kernel(kern, kBwdCtasPerSm, ctas_per_sm, ws, d,
                                      grid, stream);
  if (err != cudaSuccess) return err;
  kern<<<grid, kBwdThreads, 0, stream>>>(x, w, dy, dx, dw, ws, rows, d, eps);
  return cudaGetLastError();
}

// Threads per row and vectors per thread, as rmsnorm_bwd_plan() in
// kernels/rmsnorm/kernel.py picks them.
template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx,
                       void* dw, float* ws, int grid, long long rows, int d,
                       float eps, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* gp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  T* dwp = static_cast<T*>(dw);
  const int nvec = d / int(16 / sizeof(T));
#define BWD(V_, TPR_) \
  launch_bwd_rows<T, V_, TPR_>(xp, wp, gp, dxp, dwp, ws, grid, rows, d, eps, s)
  if (nvec <= 8) return BWD(1, 8);
  if (nvec <= 16) return BWD(1, 16);
  if (nvec <= 32) return BWD(1, 32);
  if (nvec <= 64) return BWD(2, 32);
  if (nvec <= 128) return BWD(2, 64);
  if (nvec <= 256) return BWD(2, 128);
  if (nvec <= 512) return BWD(2, 256);
#undef BWD
  if (d > kBwdWideThreads * kBwdWideElems) return cudaErrorInvalidValue;
  if (d > 8192)
    return launch_bwd_wide<T>(xp, wp, gp, dxp, dwp, ws, grid, rows, d, eps, s);
  if (nvec <= 1024)
    return launch_bwd_long<T, 4>(xp, wp, gp, dxp, dwp, ws, grid, rows, d, eps, s);
  if constexpr (sizeof(T) == 4)
    return launch_bwd_long<T, 8>(xp, wp, gp, dxp, dwp, ws, grid, rows, d, eps, s);
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
// of dtype, 16-byte aligned, d * sizeof(T) % 16 == 0 and d <= 16384.  ws:
// 8 d + 4 f32 scratch (kDwRows rows of dw's f32 sums, then a counter),
// zeroed here.  `grid` CTAs (rmsnorm_bwd_plan() in kernels/rmsnorm/kernel.py:
// at most four an SM, two for rows of more than 512 vectors, one for rows
// wider than 8192).  A memset of ws and one launch on `stream`.  Returns
// cudaGetLastError() after them (0 on success).
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, float* ws, int grid,
                           long long rows, int d, float eps, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == kF32 && d % 4 == 0)
    return (int)launch_bwd<float>(x, w, dy, dx, dw, ws, grid, rows, d, eps, s);
  if (dtype == kBF16 && d % 8 == 0)
    return (int)launch_bwd<__nv_bfloat16>(x, w, dy, dx, dw, ws, grid, rows, d, eps,
                                          s);
  return (int)cudaErrorInvalidValue;
}
