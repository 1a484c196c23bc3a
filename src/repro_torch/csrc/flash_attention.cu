// Flash-attention forward for Hopper (sm_90a): online softmax, GQA, causal
// with q_offset, any Sq and Skv.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py).  It computes what that
// kernel computes — softmax(scale * q k^T, masked) v with f32 m / l / acc and
// the output acc / max(l, 1e-30) — but not block by block: on the TPU the kv
// grid axis runs in order and carries the running state in VMEM scratch; here
// one CTA owns one (b, h, 64-row q tile) and loops over 64-row KV tiles itself,
// keeping m, l and its slice of acc in registers.
//
// Bound on the H100: tensor FLOPs (4 * B * H * Sq * Skv * hd, about half of
// it under the causal mask, against 989 TFLOP/s bf16).  Two kernels:
//   * bf16 (the serving path): the two products on the tensor cores with
//     warp-level mma.sync m16n8k16 (bf16 in, f32 accumulate).  Each of 4
//     warps owns 16 q rows; q stays in registers as A fragments, the scores
//     stay in registers and become P's A fragments directly (P rounded to
//     bf16, as FlashAttention-2 does), K and V tiles come from shared
//     memory (V's fragments through ldmatrix.trans).  No TMA, no wgmma, no double buffering yet: later work.
//   * f32: plain f32 FMA from shared memory (f32 inputs must not be rounded
//     to bf16), 16 x 16 threads each owning 4 q rows x 4 KV columns.
// Both skip the work the mask removes: KV tiles wholly above the causal
// diagonal are never loaded or multiplied, and the heaviest q tiles are
// scheduled first.
//
// Layouts: q, o (B, Sq, H, hd); k, v (B, Skv, KV, hd), all contiguous; KV head
// of q head h is h / (H / KV).  A ragged last q tile is masked (the TPU
// kernel's Sq % block_q restriction does not carry over), as are KV rows at or
// past Skv.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;       // q rows per CTA
constexpr int kBK = 64;       // KV rows per tile
constexpr int kThreads = 256; // f32 kernel: 16 x 16 threads
constexpr int kMmaThreads = 128;  // bf16 kernel: 4 warps x 16 q rows

template <int HD>
struct Smem {
  static constexpr int QT_LD = kBQ + 4;  // Qt[d][r]: float4 reads along r
  static constexpr int K_LD = HD + 1;    // Ks[c][d]: conflict-free column reads
  static constexpr int V_LD = HD;        // Vs[c][n]
  static constexpr int P_LD = kBQ + 4;   // Pt[c][r]: float4 reads along r
  static constexpr int QT = 0;
  static constexpr int KS = QT + HD * QT_LD;
  static constexpr int VS = KS + kBK * K_LD;
  static constexpr int PT = VS + kBK * V_LD;
  static constexpr int FLOATS = PT + kBK * P_LD;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// max / sum over the 16 lanes that share one q row (a half warp).
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int KV, int causal, int q_offset, float scale) {
  using S = Smem<HD>;
  constexpr int VN = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int CPT = HD / 16;         // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem + S::QT;
  float* Ks = smem + S::KS;
  float* Vs = smem + S::VS;
  float* Pt = smem + S::PT;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_ld = (long long)H * HD;    // stride between q positions
  const long long kv_ld = (long long)KV * HD;  // stride between kv positions
  const T* qb = q + (long long)b * Sq * q_ld + (long long)h * HD;
  const T* kb = k + (long long)b * Skv * kv_ld + (long long)kvh * HD;
  const T* vb = v + (long long)b * Skv * kv_ld + (long long)kvh * HD;
  T* ob = o + (long long)b * Sq * q_ld + (long long)h * HD;

  // Stage the scaled q tile, transposed, in f32; rows past Sq are zero.
  for (int e = tid; e < kBQ * HD / VN; e += kThreads) {
    const int r = e / (HD / VN), d0 = (e % (HD / VN)) * VN;
    float f[VN];
    if (q0 + r < Sq) {
      unpack16<T>(*reinterpret_cast<const uint4*>(qb + (q0 + r) * q_ld + d0), f);
    } else {
#pragma unroll
      for (int j = 0; j < VN; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VN; ++j) Qt[(d0 + j) * S::QT_LD + r] = f[j] * scale;
  }

  float acc[4][CPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < CPT; ++n) acc[i][n] = 0.f;
  }

  // KV tiles wholly above the causal diagonal of this q tile are skipped.
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_offset + q_last + 1) : Skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's readers are done (and Qt is visible)
    for (int e = tid; e < kBK * HD / VN; e += kThreads) {
      const int c = e / (HD / VN), d0 = (e % (HD / VN)) * VN;
      float fk[VN], fv[VN];
      if (k0 + c < Skv) {
        const long long off = (k0 + c) * kv_ld + d0;
        unpack16<T>(*reinterpret_cast<const uint4*>(kb + off), fk);
        unpack16<T>(*reinterpret_cast<const uint4*>(vb + off), fv);
      } else {
#pragma unroll
        for (int j = 0; j < VN; ++j) fk[j] = fv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        Ks[c * S::K_LD + d0 + j] = fk[j];
        Vs[c * S::V_LD + d0 + j] = fv[j];
      }
    }
    __syncthreads();

    // Scores for q rows ty*4+i and KV columns tx+16j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * S::QT_LD + ty * 4]);
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * S::K_LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[0][j] += qv.x * kv[j];
        s[1][j] += qv.y * kv[j];
        s[2][j] += qv.z * kv[j];
        s[3][j] += qv.w * kv[j];
      }
    }

    // Mask, online softmax update, P to shared memory.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_offset + q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < Skv && (!causal || qp >= kp);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        Pt[(tx + 16 * j) * S::P_LD + ty * 4 + i] = pj;
        rs += pj;
      }
      l[i] = l[i] * alpha + rs;  // per-thread partial; reduced at the end
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < CPT; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();

    // acc += P V for q rows ty*4+i and output columns tx+16n.
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&Pt[c * S::P_LD + ty * 4]);
#pragma unroll
      for (int n = 0; n < CPT; ++n) {
        const float vv = Vs[c * S::V_LD + tx + 16 * n];
        acc[0][n] += pv.x * vv;
        acc[1][n] += pv.y * vv;
        acc[2][n] += pv.z * vv;
        acc[3][n] += pv.w * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float den = fmaxf(half_sum(l[i]), 1e-30f);
    const int r = q0 + ty * 4 + i;
    if (r < Sq) {
#pragma unroll
      for (int n = 0; n < CPT; ++n)
        ob[r * q_ld + tx + 16 * n] = from_f<T>(acc[i][n] / den);
    }
  }
}

// ---------------------------------------------------------------- bf16 mma

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two consecutive bf16 at p (4-byte aligned) as one 32-bit fragment register.
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B fragment (16 keys x 8 columns) of a row-major [key][d] tile in shared
// memory: lanes 0-15 name the 16 key rows at column d0; .trans hands lane
// (g, t) the pair (key 2t, 2t+1; column g) of each 8 x 8 half.
__device__ __forceinline__ void ldmatrix_x2_trans(const __nv_bfloat16* row,
                                                  uint32_t& b0, uint32_t& b1) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

// max / sum over the 4 lanes of a quad (the lanes that share an mma row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int HD>
struct MmaSmem {
  // Row strides in bf16 elements: rows stay 16-byte aligned, and the 8 rows
  // a fragment read touches fall in distinct banks.
  static constexpr int LD = HD + 8;
  static constexpr int QS = 0;
  static constexpr int KS = QS + kBQ * LD;
  static constexpr int VS = KS + kBK * LD;
  static constexpr int ELEMS = VS + kBK * LD;
  static constexpr size_t BYTES = ELEMS * sizeof(__nv_bfloat16);
};

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16 x 8, col):   b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   C (16 x 8, f32):   c0 c1 (g, 2t..2t+1)  c2 c3 (g+8, 2t..2t+1)
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                     int KV, int causal, int q_offset, float scale) {
  using S = MmaSmem<HD>;
  constexpr int VN = 8;            // bf16 per 16-byte load
  constexpr int KSTEPS = HD / 16;  // k-steps of S = Q K^T
  constexpr int NT_S = kBK / 8;    // n-tiles of S (8 keys each)
  constexpr int NT_O = HD / 8;     // n-tiles of O (8 columns each)
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  __nv_bfloat16* Qs = sm + S::QS;
  __nv_bfloat16* Ks = sm + S::KS;
  __nv_bfloat16* Vs = sm + S::VS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_ld = (long long)H * HD;
  const long long kv_ld = (long long)KV * HD;
  const __nv_bfloat16* qb = q + (long long)b * Sq * q_ld + (long long)h * HD;
  const __nv_bfloat16* kb = k + (long long)b * Skv * kv_ld + (long long)kvh * HD;
  const __nv_bfloat16* vb = v + (long long)b * Skv * kv_ld + (long long)kvh * HD;
  __nv_bfloat16* ob = o + (long long)b * Sq * q_ld + (long long)h * HD;

  // Stage the q tile (rows past Sq zero) and take this warp's A fragments.
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < kBQ * HD / VN; e += kMmaThreads) {
    const int r = e / (HD / VN), d0 = (e % (HD / VN)) * VN;
    *reinterpret_cast<uint4*>(&Qs[r * S::LD + d0]) =
        q0 + r < Sq ? *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_ld + d0)
                    : zero;
  }
  __syncthreads();
  uint32_t qa[KSTEPS][4];
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ld32(&Qs[r0 * S::LD + c]);
    qa[kk][1] = ld32(&Qs[(r0 + 8) * S::LD + c]);
    qa[kk][2] = ld32(&Qs[r0 * S::LD + c + 8]);
    qa[kk][3] = ld32(&Qs[(r0 + 8) * S::LD + c + 8]);
  }

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int qp[2] = {q_offset + q0 + r0, q_offset + q0 + r0 + 8};

  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_offset + q_last + 1) : Skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the last tile's readers are done
    for (int e = tid; e < kBK * HD / VN; e += kMmaThreads) {
      const int c = e / (HD / VN), d0 = (e % (HD / VN)) * VN;
      uint4 kr = zero, vr = zero;
      if (k0 + c < Skv) {
        const long long off = (k0 + c) * kv_ld + d0;
        kr = *reinterpret_cast<const uint4*>(kb + off);
        vr = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(&Ks[c * S::LD + d0]) = kr;
      *reinterpret_cast<uint4*>(&Vs[c * S::LD + d0]) = vr;
    }
    __syncthreads();

    // S = Q K^T (unscaled), 16 x 64 per warp.
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = &Ks[(j * 8 + g) * S::LD + 2 * t];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        mma_bf16(s[j], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    // Scale, mask, online softmax for rows r0 (i = 0) and r0 + 8 (i = 1).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kp = k0 + j * 8 + 2 * t + (e & 1);
        const bool ok = kp < Skv && (!causal || qp[i] >= kp);
        s[j][e] = ok ? s[j][e] * scale : -INFINITY;
        mx[i] = fmaxf(mx[i], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        s[j][e] = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m[i]);
        rs[i] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];  // per-thread part
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V: P's A fragments straight from the score registers.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vrow = &Vs[(kk * 16 + (lane & 15)) * S::LD];
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(vrow + n * 8, b0, b1);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float den = fmaxf(quad_sum(l[i]), 1e-30f);
    const int r = q0 + r0 + 8 * i;
    if (r < Sq) {
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const __nv_bfloat162 val =
            __floats2bfloat162_rn(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
        *reinterpret_cast<__nv_bfloat162*>(&ob[r * q_ld + n * 8 + 2 * t]) = val;
      }
    }
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Skv, int H, int KV, int causal,
                       int q_offset, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_mma_kernel<HD>;
  const size_t smem = MmaSmem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq,
      Skv, H, KV, causal, q_offset, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- dispatch

template <int HD>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Skv, int H, int KV, int causal,
                       int q_offset, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<float, HD>;
  const size_t smem = Smem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, KV,
      causal, q_offset, scale);
  return cudaGetLastError();
}

// bf16 runs on the tensor cores; f32 with FMA, so nothing is rounded to bf16.
template <int HD>
cudaError_t launch_hd(int dtype, const void* q, const void* k, const void* v,
                      void* o, int B, int Sq, int Skv, int H, int KV,
                      int causal, int q_offset, float scale, cudaStream_t s) {
  if (dtype == kBF16)
    return launch_mma<HD>(q, k, v, o, B, Sq, Skv, H, KV, causal, q_offset, scale, s);
  return launch_fma<HD>(q, k, v, o, B, Sq, Skv, H, KV, causal, q_offset, scale, s);
}

}  // namespace

// q, o: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); contiguous, 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int B, int Sq, int Skv, int H, int KV,
                              int hd, int dtype, int causal, int q_offset,
                              float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 || q_offset < 0 ||
      (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return (int)launch_hd<16>(dtype, q, k, v, o, B, Sq, Skv, H, KV, causal, q_offset, scale, s);
    case 32: return (int)launch_hd<32>(dtype, q, k, v, o, B, Sq, Skv, H, KV, causal, q_offset, scale, s);
    case 64: return (int)launch_hd<64>(dtype, q, k, v, o, B, Sq, Skv, H, KV, causal, q_offset, scale, s);
    case 128: return (int)launch_hd<128>(dtype, q, k, v, o, B, Sq, Skv, H, KV, causal, q_offset, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
