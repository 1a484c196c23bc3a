// Flash-attention forward and backward for Hopper (sm_90a): online softmax,
// GQA, causal with q_offset, any Sq and Skv.  The backward is described
// where it starts, below the forward's four variants.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py).  It computes what that
// kernel computes — softmax(scale * q k^T, masked) v with f32 m / l / acc and
// the output acc / max(l, 1e-30) — but not block by block: on the TPU the kv
// grid axis runs in order and carries the running state in VMEM scratch; here
// one CTA owns one (b, h, q tile) and loops over KV tiles itself, keeping m,
// l and its slice of acc in registers.
//
// Bound on the H100: tensor FLOPs (4 * B * H * Sq * Skv * hd, about half of
// it under the causal mask, against 989 TFLOP/s bf16), but for one query
// row (decode), where it is bytes.  Four kernels, one per variant; the
// launch plan (variant, tiles, grid, shared memory) comes from `plan()` in
// kernels/flash_attention/kernel.py, and nothing falls back from one
// variant to another:
//   * wgmma (bf16, hd 64 and 128, Sq >= 2: prefill and training).
//     FlashAttention-3 in outline.  A persistent grid (one CTA per SM)
//     walks the work items (128 q rows of one (b, h)) heaviest first.  A
//     CTA has three warpgroups.
//     Warpgroup 0 is the producer: its one elected thread TMA-loads each
//     item's Q tile into one of two Q buffers (so the next item's Q arrives
//     while the current one runs) and the K and V tiles of 128 keys into a
//     ring of STAGES slots, with a "full" mbarrier per slot for K and for V,
//     counted in bytes, and an "empty" one the consumers' 8 warps arrive on.
//     Warpgroups 1 and 2 are consumers of 64 q rows each.  S = Q K^T is
//     wgmma m64n128k16 with both operands in shared memory (K-major, 128-byte
//     swizzle); the online softmax runs on the f32 accumulator in registers
//     (quad shuffles, ex2 of s * scale * log2(e) - m); P is packed to bf16 in
//     place, since the accumulator layout of m64nN is the register-A layout
//     of the next product, and O += P V is wgmma m64n{hd}k16 with V MN-major
//     (transposed) from shared memory.  setmaxnreg hands the producer's
//     registers to the consumers (56 / 224).  The mask is applied only from
//     the first KV tile that crosses the diagonal or reaches Skv.  O / l goes
//     through the warpgroup's own (no longer read) Q rows to a TMA store,
//     which clips rows past Sq; the Q buffer is released once the store has
//     read it.  TMA's zero fill covers a ragged last tile: S is its own
//     dimension of the 4-D (hd, heads, S, B) tensor maps, so a tile never
//     reads into the next sequence.  Not here yet: ping-pong between the
//     consumers and overlap of the softmax with the next Q K^T.
//     Faults to know: a wrong mbarrier parity hangs the kernel (the producer
//     waits a slot's "empty" barrier with parity (round & 1) ^ 1, the
//     consumers the "full" ones with round & 1; hopper.cuh's wait traps after
//     ~2^26 polls, so a hang becomes a launch error); a wrong descriptor
//     gives wrong numbers, not a fault (see hopper.cuh for the LBO / SBO of
//     each operand); registers: 64 (O) + 64 (S) + 32 (P) a thread at hd 128.
//   * mma_sync (bf16, hd 16 and 32): warp-level mma.sync m16n8k16, 4 warps
//     of 16 q rows, K and V tiles loaded synchronously into shared memory.
//   * fma (f32): plain f32 FMA from shared memory (f32 inputs must not be
//     rounded to bf16), 16 x 16 threads each owning 4 q rows x 4 KV columns.
//   * decode (bf16, hd 64 and 128, Sq = 1: decode's cross-attention): split
//     KV ("flash-decoding"), the GQA group's heads as one tile's rows, the
//     splits of a group one cluster, merged through distributed shared
//     memory; described where it starts, below.
// All skip the work the mask removes: KV tiles wholly above the causal
// diagonal are never loaded or multiplied, and the heaviest q tiles are
// scheduled first.
//
// Layouts: q, o (B, Sq, H, hd); k, v (B, Skv, KV, hd), all contiguous; KV head
// of q head h is h / (H / KV).  A ragged last q tile is masked (the TPU
// kernel's Sq % block_q restriction does not carry over), as are KV rows at or
// past Skv.
#include "common.cuh"
#include "hopper.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

// Variant codes passed from Python (kernels/flash_attention/kernel.py: VARIANTS).
enum Variant : int { kWgmma = 0, kMmaSync = 1, kFma = 2, kDecode = 3 };

constexpr int kBQ = 64;       // fma and mma_sync: q rows per CTA
constexpr int kBK = 64;       // fma and mma_sync: KV rows per tile
constexpr int kThreads = 256; // fma: 16 x 16 threads
constexpr int kMmaThreads = 128;  // mma_sync: 4 warps x 16 q rows
constexpr int kWgBQ = 128;        // wgmma: q rows per item (2 consumers x 64)
constexpr int kWgBN = 128;        // wgmma: keys per KV tile
constexpr int kWgThreads = 384;   // wgmma: producer + 2 consumer warpgroups

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
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                 int causal, int q_offset, float scale) {
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
      // m is in scaled units here (the q tile was scaled).
      if (lse != nullptr && tx == 0)
        lse[((long long)b * H + h) * Sq + r] = m[i] + logf(den);
    }
  }
}

// ------------------------------------------------- bf16 mma.sync (hd 16, 32)

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
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int Sq, int Skv, int H, int KV, int causal, int q_offset,
                     float scale) {
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
      if (lse != nullptr && t == 0)  // m is in scaled units here
        lse[((long long)b * H + h) * Sq + r] = m[i] + logf(den);
    }
  }
}


// ------------------------------------------------- bf16 wgmma + TMA (hd 64, 128)

template <int HD, int STAGES>
struct WgSmem {
  static constexpr int Q_BYTES = kWgBQ * HD * 2;   // one Q tile
  static constexpr int KV_BYTES = kWgBN * HD * 2;  // one K or one V tile
  static constexpr int Q = 0;                      // two Q tiles
  static constexpr int K = Q + 2 * Q_BYTES;
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int BARS = V + STAGES * KV_BYTES;
  // + q_full / q_empty per Q tile, k_full / v_full / empty per slot; + 1024
  // bytes so the tiles can start on the swizzle's 1024-byte period.
  static constexpr int BYTES = BARS + (4 + 3 * STAGES) * 8 + 1024;
};

// 2^x on the MUFU unit (x = -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) hopper::wgmma_rs_n64(d, a, db);
  else hopper::wgmma_rs_n128(d, a, db);
}

// A work item is one (q tile, h, b); item w takes q tile n_qt - 1 - w / (H B)
// (heaviest first), h = w % H, b = w / H % B.  The grid is persistent: CTA i
// takes items i, i + gridDim.x, ... so the producer loads the next item's Q
// (into the other of two Q tiles) and its first K / V tiles while the
// consumers finish the current one.
__device__ __forceinline__ void wg_item(int w, int H, int B, int n_qt, int& q0,
                                        int& h, int& b) {
  const int hb = H * B;
  q0 = (n_qt - 1 - w / hb) * kWgBQ;
  h = w % H;
  b = w / H % B;
}

template <int HD, int STAGES>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o,
                       float* __restrict__ lse, int B, int Sq, int Skv, int H,
                       int KV, int causal, int q_offset, float scale,
                       float scale_log2) {
  using S = WgSmem<HD, STAGES>;
  static_assert(HD % 64 == 0, "head dim in 64-column chunks");
  constexpr int CH = HD / 64;  // 64-column (128-byte) chunks of a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = sm + S::Q;
  uint8_t* Ks = sm + S::K;
  uint8_t* Vs = sm + S::V;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + S::BARS);  // [2]
  uint64_t* q_empty = q_full + 2;                                 // [2]
  uint64_t* k_full = q_empty + 2;                                 // [STAGES]
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int n_qt = (Sq + kWgBQ - 1) / kWgBQ;
  const int n_items = n_qt * H * B;
  const int group = H / KV;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&q_full[i], 1);
      hopper::mbar_init(&q_empty[i], 2);  // one arrival per consumer warpgroup
    }
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // The KV tiles an item needs, and the first that needs the mask (it holds
  // a key past the item's smallest q position, or at or past Skv): the same
  // formulas as kv_tiles() in kernels/flash_attention/kernel.py.
  auto tiles_of = [&](int q0, int& n_tiles, int& mask_from) {
    const int q_last = min(q0 + kWgBQ, Sq) - 1;
    const int kv_end = causal ? min(Skv, q_offset + q_last + 1) : Skv;
    n_tiles = (kv_end + kWgBN - 1) / kWgBN;
    mask_from = min(causal ? (q_offset + q0 + 1) / kWgBN : n_tiles, Skv / kWgBN);
  };

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    hopper::setmaxnreg_dec<56>();
    if (threadIdx.x == 0) {
      int it = 0;  // KV tiles loaded so far: ring slot it % STAGES
      for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
        int q0, h, b, n_tiles, mask_from;
        wg_item(w, H, B, n_qt, q0, h, b);
        tiles_of(q0, n_tiles, mask_from);
        const int kvh = h / group;
        uint8_t* Qj = Qs + (j & 1) * S::Q_BYTES;
        hopper::mbar_wait(&q_empty[j & 1], ((j >> 1) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&q_full[j & 1], S::Q_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          hopper::tma_load_4d(Qj + c * kWgBQ * 128, &tm_q, &q_full[j & 1], c * 64,
                              h, q0, b);
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int s = it % STAGES;
          hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&k_full[s], S::KV_BYTES);
#pragma unroll
          for (int c = 0; c < CH; ++c)
            hopper::tma_load_4d(Ks + s * S::KV_BYTES + c * kWgBN * 128, &tm_k,
                                &k_full[s], c * 64, kvh, t * kWgBN, b);
          hopper::mbar_arrive_expect_tx(&v_full[s], S::KV_BYTES);
#pragma unroll
          for (int c = 0; c < CH; ++c)
            hopper::tma_load_4d(Vs + s * S::KV_BYTES + c * kWgBN * 128, &tm_v,
                                &v_full[s], c * 64, kvh, t * kWgBN, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    hopper::setmaxnreg_inc<224>();
    const int cw = wg - 1;  // this warpgroup's q rows: q0 + 64 cw .. + 63
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    int it = 0;
    for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
      int q0, h, b, n_tiles, mask_from;
      wg_item(w, H, B, n_qt, q0, h, b);
      tiles_of(q0, n_tiles, mask_from);
      const int qp0 = q_offset + q0 + 64 * cw + 16 * warp + g;  // rows qp0, qp0 + 8
      uint8_t* Qw = Qs + (j & 1) * S::Q_BYTES + cw * 64 * 128;  // own rows per chunk

      float o[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

      hopper::mbar_wait(&q_full[j & 1], (j >> 1) & 1);
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int s = it % STAGES;
        const uint32_t parity = (it / STAGES) & 1;
        const uint8_t* Kt = Ks + s * S::KV_BYTES;
        const uint8_t* Vt = Vs + s * S::KV_BYTES;

        // S = Q K^T (unscaled), 64 x kWgBN for this warpgroup.
        float sc[kWgBN / 2];
        hopper::mbar_wait(&k_full[s], parity);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int off = (kk & 3) * 32;
          hopper::wgmma_ss_n128(sc,
                       hopper::sw128_desc(Qw + (kk >> 2) * kWgBQ * 128 + off, 16, 1024),
                       hopper::sw128_desc(Kt + (kk >> 2) * kWgBN * 128 + off, 16, 1024),
                       kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(sc);

        // Mask (only from the first tile that needs it), then online softmax
        // for rows qp0 (i = 0) and qp0 + 8 (i = 1).
        if (t >= mask_from) {
#pragma unroll
          for (int jj = 0; jj < kWgBN / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kp = t * kWgBN + 8 * jj + 2 * qd + (e & 1);
              const bool ok = kp < Skv && (!causal || kp <= qp0 + 8 * (e >> 1));
              if (!ok) sc[4 * jj + e] = -INFINITY;
            }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int jj = 0; jj < kWgBN / 8; ++jj) {
          mx[0] = fmaxf(mx[0], fmaxf(sc[4 * jj], sc[4 * jj + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(sc[4 * jj + 2], sc[4 * jj + 3]));
        }
        float alpha[2], neg[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_new = fmaxf(m[i], quad_max(mx[i]));
          const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked so far
          alpha[i] = ex2((m[i] - m_use) * scale_log2);
          neg[i] = m_use * scale_log2;
          m[i] = m_new;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int jj = 0; jj < kWgBN / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            sc[4 * jj + e] = ex2(fmaf(sc[4 * jj + e], scale_log2, -neg[i]));
            rs[i] += sc[4 * jj + e];
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];  // per-thread part
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj) {
          o[4 * jj] *= alpha[0];
          o[4 * jj + 1] *= alpha[0];
          o[4 * jj + 2] *= alpha[1];
          o[4 * jj + 3] *= alpha[1];
        }
        uint32_t pa[kWgBN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kWgBN / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }

        // O += P V: 16 keys (2048 bytes of V) per instruction.
        hopper::fence_regs(o);
        hopper::fence_regs(pa);
        hopper::mbar_wait(&v_full[s], parity);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBN / 16; ++kk)
          wgmma_rs<HD>(o, pa[kk], hopper::sw128_desc(Vt + kk * 2048, kWgBN * 128, 1024));
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(o);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      }

      // O / l in bf16 into this warpgroup's Q rows (swizzled as TMA wrote
      // them), then one TMA store per 64-column chunk, which clips rows past
      // Sq; the Q tile is released once the store has read it.  Where asked,
      // one lane of each quad (which holds the row's m and l) writes the
      // row's log-sum-exp of the scaled scores (m is unscaled here).
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float den = fmaxf(quad_sum(l[i]), 1e-30f);
        const int r = 16 * warp + g + 8 * i;
        if (lse != nullptr && qd == 0 && q0 + 64 * cw + r < Sq)
          lse[((long long)b * H + h) * Sq + q0 + 64 * cw + r] =
              m[i] * scale + logf(den);
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj) {
          uint8_t* dst = Qw + (jj >> 3) * kWgBQ * 128 + r * 128 +
                         (((jj & 7) ^ (r & 7)) << 4) + qd * 4;
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
              o[4 * jj + 2 * i] / den, o[4 * jj + 2 * i + 1] / den);
        }
      }
      hopper::fence_async_smem();
      hopper::named_barrier(1 + cw, 128);
      if (tid == 0) {
        if (q0 + 64 * cw < Sq) {
#pragma unroll
          for (int c = 0; c < CH; ++c)
            hopper::tma_store_4d(&tm_o, Qw + c * kWgBQ * 128, c * 64, h,
                                 q0 + 64 * cw, b);
          hopper::tma_store_wait();
        }
        hopper::mbar_arrive(&q_empty[j & 1]);
      }
    }
  }
}

template <int HD, int STAGES>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Sq, int Skv, int H, int KV,
                         int causal,
                         int q_offset, float scale, dim3 grid, int smem,
                         cudaStream_t stream) {
  if (smem < WgSmem<HD, STAGES>::BYTES) return cudaErrorInvalidValue;
  // 4-D maps over (hd, heads, S, B) with the real byte strides.
  const uint64_t row = HD * 2, q_ld = row * H, kv_ld = row * KV;
  CUtensorMap tq, tk, tv, to;
  const bool ok =
      make_bf16_map_4d(&tq, q, HD, H, Sq, B, row, q_ld, q_ld * Sq, kWgBQ) &&
      make_bf16_map_4d(&tk, k, HD, KV, Skv, B, row, kv_ld, kv_ld * Skv, kWgBN) &&
      make_bf16_map_4d(&tv, v, HD, KV, Skv, B, row, kv_ld, kv_ld * Skv, kWgBN) &&
      make_bf16_map_4d(&to, o, HD, H, Sq, B, row, q_ld, q_ld * Sq, 64);
  if (!ok) return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<HD, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, to, lse, B, Sq, Skv, H, KV,
                                           causal, q_offset, scale,
                                           scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int Sq, int Skv, int H, int KV, int causal,
                       int q_offset,
                       float scale, dim3 grid, int smem, cudaStream_t stream) {
  if (smem < (int)MmaSmem<HD>::BYTES) return cudaErrorInvalidValue;
  auto kern = flash_fwd_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      Sq, Skv, H, KV, causal, q_offset, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int Sq, int Skv, int H, int KV, int causal,
                       int q_offset,
                       float scale, dim3 grid, int smem, cudaStream_t stream) {
  if (smem < (int)Smem<HD>::BYTES) return cudaErrorInvalidValue;
  auto kern = flash_fwd_kernel<float, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Skv, H,
      KV, causal, q_offset, scale);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16 decode (Sq = 1, hd 64, 128)
//
// One query row a (b, q head): decode's cross-attention over an image's
// keys.  Bound on the H100 by bytes, not FLOPs: each K and V row is read
// once and used for the G = H / KV query heads of its GQA group, about 4 G
// FLOPs a byte pair, far below the tensor cores' ~295 a byte.  The wgmma
// variant would spend a 128-row Q tile on one valid row and stream each KV
// head's keys once for each of its G heads, one KV tile after another.
// Here ("flash-decoding"): one CTA per (key split, KV head x row tile, b).
// Its rows are the group's heads (up to 16 a row tile, padded: mma.sync
// m16n8k16's M), so each key's K and V leave HBM once for the whole group.
// The 4 warps take 16-key chunks of the split in turn (chunk c goes to warp
// c % 4); each warp streams its chunks' K and V rows by cp.async into its
// own two-slot ring in shared memory (zeros past the split's last key), so
// the next chunk loads while this one is used, and no barrier is shared
// across warps until the end.  S = Q K^T and O += P V run on mma.sync as in
// the mma_sync variant (P packed to bf16 from the score registers), with an
// online softmax per warp.  The warps' (m, l, o) merge through shared
// memory (weights exp(m_w - max)) into the split's partial: o unnormalised
// in f32, m and l, kept in shared memory.  The splits of one (KV head, row
// tile, b) are one thread-block cluster (grid x, at most 16 CTAs, split by
// 16-key chunks as evenly as they go, none empty): after a cluster barrier
// each CTA reads every split's partial from its peers' shared memory
// (distributed shared memory), merges a share of the output's elements
// with weights exp(m_i - max) (a split with no valid key would weigh
// exactly 0), casts o to bf16 once and, when asked, writes lse; a second
// barrier keeps every CTA's shared memory alive until its peers are done.
// One launch, and no partial goes through global memory.  On an H100 at
// llama-vision's decode shape (q (4, 1, 64, 128) over 1601 keys, 8 KV
// heads) the loads and products end ~19.6 us after the launch (~4.8 us of
// it the launch itself, timed after a write that fills L2 with dirty
// lines) and the two merges take ~6 more; merging through global memory
// after an atomic ticket instead (a __threadfence, the ticket, the last
// CTA's reads) took 8-9 (examples/flash_decode_bench_torch.py --phases).
// Keys at or past Skv, and under the causal mask past q_offset, are never
// loaded.

constexpr int kDecRows = 16;                     // q rows a row tile (m16)
constexpr int kDecChunk = 16;                    // keys a warp takes at a time
constexpr int kDecWarps = 4;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecStages = 2;                    // ring slots a warp
constexpr int kDecMaxSplits = 16;                // CTAs a cluster (non-portable past 8)

template <int HD>
struct DecSmem {
  static constexpr int LD = HD + 8;              // bf16 row stride: conflict-free fragments
  static constexpr int SLOT = 2 * kDecChunk * LD;  // one chunk's K rows, then its V rows
  static constexpr int KV_BYTES = kDecWarps * kDecStages * SLOT * 2;
  static constexpr int ACC_LD = HD + 8;          // f32 row stride of the warps' o
  static constexpr int ACC_BYTES = kDecWarps * kDecRows * ACC_LD * 4;
  static constexpr int PART = ACC_BYTES;         // the split's o: [row][HD] f32
  static constexpr int PART_BYTES = kDecRows * HD * 4;
  // The rings, then (once they are drained) the warps' o and the split's.
  static constexpr int BUF = KV_BYTES > PART + PART_BYTES ? KV_BYTES : PART + PART_BYTES;
  static constexpr int ML = BUF;                 // the warps' m, l: [2][warp][row] f32
  static constexpr int ROW = ML + 2 * kDecWarps * kDecRows * 4;  // the split's m, l: [2][row]
  static constexpr int BYTES = ROW + 2 * kDecRows * 4;
};

// 16-byte asynchronous copy to shared memory, bypassing L1; zeros when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The first key of split `i` of `n` over `chunks` 16-key chunks (the splits
// differ by at most one chunk; kernel.py's decode_splits mirrors it).
__device__ __forceinline__ int dec_split_begin(int i, int n, int chunks) {
  return (int)((long long)i * chunks / n) * kDecChunk;
}

template <int HD>
__global__ void __launch_bounds__(kDecThreads)
flash_fwd_decode_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                        int Skv, int H, int KV, int n_keys, float scale) {
  using S = DecSmem<HD>;
  constexpr int KSTEPS = HD / 16;   // k-steps of S = Q K^T
  constexpr int NT_O = HD / 8;      // n-tiles of O (8 columns each)
  constexpr int PIECES = HD / 8;    // 16-byte pieces a row
  constexpr int V4 = HD / 4;        // float4s a row of o
  extern __shared__ __align__(16) uint8_t dsm[];
  float* wm = reinterpret_cast<float*>(dsm + S::ML);  // [warp][row]
  float* wl = wm + kDecWarps * kDecRows;
  float* rm = reinterpret_cast<float*>(dsm + S::ROW);  // [row]
  float* rl = rm + kDecRows;
  float* part = reinterpret_cast<float*>(dsm + S::PART);  // [row][HD]

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, n_splits = gridDim.x;  // one cluster: grid x
  const int G = H / KV, RT = (G + kDecRows - 1) / kDecRows;
  const int kvh = blockIdx.y / RT, rt = blockIdx.y % RT, b = blockIdx.z;
  const int h0 = kvh * G + rt * kDecRows;            // the tile's first q head
  const int rows = min(kDecRows, G - rt * kDecRows);  // its valid rows
  const long long kv_ld = (long long)KV * HD;
  const __nv_bfloat16* kb = k + (long long)b * Skv * kv_ld + (long long)kvh * HD;
  const __nv_bfloat16* vb = v + (long long)b * Skv * kv_ld + (long long)kvh * HD;
  const int chunks = (n_keys + kDecChunk - 1) / kDecChunk;
  const int k_begin = dec_split_begin(split, n_splits, chunks);
  const int k_end = min(dec_split_begin(split + 1, n_splits, chunks), n_keys);
  const int n_chunks = (k_end - k_begin + kDecChunk - 1) / kDecChunk;
  const int mine = n_chunks > warp ? (n_chunks - warp + kDecWarps - 1) / kDecWarps : 0;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(dsm) + warp * kDecStages * S::SLOT;

  // This warp's i-th chunk (split chunk warp + 4 i) into slot i & 1.
  auto load = [&](int i) {
    __nv_bfloat16* dst = ring + (i & 1) * S::SLOT;
    const int k0 = k_begin + (warp + i * kDecWarps) * kDecChunk;
#pragma unroll 2
    for (int e = lane; e < kDecChunk * PIECES; e += 32) {
      const int r = e / PIECES, d0 = (e % PIECES) * 8;
      const bool in = k0 + r < k_end;
      const long long off = (long long)(in ? k0 + r : k_begin) * kv_ld + d0;
      cp_async16(dst + r * S::LD + d0, kb + off, in);
      cp_async16(dst + (kDecChunk + r) * S::LD + d0, vb + off, in);
    }
  };
  if (mine > 0) load(0);
  cp_async_commit();
  if (mine > 1) load(1);
  cp_async_commit();

  // Q's A fragments straight from global memory (rows g and g + 8; zero
  // past the group's heads).
  uint32_t qa[KSTEPS][4];
  {
    const __nv_bfloat16* q0 = q + ((long long)b * H + h0 + g) * HD + 2 * t;
    const __nv_bfloat16* q1 = q0 + 8 * HD;
    const bool in0 = g < rows, in1 = g + 8 < rows;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      qa[kk][0] = in0 ? ld32(q0 + kk * 16) : 0u;
      qa[kk][1] = in1 ? ld32(q1 + kk * 16) : 0u;
      qa[kk][2] = in0 ? ld32(q0 + kk * 16 + 8) : 0u;
      qa[kk][3] = in1 ? ld32(q1 + kk * 16 + 8) : 0u;
    }
  }

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<1>();  // chunk i has landed (chunk i + 1 may still fly)
    __syncwarp();
    const __nv_bfloat16* Ks = ring + (i & 1) * S::SLOT;
    const __nv_bfloat16* Vs = Ks + kDecChunk * S::LD;
    const int k0 = k_begin + (warp + i * kDecWarps) * kDecChunk;

    // S = Q K^T (unscaled): 16 rows x 16 keys.
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = &Ks[(j * 8 + g) * S::LD + 2 * t];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        mma_bf16(s[j], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }
    // Scale, mask past the split's last key, online softmax (rows g, g + 8).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k0 + j * 8 + 2 * t + (e & 1) < k_end;
        s[j][e] = ok ? s[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = m_new == -INFINITY ? 1.f : expf(m[r] - m_new);
      m[r] = m_new;
    }
    l[0] *= alpha[0];
    l[1] *= alpha[1];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[j][e] = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m[r]);
        l[r] += s[j][e];  // this thread's columns; quad-summed at the end
      }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // acc += P V.
    uint32_t pa[4];
    pa[0] = pack_bf16(s[0][0], s[0][1]);
    pa[1] = pack_bf16(s[0][2], s[0][3]);
    pa[2] = pack_bf16(s[1][0], s[1][1]);
    pa[3] = pack_bf16(s[1][2], s[1][3]);
    const __nv_bfloat16* vrow = &Vs[(lane & 15) * S::LD];
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(vrow + n * 8, b0, b1);
      mma_bf16(acc[n], pa, b0, b1);
    }
    __syncwarp();  // every lane is done with slot i & 1
    if (i + 2 < mine) load(i + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // The warps' partials into the split's: weights exp(m_w - max) a row.
  const float lq[2] = {quad_sum(l[0]), quad_sum(l[1])};
  if (t == 0) {
    wm[warp * kDecRows + g] = m[0];
    wm[warp * kDecRows + g + 8] = m[1];
    wl[warp * kDecRows + g] = lq[0];
    wl[warp * kDecRows + g + 8] = lq[1];
  }
  __syncthreads();  // the rings are free; every warp's m and l are visible
  float* accs = reinterpret_cast<float*>(dsm);  // [warp][row][ACC_LD], over the rings
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    float top = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) top = fmaxf(top, wm[w * kDecRows + row]);
    const float wt = m[r] == -INFINITY ? 0.f : expf(m[r] - top);
    float* dst = accs + (warp * kDecRows + row) * S::ACC_LD + 2 * t;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(acc[n][2 * r] * wt, acc[n][2 * r + 1] * wt);
  }
  __syncthreads();
  for (int e = tid; e < rows * V4; e += kDecThreads) {
    const int r = e / V4, c = (e % V4) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(
          accs + (w * kDecRows + r) * S::ACC_LD + c);
      sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
    }
    *reinterpret_cast<float4*>(part + r * HD + c) = sum;
  }
  if (tid < rows) {
    float top = -INFINITY, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) top = fmaxf(top, wm[w * kDecRows + tid]);
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float mw = wm[w * kDecRows + tid];
      sum += mw == -INFINITY ? 0.f : expf(mw - top) * wl[w * kDecRows + tid];
    }
    rm[tid] = top;
    rl[tid] = sum;
  }

  // Every split's partial, from the cluster's shared memory: CTA `split`
  // merges elements split, split + n_splits, ... (4 columns each).
  cluster.sync();  // the splits' partials are visible across the cluster
  for (int e = split * kDecThreads + tid; e < rows * V4; e += n_splits * kDecThreads) {
    const int r = e / V4, c = (e % V4) * 4;
    float top = -INFINITY;
    for (int sp = 0; sp < n_splits; ++sp)
      top = fmaxf(top, *cluster.map_shared_rank(rm + r, sp));
    float den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < n_splits; ++sp) {
      const float ms = *cluster.map_shared_rank(rm + r, sp);
      const float wt = ms == -INFINITY ? 0.f : expf(ms - top);
      const float4 x = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part + r * HD + c, sp));
      den += wt * *cluster.map_shared_rank(rl + r, sp);
      num.x += wt * x.x; num.y += wt * x.y; num.z += wt * x.z; num.w += wt * x.w;
    }
    den = fmaxf(den, 1e-30f);
    const long long row = (long long)b * H + h0 + r;
    const float inv = 1.f / den;
    __nv_bfloat162 lo = __floats2bfloat162_rn(num.x * inv, num.y * inv);
    __nv_bfloat162 hi = __floats2bfloat162_rn(num.z * inv, num.w * inv);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(o + row * HD + c) = packed;
    if (lse != nullptr && c == 0) lse[row] = top + logf(den);
  }
  cluster.sync();  // no CTA leaves while a peer still reads its partial
}

template <int HD>
cudaError_t launch_decode(const void* q, const void* k, const void* v, void* o,
                          float* lse, int Skv, int H, int KV, int n_keys,
                          float scale, dim3 grid, int smem, cudaStream_t stream) {
  if (smem < DecSmem<HD>::BYTES) return cudaErrorInvalidValue;
  auto kern = flash_fwd_decode_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && grid.x > 8)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kDecThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;  // the splits of one (KV head, row tile, b)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v),
                           static_cast<__nv_bfloat16*>(o), lse, Skv, H, KV,
                           n_keys, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ------------------------------------------------------------------ backward
//
// The backward (FlashAttention-2's equations).  The JAX package
// has no backward kernel (its CPU path differentiates flash_attention_ref);
// this computes what that gradient computes, from the forward's row
// log-sum-exp instead of a second online softmax:
//   D = rowsum(dO * O),  P = exp(scale * Q K^T - lse)  (masked),
//   dV = P^T dO,  dS = P * (dO V^T - D),  dQ = scale * dS K,  dK = scale * dS^T Q.
// For each key block and KV head it loops over the group's H / KV q heads
// and over the q blocks that the causal mask keeps, so dK and dV (summed
// over the GQA group) accumulate in f32 registers and are written once,
// with no atomics.  dQ gathers from every key block into an f32 buffer that
// the D pass zeroes, which the wrapper casts (the sum order, and so dq's
// last bits, vary between runs).  Bound on the H100: tensor FLOPs, 2.5x the
// forward's (five products over the pairs the mask keeps, against the
// forward's two).  Three variants:
//   * wgmma (bf16, hd 64 and 128: every training shape): TMA + wgmma +
//     an mbarrier ring, described where it starts, below.
//   * mma_sync (bf16, hd 16 and 32): one CTA per (64-key block, KV head,
//     b), 4 warps each owning 16 keys; S^T = K Q^T and dP^T = V dO^T with
//     the keys as the m16n8k16 rows, P^T and dS^T packed to bf16 straight
//     from the accumulators as the A operand of dV += P^T dO and dK += dS^T
//     Q (B by ldmatrix.trans), then dS through shared memory (as [q][key])
//     for dQ = dS K, added with f32 atomicAdd.  q blocks of 64 rows.
//   * fma (f32): the same CTAs, 16 x 16 threads, each owning 4 keys x 4 q
//     of the scores and 4 keys x hd/16 columns of dK / dV; nothing is
//     rounded to bf16.

constexpr int kBwdBK = 64;           // keys per CTA (mma_sync and fma)
constexpr int kBwdMmaThreads = 128;  // mma_sync: 4 warps x 16 keys
constexpr int kBwdMmaBQ = 64;        // mma_sync: q rows per block
constexpr int kBwdFmaThreads = 256;  // fma: 16 x 16 threads
constexpr int kBwdFmaBQ = 64;        // fma: q rows per block

// D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in f32: one warp per
// (b, i, h) row of the (B, Sq, H, hd) tensors; D is (B, H, Sq).  The same
// warp zeroes the row of the f32 dQ buffer (B, Sq, H, hd) that the main
// kernel then adds into, so the caller need not clear it.  (Vector loads
// with several rows a warp ran the pass in 23 us instead of 35 at zamba2's
// shape, but their other order of the f32 sum moved the reduced f32
// training check on the card past its 1e-4.)
template <typename T>
__global__ void flash_bwd_dot_kernel(const T* __restrict__ o,
                                     const T* __restrict__ dout,
                                     float* __restrict__ D,
                                     float* __restrict__ dq, long long rows,
                                     int Sq, int H, int hd) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const T* op = o + row * hd;
  const T* dp = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) {
    acc += to_f(op[d]) * to_f(dp[d]);
    dq[row * hd + d] = 0.f;
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    const long long bi = row / H;
    const long long b = bi / Sq;
    D[(b * H + row % H) * Sq + bi % Sq] = acc;
  }
}

template <int HD>
struct BwdMmaSmem {
  static constexpr int BQ = kBwdMmaBQ;
  // bf16 row strides: rows stay 16-byte aligned for ldmatrix, and the 8 rows
  // a fragment read touches fall in distinct banks.
  static constexpr int LD = HD + 8;         // K, V, Q, dO tiles [row][d]
  static constexpr int LDS = kBwdBK + 8;    // dS tile [q][key]
  static constexpr int KS = 0;
  static constexpr int VS = KS + kBwdBK * LD;
  static constexpr int QS = VS + kBwdBK * LD;
  static constexpr int DOS = QS + BQ * LD;
  static constexpr int DSS = DOS + BQ * LD;
  static constexpr int ELEMS = DSS + BQ * LDS;
  static constexpr size_t STATS = ELEMS * sizeof(__nv_bfloat16);  // lse, D
  static constexpr size_t BYTES = STATS + 2 * BQ * sizeof(float);
};

// A fragment (16 rows x 16 columns, row-major) of a [row][col] bf16 tile:
// rows r and r + 8, columns c and c + 8 (r = row0 + g, c = col0 + 2t).
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                       int ld, int r, int c) {
  a[0] = ld32(tile + r * ld + c);
  a[1] = ld32(tile + (r + 8) * ld + c);
  a[2] = ld32(tile + r * ld + c + 8);
  a[3] = ld32(tile + (r + 8) * ld + c + 8);
}

// Fragment layouts of mma.m16n8k16 as above (g = lane / 4, t = lane % 4).
template <int HD>
__global__ void __launch_bounds__(kBwdMmaThreads)
flash_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ Dd,
                     float* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
                     int KV, int causal, int q_offset, float scale) {
  using S = BwdMmaSmem<HD>;
  constexpr int BQ = kBwdMmaBQ;
  constexpr int VN = 8;             // bf16 per 16-byte load
  constexpr int KSTEPS = HD / 16;   // k-steps of the products over d
  constexpr int NT_Q = BQ / 8;      // n-tiles of S^T / dP^T (8 q each)
  constexpr int NT_D = HD / 8;      // n-tiles of dK / dV / dQ (8 columns each)
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* Ks = sm + S::KS;
  __nv_bfloat16* Vs = sm + S::VS;
  __nv_bfloat16* Qs = sm + S::QS;
  __nv_bfloat16* dOs = sm + S::DOS;
  __nv_bfloat16* dSs = sm + S::DSS;
  float* lse_s = reinterpret_cast<float*>(bwd_smem + S::STATS);
  float* D_s = lse_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBwdBK, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KV;
  const long long q_ld = (long long)H * HD;
  const long long kv_ld = (long long)KV * HD;
  const long long kv_base = (long long)b * Skv * kv_ld + (long long)kvh * HD;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // This CTA's K and V tiles; rows past Skv are zero.
  for (int e = tid; e < kBwdBK * HD / VN; e += kBwdMmaThreads) {
    const int c = e / (HD / VN), d0 = (e % (HD / VN)) * VN;
    uint4 kr = zero, vr = zero;
    if (k0 + c < Skv) {
      const long long off = kv_base + (k0 + c) * kv_ld + d0;
      kr = *reinterpret_cast<const uint4*>(k + off);
      vr = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(&Ks[c * S::LD + d0]) = kr;
    *reinterpret_cast<uint4*>(&Vs[c * S::LD + d0]) = vr;
  }

  float dka[NT_D][4], dva[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const int kr0 = warp * 16 + g;              // this thread's keys: kr0, kr0 + 8
  const int kp[2] = {k0 + kr0, k0 + kr0 + 8};

  // q rows that see a key of this block: from k0 - q_offset under the mask.
  const int r_first = causal ? max(0, k0 - q_offset) : 0;
  const int n_qb = (Sq + BQ - 1) / BQ;

  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const long long q_base = (long long)b * Sq * q_ld + (long long)h * HD;
    const float* lse_h = lse + ((long long)b * H + h) * Sq;
    const float* D_h = Dd + ((long long)b * H + h) * Sq;
    for (int qb = r_first / BQ; qb < n_qb; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();  // the last block's readers are done (and K, V visible)
      for (int e = tid; e < BQ * HD / VN; e += kBwdMmaThreads) {
        const int r = e / (HD / VN), d0 = (e % (HD / VN)) * VN;
        uint4 qr = zero, dr = zero;
        if (q0 + r < Sq) {
          const long long off = q_base + (q0 + r) * q_ld + d0;
          qr = *reinterpret_cast<const uint4*>(q + off);
          dr = *reinterpret_cast<const uint4*>(dout + off);
        }
        *reinterpret_cast<uint4*>(&Qs[r * S::LD + d0]) = qr;
        *reinterpret_cast<uint4*>(&dOs[r * S::LD + d0]) = dr;
      }
      for (int r = tid; r < BQ; r += kBwdMmaThreads) {
        lse_s[r] = q0 + r < Sq ? lse_h[q0 + r] : 0.f;
        D_s[r] = q0 + r < Sq ? D_h[q0 + r] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ q per warp.
      float st[NT_Q][4], dp[NT_Q][4];
#pragma unroll
      for (int j = 0; j < NT_Q; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ka[4], va[4];
        a_frag(ka, Ks, S::LD, kr0, kk * 16 + 2 * t);
        a_frag(va, Vs, S::LD, kr0, kk * 16 + 2 * t);
#pragma unroll
        for (int j = 0; j < NT_Q; ++j) {
          const __nv_bfloat16* qr = &Qs[(j * 8 + g) * S::LD + kk * 16 + 2 * t];
          const __nv_bfloat16* dr = &dOs[(j * 8 + g) * S::LD + kk * 16 + 2 * t];
          mma_bf16(st[j], ka, ld32(qr), ld32(qr + 8));
          mma_bf16(dp[j], va, ld32(dr), ld32(dr + 8));
        }
      }

      // P^T (masked), then dS^T = P^T (dP^T - D) in f32.
      float pt[NT_Q][4];
#pragma unroll
      for (int j = 0; j < NT_Q; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t + (e & 1), key = kp[e >> 1];
          const bool ok = key < Skv && q0 + qi < Sq &&
                          (!causal || key <= q_offset + q0 + qi);
          pt[j][e] = ok ? expf(st[j][e] * scale - lse_s[qi]) : 0.f;
          st[j][e] = pt[j][e] * (dp[j][e] - D_s[qi]);
        }

      // dV += P^T dO and dK += dS^T Q: A from the registers, B by
      // ldmatrix.trans from the [q][d] tiles.
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_bf16(pt[2 * kk][0], pt[2 * kk][1]);
        pa[1] = pack_bf16(pt[2 * kk][2], pt[2 * kk][3]);
        pa[2] = pack_bf16(pt[2 * kk + 1][0], pt[2 * kk + 1][1]);
        pa[3] = pack_bf16(pt[2 * kk + 1][2], pt[2 * kk + 1][3]);
        sa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        sa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        sa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        sa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        const int row = (kk * 16 + (lane & 15)) * S::LD;
#pragma unroll
        for (int n = 0; n < NT_D; ++n) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(&dOs[row + n * 8], b0, b1);
          mma_bf16(dva[n], pa, b0, b1);
          ldmatrix_x2_trans(&Qs[row + n * 8], b0, b1);
          mma_bf16(dka[n], sa, b0, b1);
        }
      }

      // dS to shared memory as [q][key] (bf16), then dQ += scale dS K.
#pragma unroll
      for (int j = 0; j < NT_Q; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dSs[(j * 8 + 2 * t + (e & 1)) * S::LDS + kr0 + 8 * (e >> 1)] =
              __float2bfloat16_rn(st[j][e]);
      __syncthreads();
      const int qr = warp * 16;  // this warp's 16 q rows of dQ
      float* dq_h = dq + q_base;
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kBwdBK / 16; ++kk) {
          uint32_t a[4], b0, b1;
          a_frag(a, dSs, S::LDS, qr + g, kk * 16 + 2 * t);
          ldmatrix_x2_trans(&Ks[(kk * 16 + (lane & 15)) * S::LD + n * 8], b0, b1);
          mma_bf16(acc, a, b0, b1);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = q0 + qr + g + 8 * i;
          if (r < Sq) {
            float* dst = dq_h + r * q_ld + n * 8 + 2 * t;
            atomicAdd(dst, scale * acc[2 * i]);
            atomicAdd(dst + 1, scale * acc[2 * i + 1]);
          }
        }
      }
    }
  }

  // dK (scaled) and dV, summed over the group: written once.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kp[i] >= Skv) continue;
    const long long off = kv_base + kp[i] * kv_ld + 2 * t;
#pragma unroll
    for (int n = 0; n < NT_D; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(&dk[off + n * 8]) = __floats2bfloat162_rn(
          scale * dka[n][2 * i], scale * dka[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(&dv[off + n * 8]) =
          __floats2bfloat162_rn(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

template <int HD>
struct BwdFmaSmem {
  static constexpr int LD = HD + 1;          // K, V, Q, dO [row][d]: odd stride
  static constexpr int LDP = kBwdFmaBQ + 1;  // P, then dS, [key][q]
  static constexpr int KS = 0;
  static constexpr int VS = KS + kBwdBK * LD;
  static constexpr int QS = VS + kBwdBK * LD;
  static constexpr int DOS = QS + kBwdFmaBQ * LD;
  static constexpr int PS = DOS + kBwdFmaBQ * LD;
  static constexpr int LSE = PS + kBwdBK * LDP;
  static constexpr int DD = LSE + kBwdFmaBQ;
  static constexpr int FLOATS = DD + kBwdFmaBQ;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// f32: thread (ty, tx) owns keys ty*4+i and q rows tx+16j of the scores,
// keys ty*4+i and columns tx+16n of dK / dV, q rows ty*4+i and columns
// tx+16n of its dQ share.
template <int HD>
__global__ void __launch_bounds__(kBwdFmaThreads)
flash_bwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ Dd,
                     float* __restrict__ dq, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Skv, int H, int KV,
                     int causal, int q_offset, float scale) {
  using S = BwdFmaSmem<HD>;
  constexpr int BQ = kBwdFmaBQ;
  constexpr int CPT = HD / 16;  // columns per thread
  extern __shared__ __align__(16) float bwd_smem_f[];
  float* Ks = bwd_smem_f + S::KS;
  float* Vs = bwd_smem_f + S::VS;
  float* Qs = bwd_smem_f + S::QS;
  float* dOs = bwd_smem_f + S::DOS;
  float* Ps = bwd_smem_f + S::PS;
  float* lse_s = bwd_smem_f + S::LSE;
  float* D_s = bwd_smem_f + S::DD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kBwdBK, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KV;
  const long long q_ld = (long long)H * HD;
  const long long kv_ld = (long long)KV * HD;
  const long long kv_base = (long long)b * Skv * kv_ld + (long long)kvh * HD;

  for (int e = tid; e < kBwdBK * HD; e += kBwdFmaThreads) {
    const int c = e / HD, d = e % HD;
    const bool in = k0 + c < Skv;
    Ks[c * S::LD + d] = in ? k[kv_base + (k0 + c) * kv_ld + d] : 0.f;
    Vs[c * S::LD + d] = in ? v[kv_base + (k0 + c) * kv_ld + d] : 0.f;
  }

  float dka[4][CPT], dva[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < CPT; ++n) dka[i][n] = dva[i][n] = 0.f;

  const int r_first = causal ? max(0, k0 - q_offset) : 0;
  const int n_qb = (Sq + BQ - 1) / BQ;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const long long q_base = (long long)b * Sq * q_ld + (long long)h * HD;
    const float* lse_h = lse + ((long long)b * H + h) * Sq;
    const float* D_h = Dd + ((long long)b * H + h) * Sq;
    for (int qb = r_first / BQ; qb < n_qb; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();
      for (int e = tid; e < BQ * HD; e += kBwdFmaThreads) {
        const int r = e / HD, d = e % HD;
        const bool in = q0 + r < Sq;
        Qs[r * S::LD + d] = in ? q[q_base + (q0 + r) * q_ld + d] : 0.f;
        dOs[r * S::LD + d] = in ? dout[q_base + (q0 + r) * q_ld + d] : 0.f;
      }
      for (int r = tid; r < BQ; r += kBwdFmaThreads) {
        lse_s[r] = q0 + r < Sq ? lse_h[q0 + r] : 0.f;
        D_s[r] = q0 + r < Sq ? D_h[q0 + r] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty * 4 + i) * S::LD + d];
          vv[i] = Vs[(ty * 4 + i) * S::LD + d];
          qv[i] = Qs[(tx + 16 * i) * S::LD + d];
          ov[i] = dOs[(tx + 16 * i) * S::LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] += kv[i] * qv[j];
            dp[i][j] += vv[i] * ov[j];
          }
      }
      // P (masked) to shared memory; dS kept in s.
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + ty * 4 + i, qi = tx + 16 * j;
          const bool ok = key < Skv && q0 + qi < Sq &&
                          (!causal || key <= q_offset + q0 + qi);
          const float p = ok ? expf(s[i][j] * scale - lse_s[qi]) : 0.f;
          Ps[(ty * 4 + i) * S::LDP + qi] = p;
          s[i][j] = p * (dp[i][j] - D_s[qi]);
        }
      __syncthreads();
      for (int qi = 0; qi < BQ; ++qi) {  // dV += P dO
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * S::LDP + qi];
#pragma unroll
        for (int n = 0; n < CPT; ++n) {
          const float o = dOs[qi * S::LD + tx + 16 * n];
#pragma unroll
          for (int i = 0; i < 4; ++i) dva[i][n] += pv[i] * o;
        }
      }
      __syncthreads();  // P is read; dS takes its place
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * S::LDP + tx + 16 * j] = s[i][j];
      __syncthreads();
      for (int qi = 0; qi < BQ; ++qi) {  // dK += dS Q
        float sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = Ps[(ty * 4 + i) * S::LDP + qi];
#pragma unroll
        for (int n = 0; n < CPT; ++n) {
          const float qv = Qs[qi * S::LD + tx + 16 * n];
#pragma unroll
          for (int i = 0; i < 4; ++i) dka[i][n] += sv[i] * qv;
        }
      }
      float acc[4][CPT];  // dQ share: q rows ty*4+i, columns tx+16n
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < CPT; ++n) acc[i][n] = 0.f;
      for (int c = 0; c < kBwdBK; ++c) {
        float sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = Ps[c * S::LDP + ty * 4 + i];
#pragma unroll
        for (int n = 0; n < CPT; ++n) {
          const float kv = Ks[c * S::LD + tx + 16 * n];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][n] += sv[i] * kv;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty * 4 + i;
        if (r >= Sq) continue;
#pragma unroll
        for (int n = 0; n < CPT; ++n)
          atomicAdd(dq + q_base + r * q_ld + tx + 16 * n, scale * acc[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Skv) continue;
#pragma unroll
    for (int n = 0; n < CPT; ++n) {
      dk[kv_base + key * kv_ld + tx + 16 * n] = scale * dka[i][n];
      dv[kv_base + key * kv_ld + tx + 16 * n] = dva[i][n];
    }
  }
}

// ------------------------------------------------- bf16 wgmma + TMA backward (hd 64, 128)
//
// FlashAttention-3's backward in outline.  A work item is one (128-key
// block, KV head, b); a persistent grid (one CTA per SM) walks the items
// heaviest (earliest) key block first, in a snake order: CTA i takes item i
// of round 0, item 2G - 1 - i of round 1, ... (G CTAs), so the heavy and
// light key blocks of the causal triangle pair up across rounds.  A CTA has
// three warpgroups.
//   * Producer (warpgroup 0, one warp).  Lane 0 TMA-loads the item's K and
//     V tiles (128 keys, 128-byte swizzle) once, then streams the Q and dO
//     tiles (64 q rows) of every q block the causal mask keeps, for every q
//     head of the GQA group, through a ring of STAGES slots; the warp's 32
//     lanes copy the rows' lse and D beside them by cp.async (zeros past
//     Sq, where Q and dO are zero too).  A slot's "full" barrier takes the
//     32 lanes' copy arrivals, lane 0's arrival and the TMA bytes; its
//     "empty" one the consumers' 8 warps.
//   * Consumers (warpgroups 1 and 2), each owning 64 of the 128 keys:
//       S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, keys as M, both
//       operands K-major in shared memory),
//       P^T = exp2(S^T scale log2e - lse log2e) (masked only on a q block
//       that crosses the diagonal or Skv), packed to bf16,
//       dS^T = P^T (dP^T - D) (at hd 64 with P^T as rounded to bf16, the
//       operand dV sees; at hd 128 with the remainder below added back),
//       packed to bf16;
//     P^T and dS^T go to shared memory as [q][key] tiles (stmatrix.trans,
//     128-byte swizzle; dS in two buffers, so that a warpgroup writes the
//     next while the other still reads this one), and at hd 128 P^T's
//     rounding remainder, P^T - bf16(P^T), rounded to bf16, as a second P
//     tile; then
//       dV += P^T dO (at hd 128 from both P tiles: dV sums over the whole
//       GQA group's q rows, and a bf16 P^T alone leaves it ~2^-9 of its
//       size off, up to two bf16 ulps past its own rounding at group 16;
//       the two tiles bring that to ~2^-17; dS^T's P^T, see below) and
//       dK += dS^T Q are
//       shared-memory wgmmas with both operands MN-major (transposed), by
//       64-column chunks of dK / dV;
//       after a named barrier, dQ = scale dS K (A = dS K-major, B = K
//       MN-major) gives each warpgroup a 64 x 64 f32 tile: at hd 128 its
//       half of the columns over all 128 keys, at hd 64 all columns over
//       its own 64 keys.
//     The tile goes through shared memory to one TMA reduce-add per 32
//     columns (cp.reduce.async.bulk.tensor .add.f32) into the f32 dQ
//     buffer, which the D pass zeroed and whose tensor map clips rows past
//     Sq; no atomics per element.  dK and dV stay in f32 registers across
//     the whole group and are written once, scaled, when the item ends.
// Registers: setmaxnreg hands the producer's to the consumers (40 / 232),
// which hold dK and dV (64 + 64 at hd 128, in 32-register chunks) and one
// 32-register tile at a time: at hd 128 dP^T is issued only once P^T has
// left the registers, and P^T comes back from its tile for dS^T (with both
// tiles in flight beside dK and dV, ptxas serializes the wgmmas and
// spills).  hd 64 keeps S^T and dP^T in flight together.
// Faults to know: the ring's parities (producer waits "empty" with
// ((it / STAGES) & 1) ^ 1, consumers "full" with (it / STAGES) & 1; the K/V
// pair with the item count's parity, likewise), the full barrier's 33
// arrivals (32 cp.async ones, and lane 0's, which carries the expected
// TMA bytes), and the dQ tile, which a warpgroup rewrites only after
// its thread 0 has waited for the previous reduce to read it (before the dS
// barrier).

constexpr int kBwdWgBN = 128;      // keys per work item (2 consumers x 64)
constexpr int kBwdWgBQ = 64;       // q rows per ring slot
constexpr int kBwdWgThreads = 384; // producer + 2 consumer warpgroups

template <int HD, int STAGES>
struct BwdWgSmem {
  static constexpr int KV_BYTES = kBwdWgBN * HD * 2;        // one K or V tile
  // K / V buffers: two at hd 64, so that the next item's tiles load while
  // this one runs (a CTA takes ~8 items at zamba2's shape); one at hd 128,
  // where shared memory has no room for a second.
  static constexpr int KVB = HD == 64 ? 2 : 1;
  static constexpr int QT_BYTES = kBwdWgBQ * HD * 2;        // one Q or dO tile
  static constexpr int DS_BYTES = kBwdWgBQ * kBwdWgBN * 2;  // dS [q][key] bf16
  static constexpr int DQ_BYTES = kBwdWgBQ * 64 * 4;        // a consumer's dQ tile
  static constexpr int K = 0;
  static constexpr int V = K + KVB * KV_BYTES;              // [KVB] each
  static constexpr int Q = V + KVB * KV_BYTES;              // [STAGES]
  static constexpr int DO = Q + STAGES * QT_BYTES;          // [STAGES]
  static constexpr int DS = DO + STAGES * QT_BYTES;         // [2]
  static constexpr int PS = DS + 2 * DS_BYTES;              // P^T [q][key]
  // P^T - bf16(P^T): hd 128 only (at hd 64's four slots 96 bytes short)
  static constexpr int PL = PS + DS_BYTES;
  static constexpr int DQ = PL + (HD == 128 ? DS_BYTES : 0);  // [2 consumers]
  static constexpr int LSE = DQ + 2 * DQ_BYTES;             // [STAGES][64] f32
  static constexpr int DD = LSE + STAGES * kBwdWgBQ * 4;    // [STAGES][64] f32
  static constexpr int BARS = DD + STAGES * kBwdWgBQ * 4;
  // full / empty per slot, kv_full / kv_empty per K / V buffer; + 1024 bytes
  // so the tiles can start on the swizzle's 1024-byte period.
  static constexpr int BYTES = BARS + (2 * STAGES + 2 * KVB) * 8 + 1024;
};

// Item of round r for CTA `cta` of `grid` (the snake order above).
__device__ __forceinline__ int bwd_item(int cta, int r, int grid) {
  return r * grid + ((r & 1) ? grid - 1 - cta : cta);
}

// D (64 x 64) = A B over HD (both K-major, 128-byte swizzle; a k16 step is
// 32 bytes along a 128-byte row, 4 steps a 64-column chunk of CA or CB
// bytes), issued and committed as one group.
template <int HD, int CA, int CB>
__device__ __forceinline__ void bwd_ss_k_major(float (&d)[32], uint64_t da, uint64_t db) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    hopper::wgmma_ss_n64<0>(d, da + ((kk >> 2) * CA + (kk & 3) * 32) / 16,
                            db + ((kk >> 2) * CB + (kk & 3) * 32) / 16, kk > 0);
  hopper::wgmma_commit();
}

// A descriptor the compiler must treat as new on every call, so that the
// k-step descriptors derived from it (base + byte offset / 16) are formed
// where they are used rather than hoisted out of the loop and held in
// registers.
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// 4-byte asynchronous copy to shared memory; zeros when !in.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (the arrival counts toward the barrier's expected count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   hopper::smem_u32(bar))
               : "memory");
}

// Four 8 x 8 bf16 matrices to shared memory, transposed: lane 8 m + r names
// the address of row r of stored matrix m, and each thread's register m
// holds rows 2 (t % 4), + 1 of column t / 4 of it (an accumulator pair).
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// The inverse: four 8 x 8 bf16 matrices from shared memory, transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The dynamic shared memory, aligned to the 128-byte swizzle's 1024-byte
// period; the compiler cannot reuse a base formed before a setmaxnreg.
__device__ __forceinline__ uint8_t* bwd_wg_smem(uint8_t* raw) {
  uint32_t off = (1024 - (hopper::smem_u32(raw) & 1023)) & 1023;
  asm volatile("" : "+r"(off));
  return raw + off;
}

// What both roles of flash_bwd_wgmma_kernel derive from the shared memory
// and the shapes.
template <int HD, int STAGES>
struct BwdView {
  uint8_t* sm;
  float *lse_s, *D_s;                        // [STAGES][64] f32 each
  uint64_t *full, *empty, *kv_full, *kv_empty;
  int n_items, n_qb, B, Sq, KV, causal, q_offset;
  __device__ __forceinline__ BwdView(uint8_t* raw, int B_, int Sq_, int Skv, int KV_,
                                     int causal_, int q_offset_)
      : sm(bwd_wg_smem(raw)), B(B_), Sq(Sq_), KV(KV_), causal(causal_),
        q_offset(q_offset_) {
    using S = BwdWgSmem<HD, STAGES>;
    lse_s = reinterpret_cast<float*>(sm + S::LSE);
    D_s = reinterpret_cast<float*>(sm + S::DD);
    full = reinterpret_cast<uint64_t*>(sm + S::BARS);
    empty = full + STAGES;
    kv_full = empty + STAGES;                     // [KVB]
    kv_empty = kv_full + BwdWgSmem<HD, STAGES>::KVB;  // [KVB]
    n_items = (Skv + kBwdWgBN - 1) / kBwdWgBN * KV * B;
    n_qb = (Sq + kBwdWgBQ - 1) / kBwdWgBQ;
  }
  // Item w: key block w / (KV B) (heaviest first), KV head w % KV, b = w /
  // KV % B; the q blocks it visits start at the first one holding a row
  // below Sq that sees the block's first key (bwd_q_blocks() in
  // kernels/flash_attention/kernel.py).
  __device__ __forceinline__ void item(int w, int& k0, int& kvh, int& b,
                                       int& qb_first) const {
    k0 = w / (KV * B) * kBwdWgBN;
    kvh = w % KV;
    b = w / KV % B;
    const int first_row = causal ? max(0, k0 - q_offset) : 0;
    qb_first = first_row < Sq ? first_row / kBwdWgBQ : n_qb;
  }
};

__device__ __forceinline__ int opaque_int(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

template <int HD, int STAGES>
__global__ void __launch_bounds__(kBwdWgThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_dq,
                       const float* __restrict__ lse, const float* __restrict__ Dd,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                       int B, int Sq, int Skv, int H, int KV, int causal,
                       int q_offset, float scale, float scale_log2) {
  using S = BwdWgSmem<HD, STAGES>;
  static_assert(HD == 64 || HD == 128, "head dim 64 or 128");
  constexpr int CH = HD / 64;                 // 64-column chunks of a row
  constexpr int KV_CHUNK = kBwdWgBN * 128;    // bytes of a K / V column chunk
  constexpr int QT_CHUNK = kBwdWgBQ * 128;    // bytes of a Q / dO column chunk
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(bwd_wg_smem(smem_raw) + S::BARS);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      // full: the producer warp's 32 copy arrivals and lane 0's expect-tx
      // one; empty: one arrival per consumer warp.
      hopper::mbar_init(&bars[s], 33);
      hopper::mbar_init(&bars[STAGES + s], 8);
    }
#pragma unroll
    for (int i = 0; i < S::KVB; ++i) {
      hopper::mbar_init(&bars[2 * STAGES + i], 1);           // kv_full
      hopper::mbar_init(&bars[2 * STAGES + S::KVB + i], 8);  // kv_empty
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // The two roles each start with their setmaxnreg, and form what they use
  // after it (BwdView hides the shared-memory base from the compiler): a
  // value live across setmaxnreg is spilled by ptxas, and code after a
  // setmaxnreg that two roles share gets the launch bound's registers.
  if (threadIdx.x < 128) {
    // ------------------------------------------------------------ producer
    hopper::setmaxnreg_dec<40>();
    const BwdView<HD, STAGES> vw(smem_raw, B, Sq, Skv, KV, causal, q_offset);
    uint8_t* sm = vw.sm;
    float* lse_s = vw.lse_s;
    float* D_s = vw.D_s;
    uint64_t *full = vw.full, *empty = vw.empty, *kv_full = vw.kv_full,
             *kv_empty = vw.kv_empty;
    const int n_items = vw.n_items, n_qb = vw.n_qb, group = H / KV;
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int it = 0;  // q blocks streamed so far: ring slot it % STAGES
      for (int r = 0;; ++r) {
        const int w = bwd_item(blockIdx.x, r, gridDim.x);
        if (w >= n_items) break;
        int k0, kvh, b, qb_first;
        vw.item(w, k0, kvh, b, qb_first);
        if (lane == 0) {
          // Item r uses K / V buffer r % KVB, its (r / KVB)-th use.
          const int kb = r % S::KVB;
          hopper::mbar_wait(&kv_empty[kb], ((r / S::KVB) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&kv_full[kb], 2 * S::KV_BYTES);
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            hopper::tma_load_4d(sm + S::K + kb * S::KV_BYTES + c * KV_CHUNK, &tm_k,
                                &kv_full[kb], c * 64,
                                kvh, k0, b);
            hopper::tma_load_4d(sm + S::V + kb * S::KV_BYTES + c * KV_CHUNK, &tm_v,
                                &kv_full[kb], c * 64,
                                kvh, k0, b);
          }
        }
        for (int gi = 0; gi < group; ++gi) {
          const int h = kvh * group + gi;
          const float* lse_h = lse + ((long long)b * H + h) * Sq;
          const float* D_h = Dd + ((long long)b * H + h) * Sq;
          for (int qb = qb_first; qb < n_qb; ++qb, ++it) {
            const int s = it % STAGES, q0 = qb * kBwdWgBQ;
            hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            // The rows' lse and D by cp.async (zeros past Sq), counted on
            // the slot's barrier: no lane waits for a global load.
#pragma unroll
            for (int i = 0; i < kBwdWgBQ / 32; ++i) {
              const int rr = lane + 32 * i, q = min(q0 + rr, Sq - 1);
              cp_async4(lse_s + s * kBwdWgBQ + rr, lse_h + q, q0 + rr < Sq);
              cp_async4(D_s + s * kBwdWgBQ + rr, D_h + q, q0 + rr < Sq);
            }
            cp_async_arrive(&full[s]);
            if (lane == 0) {
              hopper::mbar_arrive_expect_tx(&full[s], 2 * S::QT_BYTES);
#pragma unroll
              for (int c = 0; c < CH; ++c) {
                hopper::tma_load_4d(sm + S::Q + s * S::QT_BYTES + c * QT_CHUNK,
                                    &tm_q, &full[s], c * 64, h, q0, b);
                hopper::tma_load_4d(sm + S::DO + s * S::QT_BYTES + c * QT_CHUNK,
                                    &tm_do, &full[s], c * 64, h, q0, b);
              }
            }
          }
        }
      }
    }
    return;
  }
  {
    // ------------------------------------------------------------ consumers
    hopper::setmaxnreg_inc<232>();
    const BwdView<HD, STAGES> vw(smem_raw, B, Sq, Skv, KV, causal, q_offset);
    uint8_t* sm = vw.sm;
    float* lse_s = vw.lse_s;
    float* D_s = vw.D_s;
    uint64_t *full = vw.full, *empty = vw.empty, *kv_full = vw.kv_full,
             *kv_empty = vw.kv_empty;
    const int n_items = vw.n_items, n_qb = vw.n_qb, group = H / KV;
    const int wg = threadIdx.x / 128;
    const int cw = wg - 1;  // this warpgroup's keys: k0 + 64 cw .. + 63
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    uint8_t* dQw = sm + S::DQ + cw * S::DQ_BYTES;
    uint8_t* Pw = sm + S::PS;
    uint8_t* PLw = sm + S::PL;
    // Named barriers: 1 = both consumers (dS at hd 128), 2 + cw = own.
    const int ds_bar = HD == 128 ? 1 : 2 + cw, ds_count = HD == 128 ? 256 : 128;
    int it = 0;
    for (int r = 0;; ++r) {
      const int w = bwd_item(blockIdx.x, r, gridDim.x);
      if (w >= n_items) break;
      int k0, kvh, b, qb_first;
      vw.item(w, k0, kvh, b, qb_first);
      const int kw0 = k0 + 64 * cw;
      // dK and dV by 64-column chunk: 32-register accumulators are what
      // ptxas can place beside the others (as 64-register ones at hd 128
      // it could not, and serialized the wgmmas and spilled).
      float dka[CH][32], dva[CH][32];
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) dka[c][i] = dva[c][i] = 0.f;
      const int kb = r % S::KVB;
      hopper::mbar_wait(&kv_full[kb], (r / S::KVB) & 1);
      // Descriptors of this warpgroup's K and V rows (K-major), and of the
      // K tile as dQ's B operand (MN-major): at hd 128 its column chunk cw
      // over all 128 keys, at hd 64 its own 64 keys.
      const uint8_t* Kb = sm + S::K + kb * S::KV_BYTES;
      const uint64_t k_desc = hopper::sw128_desc(Kb + cw * 64 * 128, 16, 1024);
      const uint64_t v_desc =
          hopper::sw128_desc(sm + S::V + kb * S::KV_BYTES + cw * 64 * 128, 16, 1024);
      const uint64_t kq_desc = hopper::sw128_desc(
          Kb + (HD == 128 ? cw * KV_CHUNK : cw * 64 * 128), KV_CHUNK, 1024);

      for (int gi = 0; gi < group; ++gi) {
        const int h = kvh * group + gi;
        for (int qb = qb_first; qb < n_qb; ++qb, ++it) {
          const int s = it % STAGES, q0 = qb * kBwdWgBQ;
          const uint8_t* Qt = sm + S::Q + s * S::QT_BYTES;
          const uint8_t* dOt = sm + S::DO + s * S::QT_BYTES;
          uint8_t* dSb = sm + S::DS + (it & 1) * S::DS_BYTES;

          // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 q each, both
          // operands K-major from shared memory.  At hd 64 both run at once;
          // at hd 128 dP^T is issued only once P^T has left the registers,
          // so that its accumulator can take S^T's: beside dK and dV (128
          // registers) the two at once leave ptxas too few registers for
          // the wgmma pipeline (it serializes the wgmmas and spills).
          float st[32], dp[32];
          const uint64_t kd = opaque(k_desc), vd = opaque(v_desc);
          const uint64_t qd_ = hopper::sw128_desc(Qt, 16, 1024);
          const uint64_t dod = hopper::sw128_desc(dOt, 16, 1024);
          hopper::mbar_wait(&full[s], (it / STAGES) & 1);
          bwd_ss_k_major<HD, KV_CHUNK, QT_CHUNK>(st, kd, qd_);
          if constexpr (HD == 64) bwd_ss_k_major<HD, KV_CHUNK, QT_CHUNK>(dp, vd, dod);
          hopper::wgmma_wait<HD == 64 ? 1 : 0>();
          hopper::fence_regs(st);

          // P^T for keys kw0 + 16 warp + g (+ 8) and q columns 8 j + 2 qd
          // (+ 1); the mask only where a pair of the tile may be dropped.
          // Rows past Sq have lse 0 (and Q, dO zero), so P^T is 1 there but
          // dP^T, dS^T and their dV share are 0.
          const float* lse_q = lse_s + s * kBwdWgBQ;
          const float* D_q = D_s + s * kBwdWgBQ;
          const bool masked = kw0 + 64 > Skv || (causal && q_offset + q0 < kw0 + 63);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(lse_q + 8 * j + 2 * qd);
            const float nl0 = -1.4426950408889634f * l2.x;
            const float nl1 = -1.4426950408889634f * l2.y;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float x = st[4 * j + e];
              if (masked) {
                const int key = kw0 + 16 * warp + g + 8 * (e >> 1);
                const int qp = q_offset + q0 + 8 * j + 2 * qd + (e & 1);
                if (key >= Skv || (causal && key > qp)) x = -INFINITY;
              }
              st[4 * j + e] = ex2(fmaf(x, scale_log2, (e & 1) ? nl1 : nl0));
            }
          }
          uint32_t pa[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              pa[kk][i] = pack_bf16(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1]);

          // P^T and then dS^T go to shared memory as [q][key] tiles by
          // stmatrix: the warp's 16 keys x 16 q of step kk are four 8 x 8
          // matrices (keys 8 (m % 2), q 8 (m / 2) + r in row r); row q of
          // chunk cw holds key 64 cw + 16 warp + 8 (m % 2) .. + 7 in its
          // 16-byte unit 2 warp + m % 2, swizzled by q % 8 = r.  One address
          // a lane, 2048 bytes (16 rows) a step.
          const int lm = opaque_int(lane >> 3), lr = lane & 7;
          const uint32_t st_off = cw * (kBwdWgBQ * 128) + (8 * (lm >> 1) + lr) * 128 +
                                  (((2 * warp + (lm & 1)) ^ lr) << 4);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            stmatrix_x4_trans(hopper::smem_u32(Pw) + st_off + kk * 2048, pa[kk]);
          if constexpr (HD == 128) {
            // The remainder P^T - bf16(P^T) into its own tile, in pa's
            // registers (P^T comes back from its tile for dS^T below).
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float h0 = __uint_as_float(pa[kk][i] << 16);  // low half
                const float h1 = __uint_as_float(pa[kk][i] & 0xffff0000u);
                pa[kk][i] = pack_bf16(st[8 * kk + 2 * i] - h0, st[8 * kk + 2 * i + 1] - h1);
              }
              stmatrix_x4_trans(hopper::smem_u32(PLw) + st_off + kk * 2048, pa[kk]);
            }
          }
          hopper::fence_async_smem();
          if constexpr (HD == 128) bwd_ss_k_major<HD, KV_CHUNK, QT_CHUNK>(dp, vd, dod);
          hopper::named_barrier(2 + cw, 128);

          // dV += P^T dO: A = P^T (MN-major: 16 q rows = 2048 bytes a step),
          // B = dO (MN-major), both from shared memory; at hd 128 the
          // remainder tile's product too.
          const uint64_t dot = hopper::sw128_desc(dOt, QT_CHUNK, 1024);
          const uint64_t qt = hopper::sw128_desc(Qt, QT_CHUNK, 1024);
#pragma unroll
          for (int c = 0; c < CH; ++c) hopper::fence_regs(dva[c]);
          hopper::wgmma_fence();
#pragma unroll
          for (int t = 0; t < (HD == 128 ? 2 : 1); ++t) {
            const uint64_t pd =
                hopper::sw128_desc((t ? PLw : Pw) + cw * (kBwdWgBQ * 128), QT_CHUNK, 1024);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int c = 0; c < CH; ++c)
                hopper::wgmma_ss_n64<1, 1>(dva[c], pd + kk * 2048 / 16,
                                           dot + (c * QT_CHUNK + kk * 2048) / 16, 1);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();  // dP^T (dV may still run)
          hopper::fence_regs(dp);

          // dS^T = P^T (dP^T - D).  At hd 128 P^T comes back from its two
          // tiles (ldmatrix, the inverse of the stmatrix above; so that it
          // does not hold registers while dP^T runs) as bf16(P^T) plus its
          // remainder: dK sums dS^T Q over the group's q rows, and with P^T
          // rounded to bf16 here dS^T's rows no longer sum to 0 as D makes
          // them, which puts dK off by up to eight of its ulps near 0.  At
          // hd 64 P^T is bf16 as dV sees it.
          uint32_t sa[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t pl[4];
            if constexpr (HD == 128) {
              ldmatrix_x4_trans(hopper::smem_u32(Pw) + st_off + kk * 2048, pa[kk]);
              ldmatrix_x4_trans(hopper::smem_u32(PLw) + st_off + kk * 2048, pl);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = 2 * kk + (i >> 1), c = 8 * kk + 2 * i;
              const float2 d2 = *reinterpret_cast<const float2*>(D_q + 8 * j + 2 * qd);
              float p0 = __uint_as_float(pa[kk][i] << 16);  // low half
              float p1 = __uint_as_float(pa[kk][i] & 0xffff0000u);
              if constexpr (HD == 128) {
                p0 += __uint_as_float(pl[i] << 16);
                p1 += __uint_as_float(pl[i] & 0xffff0000u);
              }
              sa[kk][i] = pack_bf16(p0 * (dp[c] - d2.x), p1 * (dp[c + 1] - d2.y));
            }
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            stmatrix_x4_trans(hopper::smem_u32(dSb) + st_off + kk * 2048, sa[kk]);
          hopper::fence_async_smem();
          if (tid == 0) hopper::bulk_wait_read();  // the last dQ tile is read
          hopper::named_barrier(ds_bar, ds_count);

          // dK += dS^T Q (as dV), and dQ = dS K for this warpgroup's 64 x 64
          // tile: A = dS (K-major, keys along the row), B = K (MN-major, 16
          // keys = 2048 bytes a step).
          const uint64_t sd = hopper::sw128_desc(dSb + cw * (kBwdWgBQ * 128), QT_CHUNK, 1024);
#pragma unroll
          for (int c = 0; c < CH; ++c) hopper::fence_regs(dka[c]);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int c = 0; c < CH; ++c)
              hopper::wgmma_ss_n64<1, 1>(dka[c], sd + kk * 2048 / 16,
                                         qt + (c * QT_CHUNK + kk * 2048) / 16, 1);
          hopper::wgmma_commit();
          float dq[32];
          const uint64_t dsd = hopper::sw128_desc(
              dSb + (HD == 128 ? 0 : cw * (kBwdWgBQ * 128)), 16, 1024);
          const uint64_t kqd = opaque(kq_desc);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < (HD == 128 ? 8 : 4); ++kk)
            hopper::wgmma_ss_n64<1>(
                dq, dsd + ((kk >> 2) * (kBwdWgBQ * 128) + (kk & 3) * 32) / 16,
                kqd + kk * 2048 / 16, kk > 0);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dq);
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            hopper::fence_regs(dva[c]);
            hopper::fence_regs(dka[c]);
          }
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&empty[s]);  // Q, dO, lse, D read

          // dQ (scaled) into the warpgroup's f32 tile: two chunks of 32
          // columns, 64 rows of 128 bytes, 128-byte swizzle; then one TMA
          // reduce-add per chunk.  Row 16 warp + g + 8 hi has row % 8 = g;
          // column 8 j + 2 qd sits in unit 2 (j % 4) + qd / 2 of chunk j / 4,
          // swizzled to (2 (j % 4)) ^ (qd / 2 ^ g).
          {
            const int y = opaque_int((qd >> 1) ^ g);
            uint8_t* dq_t = dQw + (16 * warp + g) * 128 + (qd & 1) * 8;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int hi = 0; hi < 2; ++hi)
                *reinterpret_cast<float2*>(dq_t + (j >> 2) * (kBwdWgBQ * 128) + hi * 1024 +
                                           (((2 * (j & 3)) ^ y) << 4)) =
                    make_float2(scale * dq[4 * j + 2 * hi], scale * dq[4 * j + 2 * hi + 1]);
          }
          hopper::fence_async_smem();
          hopper::named_barrier(4 + cw, 128);
          if (tid == 0) {
            const int col0 = HD == 128 ? 64 * cw : 0;
            hopper::tma_reduce_add_4d(&tm_dq, dQw, col0, h, q0, b);
            hopper::tma_reduce_add_4d(&tm_dq, dQw + kBwdWgBQ * 128, col0 + 32, h, q0, b);
            hopper::bulk_commit();
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&kv_empty[kb]);

      // dK (scaled) and dV, summed over the group: written once.
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int key = kw0 + 16 * warp + g + 8 * hi;
        if (key >= Skv) continue;
        const long long off = (((long long)b * Skv + key) * KV + kvh) * HD + 2 * qd;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int c = j >> 3, e = 4 * (j & 7) + 2 * hi;
          *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) = __floats2bfloat162_rn(
              scale * dka[c][e], scale * dka[c][e + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
              __floats2bfloat162_rn(dva[c][e], dva[c][e + 1]);
        }
      }
    }
    if (tid == 0) hopper::bulk_wait_all();  // the reduces are done
  }
}

template <int HD, int STAGES>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse, const float* D,
                             float* dq, void* dk, void* dv, int B, int Sq, int Skv,
                             int H, int KV, int causal, int q_offset, float scale,
                             int grid_x, int smem, cudaStream_t stream) {
  if (smem < BwdWgSmem<HD, STAGES>::BYTES) return cudaErrorInvalidValue;
  // 4-D maps over (hd, heads, S, B) with the real byte strides.
  const uint64_t row = HD * 2, q_ld = row * H, kv_ld = row * KV;
  CUtensorMap tq, tk, tv, tdo, tdq;
  const bool ok =
      make_bf16_map_4d(&tq, q, HD, H, Sq, B, row, q_ld, q_ld * Sq, kBwdWgBQ) &&
      make_bf16_map_4d(&tdo, dout, HD, H, Sq, B, row, q_ld, q_ld * Sq, kBwdWgBQ) &&
      make_bf16_map_4d(&tk, k, HD, KV, Skv, B, row, kv_ld, kv_ld * Skv, kBwdWgBN) &&
      make_bf16_map_4d(&tv, v, HD, KV, Skv, B, row, kv_ld, kv_ld * Skv, kBwdWgBN) &&
      make_f32_map_4d(&tdq, dq, HD, H, Sq, B, 2 * row, 2 * q_ld, 2 * q_ld * Sq,
                      kBwdWgBQ);
  if (!ok) return cudaErrorInvalidValue;
  auto kern = flash_bwd_wgmma_kernel<HD, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  using bf = __nv_bfloat16;
  kern<<<grid_x, kBwdWgThreads, smem, stream>>>(
      tq, tk, tv, tdo, tdq, lse, D, static_cast<bf*>(dk), static_cast<bf*>(dv), B,
      Sq, Skv, H, KV, causal, q_offset, scale, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_dot(const void* o, const void* dout, float* D, float* dq,
                           int B, int Sq, int H, int hd, cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 rows per CTA
  const long long rows = (long long)B * Sq * H;
  const unsigned grid = (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_bwd_dot_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), D, dq, rows, Sq, H,
      hd);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse, const float* D,
                           float* dq, void* dk, void* dv, int Sq, int Skv, int H,
                           int KV, int causal, int q_offset, float scale,
                           dim3 grid, int smem, cudaStream_t stream) {
  if (smem < (int)BwdMmaSmem<HD>::BYTES) return cudaErrorInvalidValue;
  auto kern = flash_bwd_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  using bf = __nv_bfloat16;
  kern<<<grid, kBwdMmaThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, D, dq,
      static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Skv, H, KV, causal,
      q_offset, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_fma(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse, const float* D,
                           float* dq, void* dk, void* dv, int Sq, int Skv, int H,
                           int KV, int causal, int q_offset, float scale,
                           dim3 grid, int smem, cudaStream_t stream) {
  if (smem < (int)BwdFmaSmem<HD>::BYTES) return cudaErrorInvalidValue;
  auto kern = flash_bwd_fma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kBwdFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, D, dq,
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv, H, KV, causal,
      q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); contiguous, 16-byte aligned.
// lse: null, or (B, H, Sq) f32 that receives each row's log-sum-exp of the
// scaled, masked scores (the backward's input; serving passes null).
// The launch plan (variant, block_q, block_kv, stages, grid, dynamic shared
// memory) is plan()'s in kernels/flash_attention/kernel.py; a plan that no
// compiled kernel matches is refused.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int Sq, int Skv,
                              int H, int KV,
                              int hd, int dtype, int causal, int q_offset,
                              float scale, int variant, int block_q,
                              int block_kv, int stages, int grid_x, int grid_y,
                              int grid_z, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y, grid_z);
  const cudaError_t bad = cudaErrorInvalidValue;
  switch (variant) {
    case kWgmma:
      if (dtype != kBF16 || block_q != kWgBQ || block_kv != kWgBN) return (int)bad;
      if (hd == 64 && stages == 4)
        return (int)launch_wgmma<64, 4>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal,
                                             q_offset, scale, grid, smem, s);
      if (hd == 128 && stages == 2)
        return (int)launch_wgmma<128, 2>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal,
                                              q_offset, scale, grid, smem, s);
      return (int)bad;
    case kMmaSync:
      if (dtype != kBF16 || block_q != kBQ || block_kv != kBK) return (int)bad;
      if (hd == 16)
        return (int)launch_mma<16>(q, k, v, o, lse, Sq, Skv, H, KV, causal, q_offset, scale, grid, smem, s);
      if (hd == 32)
        return (int)launch_mma<32>(q, k, v, o, lse, Sq, Skv, H, KV, causal, q_offset, scale, grid, smem, s);
      return (int)bad;
    case kFma:
      if (dtype != kF32 || block_q != kBQ || block_kv != kBK) return (int)bad;
      switch (hd) {
        case 16: return (int)launch_fma<16>(q, k, v, o, lse, Sq, Skv, H, KV, causal, q_offset, scale, grid, smem, s);
        case 32: return (int)launch_fma<32>(q, k, v, o, lse, Sq, Skv, H, KV, causal, q_offset, scale, grid, smem, s);
        case 64: return (int)launch_fma<64>(q, k, v, o, lse, Sq, Skv, H, KV, causal, q_offset, scale, grid, smem, s);
        case 128: return (int)launch_fma<128>(q, k, v, o, lse, Sq, Skv, H, KV, causal, q_offset, scale, grid, smem, s);
        default: return (int)bad;
      }
    case kDecode: {
      // One cluster of grid_x CTAs (a power of two, at most 16, one per
      // split of at least one 16-key chunk) per (KV head x row tile, b).
      const int rt = (H / KV + kDecRows - 1) / kDecRows;
      const int n_keys = causal && q_offset < Skv ? q_offset + 1 : Skv;
      const int chunks = (n_keys + kDecChunk - 1) / kDecChunk;
      if (dtype != kBF16 || Sq != 1 || block_q != kDecRows ||
          block_kv != kDecChunk || stages != kDecStages || grid_x < 1 ||
          grid_x > kDecMaxSplits || (grid_x & (grid_x - 1)) || grid_x > chunks ||
          grid_y != KV * rt || grid_z != B)
        return (int)bad;
      if (hd == 64)
        return (int)launch_decode<64>(q, k, v, o, lse, Skv, H, KV, n_keys, scale,
                                      grid, smem, s);
      if (hd == 128)
        return (int)launch_decode<128>(q, k, v, o, lse, Skv, H, KV, n_keys, scale,
                                       grid, smem, s);
      return (int)bad;
    }
    default:
      return (int)bad;
  }
}

// Backward of flash_attn_fwd.  q, o, dout: (B, Sq, H, hd); k, v, dk, dv:
// (B, Skv, KV, hd), contiguous, of one dtype, 16-byte aligned; lse: the
// forward's (B, H, Sq) f32; D: (B, H, Sq) f32 scratch; dq: (B, Sq, H, hd) f32
// scratch (the D pass zeroes it, the main kernel adds into it).  Two
// launches on `stream`: D = rowsum(dout * o), then the main kernel.  The
// plan (variant, block_q, stages, threads, grid, dynamic shared memory) is
// bwd_plan()'s in kernels/flash_attention/kernel.py; a plan no compiled
// kernel matches is refused.  Returns cudaGetLastError() after the launches
// (0 on success).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout, const float* lse,
                              float* D, float* dq, void* dk, void* dv, int B,
                              int Sq, int Skv, int H, int KV, int hd, int dtype,
                              int causal, int q_offset, float scale,
                              int variant, int block_q, int stages, int threads,
                              int grid_x, int grid_y, int grid_z, int smem,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t bad = cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 || q_offset < 0)
    return (int)bad;
  if (variant == kWgmma) {
    // A persistent grid over the (128-key block, KV head, b) items.
    const long long items = (long long)((Skv + kBwdWgBN - 1) / kBwdWgBN) * KV * B;
    if (dtype != kBF16 || block_q != kBwdWgBQ || threads != kBwdWgThreads ||
        grid_x < 1 || grid_x > items || grid_y != 1 || grid_z != 1 ||
        !((hd == 64 && stages == 4) || (hd == 128 && stages == 2)))
      return (int)bad;
    cudaError_t err = launch_bwd_dot<__nv_bfloat16>(o, dout, D, dq, B, Sq, H, hd, s);
    if (err != cudaSuccess) return (int)err;
    if (hd == 64 && stages == 4)
      return (int)launch_bwd_wgmma<64, 4>(q, k, v, dout, lse, D, dq, dk, dv, B, Sq,
                                          Skv, H, KV, causal, q_offset, scale,
                                          grid_x, smem, s);
    if (hd == 128 && stages == 2)
      return (int)launch_bwd_wgmma<128, 2>(q, k, v, dout, lse, D, dq, dk, dv, B, Sq,
                                           Skv, H, KV, causal, q_offset, scale,
                                           grid_x, smem, s);
    return (int)bad;
  }
  if (grid_x != (Skv + kBwdBK - 1) / kBwdBK || grid_y != KV || grid_z != B ||
      stages != 1)
    return (int)bad;
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaError_t err;
  switch (variant) {
    case kMmaSync:
      if (dtype != kBF16 || threads != kBwdMmaThreads || block_q != kBwdMmaBQ ||
          (hd != 16 && hd != 32))
        return (int)bad;
      if ((err = launch_bwd_dot<__nv_bfloat16>(o, dout, D, dq, B, Sq, H, hd, s)) !=
          cudaSuccess)
        return (int)err;
#define BWD_MMA(HD_)                                                             \
  if (hd == HD_)                                                                \
    return (int)launch_bwd_mma<HD_>(q, k, v, dout, lse, D, dq, dk, dv, Sq, Skv, \
                                    H, KV, causal, q_offset, scale, grid, smem, s);
      BWD_MMA(16)
      BWD_MMA(32)
#undef BWD_MMA
      return (int)bad;
    case kFma:
      if (dtype != kF32 || threads != kBwdFmaThreads || block_q != kBwdFmaBQ)
        return (int)bad;
      if ((err = launch_bwd_dot<float>(o, dout, D, dq, B, Sq, H, hd, s)) != cudaSuccess)
        return (int)err;
      switch (hd) {
#define BWD_FMA(HD_)                                                             \
  case HD_:                                                                     \
    return (int)launch_bwd_fma<HD_>(q, k, v, dout, lse, D, dq, dk, dv, Sq, Skv, \
                                    H, KV, causal, q_offset, scale, grid, smem, s);
        BWD_FMA(16)
        BWD_FMA(32)
        BWD_FMA(64)
        BWD_FMA(128)
#undef BWD_FMA
        default: return (int)bad;
      }
    default:
      return (int)bad;
  }
}
