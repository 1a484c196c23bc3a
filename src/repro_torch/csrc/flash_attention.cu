// Flash-attention forward for Hopper (sm_90a): online softmax, GQA, causal
// with q_offset, any Sq and Skv.
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
// it under the causal mask, against 989 TFLOP/s bf16).  Three kernels, one
// per variant; the launch plan (variant, tiles, grid, shared memory) comes
// from `plan()` in kernels/flash_attention/kernel.py, and nothing falls back
// from one variant to another:
//   * wgmma (bf16, hd 64 and 128: every serving shape).  FlashAttention-3 in
//     outline.  A persistent grid (one CTA per SM) walks the work items (128
//     q rows of one (b, h)) heaviest first.  A CTA has three warpgroups.
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

namespace {

// Variant codes passed from Python (kernels/flash_attention/kernel.py: VARIANTS).
enum Variant : int { kWgmma = 0, kMmaSync = 1, kFma = 2 };

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
                       const __grid_constant__ CUtensorMap tm_o, int B, int Sq,
                       int Skv, int H, int KV, int causal, int q_offset,
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
      // Sq; the Q tile is released once the store has read it.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float den = fmaxf(quad_sum(l[i]), 1e-30f);
        const int r = 16 * warp + g + 8 * i;
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
                         int B, int Sq, int Skv, int H, int KV, int causal,
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
  kern<<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, to, B, Sq, Skv, H, KV, causal,
                                           q_offset, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int Sq, int Skv, int H, int KV, int causal, int q_offset,
                       float scale, dim3 grid, int smem, cudaStream_t stream) {
  if (smem < (int)MmaSmem<HD>::BYTES) return cudaErrorInvalidValue;
  auto kern = flash_fwd_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq,
      Skv, H, KV, causal, q_offset, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int Sq, int Skv, int H, int KV, int causal, int q_offset,
                       float scale, dim3 grid, int smem, cudaStream_t stream) {
  if (smem < (int)Smem<HD>::BYTES) return cudaErrorInvalidValue;
  auto kern = flash_fwd_kernel<float, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, KV,
      causal, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); contiguous, 16-byte aligned.
// The launch plan (variant, block_q, block_kv, stages, grid, dynamic shared
// memory) is plan()'s in kernels/flash_attention/kernel.py; a plan that no
// compiled kernel matches is refused.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int B, int Sq, int Skv, int H, int KV,
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
        return (int)launch_wgmma<64, 4>(q, k, v, o, B, Sq, Skv, H, KV, causal,
                                             q_offset, scale, grid, smem, s);
      if (hd == 128 && stages == 2)
        return (int)launch_wgmma<128, 2>(q, k, v, o, B, Sq, Skv, H, KV, causal,
                                              q_offset, scale, grid, smem, s);
      return (int)bad;
    case kMmaSync:
      if (dtype != kBF16 || block_q != kBQ || block_kv != kBK) return (int)bad;
      if (hd == 16)
        return (int)launch_mma<16>(q, k, v, o, Sq, Skv, H, KV, causal, q_offset, scale, grid, smem, s);
      if (hd == 32)
        return (int)launch_mma<32>(q, k, v, o, Sq, Skv, H, KV, causal, q_offset, scale, grid, smem, s);
      return (int)bad;
    case kFma:
      if (dtype != kF32 || block_q != kBQ || block_kv != kBK) return (int)bad;
      switch (hd) {
        case 16: return (int)launch_fma<16>(q, k, v, o, Sq, Skv, H, KV, causal, q_offset, scale, grid, smem, s);
        case 32: return (int)launch_fma<32>(q, k, v, o, Sq, Skv, H, KV, causal, q_offset, scale, grid, smem, s);
        case 64: return (int)launch_fma<64>(q, k, v, o, Sq, Skv, H, KV, causal, q_offset, scale, grid, smem, s);
        case 128: return (int)launch_fma<128>(q, k, v, o, Sq, Skv, H, KV, causal, q_offset, scale, grid, smem, s);
        default: return (int)bad;
      }
    default:
      return (int)bad;
  }
}
