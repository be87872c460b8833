// Flash attention for Hopper (sm_90a): the fp32 forward pass and the
// FlashAttention-2 backward (one kernel for dq, one for dk/dv) over
// q [B, S, H, D] and grouped k/v [B, S, Hkv, D], causal or full. The
// bf16 forward is the wgmma kernel of flash_forward_wgmma.cu.
//
// Replaces the Pallas TPU kernels in skypilot_tpu/ops/flash_attention.py:
//   * _flash_kernel          (forward, fp32 here: out, and the fp32
//                             log-normaliser L = m + log(l) per
//                             (batch, head, row))
//   * _flash_bwd_dq_kernel   (dq = scale * sum_j dS_j K_j)
//   * _flash_bwd_dkv_kernel  (dV = sum_i P_i^T dO_i, dK = scale * sum_i
//                             dS_i^T Q_i)
// with P = exp(scale * q k^T - L) and dS = P * (dO v^T - D), where
// D = rowsum(dO * O) comes in from the caller. The [S, S] scores never
// reach device memory in either direction.
//
// What bounds them: operations. At the training shapes (B 12, S 2048,
// H 16, Hkv 8, D 128, causal) the forward does 206 GFLOP against 0.3 GB
// of traffic, ~700 flop/byte, above the ~295 at which an H100's bf16
// tensor cores rather than its memory set the pace; the backward passes
// do 1.5x and 2x the forward's work on about twice its bytes.
//
// Design (simple and right first; PERF.md holds the measured times):
//   * Four warps per CTA; each warp owns 16 rows of the output tile and
//     keeps them in registers in the layout of the mma.m16n8 accumulator
//     fragment (lane l holds rows l/4 and l/4 + 8, columns 2(l%4) + {0,1}
//     of each 8-column subtile). For bf16 inputs the products run on the
//     tensor cores (mma.sync m16n8k16, fp32 accumulation), operands read
//     from shared memory; for fp32 inputs the same fragment layout is
//     filled by fp32 FMAs on the CUDA cores, so fp32 stays exact fp32 and
//     one kernel body serves both types.
//   * Tiles are read straight from the [B, S, heads, D] strides with
//     16-byte loads (no transposes), rows past S zero-filled; rows are
//     padded by 8 elements in shared memory so fragment reads hit 32
//     distinct banks.
//   * GQA without expansion: query head h reads kv head h / G. The dk/dv
//     CTA owns one (batch, kv head, key tile) and loops over the G query
//     heads of its group and over the query tiles from the diagonal on,
//     accumulating dk/dv in registers and writing each once in the input
//     dtype: the reference's expand-then-sum, done in place.
//   * Online softmax in fp32 as the Pallas body does it; causal tiles
//     past the diagonal are skipped, any S is handled by masking the
//     tail (the reference needs S to tile). Causal forward and dq CTAs
//     start with the longest rows.
//   * P (forward) and dS (backward) pass through shared memory in the
//     input dtype between the two products: bf16 for bf16 inputs, as the
//     FlashAttention-2 backward does, exact for fp32.
//   * Loads are not overlapped with compute inside a CTA (no cp.async or
//     TMA pipeline) and B fragments of [K][N] operands are gathered with
//     16-bit shared loads (no ldmatrix): the next steps for speed.
//
// Plain C interface (built with nvcc, loaded with ctypes): each launcher
// returns cudaGetLastError() after its launch, or -1 for arguments it
// does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 16;                    // one mma m-tile per warp
constexpr int kBlockQ = kWarps * kWarpRows;      // query rows: fwd, dq CTA
constexpr int kBlockK = 64;                      // key rows per K/V tile
constexpr int kBlockKV = kWarps * kWarpRows;     // key rows: dk/dv CTA
constexpr int kBlockQB = 32;                     // query rows per dk/dv step
constexpr int kPad = 8;                          // shared row padding

// dtype codes shared with the Python wrapper.
enum DType : int { kF32 = 0, kBF16 = 1 };

struct Params {
  const void* q;       // [B, S, H, D]
  const void* k;       // [B, S, Hkv, D]
  const void* v;       // [B, S, Hkv, D]
  const void* dout;    // [B, S, H, D]      backward only
  void* out;           // [B, S, H, D]      forward only
  float* lse;          // [B, H, S] fp32    forward writes, backward reads
  const float* dsum;   // [B, H, S] fp32    backward only
  void* dq;            // [B, S, H, D]
  void* dk;            // [B, S, Hkv, D]
  void* dv;            // [B, S, Hkv, D]
  int batch;
  int seq;
  int n_heads;
  int n_kv_heads;
  int causal;
  float scale;         // D ** -0.5
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One warp: acc[NT][4] += A * op(B), A a 16 x K row-major tile in shared
// memory (lda elements per row), output N = 8 * NT columns. BT: B is
// stored [N][K] (op(B) = B^T, k contiguous); otherwise B is [K][N].
template <int NT, int K, bool BT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4],
                                         const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    const __nv_bfloat16* a_lo = a + g * lda + kk + 2 * t;
    const __nv_bfloat16* a_hi = a_lo + 8 * lda;
    const uint32_t a0 = ld_pair(a_lo), a1 = ld_pair(a_hi);
    const uint32_t a2 = ld_pair(a_lo + 8), a3 = ld_pair(a_hi + 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + g;
      uint32_t b0, b1;
      if (BT) {
        const __nv_bfloat16* bp = b + n * ldb + kk + 2 * t;
        b0 = ld_pair(bp);
        b1 = ld_pair(bp + 8);
      } else {
        const __nv_bfloat16* bp = b + (kk + 2 * t) * ldb + n;
        b0 = pack(bp[0], bp[ldb]);
        b1 = pack(bp[8 * ldb], bp[9 * ldb]);
      }
      mma_bf16(acc[nt], a0, a1, a2, a3, b0, b1);
    }
  }
}

// fp32 operands: the same product and accumulator layout on the CUDA
// cores, in exact fp32.
template <int NT, int K, bool BT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* a,
                                         int lda, const float* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    const float a_lo = a[g * lda + kk];
    const float a_hi = a[(g + 8) * lda + kk];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * t;
      const float b0 = BT ? b[n * ldb + kk] : b[kk * ldb + n];
      const float b1 = BT ? b[(n + 1) * ldb + kk] : b[kk * ldb + n + 1];
      acc[nt][0] = fmaf(a_lo, b0, acc[nt][0]);
      acc[nt][1] = fmaf(a_lo, b1, acc[nt][1]);
      acc[nt][2] = fmaf(a_hi, b0, acc[nt][2]);
      acc[nt][3] = fmaf(a_hi, b1, acc[nt][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// Fragment element (nt, e) of a warp's tile: row offset and column.
__device__ __forceinline__ int frag_row(int e) {
  return ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int nt, int e) {
  return nt * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

// Rows [row0, row0 + n_rows) of one head's [S, D] slice (row_stride
// elements between rows) → shared [n_rows][ld]; rows at or past S are
// zero-filled. 16-byte loads: D * sizeof(T), the row stride and the
// base are multiples of 16 bytes (the wrapper checks the base).
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int n_rows, int seq) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int i = threadIdx.x; i < n_rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride +
                                            c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Max and sum over the four lanes that share a fragment row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Key tiles a query tile [q0, q0 + kBlockQ) visits.
__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  const int end = p.causal ? min(p.seq, q0 + kBlockQ) : p.seq;
  return (end + kBlockK - 1) / kBlockK;
}

// Causal CTAs with the most key tiles go first.
__device__ __forceinline__ int query_tile(const Params& p) {
  return p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
}

template <typename T, int D>
constexpr size_t fwd_smem() {
  return (size_t(kBlockQ + 2 * kBlockK) * (D + kPad) +
          size_t(kWarps) * kWarpRows * (kBlockK + kPad)) * sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int LD = D + kPad, LDP = kBlockK + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBlockQ * LD;
  T* vs = ks + kBlockK * LD;
  const int warp = threadIdx.x >> 5;
  T* pw = vs + kBlockK * LD + warp * kWarpRows * LDP;
  const T* qw = qs + warp * kWarpRows * LD;

  const int S = p.seq, H = p.n_heads;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / p.n_kv_heads);
  const int q0 = query_tile(p) * kBlockQ;
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)p.n_kv_heads * D;
  const T* qg = static_cast<const T*>(p.q) + b * S * q_stride + h * D;
  const T* kg = static_cast<const T*>(p.k) + b * S * kv_stride + kvh * D;
  const T* vg = static_cast<const T*>(p.v) + b * S * kv_stride + kvh * D;
  load_rows<T, D>(qs, LD, qg, q_stride, q0, kBlockQ, S);

  const int row0 = q0 + warp * kWarpRows;
  float o[D / 8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int n_kt = key_tiles(p, q0);
  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D>(ks, LD, kg, kv_stride, k0, kBlockK, S);
    load_rows<T, D>(vs, LD, vg, kv_stride, k0, kBlockK, S);
    __syncthreads();

    float s[kBlockK / 8][4];
    zero(s);
    warp_mma<kBlockK / 8, D, true>(s, qw, LD, ks, LD);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + frag_row(e), col = k0 + frag_col(nt, e);
        float x = s[nt][e] * p.scale;
        if (col >= S || (p.causal && col > row)) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = m_new[i] == -INFINITY ? 0.f : expf(m[i] - m_new[i]);
    }
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e];
        const float pv = x == -INFINITY ? 0.f : expf(x - m_new[e >> 1]);
        sum[e >> 1] += pv;
        pw[frag_row(e) * LDP + frag_col(nt, e)] = from_f32<T>(pv);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * corr[i] + quad_sum(sum[i]);
      m[i] = m_new[i];
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e >> 1];
    __syncwarp();
    warp_mma<D / 8, kBlockK, false>(o, pw, LDP, vs, LD);
    __syncwarp();  // P is rewritten by the next tile
  }

  T* og = static_cast<T*>(p.out) + b * S * q_stride + h * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + frag_row(e);
      if (row < S)
        og[row * q_stride + frag_col(nt, e)] =
            from_f32<T>(o[nt][e] / fmaxf(l[e >> 1], 1e-20f));
    }
  if ((threadIdx.x & 3) == 0) {
    float* lse = p.lse + ((long long)b * H + h) * S;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + frag_row(2 * i);
      if (row < S) lse[row] = m[i] + logf(fmaxf(l[i], 1e-20f));
    }
  }
}

template <typename T, int D>
constexpr size_t dq_smem() {
  return (size_t(2 * kBlockQ + 2 * kBlockK) * (D + kPad) +
          size_t(kWarps) * kWarpRows * (kBlockK + kPad)) * sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + kPad, LDP = kBlockK + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kBlockQ * LD;
  T* ks = dos + kBlockQ * LD;
  T* vs = ks + kBlockK * LD;
  const int warp = threadIdx.x >> 5;
  T* dsw = vs + kBlockK * LD + warp * kWarpRows * LDP;
  const T* qw = qs + warp * kWarpRows * LD;
  const T* dow = dos + warp * kWarpRows * LD;

  const int S = p.seq, H = p.n_heads;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / p.n_kv_heads);
  const int q0 = query_tile(p) * kBlockQ;
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)p.n_kv_heads * D;
  const long long q_off = b * S * q_stride + h * D;
  const T* kg = static_cast<const T*>(p.k) + b * S * kv_stride + kvh * D;
  const T* vg = static_cast<const T*>(p.v) + b * S * kv_stride + kvh * D;
  load_rows<T, D>(qs, LD, static_cast<const T*>(p.q) + q_off, q_stride, q0,
                  kBlockQ, S);
  load_rows<T, D>(dos, LD, static_cast<const T*>(p.dout) + q_off, q_stride,
                  q0, kBlockQ, S);

  const int row0 = q0 + warp * kWarpRows;
  const long long row_vec = ((long long)b * H + h) * S;
  float lse[2], dsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + frag_row(2 * i);
    lse[i] = row < S ? p.lse[row_vec + row] : 0.f;
    dsum[i] = row < S ? p.dsum[row_vec + row] : 0.f;
  }
  float acc[D / 8][4];
  zero(acc);
  const int n_kt = key_tiles(p, q0);
  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();
    load_rows<T, D>(ks, LD, kg, kv_stride, k0, kBlockK, S);
    load_rows<T, D>(vs, LD, vg, kv_stride, k0, kBlockK, S);
    __syncthreads();

    float s[kBlockK / 8][4], dp[kBlockK / 8][4];
    zero(s);
    zero(dp);
    warp_mma<kBlockK / 8, D, true>(s, qw, LD, ks, LD);    // Q K^T
    warp_mma<kBlockK / 8, D, true>(dp, dow, LD, vs, LD);  // dO V^T
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + frag_row(e), col = k0 + frag_col(nt, e);
        const bool live = row < S && col < S && !(p.causal && col > row);
        const float pv =
            live ? expf(s[nt][e] * p.scale - lse[e >> 1]) : 0.f;
        dsw[frag_row(e) * LDP + frag_col(nt, e)] =
            from_f32<T>(pv * (dp[nt][e] - dsum[e >> 1]));
      }
    __syncwarp();
    warp_mma<D / 8, kBlockK, false>(acc, dsw, LDP, ks, LD);  // dS K
    __syncwarp();
  }

  T* dqg = static_cast<T*>(p.dq) + q_off;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + frag_row(e);
      if (row < S)
        dqg[row * q_stride + frag_col(nt, e)] =
            from_f32<T>(acc[nt][e] * p.scale);
    }
}

template <typename T, int D>
constexpr size_t dkv_smem() {
  return (size_t(2 * kBlockKV + 2 * kBlockQB) * (D + kPad) +
          size_t(2 * kWarps) * kWarpRows * (kBlockQB + kPad)) * sizeof(T) +
         2 * kBlockQB * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = D + kPad, LDQ = kBlockQB + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kBlockKV * LD;
  T* qs = vs + kBlockKV * LD;
  T* dos = qs + kBlockQB * LD;
  const int warp = threadIdx.x >> 5;
  T* ptw = dos + kBlockQB * LD + warp * kWarpRows * LDQ;
  T* dstw = ptw + kWarps * kWarpRows * LDQ;
  float* ls = reinterpret_cast<float*>(dos + kBlockQB * LD +
                                       2 * kWarps * kWarpRows * LDQ);
  float* dsm = ls + kBlockQB;
  const T* kw = ks + warp * kWarpRows * LD;
  const T* vw = vs + warp * kWarpRows * LD;

  const int S = p.seq, H = p.n_heads, Hkv = p.n_kv_heads, G = H / Hkv;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kBlockKV;
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)Hkv * D;
  const long long kv_off = b * S * kv_stride + kvh * D;
  load_rows<T, D>(ks, LD, static_cast<const T*>(p.k) + kv_off, kv_stride, k0,
                  kBlockKV, S);
  load_rows<T, D>(vs, LD, static_cast<const T*>(p.v) + kv_off, kv_stride, k0,
                  kBlockKV, S);

  const int key0 = k0 + warp * kWarpRows;
  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  const int n_qt = (S + kBlockQB - 1) / kBlockQB;
  // Query tiles wholly above the diagonal see none of these keys.
  const int i0 = p.causal ? k0 / kBlockQB : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const long long q_off = b * S * q_stride + h * D;
    const long long row_vec = ((long long)b * H + h) * S;
    for (int i = i0; i < n_qt; ++i) {
      const int q0 = i * kBlockQB;
      __syncthreads();
      load_rows<T, D>(qs, LD, static_cast<const T*>(p.q) + q_off, q_stride,
                      q0, kBlockQB, S);
      load_rows<T, D>(dos, LD, static_cast<const T*>(p.dout) + q_off,
                      q_stride, q0, kBlockQB, S);
      if (threadIdx.x < kBlockQB) {
        const int q = q0 + threadIdx.x;
        ls[threadIdx.x] = q < S ? p.lse[row_vec + q] : 0.f;
        dsm[threadIdx.x] = q < S ? p.dsum[row_vec + q] : 0.f;
      }
      __syncthreads();

      float st[kBlockQB / 8][4], dpt[kBlockQB / 8][4];
      zero(st);
      zero(dpt);
      warp_mma<kBlockQB / 8, D, true>(st, kw, LD, qs, LD);    // K Q^T
      warp_mma<kBlockQB / 8, D, true>(dpt, vw, LD, dos, LD);  // V dO^T
#pragma unroll
      for (int nt = 0; nt < kBlockQB / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + frag_row(e), qc = frag_col(nt, e);
          const int q = q0 + qc;
          const bool live = q < S && !(p.causal && key > q);
          const float pv = live ? expf(st[nt][e] * p.scale - ls[qc]) : 0.f;
          const int at = frag_row(e) * LDQ + qc;
          ptw[at] = from_f32<T>(pv);
          dstw[at] = from_f32<T>(pv * (dpt[nt][e] - dsm[qc]));
        }
      __syncwarp();
      warp_mma<D / 8, kBlockQB, false>(dv, ptw, LDQ, dos, LD);   // P^T dO
      warp_mma<D / 8, kBlockQB, false>(dk, dstw, LDQ, qs, LD);   // dS^T Q
    }
  }

  T* dkg = static_cast<T*>(p.dk) + kv_off;
  T* dvg = static_cast<T*>(p.dv) + kv_off;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + frag_row(e);
      if (key < S) {
        const long long at = key * kv_stride + frag_col(nt, e);
        dkg[at] = from_f32<T>(dk[nt][e] * p.scale);
        dvg[at] = from_f32<T>(dv[nt][e]);
      }
    }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const Params& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

enum Pass : int { kForward = 0, kBwdDq = 1, kBwdDkv = 2 };

template <typename T, int D>
int run(int pass, const Params& p, cudaStream_t s) {
  const int n_q = (p.seq + kBlockQ - 1) / kBlockQ;
  switch (pass) {
    case kForward:
      // bf16 runs the wgmma kernel of flash_forward_wgmma.cu.
      if constexpr (std::is_same<T, float>::value)
        return launch(flash_fwd_kernel<T, D>,
                      dim3(n_q, p.n_heads, p.batch), fwd_smem<T, D>(), p,
                      s);
      else
        return -1;
    case kBwdDq:
      return launch(flash_bwd_dq_kernel<T, D>,
                    dim3(n_q, p.n_heads, p.batch), dq_smem<T, D>(), p, s);
    case kBwdDkv:
      return launch(flash_bwd_dkv_kernel<T, D>,
                    dim3((p.seq + kBlockKV - 1) / kBlockKV, p.n_kv_heads,
                         p.batch),
                    dkv_smem<T, D>(), p, s);
    default:
      return -1;
  }
}

template <typename T>
int run_head_dim(int pass, int head_dim, const Params& p, cudaStream_t s) {
  switch (head_dim) {
    case 64: return run<T, 64>(pass, p, s);
    case 128: return run<T, 128>(pass, p, s);
    default: return -1;
  }
}

int dispatch(int pass, int dtype, int head_dim, const Params& p,
             void* stream) {
  if (p.batch < 1 || p.batch > 65535 || p.seq < 1 || p.n_kv_heads < 1 ||
      p.n_heads > 65535 || p.n_heads % p.n_kv_heads != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return run_head_dim<float>(pass, head_dim, p, s);
    case kBF16: return run_head_dim<__nv_bfloat16>(pass, head_dim, p, s);
    default: return -1;
  }
}

Params make_params(const void* q, const void* k, const void* v, int batch,
                   int seq, int n_heads, int n_kv_heads, int causal,
                   float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.batch = batch;
  p.seq = seq;
  p.n_heads = n_heads;
  p.n_kv_heads = n_kv_heads;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" int skytorch_flash_forward(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int dtype, int batch, int seq,
                                      int n_heads, int n_kv_heads,
                                      int head_dim, int causal, float scale,
                                      void* stream) {
  Params p = make_params(q, k, v, batch, seq, n_heads, n_kv_heads, causal,
                         scale);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  return dispatch(kForward, dtype, head_dim, p, stream);
}

extern "C" int skytorch_flash_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* dsum,
                                     void* dq, int dtype, int batch, int seq,
                                     int n_heads, int n_kv_heads,
                                     int head_dim, int causal, float scale,
                                     void* stream) {
  Params p = make_params(q, k, v, batch, seq, n_heads, n_kv_heads, causal,
                         scale);
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.dsum = static_cast<const float*>(dsum);
  p.dq = dq;
  return dispatch(kBwdDq, dtype, head_dim, p, stream);
}

extern "C" int skytorch_flash_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dsum,
                                      void* dk, void* dv, int dtype,
                                      int batch, int seq, int n_heads,
                                      int n_kv_heads, int head_dim,
                                      int causal, float scale,
                                      void* stream) {
  Params p = make_params(q, k, v, batch, seq, n_heads, n_kv_heads, causal,
                         scale);
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.dsum = static_cast<const float*>(dsum);
  p.dk = dk;
  p.dv = dv;
  return dispatch(kBwdDkv, dtype, head_dim, p, stream);
}
