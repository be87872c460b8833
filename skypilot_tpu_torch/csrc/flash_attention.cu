// Flash attention in fp32 on the CUDA cores (sm_90a): the forward pass
// and the FlashAttention-2 backward (one kernel for dq, one for dk/dv)
// over q [B, S, H, D] and grouped k/v [B, S, Hkv, D], causal or full.
// bf16 inputs run the wgmma kernels of flash_forward_wgmma.cu and
// flash_backward_wgmma.cu; this file takes fp32 only, so fp32 stays
// exact fp32.
//
// Replaces, for fp32, the Pallas TPU kernels in
// skypilot_tpu/ops/flash_attention.py:
//   * _flash_kernel          (forward: out, and the fp32 log-normaliser
//                             L = m + log(l) per (batch, head, row))
//   * _flash_bwd_dq_kernel   (dq = scale * sum_j dS_j K_j)
//   * _flash_bwd_dkv_kernel  (dV = sum_i P_i^T dO_i, dK = scale * sum_i
//                             dS_i^T Q_i)
// with P = exp(scale * q k^T - L) and dS = P * (dO v^T - D), where
// D = rowsum(dO * O) comes in from the caller. The [S, S] scores never
// reach device memory in either direction.
//
// What bounds them: operations. At the training shapes (B 12, S 2048,
// H 16, Hkv 8, D 128, causal) the forward does 206 GFLOP against 0.6 GB
// of fp32 traffic, far above the ~20 flop/byte at which an H100's 67
// TFLOP/s of fp32 FMA rather than its memory sets the pace; the backward
// passes do 1.5x and 2x the forward's work.
//
// Design (simple and right first; PERF.md holds the measured times):
//   * Four warps per CTA; each warp owns 16 rows of the output tile and
//     keeps them in registers in the layout of the mma.m16n8 accumulator
//     fragment (lane l holds rows l/4 and l/4 + 8, columns 2(l%4) + {0,1}
//     of each 8-column subtile), filled by fp32 FMAs.
//   * Tiles are read straight from the [B, S, heads, D] strides with
//     16-byte loads (no transposes), rows past S zero-filled; rows are
//     padded by 8 elements in shared memory so fragment reads hit 32
//     distinct banks.
//   * GQA without expansion: query head h reads kv head h / G. The dk/dv
//     CTA owns one (batch, kv head, key tile) and loops over the G query
//     heads of its group and over the query tiles from the diagonal on,
//     accumulating dk/dv in registers and writing each once: the
//     reference's expand-then-sum, done in place.
//   * Online softmax as the Pallas body does it; causal tiles past the
//     diagonal are skipped, any S is handled by masking the tail (the
//     reference needs S to tile). Causal forward and dq CTAs start with
//     the longest rows.
//   * P (forward) and dS (backward) pass through shared memory between
//     the two products.
//   * Loads are not overlapped with compute inside a CTA.
//
// Plain C interface (built with nvcc, loaded with ctypes): each launcher
// returns cudaGetLastError() after its launch, or -1 for arguments it
// does not take (bf16 among them).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>


namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 16;                    // one mma m-tile per warp
constexpr int kBlockQ = kWarps * kWarpRows;      // query rows: fwd, dq CTA
constexpr int kBlockK = 64;                      // key rows per K/V tile
constexpr int kBlockKV = kWarps * kWarpRows;     // key rows: dk/dv CTA
constexpr int kBlockQB = 32;                     // query rows per dk/dv step
constexpr int kPad = 8;                          // shared row padding

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

// One warp: acc[NT][4] += A * op(B) in exact fp32, A a 16 x K row-major
// tile in shared memory (lda elements per row), output N = 8 * NT
// columns. BT: B is stored [N][K] (op(B) = B^T, k contiguous); otherwise
// B is [K][N].
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
// zero-filled. 16-byte loads: D * sizeof(float), the row stride and the
// base are multiples of 16 bytes (the wrapper checks the base).
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long row_stride, int row0,
                                          int n_rows, int seq) {
  constexpr int kVec = 16 / sizeof(float);
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

template <int D>
constexpr size_t fwd_smem() {
  return (size_t(kBlockQ + 2 * kBlockK) * (D + kPad) +
          size_t(kWarps) * kWarpRows * (kBlockK + kPad)) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int LD = D + kPad, LDP = kBlockK + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kBlockQ * LD;
  float* vs = ks + kBlockK * LD;
  const int warp = threadIdx.x >> 5;
  float* pw = vs + kBlockK * LD + warp * kWarpRows * LDP;
  const float* qw = qs + warp * kWarpRows * LD;

  const int S = p.seq, H = p.n_heads;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / p.n_kv_heads);
  const int q0 = query_tile(p) * kBlockQ;
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)p.n_kv_heads * D;
  const float* qg =
      static_cast<const float*>(p.q) + b * S * q_stride + h * D;
  const float* kg =
      static_cast<const float*>(p.k) + b * S * kv_stride + kvh * D;
  const float* vg =
      static_cast<const float*>(p.v) + b * S * kv_stride + kvh * D;
  load_rows<D>(qs, LD, qg, q_stride, q0, kBlockQ, S);

  const int row0 = q0 + warp * kWarpRows;
  float o[D / 8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int n_kt = key_tiles(p, q0);
  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    load_rows<D>(ks, LD, kg, kv_stride, k0, kBlockK, S);
    load_rows<D>(vs, LD, vg, kv_stride, k0, kBlockK, S);
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
        pw[frag_row(e) * LDP + frag_col(nt, e)] = pv;
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

  float* og = static_cast<float*>(p.out) + b * S * q_stride + h * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + frag_row(e);
      if (row < S)
        og[row * q_stride + frag_col(nt, e)] =
            o[nt][e] / fmaxf(l[e >> 1], 1e-20f);
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

template <int D>
constexpr size_t dq_smem() {
  return (size_t(2 * kBlockQ + 2 * kBlockK) * (D + kPad) +
          size_t(kWarps) * kWarpRows * (kBlockK + kPad)) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + kPad, LDP = kBlockK + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kBlockQ * LD;
  float* ks = dos + kBlockQ * LD;
  float* vs = ks + kBlockK * LD;
  const int warp = threadIdx.x >> 5;
  float* dsw = vs + kBlockK * LD + warp * kWarpRows * LDP;
  const float* qw = qs + warp * kWarpRows * LD;
  const float* dow = dos + warp * kWarpRows * LD;

  const int S = p.seq, H = p.n_heads;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / p.n_kv_heads);
  const int q0 = query_tile(p) * kBlockQ;
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)p.n_kv_heads * D;
  const long long q_off = b * S * q_stride + h * D;
  const float* kg =
      static_cast<const float*>(p.k) + b * S * kv_stride + kvh * D;
  const float* vg =
      static_cast<const float*>(p.v) + b * S * kv_stride + kvh * D;
  load_rows<D>(qs, LD, static_cast<const float*>(p.q) + q_off, q_stride, q0,
               kBlockQ, S);
  load_rows<D>(dos, LD, static_cast<const float*>(p.dout) + q_off, q_stride,
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
    load_rows<D>(ks, LD, kg, kv_stride, k0, kBlockK, S);
    load_rows<D>(vs, LD, vg, kv_stride, k0, kBlockK, S);
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
            pv * (dp[nt][e] - dsum[e >> 1]);
      }
    __syncwarp();
    warp_mma<D / 8, kBlockK, false>(acc, dsw, LDP, ks, LD);  // dS K
    __syncwarp();
  }

  float* dqg = static_cast<float*>(p.dq) + q_off;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + frag_row(e);
      if (row < S)
        dqg[row * q_stride + frag_col(nt, e)] =
            acc[nt][e] * p.scale;
    }
}

template <int D>
constexpr size_t dkv_smem() {
  return (size_t(2 * kBlockKV + 2 * kBlockQB) * (D + kPad) +
          size_t(2 * kWarps) * kWarpRows * (kBlockQB + kPad)) * sizeof(float) +
         2 * kBlockQB * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = D + kPad, LDQ = kBlockQB + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kBlockKV * LD;
  float* qs = vs + kBlockKV * LD;
  float* dos = qs + kBlockQB * LD;
  const int warp = threadIdx.x >> 5;
  float* ptw = dos + kBlockQB * LD + warp * kWarpRows * LDQ;
  float* dstw = ptw + kWarps * kWarpRows * LDQ;
  float* ls = reinterpret_cast<float*>(dos + kBlockQB * LD +
                                       2 * kWarps * kWarpRows * LDQ);
  float* dsm = ls + kBlockQB;
  const float* kw = ks + warp * kWarpRows * LD;
  const float* vw = vs + warp * kWarpRows * LD;

  const int S = p.seq, H = p.n_heads, Hkv = p.n_kv_heads, G = H / Hkv;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kBlockKV;
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)Hkv * D;
  const long long kv_off = b * S * kv_stride + kvh * D;
  load_rows<D>(ks, LD, static_cast<const float*>(p.k) + kv_off, kv_stride, k0,
               kBlockKV, S);
  load_rows<D>(vs, LD, static_cast<const float*>(p.v) + kv_off, kv_stride, k0,
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
      load_rows<D>(qs, LD, static_cast<const float*>(p.q) + q_off, q_stride,
                   q0, kBlockQB, S);
      load_rows<D>(dos, LD, static_cast<const float*>(p.dout) + q_off,
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
          ptw[at] = pv;
          dstw[at] = pv * (dpt[nt][e] - dsm[qc]);
        }
      __syncwarp();
      warp_mma<D / 8, kBlockQB, false>(dv, ptw, LDQ, dos, LD);   // P^T dO
      warp_mma<D / 8, kBlockQB, false>(dk, dstw, LDQ, qs, LD);   // dS^T Q
    }
  }

  float* dkg = static_cast<float*>(p.dk) + kv_off;
  float* dvg = static_cast<float*>(p.dv) + kv_off;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + frag_row(e);
      if (key < S) {
        const long long at = key * kv_stride + frag_col(nt, e);
        dkg[at] = dk[nt][e] * p.scale;
        dvg[at] = dv[nt][e];
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

template <int D>
int run(int pass, const Params& p, cudaStream_t s) {
  const int n_q = (p.seq + kBlockQ - 1) / kBlockQ;
  switch (pass) {
    case kForward:
      return launch(flash_fwd_kernel<D>, dim3(n_q, p.n_heads, p.batch),
                    fwd_smem<D>(), p, s);
    case kBwdDq:
      return launch(flash_bwd_dq_kernel<D>, dim3(n_q, p.n_heads, p.batch),
                    dq_smem<D>(), p, s);
    case kBwdDkv:
      return launch(flash_bwd_dkv_kernel<D>,
                    dim3((p.seq + kBlockKV - 1) / kBlockKV, p.n_kv_heads,
                         p.batch),
                    dkv_smem<D>(), p, s);
    default:
      return -1;
  }
}

// fp32 only (dtype code 0, shared with the Python wrapper).
int dispatch(int pass, int dtype, int head_dim, const Params& p,
             void* stream) {
  if (dtype != 0 || p.batch < 1 || p.batch > 65535 || p.seq < 1 ||
      p.n_kv_heads < 1 || p.n_heads > 65535 ||
      p.n_heads % p.n_kv_heads != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return run<64>(pass, p, s);
    case 128: return run<128>(pass, p, s);
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
