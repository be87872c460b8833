// Flash-decode attention for Hopper (sm_90a): S query tokens per
// sequence against a dense KV cache or a paged block pool.
//
// Replaces the Pallas TPU kernels in skypilot_tpu/ops/decode_attention.py:
//   * _decode_kernel        (dense cache  [B, max_len, Hkv, hd], S = 1)
//   * _paged_decode_kernel  (block pool   [n_blocks, block_k, Hkv, hd]
//                            read through block_tables [B, max_blocks],
//                            S = 1)
//   * _paged_verify_kernel  (the same pool, S >= 1 queries per sequence:
//                            speculative-decoding verify)
// One templated body serves all three: the paged variants only change
// which cache row a position lives in, and the verify variant widens
// each (kv head, sequence) CTA's rows from the G query heads to G * S
// (head, query) rows, row (g, i) masking by its own causal length
// lens[b] + i. A decode call is the S = 1 case with lens = cur_len; a
// verify call passes lens = start + 1, so query i attends positions
// <= start + i.
//
// What bounds it: bytes. A decode step reads every live K/V position
// once (sum_b cur_len_b * Hkv * hd * 2 * bytes/elem, plus 8 B per
// (position, kv head) of int8 scales) and does ~4 flops per byte read,
// far below the ~295 flop/byte an H100 needs before compute matters. A
// verify call does ~4 * S flops per byte: still bytes-bound at S <= 16.
//
// Design (see PERF.md for its measured time):
//   * The sequence is split across CTAs with a fixed span (flash-
//     decoding): CTA (kv head, sequence, split * chunks + chunk) walks
//     positions [split * kSpan, min((split + 1) * kSpan, longest row))
//     and writes, for each of its rows, a partial (m, l, acc[hd]) in
//     fp32 to a workspace the wrapper allocates. There are
//     ceil(capacity / kSpan) splits, capacity being the table's width
//     (max_blocks * block_k; dense: max_len), so the host never reads a
//     length; a CTA whose span starts past all its rows' lengths writes
//     empty partials (m = -1e30, l = 0, acc = 0) and exits. At most
//     kSpan / kTile tiles a CTA: the longest row no longer sets the pace
//     of a grid too small for 132 SMs.
//   * A combine kernel, enqueued by the same launcher call, reduces each
//     row's partials over the splits that start below that row's own
//     length, in split order: m = max m_s, l = sum l_s e^(m_s - m),
//     out = sum acc_s e^(m_s - m) / max(l, 1e-20), cast to q's dtype; a
//     row of length 0 reduces nothing and writes exact zeros.
//   * The order in which a row's positions are reduced is a function of
//     the position indices alone (fixed span, fixed tiles, each warp's
//     fixed share of a tile, fixed warp and split order, mma rows
//     independent of each other), never of R, S, the chunking, the grid
//     or the other rows' lengths. So a verify call's query i is
//     bit-identical to the decode kernel at cur_len = start + i + 1.
//   * The G = H / Hkv query heads of a kv head (times S queries when
//     verifying) share each K/V tile read (GQA in-kernel, query head
//     kv*G + r). Rows are cut into chunks of at most kMaxRows, each
//     chunk re-reading its span's tiles.
//   * Within its span the CTA walks kTile-position tiles only up to the
//     longest length of its rows, capped at the table's width: dead
//     positions are never read and tables[b, max_blocks] never is. In
//     paged mode the pool row of position p is
//     tables[b, p / block_k] * block_k + p % block_k, looked up only for
//     a live p. Within a tile each row masks positions past its length.
//   * Two bodies, chosen by dtype and shape alone (uses_mma), never as a
//     fallback:
//     - tensor cores (mma_body) for bf16 q over a bf16 or int8 cache at
//       head_dim % 16 == 0 (llama3-8b's serving path): K/V tiles staged
//       as bf16 in shared memory (int8 converts exactly; its per-
//       position fp32 scales sit beside the tile, K's multiplying the
//       logit, V's folded into P); the chunk's rows are one m16 tile;
//       warp w owns positions [16w, 16w + 16) of every tile with its
//       own online softmax per row: S = Q K^T on mma.sync m16n8k16 (fp32
//       accumulation), P from S's accumulator registers as the A
//       fragment, split into bf16 hi + lo so that O += P V (hd / 8
//       n-tiles, two products each) keeps ~fp32 precision; the warps
//       merge in warp order at the end of the span. The FMA chains of
//       the CUDA-core body are gone, so a tile costs about its load
//       latency (no K/V pipelining yet);
//     - CUDA cores (attention_body) otherwise (fp32 q stays exact fp32,
//       e.g. for the fp32 spec parity check): K/V tiles dequantised to
//       fp32 in shared memory (16-byte loads where rows are 16-byte
//       aligned), q in fp32; each warp owns chunk rows c = warp,
//       warp + 4, ...: lanes compute logits for positions lane + 32j,
//       reduce max/sum with shuffles, then own head-dim columns
//       d = lane + 32i of the PV update.
//     Both keep the online softmax (m, l, acc) in fp32 in the exp domain
//     of the Pallas body.
//
// Plain C interface (built with nvcc, loaded with ctypes): the launcher
// returns cudaGetLastError() after each launch, or -1 for arguments it
// does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;    // cache positions per shared-memory tile
constexpr int kSpan = 256;   // cache positions per split
constexpr int kMaxRows = 16;  // (head, query) rows per CTA
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;
static_assert(kSpan % kTile == 0, "a split holds whole tiles");

// dtype codes shared with the Python wrapper.
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

struct Params {
  const void* q;          // [B, S, H, hd]
  const void* k;          // dense [B, max_len, Hkv, hd] or pool
  const void* v;
  const float* k_scale;   // int8 only: [B, max_len, Hkv] or pool-shaped
  const float* v_scale;
  const int32_t* lens;    // [B]: row (g, i) attends positions
                          // < lens[b] + len_offset + i
  const int32_t* tables;  // paged only: [B, max_blocks]
  void* out;              // [B, S, H, hd], q's dtype
  float* part_acc;        // [B, S, H, n_splits, hd]: each split's acc
  float* part_ml;         // [B, S, H, n_splits, 2]: its (m, l)
  int batch;
  int s_q;                // queries per sequence (decode: 1)
  int len_offset;         // decode: 0 (lens = cur_len); verify: 1
                          // (lens = start)
  int n_heads;
  int n_kv_heads;
  int head_dim;
  int block_k;            // positions per cache block (dense: max_len)
  int max_blocks;         // table width (dense: 1)
  int n_pool_blocks;      // pool blocks (dense: B)
  int capacity;           // max_blocks * block_k
  int n_splits;           // ceil(capacity / kSpan)
  int chunks;             // ceil(G * S / kMaxRows)
  float scale;            // hd ** -0.5
  int vec;                // every K/V row 16-byte aligned: vector loads
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// 16 bytes of cache elements → fp32.
template <typename T>
struct Unpack;

template <>
struct Unpack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void run(const uint4& r, float* o) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
};

template <>
struct Unpack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void run(const uint4& r, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Unpack<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void run(const uint4& r, float* o) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = static_cast<float>(c[i]);
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// What CTA (kv head blockIdx.x, sequence blockIdx.y, blockIdx.z =
// split * chunks + chunk) works on. Chunk row c is row r = row0 + c of
// the (head, query) order, r = g * S + i: query head kvh * G + g of
// token i.
struct Cta {
  int kvh, b, G, S, row0, R, split, s0, base, capacity;

  __device__ explicit Cta(const Params& p) {
    kvh = blockIdx.x;
    b = blockIdx.y;
    G = p.n_heads / p.n_kv_heads;
    S = p.s_q;
    const int chunk = blockIdx.z % p.chunks;
    split = blockIdx.z / p.chunks;
    row0 = chunk * kMaxRows;
    R = min(kMaxRows, G * S - row0);
    s0 = split * kSpan;
    base = p.lens[b] + p.len_offset;
    capacity = p.capacity;
  }
  // Chunk row c attends positions < row_len(c), never past the table.
  __device__ int row_len(int c) const {
    return max(0, min(base + (row0 + c) % S, capacity));
  }
  // The longest row of the chunk: positions past it are never read.
  __device__ int longest() const {
    int cur = 0;
    for (int c = 0; c < R; ++c) cur = max(cur, row_len(c));
    return cur;
  }
  // Chunk row c's (b, i, h) index in [B, S, H].
  __device__ size_t head_row(int c, int n_heads) const {
    const int r = row0 + c;
    const int g = r / S;
    const int i = r - g * S;
    return (static_cast<size_t>(b) * S + i) * n_heads +
           static_cast<size_t>(kvh) * G + g;
  }
  // Chunk row c's partial of this split.
  __device__ size_t part(int c, const Params& p) const {
    return head_row(c, p.n_heads) * p.n_splits + split;
  }
};

// Cache row of position pos of sequence b: dense, or through the table
// (read only for a live pos).
template <bool PAGED>
__device__ __forceinline__ long long cache_row(const Params& p, int b,
                                               int pos) {
  if (PAGED) {
    const int blk =
        p.tables[static_cast<size_t>(b) * p.max_blocks + pos / p.block_k];
    if (blk < 0 || blk >= p.n_pool_blocks) __trap();
    return static_cast<long long>(blk) * p.block_k + pos % p.block_k;
  }
  return static_cast<long long>(b) * p.block_k + pos;
}

// A span that holds none of the chunk's positions: empty partials.
__device__ void write_empty(const Params& p, const Cta& cta) {
  const int hd = p.head_dim;
  for (int i = threadIdx.x; i < cta.R * hd; i += kThreads) {
    const int c = i / hd;
    p.part_acc[cta.part(c, p) * hd + (i - c * hd)] = 0.f;
  }
  for (int c = threadIdx.x; c < cta.R; c += kThreads) {
    p.part_ml[2 * cta.part(c, p)] = kNegInf;
    p.part_ml[2 * cta.part(c, p) + 1] = 0.f;
  }
}

size_t smem_bytes(int rows, int head_dim) {
  // rows[kTile] (int64) | q[R][hd] | acc[R][hd] | k[kTile][hd+1] |
  // v[kTile][hd+1] | p[kWarps][kTile] | m[R] | l[R]
  return kTile * sizeof(long long) +
         (2 * rows * head_dim + 2 * kTile * (head_dim + 1) +
          kWarps * kTile + 2 * rows) * sizeof(float);
}

// The split body of all three kernels on the CUDA cores.
template <typename TQ, typename TKV, bool PAGED>
__device__ __forceinline__ void attention_body(const Params& p) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  const Cta cta(p);
  const int R = cta.R;
  const int hd = p.head_dim;
  const int s1 = min(cta.s0 + kSpan, cta.longest());
  if (cta.s0 >= s1) {
    write_empty(p, cta);
    return;
  }
  const int ld = hd + 1;  // padded tile row: conflict-free column reads
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* rows = reinterpret_cast<long long*>(smem_raw);
  float* qs = reinterpret_cast<float*>(rows + kTile);
  float* acc = qs + R * hd;
  float* ks = acc + R * hd;
  float* vs = ks + kTile * ld;
  float* ps = vs + kTile * ld;
  float* ms = ps + kWarps * kTile;
  float* ls = ms + R;

  const TQ* q = static_cast<const TQ*>(p.q);
  for (int i = tid; i < R * hd; i += kThreads) {
    const int c = i / hd;
    qs[i] = to_f32(q[cta.head_row(c, p.n_heads) * hd + (i - c * hd)]);
    acc[i] = 0.f;
  }
  for (int c = tid; c < R; c += kThreads) {
    ms[c] = kNegInf;
    ls[c] = 0.f;
  }
  const TKV* kc = static_cast<const TKV*>(p.k);
  const TKV* vc = static_cast<const TKV*>(p.v);
  __syncthreads();

  for (int t0 = cta.s0; t0 < s1; t0 += kTile) {
    const int n = min(kTile, s1 - t0);
    // Cache row of each live position in the tile (the only table
    // reads: positions past every row's length are never looked up).
    for (int t = tid; t < n; t += kThreads)
      rows[t] = cache_row<PAGED>(p, cta.b, t0 + t);
    __syncthreads();
    // Dequantise the live K/V rows of the tile into fp32 shared memory
    // (rows t >= n are neither read nor used below). 16-byte loads when
    // every row is 16-byte aligned, element loads otherwise.
    if (p.vec) {
      constexpr int V = Unpack<TKV>::N;
      const int chunks = hd / V;
      for (int c = tid; c < n * chunks; c += kThreads) {
        const int t = c / chunks;
        const int d0 = (c - t * chunks) * V;
        const size_t hrow =
            static_cast<size_t>(rows[t]) * p.n_kv_heads + cta.kvh;
        const uint4 kraw =
            *reinterpret_cast<const uint4*>(kc + hrow * hd + d0);
        const uint4 vraw =
            *reinterpret_cast<const uint4*>(vc + hrow * hd + d0);
        float kf[V], vf[V];
        Unpack<TKV>::run(kraw, kf);
        Unpack<TKV>::run(vraw, vf);
        if (kQuant) {
          const float ksc = p.k_scale[hrow];
          const float vsc = p.v_scale[hrow];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            kf[e] *= ksc;
            vf[e] *= vsc;
          }
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
          ks[t * ld + d0 + e] = kf[e];
          vs[t * ld + d0 + e] = vf[e];
        }
      }
    } else {
      for (int i = tid; i < n * hd; i += kThreads) {
        const int t = i / hd;
        const int d = i - t * hd;
        const size_t hrow =
            static_cast<size_t>(rows[t]) * p.n_kv_heads + cta.kvh;
        float kv = to_f32(kc[hrow * hd + d]);
        float vv = to_f32(vc[hrow * hd + d]);
        if (kQuant) {
          kv *= p.k_scale[hrow];
          vv *= p.v_scale[hrow];
        }
        ks[t * ld + d] = kv;
        vs[t * ld + d] = vv;
      }
    }
    __syncthreads();

    float* pw = ps + warp * kTile;
    for (int c = warp; c < R; c += kWarps) {
      // This row's live positions in the tile. None: its m, l and acc
      // stay as they are (the update would be correction 1, p 0).
      const int nr = min(n, cta.row_len(c) - t0);
      if (nr <= 0) continue;
      const float* qg = qs + c * hd;
      float s[kTile / 32];
      float m_blk = kNegInf;
#pragma unroll
      for (int j = 0; j < kTile / 32; ++j) {
        const int t = lane + 32 * j;
        s[j] = kNegInf;   // positions t >= nr: masked, unread
        if (t < nr) {
          const float* kr = ks + t * ld;
          float dot = 0.f;
          for (int d = 0; d < hd; ++d) dot = fmaf(qg[d], kr[d], dot);
          s[j] = dot * p.scale;
        }
        m_blk = fmaxf(m_blk, s[j]);
      }
      m_blk = warp_max(m_blk);
      const float m_old = ms[c];
      const float l_old = ls[c];
      const float m_new = fmaxf(m_old, m_blk);
      const float safe_m = m_new == kNegInf ? 0.f : m_new;
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTile / 32; ++j) {
        const int t = lane + 32 * j;
        const float e = t < nr ? expf(s[j] - safe_m) : 0.f;
        pw[t] = e;
        p_sum += e;
      }
      p_sum = warp_sum(p_sum);
      const float corr = m_old == kNegInf ? 0.f : expf(m_old - safe_m);
      __syncwarp();
      float* ag = acc + c * hd;
      for (int d = lane; d < hd; d += 32) {
        float a = ag[d] * corr;
        for (int t = 0; t < nr; ++t) a = fmaf(pw[t], vs[t * ld + d], a);
        ag[d] = a;
      }
      __syncwarp();  // all lanes done with pw and m/l before reuse
      if (lane == 0) {
        ms[c] = m_new;
        ls[c] = l_old * corr + p_sum;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  for (int i = tid; i < R * hd; i += kThreads) {
    const int c = i / hd;
    p.part_acc[cta.part(c, p) * hd + (i - c * hd)] = acc[i];
  }
  for (int c = tid; c < R; c += kThreads) {
    p.part_ml[2 * cta.part(c, p)] = ms[c];
    p.part_ml[2 * cta.part(c, p) + 1] = ls[c];
  }
}

// Decode: S = 1, lens = cur_len (dense or paged).
template <typename TQ, typename TKV, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Params p) {
  attention_body<TQ, TKV, PAGED>(p);
}

// Speculative verify: S >= 1 queries, lens = start (len_offset 1), paged.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const Params p) {
  attention_body<TQ, TKV, true>(p);
}

// ------------------------------------------------ tensor-core body (bf16 q)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lane l names row l % 8 of
// matrix l / 8. trans: each thread gets the transposed pairs.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores: m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes of cache elements → bf16 in shared memory (int8 is exact).
__device__ __forceinline__ void put_bf16(__nv_bfloat16* dst, const uint4& r,
                                         __nv_bfloat16) {
  *reinterpret_cast<uint4*>(dst) = r;
}
__device__ __forceinline__ void put_bf16(__nv_bfloat16* dst, const uint4& r,
                                         int8_t) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&r);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = pack_bf16(static_cast<float>(c[2 * i]),
                     static_cast<float>(c[2 * i + 1]));
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

size_t mma_smem_bytes(int head_dim) {
  // rows[kSpan] (int64) | k scale[kSpan] | v scale[kSpan] |
  // q[kMaxRows][hd+8] | k[kTile][hd+8] | v[kTile][hd+8] (bf16) |
  // (m, l)[kWarps][kMaxRows] | weights[kMaxRows][kWarps]
  return kSpan * sizeof(long long) + 2 * kSpan * sizeof(float) +
         (kMaxRows + 2 * kTile) * (head_dim + 8) * sizeof(__nv_bfloat16) +
         3 * kWarps * kMaxRows * sizeof(float);
}

// The split body for bf16 q over bf16 or int8 K/V on the tensor cores,
// head_dim % 16 == 0, head_dim <= HD_MAX. The chunk's rows are one m16
// tile (rows past R zero). Warp w owns positions [16w, 16w + 16) of
// every tile and keeps its own online softmax (m, l, acc) for each row:
// S = Q K^T is two m16n8k16 n-tiles over hd, P (exp(S - m), times the
// position's V scale for int8) is S's accumulator reused as the A
// fragment, and O += P V runs hd / 8 n-tiles, P going in as bf16 plus
// its bf16 residual (two products), so P V keeps ~fp32 precision. K and
// V sit in shared memory as bf16 (int8 converts exactly; its K scale
// multiplies the logit). The span's cache rows and int8 scales are
// looked up once, before its tiles; each thread issues its share of a
// tile's 16-byte K/V loads kBatch at a time before storing any. At the
// end of the span the four warps' states merge in warp order into the
// row's partial.
template <typename TKV, int HD_MAX, bool PAGED>
__device__ __forceinline__ void mma_body(const Params& p) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kNT = HD_MAX / 8;
  const Cta cta(p);
  const int R = cta.R;
  const int hd = p.head_dim;
  const int s1 = min(cta.s0 + kSpan, cta.longest());
  if (cta.s0 >= s1) {
    write_empty(p, cta);
    return;
  }
  const int ld = hd + 8;  // padded bf16 row: conflict-free ldmatrix
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment rows g and g + 8
  const int t4 = lane & 3;   // fragment columns 2 t4, 2 t4 + 1
  const int pw = warp * 16;  // this warp's positions in each tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* rows = reinterpret_cast<long long*>(smem_raw);
  float* ksc = reinterpret_cast<float*>(rows + kSpan);
  float* vsc = ksc + kSpan;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(vsc + kSpan);
  __nv_bfloat16* ks = qs + kMaxRows * ld;
  __nv_bfloat16* vs = ks + kTile * ld;
  float* mls = reinterpret_cast<float*>(vs + kTile * ld);
  float* wts = mls + 2 * kWarps * kMaxRows;
  float* accs = reinterpret_cast<float*>(ks);  // after the tiles

  // q rows (zero past R) → bf16 shared memory, 16 bytes a load when q
  // is 16-byte aligned (rows are: hd % 16 == 0).
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  if (reinterpret_cast<uintptr_t>(q) % 16 == 0) {
    const int chunks = hd / 8;
    for (int i = tid; i < kMaxRows * chunks; i += kThreads) {
      const int c = i / chunks;
      const int d0 = (i - c * chunks) * 8;
      *reinterpret_cast<uint4*>(qs + c * ld + d0) =
          c < R ? *reinterpret_cast<const uint4*>(
                      q + cta.head_row(c, p.n_heads) * hd + d0)
                : make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = tid; i < kMaxRows * hd; i += kThreads) {
      const int c = i / hd;
      const int d = i - c * hd;
      qs[c * ld + d] = c < R ? q[cta.head_row(c, p.n_heads) * hd + d]
                             : __float2bfloat16(0.f);
    }
  }
  const int len[2] = {g < R ? cta.row_len(g) : 0,
                      g + 8 < R ? cta.row_len(g + 8) : 0};
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  float o[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  const TKV* kc = static_cast<const TKV*>(p.k);
  const TKV* vc = static_cast<const TKV*>(p.v);
  // Cache row (and int8 scales) of each position of the span (the only
  // table reads: positions past every row's length are never looked up).
  for (int t = tid; t < s1 - cta.s0; t += kThreads) {
    const long long row = cache_row<PAGED>(p, cta.b, cta.s0 + t);
    rows[t] = row;
    if (kQuant) {
      const size_t hrow = static_cast<size_t>(row) * p.n_kv_heads + cta.kvh;
      ksc[t] = p.k_scale[hrow];
      vsc[t] = p.v_scale[hrow];
    }
  }
  __syncthreads();

  for (int t0 = cta.s0; t0 < s1; t0 += kTile) {
    const int n = min(kTile, s1 - t0);
    const long long* trow = rows + (t0 - cta.s0);
    const float* tksc = ksc + (t0 - cta.s0);
    const float* tvsc = vsc + (t0 - cta.s0);
    // K/V rows → bf16 shared memory; positions t >= n are zero (never
    // live, and 0 * V must stay 0).
    if (p.vec) {
      constexpr int V = 16 / sizeof(TKV);
      constexpr int kBatch = 4;
      const int chunks = hd / V;
      const int total = kTile * chunks;
      for (int c0 = tid; c0 < total; c0 += kBatch * kThreads) {
        uint4 kraw[kBatch], vraw[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int c = c0 + u * kThreads;
          const int t = c / chunks;
          kraw[u] = vraw[u] = make_uint4(0, 0, 0, 0);
          if (c < total && t < n) {
            const size_t at =
                (static_cast<size_t>(trow[t]) * p.n_kv_heads + cta.kvh) *
                    hd + (c - t * chunks) * V;
            kraw[u] = *reinterpret_cast<const uint4*>(kc + at);
            vraw[u] = *reinterpret_cast<const uint4*>(vc + at);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int c = c0 + u * kThreads;
          if (c < total) {
            const int t = c / chunks;
            const int d0 = (c - t * chunks) * V;
            put_bf16(ks + t * ld + d0, kraw[u], TKV());
            put_bf16(vs + t * ld + d0, vraw[u], TKV());
          }
        }
      }
    } else {
      for (int i = tid; i < kTile * hd; i += kThreads) {
        const int t = i / hd;
        const int d = i - t * hd;
        float kv = 0.f, vv = 0.f;
        if (t < n) {
          const size_t hrow =
              static_cast<size_t>(trow[t]) * p.n_kv_heads + cta.kvh;
          kv = to_f32(kc[hrow * hd + d]);
          vv = to_f32(vc[hrow * hd + d]);
        }
        ks[t * ld + d] = __float2bfloat16(kv);
        vs[t * ld + d] = __float2bfloat16(vv);
      }
    }
    __syncthreads();

    // S = Q K^T over this warp's 16 positions: s[nt] covers positions
    // pw + 8 nt + [0, 8).
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD_MAX; kk += 16) {
      if (kk >= hd) break;
      uint32_t a[4], b[4];
      ldmatrix_x4(a, qs + (lane & 15) * ld + kk + (lane >> 4) * 8);
      ldmatrix_x4(b, ks + (pw + ((lane >> 4) << 3) + (lane & 7)) * ld +
                         kk + ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], a, b[0], b[1]);
      mma_bf16(s[1], a, b[2], b[3]);
    }
    // Logits, masked by each row's own length; the block max per row.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = pw + nt * 8 + 2 * t4 + (e & 1);
        float x = s[nt][e];
        if (kQuant) x *= t < n ? tksc[t] : 0.f;
        x *= p.scale;
        s[nt][e] = t0 + t < len[e >> 1] ? x : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float corr[2], safe[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      safe[h] = m_new == kNegInf ? 0.f : m_new;
      corr[h] = m_r[h] == kNegInf ? 0.f : expf(m_r[h] - safe[h]);
      m_r[h] = m_new;
    }
    // P = exp(S - m) for live positions, 0 elsewhere; V's int8 scale
    // folds in before P is split into bf16 hi + lo (l sums the unscaled
    // P).
    uint32_t a[4], a_lo[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = pw + nt * 8 + 2 * t4 + (e & 1);
        const int h = e >> 1;
        const bool live = t0 + t < len[h];
        const float pe = live ? expf(s[nt][e] - safe[h]) : 0.f;
        psum[h] += pe;
        pv[e] = kQuant && live ? pe * tvsc[t] : pe;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(pv[2 * h], pv[2 * h + 1]);
        const float2 back = __bfloat1622float2(hi);
        a[2 * nt + h] = *reinterpret_cast<const uint32_t*>(&hi);
        a_lo[2 * nt + h] =
            pack_bf16(pv[2 * h] - back.x, pv[2 * h + 1] - back.y);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
      l_r[h] = l_r[h] * corr[h] + psum[h];
    }
    // a (a_lo) is the m16n8k16 A fragment of P's bf16 part (residual):
    // (g, positions 0-7), (g + 8, 0-7), (g, 8-15), (g + 8, 8-15), two
    // columns a lane.
#pragma unroll
    for (int nt = 0; nt < kNT; nt += 2) {
      if (nt * 8 >= hd) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[nt][e] *= corr[e >> 1];
        o[nt + 1][e] *= corr[e >> 1];
      }
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + (pw + (lane & 15)) * ld + nt * 8 +
                               (lane >> 4) * 8);
      mma_bf16(o[nt], a, b[0], b[1]);
      mma_bf16(o[nt], a_lo, b[0], b[1]);
      mma_bf16(o[nt + 1], a, b[2], b[3]);
      mma_bf16(o[nt + 1], a_lo, b[2], b[3]);
    }
    __syncthreads();
  }

  // Merge the warps' states in warp order into each row's partial.
  if (t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mls[2 * (warp * kMaxRows + g + 8 * h)] = m_r[h];
      mls[2 * (warp * kMaxRows + g + 8 * h) + 1] = l_r[h];
    }
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    if (nt * 8 >= hd) break;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      accs[(warp * kMaxRows + g + 8 * (e >> 1)) * hd + nt * 8 + 2 * t4 +
           (e & 1)] = o[nt][e];
  }
  __syncthreads();
  if (tid < R) {
    const int c = tid;
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      m = fmaxf(m, mls[2 * (w * kMaxRows + c)]);
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(mls[2 * (w * kMaxRows + c)] - m);
      wts[c * kWarps + w] = wt;
      l = fmaf(mls[2 * (w * kMaxRows + c) + 1], wt, l);
    }
    p.part_ml[2 * cta.part(c, p)] = m;
    p.part_ml[2 * cta.part(c, p) + 1] = l;
  }
  __syncthreads();
  for (int i = tid; i < R * hd; i += kThreads) {
    const int c = i / hd;
    const int d = i - c * hd;
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w)
      acc = fmaf(accs[(w * kMaxRows + c) * hd + d], wts[c * kWarps + w],
                 acc);
    p.part_acc[cta.part(c, p) * hd + d] = acc;
  }
}

// Decode on the tensor cores (bf16 q, bf16 or int8 K/V).
template <typename TKV, int HD_MAX, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attention_mma_kernel(const Params p) {
  mma_body<TKV, HD_MAX, PAGED>(p);
}

// Speculative verify on the tensor cores.
template <typename TKV, int HD_MAX>
__global__ void __launch_bounds__(kThreads)
paged_verify_mma_kernel(const Params p) {
  mma_body<TKV, HD_MAX, true>(p);
}

// One warp per (b, i, h) row: the row's partials over the splits that
// start below its length, merged in split order, normalised and cast.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
combine_partials_kernel(const Params p) {
  constexpr int kCols = kMaxHeadDim / 32;
  const int lane = threadIdx.x & 31;
  const size_t row =
      static_cast<size_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= static_cast<size_t>(p.batch) * p.s_q * p.n_heads) return;
  const int hd = p.head_dim;
  const size_t bi = row / p.n_heads;
  const int i = static_cast<int>(bi % p.s_q);
  const int b = static_cast<int>(bi / p.s_q);
  const int len =
      max(0, min(p.lens[b] + p.len_offset + i, p.capacity));
  const int n_live = (len + kSpan - 1) / kSpan;
  const float* ml = p.part_ml + row * p.n_splits * 2;
  const float* pa = p.part_acc + row * p.n_splits * hd;
  float m = kNegInf;
#pragma unroll 4
  for (int s = 0; s < n_live; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_live; ++s) {
    const float w = expf(ml[2 * s] - m);
    l = fmaf(ml[2 * s + 1], w, l);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) acc[j] = fmaf(pa[s * hd + d], w, acc[j]);
    }
  }
  TQ* out = static_cast<TQ*>(p.out) + row * hd;
  const float denom = fmaxf(l, 1e-20f);
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int d = lane + 32 * j;
    if (d < hd) store(out + d, acc[j] / denom);
  }
}

template <typename TQ>
int launch_combine(const Params& p, cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(p.batch) * p.s_q * p.n_heads;
  const unsigned grid = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  combine_partials_kernel<TQ><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// mode: 0 dense decode, 1 paged decode, 2 paged verify.
template <typename TQ, typename TKV>
int launch(const Params& p, int mode, cudaStream_t stream) {
  const int rows = p.n_heads / p.n_kv_heads * p.s_q;
  const size_t smem = smem_bytes(rows < kMaxRows ? rows : kMaxRows,
                                 p.head_dim);
  void (*kernel)(const Params) =
      mode == 2   ? paged_verify_kernel<TQ, TKV>
      : mode == 1 ? decode_attention_kernel<TQ, TKV, true>
                  : decode_attention_kernel<TQ, TKV, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.n_kv_heads, p.batch, p.chunks * p.n_splits);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_combine<TQ>(p, stream);
}

template <typename TQ>
int dispatch_kv(const Params& p, int kv_dtype, int mode, cudaStream_t s) {
  switch (kv_dtype) {
    case kF32: return launch<TQ, float>(p, mode, s);
    case kBF16: return launch<TQ, __nv_bfloat16>(p, mode, s);
    case kI8: return launch<TQ, int8_t>(p, mode, s);
    default: return -1;
  }
}

template <typename TKV, int HD_MAX>
int launch_mma(const Params& p, int mode, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(p.head_dim);
  void (*kernel)(const Params) =
      mode == 2   ? paged_verify_mma_kernel<TKV, HD_MAX>
      : mode == 1 ? decode_attention_mma_kernel<TKV, HD_MAX, true>
                  : decode_attention_mma_kernel<TKV, HD_MAX, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.n_kv_heads, p.batch, p.chunks * p.n_splits);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_combine<__nv_bfloat16>(p, stream);
}

template <typename TKV>
int dispatch_mma(const Params& p, int mode, cudaStream_t s) {
  if (p.head_dim <= 64) return launch_mma<TKV, 64>(p, mode, s);
  if (p.head_dim <= 128) return launch_mma<TKV, 128>(p, mode, s);
  return launch_mma<TKV, 256>(p, mode, s);
}

// Which body a call runs, by dtype and shape alone: the tensor cores for
// bf16 q over bf16 or int8 K/V at head_dim % 16 == 0, the CUDA cores
// otherwise (fp32 q stays exact fp32).
bool uses_mma(int q_dtype, int kv_dtype, int head_dim) {
  return q_dtype == kBF16 && (kv_dtype == kBF16 || kv_dtype == kI8) &&
         head_dim % 16 == 0;
}

}  // namespace

// Positions per split: the wrapper sizes the workspace with it.
extern "C" int skytorch_decode_attention_span() { return kSpan; }

// 1 when a call with these dtypes and head_dim runs the tensor-core
// body, 0 when it runs the CUDA-core one.
extern "C" int skytorch_decode_attention_uses_mma(int q_dtype,
                                                  int kv_dtype,
                                                  int head_dim) {
  return uses_mma(q_dtype, kv_dtype, head_dim) ? 1 : 0;
}

// tables == nullptr selects the dense cache (block_k = max_len,
// max_blocks = 1, n_pool_blocks = batch); otherwise the paged pool.
// verify != 0 (paged only) runs the verify kernel: lens holds each
// sequence's first query position, and query i attends positions
// <= lens[b] + i. Otherwise s_q must be 1 and lens holds cur_len.
// part_acc [B, S, H, n_splits, hd] and part_ml [B, S, H, n_splits, 2]
// (fp32, n_splits = ceil(max_blocks * block_k / span)) are the
// workspace of the split partials.
extern "C" int skytorch_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lens, const void* tables,
    void* out, void* part_acc, void* part_ml, int q_dtype, int kv_dtype,
    int batch, int s_q, int n_heads, int n_kv_heads, int head_dim,
    int block_k, int max_blocks, int n_pool_blocks, int n_splits,
    int verify, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || s_q < 1 || n_kv_heads < 1 ||
      n_heads % n_kv_heads != 0 || head_dim < 1 ||
      head_dim > kMaxHeadDim || block_k < 1 || max_blocks < 1 ||
      (verify ? tables == nullptr : s_q != 1) ||
      (kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr) ||
      part_acc == nullptr || part_ml == nullptr)
    return -1;
  const long long capacity = static_cast<long long>(max_blocks) * block_k;
  const int chunks = (n_heads / n_kv_heads * s_q + kMaxRows - 1) / kMaxRows;
  if (capacity > (1LL << 30) || n_splits != (capacity + kSpan - 1) / kSpan ||
      static_cast<long long>(chunks) * n_splits > 65535)
    return -1;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lens = static_cast<const int32_t*>(lens);
  p.tables = static_cast<const int32_t*>(tables);
  p.out = out;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.batch = batch;
  p.s_q = s_q;
  p.len_offset = verify ? 1 : 0;
  p.n_heads = n_heads;
  p.n_kv_heads = n_kv_heads;
  p.head_dim = head_dim;
  p.block_k = block_k;
  p.max_blocks = max_blocks;
  p.n_pool_blocks = n_pool_blocks;
  p.capacity = static_cast<int>(capacity);
  p.n_splits = n_splits;
  p.chunks = chunks;
  p.scale = scale;
  const int elem_bytes = kv_dtype == kF32 ? 4 : kv_dtype == kBF16 ? 2 : 1;
  p.vec = (head_dim * elem_bytes) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int mode = verify ? 2 : tables != nullptr ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uses_mma(q_dtype, kv_dtype, head_dim))
    return kv_dtype == kBF16 ? dispatch_mma<__nv_bfloat16>(p, mode, s)
                             : dispatch_mma<int8_t>(p, mode, s);
  switch (q_dtype) {
    case kF32: return dispatch_kv<float>(p, kv_dtype, mode, s);
    case kBF16: return dispatch_kv<__nv_bfloat16>(p, kv_dtype, mode, s);
    default: return -1;
  }
}
