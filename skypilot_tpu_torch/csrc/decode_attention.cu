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
// Design (simple and right first; see PERF.md for its measured time):
//   * One CTA per (kv head, batch row, row chunk). The G = H / Hkv query
//     heads of that kv head (times S queries when verifying) share each
//     K/V tile read (GQA in-kernel, query head kv*G + r), so the cache is
//     read once per chunk, not once per head.
//   * Rows are cut into chunks of at most kMaxRows (the grid's third
//     axis), each chunk re-reading that kv head's live tiles: G * S rows
//     exceed what one CTA holds at spec_k >= 4 (G = 4: 20 rows at S = 5),
//     and the extra CTAs fill more of the 132 SMs.
//   * The CTA walks kTile-position tiles only up to the longest length
//     of its rows, capped at the table's width (max_blocks * block_k):
//     dead positions are never read and tables[b, max_blocks] never is,
//     which is what the TPU kernel's clamped index map achieves. In paged
//     mode the pool row of position p is
//     tables[b, p / block_k] * block_k + p % block_k, looked up only for
//     a live p.
//   * A row skips a tile that holds none of its positions, and within a
//     tile masks positions past its length: its m, l and acc are then
//     what a decode call at that length leaves (the reduction order per
//     row does not depend on the other rows), so a verify call's query
//     i is bit-identical to the decode kernel at cur_len = start + i + 1.
//   * K/V tiles are read with 16-byte vector loads (element loads when a
//     row is not 16-byte aligned) and dequantised to fp32 in shared
//     memory (int8 caches multiply by their per-(position, kv head) fp32
//     scale); q is held in fp32; online softmax (m, l, acc) in fp32
//     exactly as the Pallas body does it, result acc / max(l, 1e-20)
//     cast to q's dtype. A row with cur_len == 0 runs no tile and writes
//     exact zeros.
//   * Each warp owns chunk rows c = warp, warp + 4, ...: lanes compute
//     logits for positions lane + 32j, reduce max/sum with shuffles,
//     then own head-dim columns d = lane + 32i of the PV update.
//   * With 8 sequences and 8 kv heads a decode call has 64 CTAs for 132
//     SMs (a verify call at S = 5, two chunks of 16 + 4 rows: 128), so
//     this kernel sits well under its bandwidth bound; splitting the
//     sequence across CTAs (flash-decoding) is the next step.
//
// Plain C interface (built with nvcc, loaded with ctypes): the launcher
// returns cudaGetLastError() after the launch, or -1 for arguments it
// does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // cache positions per shared-memory tile
constexpr int kMaxRows = 16;  // (head, query) rows per CTA
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

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

size_t smem_bytes(int rows, int head_dim) {
  // rows[kTile] (int64) | q[R][hd] | acc[R][hd] | k[kTile][hd+1] |
  // v[kTile][hd+1] | p[kWarps][kTile] | m[R] | l[R]
  return kTile * sizeof(long long) +
         (2 * rows * head_dim + 2 * kTile * (head_dim + 1) +
          kWarps * kTile + 2 * rows) * sizeof(float);
}

// The body of all three kernels: CTA (kv head kvh, sequence b, row
// chunk blockIdx.z). Chunk row c is row r = blockIdx.z * kMaxRows + c of
// the (head, query) order, r = g * S + i: query head kvh * G + g of
// token i.
template <typename TQ, typename TKV, bool PAGED>
__device__ __forceinline__ void attention_body(const Params& p) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int hd = p.head_dim;
  const int G = p.n_heads / p.n_kv_heads;
  const int S = p.s_q;
  const int row0 = blockIdx.z * kMaxRows;
  const int R = min(kMaxRows, G * S - row0);  // rows of this chunk
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

  // Element offset of chunk row c's head vector in q and out.
  auto head_offset = [&](int c) -> size_t {
    const int r = row0 + c;
    const int g = r / S;
    const int i = r - g * S;
    return ((static_cast<size_t>(b) * S + i) * p.n_heads +
            static_cast<size_t>(kvh) * G + g) * hd;
  };
  const int capacity = PAGED ? p.max_blocks * p.block_k : p.block_k;
  const int base = p.lens[b] + p.len_offset;
  // Chunk row c attends positions < row_len(c), never past the table.
  auto row_len = [&](int c) -> int {
    return max(0, min(base + (row0 + c) % S, capacity));
  };

  const TQ* q = static_cast<const TQ*>(p.q);
  for (int i = tid; i < R * hd; i += kThreads) {
    const int c = i / hd;
    qs[i] = to_f32(q[head_offset(c) + (i - c * hd)]);
    acc[i] = 0.f;
  }
  for (int c = tid; c < R; c += kThreads) {
    ms[c] = kNegInf;
    ls[c] = 0.f;
  }
  int cur = 0;  // the longest row: tiles past it are never read
  for (int c = 0; c < R; ++c) cur = max(cur, row_len(c));
  const TKV* kc = static_cast<const TKV*>(p.k);
  const TKV* vc = static_cast<const TKV*>(p.v);
  __syncthreads();

  for (int t0 = 0; t0 < cur; t0 += kTile) {
    const int n = min(kTile, cur - t0);
    // Cache row of each live position in the tile (the only table
    // reads: positions past every row's length are never looked up).
    for (int t = tid; t < n; t += kThreads) {
      const int pos = t0 + t;
      long long row;
      if (PAGED) {
        const int blk =
            p.tables[static_cast<size_t>(b) * p.max_blocks + pos / p.block_k];
        if (blk < 0 || blk >= p.n_pool_blocks) __trap();
        row = static_cast<long long>(blk) * p.block_k + pos % p.block_k;
      } else {
        row = static_cast<long long>(b) * p.block_k + pos;
      }
      rows[t] = row;
    }
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
            static_cast<size_t>(rows[t]) * p.n_kv_heads + kvh;
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
            static_cast<size_t>(rows[t]) * p.n_kv_heads + kvh;
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
      const int nr = min(n, row_len(c) - t0);
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

  TQ* out = static_cast<TQ*>(p.out);
  for (int i = tid; i < R * hd; i += kThreads) {
    const int c = i / hd;
    store(out + head_offset(c) + (i - c * hd), acc[i] / fmaxf(ls[c], 1e-20f));
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

// mode: 0 dense decode, 1 paged decode, 2 paged verify.
template <typename TQ, typename TKV>
int launch(const Params& p, int mode, cudaStream_t stream) {
  const int rows = p.n_heads / p.n_kv_heads * p.s_q;
  const int chunks = (rows + kMaxRows - 1) / kMaxRows;
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
  const dim3 grid(p.n_kv_heads, p.batch, chunks);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

// tables == nullptr selects the dense cache (block_k = max_len,
// max_blocks = 1, n_pool_blocks = batch); otherwise the paged pool.
// verify != 0 (paged only) runs the verify kernel: lens holds each
// sequence's first query position, and query i attends positions
// <= lens[b] + i. Otherwise s_q must be 1 and lens holds cur_len.
extern "C" int skytorch_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lens, const void* tables,
    void* out, int q_dtype, int kv_dtype, int batch, int s_q, int n_heads,
    int n_kv_heads, int head_dim, int block_k, int max_blocks,
    int n_pool_blocks, int verify, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || s_q < 1 || n_kv_heads < 1 ||
      n_heads % n_kv_heads != 0 || head_dim < 1 ||
      head_dim > kMaxHeadDim || block_k < 1 || max_blocks < 1 ||
      (verify ? tables == nullptr : s_q != 1) ||
      (kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
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
  p.batch = batch;
  p.s_q = s_q;
  p.len_offset = verify ? 1 : 0;
  p.n_heads = n_heads;
  p.n_kv_heads = n_kv_heads;
  p.head_dim = head_dim;
  p.block_k = block_k;
  p.max_blocks = max_blocks;
  p.n_pool_blocks = n_pool_blocks;
  p.scale = scale;
  const int elem_bytes = kv_dtype == kF32 ? 4 : kv_dtype == kBF16 ? 2 : 1;
  p.vec = (head_dim * elem_bytes) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int mode = verify ? 2 : tables != nullptr ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32: return dispatch_kv<float>(p, kv_dtype, mode, s);
    case kBF16: return dispatch_kv<__nv_bfloat16>(p, kv_dtype, mode, s);
    default: return -1;
  }
}
