// Flash-decode attention for Hopper (sm_90a): one query token per
// sequence against a dense KV cache or a paged block pool.
//
// Replaces the Pallas TPU kernels in skypilot_tpu/ops/decode_attention.py:
//   * _decode_kernel        (dense cache  [B, max_len, Hkv, hd])
//   * _paged_decode_kernel  (block pool   [n_blocks, block_k, Hkv, hd]
//                            read through block_tables [B, max_blocks])
// One templated body serves both: the paged variant only changes which
// cache row a position lives in.
//
// What bounds it: bytes. A decode step reads every live K/V position
// once (sum_b cur_len_b * Hkv * hd * 2 * bytes/elem, plus 8 B per
// (position, kv head) of int8 scales) and does ~4 flops per byte read,
// far below the ~295 flop/byte an H100 needs before compute matters.
//
// Design (simple and right first; see PERF.md for its measured time):
//   * One CTA per (kv head, batch row). The G = H / Hkv query heads of
//     that kv head share each K/V tile read (GQA in-kernel, query head
//     kv*G + r), so the cache is read once per step, not once per head.
//   * The CTA walks kTile-position tiles only up to cur_len: dead
//     positions are never read, which is what the TPU kernel's clamped
//     index map achieves. In paged mode the pool row of position p is
//     tables[b, p / block_k] * block_k + p % block_k, looked up only for
//     p < cur_len.
//   * K/V tiles are read with 16-byte vector loads (element loads when a
//     row is not 16-byte aligned) and dequantised to fp32 in shared
//     memory (int8 caches multiply by their per-(position, kv head) fp32
//     scale); q is held in fp32; online softmax (m, l, acc) in fp32
//     exactly as the Pallas body does it, result acc / max(l, 1e-20)
//     cast to q's dtype. A row with cur_len == 0 runs no tile and writes
//     exact zeros.
//   * Each warp owns query heads g = warp, warp + 4, ...: lanes compute
//     logits for positions lane + 32j, reduce max/sum with shuffles,
//     then own head-dim columns d = lane + 32i of the PV update.
//   * With 8 sequences and 8 kv heads there are 64 CTAs for 132 SMs, so
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
constexpr int kMaxGroups = 16;
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

// dtype codes shared with the Python wrapper.
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

struct Params {
  const void* q;          // [B, 1, H, hd]
  const void* k;          // dense [B, max_len, Hkv, hd] or pool
  const void* v;
  const float* k_scale;   // int8 only: [B, max_len, Hkv] or pool-shaped
  const float* v_scale;
  const int32_t* cur_len; // [B]
  const int32_t* tables;  // paged only: [B, max_blocks]
  void* out;              // [B, 1, H, hd], q's dtype
  int batch;
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

size_t smem_bytes(int groups, int head_dim) {
  // rows[kTile] (int64) | q[G][hd] | acc[G][hd] | k[kTile][hd+1] |
  // v[kTile][hd+1] | p[kWarps][kTile] | m[G] | l[G]
  return kTile * sizeof(long long) +
         (2 * groups * head_dim + 2 * kTile * (head_dim + 1) +
          kWarps * kTile + 2 * groups) * sizeof(float);
}

template <typename TQ, typename TKV, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Params p) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int hd = p.head_dim;
  const int G = p.n_heads / p.n_kv_heads;
  const int ld = hd + 1;  // padded tile row: conflict-free column reads
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* rows = reinterpret_cast<long long*>(smem_raw);
  float* qs = reinterpret_cast<float*>(rows + kTile);
  float* acc = qs + G * hd;
  float* ks = acc + G * hd;
  float* vs = ks + kTile * ld;
  float* ps = vs + kTile * ld;
  float* ms = ps + kWarps * kTile;
  float* ls = ms + G;

  const size_t head0 = (static_cast<size_t>(b) * p.n_heads +
                        static_cast<size_t>(kvh) * G) * hd;
  const TQ* q = static_cast<const TQ*>(p.q) + head0;
  for (int i = tid; i < G * hd; i += kThreads) {
    qs[i] = to_f32(q[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }
  const int capacity = PAGED ? p.max_blocks * p.block_k : p.block_k;
  const int cur = max(0, min(p.cur_len[b], capacity));
  const TKV* kc = static_cast<const TKV*>(p.k);
  const TKV* vc = static_cast<const TKV*>(p.v);
  __syncthreads();

  for (int t0 = 0; t0 < cur; t0 += kTile) {
    const int n = min(kTile, cur - t0);
    // Cache row of each live position in the tile (the only table
    // reads: positions >= cur_len are never looked up).
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
    for (int g = warp; g < G; g += kWarps) {
      const float* qg = qs + g * hd;
      float s[kTile / 32];
      float m_blk = kNegInf;
#pragma unroll
      for (int j = 0; j < kTile / 32; ++j) {
        const int t = lane + 32 * j;
        s[j] = kNegInf;   // rows t >= n hold stale data: masked, unread
        if (t < n) {
          const float* kr = ks + t * ld;
          float dot = 0.f;
          for (int d = 0; d < hd; ++d) dot = fmaf(qg[d], kr[d], dot);
          s[j] = dot * p.scale;
        }
        m_blk = fmaxf(m_blk, s[j]);
      }
      m_blk = warp_max(m_blk);
      const float m_old = ms[g];
      const float l_old = ls[g];
      const float m_new = fmaxf(m_old, m_blk);
      const float safe_m = m_new == kNegInf ? 0.f : m_new;
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTile / 32; ++j) {
        const int t = lane + 32 * j;
        const float e = t < n ? expf(s[j] - safe_m) : 0.f;
        pw[t] = e;
        p_sum += e;
      }
      p_sum = warp_sum(p_sum);
      const float corr = m_old == kNegInf ? 0.f : expf(m_old - safe_m);
      __syncwarp();
      float* ag = acc + g * hd;
      for (int d = lane; d < hd; d += 32) {
        float a = ag[d] * corr;
        for (int t = 0; t < n; ++t) a = fmaf(pw[t], vs[t * ld + d], a);
        ag[d] = a;
      }
      __syncwarp();  // all lanes done with pw and m/l before reuse
      if (lane == 0) {
        ms[g] = m_new;
        ls[g] = l_old * corr + p_sum;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  TQ* out = static_cast<TQ*>(p.out) + head0;
  for (int i = tid; i < G * hd; i += kThreads) {
    const float l = ls[i / hd];
    store(out + i, acc[i] / fmaxf(l, 1e-20f));
  }
}

template <typename TQ, typename TKV, bool PAGED>
int launch(const Params& p, cudaStream_t stream) {
  const int groups = p.n_heads / p.n_kv_heads;
  const size_t smem = smem_bytes(groups, p.head_dim);
  auto kernel = decode_attention_kernel<TQ, TKV, PAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.n_kv_heads, p.batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, bool PAGED>
int dispatch_kv(const Params& p, int kv_dtype, cudaStream_t s) {
  switch (kv_dtype) {
    case kF32: return launch<TQ, float, PAGED>(p, s);
    case kBF16: return launch<TQ, __nv_bfloat16, PAGED>(p, s);
    case kI8: return launch<TQ, int8_t, PAGED>(p, s);
    default: return -1;
  }
}

template <bool PAGED>
int dispatch(const Params& p, int q_dtype, int kv_dtype, cudaStream_t s) {
  switch (q_dtype) {
    case kF32: return dispatch_kv<float, PAGED>(p, kv_dtype, s);
    case kBF16: return dispatch_kv<__nv_bfloat16, PAGED>(p, kv_dtype, s);
    default: return -1;
  }
}

}  // namespace

// tables == nullptr selects the dense cache (block_k = max_len,
// max_blocks = 1, n_pool_blocks = batch); otherwise the paged pool.
extern "C" int skytorch_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* cur_len, const void* tables,
    void* out, int q_dtype, int kv_dtype, int batch, int n_heads,
    int n_kv_heads, int head_dim, int block_k, int max_blocks,
    int n_pool_blocks, float scale, void* stream) {
  if (batch < 1 || n_kv_heads < 1 || n_heads % n_kv_heads != 0 ||
      n_heads / n_kv_heads > kMaxGroups || head_dim < 1 ||
      head_dim > kMaxHeadDim || block_k < 1 || max_blocks < 1 ||
      (kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return -1;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.cur_len = static_cast<const int32_t*>(cur_len);
  p.tables = static_cast<const int32_t*>(tables);
  p.out = out;
  p.batch = batch;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tables != nullptr ? dispatch<true>(p, q_dtype, kv_dtype, s)
                           : dispatch<false>(p, q_dtype, kv_dtype, s);
}
