// Flash-attention forward for Hopper (sm_90a), bf16, on wgmma.
//
// Replaces the Pallas TPU kernel skypilot_tpu/ops/flash_attention.py:37
// _flash_kernel for bf16 q/k/v with head_dim 64 or 128 (fp32 inputs run
// the CUDA-core body of flash_attention.cu). Same function as that
// kernel: q [B, S, H, D] and grouped k/v [B, S, Hkv, D] (query head h
// reads kv head h / G) → out [B, S, H, D] in bf16 and the fp32
// natural-log normaliser LSE = m + log(l) as [B, H, S], the layout the
// backward kernels of flash_attention.cu read. Causal or full, any S
// (the tail is masked), scale = D ** -0.5.
//
// What bounds it: operations. At the training shapes (B 12, S 2048,
// H 16, Hkv 8, D 128, causal) it does 206 GFLOP against 0.3 GB of
// traffic, ~700 flop/byte, above the ~295 at which an H100's bf16
// tensor cores rather than its memory set the pace. wgmma is the only
// way to the tensor cores' full rate, so both products use it.
//
// Design:
//   * A CTA owns 128 query rows of one (batch, head): two warpgroups,
//     each holding 64 rows of O (fp32) in the wgmma accumulator layout,
//     so every K/V tile it loads serves 128 rows. Causal CTAs with the
//     most key tiles go first.
//   * S = Q·Kᵀ: wgmma m64n128k16 per 16 of D, Q and K both K-major in
//     shared memory. Q is loaded once per CTA.
//   * O += P·V: P never leaves registers: the S accumulator, turned into
//     bf16 pairs, is already wgmma's A fragment (rows g and g + 8,
//     columns 2t..2t+1 and 2t+8..2t+9 of each 16 keys). V is read as the
//     MN-major B operand through the descriptor's transpose mode, so it
//     is never transposed in memory.
//   * Shared tiles use the 128-byte swizzle the descriptors name: D/64
//     column blocks of rows x 128 bytes, each row's 16-byte chunks
//     XOR-ed with (row % 8), every block 1024-byte aligned.
//   * Warp specialisation: a third warpgroup is the producer. One of
//     its threads loads Q once and keeps a two-stage ring of 128-key K
//     and V tiles full with TMA copies, each completing on an mbarrier
//     ("full"); the consumers free a K tile once Q·Kᵀ has read it and a
//     V tile once P·V has, each on its own "empty" mbarrier. The
//     producer gives up registers (setmaxnreg 24) so the consumers can
//     hold 240. The tensor maps are [B, S, heads, D] with S exact, so
//     rows at or past S of a (batch, head) come back as zeros.
//   * Overlap inside a warpgroup: tile j's Q·Kᵀ and tile j-1's P·V are
//     issued together and tile j's softmax runs while P·V is on the
//     tensor cores; P is packed into A fragments, and O rescaled, only
//     while no product reading them is in flight (else ptxas would
//     serialise the wgmmas).
//   * Overlap between warpgroups: two named barriers pass a turn, so
//     the warpgroups issue their products alternately and one's
//     softmax runs under the other's products.
//   * Online softmax in the exp2 domain, scale·log2(e) folded into one
//     FMA per element; the row max and sum reduce over the four lanes
//     of a fragment row. Only tiles that cross the causal diagonal or
//     the end of S are masked.
//   * Deterministic: each CTA owns its rows and walks its key tiles in
//     order, so the same inputs give the same bits on every launch.
//
// Plain C interface (built with nvcc, loaded with ctypes): the launcher
// returns cudaGetLastError() after its launch, or -1 for arguments it
// does not take.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 128;             // query rows per CTA
constexpr int kBlockN = 128;             // keys per K/V tile
constexpr int kConsumers = 2;            // warpgroups of 64 query rows
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer
constexpr int kStages = 2;               // K/V ring depth

// q [B, S, H, D] and k/v [B, S, Hkv, D] come in as tensor maps.
struct Params {
  __nv_bfloat16* out;      // [B, S, H, D]
  float* lse;              // [B, H, S]
  int seq;
  int n_heads;
  int n_kv_heads;
  int causal;
  float scale;             // D ** -0.5
};

// Max and sum over the four lanes that share a fragment row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Shared memory: Q, the K ring, the V ring, then the mbarriers (Q full;
// per stage K full, V full, K empty, V empty), 1024 bytes of slack to
// align.
template <int D>
constexpr size_t smem_bytes() {
  return 1024 + tile_bytes<D, kBlockM>() +
         size_t(kStages) * 2 * tile_bytes<D, kBlockN>() +
         8 * (1 + 4 * kStages);
}

// S = Q Kᵀ for one warpgroup's 64 rows and a 128-key tile: element i of
// s is row (lane / 4) + 8·((i >> 1) & 1) of the warp's 16, key
// 8·(i >> 2) + 2·(lane % 4) + (i & 1) of the tile.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBlockN / 2],
                                         uint32_t q_wg, uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128(
        s,
        smem_desc(q_wg + (kk >> 2) * (kBlockM * kRowBytes) + (kk & 3) * 32,
                  16, 8 * kRowBytes),
        smem_desc(ks + (kk >> 2) * (kBlockN * kRowBytes) + (kk & 3) * 32, 16,
                  8 * kRowBytes),
        kk > 0);
}

// O += P V: V MN-major, 16 keys (2048 bytes) per k-step; the next 64
// columns of D are a column block (kBlockN rows) further.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kBlockN / 16][4],
                                         uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
    wgmma_pv<D>(o, pa[kk],
                smem_desc(vs + kk * 16 * kRowBytes, kBlockN * kRowBytes,
                          8 * kRowBytes));
}

// Online softmax of one tile of S (raw Q·K products, keys from k0), in
// place: masks where the tile crosses the causal diagonal or the end of
// S, updates the row max m and this thread's share of the row sum l
// (both in the exp2 domain), leaves P = exp2(s·scale·log2(e) − m·scale·
// log2(e)) in s and the factor that rescales O to the new max in corr.
__device__ __forceinline__ void softmax_tile(float (&s)[kBlockN / 2], int k0,
                                             int row, int col2, int r0,
                                             int S, int causal,
                                             float scale_log2, float (&m)[2],
                                             float (&l)[2],
                                             float (&corr)[2]) {
  if (k0 + kBlockN > S || (causal && k0 + kBlockN - 1 > r0)) {
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) {
      const int key = k0 + (i >> 2) * 8 + col2 + (i & 1);
      const int qrow = row + ((i >> 1) & 1) * 8;
      if (key >= S || (causal && key > qrow)) s[i] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = quad_max(mx[r]);
    shift[r] = mn == -INFINITY ? 0.f : mn * scale_log2;
    corr[r] = exp2_approx(m[r] * scale_log2 - shift[r]);
    m[r] = mn;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < kBlockN / 2; i += 2) {
    const int r = (i >> 1) & 1;
    s[i] = exp2_approx(fmaf(s[i], scale_log2, -shift[r]));
    s[i + 1] = exp2_approx(fmaf(s[i + 1], scale_log2, -shift[r]));
    l[r] += s[i] + s[i + 1];
  }
}

// P in bf16 as the A fragments of the P·V product, 16 keys per k-step:
// the accumulator layout of S already is wgmma's A fragment layout.
__device__ __forceinline__ void to_a_fragments(
    const float (&s)[kBlockN / 2], uint32_t (&pa)[kBlockN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(s[kk * 8 + e * 2], s[kk * 8 + e * 2 + 1]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const Params p) {
  constexpr uint32_t kTile = tile_bytes<D, kBlockN>();
  extern __shared__ unsigned char smem[];
  const uint32_t q_s = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t k_s = q_s + tile_bytes<D, kBlockM>();
  const uint32_t v_s = k_s + kStages * kTile;
  const uint32_t q_full = v_s + kStages * kTile;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int S = p.seq, H = p.n_heads;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / p.n_kv_heads);
  const int q0 =
      (p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kBlockM;
  const int end = p.causal ? min(S, q0 + kBlockM) : S;
  const int n_kt = (end + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, kConsumers * 128);
      mbar_init(v_empty + 8 * st, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // Producer: Q once, then K/V tile j into stage j % kStages as soon
    // as the consumers have freed it (the first round's waits pass on
    // the fresh barriers).
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_full, tile_bytes<D, kBlockM>());
      tma_tile<D, kBlockM>(q_s, &tq, q_full, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % kStages;
        const int free = ((j / kStages) & 1) ^ 1;
        mbar_wait(k_empty + 8 * st, free);
        mbar_expect_tx(k_full + 8 * st, kTile);
        tma_tile<D, kBlockN>(k_s + st * kTile, &tk, k_full + 8 * st, kvh,
                             j * kBlockN, b);
        mbar_wait(v_empty + 8 * st, free);
        mbar_expect_tx(v_full + 8 * st, kTile);
        tma_tile<D, kBlockN>(v_s + st * kTile, &tv, v_full + 8 * st, kvh,
                             j * kBlockN, b);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int r0 = q0 + wg * 64;                    // the warpgroup's rows
    const int row = r0 + warp * 16 + (lane >> 2);   // and row + 8
    const int col2 = 2 * (lane & 3);
    const uint32_t q_wg = q_s + wg * 64 * kRowBytes;
    const float scale_log2 = p.scale * kLog2e;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    // Tile j's S = Q Kᵀ is issued together with tile j - 1's O += P V,
    // so the softmax of tile j runs while the tensor cores do P V. P
    // becomes A fragments, and O is rescaled, only while no product that
    // reads them is in flight.
    uint32_t pa[kBlockN / 16][4];
    float corr[2];
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    {
      float s[kBlockN / 2];
      mbar_wait(k_full, 0);
      turn_wait(wg);
      wgmma_fence();
      issue_qk<D>(s, q_wg, k_s);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      hold(s);
      mbar_arrive(k_empty);
      softmax_tile(s, 0, row, col2, r0, S, p.causal, scale_log2, m, l, corr);
      to_a_fragments(s, pa);
    }
    for (int j = 1; j < n_kt; ++j) {
      const int st = j % kStages, pst = (j - 1) % kStages;
      float s[kBlockN / 2];
      mbar_wait(k_full + 8 * st, (j / kStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_qk<D>(s, q_wg, k_s + st * kTile);
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      mbar_wait(v_full + 8 * pst, ((j - 1) / kStages) & 1);
      wgmma_fence();
      issue_pv<D>(o, pa, v_s + pst * kTile);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();
      hold(s);
      mbar_arrive(k_empty + 8 * st);  // this thread is done with K_j
      softmax_tile(s, j * kBlockN, row, col2, r0, S, p.causal, scale_log2,
                   m, l, corr);
      wgmma_wait<0>();
      hold(o);
      mbar_arrive(v_empty + 8 * pst);  // and with V_{j-1}
      to_a_fragments(s, pa);
    }
    {
      const int st = (n_kt - 1) % kStages;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      mbar_wait(v_full + 8 * st, ((n_kt - 1) / kStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_pv<D>(o, pa, v_s + st * kTile);
      wgmma_commit();
      if (wg == 0) turn_pass(wg);  // warpgroup 1's would meet no wait
      wgmma_wait<0>();
      hold(o);
    }

    const long long q_stride = (long long)H * D;
    __nv_bfloat16* og = p.out + b * S * q_stride + h * D;
    float* lse = p.lse + ((long long)b * H + h) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qrow = row + 8 * r;
      const float sum = quad_sum(l[r]);
      const float inv = 1.f / fmaxf(sum, 1e-20f);
      if (qrow >= S) continue;
      __nv_bfloat16* dst = og + qrow * q_stride + col2;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
        *reinterpret_cast<uint32_t*>(dst + nb * 8) =
            pack_bf16(o[4 * nb + 2 * r] * inv, o[4 * nb + 2 * r + 1] * inv);
      if ((lane & 3) == 0)
        lse[qrow] = m[r] * p.scale + logf(fmaxf(sum, 1e-20f));
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int batch, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, batch, p.seq, p.n_heads, D, kBlockM) ||
      !make_map(encode, &tk, k, batch, p.seq, p.n_kv_heads, D, kBlockN) ||
      !make_map(encode, &tv, v, batch, p.seq, p.n_kv_heads, D, kBlockN))
    return -3;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.seq + kBlockM - 1) / kBlockM, p.n_heads, batch);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 forward (dtype code 1, as flash_attention.cu's); any other dtype
// or head_dim is refused with -1, a tensor map the driver will not make
// with -2 or -3.
extern "C" int skytorch_flash_forward_wgmma(const void* q, const void* k,
                                            const void* v, void* out,
                                            void* lse, int dtype, int batch,
                                            int seq, int n_heads,
                                            int n_kv_heads, int head_dim,
                                            int causal, float scale,
                                            void* stream) {
  if (dtype != 1 || batch < 1 || batch > 65535 || seq < 1 ||
      n_kv_heads < 1 || n_heads > 65535 || n_heads % n_kv_heads != 0)
    return -1;
  Params p = {};
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.seq = seq;
  p.n_heads = n_heads;
  p.n_kv_heads = n_kv_heads;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch<64>(q, k, v, p, batch, s);
    case 128: return launch<128>(q, k, v, p, batch, s);
    default: return -1;
  }
}
