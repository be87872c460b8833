// Flash-attention backward for Hopper (sm_90a), bf16, on wgmma: one
// kernel for dq, one for dk/dv.
//
// Replaces the Pallas TPU kernels skypilot_tpu/ops/flash_attention.py:145
// _flash_bwd_dq_kernel and :191 _flash_bwd_dkv_kernel for bf16 q/k/v/dout
// with head_dim 64 or 128 (fp32 inputs run the CUDA-core bodies of
// flash_attention.cu). Same function as those kernels: with
// P = exp(scale·q·kᵀ − L) and dS = P ⊙ (dO·vᵀ − D), where L is the
// forward's natural-log LSE and D = rowsum(dO ⊙ O), both fp32 [B, H, S],
//   dq = scale·Σⱼ dSⱼ Kⱼ,  dV = Σᵢ Pᵢᵀ dOᵢ,  dK = scale·Σᵢ dSᵢᵀ Qᵢ,
// over q/dout [B, S, H, D] and grouped k/v [B, S, Hkv, D] (query head h
// reads kv head h / G; dk/dv sum the G query heads of a group). Causal or
// full, any S (the tail is masked), scale = D ** -0.5; dq, dk, dv in bf16.
//
// What bounds them: operations. At the training shapes (B 12, S 2048,
// H 16, Hkv 8, D 128, causal) dq does 309 GFLOP (Q·Kᵀ, dO·Vᵀ, dS·K) and
// dk/dv 412 (Kᵀ·Q, Vᵀ·dO, Pᵀ·dO, dSᵀ·Q) against ~0.4 GB of traffic each,
// far above the ~295 flop/byte at which an H100's bf16 tensor cores
// rather than its memory set the pace. So every product is a wgmma.
//
// Design (the forward's, flash_forward_wgmma.cu, with hopper.cuh's
// helpers):
//   * A CTA is two consumer warpgroups of 64 rows each and one producer
//     warpgroup (setmaxnreg: 24 registers for the producer and 240 for
//     the consumers in dq; 40 and 232 in dk/dv, whose producer warp also
//     loads the row vectors). One producer thread keeps a ring of tiles
//     full with TMA copies over [B, S, heads, D] tensor maps with S exact
//     (rows past S come back as zeros); each stage completes on a "full"
//     mbarrier and is freed on an "empty" one once both warpgroups'
//     products that read it are done. Tiles use the 128-byte swizzle.
//   * dq: a CTA owns 128 query rows of one (batch, head). Q and dO are
//     loaded once; a three-stage ring streams 64-key K and V tiles. Per
//     tile, S = Q·Kᵀ and dP = dO·Vᵀ (m64n64k16, A and B K-major). dS =
//     P ⊙ (dP − D) is formed in the accumulator layout, packed to bf16
//     pairs, and is then wgmma's A fragment for dQ += dS·K, with K the
//     MN-major B operand read through the descriptor's transpose mode
//     (never transposed in memory). Tile j's S and dP are issued with
//     tile j−1's dS·K, so dS of tile j is formed while dS·K runs; dS is
//     packed only once no product reading it is in flight. The ring
//     needs three stages: tile j+1 loads into the stage that dS·K of
//     tile j-1 frees (with two: 0.73-0.78 ms against 0.50-0.51 on an
//     H100 at the training shapes, tools/flash_backward_variants.py).
//     Causal CTAs with the most key tiles go first.
//   * dk/dv: a CTA owns 128 keys of one (batch, kv head). K and V are
//     loaded once; a two-stage ring streams the (query head, 64-row query
//     tile) pairs of the group's G heads as one sequence, each stage a Q
//     and a dO tile plus that tile's L·log2(e) and D, which the producer
//     warp loads with plain loads into shared memory (TMA needs 16-byte
//     global strides, and [B, H, S] rows have 4·S bytes). The scores are
//     computed transposed, Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so the accumulators
//     are [keys x queries], already the A layout of dV += Pᵀ·dO and
//     dK += dSᵀ·Q; there dO and Q are MN-major B operands, the same
//     swizzled tiles read K-major for Sᵀ and dPᵀ. L and D index the
//     accumulator's columns: each thread reads the values of its fragment
//     columns from the stage's copy. dK and dV stay in fp32 registers
//     over every head and query tile, in a fixed order, and are written
//     once: no atomics. Inside a warpgroup nothing overlaps: dK, dV, Sᵀ,
//     dPᵀ and the P/dS fragments of a step before would need ~240
//     registers (issuing step t's Sᵀ/dPᵀ with step t-1's products, as dq
//     does, spilled and took 1.24-1.35 ms against 0.74-0.78 on an H100,
//     tools/flash_backward_variants.py). Causal CTAs with the most query
//     tiles (key tile 0) go first.
//   * Both: two named barriers pass the tensor cores between the
//     consumer warpgroups, so one's elementwise work runs under the
//     other's products. The exp runs in the exp2 domain (scale·log2(e)
//     and L·log2(e) folded into one FMA). Only tiles that cross the
//     causal diagonal or the end of S are masked (keys past S in dq,
//     queries past S in dk/dv): a zero row from TMA gives P = 1, so the
//     mask, not the zeros, makes it right. P and dS are rounded to bf16
//     once, as they enter their product.
//   * Deterministic: each CTA owns its outputs and walks its tiles in a
//     fixed order, so the same inputs give the same bits on every launch.
//
// Plain C interface (built with nvcc, loaded with ctypes): each launcher
// returns cudaGetLastError() after its launch, or -1 for arguments it
// does not take, -2 or -3 for a tensor map the driver will not make.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer
constexpr int kRows = 128;      // rows a CTA owns: dq query rows, dk/dv keys
constexpr int kTile = 64;       // ring tile rows: dq keys, dk/dv queries
constexpr int kDqStages = 3;
constexpr int kDkvStages = 2;

// q/dout [B, S, H, D] and k/v [B, S, Hkv, D] come in as tensor maps.
struct Params {
  const float* lse;       // [B, H, S] natural-log LSE of the forward
  const float* dsum;      // [B, H, S] rowsum(dO ⊙ O)
  __nv_bfloat16* dq;      // [B, S, H, D]
  __nv_bfloat16* dk;      // [B, S, Hkv, D]
  __nv_bfloat16* dv;      // [B, S, Hkv, D]
  int seq;
  int n_heads;
  int n_kv_heads;
  int causal;
  float scale;            // D ** -0.5
};

// acc = A·Bᵀ over D for one warpgroup, m64n64k16 per 16 of D: A its 64
// rows of a [kRows][D] tile (a_wg: the tile plus the warpgroup's row
// offset), B a [kTile][D] tile, both K-major. Element i of acc is row
// (lane / 4) + 8·((i >> 1) & 1) of the warp's 16, column 8·(i >> 2) +
// 2·(lane % 4) + (i & 1) of B's rows.
template <int D>
__device__ __forceinline__ void issue_abt(float (&acc)[kTile / 2],
                                          uint32_t a_wg, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(
        acc,
        smem_desc(a_wg + (kk >> 2) * (kRows * kRowBytes) + (kk & 3) * 32,
                  16, 8 * kRowBytes),
        smem_desc(b + (kk >> 2) * (kTile * kRowBytes) + (kk & 3) * 32, 16,
                  8 * kRowBytes),
        kk > 0);
}

// acc += A·B over N = D: A from registers, kTile / 16 k-steps of the
// m64k16 fragment; B a [kTile][D] tile read MN-major, 16 rows (2048
// bytes) per k-step, the next 64 columns a column block further.
template <int D>
__device__ __forceinline__ void issue_ab(float (&acc)[D / 2],
                                         const uint32_t (&a)[kTile / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_pv<D>(acc, a[kk],
                smem_desc(b + kk * 16 * kRowBytes, kTile * kRowBytes,
                          8 * kRowBytes));
}

// An accumulator tile in bf16 as A fragments: the accumulator layout
// already is wgmma's m64k16 A layout, 16 columns per k-step.
__device__ __forceinline__ void to_a_fragments(
    const float (&x)[kTile / 2], uint32_t (&a)[kTile / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(x[kk * 8 + e * 2], x[kk * 8 + e * 2 + 1]);
}

// ------------------------------------------------------------------ dq

// Shared memory: Q, dO, the ring (per stage K then V), the mbarriers (Q
// and dO full; per stage full, empty), 1024 bytes of slack to align.
template <int D>
constexpr size_t dq_smem_bytes() {
  return 1024 + 2 * tile_bytes<D, kRows>() +
         size_t(kDqStages) * 2 * tile_bytes<D, kTile>() +
         8 * (1 + 2 * kDqStages);
}

// dS = P ⊙ (dP − D) of one 64 x 64 tile, in place in s: P = exp2(s·
// scale·log2(e) − L·log2(e)), masked where the tile (keys from k0)
// crosses the causal diagonal or the end of S. Rows row and row + 8.
__device__ __forceinline__ void dq_ds_tile(float (&s)[kTile / 2],
                                           const float (&dp)[kTile / 2],
                                           int k0, int row, int col2, int r0,
                                           int S, int causal,
                                           float scale_log2,
                                           const float (&lse2)[2],
                                           const float (&dsum)[2]) {
  if (k0 + kTile > S || (causal && k0 + kTile - 1 > r0)) {
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      const int key = k0 + (i >> 2) * 8 + col2 + (i & 1);
      const int qrow = row + ((i >> 1) & 1) * 8;
      if (key >= S || (causal && key > qrow)) s[i] = -INFINITY;
    }
  }
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2_approx(fmaf(s[i], scale_log2, -lse2[r])) * (dp[i] - dsum[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const Params p) {
  constexpr uint32_t kQBytes = tile_bytes<D, kRows>();
  constexpr uint32_t kKBytes = tile_bytes<D, kTile>();
  constexpr uint32_t kStage = 2 * kKBytes;
  extern __shared__ unsigned char smem[];
  const uint32_t q_s = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t do_s = q_s + kQBytes;
  const uint32_t ring = do_s + kQBytes;
  const uint32_t q_full = ring + kDqStages * kStage;
  const uint32_t full = q_full + 8, empty = full + 8 * kDqStages;

  const int S = p.seq, H = p.n_heads;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / p.n_kv_heads);
  const int q0 = (p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;
  const int end = p.causal ? min(S, q0 + kRows) : S;
  const int n_kt = (end + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kDqStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // Producer: Q and dO once, then K/V tile j into stage j % kDqStages
    // as soon as the consumers have freed it.
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_full, 2 * kQBytes);
      tma_tile<D, kRows>(q_s, &tq, q_full, h, q0, b);
      tma_tile<D, kRows>(do_s, &tdo, q_full, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % kDqStages;
        mbar_wait(empty + 8 * st, ((j / kDqStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, kStage);
        tma_tile<D, kTile>(ring + st * kStage, &tk, full + 8 * st, kvh,
                           j * kTile, b);
        tma_tile<D, kTile>(ring + st * kStage + kKBytes, &tv, full + 8 * st,
                           kvh, j * kTile, b);
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
    const uint32_t do_wg = do_s + wg * 64 * kRowBytes;
    const float scale_log2 = p.scale * kLog2e;
    const long long vec = ((long long)b * H + h) * S;
    float lse2[2], dsum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qrow = row + 8 * r;
      lse2[r] = qrow < S ? p.lse[vec + qrow] * kLog2e : 0.f;
      dsum[r] = qrow < S ? p.dsum[vec + qrow] : 0.f;
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    mbar_wait(q_full, 0);

    // Tile j's S and dP are issued together with tile j - 1's dQ += dS K,
    // so dS of tile j is formed while dS K runs on the tensor cores; dS
    // becomes A fragments only once that product is done.
    uint32_t dsa[kTile / 16][4];
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    {
      float s[kTile / 2], dp[kTile / 2];
      mbar_wait(full, 0);
      turn_wait(wg);
      wgmma_fence();
      issue_abt<D>(s, q_wg, ring);
      issue_abt<D>(dp, do_wg, ring + kKBytes);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      hold(s);
      hold(dp);
      dq_ds_tile(s, dp, 0, row, col2, r0, S, p.causal, scale_log2, lse2,
                 dsum);
      to_a_fragments(s, dsa);
    }
    for (int j = 1; j < n_kt; ++j) {
      const int st = j % kDqStages, pst = (j - 1) % kDqStages;
      const uint32_t ks = ring + st * kStage;
      float s[kTile / 2], dp[kTile / 2];
      mbar_wait(full + 8 * st, (j / kDqStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_abt<D>(s, q_wg, ks);
      issue_abt<D>(dp, do_wg, ks + kKBytes);
      wgmma_commit();
      issue_ab<D>(dq, dsa, ring + pst * kStage);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();
      hold(s);
      hold(dp);
      dq_ds_tile(s, dp, j * kTile, row, col2, r0, S, p.causal, scale_log2,
                 lse2, dsum);
      wgmma_wait<0>();
      hold(dq);
      mbar_arrive(empty + 8 * pst);  // this thread is done with tile j - 1
      to_a_fragments(s, dsa);
    }
    {
      turn_wait(wg);
      wgmma_fence();
      issue_ab<D>(dq, dsa, ring + ((n_kt - 1) % kDqStages) * kStage);
      wgmma_commit();
      if (wg == 0) turn_pass(wg);  // warpgroup 1's would meet no wait
      wgmma_wait<0>();
      hold(dq);
    }

    const long long q_stride = (long long)H * D;
    __nv_bfloat16* dqg = p.dq + (long long)b * S * q_stride + h * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qrow = row + 8 * r;
      if (qrow >= S) continue;
      __nv_bfloat16* dst = dqg + qrow * q_stride + col2;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
        *reinterpret_cast<uint32_t*>(dst + nb * 8) =
            pack_bf16(dq[4 * nb + 2 * r] * p.scale,
                      dq[4 * nb + 2 * r + 1] * p.scale);
    }
  }
}

// --------------------------------------------------------------- dk/dv

// Shared memory: K, V, the ring (per stage Q then dO), the ring's
// vectors (per stage kTile values of L·log2(e), then kTile of D), the
// mbarriers (K and V full; per stage full, empty), 1024 bytes of slack.
template <int D>
constexpr size_t dkv_smem_bytes() {
  return 1024 + 2 * tile_bytes<D, kRows>() +
         size_t(kDkvStages) * (2 * tile_bytes<D, kTile>() + 2 * kTile * 4) +
         8 * (1 + 2 * kDkvStages);
}

// Pᵀ in s and dSᵀ = Pᵀ ⊙ (dPᵀ − D) in dp for one 64-key x 64-query
// tile (queries from q0 are the columns; keys `key` and key + 8 the
// thread's rows), masked where the tile crosses the causal diagonal or
// the end of S. lv: the stage's kTile values of L·log2(e), then of D.
__device__ __forceinline__ void dkv_p_ds(float (&s)[kTile / 2],
                                         float (&dp)[kTile / 2], int q0,
                                         int key, int kw, int col2, int S,
                                         int causal, float scale_log2,
                                         const float* lv) {
  if (q0 + kTile > S || (causal && q0 < kw + 63)) {
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      const int q = q0 + (i >> 2) * 8 + col2 + (i & 1);
      const int kr = key + ((i >> 1) & 1) * 8;
      if (q >= S || (causal && kr > q)) s[i] = -INFINITY;
    }
  }
#pragma unroll
  for (int c = 0; c < kTile / 8; ++c) {
    const float2 l2 = *reinterpret_cast<const float2*>(lv + 8 * c + col2);
    const float2 dd =
        *reinterpret_cast<const float2*>(lv + kTile + 8 * c + col2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * c + e;
      s[i] = exp2_approx(fmaf(s[i], scale_log2, (e & 1) ? -l2.y : -l2.x));
      dp[i] = s[i] * (dp[i] - ((e & 1) ? dd.y : dd.x));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const Params p) {
  constexpr uint32_t kKBytes = tile_bytes<D, kRows>();
  constexpr uint32_t kQBytes = tile_bytes<D, kTile>();
  constexpr uint32_t kStage = 2 * kQBytes;
  extern __shared__ unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const uint32_t k_s = (base + 1023) & ~1023u;
  const uint32_t v_s = k_s + kKBytes;
  const uint32_t ring = v_s + kKBytes;
  const uint32_t vecs = ring + kDkvStages * kStage;
  float* const vec_p = reinterpret_cast<float*>(smem + (vecs - base));
  const uint32_t kv_full = vecs + kDkvStages * 2 * kTile * 4;
  const uint32_t full = kv_full + 8, empty = full + 8 * kDkvStages;

  const int S = p.seq, H = p.n_heads, G = H / p.n_kv_heads;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kRows;
  // The (query head, query tile) sequence: per head the tiles from the
  // first that meets these keys (causal) to the end of S.
  const int n_qt = (S + kTile - 1) / kTile;
  const int i0 = p.causal ? k0 / kTile : 0;
  const int per_head = n_qt - i0;
  const int n_steps = G * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int st = 0; st < kDkvStages; ++st) {
      mbar_init(full + 8 * st, 32);
      mbar_init(empty + 8 * st, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // Producer warp: K and V once, then step t's Q and dO tiles (lane 0,
    // TMA) and its L·log2(e) and D (every lane, plain loads; queries past
    // S read 0) into stage t % kDkvStages once the consumers freed it.
    // Each lane arrives on the stage's full barrier after its stores.
    setmaxnreg_dec<40>();
    if (threadIdx.x < kConsumers * 128 + 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * kKBytes);
        tma_tile<D, kRows>(k_s, &tk, kv_full, kvh, k0, b);
        tma_tile<D, kRows>(v_s, &tv, kv_full, kvh, k0, b);
      }
      for (int t = 0; t < n_steps; ++t) {
        const int st = t % kDkvStages;
        const int gi = t / per_head;
        const int h = kvh * G + gi, q0 = (i0 + t - gi * per_head) * kTile;
        mbar_wait(empty + 8 * st, ((t / kDkvStages) & 1) ^ 1);
        const long long vec = ((long long)b * H + h) * S;
        float* const dst = vec_p + st * 2 * kTile;
#pragma unroll
        for (int r = lane; r < kTile; r += 32) {
          const int q = q0 + r;
          dst[r] = q < S ? p.lse[vec + q] * kLog2e : 0.f;
          dst[kTile + r] = q < S ? p.dsum[vec + q] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full + 8 * st, kStage);
          tma_tile<D, kTile>(ring + st * kStage, &tq, full + 8 * st, h, q0,
                             b);
          tma_tile<D, kTile>(ring + st * kStage + kQBytes, &tdo,
                             full + 8 * st, h, q0, b);
        } else {
          mbar_arrive(full + 8 * st);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int kw = k0 + wg * 64;                    // the warpgroup's keys
    const int key = kw + warp * 16 + (lane >> 2);   // and key + 8
    const int col2 = 2 * (lane & 3);
    const uint32_t k_wg = k_s + wg * 64 * kRowBytes;
    const uint32_t v_wg = v_s + wg * 64 * kRowBytes;
    const float scale_log2 = p.scale * kLog2e;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kv_full, 0);

    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    for (int t = 0; t < n_steps; ++t) {
      const int st = t % kDkvStages;
      const int gi = t / per_head;
      const int q0 = (i0 + t - gi * per_head) * kTile;
      const uint32_t qs = ring + st * kStage, dos = qs + kQBytes;
      float s[kTile / 2], dp[kTile / 2];
      mbar_wait(full + 8 * st, (t / kDkvStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_abt<D>(s, k_wg, qs);     // Sᵀ = K Qᵀ
      issue_abt<D>(dp, v_wg, dos);   // dPᵀ = V dOᵀ
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      hold(s);
      hold(dp);

      dkv_p_ds(s, dp, q0, key, kw, col2, S, p.causal, scale_log2,
               vec_p + st * 2 * kTile);
      uint32_t pa[kTile / 16][4], dsa[kTile / 16][4];
      to_a_fragments(s, pa);
      to_a_fragments(dp, dsa);

      turn_wait(wg);
      wgmma_fence();
      issue_ab<D>(dv, pa, dos);      // dV += Pᵀ dO
      issue_ab<D>(dk, dsa, qs);      // dK += dSᵀ Q
      wgmma_commit();
      if (wg == 0 || t + 1 < n_steps) turn_pass(wg);
      wgmma_wait<0>();
      hold(dk);
      hold(dv);
      mbar_arrive(empty + 8 * st);   // this thread is done with step t
    }

    const long long kv_stride = (long long)p.n_kv_heads * D;
    const long long off = (long long)b * S * kv_stride + kvh * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = key + 8 * r;
      if (kr >= S) continue;
      __nv_bfloat16* dkp = p.dk + off + kr * kv_stride + col2;
      __nv_bfloat16* dvp = p.dv + off + kr * kv_stride + col2;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        *reinterpret_cast<uint32_t*>(dkp + nb * 8) =
            pack_bf16(dk[4 * nb + 2 * r] * p.scale,
                      dk[4 * nb + 2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvp + nb * 8) =
            pack_bf16(dv[4 * nb + 2 * r], dv[4 * nb + 2 * r + 1]);
      }
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const CUtensorMap& tq,
           const CUtensorMap& tk, const CUtensorMap& tv,
           const CUtensorMap& tdo, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

enum Pass : int { kDq = 0, kDkv = 1 };

// q/dout boxes hold the CTA's rows for dq and a ring tile for dk/dv;
// k/v boxes the other way round.
template <int D>
int run(int pass, const void* q, const void* k, const void* v,
        const void* dout, const Params& p, int batch, cudaStream_t s) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  const int q_rows = pass == kDq ? kRows : kTile;
  const int kv_rows = pass == kDq ? kTile : kRows;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(encode, &tq, q, batch, p.seq, p.n_heads, D, q_rows) ||
      !make_map(encode, &tdo, dout, batch, p.seq, p.n_heads, D, q_rows) ||
      !make_map(encode, &tk, k, batch, p.seq, p.n_kv_heads, D, kv_rows) ||
      !make_map(encode, &tv, v, batch, p.seq, p.n_kv_heads, D, kv_rows))
    return -3;
  const unsigned n_tiles = (p.seq + kRows - 1) / kRows;
  if (pass == kDq)
    return launch(flash_bwd_dq_wgmma_kernel<D>,
                  dim3(n_tiles, p.n_heads, batch), dq_smem_bytes<D>(), tq,
                  tk, tv, tdo, p, s);
  return launch(flash_bwd_dkv_wgmma_kernel<D>,
                dim3(n_tiles, p.n_kv_heads, batch), dkv_smem_bytes<D>(), tq,
                tk, tv, tdo, p, s);
}

// bf16 only (dtype code 1, as flash_attention.cu's); any other dtype or
// head_dim is refused with -1.
int dispatch(int pass, const void* q, const void* k, const void* v,
             const void* dout, const Params& p, int dtype, int batch,
             int head_dim, void* stream) {
  if (dtype != 1 || batch < 1 || batch > 65535 || p.seq < 1 ||
      p.n_kv_heads < 1 || p.n_heads > 65535 ||
      p.n_heads % p.n_kv_heads != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return run<64>(pass, q, k, v, dout, p, batch, s);
    case 128: return run<128>(pass, q, k, v, dout, p, batch, s);
    default: return -1;
  }
}

Params make_params(const void* lse, const void* dsum, int seq, int n_heads,
                   int n_kv_heads, int causal, float scale) {
  Params p = {};
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<const float*>(dsum);
  p.seq = seq;
  p.n_heads = n_heads;
  p.n_kv_heads = n_kv_heads;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" int skytorch_flash_bwd_dq_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dq, int dtype, int batch,
    int seq, int n_heads, int n_kv_heads, int head_dim, int causal,
    float scale, void* stream) {
  Params p = make_params(lse, dsum, seq, n_heads, n_kv_heads, causal, scale);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  return dispatch(kDq, q, k, v, dout, p, dtype, batch, head_dim, stream);
}

extern "C" int skytorch_flash_bwd_dkv_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dk, void* dv, int dtype,
    int batch, int seq, int n_heads, int n_kv_heads, int head_dim,
    int causal, float scale, void* stream) {
  Params p = make_params(lse, dsum, seq, n_heads, n_kv_heads, causal, scale);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  return dispatch(kDkv, q, k, v, dout, p, dtype, batch, head_dim, stream);
}
