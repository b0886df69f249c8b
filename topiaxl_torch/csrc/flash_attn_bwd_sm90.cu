// Flash-attention backward for Hopper (sm_90a), KV-major: bf16 q, k, v,
// dO in, f32 logsumexp (lse) from the forward; bf16 dk, dv out. Two
// compile-time variants of one kernel:
//   * the single pass (flash_attn_bwd, kWithDq): also reads o and adds dq
//     into a zeroed f32 [B, Sq, H, D] buffer. Replaces the TPU kernel
//     topiaxl/ops/flash_attention.py:_flash_bwd_fused_kernel (:369), the
//     backward taken when the keys fit one block (Sk <= 2048: the DiT's
//     self- and cross-attention);
//   * the dk/dv pass of the two-pass pair (flash_attn_bwd_dkv, !kWithDq):
//     reads delta = rowsum(dO * o), f32 [B, H, Sq], from the scratch the
//     dq pass (flash_attn_bwd.cu) wrote before it on the same stream, in
//     place of o. Replaces topiaxl/ops/flash_attention.py:
//     _flash_bwd_dkv_kernel (:469), the FA2 dk/dv pass, taken with the dq
//     pass for Sk > 2048.
// Numerics, shared with the dq pass: p = exp(s * scale - lse) in f32;
// delta = rowsum(dO * o) in f32; P rounded to bf16 for dv, dS = p * (dP -
// delta) rounded to bf16 for dq and dk; f32 accumulation; the scale
// applied to dq and dk; keys at or past Sk and q rows at or past Sq get
// p = 0.
//
// What bounds it on an H100: tensor-core FLOPs. Per head the single pass
// runs five Sq x Sk x D products (S and dP recomputed, then dV, dK, dQ),
// the dk/dv pass four, far above the card's FLOP-per-byte ridge at the
// DiT's shapes. The design:
//   * one block per (batch*head, 128-key KV tile): dK and dV accumulate
//     in f32 registers while the block loops over 64-row q tiles; two
//     consumer warpgroups own 64 keys each, a producer warpgroup feeds
//     them;
//   * the producer's first thread loads K and V once and streams Q and dO
//     (and o, in the single pass) tiles through a ring by TMA (mbarrier
//     full/empty pairs; two stages in the single pass, four in the dk/dv
//     pass, whose shared memory holds no o, dS^T or dQ tiles); two more
//     of its warps put each q tile's lse (in log2 units) and delta into
//     the same stage: the single pass computes delta from the o and dO
//     tiles in shared memory, the dk/dv pass reads it from the scratch;
//     setmaxnreg moves registers to the consumers;
//   * the products run on wgmma: S^T = K Q^T and dP^T = V dO^T, K-major
//     over D (m64n64k16); dV += P^T dO and dK += dS^T Q with P^T and dS^T
//     straight from the S^T and dP^T accumulator registers and dO, Q read
//     MN-major (m64n{72,64}k16). In the single pass K and V are read from
//     shared memory; the dk/dv pass, with registers to spare (no dQ), holds
//     them as A fragments, so S^T and dP^T read only Q and dO there;
//   * the dk/dv pass issues S^T and dP^T of q tile i + 1 with dV and dK of
//     tile i and waits once per tile, so each warpgroup has four products
//     queued, and its two warpgroups take turns issuing them (ping-pong,
//     two named barriers), so one's exponentials overlap the other's
//     products;
//   * in the single pass dQ = dS K after dS^T goes through shared memory
//     once (bf16), with dS read MN-major and K MN-major; the two
//     warpgroups split dQ's columns (40 + 32 of 72, 32 + 32 of 64), so
//     each dQ element of a (KV tile, q tile) pair is added once; dQ, a
//     sum over KV tiles that run on other blocks, is added to the f32
//     scratch by one bulk TMA reduce-add per warpgroup and q tile, from a
//     staging tile in shared memory, in place of an atomic per element.
//     The order of the additions varies from run to run, so the single
//     pass's dq rounding does too (the dk/dv pass is deterministic);
//   * one instance per head dim 64, 72, 80, 96 and 128; above 72 the dk/dv
//     pass keeps K and V in shared memory and waits for each tile's
//     products before the next (kKvRegs false: dK and dV alone take D
//     registers a thread), the single pass splits dQ's columns in halves,
//     and at 128 its consumers take 240 registers and the producer 24;
//   * head dim 256 has a kernel of its own (flash_bwd_wide_kernel, both
//     variants): dK and dV of 64 keys at 256 columns would take 256
//     registers a thread in one warpgroup, so a block owns 64 keys and its
//     two consumer warpgroups split the columns, each accumulating dK and
//     dV over its 128 (128 registers a thread). Each computes S^T and dP^T
//     of the 64 keys in full (the same products twice: neither waits on
//     the other's softmax); in the single pass warpgroup 0 puts dS^T into
//     shared memory, each computes its 128 columns of dQ (64 at a time)
//     and adds them to the f32 scratch with atomics, and the producer
//     reads o for delta from device memory (Q and dO stages leave no room
//     for o or staging tiles). Every product is waited on before the
//     next: a simple form;
//   * tiles use the no-swizzle core-matrix layout of sm90.cuh, so head
//     dim 72 needs no swizzle span; the contraction over D runs to 80,
//     with the 10th chunk of K, V, Q and dO zeroed once and never loaded;
//     the [B, S, H, D] strides go into tensor maps, so the DiT's
//     qkv.unbind(2) views are read without a copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 64;    // q rows per q tile
constexpr int kBlockN = 128;   // keys per block, 64 per consumer warpgroup
constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int kStatThreads = 64;   // producer threads writing lse, delta
constexpr float kLog2e = 1.4426950408889634f;

// dQ columns of warpgroup 0 in the single pass; warpgroup 1 takes the rest
// (each a multiple of 8, a wgmma width)
__host__ __device__ constexpr int dq_cols0(int D) {
  return D == 72 ? 40 : D / 2;
}

template <int D, bool kWithDq>
struct Bwd {
  static constexpr int kStages = kWithDq ? 2 : 4;   // Q / dO ring depth
  // the dk/dv pass holds K and V as A fragments and overlaps q tiles up to
  // head dim 72; above, dK and dV alone take D registers a thread and that
  // form spills (32 bytes at 80), so it reads K and V from shared memory
  // and runs the single pass's loop
  static constexpr bool kKvRegs = !kWithDq && D <= 72;
  // registers a thread, producer warpgroup and consumers (setmaxnreg): the
  // single pass's producer computes delta from o and dO, with 56 up to head
  // dim 96; at 128 its consumers need all 240 (224 spilled 20 bytes) and
  // the producer takes 24, as in the dk/dv pass
  static constexpr int kProducerRegs = kWithDq && D <= 96 ? 56 : 24;
  static constexpr int kConsumerRegs = kWithDq && D <= 96 ? 224 : 240;
  static constexpr int kChunks = D / 8;
  static constexpr int kSteps = (D + 15) / 16;    // k16 steps over D
  static constexpr int kChunksP = 2 * kSteps;
  static constexpr int kKElems = kChunksP * kBlockN * 8;   // K or V
  static constexpr int kQElems = kChunksP * kBlockM * 8;   // Q or dO stage
  static constexpr int kOElems = kWithDq ? kChunks * kBlockM * 8 : 0;
  static constexpr int kDsElems = kWithDq ? kBlockM * kBlockN : 0;  // dS^T
  static constexpr int kDqOffset =
      2 * (2 * kKElems + kStages * (2 * kQElems + kOElems) + kDsElems);
  static constexpr int kStatOffset =
      kDqOffset + (kWithDq ? 4 * kBlockM * D : 0);
  static constexpr int kBarOffset = kStatOffset + 4 * 2 * kStages * kBlockM;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 3 * kStages);
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
};

struct BwdArgs {
  const float* lse;      // [B, H, Sq] contiguous
  const float* delta;    // [B, H, Sq] contiguous (the dk/dv pass)
  __nv_bfloat16* dk;     // [B, Sk, H, D] contiguous
  __nv_bfloat16* dv;
  // head dim 256, the single pass: the f32 dq scratch [B, Sq, H, D]
  // (contiguous) and o [B, Sq, H, D] at strides osb, oss, osh
  float* dq;
  const __nv_bfloat16* o;
  long long osb, oss, osh;
  int H, Sq, Sk;
  float scale, scale_log2;
};

// S^T = K Q^T and dP^T = V dO^T of one q tile, 64 keys x 64 q rows each:
// K, V K-major A (this warpgroup's rows of kN-key tiles), Q, dO K-major B
template <int D, int kN = kBlockN>
__device__ __forceinline__ void issue_st_dpt(float (&s)[kBlockM / 2],
                                             float (&dp)[kBlockM / 2],
                                             uint64_t k_desc, uint64_t v_desc,
                                             const __nv_bfloat16* Qt,
                                             const __nv_bfloat16* dOt) {
  constexpr int kSteps = (D + 15) / 16;
  const uint64_t q_desc = make_desc(Qt, kBlockM * 16, 128);
  const uint64_t do_desc = make_desc(dOt, kBlockM * 16, 128);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    wgmma_ss<kBlockM, 0, 0>(s, k_desc + ((kk * 2 * kN * 16) >> 4),
                            q_desc + ((kk * 2 * kBlockM * 16) >> 4), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    wgmma_ss<kBlockM, 0, 0>(dp, v_desc + ((kk * 2 * kN * 16) >> 4),
                            do_desc + ((kk * 2 * kBlockM * 16) >> 4), kk > 0);
  }
}

// the same products with K and V as A fragments in registers (this
// warpgroup's 64 keys, one fragment per k16 step over D), so that only Q
// and dO are read from shared memory (the dk/dv pass)
template <int D>
__device__ __forceinline__ void issue_st_dpt_rs(
    float (&s)[kBlockM / 2], float (&dp)[kBlockM / 2],
    const uint32_t (&kf)[(D + 15) / 16][4],
    const uint32_t (&vf)[(D + 15) / 16][4], const __nv_bfloat16* Qt,
    const __nv_bfloat16* dOt) {
  constexpr int kSteps = (D + 15) / 16;
  const uint64_t q_desc = make_desc(Qt, kBlockM * 16, 128);
  const uint64_t do_desc = make_desc(dOt, kBlockM * 16, 128);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    wgmma_rs<kBlockM, 0>(s, kf[kk], q_desc + ((kk * 2 * kBlockM * 16) >> 4),
                         kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    wgmma_rs<kBlockM, 0>(dp, vf[kk],
                         do_desc + ((kk * 2 * kBlockM * 16) >> 4), kk > 0);
  }
}

// p = exp(s * scale - lse), masked; dS = p * (dP - delta). Rows of the
// accumulators are keys (g, g + 8), columns are q rows. P^T and dS^T go
// out as A fragments over the q rows (k16 steps).
__device__ __forceinline__ void p_ds_fragments(
    float (&s)[kBlockM / 2], float (&dp)[kBlockM / 2],
    uint32_t (&pa)[kBlockM / 16][4], uint32_t (&da)[kBlockM / 16][4],
    const float* lse2, const float* delta, const bool (&key_ok)[2], int tg,
    float scale_log2) {
#pragma unroll
  for (int nt = 0; nt < kBlockM / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qc = nt * 8 + tg * 2 + (e & 1);
      const int idx = nt * 4 + e;
      const float p = key_ok[e >> 1]
          ? exp2f(fmaf(s[idx], scale_log2, -lse2[qc])) : 0.f;
      s[idx] = p;
      dp[idx] = p * (dp[idx] - delta[qc]);
    }
  }
#pragma unroll
  for (int kk = 0; kk < kBlockM / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
    }
  }
}

// dV += P^T dO and dK += dS^T Q: dO and Q MN-major B
template <int D>
__device__ __forceinline__ void issue_dv_dk(
    float (&dk)[D / 2], float (&dv)[D / 2],
    const uint32_t (&pa)[kBlockM / 16][4],
    const uint32_t (&da)[kBlockM / 16][4], const __nv_bfloat16* Qt,
    const __nv_bfloat16* dOt) {
  const uint64_t do_mdesc = make_desc(dOt, 128, kBlockM * 16);
  const uint64_t q_mdesc = make_desc(Qt, 128, kBlockM * 16);
#pragma unroll
  for (int kk = 0; kk < kBlockM / 16; ++kk) {
    wgmma_rs<D, 1>(dv, pa[kk], do_mdesc + ((kk * 256) >> 4), 1);
  }
#pragma unroll
  for (int kk = 0; kk < kBlockM / 16; ++kk) {
    wgmma_rs<D, 1>(dk, da[kk], q_mdesc + ((kk * 256) >> 4), 1);
  }
}

// dQ rows of this q tile, columns [kC0, kC0 + N), over the block's 128
// keys: A = dS (MN-major from the dS^T tile), B = K (MN-major); the
// scaled f32 sums go through this warpgroup's staging tile dq_s ([64][N])
// and one bulk reduce-add into the scratch (rows past Sq are dropped)
template <int N, int kC0>
__device__ __forceinline__ void dq_part(const __nv_bfloat16* dSs,
                                        const __nv_bfloat16* Ks, float* dq_s,
                                        const CUtensorMap* dq_map,
                                        float scale, int b, int h, int m0,
                                        int wg, int warp, int lane,
                                        uint64_t* q_empty) {
  const int g = lane >> 2;
  const int tg = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  float dq[N / 2];
  const uint64_t ds_desc = make_desc(dSs, 128, kBlockN * 16);
  const uint64_t k_desc = make_desc(Ks + kC0 * kBlockN, 128, kBlockN * 16);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    wgmma_ss<N, 1, 1>(dq, ds_desc + ((kk * 256) >> 4),
                      k_desc + ((kk * 256) >> 4), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);
  if (lane == 0) mbar_arrive(q_empty);
  // the previous tile's reduce-add has read the staging tile
  if (leader) bulk_wait<0, true>();
  named_sync(2 + wg, 128);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = dq_s + (warp * 16 + g + 8 * r) * N + tg * 2;
#pragma unroll
    for (int dt = 0; dt < N / 8; ++dt) {
      *reinterpret_cast<float2*>(row + dt * 8) = make_float2(
          dq[dt * 4 + 2 * r] * scale, dq[dt * 4 + 2 * r + 1] * scale);
    }
  }
  fence_proxy_async();
  named_sync(2 + wg, 128);
  if (leader) {
    tma_reduce_add_4d(dq_map, dq_s, kC0, m0, h, b);
    bulk_commit();
  }
}

template <int D, bool kWithDq>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap domap,
                      const __grid_constant__ CUtensorMap omap,
                      const __grid_constant__ CUtensorMap dq0_map,
                      const __grid_constant__ CUtensorMap dq1_map,
                      const BwdArgs a) {
  using T = Bwd<D, kWithDq>;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + T::kKElems;
  __nv_bfloat16* Qs = Vs + T::kKElems;                 // [kStages] tiles
  __nv_bfloat16* dOs = Qs + kStages * T::kQElems;      // [kStages] tiles
  __nv_bfloat16* Os = dOs + kStages * T::kQElems;      // [kStages] tiles
  __nv_bfloat16* dSs = Os + kStages * T::kOElems;      // [q chunk][key][8]
  float* dq_s = reinterpret_cast<float*>(smem + T::kDqOffset);   // per wg
  float* lse2_s = reinterpret_cast<float*>(smem + T::kStatOffset);
  float* delta_s = lse2_s + kStages * kBlockM;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + T::kBarOffset);
  uint64_t* in_full = kv_full + 1;      // the stage's tiles have arrived
  uint64_t* q_full = in_full + kStages;  // and its lse, delta are written
  uint64_t* q_empty = q_full + kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int n0 = blockIdx.x * kBlockN;
  const int n_qt = (a.Sq + kBlockM - 1) / kBlockM;

  // the padding chunks of K, V and every Q / dO stage: zero once
  if constexpr (T::kChunksP > T::kChunks) {
    constexpr int kPadN = (T::kChunksP - T::kChunks) * kBlockN;   // uint4s
    constexpr int kPadM = (T::kChunksP - T::kChunks) * kBlockM;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < kPadN; i += kThreads) {
      reinterpret_cast<uint4*>(Ks + T::kChunks * kBlockN * 8)[i] = z;
      reinterpret_cast<uint4*>(Vs + T::kChunks * kBlockN * 8)[i] = z;
    }
    for (int i = tid; i < 2 * kStages * kPadM; i += kThreads) {
      const int t = i / kPadM;   // Q stages, then dO stages (adjacent)
      reinterpret_cast<uint4*>(Qs + t * T::kQElems +
                               T::kChunks * kBlockM * 8)[i - t * kPadM] = z;
    }
    fence_proxy_async();
  }
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&in_full[st], 1);
      mbar_init(&q_full[st], kStatThreads);
      mbar_init(&q_empty[st], 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    setmaxnreg_dec<T::kProducerRegs>();
    const int t = tid - 256;
    if (t == 0) {
      // TMA: K and V once, then Q, dO (and o) per q tile
      mbar_arrive_expect_tx(kv_full, 2 * T::kChunks * kBlockN * 16);
      tma_load_tile<D, kBlockN>(Ks, &kmap, kv_full, n0, h, b);
      tma_load_tile<D, kBlockN>(Vs, &vmap, kv_full, n0, h, b);
      for (int i = 0; i < n_qt; ++i) {
        const int st = i % kStages;
        mbar_wait(&q_empty[st], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&in_full[st],
                              (kWithDq ? 3 : 2) * T::kChunks * kBlockM * 16);
        tma_load_tile<D, kBlockM>(Qs + st * T::kQElems, &qmap, &in_full[st],
                                  i * kBlockM, h, b);
        tma_load_tile<D, kBlockM>(dOs + st * T::kQElems, &domap,
                                  &in_full[st], i * kBlockM, h, b);
        if constexpr (kWithDq) {
          tma_load_tile<D, kBlockM>(Os + st * T::kOElems, &omap,
                                    &in_full[st], i * kBlockM, h, b);
        }
      }
    } else if (t >= 32 && t < 32 + kStatThreads) {
      // lse (log2 units) and delta of q row r of each tile; rows at or
      // past Sq get lse = +inf (so p = 0)
      const int r = t - 32;
      const long long row_base = static_cast<long long>(blockIdx.y) * a.Sq;
      for (int i = 0; i < n_qt; ++i) {
        const int st = i % kStages;
        const int row = i * kBlockM + r;
        const float lse2 = row < a.Sq ? a.lse[row_base + row] * kLog2e
                                      : INFINITY;
        float delta = 0.f;
        if constexpr (!kWithDq) {
          if (row < a.Sq) delta = a.delta[row_base + row];
        }
        // the stage is free (its Q, dO are loaded after the release)
        mbar_wait(&in_full[st], (i / kStages) & 1);
        if constexpr (kWithDq) {
          const __nv_bfloat16* orow = Os + st * T::kOElems + r * 8;
          const __nv_bfloat16* drow = dOs + st * T::kQElems + r * 8;
#pragma unroll
          for (int c = 0; c < T::kChunks; ++c) {
            const int off = c * kBlockM * 8;
            const uint4 ov = *reinterpret_cast<const uint4*>(orow + off);
            const uint4 dv = *reinterpret_cast<const uint4*>(drow + off);
            const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
            const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 of = __bfloat1622float2(o2[e]);
              const float2 df = __bfloat1622float2(d2[e]);
              delta += of.x * df.x + of.y * df.y;
            }
          }
        }
        lse2_s[st * kBlockM + r] = lse2;
        delta_s[st * kBlockM + r] = delta;   // rows past Sq: 0
        mbar_arrive(&q_full[st]);
      }
    }
  } else {
    // consumer warpgroup wg: keys [n0 + 64 wg, n0 + 64 wg + 64)
    setmaxnreg_inc<T::kConsumerRegs>();
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tg = lane & 3;
    const int kr = wg * 64 + warp * 16 + g;   // first key row of the thread
    const bool key_ok[2] = {n0 + kr < a.Sk, n0 + kr + 8 < a.Sk};

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_full, 0);
    if constexpr (!T::kKvRegs) {
      // K, V: K-major A, this warpgroup's 64 rows; chunk stride along D
      const uint64_t k_desc = make_desc(Ks + wg * 64 * 8, kBlockN * 16, 128);
      const uint64_t v_desc = make_desc(Vs + wg * 64 * 8, kBlockN * 16, 128);
      for (int i = 0; i < n_qt; ++i) {
        const int st = i % kStages;
        mbar_wait(&in_full[st], (i / kStages) & 1);
        mbar_wait(&q_full[st], (i / kStages) & 1);
        const __nv_bfloat16* Qt = Qs + st * T::kQElems;
        const __nv_bfloat16* dOt = dOs + st * T::kQElems;

        float s[kBlockM / 2], dp[kBlockM / 2];
        uint32_t pa[kBlockM / 16][4], da[kBlockM / 16][4];
        wgmma_fence();
        issue_st_dpt<D>(s, dp, k_desc, v_desc, Qt, dOt);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        p_ds_fragments(s, dp, pa, da, lse2_s + st * kBlockM,
                       delta_s + st * kBlockM, key_ok, tg, a.scale_log2);

        fence_regs(dk);
        fence_regs(dv);
        wgmma_fence();
        issue_dv_dk<D>(dk, dv, pa, da, Qt, dOt);
        wgmma_commit();

        if constexpr (kWithDq) {
          // dS^T (bf16) into shared memory, chunked by q: both warpgroups
          // are done with the previous tile's dQ products first, and both
          // have written before either reads
          named_sync(1, 256);
#pragma unroll
          for (int nt = 0; nt < kBlockM / 8; ++nt) {
            __nv_bfloat16* dst = dSs + nt * kBlockN * 8 + kr * 8 + tg * 2;
            *reinterpret_cast<uint32_t*>(dst) = da[nt >> 1][(nt & 1) * 2];
            *reinterpret_cast<uint32_t*>(dst + 64) =
                da[nt >> 1][(nt & 1) * 2 + 1];
          }
          fence_proxy_async();
          named_sync(1, 256);

          // dQ of this q tile; the wait inside also completes dV and dK,
          // so the stage is released there
          if (wg == 0) {
            dq_part<dq_cols0(D), 0>(dSs, Ks, dq_s, &dq0_map, a.scale, b, h,
                                    i * kBlockM, wg, warp, lane,
                                    &q_empty[st]);
          } else {
            dq_part<D - dq_cols0(D), dq_cols0(D)>(
                dSs, Ks, dq_s + kBlockM * dq_cols0(D), &dq1_map, a.scale, b,
                h, i * kBlockM, wg, warp, lane, &q_empty[st]);
          }
        } else {
          // the dk/dv pass above head dim 72: dV and dK of this tile are
          // done with its stage
          wgmma_wait<0>();
          if (lane == 0) mbar_arrive(&q_empty[st]);
        }
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pa);
        fence_regs(da);
      }
      // the last reduce-adds are done before the block (and its shared
      // memory) goes
      if (kWithDq && (tid & 127) == 0) bulk_wait<0, false>();
    } else {
      // S^T and dP^T of q tile i + 1 go with dV and dK of tile i; one
      // wait per tile completes both, then tile i's stage is released.
      // The warpgroups take turns issuing (two named barriers hand the
      // turn back and forth), so one's exponentials overlap the other's
      // products: turn 0 issues S^T and dP^T of tile 0, turn i + 1 the
      // products of iteration i.
      float s[kBlockM / 2], dp[kBlockM / 2];
      uint32_t pa[kBlockM / 16][4], da[kBlockM / 16][4];
      // K and V of this warpgroup's keys as A fragments (rows kr, kr + 8;
      // columns 2 tg, +1 and 2 tg + 8, +9 of each k16 step), read once
      uint32_t kf[T::kSteps][4], vf[T::kSteps][4];
#pragma unroll
      for (int kk = 0; kk < T::kSteps; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int off = (2 * kk + (r >> 1)) * kBlockN * 8 +
                          (kr + 8 * (r & 1)) * 8 + 2 * tg;
          kf[kk][r] = *reinterpret_cast<const uint32_t*>(Ks + off);
          vf[kk][r] = *reinterpret_cast<const uint32_t*>(Vs + off);
        }
      }
      if (wg == 1) named_arrive(1, 256);   // warpgroup 0 goes first
      mbar_wait(&in_full[0], 0);
      mbar_wait(&q_full[0], 0);
      named_sync(1 + wg, 256);
      wgmma_fence();
      issue_st_dpt_rs<D>(s, dp, kf, vf, Qs, dOs);
      wgmma_commit();
      named_arrive(2 - wg, 256);
      for (int i = 0; i < n_qt; ++i) {
        const int st = i % kStages;
        const int sn = (i + 1) % kStages;
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pa);
        fence_regs(da);
        if (i > 0 && lane == 0) mbar_arrive(&q_empty[(i - 1) % kStages]);
        p_ds_fragments(s, dp, pa, da, lse2_s + st * kBlockM,
                       delta_s + st * kBlockM, key_ok, tg, a.scale_log2);
        fence_regs(pa);
        fence_regs(da);
        if (i + 1 < n_qt) {
          mbar_wait(&in_full[sn], ((i + 1) / kStages) & 1);
          mbar_wait(&q_full[sn], ((i + 1) / kStages) & 1);
        }
        named_sync(1 + wg, 256);
        wgmma_fence();
        issue_dv_dk<D>(dk, dv, pa, da, Qs + st * T::kQElems,
                       dOs + st * T::kQElems);
        if (i + 1 < n_qt) {
          issue_st_dpt_rs<D>(s, dp, kf, vf, Qs + sn * T::kQElems,
                             dOs + sn * T::kQElems);
        }
        wgmma_commit();
        if (wg == 0 || i + 1 < n_qt) named_arrive(2 - wg, 256);
      }
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
    }

    // dK (scaled) and dV of this thread's keys; [B, Sk, H, D] contiguous
    const long long rs = static_cast<long long>(a.H) * D;
    const long long base = (static_cast<long long>(b) * a.Sk * a.H + h) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!key_ok[r]) continue;
      const long long off = base + (n0 + kr + 8 * r) * rs;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int col = dt * 8 + tg * 2;
        *reinterpret_cast<uint32_t*>(a.dk + off + col) = pack_bf16(
            dk[dt * 4 + 2 * r] * a.scale, dk[dt * 4 + 2 * r + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(a.dv + off + col) =
            pack_bf16(dv[dt * 4 + 2 * r], dv[dt * 4 + 2 * r + 1]);
      }
    }
  }
}

// ---- head dim 256 (flash_bwd_wide_kernel) -------------------------------

constexpr int kWideD = 256;
constexpr int kWideN = 64;       // keys per block
constexpr int kWideCols = 128;   // dK, dV (and dQ) columns per warpgroup

template <bool kWithDq>
struct Wide {
  static constexpr int kStages = 2;                       // Q / dO ring depth
  static constexpr int kChunks = kWideD / 8;
  static constexpr int kKElems = kChunks * kWideN * 8;    // K or V
  static constexpr int kQElems = kChunks * kBlockM * 8;   // Q or dO stage
  static constexpr int kDsElems = kWithDq ? kBlockM * kWideN : 0;   // dS^T
  static constexpr int kStatOffset =
      2 * (2 * kKElems + 2 * kStages * kQElems + kDsElems);
  static constexpr int kBarOffset = kStatOffset + 4 * 2 * kStages * kBlockM;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 3 * kStages);
};

template <bool kWithDq>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wide_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap domap,
                      const BwdArgs a) {
  using T = Wide<kWithDq>;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + T::kKElems;
  __nv_bfloat16* Qs = Vs + T::kKElems;                 // [kStages] tiles
  __nv_bfloat16* dOs = Qs + kStages * T::kQElems;      // [kStages] tiles
  __nv_bfloat16* dSs = dOs + kStages * T::kQElems;     // [q chunk][key][8]
  float* lse2_s = reinterpret_cast<float*>(smem + T::kStatOffset);
  float* delta_s = lse2_s + kStages * kBlockM;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + T::kBarOffset);
  uint64_t* in_full = kv_full + 1;       // the stage's Q, dO have arrived
  uint64_t* q_full = in_full + kStages;  // and its lse, delta are written
  uint64_t* q_empty = q_full + kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int n0 = blockIdx.x * kWideN;
  const int n_qt = (a.Sq + kBlockM - 1) / kBlockM;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&in_full[st], 1);
      mbar_init(&q_full[st], kStatThreads);
      mbar_init(&q_empty[st], 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // the producer reads o from device memory for delta: 24 registers
    // spill there, 32 do not (the consumers keep 232)
    setmaxnreg_dec<32>();
    const int t = tid - 256;
    if (t == 0) {
      // TMA: K and V once, then Q and dO per q tile
      mbar_arrive_expect_tx(kv_full, 2 * T::kChunks * kWideN * 16);
      tma_load_tile<kWideD, kWideN>(Ks, &kmap, kv_full, n0, h, b);
      tma_load_tile<kWideD, kWideN>(Vs, &vmap, kv_full, n0, h, b);
      for (int i = 0; i < n_qt; ++i) {
        const int st = i % kStages;
        mbar_wait(&q_empty[st], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&in_full[st], 2 * T::kChunks * kBlockM * 16);
        tma_load_tile<kWideD, kBlockM>(Qs + st * T::kQElems, &qmap,
                                       &in_full[st], i * kBlockM, h, b);
        tma_load_tile<kWideD, kBlockM>(dOs + st * T::kQElems, &domap,
                                       &in_full[st], i * kBlockM, h, b);
      }
    } else if (t >= 32 && t < 32 + kStatThreads) {
      // lse (log2 units) and delta of q row r of each tile; rows at or
      // past Sq get lse = +inf (so p = 0) and delta 0
      const int r = t - 32;
      const long long row_base = static_cast<long long>(blockIdx.y) * a.Sq;
      for (int i = 0; i < n_qt; ++i) {
        const int st = i % kStages;
        const int row = i * kBlockM + r;
        const float lse2 = row < a.Sq ? a.lse[row_base + row] * kLog2e
                                      : INFINITY;
        float delta = 0.f;
        if constexpr (!kWithDq) {
          if (row < a.Sq) delta = a.delta[row_base + row];
        }
        mbar_wait(&in_full[st], (i / kStages) & 1);
        if constexpr (kWithDq) {
          // rowsum(dO * o): dO from the stage, o from device memory
          if (row < a.Sq) {
            const __nv_bfloat16* orow =
                a.o + b * a.osb + row * a.oss + h * a.osh;
            const __nv_bfloat16* drow = dOs + st * T::kQElems + r * 8;
#pragma unroll 1
            for (int c = 0; c < T::kChunks; ++c) {
              const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
              const uint4 dv = *reinterpret_cast<const uint4*>(
                  drow + c * kBlockM * 8);
              const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
              const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 of = __bfloat1622float2(o2[e]);
                const float2 df = __bfloat1622float2(d2[e]);
                delta += of.x * df.x + of.y * df.y;
              }
            }
          }
        }
        lse2_s[st * kBlockM + r] = lse2;
        delta_s[st * kBlockM + r] = delta;
        mbar_arrive(&q_full[st]);
      }
    }
  } else {
    // consumer warpgroup wg: all 64 keys, columns [c0, c0 + 128)
    setmaxnreg_inc<232>();
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tg = lane & 3;
    const int kr = warp * 16 + g;     // first key row of the thread
    const int c0 = wg * kWideCols;
    const bool key_ok[2] = {n0 + kr < a.Sk, n0 + kr + 8 < a.Sk};

    float dk[kWideCols / 2], dv[kWideCols / 2];
#pragma unroll
    for (int i = 0; i < kWideCols / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_full, 0);
    // K, V: K-major A over the block's 64 keys; chunk stride along D
    const uint64_t k_desc = make_desc(Ks, kWideN * 16, 128);
    const uint64_t v_desc = make_desc(Vs, kWideN * 16, 128);
    for (int i = 0; i < n_qt; ++i) {
      const int st = i % kStages;
      mbar_wait(&in_full[st], (i / kStages) & 1);
      mbar_wait(&q_full[st], (i / kStages) & 1);
      const __nv_bfloat16* Qt = Qs + st * T::kQElems;
      const __nv_bfloat16* dOt = dOs + st * T::kQElems;

      float s[kBlockM / 2], dp[kBlockM / 2];
      uint32_t pa[kBlockM / 16][4], da[kBlockM / 16][4];
      wgmma_fence();
      issue_st_dpt<kWideD, kWideN>(s, dp, k_desc, v_desc, Qt, dOt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      p_ds_fragments(s, dp, pa, da, lse2_s + st * kBlockM,
                     delta_s + st * kBlockM, key_ok, tg, a.scale_log2);

      // dV += P^T dO and dK += dS^T Q over this warpgroup's columns
      fence_regs(dk);
      fence_regs(dv);
      wgmma_fence();
      issue_dv_dk<kWideCols>(dk, dv, pa, da, Qt + c0 * kBlockM,
                             dOt + c0 * kBlockM);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(da);
      if (lane == 0) mbar_arrive(&q_empty[st]);   // the stage is read

      if constexpr (kWithDq) {
        // dS^T (bf16) into shared memory, chunked by q (both warpgroups
        // hold the same dS^T; warpgroup 0 writes it), once both are done
        // with the previous tile's dQ products
        named_sync(1, 256);
        if (wg == 0) {
#pragma unroll
          for (int nt = 0; nt < kBlockM / 8; ++nt) {
            __nv_bfloat16* dst = dSs + nt * kWideN * 8 + kr * 8 + tg * 2;
            *reinterpret_cast<uint32_t*>(dst) = da[nt >> 1][(nt & 1) * 2];
            *reinterpret_cast<uint32_t*>(dst + 64) =
                da[nt >> 1][(nt & 1) * 2 + 1];
          }
          fence_proxy_async();
        }
        named_sync(1, 256);
        // dQ[:, c0 : c0 + 128] of this q tile = dS K, 64 columns at a time
        // (all 128 beside dK and dV spill): dS MN-major from the dS^T tile,
        // K MN-major; added to the scratch (rows past Sq dropped)
        const uint64_t ds_desc = make_desc(dSs, 128, kWideN * 16);
#pragma unroll 1
        for (int half = 0; half < 2; ++half) {
          const int cq = c0 + half * (kWideCols / 2);
          float dq[kWideCols / 4];
          const uint64_t kq_desc = make_desc(Ks + cq * kWideN, 128,
                                             kWideN * 16);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kWideN / 16; ++kk) {
            wgmma_ss<kWideCols / 2, 1, 1>(dq, ds_desc + ((kk * 256) >> 4),
                                          kq_desc + ((kk * 256) >> 4),
                                          kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = i * kBlockM + warp * 16 + g + 8 * r;
            if (row >= a.Sq) continue;
            float* dst = a.dq + ((static_cast<long long>(b) * a.Sq + row) *
                                 a.H + h) * kWideD + cq + tg * 2;
#pragma unroll
            for (int dt = 0; dt < kWideCols / 16; ++dt) {
              atomicAdd(dst + dt * 8, dq[dt * 4 + 2 * r] * a.scale);
              atomicAdd(dst + dt * 8 + 1, dq[dt * 4 + 2 * r + 1] * a.scale);
            }
          }
        }
      }
    }

    // dK (scaled) and dV of this thread's keys and columns; [B, Sk, H, D]
    // contiguous
    const long long rs = static_cast<long long>(a.H) * kWideD;
    const long long base =
        (static_cast<long long>(b) * a.Sk * a.H + h) * kWideD + c0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!key_ok[r]) continue;
      const long long off = base + (n0 + kr + 8 * r) * rs;
#pragma unroll
      for (int dt = 0; dt < kWideCols / 8; ++dt) {
        const int col = dt * 8 + tg * 2;
        *reinterpret_cast<uint32_t*>(a.dk + off + col) = pack_bf16(
            dk[dt * 4 + 2 * r] * a.scale, dk[dt * 4 + 2 * r + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(a.dv + off + col) =
            pack_bf16(dv[dt * 4 + 2 * r], dv[dt * 4 + 2 * r + 1]);
      }
    }
  }
}

template <int D, bool kWithDq>
int launch(const CUtensorMap (&maps)[7], const BwdArgs& a, int B,
           cudaStream_t st) {
  constexpr int smem = Bwd<D, kWithDq>::kSmem;
  const int err = allow_smem<flash_bwd_sm90_kernel<D, kWithDq>>(smem);
  if (err != 0) return err;
  const dim3 grid((a.Sk + kBlockN - 1) / kBlockN, B * a.H);
  flash_bwd_sm90_kernel<D, kWithDq><<<grid, kThreads, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWithDq>
int launch_wide(const CUtensorMap (&maps)[7], const BwdArgs& a, int B,
                cudaStream_t st) {
  constexpr int smem = Wide<kWithDq>::kSmem;
  const int err = allow_smem<flash_bwd_wide_kernel<kWithDq>>(smem);
  if (err != 0) return err;
  const dim3 grid((a.Sk + kWideN - 1) / kWideN, B * a.H);
  flash_bwd_wide_kernel<kWithDq><<<grid, kThreads, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return static_cast<int>(cudaGetLastError());
}

// the head dims with an instance (the wrapper zero-pads any other D up to
// the next one: ops/flash_attention.py:kernel_head_dim)
bool head_dim_ok(int D) {
  return D == 64 || D == 72 || D == 80 || D == 96 || D == 128 || D == 256;
}

template <bool kWithDq>
int launch_d(int D, const CUtensorMap (&maps)[7], const BwdArgs& a, int B,
             cudaStream_t st) {
  switch (D) {
    case 64: return launch<64, kWithDq>(maps, a, B, st);
    case 72: return launch<72, kWithDq>(maps, a, B, st);
    case 80: return launch<80, kWithDq>(maps, a, B, st);
    case 96: return launch<96, kWithDq>(maps, a, B, st);
    case 128: return launch<128, kWithDq>(maps, a, B, st);
    default: return launch_wide<kWithDq>(maps, a, B, st);
  }
}

// the tensor maps of k, v, q and dout (bf16 chunks), then, with o below
// head dim 256, those of o and of dq's two column blocks (f32); the maps a
// variant does not read are copies of the first
int encode_maps(CUtensorMap (&maps)[7], const void* q, const void* k,
                const void* v, const void* o, const void* dout, void* dq,
                int B, int H, int Sq, int Sk, int D, long long qsb,
                long long qss, long long qsh, long long ksb, long long kss,
                long long ksh, long long vsb, long long vss, long long vsh,
                long long osb, long long oss, long long osh, long long dosb,
                long long doss, long long dosh) {
  const int kv_rows = D == kWideD ? kWideN : kBlockN;
  int err = encode_bshd(&maps[0], k, false, B, Sk, H, D, ksb, kss, ksh, 8,
                        kv_rows);
  if (err == 0) {
    err = encode_bshd(&maps[1], v, false, B, Sk, H, D, vsb, vss, vsh, 8,
                      kv_rows);
  }
  if (err == 0) {
    err = encode_bshd(&maps[2], q, false, B, Sq, H, D, qsb, qss, qsh, 8,
                      kBlockM);
  }
  if (err == 0) {
    err = encode_bshd(&maps[3], dout, false, B, Sq, H, D, dosb, doss, dosh, 8,
                      kBlockM);
  }
  if (err != 0 || o == nullptr || D == kWideD) {
    for (int i = 4; i < 7; ++i) maps[i] = maps[0];
    return err;
  }
  const int dq0 = dq_cols0(D);
  const long long hd = static_cast<long long>(H) * D;
  err = encode_bshd(&maps[4], o, false, B, Sq, H, D, osb, oss, osh, 8,
                    kBlockM);
  if (err == 0) {
    err = encode_bshd(&maps[5], dq, true, B, Sq, H, D, Sq * hd, hd, D, dq0,
                      kBlockM);
  }
  if (err == 0) {
    err = encode_bshd(&maps[6], dq, true, B, Sq, H, D, Sq * hd, hd, D,
                      D - dq0, kBlockM);
  }
  return err;
}

}  // namespace

// q, o, dout [B, Sq, H, D], k/v [B, Sk, H, D]: bf16, strides in elements,
// last dim contiguous, strides multiples of 8 and bases 16-byte aligned
// (TMA); lse f32 [B, H, Sq] contiguous; D 64, 72, 80, 96, 128 or 256.
// Both write bf16 dk, dv
// [B, Sk, H, D] (contiguous). flash_attn_bwd adds dq into a zeroed f32
// [B, Sq, H, D] buffer (delta unused); flash_attn_bwd_dkv reads delta,
// f32 [B, H, Sq] contiguous, as the dq pass wrote it (o and dq unused).
// Each returns the CUDA error code of the tensor map encoding or of the
// launch (0 on success).
extern "C" int topiaxl_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Sq, int Sk, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, long long dosb,
    long long doss, long long dosh, float scale, void* stream) {
  (void)delta;
  if (!head_dim_ok(D)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[7];
  const int err = encode_maps(maps, q, k, v, o, dout, dq, B, H, Sq, Sk, D,
                              qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                              osb, oss, osh, dosb, doss, dosh);
  if (err != 0) return err;
  BwdArgs a;
  a.lse = static_cast<const float*>(lse);
  a.delta = nullptr;
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.dq = static_cast<float*>(dq);
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.osb = osb;
  a.oss = oss;
  a.osh = osh;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_d<true>(D, maps, a, B, st);
}

extern "C" int topiaxl_flash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Sq, int Sk, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, long long dosb,
    long long doss, long long dosh, float scale, void* stream) {
  (void)o;
  (void)dq;
  if (!head_dim_ok(D)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[7];
  const int err = encode_maps(maps, q, k, v, nullptr, dout, nullptr, B, H,
                              Sq, Sk, D, qsb, qss, qsh, ksb, kss, ksh, vsb,
                              vss, vsh, osb, oss, osh, dosb, doss, dosh);
  if (err != 0) return err;
  BwdArgs a;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.dq = nullptr;
  a.o = nullptr;
  a.osb = a.oss = a.osh = 0;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_d<false>(D, maps, a, B, st);
}
