// Flash-attention backward for Hopper (sm_90a), KV-major: bf16 q, k, v,
// dO in, f32 logsumexp (lse) from the forward; bf16 dk, dv out. Two
// compile-time variants of one kernel:
//   * the single pass (flash_attn_bwd, kWithDq): also reads o and adds dq
//     into a zeroed f32 [B, Sq, H, D] buffer. Replaces the TPU kernel
//     topiaxl/ops/flash_attention.py:_flash_bwd_fused_kernel (:369), the
//     backward taken when the keys fit one block (Sk <= 2048: the DiT's
//     self- and cross-attention), and at head dims up to 72 and 129-256
//     at every Sk, because the card measured it faster than the pair there
//     (ops/flash_attention.py:bwd_form). At head dims 64 and 72 it runs a
//     loop of its own, flash_bwd_overlap_kernel (below);
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
// DiT's shapes. The design (flash_bwd_sm90_kernel: the dk/dv pass, and
// the single pass at 80-128; the overlapped loop at 64 and 72 keeps its
// blocks, tiles and products, below):
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
//     warpgroups split dQ's columns (dq_cols0), so each dQ element of a
//     (KV tile, q tile) pair is added once; dQ, a
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
//   * head dims 129-256 (padded to 256) have a kernel of their own,
//     flash_bwd_wide_kernel, both variants. dK and dV of 64 keys at 256
//     columns would take 256 registers a thread in one warpgroup, so a
//     block owns 64 keys and its two consumer warpgroups split the columns,
//     each accumulating dK and dV over its 128 (128 registers a thread).
//     The rest of the design keeps each product once a block and the
//     tensor cores fed:
//       - S^T = K Q^T and dP^T = V dO^T are split by queries: each
//         warpgroup computes its 32 of the q tile's 64 (m64n32, K and V
//         K-major A over D), so the block runs each of the five products
//         once; P^T and dS^T (bf16, 8 KiB each, two buffers so that one
//         barrier a tile orders them) pass through shared memory, where
//         dV += P^T dO and dK += dS^T Q over a warpgroup's 128 columns
//         read all 64 queries (m64n128, A from shared memory);
//       - dQ = dS K (single pass) in two 64-column halves a warpgroup,
//         staged as f32 in the warpgroup's own boxes of the spent Q/dO
//         stage (32-column boxes, 128-byte swizzle) and added to the f32
//         scratch by four bulk TMA reduce-adds a tile, with no atomic per
//         element; the stage goes back to the producer once the
//         reduce-adds have read it, and the second half runs beside the
//         next tile's S^T and dP^T;
//       - delta = rowsum(dO * o) comes from a pass of its own ahead of the
//         single pass (flash_bwd_delta_kernel, one warp a row), as the
//         dk/dv pass reads it from the dq pass's scratch: read by the
//         producer in the kernel, o took a device-memory round trip a row
//         and held the consumers up;
//       - the dk/dv pass queues S^T and dP^T of tile i + 1 behind dV and
//         dK of tile i;
//       - K, V, Q and dO arrive in 64-column boxes with the 128-byte
//         swizzle (four a tile), the loop-invariant K and V descriptors
//         kept out of registers across the loop (opaque_desc);
//   * below 256 the tiles use the no-swizzle core-matrix layout of
//     sm90.cuh, so head dim 72 needs no swizzle span; the contraction over
//     D runs to 80, with the 10th chunk of K, V, Q and dO zeroed once and
//     never loaded; the [B, S, H, D] strides go into tensor maps, so the
//     DiT's qkv.unbind(2) views are read without a copy.
//
// The single pass at head dims 64 and 72 (flash_bwd_overlap_kernel, the
// "overlapped" loop of ops/flash_attention.py:bwd_loop). The loop above
// runs each q tile in series (S^T and dP^T, wait, exponentials, dV and dK,
// the dS^T exchange, dQ, wait, staging, reduce-add), about 5,000 cycles a
// 64 x 128 tile where its products need about 1,300 at the dense bf16
// rate. This loop keeps the same block, tiles, products and numerics
// (dK and dV bitwise the serial loop's; dQ's sums over a block the same,
// added once an element) and overlaps them:
//   * ping-pong turns: the two consumer warpgroups take turns issuing
//     their products (two named barriers), so one's exponentials and dQ
//     staging run under the other's products. A turn issues dV, dK of q
//     tile i, S^T, dP^T of tile i + 1 and a dQ, and the warpgroup waits for
//     them before its back edge: a wgmma in flight across the loop's back
//     edge, a wgmma left out at run time inside a turn, or a branch between
//     two wgmma sequences each made ptxas serialise every wgmma of the loop
//     (C7514 / C7515), at about 100 cycles a wgmma;
//   * dQ without a barrier across the warpgroups: dS^T goes through one of
//     three shared-memory buffers, and warpgroup 1 issues dQ of tile i in
//     its turn i + 1, warpgroup 0 (a turn ahead of it) in its turn i + 2,
//     once both have written their rows; the turn barriers order the rows'
//     writes before those reads, and the reads before the writes of tile i
//     + 3. Both issue dQ 40 columns wide at 72 (warpgroup 1's first 8 are
//     warpgroup 0's last, added once), so that the two run one wgmma
//     sequence;
//   * the five accumulator chains of a turn (dV, dK, S^T, dP^T, dQ) are
//     issued interleaved by k16 step;
//   * each warp stages its 16 rows of a finished dQ (f32, the 32-column
//     boxes with the 128-byte swizzle, whose unswizzled rows would put the
//     8 rows of a store on the same banks) and adds them with its own bulk
//     reduce-add, so staging takes no barrier across the warpgroup;
//   * Q, dO and o arrive in the forward's split layout (flash_fwd_layout.
//     cuh): one 64-column box with the 128-byte swizzle and, at 72, one
//     8-column chunk, 2 (6 at 72) TMA boxes a tile where the chunked layout
//     took 24 (27); a four-stage ring; K and V stay chunked (loaded once a
//     block);
//   * exponentials by ex2.approx.ftz: exp2f's handling of results below
//     2^-126 took about a fifth of the loop's time.
// What bounds it now: the tensor cores, busy most of a turn pair (one
// warpgroup's products take about as long as the other's exponentials,
// dS^T and dQ staging); the products run at about half the dense rate
// (m64n64 and narrower, SS operands from shared memory). ptxas -v: 168
// registers (the launch's 65536 / 384; setmaxnreg gives the consumers 224,
// the producer 56), 0 bytes of spill, no wgmma serialised. On an H100
// 80GB HBM3 at 700 W (chip_smoke.py's ss_flow and flash_head_dims): 1.0865
// ms at 8 x 4096 x 1374 x 16 x 64 (the serial loop 1.99), 3.0938 at 8 x
// 4096 x 4096 x 16 x 64 (the pair 5.9692), 0.9253 / 0.6431 at 8 x 2048 x
// {2048, 1370} x 16 x 72 (the serial loop 1.4142 / 0.9736), 33-36% of the
// backward's four products' bound.

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
  // [B, H, Sq] contiguous: read by the dk/dv pass, and at head dim 256 by
  // the single pass too, after its delta pass wrote it
  const float* delta;
  __nv_bfloat16* dk;     // [B, Sk, H, D] contiguous
  __nv_bfloat16* dv;
  // head dim 256, the single pass: o and dO [B, Sq, H, D] at their
  // strides, which the delta pass reads (writing delta)
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  long long osb, oss, osh, dosb, doss, dosh;
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

// ---- head dims 64 and 72, the single pass (flash_bwd_overlap_kernel) ----

constexpr int kOvlStages = 4;   // Q / dO / o ring depth
constexpr int kOvlDsBufs = 3;   // dS^T tiles in flight (see the kernel)
constexpr int kSwBox = 64;      // bf16 columns of a swizzled box (128 bytes)

template <int D>
struct Ovl {
  static_assert(D == 64 || D == 72, "the overlapped loop's head dims");
  static constexpr int kTail = D - kSwBox;            // columns past the box
  static constexpr int kSteps = (D + 15) / 16;        // k16 steps over D
  static constexpr int kKBytes = 2 * kSteps * kBlockN * 16;   // K or V
  // a Q or dO stage: the box, then at 72 the tail chunk and a padding
  // chunk (zeroed once, never loaded: the fifth k16 step runs to 80)
  static constexpr int kQBytes = kBlockM * 2 * (kSwBox + (kTail ? 16 : 0));
  static constexpr int kOBytes = kBlockM * 2 * D;     // o: box and tail
  static constexpr int kStageBytes = 2 * kQBytes + kOBytes;
  static constexpr int kDsBytes = kBlockM * kBlockN * 2;      // one dS^T
  static constexpr int kQOffset = 2 * kKBytes;
  static constexpr int kDsOffset = kQOffset + kOvlStages * kStageBytes;
  static constexpr int kDqOffset = kDsOffset + kOvlDsBufs * kDsBytes;
  static constexpr int kStatOffset = kDqOffset + 4 * kBlockM * D;
  static constexpr int kBarOffset = kStatOffset + 4 * 2 * kOvlStages * kBlockM;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 3 * kOvlStages);
  static_assert(kQOffset % 1024 == 0 && kQBytes % 1024 == 0 &&
                    kOBytes % 1024 == 0,
                "every swizzled box 1024-byte aligned");
  static_assert(kSmem <= 232448, "shared memory a block can hold");
};

// rows [row0, row0 + 64) of head (b, h) into a split tile: the 64-column
// box (128-byte swizzle) from `map`, then at 72 the last 8 columns as one
// chunk from `chunk_map` (the chunked layout's map)
template <int D>
__device__ __forceinline__ void load_split(unsigned char* dst,
                                           const CUtensorMap* map,
                                           const CUtensorMap* chunk_map,
                                           uint64_t* bar, int row0, int h,
                                           int b) {
  tma_load_4d(dst, map, bar, 0, row0, h, b);
  if constexpr (D > kSwBox) {
    tma_load_4d(dst + kBlockM * 2 * kSwBox, chunk_map, bar, kSwBox, row0, h,
                b);
  }
}

// The products of the overlapped loop, one k16 step at a time. A wgmma
// that adds to the accumulator of the one before it waits for that one's
// latency (about 100 cycles on an H100, where an m64n64k16 takes 32 of
// the tensor cores' time), so a turn interleaves the k16 steps of its five
// accumulator chains (dV, dK, S^T, dP^T, dQ) and no step waits on the one
// issued just before it.

// k16 step kk of S^T = K Q^T and dP^T = V dO^T from split Q and dO tiles:
// K, V chunked K-major A (this warpgroup's 64 keys); Q, dO K-major B, the
// box (SBO 8 rows, a step 32 bytes into its rows) for the first four steps,
// at 72 the fifth on the tail and padding chunks (no swizzle, LBO one
// chunk)
template <int D>
__device__ __forceinline__ void st_dpt_step(float (&s)[kBlockM / 2],
                                            float (&dp)[kBlockM / 2],
                                            uint64_t k_desc, uint64_t v_desc,
                                            const unsigned char* Qt,
                                            const unsigned char* dOt,
                                            int kk) {
  const uint32_t a_off = (kk * 2 * kBlockN * 16) >> 4;
  if (kk < kSwBox / 16) {
    wgmma_ss<kBlockM, 0, 0>(s, k_desc + a_off,
                            make_desc_sw<128>(Qt, 16, 1024) + ((kk * 32) >> 4),
                            kk > 0);
    wgmma_ss<kBlockM, 0, 0>(dp, v_desc + a_off,
                            make_desc_sw<128>(dOt, 16, 1024) +
                                ((kk * 32) >> 4),
                            kk > 0);
  } else {
    wgmma_ss<kBlockM, 0, 0>(
        s, k_desc + a_off,
        make_desc(Qt + kBlockM * 2 * kSwBox, kBlockM * 16, 128), 1);
    wgmma_ss<kBlockM, 0, 0>(
        dp, v_desc + a_off,
        make_desc(dOt + kBlockM * 2 * kSwBox, kBlockM * 16, 128), 1);
  }
}

// k16 step kk (over the tile's q rows) of dV += P^T dO and dK += dS^T Q
// from split tiles, dO and Q MN-major B: the box (SBO 8 rows, a step 16
// rows) into the first 32 accumulator registers, at 72 the tail chunk (LBO
// 8 rows, SBO one chunk) into the last 4, on the same A fragments
template <int D>
__device__ __forceinline__ void dv_dk_step(
    float (&dk)[D / 2], float (&dv)[D / 2],
    const uint32_t (&pa)[kBlockM / 16][4],
    const uint32_t (&da)[kBlockM / 16][4], const unsigned char* Qt,
    const unsigned char* dOt, int kk) {
  using Box = float[kSwBox / 2];
  using Tail = float[(D - kSwBox) / 2 + (D == kSwBox)];
  const uint32_t box_off = (kk * 16 * 128) >> 4;
  wgmma_rs<kSwBox, 1>(*reinterpret_cast<Box*>(&dv[0]), pa[kk],
                      make_desc_sw<128>(dOt, kBlockM * 128, 1024) + box_off,
                      1);
  wgmma_rs<kSwBox, 1>(*reinterpret_cast<Box*>(&dk[0]), da[kk],
                      make_desc_sw<128>(Qt, kBlockM * 128, 1024) + box_off,
                      1);
  if constexpr (D > kSwBox) {
    const uint32_t tail_off = (kk * 256) >> 4;
    wgmma_rs<D - kSwBox, 1>(
        *reinterpret_cast<Tail*>(&dv[kSwBox / 2]), pa[kk],
        make_desc(dOt + kBlockM * 2 * kSwBox, 128, kBlockM * 16) + tail_off,
        1);
    wgmma_rs<D - kSwBox, 1>(
        *reinterpret_cast<Tail*>(&dk[kSwBox / 2]), da[kk],
        make_desc(Qt + kBlockM * 2 * kSwBox, 128, kBlockM * 16) + tail_off,
        1);
  }
}

// k16 step kk (over the block's 128 keys) of N dQ columns of one q tile:
// A = dS (MN-major from a dS^T tile), B = K's N columns from Kc (MN-major,
// chunked)
template <int N>
__device__ __forceinline__ void dq_step(float (&dq)[N / 2],
                                        const __nv_bfloat16* dSt,
                                        const __nv_bfloat16* Kc, int kk) {
  wgmma_ss<N, 1, 1>(dq, make_desc(dSt, 128, kBlockN * 16) + ((kk * 256) >> 4),
                    make_desc(Kc, 128, kBlockN * 16) + ((kk * 256) >> 4),
                    kk > 0);
}

// a turn of the overlapped loop: dV, dK of q tile i (stage Qt, dOt), S^T,
// dP^T of the next tile (Qn, dOn) and N dQ columns (from K's at Kc) of the
// tile whose dS^T is dSt, interleaved by k16 step. A turn issues the same
// products whatever the tile: a wgmma left out at run time, or a branch
// between two sequences, makes ptxas serialise every wgmma of the loop
// (C7515), so where a turn has no next tile or no dQ it issues them on
// data it discards
template <int D, int N>
__device__ __forceinline__ void issue_turn(
    float (&dk)[D / 2], float (&dv)[D / 2],
    const uint32_t (&pa)[kBlockM / 16][4],
    const uint32_t (&da)[kBlockM / 16][4], const unsigned char* Qt,
    const unsigned char* dOt, float (&s)[kBlockM / 2],
    float (&dp)[kBlockM / 2], uint64_t k_desc, uint64_t v_desc,
    const unsigned char* Qn, const unsigned char* dOn, float (&dq)[N / 2],
    const __nv_bfloat16* dSt, const __nv_bfloat16* Kc) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    if (kk < kBlockM / 16) dv_dk_step<D>(dk, dv, pa, da, Qt, dOt, kk);
    if (kk < (D + 15) / 16) st_dpt_step<D>(s, dp, k_desc, v_desc, Qn, dOn, kk);
    dq_step<N>(dq, dSt, Kc, kk);
  }
}

// p = exp(s * scale - lse) as p_ds_fragments computes it, with the
// exponential ex2.approx.ftz: exp2f's handling of results below 2^-126
// cost about a fifth of the loop's time. Those p flush to 0, where they
// would add less than 2^-126 |dO| to any sum; every other p has the bits
// of exp2f's
__device__ __forceinline__ void p_ds_fragments_ftz(
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
      float p;
      asm("ex2.approx.ftz.f32 %0, %1;"
          : "=f"(p) : "f"(fmaf(s[idx], scale_log2, -lse2[qc])));
      p = key_ok[e >> 1] ? p : 0.f;
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

// rows of a dQ staging box: each warp stages and adds its own 16 rows, so
// no barrier across the warpgroup
constexpr int kDqRows = 16;
// a staging box 32 columns wide (128-byte rows) takes the 128-byte
// swizzle: unswizzled, the 8 rows one store instruction writes would sit
// on the same banks
__host__ __device__ constexpr bool dq_swizzled(int N) { return N == 32; }

// the scaled f32 sums of a finished dQ, columns [kC0, kC0 + N) from its
// registers past the first kSkip 8-column tiles: this warp's 16 rows into
// its rows of the warpgroup's staging tile dq_s ([64][N]; at N 32 the
// 16-byte chunk c of row r at c ^ (r % 8)) and one bulk reduce-add into the
// scratch at q row m0 + 16 warp (rows past Sq are dropped); the rows are
// free once the warp's previous reduce-add has read them
template <int N, int kC0, int kSkip, int kRegs>
__device__ __forceinline__ void stage_dq(const float (&dq)[kRegs],
                                         float* dq_s,
                                         const CUtensorMap* dq_map,
                                         float scale, int b, int h, int m0,
                                         int warp, int lane) {
  const int g = lane >> 2;
  const int tg = lane & 3;
  float* rows = dq_s + warp * kDqRows * N;
  if (lane == 0) bulk_wait<0, true>();
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = rows + (g + 8 * r) * N;
#pragma unroll
    for (int dt = 0; dt < N / 8; ++dt) {
      const int i = (dt + kSkip) * 4 + 2 * r;
      const int col = dt * 8 + tg * 2;
      float* dst = dq_swizzled(N)
          ? row + ((((col >> 2) ^ g) << 2) | (col & 3)) : row + col;
      *reinterpret_cast<float2*>(dst) =
          make_float2(dq[i] * scale, dq[i + 1] * scale);
    }
  }
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) {
    tma_reduce_add_4d(dq_map, rows, kC0, m0 + warp * kDqRows, h, b);
    bulk_commit();
  }
}

// Head dims 64 and 72, the single pass (kWithDq), overlapped: see the
// header. maps: k, v (chunked), q, dO, o (8-column chunks: the tails), dq's
// two column blocks, then q, dO, o (64-column swizzled boxes).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_overlap_kernel(const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap qchunks,
                         const __grid_constant__ CUtensorMap dochunks,
                         const __grid_constant__ CUtensorMap ochunks,
                         const __grid_constant__ CUtensorMap dq0_map,
                         const __grid_constant__ CUtensorMap dq1_map,
                         const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap omap,
                         const BwdArgs a) {
  using T = Ovl<D>;
  constexpr int kStages = kOvlStages;
  constexpr int kN0 = dq_cols0(D);   // dQ columns of warpgroup 0
  constexpr int kN1 = D - kN0;       // and of warpgroup 1
  extern __shared__ __align__(1024) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + T::kKBytes);
  // stage st: Q, then dO, then o
  unsigned char* stages = smem + T::kQOffset;
  __nv_bfloat16* dSs = reinterpret_cast<__nv_bfloat16*>(smem + T::kDsOffset);
  float* dq_s = reinterpret_cast<float*>(smem + T::kDqOffset);   // per wg
  float* lse2_s = reinterpret_cast<float*>(smem + T::kStatOffset);
  float* delta_s = lse2_s + kStages * kBlockM;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + T::kBarOffset);
  uint64_t* in_full = kv_full + 1;      // the stage's tiles have arrived
  uint64_t* q_full = in_full + kStages;  // and its lse, delta are written
  uint64_t* q_empty = q_full + kStages;
  auto q_tile = [&](int st) { return stages + st * T::kStageBytes; };
  auto do_tile = [&](int st) { return q_tile(st) + T::kQBytes; };
  auto o_tile = [&](int st) { return q_tile(st) + 2 * T::kQBytes; };

  const int tid = threadIdx.x;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int n0 = blockIdx.x * kBlockN;
  const int n_qt = (a.Sq + kBlockM - 1) / kBlockM;
  check_smem_align(smem);
  // the warpgroup, broadcast from lane 0 so that ptxas sees it uniform
  // across the warp: branches on it around wgmma stay convergent
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  // the padding chunks of K, V and (72) of every Q / dO stage: zero once
  if constexpr (2 * T::kSteps > D / 8) {
    constexpr int kPadN = (2 * T::kSteps - D / 8) * kBlockN;   // uint4s
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < kPadN; i += kThreads) {
      reinterpret_cast<uint4*>(Ks + (D / 8) * kBlockN * 8)[i] = z;
      reinterpret_cast<uint4*>(Vs + (D / 8) * kBlockN * 8)[i] = z;
    }
    for (int i = tid; i < 2 * kStages * kBlockM; i += kThreads) {
      const int st = i / (2 * kBlockM);
      const int r = i - st * 2 * kBlockM;   // Q's rows, then dO's
      unsigned char* t = r < kBlockM ? q_tile(st) : do_tile(st);
      reinterpret_cast<uint4*>(t + kBlockM * 2 * (kSwBox + 8))[r % kBlockM] =
          z;
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

  if (wg == 2) {
    setmaxnreg_dec<56>();
    const int t = tid - 256;
    if (t == 0) {
      // TMA: K and V once (chunked), then Q, dO and o per q tile (split)
      mbar_arrive_expect_tx(kv_full, 2 * D * kBlockN * 2);
      tma_load_tile<D, kBlockN>(Ks, &kmap, kv_full, n0, h, b);
      tma_load_tile<D, kBlockN>(Vs, &vmap, kv_full, n0, h, b);
      for (int i = 0; i < n_qt; ++i) {
        const int st = i % kStages;
        mbar_wait(&q_empty[st], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&in_full[st], 3 * D * kBlockM * 2);
        load_split<D>(q_tile(st), &qmap, &qchunks, &in_full[st],
                      i * kBlockM, h, b);
        load_split<D>(do_tile(st), &domap, &dochunks, &in_full[st],
                      i * kBlockM, h, b);
        load_split<D>(o_tile(st), &omap, &ochunks, &in_full[st],
                      i * kBlockM, h, b);
      }
    } else if (t >= 32 && t < 32 + kStatThreads) {
      // lse (log2 units) and delta = rowsum(dO * o) of q row r of each
      // tile, the columns in order: the box's 16-byte chunk c of row r sits
      // at c ^ (r % 8), the tail's after the box. Rows at or past Sq get
      // lse = +inf (so p = 0) and, their o and dO read as zeros, delta 0
      const int r = t - 32;
      const long long row_base = static_cast<long long>(blockIdx.y) * a.Sq;
      for (int i = 0; i < n_qt; ++i) {
        const int st = i % kStages;
        const int row = i * kBlockM + r;
        const float lse2 = row < a.Sq ? a.lse[row_base + row] * kLog2e
                                      : INFINITY;
        float delta = 0.f;
        mbar_wait(&in_full[st], (i / kStages) & 1);
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          const int off = c < kSwBox / 8
              ? r * 128 + ((c ^ (r & 7)) << 4)
              : kBlockM * 2 * kSwBox + (c - kSwBox / 8) * kBlockM * 16 +
                    r * 16;
          const uint4 ov = *reinterpret_cast<const uint4*>(o_tile(st) + off);
          const uint4 dv = *reinterpret_cast<const uint4*>(do_tile(st) + off);
          const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 df = __bfloat1622float2(d2[e]);
            delta += of.x * df.x + of.y * df.y;
          }
        }
        lse2_s[st * kBlockM + r] = lse2;
        delta_s[st * kBlockM + r] = delta;
        mbar_arrive(&q_full[st]);
      }
    }
  } else {
    // consumer warpgroup wg: keys [n0 + 64 wg, n0 + 64 wg + 64)
    setmaxnreg_inc<224>();
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tg = lane & 3;
    const int kr = wg * 64 + warp * 16 + g;   // first key row of the thread
    const bool key_ok[2] = {n0 + kr < a.Sk, n0 + kr + 8 < a.Sk};
    // dQ's tile behind this warpgroup's turn: warpgroup 1 issues dQ of the
    // tile whose dS^T both warpgroups wrote before its turn, warpgroup 0,
    // a turn ahead of it, that of the tile before
    const int dq_lag = 1 - wg;
    // both warpgroups issue dQ kNq columns wide (at 72 warpgroup 1's first 8
    // are warpgroup 0's last, computed twice and added once), so that the
    // two run one wgmma sequence
    constexpr int kNq = kN0 > kN1 ? kN0 : kN1;
    const __nv_bfloat16* Kc = Ks + (wg == 0 ? 0 : D - kNq) * kBlockN;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    float s[kBlockM / 2], dp[kBlockM / 2];
    uint32_t pa[kBlockM / 16][4], da[kBlockM / 16][4];
    float dq[kNq / 2];
    auto stage = [&](int j) {
      if (wg == 0) {
        stage_dq<kN0, 0, 0>(dq, dq_s, &dq0_map, a.scale, b, h, j * kBlockM,
                            warp, lane);
      } else {
        stage_dq<kN1, kN0, (kNq - kN1) / 8>(dq, dq_s + kBlockM * kN0,
                                            &dq1_map, a.scale, b, h,
                                            j * kBlockM, warp, lane);
      }
    };
    auto dst_of = [&](int j) {
      return dSs + (j < 0 ? 0 : j % kOvlDsBufs) * kBlockM * kBlockN;
    };
    auto fence_all = [&]() {
      fence_regs(s);
      fence_regs(dp);
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(da);
      fence_regs(dq);
    };

    // K, V: K-major A, this warpgroup's 64 rows; chunk stride along D
    const uint64_t k_desc = make_desc(Ks + wg * 64 * 8, kBlockN * 16, 128);
    const uint64_t v_desc = make_desc(Vs + wg * 64 * 8, kBlockN * 16, 128);
    mbar_wait(kv_full, 0);
    // turn 0 (warpgroup 0 first): S^T and dP^T of tile 0. Each turn's
    // products are waited for in the iteration that issues them, so that no
    // wgmma is in flight across the loop's back edge (where ptxas would
    // serialise them all, C7514 / C7515); the other warpgroup's turn runs
    // meanwhile
    if (wg == 1) named_arrive(1, 256);
    mbar_wait(&in_full[0], 0);
    named_sync(1 + wg, 256);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::kSteps; ++kk) {
      st_dpt_step<D>(s, dp, k_desc, v_desc, q_tile(0), do_tile(0), kk);
    }
    wgmma_commit();
    named_arrive(2 - wg, 256);
    wgmma_wait<0>();
    fence_all();
    for (int i = 0; i < n_qt; ++i) {
      const int st = i % kStages;
      mbar_wait(&q_full[st], (i / kStages) & 1);
      p_ds_fragments_ftz(s, dp, pa, da, lse2_s + st * kBlockM,
                         delta_s + st * kBlockM, key_ok, tg, a.scale_log2);
      // this warpgroup's rows of dS^T (bf16, chunked by q) into the tile's
      // buffer; the turn barriers order them before the other warpgroup's
      // dQ reads, and its reads of the buffer three tiles back before them
      __nv_bfloat16* dSt = dst_of(i);
#pragma unroll
      for (int nt = 0; nt < kBlockM / 8; ++nt) {
        __nv_bfloat16* dst = dSt + nt * kBlockN * 8 + kr * 8 + tg * 2;
        *reinterpret_cast<uint32_t*>(dst) = da[nt >> 1][(nt & 1) * 2];
        *reinterpret_cast<uint32_t*>(dst + 64) = da[nt >> 1][(nt & 1) * 2 + 1];
      }
      fence_proxy_async();
      const bool next = i + 1 < n_qt;
      if (next) {
        mbar_wait(&in_full[(i + 1) % kStages], ((i + 1) / kStages) & 1);
      }

      // turn i + 1: dV, dK of tile i, S^T, dP^T of tile i + 1, and a dQ;
      // after the last tile S^T and dP^T run again on this stage, and
      // warpgroup 0's first turn computes a dQ of buffer 0, all discarded
      named_sync(1 + wg, 256);
      fence_all();
      wgmma_fence();
      const int sn = next ? (i + 1) % kStages : st;
      issue_turn<D, kNq>(dk, dv, pa, da, q_tile(st), do_tile(st), s, dp,
                         k_desc, v_desc, q_tile(sn), do_tile(sn), dq,
                         dst_of(i - dq_lag), Kc);
      wgmma_commit();
      named_arrive(2 - wg, 256);
      wgmma_wait<0>();
      fence_all();
      // tile i's stage goes back to the producer (its dV and dK are done);
      // the dQ of this turn goes to the scratch
      if (lane == 0) mbar_arrive(&q_empty[st]);
      if (i - dq_lag >= 0) stage(i - dq_lag);
    }
    // a last turn: warpgroup 0's dQ of the last tile, once warpgroup 1 has
    // written its dS^T (warpgroup 1 issues the same and discards it)
    named_sync(1 + wg, 256);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      dq_step<kNq>(dq, dst_of(n_qt - 1), Kc, kk);
    }
    wgmma_commit();
    if (wg == 0) named_arrive(2, 256);
    wgmma_wait<0>();
    fence_regs(dq);
    if (wg == 0) stage(n_qt - 1);
    // the last reduce-adds are done before the block (and its shared
    // memory) goes
    if (lane == 0) bulk_wait<0, false>();

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
constexpr int kWideCols = 128;   // dK, dV and dQ columns per warpgroup
constexpr int kWideQ = 32;       // S^T, dP^T queries per warpgroup
constexpr int kWideBox = 64;     // bf16 columns per TMA box (128-byte swizzle)
constexpr int kWideBoxBytes = kWideBox * 2 * 64;   // one box of 64 rows
constexpr int kDqBox = 32;       // f32 dQ columns per reduce-add box

template <bool kWithDq>
struct Wide {
  static constexpr int kStages = 2;                       // Q / dO ring depth
  static constexpr int kKElems = kWideN * kWideD;         // K or V
  static constexpr int kQElems = kBlockM * kWideD;        // Q or dO stage
  static constexpr int kPElems = kWideN * kBlockM;        // P^T or dS^T
  static constexpr int kStatOffset =
      2 * (2 * kKElems + 2 * kStages * kQElems + 2 * 2 * kPElems);
  static constexpr int kBarOffset = kStatOffset + 4 * 2 * kStages * kBlockM;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 3 * kStages);
  // registers a thread: the producer issues loads and copies lse, delta
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static_assert(kWideN == kBlockM, "K/V and Q/dO boxes share one size");
};

// delta = rowsum(dO * o) in f32 [B, H, Sq] for the wide single pass, ahead
// of it on the same stream (a pass over o and dO, bound by their bytes):
// one warp a row (b, s, h), lane l on columns [8 l, 8 l + 8)
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta, int H, int Sq, int rows,
                       long long osb, long long oss, long long osh,
                       long long dosb, long long doss, long long dosh) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int h = row % H;
  const int s = (row / H) % Sq;
  const int b = row / H / Sq;
  const uint4 ov = *reinterpret_cast<const uint4*>(
      o + b * osb + s * oss + h * osh + lane * 8);
  const uint4 dv = *reinterpret_cast<const uint4*>(
      dout + b * dosb + s * doss + h * dosh + lane * 8);
  const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
  const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 of = __bfloat1622float2(o2[e]);
    const float2 df = __bfloat1622float2(d2[e]);
    sum += of.x * df.x + of.y * df.y;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * Sq + s] = sum;
}

// byte offset of k16 step kk (over D) of a K-major swizzled 64-row tile:
// box kk / 4, 32 bytes a step into its rows
__device__ __forceinline__ uint32_t wide_k_offset(int kk) {
  return (kk >> 2) * kWideBoxBytes + (kk & 3) * 32;
}

// S^T = K Q_w^T and dP^T = V dO_w^T over the 32 queries [32 wg, 32 wg +
// 32) of the q tile (m64n32, each warpgroup its own half, so each product
// runs once a block): K, V K-major A (64 keys), Q, dO K-major B (this
// warpgroup's rows of each box), all with the 128-byte swizzle
__device__ __forceinline__ void issue_st_dpt_wide(
    float (&s)[kWideQ / 2], float (&dp)[kWideQ / 2],
    const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
    const __nv_bfloat16* Qt, const __nv_bfloat16* dOt, int wg) {
  const uint64_t k_desc = opaque_desc(make_desc_sw<128>(Ks, 16, 1024));
  const uint64_t v_desc = opaque_desc(make_desc_sw<128>(Vs, 16, 1024));
  const uint64_t q_desc = make_desc_sw<128>(Qt + wg * kWideQ * kWideBox, 16,
                                            1024);
  const uint64_t do_desc = make_desc_sw<128>(dOt + wg * kWideQ * kWideBox,
                                             16, 1024);
#pragma unroll
  for (int kk = 0; kk < kWideD / 16; ++kk) {
    const uint32_t off = wide_k_offset(kk) >> 4;
    wgmma_ss<kWideQ, 0, 0>(s, k_desc + off, q_desc + off, kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < kWideD / 16; ++kk) {
    const uint32_t off = wide_k_offset(kk) >> 4;
    wgmma_ss<kWideQ, 0, 0>(dp, v_desc + off, do_desc + off, kk > 0);
  }
}

// dV += P^T dO and dK += dS^T Q over this warpgroup's 128 columns, all 64
// queries: P^T, dS^T K-major A from their chunked tiles ([q chunk][key][8]:
// LBO 1024 along q, SBO 128 along keys, a k16 step two chunks); dO, Q
// MN-major B, boxes 2 wg and 2 wg + 1 (LBO one box, SBO 8 rows, a k16 step
// 16 rows)
__device__ __forceinline__ void issue_dv_dk_wide(
    float (&dk)[kWideCols / 2], float (&dv)[kWideCols / 2],
    const __nv_bfloat16* Pt, const __nv_bfloat16* dSt,
    const __nv_bfloat16* Qt, const __nv_bfloat16* dOt, int wg) {
  const uint64_t p_desc = make_desc(Pt, kWideN * 16, 128);
  const uint64_t ds_desc = make_desc(dSt, kWideN * 16, 128);
  const int cols = 2 * wg * 64 * kWideBox;   // the first of this wg's boxes
  const uint64_t do_m = make_desc_sw<128>(dOt + cols, kWideBoxBytes, 1024);
  const uint64_t q_m = make_desc_sw<128>(Qt + cols, kWideBoxBytes, 1024);
#pragma unroll
  for (int kk = 0; kk < kBlockM / 16; ++kk) {
    wgmma_ss<kWideCols, 0, 1>(dv, p_desc + ((kk * 2048) >> 4),
                              do_m + ((kk * 2048) >> 4), 1);
  }
#pragma unroll
  for (int kk = 0; kk < kBlockM / 16; ++kk) {
    wgmma_ss<kWideCols, 0, 1>(dk, ds_desc + ((kk * 2048) >> 4),
                              q_m + ((kk * 2048) >> 4), 1);
  }
}

// dQ[:, c0 + 64 half : +64] = dS K over the block's 64 keys (this
// warpgroup's columns, one half at a time so that no more than dK, dV and
// two 32-register sums are live): dS MN-major A from the dS^T tile (LBO 128
// along keys, SBO 1024 along q), K MN-major B from box 2 wg + half
__device__ __forceinline__ void issue_dq_wide(float (&dq)[kWideCols / 4],
                                              const __nv_bfloat16* dSt,
                                              const __nv_bfloat16* Ks,
                                              int wg, int half) {
  const uint64_t dsm = make_desc(dSt, 128, kWideN * 16);
  const uint64_t k_m = opaque_desc(make_desc_sw<128>(
      Ks + (2 * wg + half) * kWideN * kWideBox, kWideBoxBytes, 1024));
#pragma unroll
  for (int kk = 0; kk < kWideN / 16; ++kk) {
    wgmma_ss<kWideCols / 2, 1, 1>(dq, dsm + ((kk * 256) >> 4),
                                  k_m + ((kk * 2048) >> 4), kk > 0);
  }
}

// the scaled dQ half `half` of this thread's rows into its two f32 staging
// boxes (32 columns each, 128-byte swizzle: the 16-byte chunk c of row r at
// c ^ (r % 8)); box(j) is f32 box j of the warpgroup's four
template <typename BoxFn>
__device__ __forceinline__ void stage_dq_wide(const float (&dq)[kWideCols / 4],
                                              BoxFn box, int half, int warp,
                                              int g, int tg, float scale) {
#pragma unroll
  for (int nt = 0; nt < kWideCols / 16; ++nt) {
    unsigned char* dst = box(2 * half + (nt >> 2));
    const int chunk = 2 * (nt & 3) + (tg >> 1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      *reinterpret_cast<float2*>(dst + row * 128 + ((chunk ^ g) << 4) +
                                 (tg & 1) * 8) =
          make_float2(dq[nt * 4 + 2 * r] * scale,
                      dq[nt * 4 + 2 * r + 1] * scale);
    }
  }
}

// Head dims 129-256 (zero-padded to 256), both variants. dK and dV of 128
// keys at 256 columns would take 256 registers a thread in one warpgroup,
// so a block owns 64 keys and its two consumer warpgroups split the
// columns, each accumulating dK and dV over its 128 (128 registers a
// thread). See the header for the design.
template <bool kWithDq>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wide_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap domap,
                      const __grid_constant__ CUtensorMap dqmap,
                      const BwdArgs a) {
  using T = Wide<kWithDq>;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + T::kKElems;
  __nv_bfloat16* Qs = Vs + T::kKElems;                 // [kStages] tiles
  __nv_bfloat16* dOs = Qs + kStages * T::kQElems;      // [kStages] tiles
  __nv_bfloat16* Ps = dOs + kStages * T::kQElems;      // P^T [2] buffers
  __nv_bfloat16* dSs = Ps + 2 * T::kPElems;            // dS^T [2] buffers
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
  check_smem_align(smem);

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&in_full[st], 1);
      mbar_init(&q_full[st], kStatThreads);
      mbar_init(&q_empty[st], 2);   // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    setmaxnreg_dec<T::kProducerRegs>();
    const int t = tid - 256;
    if (t == 0) {
      // TMA: K and V once, then Q and dO per q tile, 64-column boxes
      mbar_arrive_expect_tx(kv_full, 2 * 2 * T::kKElems);
      tma_load_tile_sw<kWideD, kWideN, kWideBox>(Ks, &kmap, kv_full, n0, h,
                                                 b);
      tma_load_tile_sw<kWideD, kWideN, kWideBox>(Vs, &vmap, kv_full, n0, h,
                                                 b);
      for (int i = 0; i < n_qt; ++i) {
        const int st = i % kStages;
        mbar_wait(&q_empty[st], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&in_full[st], 2 * 2 * T::kQElems);
        tma_load_tile_sw<kWideD, kBlockM, kWideBox>(
            Qs + st * T::kQElems, &qmap, &in_full[st], i * kBlockM, h, b);
        tma_load_tile_sw<kWideD, kBlockM, kWideBox>(
            dOs + st * T::kQElems, &domap, &in_full[st], i * kBlockM, h, b);
      }
    } else if (t >= 64) {
      // warps 2 and 3: lse (log2 units) and delta (from the scratch) of q
      // row r of each tile; rows at or past Sq get lse = +inf (so p = 0)
      // and delta 0
      const int r = t - 64;
      const long long row_base = static_cast<long long>(blockIdx.y) * a.Sq;
      for (int i = 0; i < n_qt; ++i) {
        const int st = i % kStages;
        const int row = i * kBlockM + r;
        const float lse2 = row < a.Sq ? a.lse[row_base + row] * kLog2e
                                      : INFINITY;
        const float delta = row < a.Sq ? a.delta[row_base + row] : 0.f;
        // the stage is free (its Q, dO are loaded after the release)
        mbar_wait(&in_full[st], (i / kStages) & 1);
        lse2_s[st * kBlockM + r] = lse2;
        delta_s[st * kBlockM + r] = delta;
        mbar_arrive(&q_full[st]);
      }
    }
  } else {
    // consumer warpgroup wg: dK, dV of all 64 keys over columns [c0, c0 +
    // 128); S^T, dP^T of queries [32 wg, 32 wg + 32) of each q tile
    setmaxnreg_inc<T::kConsumerRegs>();
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tg = lane & 3;
    const int kr = warp * 16 + g;     // first key row of the thread
    const int c0 = wg * kWideCols;
    const bool key_ok[2] = {n0 + kr < a.Sk, n0 + kr + 8 < a.Sk};
    const bool leader = (tid & 127) == 0;

    float dk[kWideCols / 2], dv[kWideCols / 2], dq[kWideCols / 4];
    float s[kWideQ / 2], dp[kWideQ / 2];
#pragma unroll
    for (int i = 0; i < kWideCols / 2; ++i) dk[i] = dv[i] = 0.f;

    // S^T and dP^T (and dQ) start their sums from zero (scale_d 0); the
    // zeros here end the registers' live ranges at their last read
    auto zero = [](auto& r) {
#pragma unroll
      for (auto& x : r) x = 0.f;
    };
    mbar_wait(kv_full, 0);
    mbar_wait(&in_full[0], 0);
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_st_dpt_wide(s, dp, Ks, Vs, Qs, dOs, wg);
    wgmma_commit();
    for (int i = 0; i < n_qt; ++i) {
      const int st = i % kStages;
      const int sn = (i + 1) % kStages;
      const __nv_bfloat16* Qt = Qs + st * T::kQElems;
      const __nv_bfloat16* dOt = dOs + st * T::kQElems;
      __nv_bfloat16* Pt = Ps + (i & 1) * T::kPElems;
      __nv_bfloat16* dSt = dSs + (i & 1) * T::kPElems;
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      fence_regs(dk);
      fence_regs(dv);
      if constexpr (kWithDq) {
        // the previous tile's reduce-adds have read its stage: release it
        if (i > 0 && leader) {
          bulk_wait<0, true>();
          mbar_arrive(&q_empty[(i - 1) % kStages]);
        }
      }
      mbar_wait(&q_full[st], (i / kStages) & 1);

      // p = exp(s * scale - lse), masked; dS = p * (dP - delta); P^T and
      // dS^T (bf16) into this tile's buffers, chunked by q: this thread's
      // keys kr, kr + 8, queries 32 wg + 8 nt + 2 tg, +1
      const float* lse2 = lse2_s + st * kBlockM + wg * kWideQ;
      const float* delta = delta_s + st * kBlockM + wg * kWideQ;
#pragma unroll
      for (int nt = 0; nt < kWideQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + tg * 2 + (e & 1);
          const int idx = nt * 4 + e;
          const float p = key_ok[e >> 1]
              ? exp2f(fmaf(s[idx], a.scale_log2, -lse2[qc])) : 0.f;
          s[idx] = p;
          dp[idx] = p * (dp[idx] - delta[qc]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = (wg * (kWideQ / 8) + nt) * kWideN * 8 +
                          (kr + 8 * r) * 8 + tg * 2;
          *reinterpret_cast<uint32_t*>(Pt + off) =
              pack_bf16(s[nt * 4 + 2 * r], s[nt * 4 + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dSt + off) =
              pack_bf16(dp[nt * 4 + 2 * r], dp[nt * 4 + 2 * r + 1]);
        }
      }
      // both halves written before either warpgroup reads them (the
      // buffers alternate, so the tile before the last is done with these)
      fence_proxy_async();
      named_sync(1, 256);

      if constexpr (kWithDq) {
        zero(dq);
        fence_regs(dq);
      } else if (i + 1 < n_qt) {
        zero(s);
        zero(dp);
      }
      fence_regs(s);
      fence_regs(dp);
      fence_regs(dk);
      fence_regs(dv);
      wgmma_fence();
      issue_dv_dk_wide(dk, dv, Pt, dSt, Qt, dOt, wg);
      if constexpr (kWithDq) {
        // dQ (scaled) to the f32 scratch, in two halves of 64 columns:
        // staged in this warpgroup's own boxes of the stage (Q boxes 2 wg,
        // 2 wg + 1, then dO's, which only its dK and dV products read) as
        // four f32 boxes of 32 columns with the 128-byte swizzle, then four
        // bulk reduce-adds (rows past Sq are dropped). The second half
        // runs beside S^T and dP^T of the next tile.
        auto dq_box = [&](int j) {
          return reinterpret_cast<unsigned char*>(const_cast<__nv_bfloat16*>(
              (j < 2 ? Qt : dOt) + (2 * wg + (j & 1)) * kBlockM * kWideBox));
        };
        issue_dq_wide(dq, dSt, Ks, wg, 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(dq);
        stage_dq_wide(dq, dq_box, 0, warp, g, tg, a.scale);
        zero(dq);
        fence_regs(dq);
        const bool next = i + 1 < n_qt;
        if (next) {
          mbar_wait(&in_full[sn], ((i + 1) / kStages) & 1);
          zero(s);
          zero(dp);
          fence_regs(s);
          fence_regs(dp);
        }
        wgmma_fence();
        issue_dq_wide(dq, dSt, Ks, wg, 1);
        wgmma_commit();
        if (next) {
          issue_st_dpt_wide(s, dp, Ks, Vs, Qs + sn * T::kQElems,
                            dOs + sn * T::kQElems, wg);
          wgmma_commit();
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_regs(dq);
        stage_dq_wide(dq, dq_box, 1, warp, g, tg, a.scale);
        fence_proxy_async();
        named_sync(2 + wg, 128);
        if (leader) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            tma_reduce_add_4d(&dqmap, dq_box(j), c0 + j * kDqBox,
                              i * kBlockM, h, b);
          }
          bulk_commit();
        }
      } else {
        // S^T and dP^T of the next tile queue behind dV and dK of this
        // one; once those are done the stage is released
        wgmma_commit();
        if (i + 1 < n_qt) {
          mbar_wait(&in_full[sn], ((i + 1) / kStages) & 1);
          issue_st_dpt_wide(s, dp, Ks, Vs, Qs + sn * T::kQElems,
                            dOs + sn * T::kQElems, wg);
          wgmma_commit();
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_regs(dk);
        fence_regs(dv);
        if (leader) mbar_arrive(&q_empty[st]);
      }
    }
    // the last reduce-adds are done before the block (and its shared
    // memory) goes
    if (kWithDq && leader) bulk_wait<0, false>();

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

constexpr int kMaps = 10;

// the single pass at head dims 64 and 72 runs the overlapped loop
__host__ __device__ constexpr bool overlapped(int D, bool kWithDq) {
  return kWithDq && D <= 72;
}

template <int D, bool kWithDq>
int launch(const CUtensorMap (&maps)[kMaps], const BwdArgs& a, int B,
           cudaStream_t st) {
  const dim3 grid((a.Sk + kBlockN - 1) / kBlockN, B * a.H);
  if constexpr (overlapped(D, kWithDq)) {
    constexpr int smem = Ovl<D>::kSmem;
    const int err = allow_smem<flash_bwd_overlap_kernel<D>>(smem);
    if (err != 0) return err;
    flash_bwd_overlap_kernel<D><<<grid, kThreads, smem, st>>>(
        maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6],
        maps[7], maps[8], maps[9], a);
  } else {
    constexpr int smem = Bwd<D, kWithDq>::kSmem;
    const int err = allow_smem<flash_bwd_sm90_kernel<D, kWithDq>>(smem);
    if (err != 0) return err;
    flash_bwd_sm90_kernel<D, kWithDq><<<grid, kThreads, smem, st>>>(
        maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kWithDq>
int launch_wide(const CUtensorMap (&maps)[kMaps], const BwdArgs& a, int B,
                cudaStream_t st) {
  if constexpr (kWithDq) {
    const int rows = B * a.Sq * a.H;
    flash_bwd_delta_kernel<<<(rows + 7) / 8, 256, 0, st>>>(
        a.o, a.dout, const_cast<float*>(a.delta), a.H, a.Sq, rows, a.osb,
        a.oss, a.osh, a.dosb, a.doss, a.dosh);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  constexpr int smem = Wide<kWithDq>::kSmem;
  const int err = allow_smem<flash_bwd_wide_kernel<kWithDq>>(smem);
  if (err != 0) return err;
  const dim3 grid((a.Sk + kWideN - 1) / kWideN, B * a.H);
  flash_bwd_wide_kernel<kWithDq><<<grid, kThreads, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], a);
  return static_cast<int>(cudaGetLastError());
}

// the head dims with an instance (the wrapper zero-pads any other D up to
// the next one: ops/flash_attention.py:kernel_head_dim)
bool head_dim_ok(int D) {
  return D == 64 || D == 72 || D == 80 || D == 96 || D == 128 || D == 256;
}

template <bool kWithDq>
int launch_d(int D, const CUtensorMap (&maps)[kMaps], const BwdArgs& a, int B,
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

// the tensor maps of k, v, q and dout (bf16 chunks; at head dim 256
// swizzled 64-column boxes), then, with o below head dim 256, those of o
// and of dq's two column blocks (f32), and at 64 and 72 those of q, dout
// and o in 64-column swizzled boxes (the overlapped loop's); at 256 with
// dq that of dq's 32-column swizzled boxes; the maps a variant does not
// read are copies of the first
int encode_maps(CUtensorMap (&maps)[kMaps], const void* q, const void* k,
                const void* v, const void* o, const void* dout, void* dq,
                int B, int H, int Sq, int Sk, int D, long long qsb,
                long long qss, long long qsh, long long ksb, long long kss,
                long long ksh, long long vsb, long long vss, long long vsh,
                long long osb, long long oss, long long osh, long long dosb,
                long long doss, long long dosh) {
  const bool wide = D == kWideD;
  const int kv_rows = wide ? kWideN : kBlockN;
  const int box = wide ? kWideBox : 8;
  const int sw = wide ? 128 : 0;
  int err = encode_bshd(&maps[0], k, false, B, Sk, H, D, ksb, kss, ksh, box,
                        kv_rows, sw);
  if (err == 0) {
    err = encode_bshd(&maps[1], v, false, B, Sk, H, D, vsb, vss, vsh, box,
                      kv_rows, sw);
  }
  if (err == 0) {
    err = encode_bshd(&maps[2], q, false, B, Sq, H, D, qsb, qss, qsh, box,
                      kBlockM, sw);
  }
  if (err == 0) {
    err = encode_bshd(&maps[3], dout, false, B, Sq, H, D, dosb, doss, dosh,
                      box, kBlockM, sw);
  }
  for (int i = 4; i < kMaps; ++i) maps[i] = maps[0];
  if (err != 0 || o == nullptr || wide) {
    if (err == 0 && wide && dq != nullptr) {
      const long long hd = static_cast<long long>(H) * D;
      err = encode_bshd(&maps[4], dq, true, B, Sq, H, D, Sq * hd, hd, D,
                        kDqBox, kBlockM, 128);
    }
    return err;
  }
  const int dq0 = dq_cols0(D);
  const long long hd = static_cast<long long>(H) * D;
  err = encode_bshd(&maps[4], o, false, B, Sq, H, D, osb, oss, osh, 8,
                    kBlockM);
  // dq's boxes: a q tile's rows, at 64 and 72 a warp's (kDqRows), 32
  // columns wide swizzled (dq_swizzled)
  const bool ovl = overlapped(D, true);
  const int dq_rows = ovl ? kDqRows : kBlockM;
  if (err == 0) {
    err = encode_bshd(&maps[5], dq, true, B, Sq, H, D, Sq * hd, hd, D, dq0,
                      dq_rows, ovl && dq_swizzled(dq0) ? 128 : 0);
  }
  if (err == 0) {
    err = encode_bshd(&maps[6], dq, true, B, Sq, H, D, Sq * hd, hd, D,
                      D - dq0, dq_rows, ovl && dq_swizzled(D - dq0) ? 128 : 0);
  }
  if (err == 0 && overlapped(D, true)) {
    err = encode_bshd(&maps[7], q, false, B, Sq, H, D, qsb, qss, qsh, kSwBox,
                      kBlockM, 128);
    if (err == 0) {
      err = encode_bshd(&maps[8], dout, false, B, Sq, H, D, dosb, doss, dosh,
                        kSwBox, kBlockM, 128);
    }
    if (err == 0) {
      err = encode_bshd(&maps[9], o, false, B, Sq, H, D, osb, oss, osh,
                        kSwBox, kBlockM, 128);
    }
  }
  return err;
}

}  // namespace

// q, o, dout [B, Sq, H, D], k/v [B, Sk, H, D]: bf16, strides in elements,
// last dim contiguous, strides multiples of 8 and bases 16-byte aligned
// (TMA); lse f32 [B, H, Sq] contiguous; D 64, 72, 80, 96, 128 or 256.
// Both write bf16 dk, dv
// [B, Sk, H, D] (contiguous). flash_attn_bwd adds dq into a zeroed f32
// [B, Sq, H, D] buffer; at D 256 it takes delta, an f32 [B, H, Sq]
// contiguous scratch, and starts two kernels, flash_bwd_delta_kernel
// writing delta there and then flash_bwd_wide_kernel (below 256 delta is
// unused and it starts one); flash_attn_bwd_dkv reads delta as the dq
// pass wrote it (o and dq unused).
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
  if (!head_dim_ok(D) || (D == kWideD && delta == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[kMaps];
  const int err = encode_maps(maps, q, k, v, o, dout, dq, B, H, Sq, Sk, D,
                              qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                              osb, oss, osh, dosb, doss, dosh);
  if (err != 0) return err;
  BwdArgs a;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.osb = osb;
  a.oss = oss;
  a.osh = osh;
  a.dosb = dosb;
  a.doss = doss;
  a.dosh = dosh;
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
  CUtensorMap maps[kMaps];
  const int err = encode_maps(maps, q, k, v, nullptr, dout, nullptr, B, H,
                              Sq, Sk, D, qsb, qss, qsh, ksb, kss, ksh, vsb,
                              vss, vsh, osb, oss, osh, dosb, doss, dosh);
  if (err != 0) return err;
  BwdArgs a;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.o = a.dout = nullptr;
  a.osb = a.oss = a.osh = a.dosb = a.doss = a.dosh = 0;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_d<false>(D, maps, a, B, st);
}
