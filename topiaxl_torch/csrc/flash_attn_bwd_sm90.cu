// Single-pass flash-attention backward for Hopper (sm_90a): bf16 q, k, v,
// o, dO in, f32 logsumexp (lse) from the forward; dq added into a zeroed
// f32 [B, Sq, H, D] buffer, bf16 dk, dv out.
//
// Replaces the TPU kernel topiaxl/ops/flash_attention.py:
// _flash_bwd_fused_kernel (:369), the backward taken when the keys fit one
// block (Sk <= 2048: the DiT's self- and cross-attention). The numerics
// are those of flash_attn_bwd.cu's two-pass pair: p = exp(s * scale - lse)
// in f32; delta = rowsum(dO * o) in f32; P rounded to bf16 for dv, dS =
// p * (dP - delta) rounded to bf16 for dq and dk; f32 accumulation; the
// scale applied to dq and dk; keys at or past Sk and q rows at or past Sq
// get p = 0.
//
// What bounds it on an H100: tensor-core FLOPs. Per head it runs five
// Sq x Sk x D products (S and dP recomputed, then dV, dK, dQ), far above
// the card's FLOP-per-byte ridge at the DiT's shapes. The design:
//   * one block per (batch*head, 128-key KV tile), as the first kernel
//     of this port: dK and dV accumulate in f32 registers while the block
//     loops over 64-row q tiles; two consumer warpgroups own 64 keys each,
//     a producer warpgroup feeds them;
//   * the producer's first thread loads K and V once and streams Q, dO
//     and o tiles through a two-stage ring by TMA (mbarrier full/empty
//     pairs); two more of its warps compute each q tile's lse (in log2
//     units) and delta = rowsum(dO * o) from the o and dO tiles in shared
//     memory into the same stage, so no separate pass runs; setmaxnreg
//     moves registers to the consumers;
//   * all five products run on wgmma: S^T = K Q^T and dP^T = V dO^T with
//     both operands in shared memory, K-major over D (m64n64k16); dV +=
//     P^T dO and dK += dS^T Q with P^T and dS^T straight from the S^T and
//     dP^T accumulator registers and dO, Q read MN-major (m64n{72,64}k16);
//     dQ = dS K after dS^T goes through shared memory once (bf16), with
//     dS read MN-major and K MN-major; the two warpgroups split dQ's
//     columns (40 + 32 of 72, 32 + 32 of 64), so each dQ element of a
//     (KV tile, q tile) pair is added once;
//   * dQ, a sum over KV tiles that run on other blocks, is added to the
//     f32 scratch by one bulk TMA reduce-add per warpgroup and q tile,
//     from a staging tile in shared memory, in place of an atomic per
//     element (the 128-key tile also halves the number of additions
//     against a 64-key one). The order of the additions varies from run
//     to run, so dq's f32 rounding does too;
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
constexpr int kStages = 2;     // Q / dO ring depth
constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int kStatThreads = 64;   // producer threads computing lse, delta
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Bwd {
  static constexpr int kChunks = D / 8;
  static constexpr int kSteps = (D + 15) / 16;    // k16 steps over D
  static constexpr int kChunksP = 2 * kSteps;
  static constexpr int kKElems = kChunksP * kBlockN * 8;   // K or V
  static constexpr int kQElems = kChunksP * kBlockM * 8;   // Q or dO stage
  static constexpr int kOElems = kChunks * kBlockM * 8;    // o stage
  static constexpr int kDsElems = kBlockM * kBlockN;       // dS^T
  // dQ columns of warpgroup 0; warpgroup 1 takes the rest
  static constexpr int kDq0 = D == 72 ? 40 : 32;
  static constexpr int kDqOffset =
      2 * (2 * kKElems + kStages * (2 * kQElems + kOElems) + kDsElems);
  static constexpr int kStatOffset = kDqOffset + 4 * kBlockM * D;
  static constexpr int kBarOffset = kStatOffset + 4 * 2 * kStages * kBlockM;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 3 * kStages);
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
};

struct BwdArgs {
  const float* lse;      // [B, H, Sq] contiguous
  __nv_bfloat16* dk;     // [B, Sk, H, D] contiguous
  __nv_bfloat16* dv;
  int H, Sq, Sk;
  float scale, scale_log2;
};

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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap domap,
                      const __grid_constant__ CUtensorMap omap,
                      const __grid_constant__ CUtensorMap dq0_map,
                      const __grid_constant__ CUtensorMap dq1_map,
                      const BwdArgs a) {
  using T = Bwd<D>;
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
  uint64_t* in_full = kv_full + 1;      // Q, dO, o of a stage have arrived
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
    setmaxnreg_dec<56>();
    const int t = tid - 256;
    if (t == 0) {
      // TMA: K and V once, then Q, dO and o per q tile
      mbar_arrive_expect_tx(kv_full, 2 * T::kChunks * kBlockN * 16);
      tma_load_tile<D, kBlockN>(Ks, &kmap, kv_full, n0, h, b);
      tma_load_tile<D, kBlockN>(Vs, &vmap, kv_full, n0, h, b);
      for (int i = 0; i < n_qt; ++i) {
        const int st = i % kStages;
        mbar_wait(&q_empty[st], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&in_full[st], 3 * T::kChunks * kBlockM * 16);
        tma_load_tile<D, kBlockM>(Qs + st * T::kQElems, &qmap, &in_full[st],
                                  i * kBlockM, h, b);
        tma_load_tile<D, kBlockM>(dOs + st * T::kQElems, &domap,
                                  &in_full[st], i * kBlockM, h, b);
        tma_load_tile<D, kBlockM>(Os + st * T::kOElems, &omap, &in_full[st],
                                  i * kBlockM, h, b);
      }
    } else if (t >= 32 && t < 32 + kStatThreads) {
      // lse (log2 units) and delta of q row r of each tile, from the
      // stage's o and dO; rows at or past Sq get lse = +inf (so p = 0)
      const int r = t - 32;
      const float* lse_bh = a.lse + static_cast<long long>(blockIdx.y) * a.Sq;
      for (int i = 0; i < n_qt; ++i) {
        const int st = i % kStages;
        const int row = i * kBlockM + r;
        const float lse2 = row < a.Sq ? lse_bh[row] * kLog2e : INFINITY;
        mbar_wait(&in_full[st], (i / kStages) & 1);
        const __nv_bfloat16* orow = Os + st * T::kOElems + r * 8;
        const __nv_bfloat16* drow = dOs + st * T::kQElems + r * 8;
        float delta = 0.f;
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
        lse2_s[st * kBlockM + r] = lse2;
        delta_s[st * kBlockM + r] = delta;   // rows past Sq read zeros: 0
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
    // K, V: K-major A, this warpgroup's 64 rows; chunk stride along D
    const uint64_t k_desc = make_desc(Ks + wg * 64 * 8, kBlockN * 16, 128);
    const uint64_t v_desc = make_desc(Vs + wg * 64 * 8, kBlockN * 16, 128);

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_qt; ++i) {
      const int st = i % kStages;
      mbar_wait(&in_full[st], (i / kStages) & 1);
      mbar_wait(&q_full[st], (i / kStages) & 1);
      const __nv_bfloat16* Qt = Qs + st * T::kQElems;
      const __nv_bfloat16* dOt = dOs + st * T::kQElems;
      const float* lse2 = lse2_s + st * kBlockM;
      const float* delta = delta_s + st * kBlockM;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 q rows each
      float s[kBlockM / 2], dp[kBlockM / 2];
      const uint64_t q_desc = make_desc(Qt, kBlockM * 16, 128);
      const uint64_t do_desc = make_desc(dOt, kBlockM * 16, 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kSteps; ++kk) {
        wgmma_ss<kBlockM, 0, 0>(s, k_desc + ((kk * 2 * kBlockN * 16) >> 4),
                                q_desc + ((kk * 2 * kBlockM * 16) >> 4),
                                kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < T::kSteps; ++kk) {
        wgmma_ss<kBlockM, 0, 0>(dp, v_desc + ((kk * 2 * kBlockN * 16) >> 4),
                                do_desc + ((kk * 2 * kBlockM * 16) >> 4),
                                kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // p = exp(s * scale - lse), masked; dS = p * (dP - delta). Rows of
      // the accumulators are keys (g, g + 8), columns are q rows.
#pragma unroll
      for (int nt = 0; nt < kBlockM / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + tg * 2 + (e & 1);
          const int idx = nt * 4 + e;
          const float p = key_ok[e >> 1]
              ? exp2f(fmaf(s[idx], a.scale_log2, -lse2[qc])) : 0.f;
          s[idx] = p;
          dp[idx] = p * (dp[idx] - delta[qc]);
        }
      }
      // P^T and dS^T as A fragments over the q rows (k16 steps)
      uint32_t pa[kBlockM / 16][4], da[kBlockM / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }
      }

      // dV += P^T dO and dK += dS^T Q: dO and Q MN-major B
      const uint64_t do_mdesc = make_desc(dOt, 128, kBlockM * 16);
      const uint64_t q_mdesc = make_desc(Qt, 128, kBlockM * 16);
      fence_regs(dk);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) {
        wgmma_rs<D, 1>(dv, pa[kk], do_mdesc + ((kk * 256) >> 4), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) {
        wgmma_rs<D, 1>(dk, da[kk], q_mdesc + ((kk * 256) >> 4), 1);
      }
      wgmma_commit();

      // dS^T (bf16) into shared memory, chunked by q: both warpgroups are
      // done with the previous tile's dQ products first, and both have
      // written before either reads
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

      // dQ of this q tile; the wait inside also completes dV and dK, so
      // the stage is released there
      if (wg == 0) {
        dq_part<T::kDq0, 0>(dSs, Ks, dq_s, &dq0_map, a.scale, b, h,
                            i * kBlockM, wg, warp, lane, &q_empty[st]);
      } else {
        dq_part<D - T::kDq0, T::kDq0>(dSs, Ks, dq_s + kBlockM * T::kDq0,
                                      &dq1_map, a.scale, b, h, i * kBlockM,
                                      wg, warp, lane, &q_empty[st]);
      }
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(da);
    }

    // the last reduce-adds are done before the block (and its shared
    // memory) goes
    if ((tid & 127) == 0) bulk_wait<0, false>();

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

template <int D>
int launch(const CUtensorMap (&maps)[7], const BwdArgs& a, int B,
           cudaStream_t st) {
  constexpr int smem = Bwd<D>::kSmem;
  const int err = allow_smem<flash_bwd_sm90_kernel<D>>(smem);
  if (err != 0) return err;
  const dim3 grid((a.Sk + kBlockN - 1) / kBlockN, B * a.H);
  flash_bwd_sm90_kernel<D><<<grid, kThreads, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout [B, Sq, H, D], k/v [B, Sk, H, D]: bf16, strides in elements,
// last dim contiguous, strides multiples of 8 and bases 16-byte aligned
// (TMA); lse f32 [B, H, Sq] contiguous; D 64 or 72. Adds dq into a zeroed
// f32 [B, Sq, H, D] buffer and writes bf16 dk, dv [B, Sk, H, D]
// (contiguous). Returns the CUDA error code of the tensor map encoding or
// of the launch (0 on success).
extern "C" int topiaxl_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv, int B,
    int H, int Sq, int Sk, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh,
    long long dosb, long long doss, long long dosh, float scale,
    void* stream) {
  if (D != 64 && D != 72) return static_cast<int>(cudaErrorInvalidValue);
  // k, v, q, dout, o (bf16 chunks), then dq's two column blocks (f32)
  CUtensorMap maps[7];
  const int dq0 = D == 72 ? 40 : 32;
  const long long hd = static_cast<long long>(H) * D;
  int err = encode_bshd(&maps[0], k, false, B, Sk, H, D, ksb, kss, ksh, 8,
                        kBlockN);
  if (err == 0) {
    err = encode_bshd(&maps[1], v, false, B, Sk, H, D, vsb, vss, vsh, 8,
                      kBlockN);
  }
  if (err == 0) {
    err = encode_bshd(&maps[2], q, false, B, Sq, H, D, qsb, qss, qsh, 8,
                      kBlockM);
  }
  if (err == 0) {
    err = encode_bshd(&maps[3], dout, false, B, Sq, H, D, dosb, doss, dosh, 8,
                      kBlockM);
  }
  if (err == 0) {
    err = encode_bshd(&maps[4], o, false, B, Sq, H, D, osb, oss, osh, 8,
                      kBlockM);
  }
  if (err == 0) {
    err = encode_bshd(&maps[5], dq, true, B, Sq, H, D, Sq * hd, hd, D, dq0,
                      kBlockM);
  }
  if (err == 0) {
    err = encode_bshd(&maps[6], dq, true, B, Sq, H, D, Sq * hd, hd, D,
                      D - dq0, kBlockM);
  }
  if (err != 0) return err;
  BwdArgs a;
  a.lse = static_cast<const float*>(lse);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 72) return launch<72>(maps, a, B, st);
  return launch<64>(maps, a, B, st);
}
