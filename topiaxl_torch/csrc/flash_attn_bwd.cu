// Two-pass flash-attention backward for Hopper (sm_90a), the dq pass
// (flash_attn_bwd_dq): bf16 q, k, v, o, dO in, f32 logsumexp (lse) from
// the forward; bf16 dq out, and delta = rowsum(dO * o), f32 [B, H, Sq],
// for the dk/dv pass (flash_attn_bwd_dkv in flash_attn_bwd_sm90.cu),
// which reads it in place of o. The pair runs when the keys do not fit
// one block (Sk > 2048). The wrapper (ops/flash_attention.py) launches
// this pass first and the dk/dv pass after it on the same stream, so the
// dk/dv pass finds delta written.
//
// Replaces the TPU kernel topiaxl/ops/flash_attention.py:
// _flash_bwd_dq_kernel (:282), the FA2 dq pass, with the delta that the
// JAX wrapper computes before it (:697-699). Numerics, those of the
// single pass and of the dk/dv pass: p = exp(s * scale - lse) in f32;
// delta in f32; dS = p * (dP - delta) rounded to bf16 for dq; f32
// accumulation; the scale applied to dq; keys at or past Sk get p = 0.
//
// What bounds it on an H100: tensor-core FLOPs. Per head it runs three
// Sq x Sk x D products (S and dP recomputed, then dQ) and one exponential
// per logit, against one read of q, k, v, o and dO. The design is the
// forward's (flash_attn_fwd.cu):
//   * one block per (batch*head, 128-row q tile): two consumer
//     warpgroups of 64 q rows each keep dQ in f32 registers over the
//     128-key K/V tiles; dQ is written once, by one block, so it is
//     deterministic (no atomics, no reduce-adds);
//   * a producer warpgroup loads Q, dO and o once and streams K and V
//     through a three-stage ring by TMA (mbarrier full/empty pairs; a
//     stage is released when dQ of its tile is done); setmaxnreg moves
//     its registers to the consumers; at head dim 256 the ring has two
//     stages and o is not staged (Q and dO alone take 128 KiB);
//   * each consumer thread computes lse (log2 units) and delta of its two
//     rows once, from the o and dO tiles in shared memory (at 256, o from
//     device memory; the quad's four threads split the chunks), and
//     writes delta to the scratch;
//   * per K/V tile (128 keys up to head dim 80, 64 up to 128, 32 at 256:
//     dq_block_n), S = Q K^T and dP = dO V^T run on wgmma m64n{128,64,32}k16
//     with both operands in shared memory, K-major over D; dS = p (dP -
//     delta) is formed in the accumulator registers and packed to bf16 A
//     fragments; dQ += dS K runs on wgmma m64n{72,64}k16 with dS from
//     registers and K read MN-major from the same tile (m64nDk16, one
//     instance per head dim 64, 72, 80, 96, 128 and 256, whose dQ takes
//     two m64n128 halves);
//   * overlap: in its turn a warpgroup issues S and dP of tile j with dQ
//     of tile j - 1, and two named barriers hand the turns back and forth
//     (ping-pong), so one warpgroup's exponentials overlap the other's
//     products;
//   * tiles use the no-swizzle core-matrix layout of sm90.cuh: the
//     contraction over D runs to 80 for head dim 72, with the 10th chunk
//     of Q, dO, K and V zeroed once and never loaded; the [B, S, H, D]
//     strides go into tensor maps, so the DiT's qkv.unbind(2) views are
//     read without a copy, and rows past Sq or Sk arrive as zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;   // q rows per block, 64 per consumer warpgroup
constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr float kLog2e = 1.4426950408889634f;

// keys per K/V tile: 128 up to head dim 80; 64 above, where S, dP, dQ and
// the dS fragments of a 128-key tile (64 + 64 + D / 2 + 32 registers a
// thread) would not fit the consumers' 240 registers without spilling; 32
// at 256, where dQ alone takes 128 and Q and dO 128 KiB of shared memory
__host__ __device__ constexpr int dq_block_n(int D) {
  return D <= 80 ? 128 : D <= 128 ? 64 : 32;
}

template <int D>
struct Dq {
  static constexpr int kBlockN = dq_block_n(D);
  // K/V ring depth; at 256 two stages, and o is read for delta from
  // device memory, not staged (Q, dO and three stages would not fit)
  static constexpr int kStages = D <= 128 ? 3 : 2;
  static constexpr bool kOSmem = D <= 128;
  static constexpr int kChunks = D / 8;            // 8-column chunks of D
  static constexpr int kSteps = (D + 15) / 16;     // k16 steps over D
  static constexpr int kChunksP = 2 * kSteps;      // chunks with padding
  static constexpr int kQElems = kChunksP * kBlockM * 8;   // Q or dO
  static constexpr int kOElems = kOSmem ? kChunks * kBlockM * 8 : 0;
  static constexpr int kKElems = kChunksP * kBlockN * 8;   // K or V stage
  static constexpr int kBarOffset =
      2 * (2 * kQElems + kOElems + 2 * kStages * kKElems);
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kStages);
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
};

struct DqArgs {
  const float* lse;      // [B, H, Sq] contiguous
  float* delta;          // [B, H, Sq] contiguous, written here
  __nv_bfloat16* dq;     // [B, Sq, H, D] contiguous
  const __nv_bfloat16* o;   // [B, Sq, H, D], strides osb, oss, osh
  long long osb, oss, osh;
  int H, Sq, Sk;
  float scale, scale_log2;
};

// dQ += dS K for the K tile Kt: dS from registers, K MN-major B (8 keys
// per core matrix along the contraction, the chunks along N)
template <int D>
__device__ __forceinline__ void issue_dq(
    float (&dq)[D / 2], const uint32_t (&ds)[Dq<D>::kBlockN / 16][4],
    const __nv_bfloat16* Kt) {
  constexpr int kBlockN = Dq<D>::kBlockN;
  const uint64_t k_desc = make_desc(Kt, 128, kBlockN * 16);
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    wgmma_rs<D, 1>(dq, ds[kk], k_desc + ((kk * 256) >> 4), 1);
  }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const __grid_constant__ CUtensorMap omap,
                    const DqArgs a) {
  using T = Dq<D>;
  constexpr int kBlockN = T::kBlockN;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + T::kQElems;
  __nv_bfloat16* Os = dOs + T::kQElems;
  __nv_bfloat16* Ks = Os + T::kOElems;                  // [kStages] tiles
  __nv_bfloat16* Vs = Ks + kStages * T::kKElems;        // [kStages] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::kBarOffset);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int m0 = blockIdx.x * kBlockM;
  const int n_tiles = (a.Sk + kBlockN - 1) / kBlockN;

  // the padding chunks of Q, dO and every K / V stage: zero once
  if constexpr (T::kChunksP > T::kChunks) {
    constexpr int kPadM = (T::kChunksP - T::kChunks) * kBlockM;   // uint4s
    constexpr int kPadN = (T::kChunksP - T::kChunks) * kBlockN;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < kPadM; i += kThreads) {
      reinterpret_cast<uint4*>(Qs + T::kChunks * kBlockM * 8)[i] = z;
      reinterpret_cast<uint4*>(dOs + T::kChunks * kBlockM * 8)[i] = z;
    }
    for (int i = tid; i < 2 * kStages * kPadN; i += kThreads) {
      const int t = i / kPadN;   // K stages, then V stages (adjacent)
      reinterpret_cast<uint4*>(Ks + t * T::kKElems +
                               T::kChunks * kBlockN * 8)[i - t * kPadN] = z;
    }
    fence_proxy_async();
  }
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&kv_full[st], 1);
      mbar_init(&kv_empty[st], 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // producer: one thread issues every TMA load
    setmaxnreg_dec<24>();
    if (tid == 256) {
      mbar_arrive_expect_tx(q_full,
                            (T::kOSmem ? 3 : 2) * T::kChunks * kBlockM * 16);
      tma_load_tile<D, kBlockM>(Qs, &qmap, q_full, m0, h, b);
      tma_load_tile<D, kBlockM>(dOs, &domap, q_full, m0, h, b);
      if constexpr (T::kOSmem) {
        tma_load_tile<D, kBlockM>(Os, &omap, q_full, m0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&kv_empty[st], ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&kv_full[st], 2 * T::kChunks * kBlockN * 16);
        tma_load_tile<D, kBlockN>(Ks + st * T::kKElems, &kmap, &kv_full[st],
                                  j * kBlockN, h, b);
        tma_load_tile<D, kBlockN>(Vs + st * T::kKElems, &vmap, &kv_full[st],
                                  j * kBlockN, h, b);
      }
    }
  } else {
    // consumer warpgroup wg: q rows [64 wg, 64 wg + 64) of the tile
    setmaxnreg_inc<240>();
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tg = lane & 3;
    const int r0 = wg * 64 + warp * 16 + g;   // the thread's first row
    // Q, dO: K-major A, this warpgroup's 64 rows; chunk stride along D
    const uint64_t q_desc = make_desc(Qs + wg * 64 * 8, kBlockM * 16, 128);
    const uint64_t do_desc = make_desc(dOs + wg * 64 * 8, kBlockM * 16, 128);
    const long long row_base = static_cast<long long>(blockIdx.y) * a.Sq;

    // lse (log2 units) and delta of rows r0 and r0 + 8; rows past Sq read
    // zeros (delta 0) and get lse = +inf (p = 0); at head dim 256 o comes
    // from device memory
    mbar_wait(q_full, 0);
    float lse2[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rt = r0 + 8 * r;
      const int row = m0 + rt;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < (T::kChunks + 3) / 4; ++i) {
        const int c = tg + 4 * i;
        if (c < T::kChunks && (T::kOSmem || row < a.Sq)) {
          const int off = c * kBlockM * 8 + rt * 8;
          uint4 ov;
          if constexpr (T::kOSmem) {
            ov = *reinterpret_cast<const uint4*>(Os + off);
          } else {
            ov = *reinterpret_cast<const uint4*>(
                a.o + b * a.osb + row * a.oss + h * a.osh + c * 8);
          }
          const uint4 dv = *reinterpret_cast<const uint4*>(dOs + off);
          const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 df = __bfloat1622float2(d2[e]);
            acc += of.x * df.x + of.y * df.y;
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      delta[r] = acc;
      lse2[r] = row < a.Sq ? a.lse[row_base + row] * kLog2e : INFINITY;
      if (tg == 0 && row < a.Sq) a.delta[row_base + row] = acc;
    }

    float s[kBlockN / 2];          // S tile: kBlockN / 8 column tiles x 4
    float dp[kBlockN / 2];         // dP, then dS (f32)
    float dq[D / 2];               // dQ: D / 8 column tiles x 4
    uint32_t ds[kBlockN / 16][4];  // dS (bf16) as A fragments, per k16 step
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    if (wg == 1) named_arrive(1, 256);   // warpgroup 0 takes the first turn
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      mbar_wait(&kv_full[st], (j / kStages) & 1);
      named_sync(1 + wg, 256);           // this warpgroup's turn
      const uint64_t k_desc =
          make_desc(Ks + st * T::kKElems, kBlockN * 16, 128);
      const uint64_t v_desc =
          make_desc(Vs + st * T::kKElems, kBlockN * 16, 128);
      fence_regs(dq);
      fence_regs(ds);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kSteps; ++kk) {
        wgmma_ss<kBlockN, 0, 0>(s, q_desc + ((kk * 2 * kBlockM * 16) >> 4),
                                k_desc + ((kk * 2 * kBlockN * 16) >> 4),
                                kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < T::kSteps; ++kk) {
        wgmma_ss<kBlockN, 0, 0>(dp, do_desc + ((kk * 2 * kBlockM * 16) >> 4),
                                v_desc + ((kk * 2 * kBlockN * 16) >> 4),
                                kk > 0);
      }
      wgmma_commit();
      if (j > 0) issue_dq<D>(dq, ds, Ks + ((j - 1) % kStages) * T::kKElems);
      if (wg == 0 || j + 1 < n_tiles) named_arrive(2 - wg, 256);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      fence_regs(dq);
      fence_regs(ds);
      // dQ of tile j - 1 is done with its K tile
      if (j > 0 && lane == 0) mbar_arrive(&kv_empty[(j - 1) % kStages]);

      // dS = p (dP - delta), p = exp(s * scale - lse), masked past Sk;
      // rows of the accumulators are q rows (g, g + 8), columns keys
      const int n0 = j * kBlockN;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n0 + nt * 8 + tg * 2 + (e & 1);
          const int idx = nt * 4 + e;
          const float p = key < a.Sk
              ? exp2f(fmaf(s[idx], a.scale_log2, -lse2[e >> 1])) : 0.f;
          dp[idx] = p * (dp[idx] - delta[e >> 1]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ds[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }
      }
    }
    fence_regs(dq);
    fence_regs(ds);
    wgmma_fence();
    issue_dq<D>(dq, ds, Ks + ((n_tiles - 1) % kStages) * T::kKElems);
    wgmma_wait<0>();
    fence_regs(dq);

    // dQ (scaled), bf16, [B, Sq, H, D] contiguous
    const long long rs = static_cast<long long>(a.H) * D;
    __nv_bfloat16* dqh =
        a.dq + (static_cast<long long>(b) * a.Sq * a.H + h) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + r0 + 8 * r;
      if (row >= a.Sq) continue;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int col = dt * 8 + tg * 2;
        *reinterpret_cast<uint32_t*>(dqh + row * rs + col) = pack_bf16(
            dq[dt * 4 + 2 * r] * a.scale, dq[dt * 4 + 2 * r + 1] * a.scale);
      }
    }
  }
}

template <int D>
int launch(const CUtensorMap (&maps)[5], const DqArgs& a, int B,
           cudaStream_t st) {
  constexpr int smem = Dq<D>::kSmem;
  const int err = allow_smem<flash_bwd_dq_kernel<D>>(smem);
  if (err != 0) return err;
  const dim3 grid((a.Sq + kBlockM - 1) / kBlockM, B * a.H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout [B, Sq, H, D], k/v [B, Sk, H, D]: bf16, strides in elements,
// last dim contiguous, strides multiples of 8 and bases 16-byte aligned
// (TMA); lse f32 [B, H, Sq] contiguous; D 64, 72, 80, 96, 128 or 256 (the
// wrapper zero-pads any other D up to the next). Writes bf16 dq
// [B, Sq, H, D] (contiguous) and delta, f32 [B, H, Sq] (contiguous); dk,
// dv are unused (the signature is that of every backward entry). Returns
// the CUDA error code of the tensor map encoding or of the launch (0 on
// success).
extern "C" int topiaxl_flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Sq, int Sk, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, long long dosb,
    long long doss, long long dosh, float scale, void* stream) {
  (void)dk;
  (void)dv;
  if (D != 64 && D != 72 && D != 80 && D != 96 && D != 128 && D != 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // q, k, v, dout, o (bf16 chunks)
  CUtensorMap maps[5];
  int err = encode_bshd(&maps[0], q, false, B, Sq, H, D, qsb, qss, qsh, 8,
                        kBlockM);
  if (err == 0) {
    err = encode_bshd(&maps[1], k, false, B, Sk, H, D, ksb, kss, ksh, 8,
                      dq_block_n(D));
  }
  if (err == 0) {
    err = encode_bshd(&maps[2], v, false, B, Sk, H, D, vsb, vss, vsh, 8,
                      dq_block_n(D));
  }
  if (err == 0) {
    err = encode_bshd(&maps[3], dout, false, B, Sq, H, D, dosb, doss, dosh,
                      8, kBlockM);
  }
  if (err == 0) {
    err = encode_bshd(&maps[4], o, false, B, Sq, H, D, osb, oss, osh, 8,
                      kBlockM);
  }
  if (err != 0) return err;
  DqArgs a;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
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
  switch (D) {
    case 64: return launch<64>(maps, a, B, st);
    case 72: return launch<72>(maps, a, B, st);
    case 80: return launch<80>(maps, a, B, st);
    case 96: return launch<96>(maps, a, B, st);
    case 128: return launch<128>(maps, a, B, st);
    default: return launch<256>(maps, a, B, st);
  }
}
