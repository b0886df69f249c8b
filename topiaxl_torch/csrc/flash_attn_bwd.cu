// Flash-attention backward for Hopper (sm_90a): bf16 q, k, v, o, dO in,
// f32 logsumexp (lse) from the forward, bf16 dq, dk, dv out.
//
// Replaces the TPU kernels of topiaxl/ops/flash_attention.py:
//   flash_attn_bwd      <- _flash_bwd_fused_kernel (single pass, :369)
//   flash_attn_bwd_dq   <- _flash_bwd_dq_kernel   (FA2 dq pass, :282)
//   flash_attn_bwd_dkv  <- _flash_bwd_dkv_kernel  (FA2 dk/dv pass, :469)
// The softmax is rebuilt from the lse: p = exp(s * scale - lse) in f32;
// delta = rowsum(dO * o) in f32; P is rounded to bf16 for dv, dS =
// p * (dP - delta) is rounded to bf16 for dq and dk; every product
// accumulates in f32 on mma.sync m16n8k16; the scale is applied to dq
// and dk. Keys at or past Sk and q rows at or past Sq get p = 0.
//
// What bounds it on an H100: tensor-core FLOPs, as in the forward. Per
// head the backward runs five Sq x Sk x D products (S and dP recomputed,
// then dV, dK, dQ), far above the card's FLOP-per-byte ridge at the
// DiT's shapes, so the design keeps S, P, dP and dS out of device memory:
//   * flash_attn_bwd: one block of 4 warps per (batch*head, 64-key KV
//     tile); each warp owns 16 keys and keeps their dK and dV in f32
//     registers while the block loops over 64-row q tiles. S^T and dP^T
//     are computed once per (KV tile, q tile) pair and feed all three
//     gradients. dQ, a sum over KV tiles that run on other blocks, goes
//     through shared memory (dS, bf16) and f32 atomicAdd into a scratch
//     [B, Sq, H, D] buffer that the wrapper zeroes and casts to bf16:
//     this is what stands in for the TPU kernel keeping the whole KV of
//     a head in VMEM. The atomics make dq's f32 summation order vary
//     from run to run.
//   * flash_attn_bwd_dkv: the same kernel without the dQ part.
//   * flash_attn_bwd_dq: one block per (batch*head, 64-row q tile), each
//     warp owning 16 q rows, looping over KV tiles and keeping dQ in
//     registers: deterministic, written once.
//   * delta is computed per q tile inside every kernel from o and dO
//     (two threads per row), as the TPU's single-pass kernel does; no
//     separate pass.
//   * the [B, S, H, D] strides are read directly, so the DiT's
//     qkv.unbind(2) views go in without a copy; head_dim 72 is padded to
//     80 in shared memory only.
// It is a simple first kernel: synchronous loads, no cp.async/TMA
// pipeline, no wgmma, B fragments read element-wise where the operand is
// transposed. Those are later work. The block shape and the mma/tile
// helpers are those of the forward (mma_tile.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int kLdS = kBlockM + 8;   // row stride of the dS tile (bf16)
constexpr float kLog2e = 1.4426950408889634f;

// lse (in log2 units) and delta = rowsum(dO * o) of q rows
// [m0, m0 + 64); rows at or past Sq get lse = +inf (so p = 0) and delta 0
template <int D>
__device__ __forceinline__ void load_row_stats(
    float* lse2_s, float* delta_s, const float* lse_bh,
    const __nv_bfloat16* oh, long long oss, const __nv_bfloat16* doh,
    long long doss, int m0, int Sq) {
  const int r = threadIdx.x >> 1;   // two threads per row, adjacent lanes
  const int half = threadIdx.x & 1;
  const int row = m0 + r;
  float acc = 0.f;
  if (row < Sq) {
    const __nv_bfloat16* orow = oh + static_cast<long long>(row) * oss;
    const __nv_bfloat16* drow = doh + static_cast<long long>(row) * doss;
    for (int c = half; c < D / 8; c += 2) {
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
      const uint4 dv = *reinterpret_cast<const uint4*>(drow + c * 8);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 of = __bfloat1622float2(o2[j]);
        const float2 df = __bfloat1622float2(d2[j]);
        acc += of.x * df.x + of.y * df.y;
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (half == 0) {
    delta_s[r] = acc;
    lse2_s[r] = row < Sq ? lse_bh[row] * kLog2e : INFINITY;
  }
}

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;      // [B, H, Sq] contiguous
  void* dq;              // f32 [B, Sq, H, D] scratch (atomic) or bf16 dq
  __nv_bfloat16* dk;     // [B, Sk, H, D] contiguous (null: not computed)
  __nv_bfloat16* dv;
  int H, Sq, Sk;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  long long osb, oss, osh, dosb, doss, dosh;
  float scale, scale_log2;
};

// KV-major pass: dK and dV of one 64-key tile, and with kDq the tile's
// dQ contributions added atomically into the f32 scratch.
template <int D, bool kDq>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const BwdArgs a) {
  using T = Dims<D>;
  constexpr int LD = T::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kBlockN * LD;
  __nv_bfloat16* Qs = Vs + kBlockN * LD;
  __nv_bfloat16* dOs = Qs + kBlockM * LD;
  __nv_bfloat16* dSs = dOs + kBlockM * LD;   // [64 keys][kLdS q], kDq only
  float* lse2_s = reinterpret_cast<float*>(dSs + (kDq ? kBlockN * kLdS : 0));
  float* delta_s = lse2_s + kBlockM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma group id: fragment row
  const int tg = lane & 3;   // thread in group: fragment column pair
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int n0 = blockIdx.x * kBlockN;
  const int kr = warp * 16;  // this warp's first key row in the tile

  const __nv_bfloat16* qh = a.q + b * a.qsb + h * a.qsh;
  const __nv_bfloat16* kh = a.k + b * a.ksb + h * a.ksh;
  const __nv_bfloat16* vh = a.v + b * a.vsb + h * a.vsh;
  const __nv_bfloat16* oh = a.o + b * a.osb + h * a.osh;
  const __nv_bfloat16* doh = a.dout + b * a.dosb + h * a.dosh;
  const float* lse_bh = a.lse + static_cast<long long>(blockIdx.y) * a.Sq;

  load_tile<D>(Ks, kh, a.kss, n0, a.Sk);
  load_tile<D>(Vs, vh, a.vss, n0, a.Sk);
  const bool key_ok[2] = {n0 + kr + g < a.Sk, n0 + kr + g + 8 < a.Sk};

  float dk_acc[T::kDTiles][4];
  float dv_acc[T::kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < T::kDTiles; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;
  }

  const int n_qt = (a.Sq + kBlockM - 1) / kBlockM;
  for (int i = 0; i < n_qt; ++i) {
    const int m0 = i * kBlockM;
    __syncthreads();   // every warp is done with the previous q tile
    load_tile<D>(Qs, qh, a.qss, m0, a.Sq);
    load_tile<D>(dOs, doh, a.doss, m0, a.Sq);
    load_row_stats<D>(lse2_s, delta_s, lse_bh, oh, a.oss, doh, a.doss, m0,
                      a.Sq);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 q rows
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < T::kSteps; ++kk) {
      const int c = kk * 16 + tg * 2;
      uint32_t ka[4], va[4];
      ka[0] = ld_u32(&Ks[(kr + g) * LD + c]);
      ka[1] = ld_u32(&Ks[(kr + g + 8) * LD + c]);
      ka[2] = ld_u32(&Ks[(kr + g) * LD + c + 8]);
      ka[3] = ld_u32(&Ks[(kr + g + 8) * LD + c + 8]);
      va[0] = ld_u32(&Vs[(kr + g) * LD + c]);
      va[1] = ld_u32(&Vs[(kr + g + 8) * LD + c]);
      va[2] = ld_u32(&Vs[(kr + g) * LD + c + 8]);
      va[3] = ld_u32(&Vs[(kr + g + 8) * LD + c + 8]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bq[2], bd[2];
        bq[0] = ld_u32(&Qs[(nt * 8 + g) * LD + c]);
        bq[1] = ld_u32(&Qs[(nt * 8 + g) * LD + c + 8]);
        bd[0] = ld_u32(&dOs[(nt * 8 + g) * LD + c]);
        bd[1] = ld_u32(&dOs[(nt * 8 + g) * LD + c + 8]);
        mma_16816(s[nt], ka, bq);
        mma_16816(dp[nt], va, bd);
      }
    }

    // p = exp(s * scale - lse), masked; dS = p * (dP - delta). Rows of
    // the accumulators are keys (g, g + 8), columns are q rows.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + tg * 2 + (e & 1);
        const float p = key_ok[e >> 1]
            ? exp2f(fmaf(s[nt][e], a.scale_log2, -lse2_s[qc])) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - delta_s[qc]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: A straight from the accumulator
    // registers (bf16), B read column-wise from shared memory
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      uint32_t pa[4], sa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      sa[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      sa[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      sa[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      sa[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      const int qrow = kk * 16 + tg * 2;
#pragma unroll
      for (int dt = 0; dt < T::kDTiles; ++dt) {
        const int col = dt * 8 + g;
        uint32_t bd[2], bq[2];
        bd[0] = ld_col2(&dOs[qrow * LD + col], LD);
        bd[1] = ld_col2(&dOs[(qrow + 8) * LD + col], LD);
        bq[0] = ld_col2(&Qs[qrow * LD + col], LD);
        bq[1] = ld_col2(&Qs[(qrow + 8) * LD + col], LD);
        mma_16816(dv_acc[dt], pa, bd);
        mma_16816(dk_acc[dt], sa, bq);
      }
    }

    if constexpr (kDq) {
      // this warp's dS^T rows into shared memory, then dQ = dS K for
      // q rows [16 * warp, 16 * warp + 16) over the tile's 64 keys
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nt * 8 + tg * 2;
        *reinterpret_cast<uint32_t*>(&dSs[(kr + g) * kLdS + col]) =
            pack_bf16(dp[nt][0], dp[nt][1]);
        *reinterpret_cast<uint32_t*>(&dSs[(kr + g + 8) * kLdS + col]) =
            pack_bf16(dp[nt][2], dp[nt][3]);
      }
      __syncthreads();
      const int qr = warp * 16;
      float dq[T::kDTiles][4];
#pragma unroll
      for (int dt = 0; dt < T::kDTiles; ++dt) {
        dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const int key = kk * 16 + tg * 2;
        // A[q][key] = dS^T[key][q]: column pairs of the dS tile
        uint32_t da[4];
        da[0] = ld_col2(&dSs[key * kLdS + qr + g], kLdS);
        da[1] = ld_col2(&dSs[key * kLdS + qr + g + 8], kLdS);
        da[2] = ld_col2(&dSs[(key + 8) * kLdS + qr + g], kLdS);
        da[3] = ld_col2(&dSs[(key + 8) * kLdS + qr + g + 8], kLdS);
#pragma unroll
        for (int dt = 0; dt < T::kDTiles; ++dt) {
          const int col = dt * 8 + g;
          uint32_t bk[2];
          bk[0] = ld_col2(&Ks[key * LD + col], LD);
          bk[1] = ld_col2(&Ks[(key + 8) * LD + col], LD);
          mma_16816(dq[dt], da, bk);
        }
      }
      float* dqh = static_cast<float*>(a.dq) +
                   (static_cast<long long>(b) * a.Sq * a.H + h) * D;
      const long long dqs = static_cast<long long>(a.H) * D;
      const int row0 = m0 + qr + g;
#pragma unroll
      for (int dt = 0; dt < T::kDTiles; ++dt) {
        const int col = dt * 8 + tg * 2;
        if (row0 < a.Sq) {
          atomicAdd(dqh + row0 * dqs + col, dq[dt][0] * a.scale);
          atomicAdd(dqh + row0 * dqs + col + 1, dq[dt][1] * a.scale);
        }
        if (row0 + 8 < a.Sq) {
          atomicAdd(dqh + (row0 + 8) * dqs + col, dq[dt][2] * a.scale);
          atomicAdd(dqh + (row0 + 8) * dqs + col + 1, dq[dt][3] * a.scale);
        }
      }
    }
  }

  // dK (scaled) and dV of this warp's 16 keys; [B, Sk, H, D] contiguous
  const long long rs = static_cast<long long>(a.H) * D;
  const long long base = (static_cast<long long>(b) * a.Sk * a.H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!key_ok[r]) continue;
    const long long off = base + (n0 + kr + g + 8 * r) * rs;
#pragma unroll
    for (int dt = 0; dt < T::kDTiles; ++dt) {
      const int col = dt * 8 + tg * 2;
      *reinterpret_cast<uint32_t*>(a.dk + off + col) = pack_bf16(
          dk_acc[dt][2 * r] * a.scale, dk_acc[dt][2 * r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(a.dv + off + col) =
          pack_bf16(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

// q-major pass: dQ of one 64-row q tile over every KV tile, in registers
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdArgs a) {
  using T = Dims<D>;
  constexpr int LD = T::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + kBlockM * LD;
  __nv_bfloat16* Ks = dOs + kBlockM * LD;
  __nv_bfloat16* Vs = Ks + kBlockN * LD;
  float* lse2_s = reinterpret_cast<float*>(Vs + kBlockN * LD);
  float* delta_s = lse2_s + kBlockM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int m0 = blockIdx.x * kBlockM;
  const int qr = warp * 16;  // this warp's first q row in the tile

  const __nv_bfloat16* qh = a.q + b * a.qsb + h * a.qsh;
  const __nv_bfloat16* kh = a.k + b * a.ksb + h * a.ksh;
  const __nv_bfloat16* vh = a.v + b * a.vsb + h * a.vsh;
  const __nv_bfloat16* oh = a.o + b * a.osb + h * a.osh;
  const __nv_bfloat16* doh = a.dout + b * a.dosb + h * a.dosh;
  const float* lse_bh = a.lse + static_cast<long long>(blockIdx.y) * a.Sq;

  load_tile<D>(Qs, qh, a.qss, m0, a.Sq);
  load_tile<D>(dOs, doh, a.doss, m0, a.Sq);
  load_row_stats<D>(lse2_s, delta_s, lse_bh, oh, a.oss, doh, a.doss, m0,
                    a.Sq);
  __syncthreads();

  // this warp's q and dO rows as A fragments, kept in registers
  uint32_t qf[T::kSteps][4], df[T::kSteps][4];
#pragma unroll
  for (int kk = 0; kk < T::kSteps; ++kk) {
    const int c = kk * 16 + tg * 2;
    qf[kk][0] = ld_u32(&Qs[(qr + g) * LD + c]);
    qf[kk][1] = ld_u32(&Qs[(qr + g + 8) * LD + c]);
    qf[kk][2] = ld_u32(&Qs[(qr + g) * LD + c + 8]);
    qf[kk][3] = ld_u32(&Qs[(qr + g + 8) * LD + c + 8]);
    df[kk][0] = ld_u32(&dOs[(qr + g) * LD + c]);
    df[kk][1] = ld_u32(&dOs[(qr + g + 8) * LD + c]);
    df[kk][2] = ld_u32(&dOs[(qr + g) * LD + c + 8]);
    df[kk][3] = ld_u32(&dOs[(qr + g + 8) * LD + c + 8]);
  }
  const float lse2[2] = {lse2_s[qr + g], lse2_s[qr + g + 8]};
  const float delta[2] = {delta_s[qr + g], delta_s[qr + g + 8]};

  float dq[T::kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < T::kDTiles; ++dt) {
    dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
  }

  const int n_kt = (a.Sk + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_kt; ++j) {
    const int n0 = j * kBlockN;
    __syncthreads();   // every warp is done with the previous KV tile
    load_tile<D>(Ks, kh, a.kss, n0, a.Sk);
    load_tile<D>(Vs, vh, a.vss, n0, a.Sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 q rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      const __nv_bfloat16* krow = &Ks[(nt * 8 + g) * LD + tg * 2];
      const __nv_bfloat16* vrow = &Vs[(nt * 8 + g) * LD + tg * 2];
#pragma unroll
      for (int kk = 0; kk < T::kSteps; ++kk) {
        uint32_t bk[2], bv[2];
        bk[0] = ld_u32(krow + kk * 16);
        bk[1] = ld_u32(krow + kk * 16 + 8);
        bv[0] = ld_u32(vrow + kk * 16);
        bv[1] = ld_u32(vrow + kk * 16 + 8);
        mma_16816(s[nt], qf[kk], bk);
        mma_16816(dp[nt], df[kk], bv);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + nt * 8 + tg * 2 + (e & 1);
        const float p = key < a.Sk
            ? exp2f(fmaf(s[nt][e], a.scale_log2, -lse2[e >> 1])) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - delta[e >> 1]);
      }
    }
    // dQ += dS K: A from the dS registers (bf16), B = K column-wise
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t sa[4];
      sa[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      sa[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      sa[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      sa[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      const int key = kk * 16 + tg * 2;
#pragma unroll
      for (int dt = 0; dt < T::kDTiles; ++dt) {
        const int col = dt * 8 + g;
        uint32_t bk[2];
        bk[0] = ld_col2(&Ks[key * LD + col], LD);
        bk[1] = ld_col2(&Ks[(key + 8) * LD + col], LD);
        mma_16816(dq[dt], sa, bk);
      }
    }
  }

  // dQ (scaled), bf16, [B, Sq, H, D] contiguous
  __nv_bfloat16* dqh = static_cast<__nv_bfloat16*>(a.dq) +
                       (static_cast<long long>(b) * a.Sq * a.H + h) * D;
  const long long rs = static_cast<long long>(a.H) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + qr + g + 8 * r;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int dt = 0; dt < T::kDTiles; ++dt) {
      const int col = dt * 8 + tg * 2;
      *reinterpret_cast<uint32_t*>(dqh + row * rs + col) = pack_bf16(
          dq[dt][2 * r] * a.scale, dq[dt][2 * r + 1] * a.scale);
    }
  }
}

template <int D>
constexpr int kv_smem_bytes(bool with_dq) {
  return (2 * kBlockN + 2 * kBlockM) * Dims<D>::LD * 2 +
         (with_dq ? kBlockN * kLdS * 2 : 0) + 2 * kBlockM * 4;
}

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * kBlockN + 2 * kBlockM) * Dims<D>::LD * 2 + 2 * kBlockM * 4;
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int smem, const BwdArgs& a,
           cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

enum class Pass { kFused, kDkv, kDq };

template <int D>
int run(Pass pass, const BwdArgs& a, int B, cudaStream_t st) {
  const dim3 kv_grid((a.Sk + kBlockN - 1) / kBlockN, B * a.H);
  const dim3 q_grid((a.Sq + kBlockM - 1) / kBlockM, B * a.H);
  switch (pass) {
    case Pass::kFused:
      return launch(flash_bwd_kv_kernel<D, true>, kv_grid,
                    kv_smem_bytes<D>(true), a, st);
    case Pass::kDkv:
      return launch(flash_bwd_kv_kernel<D, false>, kv_grid,
                    kv_smem_bytes<D>(false), a, st);
    case Pass::kDq:
      return launch(flash_bwd_dq_kernel<D>, q_grid, dq_smem_bytes<D>(), a,
                    st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(Pass pass, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const void* lse, void* dq,
             void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
             long long qsb, long long qss, long long qsh, long long ksb,
             long long kss, long long ksh, long long vsb, long long vss,
             long long vsh, long long osb, long long oss, long long osh,
             long long dosb, long long doss, long long dosh, float scale,
             void* stream) {
  BwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dq = dq;
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.qsb = qsb; a.qss = qss; a.qsh = qsh;
  a.ksb = ksb; a.kss = kss; a.ksh = ksh;
  a.vsb = vsb; a.vss = vss; a.vsh = vsh;
  a.osb = osb; a.oss = oss; a.osh = osh;
  a.dosb = dosb; a.doss = doss; a.dosh = dosh;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 72) return run<72>(pass, a, B, st);
  if (D == 64) return run<64>(pass, a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o, dout [B, Sq, H, D], k/v [B, Sk, H, D]: bf16, strides in elements,
// last dim contiguous; lse f32 [B, H, Sq] contiguous; D 64 or 72. Outputs
// are contiguous: flash_attn_bwd adds dq into a zeroed f32 [B, Sq, H, D]
// buffer and writes bf16 dk, dv [B, Sk, H, D]; flash_attn_bwd_dkv writes
// dk, dv (dq unused); flash_attn_bwd_dq writes bf16 dq [B, Sq, H, D] (dk,
// dv unused). Each returns the CUDA error code of its launch (0 on
// success).
#define TOPIAXL_BWD_ENTRY(NAME, PASS)                                        \
  extern "C" int NAME(                                                       \
      const void* q, const void* k, const void* v, const void* o,            \
      const void* dout, const void* lse, void* dq, void* dk, void* dv,       \
      int B, int H, int Sq, int Sk, int D, long long qsb, long long qss,     \
      long long qsh, long long ksb, long long kss, long long ksh,            \
      long long vsb, long long vss, long long vsh, long long osb,            \
      long long oss, long long osh, long long dosb, long long doss,          \
      long long dosh, float scale, void* stream) {                           \
    return dispatch(PASS, q, k, v, o, dout, lse, dq, dk, dv, B, H, Sq, Sk,   \
                    D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, \
                    osh, dosb, doss, dosh, scale, stream);                   \
  }

TOPIAXL_BWD_ENTRY(topiaxl_flash_attn_bwd, Pass::kFused)
TOPIAXL_BWD_ENTRY(topiaxl_flash_attn_bwd_dkv, Pass::kDkv)
TOPIAXL_BWD_ENTRY(topiaxl_flash_attn_bwd_dq, Pass::kDq)
