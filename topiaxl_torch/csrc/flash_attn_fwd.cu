// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU kernel topiaxl/ops/flash_attention.py:_flash_kernel
// (wrapped by _flash_forward / flash_attention). It computes
// softmax(q k^T * scale) v with an online softmax: logits, running max,
// denominator and accumulator are f32; P is rounded to bf16 before the
// P.V product, as the TPU kernel does; the output is bf16. Given an lse
// buffer it also writes the logsumexp of the scaled logits, f32 [B, H,
// Sq] (the TPU kernel's lse_ref), which the backward kernels
// (flash_attn_bwd.cu) rebuild the softmax from.
//
// What bounds it on an H100: tensor-core FLOPs. At the DiT's shapes
// (2 x 2048 x 2048, 16 heads of 72) the kernel does ~2*2*Sq*Sk*D FLOPs
// per head against ~(Sq + 2*Sk)*D*2 bytes, far above the card's
// FLOP-per-byte ridge. The design keeps logits out of device memory and
// feeds the tensor cores through mma.sync m16n8k16 (bf16, f32
// accumulate):
//   * one block of 4 warps per (batch*head, 64-row q tile); each warp
//     owns 16 q rows whose A fragments stay in registers;
//   * K and V stream through shared memory in 64-key tiles;
//   * S = Q K^T and O += P V both run on mma.sync, with P reused from
//     the S accumulator registers (no shared-memory round trip);
//   * the [B, S, H, D] strides are read directly: no fold, no
//     transpose, no padding in device memory;
//   * head_dim 72 is zero-padded to 80 only in shared memory, so the
//     Q K^T contraction runs in 16-wide steps; the P V product covers
//     exactly D/8 output column tiles;
//   * ragged Sq and Sk (1370, 1374) are masked inside the kernel.
// It is a simple first kernel: loads are synchronous (no cp.async/TMA
// pipeline) and no wgmma. Those are later work. The block shape and the
// mma/tile helpers (mma_tile.cuh) are shared with the backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr float kNegBig = -1e30f;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Sk,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 long long osb, long long oss, long long osh,
                 float scale_log2) {
  constexpr int kSteps = Dims<D>::kSteps;    // Q K^T contraction steps
  constexpr int LD = Dims<D>::LD;
  constexpr int kDTiles = Dims<D>::kDTiles;  // output column tiles

  __shared__ __align__(16) __nv_bfloat16 Qs[kBlockM * LD];
  __shared__ __align__(16) __nv_bfloat16 Ks[kBlockN * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBlockN * LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma group id: fragment row
  const int tg = lane & 3;   // thread in group: fragment column pair
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int m0 = blockIdx.x * kBlockM;

  const __nv_bfloat16* qh = q + b * qsb + h * qsh;
  const __nv_bfloat16* kh = k + b * ksb + h * ksh;
  const __nv_bfloat16* vh = v + b * vsb + h * vsh;

  // zero all three tiles once, so the head-dim padding stays zero and
  // the tile loads write only the D real columns
  {
    constexpr int kWords = kBlockM * LD / 8;
    uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < kWords; i += kThreads) {
      reinterpret_cast<uint4*>(Qs)[i] = z;
      reinterpret_cast<uint4*>(Ks)[i] = z;
      reinterpret_cast<uint4*>(Vs)[i] = z;
    }
  }
  __syncthreads();
  load_tile<D, false>(Qs, qh, qss, m0, Sq);
  __syncthreads();

  // this warp's 16 q rows as mma A fragments, kept in registers
  uint32_t qf[kSteps][4];
  const int qr = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int c = kk * 16 + tg * 2;
    qf[kk][0] = ld_u32(&Qs[qr * LD + c]);
    qf[kk][1] = ld_u32(&Qs[(qr + 8) * LD + c]);
    qf[kk][2] = ld_u32(&Qs[qr * LD + c + 8]);
    qf[kk][3] = ld_u32(&Qs[(qr + 8) * LD + c + 8]);
  }

  // rows g and g + 8 of the warp's tile: running max (log2 units),
  // this thread's partial denominator, and the f32 output accumulator
  float m_run[2] = {kNegBig, kNegBig};
  float l_run[2] = {0.f, 0.f};
  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }

  const int n_tiles = (Sk + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kBlockN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, false>(Ks, kh, kss, n0, Sk);
    load_tile<D, false>(Vs, vh, vss, n0, Sk);
    __syncthreads();

    // S = Q K^T over 8 column tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = &Ks[(nt * 8 + g) * LD + tg * 2];
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t bf[2];
        bf[0] = ld_u32(krow + kk * 16);
        bf[1] = ld_u32(krow + kk * 16 + 8);
        mma_16816(s[nt], qf[kk], bf);
      }
    }

    // scale in f32 (log2 units), mask keys past Sk, row max
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + tg * 2 + (e & 1);
        const float val = col < Sk ? s[nt][e] * scale_log2 : kNegBig;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        l_run[e >> 1] += p;
      }
    }

    // O += P V: P (bf16) straight from the S registers as A fragments,
    // V read column-wise from shared memory as B fragments
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + tg * 2;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const int col = dt * 8 + g;
        uint32_t bf[2];
        bf[0] = ld_col2(&Vs[key * LD + col], LD);
        bf[1] = ld_col2(&Vs[(key + 8) * LD + col], LD);
        mma_16816(acc[dt], pa, bf);
      }
    }
  }

  // full row denominators (the 4 threads of a group share a row)
  float inv[2];
  const int row_a = m0 + warp * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    inv[r] = 1.f / l;
    // lse = m + log(l) in natural units; m_run is in log2 units
    if (lse != nullptr && tg == 0 && row_a + 8 * r < Sq) {
      lse[static_cast<long long>(blockIdx.y) * Sq + row_a + 8 * r] =
          (m_run[r] + log2f(l)) * 0.6931471805599453f;
    }
  }
  __nv_bfloat16* oh = o + b * osb + h * osh;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int col = dt * 8 + tg * 2;
    if (row_a < Sq) {
      *reinterpret_cast<uint32_t*>(oh + row_a * oss + col) =
          pack_bf16(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    }
    if (row_a + 8 < Sq) {
      *reinterpret_cast<uint32_t*>(oh + (row_a + 8) * oss + col) =
          pack_bf16(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
    }
  }
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Sk, H, D], o [B, Sq, H, D]: bf16, strides in
// elements, last dim contiguous. D must be 64 or 72. lse is null or an
// f32 [B, H, Sq] contiguous buffer. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int topiaxl_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int H,
    int Sq, int Sk, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss,
    long long osh, float scale, void* stream) {
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, B * H);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  if (D == 72) {
    flash_fwd_kernel<72><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, lp, H, Sq, Sk, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
        vsh, osb, oss, osh, scale_log2);
  } else if (D == 64) {
    flash_fwd_kernel<64><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, lp, H, Sq, Sk, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
        vsh, osb, oss, osh, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
