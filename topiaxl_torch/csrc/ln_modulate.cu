// Fused LayerNorm + adaLN modulate (and the residual gate-add variant)
// for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU kernels topiaxl/ops/fused_ln.py:_ln_mod_kernel
// (ln_modulate) and :_ln_mod_res_kernel (ln_modulate_residual).
//   ln_modulate:          h = LN(x) * (1 + scale[b]) + shift[b]
//   ln_modulate_residual: x_new = x + gate[b] * delta;
//                         h = LN(x_new) * (1 + scale[b]) + shift[b]
// LN is affine-free over the last dim D with f32 mean and variance
// (two passes over the row held in registers, eps added before rsqrt);
// the modulate runs in f32 and each output is cast to bf16 once. h is
// computed from the unrounded f32 x_new, as on the TPU.
//
// What bounds it on an H100: device-memory bytes. Each row is read once
// and written once (twice for the residual variant), ~2 FLOP per byte,
// so the kernel can only approach the HBM roofline. The design: one warp
// per row, 16-byte vectorised bf16 loads and stores, the whole row kept
// in registers between the statistics and the write, no shared memory
// and no second read of the row. The per-batch shift/scale/gate vectors
// are read with their own batch stride, so column slices of the DiT's
// adaLN output need no copy. Any D that is a multiple of 8 up to 4096.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 4;  // one warp per row
constexpr int kThreads = kRowsPerBlock * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(p[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 raw;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) p[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return raw;
}

__device__ __forceinline__ uint4 ld16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// VPL: 8-element vectors per lane (ceil(D / 256)); RES: residual variant
template <int VPL, bool RES>
__global__ void __launch_bounds__(kThreads)
ln_modulate_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ delta,
                   const __nv_bfloat16* __restrict__ gate,
                   const __nv_bfloat16* __restrict__ shift,
                   const __nv_bfloat16* __restrict__ scale,
                   __nv_bfloat16* __restrict__ x_out,
                   __nv_bfloat16* __restrict__ h_out, int rows, int N,
                   int D, long long gate_sb, long long shift_sb,
                   long long scale_sb, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int b = row / N;
  const long long off = static_cast<long long>(row) * D;
  const int n_vec = D >> 3;

  float xv[VPL][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + i * 32;
    if (c < n_vec) {
      unpack8(ld16(x + off + c * 8), xv[i]);
      if (RES) {
        float d[8], gv[8];
        unpack8(ld16(delta + off + c * 8), d);
        unpack8(ld16(gate + b * gate_sb + c * 8), gv);
#pragma unroll
        for (int j = 0; j < 8; ++j) xv[i][j] += gv[j] * d[j];
        *reinterpret_cast<uint4*>(x_out + off + c * 8) = pack8(xv[i]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += xv[i][j];
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) xv[i][j] = 0.f;
    }
  }
  const float inv_d = 1.f / static_cast<float>(D);
  const float mean = warp_sum(sum) * inv_d;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + i * 32 < n_vec) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float t = xv[i][j] - mean;
        sq += t * t;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);

#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + i * 32;
    if (c < n_vec) {
      float sh[8], sc[8], y[8];
      unpack8(ld16(shift + b * shift_sb + c * 8), sh);
      unpack8(ld16(scale + b * scale_sb + c * 8), sc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[j] = (xv[i][j] - mean) * rstd * (1.f + sc[j]) + sh[j];
      }
      *reinterpret_cast<uint4*>(h_out + off + c * 8) = pack8(y);
    }
  }
}

template <bool RES>
int launch(const void* x, const void* delta, const void* gate,
           const void* shift, const void* scale, void* x_out, void* h_out,
           int rows, int N, int D, long long gate_sb, long long shift_sb,
           long long scale_sb, float eps, void* stream) {
  if (D % 8 != 0 || D <= 0 || N <= 0 || rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vpl = (D / 8 + 31) / 32;
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TOPIAXL_LN_CASE(V)                                                  \
  if (vpl <= V) {                                                           \
    ln_modulate_kernel<V, RES><<<grid, kThreads, 0, st>>>(                  \
        static_cast<const __nv_bfloat16*>(x),                               \
        static_cast<const __nv_bfloat16*>(delta),                           \
        static_cast<const __nv_bfloat16*>(gate),                            \
        static_cast<const __nv_bfloat16*>(shift),                           \
        static_cast<const __nv_bfloat16*>(scale),                           \
        static_cast<__nv_bfloat16*>(x_out),                                 \
        static_cast<__nv_bfloat16*>(h_out), rows, N, D, gate_sb, shift_sb, \
        scale_sb, eps);                                                     \
    return static_cast<int>(cudaGetLastError());                            \
  }
  TOPIAXL_LN_CASE(1)
  TOPIAXL_LN_CASE(2)
  TOPIAXL_LN_CASE(3)
  TOPIAXL_LN_CASE(4)
  TOPIAXL_LN_CASE(5)
  TOPIAXL_LN_CASE(6)
  TOPIAXL_LN_CASE(8)
  TOPIAXL_LN_CASE(12)
  TOPIAXL_LN_CASE(16)
#undef TOPIAXL_LN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x/out [rows = B*N, D] bf16 contiguous; shift/scale rows of D bf16 at
// batch strides *_sb (elements). Returns the launch's CUDA error code.
extern "C" int topiaxl_ln_modulate(const void* x, const void* shift,
                                   const void* scale, void* out, int rows,
                                   int N, int D, long long shift_sb,
                                   long long scale_sb, float eps,
                                   void* stream) {
  return launch<false>(x, nullptr, nullptr, shift, scale, nullptr, out,
                       rows, N, D, 0, shift_sb, scale_sb, eps, stream);
}

// as above, plus delta [rows, D], gate rows at batch stride gate_sb, and
// the second output x_out [rows, D] = x + gate * delta
extern "C" int topiaxl_ln_modulate_residual(
    const void* x, const void* delta, const void* gate, const void* shift,
    const void* scale, void* x_out, void* h_out, int rows, int N, int D,
    long long gate_sb, long long shift_sb, long long scale_sb, float eps,
    void* stream) {
  return launch<true>(x, delta, gate, shift, scale, x_out, h_out, rows, N,
                      D, gate_sb, shift_sb, scale_sb, eps, stream);
}
