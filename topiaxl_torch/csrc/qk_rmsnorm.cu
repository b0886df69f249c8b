// Per-head RMS normalisation of attention queries and keys for Hopper
// (sm_90a), bf16 in / bf16 out, forward and backward, in two forms chosen
// at compile time (kRms) by the entry point.
//
// Replaces no TPU kernel: the JAX package has no QK norm. It was added
// for TRELLIS's sparse-structure flow transformer (models/ss_flow.py),
// whose self-attention normalises q and k per head, the "l2" form
// (TRELLIS's MultiHeadRMSNorm):
//   forward:  y = x / max(||x||, 1e-12) * gamma[h] * scale
//   backward: with n = max(||x||, 1e-12), xh = x / n, g = gamma[h] * scale * dy,
//             dx = (g - xh * <xh, g>) / n where ||x|| > 1e-12, else g / n,
//             dgamma[h] = scale * sum over rows of head h of dy * xh
// and, for Hunyuan3D-2's shape DiT (models/mmdit.py), the "rms" form
// (FLUX's RMSNorm in its QKNorm: the epsilon inside the mean):
//   forward:  y = x * r * gamma[h] * scale, r = rsqrt(sum(x^2) / D + 1e-6)
//   backward: with xh = x * r, g = gamma[h] * scale * dy,
//             dx = r * (g - xh * <xh, g> / D),
//             dgamma[h] = scale * sum over rows of head h of dy * xh
// over each row of D values (one head of one token); the math in f32,
// each output rounded to bf16 once. scale is sqrt(D) in TRELLIS's model,
// 1 in Hunyuan3D-2's, whose gain is one vector shared by the heads (the
// wrapper passes it expanded to [H, D] and sums its gradient over H).
// The two forms share every load, store and reduction; they differ in the
// row's factor alone (and the l2 form's clamp).
//
// What bounds it on an H100: device-memory bytes. The forward reads a row
// and writes it (~1 FLOP per byte); the backward reads x and dy and writes
// dx. The design: L = D / 8 lanes a row, each with one 16-byte load of
// each input; the row's sums of squares and dot products reduced by
// shuffles inside its L lanes; no shared memory on the row's path and no
// second read. x is read where the qkv projection left it (any row
// strides, last dim contiguous), so q and k are normalised in place of a
// copy and written contiguous [B, N, H, D], as flash attention takes
// them. gamma [H, D] f32 is small and stays in L1.
//
// The backward's dgamma: a block holds k whole tokens' worth of rows
// (k * H rows, L lanes each) and walks the rows with a stride that is a
// multiple of H, so each thread always meets the same head and columns
// and keeps its 8 partial sums in registers; at the end the threads of a
// head add theirs in a fixed order through shared memory and the block
// writes one partial [H, D] sum. The wrapper adds the blocks' partials
// (ops/qk_norm.py), so the result does not depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-12f;      // the l2 form's clamp of ||x||
constexpr float kRmsEps = 1e-6f;    // the rms form's epsilon, in the mean

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

// sum over the L lanes of a row (L a power of two up to 32, the row's
// lanes consecutive and aligned to L inside the warp)
__device__ __forceinline__ float row_sum(float v, int L) {
  for (int o = L >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Rows {
  // x [B, N, H, D] at strides (sb, sn, sh, 1) elements; rows in (b, n, h)
  // order, h fastest
  long long sb, sn, sh;
  int N, H;

  __device__ __forceinline__ long long offset(long long row) const {
    const int h = static_cast<int>(row % H);
    const long long tok = row / H;
    return (tok / N) * sb + (tok % N) * sn + h * sh;
  }
};

template <bool kRms>
__global__ void qk_rmsnorm_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                                      const float* __restrict__ gamma,
                                      __nv_bfloat16* __restrict__ y,
                                      Rows in, long long rows, int D,
                                      float scale) {
  const int L = D >> 3;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / L) + threadIdx.x / L;
  const int c = (threadIdx.x % L) * 8;
  // every lane of a warp takes part in the shuffles, so a lane past the
  // last row computes on row 0 and does not write
  const bool live = row < rows;
  const long long r = live ? row : 0;
  float v[8], g[8];
  unpack8(*reinterpret_cast<const uint4*>(x + in.offset(r) + c), v);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) ss += v[j] * v[j];
  float inv;
  if constexpr (kRms) {
    inv = scale * rsqrtf(row_sum(ss, L) / D + kRmsEps);
  } else {
    inv = scale / fmaxf(sqrtf(row_sum(ss, L)), kEps);
  }
  const float* gh = gamma + static_cast<int>(r % in.H) * D + c;
  *reinterpret_cast<float4*>(g) = *reinterpret_cast<const float4*>(gh);
  *reinterpret_cast<float4*>(g + 4) = *reinterpret_cast<const float4*>(gh + 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] *= inv * g[j];
  if (live) *reinterpret_cast<uint4*>(y + r * D + c) = pack8(v);
}

template <bool kRms>
__global__ void qk_rmsnorm_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                                      const __nv_bfloat16* __restrict__ dy,
                                      const float* __restrict__ gamma,
                                      __nv_bfloat16* __restrict__ dx,
                                      float* __restrict__ dgamma_part,
                                      Rows in, long long rows, int D,
                                      float scale) {
  extern __shared__ float part[];   // [rows a block][D]
  const int L = D >> 3;
  const int per_block = blockDim.x / L;    // a multiple of H
  const int slot = threadIdx.x / L;
  const int c = (threadIdx.x % L) * 8;
  const int h = slot % in.H;
  float g[8], acc[8];
  const float* gh = gamma + h * D + c;
  *reinterpret_cast<float4*>(g) = *reinterpret_cast<const float4*>(gh);
  *reinterpret_cast<float4*>(g + 4) = *reinterpret_cast<const float4*>(gh + 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    g[j] *= scale;
    acc[j] = 0.f;
  }
  const long long stride = static_cast<long long>(gridDim.x) * per_block;
  // the loop runs alike for every lane of a warp (rows a warp spans start
  // together), so the shuffles see all their lanes
  for (long long base = static_cast<long long>(blockIdx.x) * per_block;
       base < rows; base += stride) {
    const long long row = base + slot;
    const bool live = row < rows;
    const long long r = live ? row : 0;
    float xv[8], gy[8];
    unpack8(*reinterpret_cast<const uint4*>(x + in.offset(r) + c), xv);
    unpack8(*reinterpret_cast<const uint4*>(dy + r * D + c), gy);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += xv[j] * xv[j];
    float norm, inv;
    if constexpr (kRms) {
      norm = 0.f;                   // unused: the rms form has no clamp
      inv = rsqrtf(row_sum(ss, L) / D + kRmsEps);
    } else {
      norm = sqrtf(row_sum(ss, L));
      inv = 1.f / fmaxf(norm, kEps);
    }
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xv[j] *= inv;                 // xh
      if (live) acc[j] += gy[j] * xv[j];
      gy[j] *= g[j];                // gamma * scale * dy
      dot += xv[j] * gy[j];
    }
    dot = row_sum(dot, L);
    if constexpr (kRms) {
      dot /= D;
    } else {
      if (!(norm > kEps)) dot = 0.f;  // the clamp: y = x * scale * gamma / eps
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) gy[j] = (gy[j] - xv[j] * dot) * inv;
    if (live) *reinterpret_cast<uint4*>(dx + r * D + c) = pack8(gy);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) part[slot * D + c + j] = acc[j] * scale;
  __syncthreads();
  // thread i < H * D adds column i % D of head i / D over the block's
  // slots of that head, in slot order
  for (int i = threadIdx.x; i < in.H * D; i += blockDim.x) {
    const int hh = i / D, col = i % D;
    float s = 0.f;
    for (int k = hh; k < per_block; k += in.H) s += part[k * D + col];
    dgamma_part[static_cast<long long>(blockIdx.x) * in.H * D + i] = s;
  }
}

// threads a block: k tokens of H rows, L lanes a row, whole warps, k the
// most that keeps the block at or under 256 threads (at least the fewest
// tokens that fill whole warps); 0 for a shape the kernels do not take
int block_threads(int H, int D) {
  const int L = D >> 3;
  if (H <= 0 || D % 8 != 0 || L <= 0 || L > 32 || (L & (L - 1)) != 0) {
    return 0;
  }
  const int per_token = H * L;
  int unit = 1;   // tokens that fill whole warps: 32 / gcd(per_token, 32)
  while ((unit * per_token) % 32 != 0) unit <<= 1;
  int k = (256 / (unit * per_token)) * unit;
  if (k < unit) k = unit;
  return k * per_token <= 1024 ? k * per_token : 0;
}

template <bool kRms>
int launch_fwd(const void* x, const void* gamma, void* y, int B, int N,
               int H, int D, long long sb, long long sn, long long sh,
               float scale, void* stream) {
  const long long rows = static_cast<long long>(B) * N * H;
  if (B <= 0 || N <= 0 || block_threads(H, D) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 256;   // whole rows: L divides 32
  const long long per_block = threads / (D >> 3);
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  qk_rmsnorm_fwd_kernel<kRms><<<static_cast<unsigned>(blocks), threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<__nv_bfloat16*>(y), Rows{sb, sn, sh, N, H}, rows, D,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRms>
int launch_bwd(const void* x, const void* dy, const void* gamma, void* dx,
               void* dgamma_part, int blocks, int B, int N, int H, int D,
               long long sb, long long sn, long long sh, float scale,
               void* stream) {
  const long long rows = static_cast<long long>(B) * N * H;
  const int threads = block_threads(H, D);
  if (B <= 0 || N <= 0 || blocks <= 0 || threads == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * (threads / (D >> 3)) * D;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qk_rmsnorm_bwd_kernel<kRms>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  qk_rmsnorm_bwd_kernel<kRms><<<blocks, threads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), static_cast<const float*>(gamma),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(dgamma_part),
      Rows{sb, sn, sh, N, H}, rows, D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, N, H, D] bf16 at element strides (sb, sn, sh, 1); gamma [H, D] f32
// contiguous; y [B, N, H, D] bf16 contiguous. D / 8 a power of two up to
// 32. Returns the launch's CUDA error code. topiaxl_qk_rmsnorm computes
// the l2 form, topiaxl_qk_rmsnorm_rms the rms form (header).
extern "C" int topiaxl_qk_rmsnorm(const void* x, const void* gamma, void* y,
                                  int B, int N, int H, int D, long long sb,
                                  long long sn, long long sh, float scale,
                                  void* stream) {
  return launch_fwd<false>(x, gamma, y, B, N, H, D, sb, sn, sh, scale, stream);
}

extern "C" int topiaxl_qk_rmsnorm_rms(const void* x, const void* gamma,
                                      void* y, int B, int N, int H, int D,
                                      long long sb, long long sn,
                                      long long sh, float scale,
                                      void* stream) {
  return launch_fwd<true>(x, gamma, y, B, N, H, D, sb, sn, sh, scale, stream);
}

// The number of blocks the backward launches at this shape, either form
// (the rows of the partial dgamma [blocks, H, D] f32 the caller
// allocates), or 0 for a shape the kernel does not take.
extern "C" int topiaxl_qk_rmsnorm_bwd_blocks(int B, int N, int H, int D,
                                             int sms) {
  const long long rows = static_cast<long long>(B) * N * H;
  const int threads = block_threads(H, D);
  if (B <= 0 || N <= 0 || sms <= 0 || threads == 0) return 0;
  const long long per_block = threads / (D >> 3);
  const long long need = (rows + per_block - 1) / per_block;
  // enough blocks to fill every SM at full occupancy, no more: each walks
  // its share of the rows
  const long long fill = static_cast<long long>(sms) * (2048 / threads);
  return static_cast<int>(need < fill ? need : fill);
}

// x as the forward's; dy and dx [B, N, H, D] bf16 contiguous; gamma [H, D]
// f32; dgamma_part [blocks, H, D] f32, blocks from
// topiaxl_qk_rmsnorm_bwd_blocks. The l2 form, then the rms form.
extern "C" int topiaxl_qk_rmsnorm_bwd(const void* x, const void* dy,
                                      const void* gamma, void* dx,
                                      void* dgamma_part, int blocks, int B,
                                      int N, int H, int D, long long sb,
                                      long long sn, long long sh,
                                      float scale, void* stream) {
  return launch_bwd<false>(x, dy, gamma, dx, dgamma_part, blocks, B, N, H, D,
                           sb, sn, sh, scale, stream);
}

extern "C" int topiaxl_qk_rmsnorm_rms_bwd(const void* x, const void* dy,
                                          const void* gamma, void* dx,
                                          void* dgamma_part, int blocks,
                                          int B, int N, int H, int D,
                                          long long sb, long long sn,
                                          long long sh, float scale,
                                          void* stream) {
  return launch_bwd<true>(x, dy, gamma, dx, dgamma_part, blocks, B, N, H, D,
                          sb, sn, sh, scale, stream);
}
