// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU kernel topiaxl/ops/flash_attention.py:_flash_kernel
// (wrapped by _flash_forward / flash_attention). It computes
// softmax(q k^T * scale) v with an online softmax: logits, running max,
// denominator and accumulator are f32; P is rounded to bf16 before the
// P.V product, as the TPU kernel does; the output is bf16. Given an lse
// buffer it also writes the logsumexp of the scaled logits, f32 [B, H,
// Sq] (the TPU kernel's lse_ref), which the backward kernels rebuild the
// softmax from.
//
// What bounds it on an H100: tensor-core FLOPs (4 Sq Sk D per head
// against ~2 (Sq + 2 Sk) D bytes, far above the card's FLOP-per-byte
// ridge), and, at head dim 72, nearly as much the exponentials: 2 x 16 x
// 2048^2 exp2 per DiT self-attention launch take about as long on the
// special-function units as its products on the tensor cores. The design
// (the shape of FlashAttention-3):
//   * one block per (batch*head, 128-row q tile): two consumer
//     warpgroups of 64 q rows each and one producer warpgroup;
//   * the producer keeps TMA loads of K and V tiles (128 keys; 64 at head
//     dim 256) in flight in a two-stage shared-memory ring (mbarrier
//     full/empty pairs, K and V released separately); Q is loaded once;
//     setmaxnreg moves the producer's registers to the consumers;
//   * S = Q K^T runs on wgmma m64n128k16 (m64n64k16 at head dim 256) with
//     both operands in shared memory (K-major over D); O += P V on wgmma
//     m64n{72,64}k16 with P from registers and V read MN-major
//     (transposed) from its [key, D] tile; the accumulator layout is
//     mma.sync's, so the online softmax works on the S registers in place;
//   * overlap: in its turn a warpgroup issues S of tile j and P V of tile
//     j - 1 together; two named barriers hand the turns back and forth
//     (ping-pong), so one warpgroup's softmax overlaps the other's
//     products. (Running the softmax of tile j while P V of tile j - 1 is
//     still in flight, waiting for S alone, makes ptxas serialise the
//     wgmmas (C7514) and measured slower on the H100.)
//   * up to head dim 80 (the DiT's 72, DINOv2's 64) tiles live in shared
//     memory in wgmma's no-swizzle core-matrix layout (sm90.cuh), loaded by
//     TMA one 8-column chunk at a time, so head dim 72 (9 chunks) needs no
//     swizzle span; Q K^T contracts over 80, with the 10th chunk of Q and
//     K zeroed once and never loaded;
//   * above 80 (96, 128, 256) the tiles are swizzled (sm90.cuh): 64-column
//     boxes with the 128-byte swizzle at 128 and 256, 32-column boxes with
//     the 64-byte one at 96, so a tile arrives in D / 64 (D / 32) TMA boxes
//     of whole 128-byte (64-byte) rows where the chunked layout took D / 8
//     boxes of 16-byte rows, each costing a request per row and half a
//     32-byte sector; the same descriptors read Q and K K-major and V
//     MN-major. There the O rescale is skipped when no row of the warp
//     moved its maximum (after the first tiles, most tiles);
//   * one instance per head dim 64, 72, 80, 96, 128 and 256 (P V on wgmma
//     m64nDk16, at 256 two m64n128 halves sharing the P fragments, each
//     half of O its own accumulator chain); at 128 the S, O and P registers
//     (64 + 64 + 32 a thread) still fit the consumers' 240, and shared
//     memory holds Q and two K/V stages in 160 KiB; at 256 O alone takes
//     128 registers a thread, so the K/V tiles hold 64 keys (S and P 32 +
//     16; a 128-key S tile beside O would take 224 of the 240) and Q and
//     two stages take 192 KiB;
//   * the [B, S, H, D] strides go into the tensor maps (encoded on the
//     host per launch), so the DiT's qkv.unbind(2) views are read
//     without a copy; rows past Sq or Sk arrive as zeros from TMA and
//     keys past Sk are masked before the softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;   // q rows per block, 64 per consumer warpgroup
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr float kNegBig = -1e30f;

// keys per K/V tile: 128 up to head dim 128; 64 at 256, where O (128
// registers a thread) beside S and P of a 128-key tile would spill
__host__ __device__ constexpr int fwd_block_n(int D) {
  return D <= 128 ? 128 : 64;
}

// above head dim 80 the tiles use the swizzled layout (sm90.cuh): boxes
// of 64 columns with the 128-byte swizzle where D is a multiple of 64
// (128, 256), of 32 columns with the 64-byte one otherwise (96); up to 80
// the chunked no-swizzle layout, which head dim 72 needs
__host__ __device__ constexpr bool fwd_swizzled(int D) { return D > 80; }
__host__ __device__ constexpr int fwd_box_cols(int D) {
  return !fwd_swizzled(D) ? 8 : D % 64 == 0 ? 64 : 32;
}

template <int D>
struct Fwd {
  static constexpr bool kSw = fwd_swizzled(D);
  static constexpr int kSwCols = fwd_box_cols(D);   // columns per TMA box
  static constexpr int kSwBytes = 2 * kSwCols;       // swizzle span (kSw)
  static constexpr int kBlockN = fwd_block_n(D);
  static constexpr int kChunks = D / 8;            // 8-column chunks of D
  static constexpr int kSteps = (D + 15) / 16;     // k16 steps of Q K^T
  static constexpr int kChunksP = 2 * kSteps;      // Q, K chunks with padding
  static constexpr int kQElems = kChunksP * kBlockM * 8;
  static constexpr int kKElems = kChunksP * kBlockN * 8;
  static constexpr int kVElems = kChunks * kBlockN * 8;
  static constexpr int kBarOffset =
      2 * (kQElems + kStages * (kKElems + kVElems));
  static constexpr int kSmem = kBarOffset + 8 * (1 + 4 * kStages);
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
  static_assert(!kSw || (D % kSwCols == 0 && kChunksP == kChunks),
                "a swizzled head dim is a multiple of its box and of 16");
};

// byte offset of k16 step kk of a K-major swizzled tile of kRows rows: box
// kk / (kSwCols / 16), 32 bytes a step into its rows
template <int D, int kRows>
__host__ __device__ constexpr uint32_t sw_k_offset(int kk) {
  constexpr int kPerBox = Fwd<D>::kSwCols / 16;
  return (kk / kPerBox) * kRows * Fwd<D>::kSwBytes + (kk % kPerBox) * 32;
}

// rows [row0, row0 + kRows) of head (b, h) into a tile: 8-column chunks,
// or above head dim 80 kSwCols-column swizzled boxes
template <int D, int kRows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int row0, int h,
                                          int b) {
  if constexpr (Fwd<D>::kSw) {
    tma_load_tile_sw<D, kRows, Fwd<D>::kSwCols>(dst, map, bar, row0, h, b);
  } else {
    tma_load_tile<D, kRows>(dst, map, bar, row0, h, b);
  }
}

// O += P V for K/V tile j, once its V has arrived: P from registers, V
// MN-major B (8 keys per core matrix along K, the chunks along N)
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&acc)[D / 2], const uint32_t (&p)[Fwd<D>::kBlockN / 16][4],
    const __nv_bfloat16* Vs, uint64_t* v_full, int j) {
  using T = Fwd<D>;
  constexpr int kBlockN = T::kBlockN;
  const int st = j % kStages;
  mbar_wait(&v_full[st], (j / kStages) & 1);
  if constexpr (T::kSw) {
    // V MN-major with the swizzle: LBO one box (kSwCols columns along N),
    // SBO 8 keys, a k16 step 16 keys; at 256 two m64n128 halves, the
    // second two boxes along
    constexpr uint32_t kBox = kBlockN * T::kSwBytes;
    const uint64_t v_desc = make_desc_sw<T::kSwBytes>(
        Vs + st * T::kVElems, kBox, 8 * T::kSwBytes);
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t off = (kk * 16 * T::kSwBytes) >> 4;
      if constexpr (D == 256) {
        wgmma_rs<128, 1>(*reinterpret_cast<float(*)[64]>(&acc[0]), p[kk],
                         v_desc + off, 1);
        wgmma_rs<128, 1>(*reinterpret_cast<float(*)[64]>(&acc[64]), p[kk],
                         v_desc + off + ((2 * kBox) >> 4), 1);
      } else {
        wgmma_rs<D, 1>(acc, p[kk], v_desc + off, 1);
      }
    }
  } else {
    const uint64_t v_desc = make_desc(Vs + st * T::kVElems, 128, kBlockN * 16);
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      wgmma_rs<D, 1>(acc, p[kk], v_desc + ((kk * 256) >> 4), 1);
    }
  }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Sk, long long osb, long long oss,
                 long long osh, float scale_log2) {
  using T = Fwd<D>;
  constexpr int kBlockN = T::kBlockN;
  extern __shared__ __align__(1024) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + T::kQElems;                  // [kStages] tiles
  __nv_bfloat16* Vs = Ks + kStages * T::kKElems;        // [kStages] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::kBarOffset);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int m0 = blockIdx.x * kBlockM;
  const int n_tiles = (Sk + kBlockN - 1) / kBlockN;
  if constexpr (T::kSw) check_smem_align(smem);

  // the padding chunks of Q and of every K stage: zero once, never loaded
  if constexpr (T::kChunksP > T::kChunks) {
    constexpr int kPadQ = (T::kChunksP - T::kChunks) * kBlockM;   // uint4s
    constexpr int kPadK = (T::kChunksP - T::kChunks) * kBlockN;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < kPadQ; i += kThreads) {
      reinterpret_cast<uint4*>(Qs + T::kChunks * kBlockM * 8)[i] = z;
    }
    for (int i = tid; i < kStages * kPadK; i += kThreads) {
      const int st = i / kPadK;
      reinterpret_cast<uint4*>(Ks + st * T::kKElems +
                               T::kChunks * kBlockN * 8)[i - st * kPadK] = z;
    }
    fence_proxy_async();
  }
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], 8);   // one arrival per consumer warp
      mbar_init(&v_empty[st], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // producer: one thread issues every TMA load
    setmaxnreg_dec<24>();
    if (tid == 256) {
      mbar_arrive_expect_tx(q_full, T::kChunks * kBlockM * 16);
      load_tile<D, kBlockM>(Qs, &qmap, q_full, m0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const uint32_t ph = (j / kStages) & 1;
        mbar_wait(&k_empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&k_full[st], T::kChunks * kBlockN * 16);
        load_tile<D, kBlockN>(Ks + st * T::kKElems, &kmap, &k_full[st],
                              j * kBlockN, h, b);
        mbar_wait(&v_empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&v_full[st], T::kChunks * kBlockN * 16);
        load_tile<D, kBlockN>(Vs + st * T::kVElems, &vmap, &v_full[st],
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
    // Q: K-major A, this warpgroup's 64 rows; chunk stride along D (or,
    // swizzled, 64 rows into each box)
    const uint64_t q_desc = [&] {
      if constexpr (T::kSw) {
        return make_desc_sw<T::kSwBytes>(Qs + wg * 64 * T::kSwCols, 16,
                                         8 * T::kSwBytes);
      } else {
        return make_desc(Qs + wg * 64 * 8, kBlockM * 16, 128);
      }
    }();

    float s[kBlockN / 2];          // S tile: kBlockN / 8 column tiles x 4
    float acc[D / 2];              // O: D / 8 column tiles x 4
    uint32_t p[kBlockN / 16][4];   // P (bf16) as A fragments, per k16 step
    float m_run[2] = {kNegBig, kNegBig};   // rows g, g + 8; log2 units
    float l_run[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    if (wg == 1) named_arrive(1, 256);   // warpgroup 0 takes the first turn
    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      mbar_wait(&k_full[st], (j / kStages) & 1);
      named_sync(1 + wg, 256);           // this warpgroup's turn
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
      if constexpr (T::kSw) {
        const uint64_t k_desc = make_desc_sw<T::kSwBytes>(
            Ks + st * T::kKElems, 16, 8 * T::kSwBytes);
#pragma unroll
        for (int kk = 0; kk < T::kSteps; ++kk) {
          wgmma_ss<kBlockN, 0, 0>(s, q_desc + (sw_k_offset<D, kBlockM>(kk) >> 4),
                                  k_desc + (sw_k_offset<D, kBlockN>(kk) >> 4),
                                  kk > 0);
        }
      } else {
        const uint64_t k_desc =
            make_desc(Ks + st * T::kKElems, kBlockN * 16, 128);
#pragma unroll
        for (int kk = 0; kk < T::kSteps; ++kk) {
          wgmma_ss<kBlockN, 0, 0>(s, q_desc + ((kk * 2 * kBlockM * 16) >> 4),
                                  k_desc + ((kk * 2 * kBlockN * 16) >> 4),
                                  kk > 0);
        }
      }
      wgmma_commit();
      if (j > 0) issue_pv<D>(acc, p, Vs, v_full, j - 1);
      if (wg == 0 || j + 1 < n_tiles) named_arrive(2 - wg, 256);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(acc);
      fence_regs(p);
      if (lane == 0) {
        mbar_arrive(&k_empty[st]);
        if (j > 0) mbar_arrive(&v_empty[(j - 1) % kStages]);
      }

      // scale (log2 units), mask keys past Sk, online softmax
      const int n0 = j * kBlockN;
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + nt * 8 + tg * 2 + (e & 1);
          const float val = col < Sk ? s[nt * 4 + e] * scale_log2 : kNegBig;
          s[nt * 4 + e] = val;
          mx[e >> 1] = fmaxf(mx[e >> 1], val);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m_run[r] - mx[r]);
        m_run[r] = mx[r];
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        const float pv = exp2f(s[i] - m_run[(i >> 1) & 1]);
        s[i] = pv;
        l_run[(i >> 1) & 1] += pv;
      }

      // rescale O to the new row maxima (swizzled form: skipped where no
      // row of the warp moved its maximum); P of tile j takes the A
      // registers
      if (!T::kSw || __any_sync(0xffffffffu,
                                alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    }
    fence_regs(acc);
    fence_regs(p);
    wgmma_fence();
    issue_pv<D>(acc, p, Vs, v_full, n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc);

    // full row denominators (the 4 threads of a quad share a row)
    float inv[2];
    const int row_a = m0 + wg * 64 + warp * 16 + g;
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
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + tg * 2;
      if (row_a < Sq) {
        *reinterpret_cast<uint32_t*>(oh + row_a * oss + col) =
            pack_bf16(acc[dt * 4] * inv[0], acc[dt * 4 + 1] * inv[0]);
      }
      if (row_a + 8 < Sq) {
        *reinterpret_cast<uint32_t*>(oh + (row_a + 8) * oss + col) =
            pack_bf16(acc[dt * 4 + 2] * inv[1], acc[dt * 4 + 3] * inv[1]);
      }
    }
  }
}

template <int D>
int launch(const CUtensorMap& qm, const CUtensorMap& km,
           const CUtensorMap& vm, __nv_bfloat16* o, float* lse, int B, int H,
           int Sq, int Sk, long long osb, long long oss, long long osh,
           float scale_log2, cudaStream_t st) {
  constexpr int smem = Fwd<D>::kSmem;
  const int err = allow_smem<flash_fwd_kernel<D>>(smem);
  if (err != 0) return err;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, smem, st>>>(
      qm, km, vm, o, lse, H, Sq, Sk, osb, oss, osh, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Sk, H, D], o [B, Sq, H, D]: bf16, strides in
// elements, last dim contiguous, every stride a multiple of 8 and the
// bases 16-byte aligned (TMA). D must be one of the instances, 64, 72,
// 80, 96, 128 or 256 (the wrapper zero-pads any other D up to the next one:
// ops/flash_attention.py:kernel_head_dim). lse is null or an f32
// [B, H, Sq] contiguous buffer. Returns the CUDA error code of the tensor
// map encoding or of the launch (0 on success).
extern "C" int topiaxl_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int H,
    int Sq, int Sk, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss,
    long long osh, float scale, void* stream) {
  if (D != 64 && D != 72 && D != 80 && D != 96 && D != 128 && D != 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap qm, km, vm;
  const int box = fwd_box_cols(D);
  const int sw = fwd_swizzled(D) ? 2 * box : 0;
  int err = encode_bshd(&qm, q, false, B, Sq, H, D, qsb, qss, qsh, box,
                        kBlockM, sw);
  if (err == 0) {
    err = encode_bshd(&km, k, false, B, Sk, H, D, ksb, kss, ksh, box,
                      fwd_block_n(D), sw);
  }
  if (err == 0) {
    err = encode_bshd(&vm, v, false, B, Sk, H, D, vsb, vss, vsh, box,
                      fwd_block_n(D), sw);
  }
  if (err != 0) return err;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  switch (D) {
    case 64:
      return launch<64>(qm, km, vm, op, lp, B, H, Sq, Sk, osb, oss, osh,
                        scale_log2, st);
    case 72:
      return launch<72>(qm, km, vm, op, lp, B, H, Sq, Sk, osb, oss, osh,
                        scale_log2, st);
    case 80:
      return launch<80>(qm, km, vm, op, lp, B, H, Sq, Sk, osb, oss, osh,
                        scale_log2, st);
    case 96:
      return launch<96>(qm, km, vm, op, lp, B, H, Sq, Sk, osb, oss, osh,
                        scale_log2, st);
    case 128:
      return launch<128>(qm, km, vm, op, lp, B, H, Sq, Sk, osb, oss, osh,
                         scale_log2, st);
    default:
      return launch<256>(qm, km, vm, op, lp, B, H, Sq, Sk, osb, oss, osh,
                         scale_log2, st);
  }
}
