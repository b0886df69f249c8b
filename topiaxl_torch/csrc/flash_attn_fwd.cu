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
//     m64nDk16 with P from registers and V read MN-major
//     (transposed) from its [key, D] tile; the accumulator layout is
//     mma.sync's, so the online softmax works on the S registers in place;
//   * overlap: in its turn a warpgroup issues S of tile j and P V of tile
//     j - 1 together; two named barriers hand the turns back and forth
//     (ping-pong), so one warpgroup's softmax overlaps the other's
//     products. (Running the softmax of tile j while P V of tile j - 1 is
//     still in flight, waiting for S alone, makes ptxas serialise the
//     wgmmas (C7514) and measured slower on the H100.)
//   * the tiles live in shared memory as swizzled TMA boxes (sm90.cuh; the
//     rule in flash_fwd_layout.cuh): 64-column boxes with the 128-byte
//     swizzle at 64, 72, 80, 128 and 256, 32-column boxes with the 64-byte
//     one at 96, so a tile arrives in a few boxes of whole 128-byte
//     (64-byte) rows, where 8-column chunks took D / 8 boxes of 16-byte
//     rows, each costing a request per row and half a 32-byte sector. Head
//     dims 72 and 80 take the "split" layout: one 64-column box, then the 8
//     (16) columns past it as one (two) 8-column chunks in wgmma's
//     no-swizzle core-matrix layout. At 72 the tail's 16-byte rows are
//     narrower than the narrowest swizzle span (32 bytes), and a second
//     64-column box would hold 56 columns of zeros a row, so the tail stays
//     one chunk: 2 TMA boxes a tile where there were 9 (0.1225 ms at
//     2x2048x2048x16, 31.9% of its bound, where the 9 chunks took 0.1458 ms,
//     26.8%, on an H100 80GB HBM3 at 700 W, with the same bits; the softmax,
//     not the loads, holds it now). 80 shares the code; its two chunks could
//     be one 32-byte-swizzled box, which no cell measures. Q K^T runs its
//     first four k16 steps on the box's descriptors and the fifth on the
//     tail, which at 72 pairs the chunk with a padding chunk of Q and of K
//     zeroed once and never loaded; P V splits into m64n64k16 over V's box
//     and m64n{8,16}k16 over its tail, each on its own accumulator
//     registers, sharing the P fragments. The same descriptors read Q and K
//     K-major and V MN-major;
//   * every tile rescales O: skipping that where no row of the warp moved
//     its maximum (a warp vote and a branch) measured slower at 72 and 128
//     on the H100, with the same bits;
//   * one instance per head dim 64, 72, 80, 96, 128 and 256 (P V at 72 and
//     80 split as above, at 256 two m64n128 halves sharing the P
//     fragments, each half of O its own accumulator chain); at 128 the S,
//     O and P registers (64 + 64 + 32 a thread) still fit the consumers'
//     240, and shared memory holds Q and two K/V stages in 160 KiB; at 256
//     O alone takes 128 registers a thread, so the K/V tiles hold 64 keys
//     (S and P 32 + 16; a 128-key S tile beside O would take 224 of the
//     240) and Q and two stages take 192 KiB;
//   * the [B, S, H, D] strides go into the tensor maps (encoded on the
//     host per launch), so the DiT's qkv.unbind(2) views are read
//     without a copy; rows past Sq or Sk arrive as zeros from TMA and
//     keys past Sk are masked before the softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd_layout.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;   // q rows per block, 64 per consumer warpgroup
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr float kNegBig = -1e30f;

template <int D>
struct Fwd {
  static constexpr int kSwCols = fwd_box_cols(D);   // columns per TMA box
  static constexpr int kSwBytes = 2 * kSwCols;       // swizzle span
  static constexpr int kTail = fwd_tail_cols(D);     // columns in chunks
  static constexpr int kBoxCols = D - kTail;         // columns in boxes
  static constexpr int kBlockN = fwd_block_n(D);
  static constexpr int kChunks = D / 8;            // 8-column units of D
  static constexpr int kSteps = (D + 15) / 16;     // k16 steps of Q K^T
  static constexpr int kChunksP = 2 * kSteps;      // Q, K units with padding
  static constexpr int kQElems = kChunksP * kBlockM * 8;
  static constexpr int kKElems = kChunksP * kBlockN * 8;
  static constexpr int kVElems = kChunks * kBlockN * 8;
  static constexpr int kBarOffset =
      2 * (kQElems + kStages * (kKElems + kVElems));
  static constexpr int kSmem = kBarOffset + 8 * (1 + 4 * kStages);
  static_assert(D % 8 == 0 && kBoxCols % kSwCols == 0 && kTail <= 16,
                "whole boxes, then at most one k16 step of 8-column chunks");
  static_assert((2 * kQElems) % 1024 == 0 && (2 * kKElems) % 1024 == 0 &&
                    (2 * kVElems) % 1024 == 0,
                "every tile, so every swizzled box, 1024-byte aligned");
};

// byte offset of k16 step kk of a K-major swizzled tile of kRows rows: box
// kk / (kSwCols / 16), 32 bytes a step into its rows
template <int D, int kRows>
__host__ __device__ constexpr uint32_t sw_k_offset(int kk) {
  constexpr int kPerBox = Fwd<D>::kSwCols / 16;
  return (kk / kPerBox) * kRows * Fwd<D>::kSwBytes + (kk % kPerBox) * 32;
}

// rows [row0, row0 + kRows) of head (b, h) into a tile: its swizzled
// boxes from `map`, then the tail's 8-column chunks from `tail_map`
template <int D, int kRows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const CUtensorMap* map,
                                          const CUtensorMap* tail_map,
                                          uint64_t* bar, int row0, int h,
                                          int b) {
  using T = Fwd<D>;
  tma_load_tile_sw<T::kBoxCols, kRows, T::kSwCols>(dst, map, bar, row0, h, b);
#pragma unroll
  for (int c = T::kBoxCols; c < D; c += 8) {
    tma_load_4d(dst + kRows * c, tail_map, bar, c, row0, h, b);
  }
}

// O += P V for K/V tile j, once its V has arrived: P from registers, V
// MN-major B. The boxes: LBO one box (kSwCols columns along N), SBO 8 keys,
// a k16 step 16 keys; at 256 two m64n128 halves, the second two boxes
// along. The tail's chunks (72, 80): LBO 8 keys, SBO one chunk, a k16 step
// 16 keys, into the last kTail / 2 accumulator registers
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&acc)[D / 2], const uint32_t (&p)[Fwd<D>::kBlockN / 16][4],
    const __nv_bfloat16* Vs, uint64_t* v_full, int j) {
  using T = Fwd<D>;
  constexpr int kBlockN = T::kBlockN;
  const int st = j % kStages;
  mbar_wait(&v_full[st], (j / kStages) & 1);
  const __nv_bfloat16* vs = Vs + st * T::kVElems;
  constexpr uint32_t kBox = kBlockN * T::kSwBytes;
  const uint64_t v_desc =
      make_desc_sw<T::kSwBytes>(vs, kBox, 8 * T::kSwBytes);
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    const uint32_t off = (kk * 16 * T::kSwBytes) >> 4;
    if constexpr (D == 256) {
      wgmma_rs<128, 1>(*reinterpret_cast<float(*)[64]>(&acc[0]), p[kk],
                       v_desc + off, 1);
      wgmma_rs<128, 1>(*reinterpret_cast<float(*)[64]>(&acc[64]), p[kk],
                       v_desc + off + ((2 * kBox) >> 4), 1);
    } else {
      wgmma_rs<T::kBoxCols, 1>(
          *reinterpret_cast<float(*)[T::kBoxCols / 2]>(&acc[0]), p[kk],
          v_desc + off, 1);
    }
    if constexpr (T::kTail > 0) {
      const uint64_t vt_desc =
          make_desc(vs + kBlockN * T::kBoxCols, 128, kBlockN * 16);
      wgmma_rs<T::kTail, 1>(
          *reinterpret_cast<float(*)[T::kTail / 2]>(&acc[T::kBoxCols / 2]),
          p[kk], vt_desc + ((kk * 256) >> 4), 1);
    }
  }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap qtail,
                 const __grid_constant__ CUtensorMap ktail,
                 const __grid_constant__ CUtensorMap vtail,
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
  check_smem_align(smem);

  // the padding chunk of Q and of every K stage (72): zero once, never
  // loaded
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
      load_tile<D, kBlockM>(Qs, &qmap, &qtail, q_full, m0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const uint32_t ph = (j / kStages) & 1;
        mbar_wait(&k_empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&k_full[st], T::kChunks * kBlockN * 16);
        load_tile<D, kBlockN>(Ks + st * T::kKElems, &kmap, &ktail,
                              &k_full[st], j * kBlockN, h, b);
        mbar_wait(&v_empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&v_full[st], T::kChunks * kBlockN * 16);
        load_tile<D, kBlockN>(Vs + st * T::kVElems, &vmap, &vtail,
                              &v_full[st], j * kBlockN, h, b);
      }
    }
  } else {
    // consumer warpgroup wg: q rows [64 wg, 64 wg + 64) of the tile
    setmaxnreg_inc<240>();
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tg = lane & 3;
    // Q: K-major A, this warpgroup's 64 rows into each box
    const uint64_t q_desc = make_desc_sw<T::kSwBytes>(
        Qs + wg * 64 * T::kSwCols, 16, 8 * T::kSwBytes);

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
      const __nv_bfloat16* ks = Ks + st * T::kKElems;
      const uint64_t k_desc =
          make_desc_sw<T::kSwBytes>(ks, 16, 8 * T::kSwBytes);
#pragma unroll
      for (int kk = 0; kk < T::kBoxCols / 16; ++kk) {
        wgmma_ss<kBlockN, 0, 0>(s, q_desc + (sw_k_offset<D, kBlockM>(kk) >> 4),
                                k_desc + (sw_k_offset<D, kBlockN>(kk) >> 4),
                                kk > 0);
      }
      if constexpr (T::kTail > 0) {
        // the last k16 step: the tail's chunks (at 72 beside the zeroed
        // padding chunk), no swizzle: LBO one chunk along D, SBO 8 rows
        wgmma_ss<kBlockN, 0, 0>(
            s, make_desc(Qs + kBlockM * T::kBoxCols + wg * 64 * 8,
                         kBlockM * 16, 128),
            make_desc(ks + kBlockN * T::kBoxCols, kBlockN * 16, 128), 1);
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

      // rescale O to the new row maxima; P of tile j takes the A registers
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
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
int launch(const CUtensorMap (&maps)[6], __nv_bfloat16* o, float* lse,
           int B, int H, int Sq, int Sk, long long osb, long long oss,
           long long osh, float scale_log2, cudaStream_t st) {
  constexpr int smem = Fwd<D>::kSmem;
  const int err = allow_smem<flash_fwd_kernel<D>>(smem);
  if (err != 0) return err;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], o, lse, H, Sq, Sk,
      osb, oss, osh, scale_log2);
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
  // the maps of q, k and v for their swizzled boxes, then for the tail's
  // 8-column chunks (72, 80; without a tail those go unread)
  CUtensorMap maps[6];
  const void* bases[3] = {q, k, v};
  const int extents[3] = {Sq, Sk, Sk};
  const long long strides[3][3] = {
      {qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh}};
  const int box = fwd_box_cols(D);
  const bool tail = fwd_tail_cols(D) > 0;
  for (int t = 0; t < 3; ++t) {
    const int rows = t == 0 ? kBlockM : fwd_block_n(D);
    const long long* sd = strides[t];
    int err = encode_bshd(&maps[t], bases[t], false, B, extents[t], H, D,
                          sd[0], sd[1], sd[2], box, rows, 2 * box);
    if (err == 0 && tail) {
      err = encode_bshd(&maps[3 + t], bases[t], false, B, extents[t], H, D,
                        sd[0], sd[1], sd[2], 8, rows);
    }
    if (err != 0) return err;
    if (!tail) maps[3 + t] = maps[t];
  }
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  switch (D) {
    case 64:
      return launch<64>(maps, op, lp, B, H, Sq, Sk, osb, oss, osh,
                        scale_log2, st);
    case 72:
      return launch<72>(maps, op, lp, B, H, Sq, Sk, osb, oss, osh,
                        scale_log2, st);
    case 80:
      return launch<80>(maps, op, lp, B, H, Sq, Sk, osb, oss, osh,
                        scale_log2, st);
    case 96:
      return launch<96>(maps, op, lp, B, H, Sq, Sk, osb, oss, osh,
                        scale_log2, st);
    case 128:
      return launch<128>(maps, op, lp, B, H, Sq, Sk, osb, oss, osh,
                         scale_log2, st);
    default:
      return launch<256>(maps, op, lp, B, H, Sq, Sk, osb, oss, osh,
                         scale_log2, st);
  }
}
