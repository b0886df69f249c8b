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
// ridge), and, at head dims 64 and 72, nearly as much the exponentials: 2
// x 16 x 2048^2 exp2 per DiT self-attention launch take about as long on
// the special-function units as its products on the tensor cores. The
// design (the shape of FlashAttention-3):
//   * a block has one producer warpgroup and consumer warpgroups of 64 q
//     rows each: two, or in the overlapped loop three (192-row q tiles)
//     where a launch's grid of them takes fewer of the card's waves
//     (fwd_consumers in flash_fwd_layout.cuh, from the SM count). The
//     ping-pong loop runs a block per (batch*head, q tile); the overlapped
//     loop a block per SM, each running q tiles blockIdx.x, + gridDim.x,
//     ... one after another, the producer loading the next tile's Q (two
//     buffers) and first K/V tiles under the current tile's last turns;
//   * the producer keeps TMA loads of K and V tiles (128 keys; 64 at head
//     dim 256) in flight in a two-stage shared-memory ring (mbarrier
//     full/empty pairs, K and V released separately); a q tile's Q is
//     loaded once; setmaxnreg moves the producer's registers to the
//     consumers;
//   * S = Q K^T runs on wgmma m64n128k16 (m64n64k16 at head dim 256) with
//     both operands in shared memory (K-major over D); O += P V on wgmma
//     m64nDk16 with P from registers and V read MN-major
//     (transposed) from its [key, D] tile; the accumulator layout is
//     mma.sync's, so the online softmax works on the S registers in place;
//   * the consumer warpgroups take turns issuing their products (named
//     barriers hand each turn on), so one's softmax runs under the
//     others' products. Two loops (the rule in flash_fwd_layout.cuh):
//       - the ping-pong loop (flash_fwd_kernel, head dims 80-256): in its
//         turn a warpgroup issues S of tile j and P V of tile j - 1 and
//         waits for both, then runs tile j's softmax;
//       - the overlapped loop (flash_fwd_kernel_overlap, 64 and 72): tile
//         0's S and softmax in a turn of their own, then turns that issue
//         S(j + 1) and P(j) V(j) and wait for S alone before the softmax
//         of tile j + 1, then a turn of the last P V. Every loop turn
//         issues the same products and hands its turn on, and waits for
//         both before its back edge; only the last tile's turn masks keys
//         past Sk; the exponentials are ex2.approx.ftz (below);
//   * what the overlapped loop found (on an H100 80GB HBM3 at 700 W; o and
//     lse bit for bit the ping-pong loop's at every shape measured):
//       - the ping-pong loop's wgmmas are not serialised: ptxas -v reads
//         168 registers, 0 bytes of spill and no "Performance Loss" note
//         for it at any head dim, its run-time P V and turn hand-off
//         included;
//       - P written into a second register buffer by the softmax while P
//         V reads the first makes ptxas serialise every wgmma of the loop
//         (C7513: non-wgmma instructions defining input registers of a
//         wgmma inside the pipeline stage), 0.157 ms against the ping-pong
//         loop's 0.124 at 2x2048x2048x16x72. So the softmax leaves P in
//         f32 in S's registers, whose products have completed, and P goes
//         to bf16 into the one P buffer after the wait for P V;
//       - a warpgroup's wgmma issue stalls until the tensor cores have run
//         most of what it issued (clock64 counters: ~640 cycles at 72,
//         ~400 at 64, about the products' own time), and ptxas places the
//         wait for P V after the row maxima, so what a warpgroup runs under
//         its own P V is the scale and the maxima. Measured one change at a
//         time: exp2f in place of ex2.approx.ftz reads +3% at
//         2x2048x2048x16x72, masking every tile (not only the last) +2.4%,
//         two consumer warpgroups in place of three +11% at
//         8x4096x4096x16x64 and +5% at 2x2048x2048x16x72 (a warpgroup's
//         softmax takes one to two times its products, so two warpgroups
//         left the tensor cores idle), but -20% at DINOv2's
//         1x1374x1374x12x64 (96 blocks of 192 rows on 132 SMs) and -19% at
//         1x2048x1370x16x72 (a last wave a third full): the rule's cases.
//         A block a q tile spent ~9k cycles of ~47k outside its loop at
//         72 (Q's arrival 2.5k, the first turn 2.8k, the epilogue 2-2.8k),
//         which a block running its q tiles one after another hides in
//         part: -6% at 2x2048x2048x16x72, -7% at 8x2048x2048x16x72. In
//         all (medians, the same call as the ping-pong loop's): 0.0991 ms
//         (was 0.1249) at 2x2048x2048x16x72, 0.0399 (0.0466) at
//         1x2048x1370, 0.3401 / 0.2495 (0.4694 / 0.3455) at
//         8x2048x{2048, 1370}, 1.2658 / 0.4686 (1.7100 / 0.6418) at
//         8x4096x{4096, 1374}x16x64, 0.0208 (0.0252) at 1x1374x1374x12x64;
//   * what bounds the overlapped loop now: a warpgroup's turn at 72 is its
//     products' issue (~640 cycles), its softmax (64 exponentials a thread
//     on the special-function units, 8 cycles a warp instruction, shared
//     with the other warpgroups' on the same sub-partition) and ~250
//     cycles of barrier waits, ~2,550 cycles a 128 x 128 tile with two
//     consumer warpgroups where the products need ~1,300. ptxas -v: 168
//     registers with two consumer warpgroups (setmaxnreg gives them 240),
//     128 with three (160), 0 bytes of spill, no "Performance Loss" note;
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

constexpr int kStages = 2;     // K/V ring depth
constexpr float kNegBig = -1e30f;

// the tiles of head dim D for a block of kC consumer warpgroups
template <int D, int kC = 2>
struct Fwd {
  static constexpr int kSwCols = fwd_box_cols(D);   // columns per TMA box
  static constexpr int kSwBytes = 2 * kSwCols;       // swizzle span
  static constexpr int kTail = fwd_tail_cols(D);     // columns in chunks
  static constexpr int kBoxCols = D - kTail;         // columns in boxes
  static constexpr int kBlockN = fwd_block_n(D);
  // consumer warpgroups of 64 q rows each, then the producer warpgroup
  static constexpr int kConsumers = kC;
  static constexpr int kBlockM = fwd_block_m(kC);    // q rows per block
  static constexpr int kThreads = 128 * (kC + 1);
  static constexpr int kChunks = D / 8;            // 8-column units of D
  static constexpr int kSteps = (D + 15) / 16;     // k16 steps of Q K^T
  static constexpr int kChunksP = 2 * kSteps;      // Q, K units with padding
  static constexpr int kQElems = kChunksP * kBlockM * 8;
  static constexpr int kKElems = kChunksP * kBlockN * 8;
  static constexpr int kVElems = kChunks * kBlockN * 8;
  // Q tiles: two in the overlapped loop, whose blocks run tile after tile
  // (the next tile's Q loads while this one runs), one in the ping-pong
  static constexpr int kQBufs = fwd_overlapped(D) ? 2 : 1;
  static constexpr int kBarOffset =
      2 * (kQBufs * kQElems + kStages * (kKElems + kVElems));
  // mbarriers: Q's full (and, for two tiles, their empty ones), then the
  // K/V ring's full and empty ones
  static constexpr int kSmem =
      kBarOffset + 8 * ((kQBufs == 2 ? 4 : 1) + 4 * kStages);
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

// S = Q K^T of one K/V tile (its K arrived; ks its stage) into s: the
// box's k16 steps on the swizzled descriptors, then at 72 (80) the last
// k16 step on the tail's chunks (at 72 beside the zeroed padding chunk),
// no swizzle: LBO one chunk along D, SBO 8 rows
template <int D, int kC>
__device__ __forceinline__ void issue_s(float (&s)[Fwd<D>::kBlockN / 2],
                                        uint64_t q_desc,
                                        const __nv_bfloat16* Qs,
                                        const __nv_bfloat16* ks, int wg) {
  using T = Fwd<D, kC>;
  constexpr int kBlockN = T::kBlockN;
  const uint64_t k_desc = make_desc_sw<T::kSwBytes>(ks, 16, 8 * T::kSwBytes);
#pragma unroll
  for (int kk = 0; kk < T::kBoxCols / 16; ++kk) {
    wgmma_ss<kBlockN, 0, 0>(s,
                            q_desc + (sw_k_offset<D, T::kBlockM>(kk) >> 4),
                            k_desc + (sw_k_offset<D, kBlockN>(kk) >> 4),
                            kk > 0);
  }
  if constexpr (T::kTail > 0) {
    wgmma_ss<kBlockN, 0, 0>(
        s, make_desc(Qs + T::kBlockM * T::kBoxCols + wg * 64 * 8,
                     T::kBlockM * 16, 128),
        make_desc(ks + kBlockN * T::kBoxCols, kBlockN * 16, 128), 1);
  }
}

// O += P V for one K/V tile (its V arrived; vs its stage): P from
// registers, V MN-major B. The boxes: LBO one box (kSwCols columns along
// N), SBO 8 keys, a k16 step 16 keys; at 256 two m64n128 halves, the second
// two boxes along. The tail's chunks (72, 80): LBO 8 keys, SBO one chunk, a
// k16 step 16 keys, into the last kTail / 2 accumulator registers
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&acc)[D / 2], const uint32_t (&p)[Fwd<D>::kBlockN / 16][4],
    const __nv_bfloat16* vs) {
  using T = Fwd<D>;
  constexpr int kBlockN = T::kBlockN;
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
}

// 2^x: exp2f, or (kFtz) ex2.approx.ftz, which flushes results below 2^-126
// to 0 and gives exp2f's bits for every other (exp2f's handling of those
// results costs instructions an exponential)
template <bool kFtz>
__device__ __forceinline__ float exp2_of(float x) {
  if constexpr (kFtz) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  } else {
    return exp2f(x);
  }
}

// the online softmax of the S tile of keys [n0, n0 + kBlockN), in place in
// s: scale (log2 units), mask keys past Sk (kMask: the tile may hold keys
// past Sk; only the last can), the new row maxima into m_run,
// alpha = 2^(old max - new max) for l_run and O, the exponentials (P in
// f32), their row sums added to l_run in column order; the caller rescales
// O by alpha and packs P for the P V product (pack_p)
template <int kBlockN, bool kFtz, bool kMask = true>
__device__ __forceinline__ void online_softmax(float (&s)[kBlockN / 2],
                                               float (&m_run)[2],
                                               float (&l_run)[2],
                                               float (&alpha)[2], int n0,
                                               int Sk, int tg,
                                               float scale_log2) {
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n0 + nt * 8 + tg * 2 + (e & 1);
      const float val =
          !kMask || col < Sk ? s[nt * 4 + e] * scale_log2 : kNegBig;
      s[nt * 4 + e] = val;
      mx[e >> 1] = fmaxf(mx[e >> 1], val);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2_of<kFtz>(m_run[r] - mx[r]);
    m_run[r] = mx[r];
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) {
    const float pv = exp2_of<kFtz>(s[i] - m_run[(i >> 1) & 1]);
    s[i] = pv;
    l_run[(i >> 1) & 1] += pv;
  }
}

// P (f32 in s) rounded to bf16 into p: A fragments, one a k16 step
template <int kBlockN>
__device__ __forceinline__ void pack_p(const float (&s)[kBlockN / 2],
                                       uint32_t (&p)[kBlockN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// O to the new row maxima
template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// a q tile's view of the block's shared memory: its Q tile and barrier,
// the K/V ring and its barriers; the tile's K/V tile j is the ring's tile
// base + j, in stage (base + j) % kStages, its barriers' phase
// (base + j) / kStages
template <int D>
struct Ring {
  int base;                  // the ring's count of K/V tiles before this q tile
  const __nv_bfloat16* Qs;
  const __nv_bfloat16* Ks;   // [kStages] tiles
  const __nv_bfloat16* Vs;   // [kStages] tiles
  uint64_t* q_full;
  uint64_t* k_full;
  uint64_t* v_full;
  uint64_t* k_empty;
  uint64_t* v_empty;
  __device__ const __nv_bfloat16* k(int j) const {
    return Ks + ((base + j) % kStages) * Fwd<D>::kKElems;
  }
  __device__ const __nv_bfloat16* v(int j) const {
    return Vs + ((base + j) % kStages) * Fwd<D>::kVElems;
  }
  __device__ void wait_k(int j) const {
    mbar_wait(&k_full[(base + j) % kStages], ((base + j) / kStages) & 1);
  }
  __device__ void wait_v(int j) const {
    mbar_wait(&v_full[(base + j) % kStages], ((base + j) / kStages) & 1);
  }
  // one consumer warp done with tile j of K or of V
  __device__ void release_k(int j) const {
    mbar_arrive(&k_empty[(base + j) % kStages]);
  }
  __device__ void release_v(int j) const {
    mbar_arrive(&v_empty[(base + j) % kStages]);
  }
};

// The ping-pong loop (head dims 80-256): in its turn a warpgroup issues S
// of tile j and P V of tile j - 1 together and waits for both, then runs
// tile j's softmax while the other warpgroup's products run
template <int D>
__device__ __forceinline__ void consume_pingpong(
    const Ring<D>& r, float (&acc)[D / 2], float (&m_run)[2],
    float (&l_run)[2], int wg, int lane, int tg, int n_tiles, int Sk,
    float scale_log2) {
  using T = Fwd<D>;
  constexpr int kBlockN = T::kBlockN;
  // Q: K-major A, this warpgroup's 64 rows into each box
  const uint64_t q_desc = make_desc_sw<T::kSwBytes>(
      r.Qs + wg * 64 * T::kSwCols, 16, 8 * T::kSwBytes);
  float s[kBlockN / 2];          // S tile: kBlockN / 8 column tiles x 4
  uint32_t p[kBlockN / 16][4];   // P (bf16) as A fragments, per k16 step
  float alpha[2];

  if (wg == 1) named_arrive(1, 256);   // warpgroup 0 takes the first turn
  mbar_wait(r.q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    r.wait_k(j);
    named_sync(1 + wg, 256);           // this warpgroup's turn
    fence_regs(acc);
    fence_regs(p);
    wgmma_fence();
    issue_s<D, 2>(s, q_desc, r.Qs, r.k(j), wg);
    wgmma_commit();
    if (j > 0) {
      r.wait_v(j - 1);
      issue_pv<D>(acc, p, r.v(j - 1));
      wgmma_commit();
    }
    if (wg == 0 || j + 1 < n_tiles) named_arrive(2 - wg, 256);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(acc);
    fence_regs(p);
    if (lane == 0) {
      r.release_k(j);
      if (j > 0) r.release_v(j - 1);
    }
    // rescale O to the new row maxima; P of tile j takes the A registers
    online_softmax<kBlockN, false>(s, m_run, l_run, alpha, j * kBlockN, Sk,
                                   tg, scale_log2);
    rescale<D>(acc, alpha);
    pack_p<kBlockN>(s, p);
  }
  fence_regs(acc);
  fence_regs(p);
  wgmma_fence();
  r.wait_v(n_tiles - 1);
  issue_pv<D>(acc, p, r.v(n_tiles - 1));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// A turn of the overlapped loop (head dims 64, 72): S of tile j + 1 and P
// V of tile j, committed in that order; the softmax of tile j + 1 runs in
// place in s once S has arrived, while P V is still on the tensor cores;
// then O, with P(j) V(j) added, takes alpha of tile j + 1, and P(j + 1)
// takes p. The turn waits for both products before it returns. kLast: tile
// j + 1 is the last, whose keys past Sk are masked
template <int D, int kC, bool kLast>
__device__ __forceinline__ void overlap_turn(
    const Ring<D>& r, uint64_t q_desc, float (&s)[Fwd<D>::kBlockN / 2],
    float (&acc)[D / 2], uint32_t (&p)[Fwd<D>::kBlockN / 16][4],
    float (&m_run)[2], float (&l_run)[2], int wg, int next, int lane, int tg,
    int j, int Sk, float scale_log2) {
  constexpr int kBlockN = Fwd<D>::kBlockN;
  float alpha[2];
  r.wait_k(j + 1);
  r.wait_v(j);
  named_sync(1 + wg, 256);
  fence_regs(acc);
  fence_regs(p);
  wgmma_fence();
  issue_s<D, kC>(s, q_desc, r.Qs, r.k(j + 1), wg);
  wgmma_commit();
  issue_pv<D>(acc, p, r.v(j));
  wgmma_commit();
  named_arrive(1 + next, 256);
  wgmma_wait<1>();   // S of tile j + 1
  fence_regs(s);
  online_softmax<kBlockN, true, kLast>(s, m_run, l_run, alpha,
                                       (j + 1) * kBlockN, Sk, tg, scale_log2);
  fence_regs(s);
  wgmma_wait<0>();   // P V of tile j
  fence_regs(acc);
  fence_regs(p);
  if (lane == 0) {
    r.release_k(j + 1);
    r.release_v(j);
  }
  rescale<D>(acc, alpha);
  pack_p<kBlockN>(s, p);
}

// The overlapped loop over one q tile (head dims 64, 72; see the header):
// K/V tile 0's S and softmax in a turn of their own, then turns of S(j +
// 1) and P(j) V(j), then a turn of the last tile's P V. The consumer
// warpgroups take their turns in order, each handing the next its turn
// (named barrier 1 + w is warpgroup w's turn), from one q tile into the
// next; every loop turn issues the same products and hands its turn on
template <int D, int kC>
__device__ __forceinline__ void consume_overlap(
    const Ring<D>& r, uint32_t q_phase, bool more, float (&acc)[D / 2],
    float (&m_run)[2], float (&l_run)[2], int wg, int lane, int tg,
    int n_tiles, int Sk, float scale_log2) {
  using T = Fwd<D, kC>;
  constexpr int kBlockN = T::kBlockN;
  constexpr int kLast = T::kConsumers - 1;
  const int next = wg == kLast ? 0 : wg + 1;
  const uint64_t q_desc = make_desc_sw<T::kSwBytes>(
      r.Qs + wg * 64 * T::kSwCols, 16, 8 * T::kSwBytes);
  float s[kBlockN / 2];
  uint32_t p[kBlockN / 16][4];
  float alpha[2];

  mbar_wait(r.q_full, q_phase);
  r.wait_k(0);
  named_sync(1 + wg, 256);
  wgmma_fence();
  issue_s<D, kC>(s, q_desc, r.Qs, r.k(0), wg);
  wgmma_commit();
  named_arrive(1 + next, 256);
  wgmma_wait<0>();
  fence_regs(s);
  if (lane == 0) r.release_k(0);
  // O is still zero: alpha has nothing to rescale
  online_softmax<kBlockN, true>(s, m_run, l_run, alpha, 0, Sk, tg,
                                scale_log2);
  pack_p<kBlockN>(s, p);
  for (int j = 0; j + 2 < n_tiles; ++j) {
    overlap_turn<D, kC, false>(r, q_desc, s, acc, p, m_run, l_run, wg,
                               next, lane, tg, j, Sk, scale_log2);
  }
  if (n_tiles > 1) {
    overlap_turn<D, kC, true>(r, q_desc, s, acc, p, m_run, l_run, wg, next,
                              lane, tg, n_tiles - 2, Sk, scale_log2);
  }
  // the last turn: P V of the last tile; the last warpgroup hands its turn
  // on to the block's next q tile, if `more`
  r.wait_v(n_tiles - 1);
  named_sync(1 + wg, 256);
  fence_regs(acc);
  fence_regs(p);
  wgmma_fence();
  issue_pv<D>(acc, p, r.v(n_tiles - 1));
  wgmma_commit();
  if (wg != kLast || more) named_arrive(1 + next, 256);
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0) r.release_v(n_tiles - 1);   // for the block's next q tile
}

// the padding chunk of the kQTiles Q tiles at Qs and of every K stage
// (72): zero once, never loaded
template <int D, int kC, int kQTiles>
__device__ __forceinline__ void zero_pads(__nv_bfloat16* Qs,
                                          __nv_bfloat16* Ks, int tid) {
  using T = Fwd<D, kC>;
  if constexpr (T::kChunksP > T::kChunks) {
    constexpr int kPadQ = (T::kChunksP - T::kChunks) * T::kBlockM;  // uint4s
    constexpr int kPadK = (T::kChunksP - T::kChunks) * T::kBlockN;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < kQTiles * kPadQ; i += T::kThreads) {
      const int qb = i / kPadQ;
      reinterpret_cast<uint4*>(Qs + qb * T::kQElems +
                               T::kChunks * T::kBlockM * 8)[i - qb * kPadQ] =
          z;
    }
    for (int i = tid; i < kStages * kPadK; i += T::kThreads) {
      const int st = i / kPadK;
      reinterpret_cast<uint4*>(Ks + st * T::kKElems +
                               T::kChunks * T::kBlockN * 8)[i - st * kPadK] =
          z;
    }
    fence_proxy_async();
  }
}

// a consumer thread's two rows of O (row_a, row_a + 8 of a head whose
// [S, D] rows start at oh, rows `oss` apart) over their full denominators
// (the 4 threads of a quad share a row), and their lse (natural units) at
// lse_h, given one
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           const float (&m_run)[2],
                                           const float (&l_run)[2],
                                           __nv_bfloat16* oh, float* lse_h,
                                           int row_a, int Sq, int tg,
                                           long long oss) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    inv[r] = 1.f / l;
    // lse = m + log(l) in natural units; m_run is in log2 units
    if (lse_h != nullptr && tg == 0 && row_a + 8 * r < Sq) {
      lse_h[row_a + 8 * r] = (m_run[r] + log2f(l)) * 0.6931471805599453f;
    }
  }
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

// One block of the ping-pong loop (head dims 80-256): q rows [128
// blockIdx.x, + 128) of head blockIdx.y
template <int D>
__device__ __forceinline__ void pingpong_block(
    const CUtensorMap* qmap, const CUtensorMap* kmap, const CUtensorMap* vmap,
    const CUtensorMap* qtail, const CUtensorMap* ktail,
    const CUtensorMap* vtail, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int H, int Sq, int Sk, long long osb,
    long long oss, long long osh, float scale_log2) {
  using T = Fwd<D>;
  constexpr int kBlockN = T::kBlockN;
  constexpr int kBlockM = T::kBlockM;
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
  zero_pads<D, 2, 1>(Qs, Ks, tid);
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
      load_tile<D, kBlockM>(Qs, qmap, qtail, q_full, m0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const uint32_t ph = (j / kStages) & 1;
        mbar_wait(&k_empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&k_full[st], T::kChunks * kBlockN * 16);
        load_tile<D, kBlockN>(Ks + st * T::kKElems, kmap, ktail,
                              &k_full[st], j * kBlockN, h, b);
        mbar_wait(&v_empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&v_full[st], T::kChunks * kBlockN * 16);
        load_tile<D, kBlockN>(Vs + st * T::kVElems, vmap, vtail,
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
    const Ring<D> ring{0, Qs, Ks, Vs, q_full, k_full, v_full, k_empty,
                       v_empty};
    float acc[D / 2];              // O: D / 8 column tiles x 4
    float m_run[2] = {kNegBig, kNegBig};   // rows g, g + 8; log2 units
    float l_run[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    consume_pingpong<D>(ring, acc, m_run, l_run, wg, lane, tg, n_tiles, Sk,
                        scale_log2);
    float* lse_h = lse == nullptr
        ? nullptr : lse + static_cast<long long>(blockIdx.y) * Sq;
    store_rows<D>(acc, m_run, l_run, o + b * osb + h * osh, lse_h,
                  m0 + wg * 64 + warp * 16 + g, Sq, tg, oss);
  }
}

// One block of the overlapped loop (head dims 64, 72), kC consumer
// warpgroups: q tiles blockIdx.x, blockIdx.x + gridDim.x, ... of the BH x
// ceil(Sq / (64 kC)) tiles, head by head, one after another. The producer
// loads the next tile's Q into a second buffer and its first K/V tiles
// while this one runs, so that they arrive under its last turns
template <int D, int kC>
__device__ __forceinline__ void overlap_block(
    const CUtensorMap* qmap, const CUtensorMap* kmap, const CUtensorMap* vmap,
    const CUtensorMap* qtail, const CUtensorMap* ktail,
    const CUtensorMap* vtail, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int BH, int H, int Sq, int Sk, long long osb,
    long long oss, long long osh, float scale_log2) {
  using T = Fwd<D, kC>;
  constexpr int kBlockN = T::kBlockN;
  constexpr int kBlockM = T::kBlockM;
  static_assert(T::kQBufs == 2, "a Q tile loads while the other runs");
  extern __shared__ __align__(1024) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [2] tiles
  __nv_bfloat16* Ks = Qs + 2 * T::kQElems;              // [kStages] tiles
  __nv_bfloat16* Vs = Ks + kStages * T::kKElems;        // [kStages] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::kBarOffset);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int tid = threadIdx.x;
  const int m_tiles = (Sq + kBlockM - 1) / kBlockM;
  const int n_tiles = (Sk + kBlockN - 1) / kBlockN;
  const int n_work = BH * m_tiles;   // q tiles
  check_smem_align(smem);
  zero_pads<D, kC, 2>(Qs, Ks, tid);
  if (tid == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(&q_full[qb], 1);
      mbar_init(&q_empty[qb], 4 * kC);   // one arrival per consumer warp
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], 4 * kC);
      mbar_init(&v_empty[st], 4 * kC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that ptxas sees it uniform
  // across the warp: branches on it around wgmma stay convergent
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == kC) {
    // producer: one thread issues every TMA load; the block's i-th q tile
    // takes Q buffer i % 2 and the ring's K/V tiles from i n_tiles on (kv)
    setmaxnreg_dec<24>();
    if (tid == 128 * kC) {
      int kv = 0;
      for (int t = blockIdx.x, i = 0; t < n_work; t += gridDim.x, ++i) {
        const int bh = t / m_tiles;
        const int b = bh / H;
        const int h = bh - b * H;
        const int qb = i & 1;
        mbar_wait(&q_empty[qb], ((i >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[qb], T::kChunks * kBlockM * 16);
        load_tile<D, kBlockM>(Qs + qb * T::kQElems, qmap, qtail, &q_full[qb],
                              (t - bh * m_tiles) * kBlockM, h, b);
        for (int j = 0; j < n_tiles; ++j, ++kv) {
          const int st = kv % kStages;
          const uint32_t ph = (kv / kStages) & 1;
          mbar_wait(&k_empty[st], ph ^ 1);
          mbar_arrive_expect_tx(&k_full[st], T::kChunks * kBlockN * 16);
          load_tile<D, kBlockN>(Ks + st * T::kKElems, kmap, ktail,
                                &k_full[st], j * kBlockN, h, b);
          mbar_wait(&v_empty[st], ph ^ 1);
          mbar_arrive_expect_tx(&v_full[st], T::kChunks * kBlockN * 16);
          load_tile<D, kBlockN>(Vs + st * T::kVElems, vmap, vtail,
                                &v_full[st], j * kBlockN, h, b);
        }
      }
    }
  } else {
    // consumer warpgroup wg: q rows [64 wg, 64 wg + 64) of each tile; the
    // registers the producer gave up (240 a thread for two consumer
    // warpgroups, 160 for three)
    setmaxnreg_inc<kC == 2 ? 240 : 160>();
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tg = lane & 3;
    if (wg == kC - 1) named_arrive(1, 256);   // warpgroup 0 goes first
    for (int t = blockIdx.x, i = 0; t < n_work; t += gridDim.x, ++i) {
      const int bh = t / m_tiles;
      const int b = bh / H;
      const int h = bh - b * H;
      const int qb = i & 1;
      const Ring<D> ring{i * n_tiles, Qs + qb * T::kQElems, Ks, Vs,
                         &q_full[qb], k_full, v_full, k_empty, v_empty};
      float acc[D / 2];              // O: D / 8 column tiles x 4
      float m_run[2] = {kNegBig, kNegBig};   // rows g, g + 8; log2 units
      float l_run[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;
      consume_overlap<D, kC>(ring, (i >> 1) & 1, t + gridDim.x < n_work, acc,
                             m_run, l_run, wg, lane, tg, n_tiles, Sk,
                             scale_log2);
      // every S of the tile has run: its Q buffer goes back
      if (lane == 0) mbar_arrive(&q_empty[qb]);
      store_rows<D>(acc, m_run, l_run, o + b * osb + h * osh,
                    lse == nullptr ? nullptr
                                   : lse + static_cast<long long>(bh) * Sq,
                    (t - bh * m_tiles) * kBlockM + wg * 64 + warp * 16 + g, Sq,
                    tg, oss);
    }
  }
}

// head dims 80, 96, 128 and 256: the ping-pong loop. maps: q, k, v (their
// swizzled boxes), then their tails' 8-column chunks
template <int D>
__global__ void __launch_bounds__(Fwd<D>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap qtail,
                 const __grid_constant__ CUtensorMap ktail,
                 const __grid_constant__ CUtensorMap vtail,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Sk, long long osb, long long oss,
                 long long osh, float scale_log2) {
  pingpong_block<D>(&qmap, &kmap, &vmap, &qtail, &ktail, &vtail, o, lse, H,
                    Sq, Sk, osb, oss, osh, scale_log2);
}

// head dims 64 and 72: the overlapped loop with kC consumer warpgroups;
// the same parameters
template <int D, int kC>
__global__ void __launch_bounds__(Fwd<D, kC>::kThreads, 1)
flash_fwd_kernel_overlap(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap qtail,
                         const __grid_constant__ CUtensorMap ktail,
                         const __grid_constant__ CUtensorMap vtail,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int BH, int H, int Sq,
                         int Sk, long long osb, long long oss, long long osh,
                         float scale_log2) {
  static_assert(fwd_overlapped(D), "the overlapped loop's head dims");
  overlap_block<D, kC>(&qmap, &kmap, &vmap, &qtail, &ktail, &vtail, o, lse,
                       BH, H, Sq, Sk, osb, oss, osh, scale_log2);
}

// the grid: the ping-pong loop a block per q tile; the overlapped loop a
// block per SM (no more than the q tiles), each running its share of them
template <auto kKernel, int D, int kC>
int launch_kernel(const CUtensorMap (&maps)[6], __nv_bfloat16* o, float* lse,
                  int B, int H, int Sq, int Sk, long long osb, long long oss,
                  long long osh, float scale_log2, int sms, cudaStream_t st) {
  using T = Fwd<D, kC>;
  const int err = allow_smem<kKernel>(T::kSmem);
  if (err != 0) return err;
  const int m_tiles = (Sq + T::kBlockM - 1) / T::kBlockM;
  if constexpr (fwd_overlapped(D)) {
    const int n_work = B * H * m_tiles;
    const dim3 grid(n_work < sms || sms <= 0 ? n_work : sms);
    kKernel<<<grid, T::kThreads, T::kSmem, st>>>(
        maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], o, lse, B * H,
        H, Sq, Sk, osb, oss, osh, scale_log2);
  } else {
    const dim3 grid(m_tiles, B * H);
    kKernel<<<grid, T::kThreads, T::kSmem, st>>>(
        maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], o, lse, H, Sq,
        Sk, osb, oss, osh, scale_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

// the instance's kernel: the ping-pong loop, or the overlapped one with
// `consumers` (fwd_consumers) consumer warpgroups
template <int D>
int launch(const CUtensorMap (&maps)[6], __nv_bfloat16* o, float* lse,
           int B, int H, int Sq, int Sk, long long osb, long long oss,
           long long osh, float scale_log2, int consumers, int sms,
           cudaStream_t st) {
  if constexpr (fwd_overlapped(D)) {
    if (consumers == 3) {
      return launch_kernel<flash_fwd_kernel_overlap<D, 3>, D, 3>(
          maps, o, lse, B, H, Sq, Sk, osb, oss, osh, scale_log2, sms, st);
    }
    return launch_kernel<flash_fwd_kernel_overlap<D, 2>, D, 2>(
        maps, o, lse, B, H, Sq, Sk, osb, oss, osh, scale_log2, sms, st);
  } else {
    return launch_kernel<flash_fwd_kernel<D>, D, 2>(
        maps, o, lse, B, H, Sq, Sk, osb, oss, osh, scale_log2, sms, st);
  }
}

// the card's SM count (the current device's, read once a device)
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return counts[dev];
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
  const int sms = sm_count();
  const int consumers = fwd_consumers(D, B * H, Sq, sms);
  for (int t = 0; t < 3; ++t) {
    const int rows = t == 0 ? fwd_block_m(consumers) : fwd_block_n(D);
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
                        scale_log2, consumers, sms, st);
    case 72:
      return launch<72>(maps, op, lp, B, H, Sq, Sk, osb, oss, osh,
                        scale_log2, consumers, sms, st);
    case 80:
      return launch<80>(maps, op, lp, B, H, Sq, Sk, osb, oss, osh,
                        scale_log2, consumers, sms, st);
    case 96:
      return launch<96>(maps, op, lp, B, H, Sq, Sk, osb, oss, osh,
                        scale_log2, consumers, sms, st);
    case 128:
      return launch<128>(maps, op, lp, B, H, Sq, Sk, osb, oss, osh,
                         scale_log2, consumers, sms, st);
    default:
      return launch<256>(maps, op, lp, B, H, Sq, Sk, osb, oss, osh,
                         scale_log2, consumers, sms, st);
  }
}
