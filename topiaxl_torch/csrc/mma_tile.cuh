// Tile helpers shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the block shape, the mma.sync m16n8k16 bf16 product
// with f32 accumulation, fragment loads from shared memory, and the load
// of a 64-row [S, D] tile of one head into shared memory with head_dim
// zero-padded to a multiple of 16.
//
// Fragment layout (PTX ISA, mma.m16n8k16 .bf16): lane = 4 * g + tg; an A
// fragment holds rows g and g + 8, column pairs tg * 2 (+ 8); a B fragment
// holds column g, row pairs tg * 2 (+ 8); the f32 accumulator holds rows
// g and g + 8, columns tg * 2 and tg * 2 + 1.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // q rows per q tile (16 per warp)
constexpr int kBlockN = 64;   // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats -> packed bf16x2, `lo` in the low half (lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_u16(const __nv_bfloat16* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p));
}

// two bf16 of one column, rows r and r + 1 of a row-major tile, as the
// packed pair a B (or transposed A) fragment wants
__device__ __forceinline__ uint32_t ld_col2(const __nv_bfloat16* p, int ld) {
  return ld_u16(p) | (ld_u16(p + ld) << 16);
}

template <int D>
struct Dims {
  static constexpr int kSteps = (D + 15) / 16;  // 16-wide steps over D
  static constexpr int DP = kSteps * 16;        // D padded in shared memory
  static constexpr int LD = DP + 8;             // smem row stride: no bank conflicts
  static constexpr int kDTiles = D / 8;         // 8-wide column tiles of D
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
};

// rows [row0, row0 + 64) of one head into shared memory with row stride
// LD; rows >= len are written as zeros. With kPad the head-dim padding
// columns [D, DP) are written as zeros too; without it they are left as
// they are, for a kernel that zeroes its tiles once and so saves those
// stores on every tile it loads.
template <int D, bool kPad = true>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int len) {
  constexpr int kVecP = (kPad ? Dims<D>::DP : D) / 8;
  constexpr int LD = Dims<D>::LD;
  for (int i = threadIdx.x; i < 64 * kVecP; i += kThreads) {
    const int r = i / kVecP;
    const int c = i - r * kVecP;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if ((!kPad || c < D / 8) && row0 + r < len) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * row_stride + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

}  // namespace
