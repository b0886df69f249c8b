// The flash forward's tile rule by head dim (flash_attn_fwd.cu), in plain
// constexpr C++ that a host compiler also reads, so that the CPU tests can
// hold ops/flash_attention.py:fwd_tile_layout, its Python mirror, to it.
//
// A [rows, D] tile of Q, K or V is kept as swizzled boxes of fwd_box_cols(D)
// columns (sm90.cuh, "swizzled layout") and, past the last whole box,
// fwd_tail_cols(D) columns as 8-column chunks in the no-swizzle layout
// ("chunked layout"): the "split" layout where that tail is not empty (72,
// 80), the "swizzled" one where it is (64, 96, 128, 256).

#pragma once

#if defined(__CUDACC__)
#define FWD_RULE __host__ __device__ constexpr
#else
#define FWD_RULE constexpr
#endif

// keys per K/V tile: 128 up to head dim 128; 64 at 256, where O (128
// registers a thread) beside S and P of a 128-key tile would spill
FWD_RULE int fwd_block_n(int D) { return D <= 128 ? 128 : 64; }

// columns per swizzled box: 64 (the 128-byte swizzle) where the head dim
// leaves at most 16 columns past its whole 64-column boxes, 32 (the 64-byte
// swizzle) otherwise (96)
FWD_RULE int fwd_box_cols(int D) { return D % 64 <= 16 ? 64 : 32; }

// columns past the whole boxes, loaded as 8-column chunks: 8 at 72, 16 at
// 80, none at the other instances
FWD_RULE int fwd_tail_cols(int D) { return D % fwd_box_cols(D); }

#undef FWD_RULE
