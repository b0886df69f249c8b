// The flash forward's tile and loop rules by head dim (flash_attn_fwd.cu),
// in plain constexpr C++ that a host compiler also reads, so that the CPU
// tests can hold their Python mirrors, ops/flash_attention.py:
// fwd_tile_layout and fwd_loop, to them.
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

// the consumers' loop: the overlapped one (flash_fwd_kernel_overlap: each
// warpgroup waits for its S alone and runs the softmax before its P V has
// finished) at 64 and 72, the instances whose flash backward runs its
// overlapped loop too; the ping-pong loop (flash_fwd_kernel) at 80, 96, 128
// and 256
FWD_RULE bool fwd_overlapped(int D) { return D <= 72; }

// consumer warpgroups a block, 64 q rows each, for a launch over `heads`
// (batch x heads) of Sq q rows on a card of `sms` SMs: two in the
// ping-pong loop (at 128 and 256 O's registers need the 240 a thread that
// only two consumer warpgroups leave); in the overlapped loop three
// (192-row q tiles, 160 registers a thread) where their blocks take fewer
// waves of the card, at 13/10 of a two-warpgroup block's time a wave, than
// two warpgroups' 128-row blocks. A warpgroup's softmax there takes one to
// two times its products, so a third warpgroup's products keep the tensor
// cores busier, and a 192-row q tile took 1.23-1.30 times a 128-row one on
// an H100 (three against two: 0.0988 ms against 0.1047 at
// 2x2048x2048x16x72, 0.0496 against 0.0402 at 1x2048x1370x16x72, whose
// last wave is a third full; the rule picks the faster at every cell's
// shape measured)
FWD_RULE int fwd_consumers(int D, int heads, int Sq, int sms) {
  if (!fwd_overlapped(D) || sms <= 0) return 2;
  const int waves2 = (heads * ((Sq + 127) / 128) + sms - 1) / sms;
  const int waves3 = (heads * ((Sq + 191) / 192) + sms - 1) / sms;
  return 13 * waves3 < 10 * waves2 ? 3 : 2;
}

// q rows a block of `consumers` consumer warpgroups
FWD_RULE int fwd_block_m(int consumers) { return 64 * consumers; }

#undef FWD_RULE
