// The fused binary conv layer's per-word arithmetic on the CUDA cores, for
// the one-block member body (megakernel.cuh run_member), which the fused
// cascade (cascade.cu) alone still runs; the staged conv kernel and the
// cluster body compute the same layer on the tensor cores (conv_mma.cuh).
//
// Conventions (those of repro.core.binarize): +1 -> bit 0, -1 -> bit 1,
// 32 channels per uint32 word, LSB first.  A map is (H, W, CW) words, row
// major; weights are (F, 4, CW) words with taps (dy, dx) row major.
#pragma once

#include <cstdint>

namespace repro_torch {

constexpr int kMaxCw = 8;      // 256 channels: the widest map the chip has
constexpr unsigned kFullMask = 0xffffffffu;

// Loads the 4 taps x cw words of feature f into registers (lane-private).
// The weights are (F, 4, stride) words, of which the first cw of each tap
// are read: stride is cw for one layer's own weights and the image's
// widest channel-word count for a composite weight image.
__device__ __forceinline__ void load_taps(const uint32_t* __restrict__ w,
                                          int f, int cw, int stride,
                                          uint32_t (&wr)[4 * kMaxCw]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int i = 0; i < kMaxCw; ++i) {
      wr[t * kMaxCw + i] = i < cw ? w[(f * 4 + t) * stride + i] : 0u;
    }
  }
}

// Sign bit (1 = -1) of one feature at conv output position (y, x):
// s = 4c - 2 * popcount(a ^ w) over the 2x2 window, then the folded
// comparator bit = 1 - ((s >= tau) ^ flip).
__device__ __forceinline__ uint32_t conv_bit(const uint32_t* __restrict__ a,
                                             int wd, int cw, int y, int x,
                                             const uint32_t (&wr)[4 * kMaxCw],
                                             int k4, int tau, int flip) {
  int acc = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint32_t* p = a + ((y + (t >> 1)) * wd + (x + (t & 1))) * cw;
#pragma unroll
    for (int i = 0; i < kMaxCw; ++i) {
      if (i < cw) acc += __popc(p[i] ^ wr[t * kMaxCw + i]);
    }
  }
  const int s = k4 - 2 * acc;
  return 1u - (static_cast<uint32_t>(s >= tau) ^ static_cast<uint32_t>(flip));
}

// One packed output word at output position (yo, xo), computed by a whole
// warp: lane j owns feature 32*fw + j (its taps in wr), and the ballot of
// the lanes' sign bits is the word, lane 0 on bit 0.  With pool, the bit is
// the AND over the 2x2/2 window of conv positions (max-pool in the sign
// domain); the odd trailing row/column is never read.
__device__ __forceinline__ uint32_t conv_word(const uint32_t* __restrict__ a,
                                              int wd, int cw, int yo, int xo,
                                              bool pool,
                                              const uint32_t (&wr)[4 * kMaxCw],
                                              int k4, int tau, int flip) {
  uint32_t bit;
  if (pool) {
    const int y = 2 * yo, x = 2 * xo;
    bit = conv_bit(a, wd, cw, y, x, wr, k4, tau, flip) &
          conv_bit(a, wd, cw, y, x + 1, wr, k4, tau, flip) &
          conv_bit(a, wd, cw, y + 1, x, wr, k4, tau, flip) &
          conv_bit(a, wd, cw, y + 1, x + 1, wr, k4, tau, flip);
  } else {
    bit = conv_bit(a, wd, cw, yo, xo, wr, k4, tau, flip);
  }
  return __ballot_sync(kFullMask, bit);
}

}  // namespace repro_torch
