// Fused packed binary conv layer for Hopper (sm_90a).
//
// Replaces: repro/kernels/binary_conv2x2_block.py:_conv_block_kernel (body
// conv_block_body): 2x2 stride-1 XNOR-popcount conv -> folded comparator
// (s >= tau) XOR flip -> optional 2x2/2 max-pool as an AND of sign bits ->
// repack, 32 neurons per word.  Packed words in, packed words out.
//
// What bounds it on the H100: integer issue, not memory.  Every output
// bit costs 4 taps x CW words of xor+popc (popc issues at 16 per clock
// per SM), while a layer's maps and weights are a few hundred KB that stay
// in L2.  Design: one warp per (frame, output position, 32-feature word).
// Lane j owns feature 32*fw + j; its 4 x CW weight words are loaded into
// registers once per block (the block's fw is fixed), so the inner loop
// reads only activation words, which all lanes read at the same address
// (a broadcast).  The ballot of the 32 lanes' bits is the output word, so
// no shuffle or shared-memory repack is needed.  Blocks stride over
// positions; F/32 blocks in y keep each block on one feature word.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv_block.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
conv_block_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ w,
                  const int32_t* __restrict__ tau, const int32_t* __restrict__ flip,
                  uint32_t* __restrict__ out, int b, int h, int wd, int cw,
                  int fwords, int k4, int pool) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int fw = blockIdx.y;
  const int f = fw * 32 + lane;
  uint32_t wr[4 * repro_torch::kMaxCw];
  repro_torch::load_taps(w, f, cw, cw, wr);
  const int t = tau[f];
  const int fl = flip[f];
  const int ho = pool ? (h - 1) / 2 : h - 1;
  const int wo = pool ? (wd - 1) / 2 : wd - 1;
  const int per_frame = ho * wo;
  const int items = b * per_frame;
  for (int item = blockIdx.x * kWarps + warp; item < items;
       item += gridDim.x * kWarps) {
    const int bi = item / per_frame;
    const int pos = item - bi * per_frame;
    const int yo = pos / wo;
    const int xo = pos - yo * wo;
    const uint32_t* frame = a + static_cast<size_t>(bi) * h * wd * cw;
    const uint32_t word = repro_torch::conv_word(frame, wd, cw, yo, xo,
                                                 pool != 0, wr, k4, t, fl);
    if (lane == 0) {
      out[static_cast<size_t>(item) * fwords + fw] = word;
    }
  }
}

}  // namespace

// a (B, H, W, CW), w (F, 4, CW) words; tau/flip (F,) int32; out
// (B, Ho, Wo, F/32) words.  F % 32 == 0 and CW <= 8, checked by the
// Python wrapper.  Returns cudaGetLastError() after the launch.
extern "C" int conv_block_launch(const void* a, const void* w, const void* tau,
                                 const void* flip, void* out, int b, int h,
                                 int wd, int cw, int f, int k4, int pool,
                                 void* stream) {
  const int fwords = f / 32;
  const int ho = pool ? (h - 1) / 2 : h - 1;
  const int wo = pool ? (wd - 1) / 2 : wd - 1;
  const long items = static_cast<long>(b) * ho * wo;
  long bx = (items + kWarps - 1) / kWarps;
  if (bx > 4096) bx = 4096;
  if (bx < 1) bx = 1;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(fwords));
  conv_block_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const int32_t*>(tau), static_cast<const int32_t*>(flip),
      static_cast<uint32_t*>(out), b, h, wd, cw, fwords, k4, pool);
  return static_cast<int>(cudaGetLastError());
}
