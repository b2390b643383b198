// Fused sign + bitpack for Hopper (sm_90a).
//
// Replaces: repro/kernels/binarize_pack.py:_binarize_pack_kernel: an
// (M, K) float32 tile -> (M, ceil(K/32)) packed sign words, bit 1 iff
// x < 0 (so -0.0 and NaN give bit 0), K padded with +1.0 (bit 0).  It is
// the producer of the packed activations that xnor_matmul and
// binary_conv2x2 read.
//
// What bounds it on the H100: memory.  Each input float is read once and
// each output word written once (33 bytes for 32 inputs), with one compare
// and a ballot per 32 inputs, far below the issue rate.  Design: one warp
// per output word.  Lane i reads x[m, 32*kw + i] (the warp reads 128
// contiguous bytes, one transaction), and __ballot_sync of the lanes'
// (x < 0) is the word itself, lane i on bit i: the LSB-first lane order of
// pack_bit_lanes.  Lanes at or past K vote 0, which is the +1.0 padding.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
binarize_pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ out,
                     int m, int k, int kw) {
  const int lane = threadIdx.x & 31;
  const long words = static_cast<long>(m) * kw;
  for (long word = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       word < words; word += static_cast<long>(gridDim.x) * kWarps) {
    const long row = word / kw;                        // warp-uniform
    const int col = static_cast<int>(word - row * kw) * 32 + lane;
    const bool neg = col < k && x[row * k + col] < 0.0f;
    const uint32_t bits = __ballot_sync(0xffffffffu, neg);
    if (lane == 0) out[word] = bits;
  }
}

}  // namespace

// x (M, K) float32, out (M, ceil(K/32)) words, both contiguous (checked
// by the Python wrapper).  Returns cudaGetLastError() after the launch.
extern "C" int binarize_pack_launch(const void* x, void* out, int m, int k,
                                    void* stream) {
  const int kw = (k + 31) / 32;
  const long words = static_cast<long>(m) * kw;
  long blocks = (words + kWarps - 1) / kWarps;
  if (blocks > 65535) blocks = 65535;
  if (blocks < 1) blocks = 1;
  binarize_pack_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint32_t*>(out), m, k, kw);
  return static_cast<int>(cudaGetLastError());
}
