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
// a float, far below the issue rate; so the design keeps as many bytes in
// flight as it can.  Two paths, both over a grid-stride loop of 8-warp
// blocks sized to the SMs by the wrapper:
//
// flat (K % 32 == 0, x 16-byte aligned): rows do not matter, word i packs
// flat floats 32i .. 32i + 31.  A warp takes a tile of kChunks 128-float
// chunks; lane l loads float4 l of each chunk (16 bytes, all kChunks loads
// in flight, through the read-only path) and forms the nibble of its
// floats 4l .. 4l + 3 at bits 4 (l & 7), so three __shfl_xor ORs leave word
// j of the chunk in lanes 8j .. 8j + 7.  Four more shuffles gather chunk
// u's four words into lane u, which stores them as one 16-byte word quad
// (out, a fresh allocation, is 16-byte aligned).
//
// rows (any other K or alignment): a warp takes one row's kChunks
// consecutive words; lane l loads float 32 w + l of each (masked past K:
// the +1.0 padding votes 0), and the ballot of the lanes' (x < 0) is word
// w, lane l on bit l: the LSB-first order of pack_bit_lanes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunks = 4;              // loads in flight a lane
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ uint32_t nibble(const float4 f) {
  return static_cast<uint32_t>(f.x < 0.0f) |
         static_cast<uint32_t>(f.y < 0.0f) << 1 |
         static_cast<uint32_t>(f.z < 0.0f) << 2 |
         static_cast<uint32_t>(f.w < 0.0f) << 3;
}

// x: nvec float4s (M K / 4, K % 32 == 0); out: nvec / 8 words
__global__ void __launch_bounds__(kThreads)
binarize_pack_flat_kernel(const float4* __restrict__ x,
                          uint32_t* __restrict__ out, long nvec) {
  const int lane = threadIdx.x & 31;
  const long words = nvec / 8;
  const long warps = static_cast<long>(gridDim.x) * kWarps;
  for (long tile = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       tile * 32 * kChunks < nvec; tile += warps) {
    const long v0 = tile * 32 * kChunks + lane;
    float4 f[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const long v = v0 + 32 * u;
      f[u] = v < nvec ? __ldg(x + v) : make_float4(1.f, 1.f, 1.f, 1.f);
    }
    uint32_t word[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      uint32_t b = nibble(f[u]) << (4 * (lane & 7));
      b |= __shfl_xor_sync(kFullMask, b, 1);
      b |= __shfl_xor_sync(kFullMask, b, 2);
      b |= __shfl_xor_sync(kFullMask, b, 4);
      word[u] = b;                     // word (u, lane >> 3) of the tile
    }
    // lane 8j + i offers word (i & 3, j); lane u < kChunks gathers chunk
    // u's words j = 0..3 from lanes 8j + u
    const int q = lane & 3;
    uint32_t mine = word[0];
#pragma unroll
    for (int u = 1; u < kChunks; ++u) mine = q == u ? word[u] : mine;
    const uint4 quad = make_uint4(__shfl_sync(kFullMask, mine, q),
                                  __shfl_sync(kFullMask, mine, 8 + q),
                                  __shfl_sync(kFullMask, mine, 16 + q),
                                  __shfl_sync(kFullMask, mine, 24 + q));
    const long w0 = tile * 4 * kChunks + 4 * lane;   // chunk lane's words
    if (lane < kChunks && w0 < words) {
      if (w0 + 4 <= words) {
        *reinterpret_cast<uint4*>(out + w0) = quad;
      } else {
        const uint32_t q4[4] = {quad.x, quad.y, quad.z, quad.w};
        for (int j = 0; w0 + j < words; ++j) out[w0 + j] = q4[j];
      }
    }
  }
}

// x (M, K) float32, out (M, kw) words; a work item is one row's kChunks
// consecutive words
__global__ void __launch_bounds__(kThreads)
binarize_pack_rows_kernel(const float* __restrict__ x,
                          uint32_t* __restrict__ out, int m, int k, int kw) {
  const int lane = threadIdx.x & 31;
  const int spans = (kw + kChunks - 1) / kChunks;     // items a row
  const long items = static_cast<long>(m) * spans;
  const long warps = static_cast<long>(gridDim.x) * kWarps;
  for (long item = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       item < items; item += warps) {
    const long row = item / spans;                      // warp-uniform
    const int wd0 = static_cast<int>(item - row * spans) * kChunks;
    const float* xr = x + row * k;
    bool neg[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int col = (wd0 + u) * 32 + lane;
      neg[u] = col < k && __ldg(xr + col) < 0.0f;
    }
    uint32_t mine = 0;
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const uint32_t bits = __ballot_sync(kFullMask, neg[u]);
      mine = lane == u ? bits : mine;
    }
    if (lane < kChunks && wd0 + lane < kw) out[row * kw + wd0 + lane] = mine;
  }
}

}  // namespace

// x (M, K) float32, out (M, ceil(K/32)) words, both contiguous; flat != 0
// takes the flat path (the wrapper checks K % 32 == 0 and x's 16-byte
// alignment), else the row path; blocks of 8 warps (the wrapper's
// pack_blocks).  Returns cudaGetLastError() after the launch.
extern "C" int binarize_pack_launch(const void* x, void* out, int m, int k,
                                    int flat, int blocks, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint32_t*>(out);
  if (flat) {
    binarize_pack_flat_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float4*>(x), o, static_cast<long>(m) * k / 4);
  } else {
    binarize_pack_rows_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), o, m, k, (k + 31) / 32);
  }
  return static_cast<int>(cudaGetLastError());
}
