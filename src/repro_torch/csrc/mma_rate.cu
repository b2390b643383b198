// Issue-rate probe of Hopper's (sm_90a) integer tensor-core MMAs:
// mma.sync m16n8k256 .b1 .and.popc (32,768 binary MACs, the conv kernels'
// instruction, conv_mma.cuh) against m16n8k32 .s8 (4,096 int8 MACs, the
// instruction the data sheet's int8 rate is for).  Each warp runs kChains
// independent accumulator chains on register operands, so the tensor
// cores' issue rate, not latency or memory, sets the time.  chip_smoke.py
// times both and scales the data sheet's int8 MAC rate by their measured
// MAC-rate ratio for the binary MACs' bound.  mma_latency_launch times one
// dependent chain of either MMA in one warp: the latency a chain of
// dependent MMAs (a tile's K steps) pays.  empty_launch launches a kernel
// that does nothing: its device time is the card's launch floor, which the
// smallest kernels of the port (one block, a few microseconds) sit near.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

// c += a x b: the .b1 m16n8k256 AND-popc MMA, or the .s8 m16n8k32 one
template <bool kBinary>
__device__ __forceinline__ void mma_step(int (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  if (kBinary) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
}

template <bool kBinary>
__global__ void __launch_bounds__(kThreads)
mma_rate_kernel(int iters, uint32_t seed, int* sink) {
  const uint32_t a0 = seed ^ threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u,
                 a3 = a0 * 7u, b0 = a0 * 11u, b1 = a0 * 13u;
  int c[kChains][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      mma_step<kBinary>(c[k], a0, a1, a2, a3, b0, b1);
    }
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  if (s == 0x7fffffff) sink[0] = s;     // keeps every chain live
}

// One warp, one dependent chain of iters MMAs between two clock64 reads:
// the MMA's latency in SM clocks, iters times over.
template <bool kBinary>
__global__ void __launch_bounds__(32)
mma_latency_kernel(int iters, uint32_t seed, int* sink, long long* clocks) {
  const uint32_t a0 = seed ^ threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u,
                 a3 = a0 * 7u, b0 = a0 * 11u, b1 = a0 * 13u;
  int c[4] = {};
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) mma_step<kBinary>(c, a0, a1, a2, a3, b0, b1);
  const int s = c[0] + c[1] + c[2] + c[3];
  const long long t1 = clock64();
  if (threadIdx.x == 0) clocks[0] = t1 - t0;
  if (s == 0x7fffffff) sink[0] = s;
}

__global__ void empty_kernel() {}

}  // namespace

// binary != 0: the .b1 MMA, else the .s8 one; blocks x 8 warps, each
// kChains x iters MMAs.  sink: one int32 on the card.  Returns
// cudaGetLastError() after the launch.
extern "C" int mma_rate_launch(int binary, int blocks, int iters, void* sink,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out = static_cast<int*>(sink);
  constexpr uint32_t kSeed = 0x9e3779b9u;
  if (binary) {
    mma_rate_kernel<true><<<blocks, kThreads, 0, s>>>(iters, kSeed, out);
  } else {
    mma_rate_kernel<false><<<blocks, kThreads, 0, s>>>(iters, kSeed, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The latency probe: one warp, iters dependent MMAs (binary != 0: .b1,
// else .s8); clocks: one int64 on the card, the chain's SM clocks.
extern "C" int mma_latency_launch(int binary, int iters, void* sink,
                                  void* clocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out = static_cast<int*>(sink);
  long long* clk = static_cast<long long*>(clocks);
  constexpr uint32_t kSeed = 0x9e3779b9u;
  if (binary) {
    mma_latency_kernel<true><<<1, 32, 0, s>>>(iters, kSeed, out, clk);
  } else {
    mma_latency_kernel<false><<<1, 32, 0, s>>>(iters, kSeed, out, clk);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch-floor probe: one block of one warp running no instruction.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
