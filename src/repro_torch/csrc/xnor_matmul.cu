// Packed XNOR-popcount binary matmul for Hopper (sm_90a).
//
// Replaces: repro/kernels/xnor_matmul.py:_xnor_matmul_kernel (int32 sums
// K - 2*popcount(a ^ w)) and :_xnor_matmul_pack_kernel (the same sums,
// signed and packed 32 per word along N).  One source, a template flag
// selects the variant.
//
// What bounds it on the H100: at the chip tier's FC shapes (M = batch,
// N <= 256, K <= 1600) the whole problem is a few KB and a few thousand
// word-ops, so launch latency bounds it long before bytes or popc issue.
// Design, simple and right: the plain variant runs one thread per (m, n)
// over the Kw words; the packed variant runs one warp per (m, 32
// consecutive n), lane j on n = 32*nw + j, and the ballot of the lanes'
// sign bits (s < 0) is the output word, lane 0 on bit 0.  Tail words of K
// are zero on both operands (pack_signs pads with +1), so they add
// nothing and need no mask.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ int xnor_sum(const uint32_t* __restrict__ a,
                                        const uint32_t* __restrict__ w,
                                        int kw, int k) {
  int acc = 0;
  for (int i = 0; i < kw; ++i) acc += __popc(a[i] ^ w[i]);
  return k - 2 * acc;
}

template <bool kPackOut>
__global__ void xnor_matmul_kernel(const uint32_t* __restrict__ a,
                                   const uint32_t* __restrict__ w,
                                   void* __restrict__ out, int m, int n,
                                   int kw, int k) {
  if constexpr (kPackOut) {
    // blockDim.x = 32 lanes x blockDim.y warps; one warp per output word
    const int lane = threadIdx.x;
    const int nwords = n / 32;
    const long word = static_cast<long>(blockIdx.x) * blockDim.y + threadIdx.y;
    if (word >= static_cast<long>(m) * nwords) return;   // warp-uniform
    const int mi = static_cast<int>(word / nwords);
    const int nw = static_cast<int>(word - static_cast<long>(mi) * nwords);
    const int ni = nw * 32 + lane;
    const int s = xnor_sum(a + static_cast<size_t>(mi) * kw,
                           w + static_cast<size_t>(ni) * kw, kw, k);
    const uint32_t bits = __ballot_sync(0xffffffffu, s < 0);
    if (lane == 0) static_cast<uint32_t*>(out)[word] = bits;
  } else {
    const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= static_cast<long>(m) * n) return;
    const int mi = static_cast<int>(idx / n);
    const int ni = static_cast<int>(idx - static_cast<long>(mi) * n);
    static_cast<int32_t*>(out)[idx] =
        xnor_sum(a + static_cast<size_t>(mi) * kw,
                 w + static_cast<size_t>(ni) * kw, kw, k);
  }
}

}  // namespace

// a (M, Kw), w (N, Kw) words.  pack_out = 0: out (M, N) int32 sums;
// pack_out = 1: out (M, N/32) words (N % 32 == 0, checked by the Python
// wrapper).  Returns cudaGetLastError() after the launch.
extern "C" int xnor_matmul_launch(const void* a, const void* w, void* out,
                                  int m, int n, int kw, int k, int pack_out,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const uint32_t*>(a);
  const auto* wp = static_cast<const uint32_t*>(w);
  if (pack_out) {
    constexpr int kWarps = 4;
    const long words = static_cast<long>(m) * (n / 32);
    const long blocks = (words + kWarps - 1) / kWarps;
    xnor_matmul_kernel<true><<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                               dim3(32, kWarps), 0, s>>>(ap, wp, out, m, n, kw, k);
  } else {
    constexpr int kThreads = 128;
    const long total = static_cast<long>(m) * n;
    const long blocks = (total + kThreads - 1) / kThreads;
    xnor_matmul_kernel<false><<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                                kThreads, 0, s>>>(ap, wp, out, m, n, kw, k);
  }
  return static_cast<int>(cudaGetLastError());
}
