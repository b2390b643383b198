// Unfused packed 2x2 stride-1 binary convolution for Hopper (sm_90a).
//
// Replaces: repro/kernels/binary_conv2x2.py:_binary_conv2x2_kernel: packed
// maps (B, H, W, CW) and packed taps (F, 4, CW), (dy, dx) row major, ->
// int32 sums (B, H-1, W-1, F) = 4c - 2 * popcount(a ^ w) over the 2x2
// window.  Any c >= 1 (CW <= 64 words, 2048 channels), any H, W >= 2,
// any F.  Words past c are zero in both operands (pack_signs pads with
// +1), so they add nothing and need no mask.
//
// What bounds it on the H100: integer issue.  Each output sum costs 4 x CW
// xor+popc (popc issues at 16 per clock per SM) and is written as 4 bytes:
// at cifar9_s1's first layer (B=8, 32x32, 256 channels, 256 features) that
// is about 63 M word-ops against 7.9 MB of output.  Design, simple and
// right: one warp per (frame, output position, 32-feature tile), lane j on
// feature 32*tile + j.  The block's tile of taps is staged in shared
// memory as [tap][word][lane], so a lane's reads are conflict-free, and
// the activation words are read by all lanes at one address (a
// broadcast).  Consecutive lanes write consecutive features (128-byte
// stores when F % 32 == 0).  Features past F (the ragged tile) compute on
// zero taps and store nothing.  Unlike conv_block.cuh's register-resident
// taps (kMaxCw = 8), the channel words are a runtime loop.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxCw = 64;     // 4 x 64 x 32 words = 32 KB of taps a block

__global__ void __launch_bounds__(kWarps * 32)
binary_conv2x2_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ w,
                      int32_t* __restrict__ out, int b, int h, int wd,
                      int cw, int f, int k4) {
  extern __shared__ uint32_t taps[];                   // [4 * cw][32]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = blockIdx.y * 32;
  for (int idx = threadIdx.x; idx < 4 * cw * 32; idx += kWarps * 32) {
    const int fi = f0 + (idx & 31);
    const int ti = idx >> 5;                            // tap * cw + word
    taps[idx] = fi < f ? w[static_cast<size_t>(fi) * 4 * cw + ti] : 0u;
  }
  __syncthreads();
  const int ho = h - 1, wo = wd - 1;
  const long per_frame = static_cast<long>(ho) * wo;
  const long items = b * per_frame;
  const int fl = f0 + lane;
  for (long item = static_cast<long>(blockIdx.x) * kWarps + warp;
       item < items; item += static_cast<long>(gridDim.x) * kWarps) {
    const long bi = item / per_frame;
    const int pos = static_cast<int>(item - bi * per_frame);
    const int y = pos / wo;
    const int x = pos - y * wo;
    int acc = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t* p =
          a + ((bi * h + y + (t >> 1)) * wd + x + (t & 1)) * cw;
      const uint32_t* q = taps + t * cw * 32 + lane;
      for (int i = 0; i < cw; ++i) acc += __popc(p[i] ^ q[i * 32]);
    }
    if (fl < f) out[item * f + fl] = k4 - 2 * acc;
  }
}

}  // namespace

// a (B, H, W, CW), w (F, 4, CW) words, out (B, H-1, W-1, F) int32, all
// contiguous; 1 <= CW <= 64, H, W >= 2 (checked by the Python wrapper).
// Returns cudaGetLastError() after the launch.
extern "C" int binary_conv2x2_launch(const void* a, const void* w, void* out,
                                     int b, int h, int wd, int cw, int f,
                                     int k4, void* stream) {
  if (cw < 1 || cw > kMaxCw) return static_cast<int>(cudaErrorInvalidValue);
  const long items = static_cast<long>(b) * (h - 1) * (wd - 1);
  long bx = (items + kWarps - 1) / kWarps;
  if (bx > 8192) bx = 8192;
  if (bx < 1) bx = 1;
  const dim3 grid(static_cast<unsigned>(bx),
                  static_cast<unsigned>((f + 31) / 32));
  const size_t smem = static_cast<size_t>(4) * cw * 32 * sizeof(uint32_t);
  binary_conv2x2_kernel<<<grid, kWarps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<int32_t*>(out), b, h, wd, cw, f, k4);
  return static_cast<int>(cudaGetLastError());
}
