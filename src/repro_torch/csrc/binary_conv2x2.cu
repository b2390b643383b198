// Unfused packed 2x2 stride-1 binary convolution for Hopper (sm_90a).
//
// Replaces: repro/kernels/binary_conv2x2.py:_binary_conv2x2_kernel: packed
// maps (B, H, W, CW) and packed taps (F, 4, CW), (dy, dx) row major, ->
// int32 sums (B, H-1, W-1, F) = 4c - 2 * popcount(a ^ w) over the 2x2
// window, popcounting every bit of every word (words past c are zero in
// both operands when pack_signs made them).  Any c >= 1 (CW <= 64 words,
// 2048 channels), any H, W >= 2, any F.
//
// What bounds it on the H100: bytes.  At cifar9_s1's first layer (B=8,
// 32x32, 256 channels, 256 features) the 7.87 MB of int32 sums take
// 0.0024 ms at 3.35 TB/s; the 2.0 G binary MACs take 0.00025 ms at the
// tensor cores' binary rate (8x the int8 MAC rate: a .b1 m16n8k256 MMA
// issues at the rate of an int8 m16n8k32 one, chip_smoke.py's MMA issue
// probe).  Design: the binary implicit GEMM of conv_mma.cuh (mma.sync
// m16n8k256 .b1 .and.popc, the XNOR count from the AND count), so the
// MACs cost a tenth of the stores; the sums leave straight from the
// accumulator fragments, each lane's two neighbouring features as one
// 8-byte store when F is even, so every store instruction fills whole
// 32-byte sectors (8 positions x 32 bytes) once F % 8 == 0 and each sum is
// written once (a warp's sums staged in shared memory for 128-byte row
// stores measured no faster: launch/time_convs.py, PERF.md).  The feature
// tile is sized by the wrapper so that its taps fit shared memory whole at
// CW = 64 (32 features x 264 words), so K is never streamed, and a band is
// a chunk of a row's columns where a whole row does not fit, so any width
// runs.  Features past F (a ragged tile) compute on zero taps and store
// nothing.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv_mma.cuh"

namespace {

using namespace repro_torch::conv_mma;

constexpr int kMaxCw = 64;

template <bool kChunked>
__global__ void __launch_bounds__(kThreads)
binary_conv2x2_mma(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ w, int32_t* __restrict__ out,
                   int h, int wd, int cw, int f, int k4, const Geometry g) {
  extern __shared__ uint4 smem4[];
  const int ho = h - 1, wo = wd - 1;
  const int nblk = 32 * g.nslices;
  const int n0 = blockIdx.y * nblk;
  const Band bd = band_of<kChunked>(blockIdx.x, g, ho, wo);
  const Smem sm = carve(reinterpret_cast<uint32_t*>(smem4), nblk, g.kstride);
  stage_taps(w, f, n0, nblk, cw, g, sm.taps);
  const uint32_t* sa =
      stage_band<kChunked>(sm.band, a, bd, g, h, wd, cw, false);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int slice = warp % g.nslices;
  const int f0 = n0 + 32 * slice;          // the slice's first feature
  if (f0 >= f) return;
  const uint32_t* sb = sm.taps + 32 * slice * g.kstride;
  int pw[4][4] = {};          // the taps' popcounts, from the first tile
  int kc[4][2];               // k4 - 2 pw
  const bool vec = !((cw | static_cast<int>(
      reinterpret_cast<uintptr_t>(sa) >> 2)) & 1);
  const bool pairs = !(f & 1);             // 8-byte aligned sum pairs
  int32_t* out_frame = out + static_cast<size_t>(bd.frame) * ho * wo * f;
  const int tiles = (bd.windows + 15) / 16;
  for (int mt = warp / g.nslices; mt < tiles; mt += kWarps / g.nslices) {
    const Row r0 = row_of(16 * mt + gr, bd, g.pitch, cw, wo, false);
    const Row r1 = row_of(16 * mt + gr + 8, bd, g.pitch, cw, wo, false);
    int acc[4][4] = {};
    int pa[2] = {0, 0};
    if (mt == warp / g.nslices) {
      mma_tile<true>(sa, r0.base, r1.base, sb, g.kstride, g.ksteps, cw,
                     g.pitch, vec, lane, acc, pa, pw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kc[j][0] = k4 - 2 * pw[j][0];
        kc[j][1] = k4 - 2 * pw[j][1];
      }
    } else {
      mma_tile<false>(sa, r0.base, r1.base, sb, g.kstride, g.ksteps, cw,
                      g.pitch, vec, lane, acc, pa, pw);
    }
    pa[0] = quad_sum(pa[0]);
    pa[1] = quad_sum(pa[1]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pos = half ? r1.out : r0.out;
      if (pos < 0) continue;
      int32_t* row = out_frame + static_cast<size_t>(pos) * f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int fi = f0 + 8 * j + 2 * t;
        const int s0 = kc[j][0] - 2 * pa[half] + 4 * acc[j][2 * half];
        const int s1 = kc[j][1] - 2 * pa[half] + 4 * acc[j][2 * half + 1];
        if (pairs && fi < f) {
          *reinterpret_cast<int2*>(row + fi) = make_int2(s0, s1);
        } else {
          if (fi < f) row[fi] = s0;
          if (fi + 1 < f) row[fi + 1] = s1;
        }
      }
    }
  }
}

}  // namespace

// a (B, H, W, CW), w (F, 4, CW) words, both 16-byte aligned; out
// (B, H-1, W-1, F) int32, all contiguous; 1 <= CW <= 64, H, W >= 2
// (checked by the Python wrapper); the launch geometry (rows ... pitch, as
// Geometry; the feature tiles grid_y and the dynamic shared memory bytes
// smem) is its conv_tiles.  Returns
// cudaGetLastError() after the launch.
extern "C" int binary_conv2x2_launch(const void* a, const void* w, void* out,
                                     int b, int h, int wd, int cw, int f,
                                     int k4, int rows, int bands, int cols,
                                     int chunks, int nslices, int ksteps,
                                     int kstride, int in_cols, int pitch,
                                     int grid_y, int smem, void* stream) {
  if (cw < 1 || cw > kMaxCw) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{rows, bands, cols, chunks, nslices, ksteps, kstride,
                   in_cols, pitch};
  auto* kernel =
      chunks > 1 ? binary_conv2x2_mma<true> : binary_conv2x2_mma<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(b * bands * chunks),
                  static_cast<unsigned>(grid_y));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<int32_t*>(out), h, wd, cw, f, k4, g);
  return static_cast<int>(cudaGetLastError());
}
