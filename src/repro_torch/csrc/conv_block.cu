// Fused packed binary conv layer for Hopper (sm_90a).
//
// Replaces: repro/kernels/binary_conv2x2_block.py:_conv_block_kernel (body
// conv_block_body): 2x2 stride-1 XNOR-popcount conv -> folded comparator
// (s >= tau) XOR flip -> optional 2x2/2 max-pool as an AND of sign bits ->
// repack, 32 neurons per word.  Packed words in, packed words out.
//
// What bounds it on the H100: the tensor cores' binary MACs.  cifar9_s1's
// eight layers at B=8 are 8.05 G binary MACs, 0.0010 ms at the binary
// rate (8x the int8 MAC rate of 1,979 TOP/s: a .b1 m16n8k256 MMA issues at
// the rate of an int8 m16n8k32 one, chip_smoke.py's MMA issue probe),
// against a few hundred KB of maps and taps (about 0.0003 ms at 3.35
// TB/s).
// Design: the binary implicit GEMM of conv_mma.cuh, mma.sync m16n8k256
// .b1 .and.popc with the XNOR count from the AND count.  The block stages
// its band of input rows (a chunk of their columns where a whole row does
// not fit, so any width runs) and its feature tile's taps, tau and flip in
// shared memory by cp.async once; the epilogue runs on the accumulator
// fragments: s, the comparator, with pool the AND of a window's four
// corners (two rows of a lane, then lane ^ 16), and the 32 features of a
// word, spread over a quad's lanes and four n8 tiles, ORed together by
// shuffles.  One lane of a quad stores the whole word.  Measured
// (chip_smoke.py phase 7, PERF.md): a layer is one wave of short blocks,
// each a dependent chain of staging, one or two tiles and the epilogue,
// so latency, not the MACs, sets its time (3-7 us a layer, tens of times
// the bound).  The cluster member body of the whole-network kernels
// (member_mma.cuh) computes the same layer from the same tile and
// epilogue (conv_mma.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "conv_mma.cuh"

namespace {

using namespace repro_torch::conv_mma;

template <bool kChunked>
__global__ void __launch_bounds__(kThreads)
conv_block_mma(const uint32_t* __restrict__ a, const uint32_t* __restrict__ w,
               const int32_t* __restrict__ tau,
               const int32_t* __restrict__ flip, uint32_t* __restrict__ out,
               int h, int wd, int cw, int f, int k4, int pool,
               const Geometry g) {
  extern __shared__ uint4 smem4[];
  const int ho = pool ? (h - 1) / 2 : h - 1;
  const int wo = pool ? (wd - 1) / 2 : wd - 1;
  const int nblk = 32 * g.nslices;
  const int n0 = blockIdx.y * nblk;
  const Band bd = band_of<kChunked>(blockIdx.x, g, ho, wo);
  const Smem sm = carve(reinterpret_cast<uint32_t*>(smem4), nblk, g.kstride);
  stage_taps(w, f, n0, nblk, cw, g, sm.taps);
  // tau and flip of the tile's features (16-byte aligned, F % 32 == 0)
  for (int i = threadIdx.x; i < nblk / 2; i += kThreads) {
    const int q = 4 * (i % (nblk / 4));
    const bool ok = n0 + q < f;
    const int32_t* src = i < nblk / 4 ? tau : flip;
    cp_async16((i < nblk / 4 ? sm.tau : sm.flip) + q, ok ? src + n0 + q : src,
               ok);
  }
  const uint32_t* sa =
      stage_band<kChunked>(sm.band, a, bd, g, h, wd, cw, pool != 0);

  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int slice = warp % g.nslices;
  if (n0 + 32 * slice >= f) return;
  const uint32_t* sb = sm.taps + 32 * slice * g.kstride;
  // the comparator of this lane's 8 features
  int th[4][2];
  const uint32_t fl =
      load_comparator(sm.tau + 32 * slice, sm.flip + 32 * slice, t, th);
  int pw[4][4] = {};          // the taps' popcounts, from the first tile
  int kc[4][2];               // k4 - 2 pw
  const bool vec = !((cw | static_cast<int>(
      reinterpret_cast<uintptr_t>(sa) >> 2)) & 1);
  const int fwords = f / 32;
  const int fw = n0 / 32 + slice;
  uint32_t* out_frame =
      out + static_cast<size_t>(bd.frame) * ho * wo * fwords + fw;
  const int rows_m = pool ? 4 * bd.windows : bd.windows;
  const int tiles = (rows_m + 15) / 16;
  for (int mt = warp / g.nslices; mt < tiles; mt += kWarps / g.nslices) {
    const Row r0 = row_of(16 * mt + gr, bd, g.pitch, cw, wo, pool != 0);
    const Row r1 = row_of(16 * mt + gr + 8, bd, g.pitch, cw, wo, pool != 0);
    int acc[4][4] = {};
    int pa[2] = {0, 0};
    if (mt == warp / g.nslices) {
      mma_tile<true>(sa, r0.base, r1.base, sb, g.kstride, g.ksteps, cw,
                     g.pitch, vec, lane, acc, pa, pw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) kc[j][e] = k4 - 2 * pw[j][e];
      }
    } else {
      mma_tile<false>(sa, r0.base, r1.base, sb, g.kstride, g.ksteps, cw,
                      g.pitch, vec, lane, acc, pa, pw);
    }
    uint32_t w0, w1;
    fused_words(acc, quad_sum(pa[0]), quad_sum(pa[1]), kc, th, fl, t,
                pool != 0, w0, w1);
    if (t == 0) {
      if (pool) {
        if (gr < 4 && r0.out >= 0) {
          out_frame[static_cast<size_t>(r0.out) * fwords] = w0;
        }
      } else {
        if (r0.out >= 0) out_frame[static_cast<size_t>(r0.out) * fwords] = w0;
        if (r1.out >= 0) out_frame[static_cast<size_t>(r1.out) * fwords] = w1;
      }
    }
  }
}

}  // namespace

// a (B, H, W, CW), w (F, 4, CW) words; tau/flip (F,) int32, all 16-byte
// aligned; out (B, Ho, Wo, F/32) words.  F % 32 == 0 and 1 <= CW <= 8; the
// launch geometry (rows ... pitch, as Geometry; the feature tiles grid_y
// and the dynamic shared memory bytes smem) is the Python wrapper's
// conv_tiles.  Returns cudaGetLastError() after the launch.
extern "C" int conv_block_launch(const void* a, const void* w, const void* tau,
                                 const void* flip, void* out, int b, int h,
                                 int wd, int cw, int f, int k4, int pool,
                                 int rows, int bands, int cols, int chunks,
                                 int nslices, int ksteps, int kstride,
                                 int in_cols, int pitch, int grid_y, int smem,
                                 void* stream) {
  const Geometry g{rows, bands, cols, chunks, nslices, ksteps, kstride,
                   in_cols, pitch};
  auto* kernel = chunks > 1 ? conv_block_mma<true> : conv_block_mma<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(b * bands * chunks),
                  static_cast<unsigned>(grid_y));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const int32_t*>(tau), static_cast<const int32_t*>(flip),
      static_cast<uint32_t*>(out), h, wd, cw, f, k4, pool, g);
  return static_cast<int>(cudaGetLastError());
}
