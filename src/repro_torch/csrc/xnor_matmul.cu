// Packed XNOR-popcount binary matmul for Hopper (sm_90a).
//
// Replaces: repro/kernels/xnor_matmul.py:_xnor_matmul_kernel (int32 sums
// K - 2*popcount(a ^ w)) and :_xnor_matmul_pack_kernel (the same sums,
// signed and packed 32 per word along N).  Both stay behind
// xnor_matmul_launch as one binary GEMM on the tensor cores
// (xnor_mma_kernel): the int32 variant stores the sums, the packed variant
// (kPack) their signs.  Rows are M (activations), columns N (neurons), and
// K runs over the Kw packed words,
// padded with zero words to whole 256-bit steps.  mma.sync.m16n8k256 .b1
// .and.popc counts popc(a & w); the XNOR count follows from
// popc(a ^ w) = pa + pw - 2 popc(a & w) (conv_mma.cuh), so
//   s = K - 2 (pa + pw - 2 and),
// pa a row's popcount and pw a column's, summed from the words each lane
// loads for its fragments.  The identity holds for any bits, so words with
// bits set past K count as the plain version counts them, and zero padding
// adds to none of the terms.  Fragments follow conv_mma.cuh: lane 4g + t
// holds A rows g and g + 8 and B column g, the step's words 2t and 2t + 1
// as its two registers (one 8-byte shared load each), and the accumulator
// rows g and g + 8 at columns 2t and 2t + 1.
//
// What bounds it on the H100: at BitLinear's SmolLM-360M shape (M=256,
// K=960, N=2560) the int32 output is 88% of the bytes and the MACs take a
// tenth of the bytes' time, so the stores set the bound (0.00088 ms); a
// CUDA-core xor+popc loop cannot go below 5x that.  Design: a block of 8
// warps computes a (16 wm) x (8 kTn wn) tile, each warp one m16 x (8 kTn)
// strip; the block's A and W rows are staged in shared memory by cp.async,
// kchunk steps at a time, double-buffered when K has more than one chunk,
// rows kstride words apart (8 mod 16: a half warp's 8-byte fragment loads
// fall in 32 distinct banks).  The epilogue stores int32 straight from the
// accumulator fragments, 8 bytes a lane (columns 2t, 2t + 1) where N is
// even, masked on ragged M and N.  The geometry (warps along M and N, n8
// tiles a warp, chunking, strides, the copy width, grid and shared memory)
// is the Python wrapper's alone (kernels/xnor_matmul.py, xnor_tiles).
//
// The packed variant's epilogue signs the same sums (bit 1 iff s < 0,
// bit 0 = column 0) and packs them 32 columns a word.  Its tiles (xnor_tiles
// with pack) give a warp a strip of whole words, kTn = 4 or 8 n8 tiles from
// a multiple of 32 columns, so n8 tiles 4w .. 4w + 3 make the strip's word
// w.  Lane 4g + t holds 8 of a word's 32 bits for rows g and g + 8: bits
// 8j + 2t and 8j + 2t + 1 of its tile j.  Two __shfl_xor_sync ORs across
// the quad complete the word, and lane t = 0 stores it (4 bytes where the
// int32 variant stores 128): rows past M store nothing, and N % 32 == 0
// (the wrapper checks it) leaves no partial word.  What bounds it: at
// mnist5's hidden layer (M=8, K=256, N=64) the launch, as for the int32
// variant at small M; at M=256, K=960, N=2560 the operand bytes, the
// output a 32nd of the int32 variant's.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv_mma.cuh"

namespace {

using repro_torch::conv_mma::cp_async16;
using repro_torch::conv_mma::kFullMask;
using repro_torch::conv_mma::kStepWords;
using repro_torch::conv_mma::mma_and_popc;
using repro_torch::conv_mma::quad_sum;
using repro_torch::conv_mma::smem_addr;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// The wrapper's launch geometry (xnor_tiles): warps along M and N (wm x wn
// = kWarps), 256-bit K steps a staged chunk (1, 2 or 4) and chunks, words a
// staged row, words a cp.async (4, 2 or 1: Kw and both operands' alignment
// allow it).
struct Tiles {
  int wm, wn, kchunk, nchunks, kstride, cpw;
};

// cp.async of cpw words global -> shared; zeros when !ok (src-size 0)
__device__ __forceinline__ void cp_async(void* dst, const void* src, int cpw,
                                         bool ok) {
  const unsigned d = smem_addr(dst);
  if (cpw == 4) {
    cp_async16(dst, src, ok);
  } else if (cpw == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 8 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
  }
}

// Stages words [word0, word0 + kchunk * 8) of the block's bm A rows (from
// m0) and bn W rows (from n0) as rows kstride words apart, A first; words
// at or past kw and rows at or past M (N) are zeros.
__device__ __forceinline__ void stage_chunk(
    uint32_t* buf, const uint32_t* __restrict__ a,
    const uint32_t* __restrict__ w, int m0, int n0, int bm, int bn, int m,
    int n, int kw, int word0, Tiles t) {
  // copies a row: a power of 2 (kchunk and cpw are)
  const int ushift = __ffs(t.kchunk * kStepWords / t.cpw) - 1;
  const int umask = (1 << ushift) - 1;
  for (int i = threadIdx.x; i < (bm + bn) << ushift; i += kThreads) {
    const int r = i >> ushift, u = i & umask;
    const int col = word0 + u * t.cpw;
    const bool is_a = r < bm;
    const int gr = is_a ? m0 + r : n0 + r - bm;
    const bool ok = gr < (is_a ? m : n) && col < kw;
    const uint32_t* src = is_a ? a : w;
    cp_async(buf + r * t.kstride + u * t.cpw,
             ok ? src + static_cast<size_t>(gr) * kw + col : src, t.cpw, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// out[r, c], out[r, c + 1] = s, masked on M and N
__device__ __forceinline__ void store_pair(int32_t* __restrict__ out, int m,
                                           int n, int r, int c, int2 s) {
  if (r >= m || c >= n) return;
  int32_t* p = out + static_cast<size_t>(r) * n + c;
  if ((n & 1) == 0) {                   // c even, c + 1 < n, 8-byte aligned
    *reinterpret_cast<int2*>(p) = s;
  } else {
    p[0] = s.x;
    if (c + 1 < n) p[1] = s.y;
  }
}

template <int kTn, bool kPack>
__global__ void __launch_bounds__(kThreads)
xnor_mma_kernel(const uint32_t* __restrict__ a,
                const uint32_t* __restrict__ w, int32_t* __restrict__ out,
                int m, int n, int kw, int k, Tiles t) {
  static_assert(!kPack || kTn % 4 == 0, "a packed strip holds whole words");
  extern __shared__ __align__(16) uint32_t smem[];
  const int bm = 16 * t.wm, bn = 8 * kTn * t.wn;
  const int m0 = blockIdx.y * bm, n0 = blockIdx.x * bn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wrow = (warp % t.wm) * 16, wcol = (warp / t.wm) * 8 * kTn;
  const int buf_words = (bm + bn) * t.kstride;
  const int chunk_words = t.kchunk * kStepWords;

  int acc[kTn][4] = {};
  int pa0 = 0, pa1 = 0;
  int pw[kTn] = {};
  stage_chunk(smem, a, w, m0, n0, bm, bn, m, n, kw, 0, t);
  for (int c = 0; c < t.nchunks; ++c) {
    if (c + 1 < t.nchunks) {           // the next chunk into the other buffer
      stage_chunk(smem + ((c + 1) & 1) * buf_words, a, w, m0, n0, bm, bn, m,
                  n, kw, (c + 1) * chunk_words, t);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const uint32_t* sa = smem + (c & 1) * buf_words;
    const uint32_t* sb = sa + bm * t.kstride;
    const uint32_t* ra0 = sa + (wrow + g) * t.kstride + 2 * tq;
    const uint32_t* ra1 = ra0 + 8 * t.kstride;
    const uint32_t* rb = sb + (wcol + g) * t.kstride + 2 * tq;
    for (int s = 0; s < t.kchunk; ++s) {
      const int kw0 = s * kStepWords;
      const uint2 a0 = *reinterpret_cast<const uint2*>(ra0 + kw0);
      const uint2 a1 = *reinterpret_cast<const uint2*>(ra1 + kw0);
      pa0 += __popc(a0.x) + __popc(a0.y);
      pa1 += __popc(a1.x) + __popc(a1.y);
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            rb + 8 * j * t.kstride + kw0);
        pw[j] += __popc(b.x) + __popc(b.y);
        mma_and_popc(acc[j], a0.x, a1.x, a0.y, a1.y, b.x, b.y);
      }
    }
    __syncthreads();                    // before this buffer is restaged
  }

  // pa of rows g, g + 8 over the quad; pw of column g over the quad, then
  // columns 2t and 2t + 1 from the quads g' = 2t and 2t + 1
  pa0 = quad_sum(pa0);
  pa1 = quad_sum(pa1);
  const int r0 = m0 + wrow + g;
  constexpr int kWords = kPack ? kTn / 4 : 1;    // words a row a strip
  uint32_t bits[kWords][2] = {};                 // rows g, g + 8
#pragma unroll
  for (int j = 0; j < kTn; ++j) {
    const int pwq = quad_sum(pw[j]);
    const int pw0 = __shfl_sync(kFullMask, pwq, 8 * tq);
    const int pw1 = __shfl_sync(kFullMask, pwq, 8 * tq + 4);
    const int2 s0 = make_int2(k - 2 * (pa0 + pw0 - 2 * acc[j][0]),
                              k - 2 * (pa0 + pw1 - 2 * acc[j][1]));
    const int2 s1 = make_int2(k - 2 * (pa1 + pw0 - 2 * acc[j][2]),
                              k - 2 * (pa1 + pw1 - 2 * acc[j][3]));
    if (kPack) {                   // columns 8j + 2t, + 1 of word j / 4
      const int bit = 8 * (j % 4) + 2 * tq;
      bits[j / 4][0] |= (static_cast<uint32_t>(s0.x < 0) << bit)
                        | (static_cast<uint32_t>(s0.y < 0) << (bit + 1));
      bits[j / 4][1] |= (static_cast<uint32_t>(s1.x < 0) << bit)
                        | (static_cast<uint32_t>(s1.y < 0) << (bit + 1));
    } else {
      const int col = n0 + wcol + 8 * j + 2 * tq;
      store_pair(out, m, n, r0, col, s0);
      store_pair(out, m, n, r0 + 8, col, s1);
    }
  }
  if (kPack) {                     // the quad's 4 x 8 bits make each word
    auto* words = reinterpret_cast<uint32_t*>(out);
#pragma unroll
    for (int wd = 0; wd < kWords; ++wd)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t b = bits[wd][i];
        b |= __shfl_xor_sync(kFullMask, b, 1);
        b |= __shfl_xor_sync(kFullMask, b, 2);
        const int r = r0 + 8 * i;
        const int col = n0 + wcol + 32 * wd;
        if (tq == 0 && r < m && col < n)
          words[static_cast<size_t>(r) * (n / 32) + col / 32] = b;
      }
  }
}

template <int kTn, bool kPack>
void launch_mma(const uint32_t* a, const uint32_t* w, int32_t* out, int m,
                int n, int kw, int k, const Tiles& t, dim3 grid, int smem,
                cudaStream_t s) {
  xnor_mma_kernel<kTn, kPack><<<grid, kThreads, smem, s>>>(a, w, out, m, n,
                                                           kw, k, t);
}

}  // namespace

// a (M, Kw), w (N, Kw) words.  Out: (M, N) int32 sums (pack_out = 0), or
// (M, N/32) sign words (pack_out = 1; N % 32 == 0, checked by the Python
// wrapper), on the tensor cores at the wrapper's geometry (xnor_tiles: tn
// n8 tiles a warp, wm x wn warps, kchunk steps a chunk, nchunks, kstride,
// cpw, the grid (N tiles, M tiles) and smem bytes; tn one of 1, 2, 4, 5, 8,
// and 4 or 8 with pack_out).  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a tn without a kernel.
extern "C" int xnor_matmul_launch(const void* a, const void* w, void* out,
                                  int m, int n, int kw, int k, int pack_out,
                                  int tn, int wm, int wn, int kchunk,
                                  int nchunks, int kstride, int cpw,
                                  int grid_n, int grid_m, int smem,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const uint32_t*>(a);
  const auto* wp = static_cast<const uint32_t*>(w);
  const Tiles t{wm, wn, kchunk, nchunks, kstride, cpw};
  const dim3 grid(grid_n, grid_m);
  auto* o = static_cast<int32_t*>(out);
  if (pack_out) {
    switch (tn) {
      case 4: launch_mma<4, true>(ap, wp, o, m, n, kw, k, t, grid, smem, s);
        break;
      case 8: launch_mma<8, true>(ap, wp, o, m, n, kw, k, t, grid, smem, s);
        break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  switch (tn) {
    case 1: launch_mma<1, false>(ap, wp, o, m, n, kw, k, t, grid, smem, s);
      break;
    case 2: launch_mma<2, false>(ap, wp, o, m, n, kw, k, t, grid, smem, s);
      break;
    case 4: launch_mma<4, false>(ap, wp, o, m, n, kw, k, t, grid, smem, s);
      break;
    case 5: launch_mma<5, false>(ap, wp, o, m, n, kw, k, t, grid, smem, s);
      break;
    case 8: launch_mma<8, false>(ap, wp, o, m, n, kw, k, t, grid, smem, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
