// The binary implicit GEMM that both packed 2x2 conv kernels share
// (conv_block.cu, the fused layer; binary_conv2x2.cu, the unfused sums) and
// the whole-network member body (member_mma.cuh), on Hopper's tensor cores
// (sm_90a).
//
// Conventions (those of repro.core.binarize): +1 -> bit 0, -1 -> bit 1, 32
// channels a uint32 word, LSB first.  A map is (B, H, W, CW) words, row
// major; taps are (F, 4, CW) words, (dy, dx) row major.
//
// The conv as a product: rows are conv output positions of one frame band,
// columns are features, and K runs over a position's 2x2 window in the
// taps' own order, 4 taps x CW words, padded with zero words to whole
// 256-bit steps.  In the staged map a position's K words are two runs of
// 2 CW words, the window's top row from (y, x) and its bottom row one map
// row (W CW words) below, so the product reads the map in place: no im2col.
// mma.sync.m16n8k256 .b1 .and.popc takes the packed words as they are (32
// channels a register) and counts popc(a & w); the XNOR count follows from
// popc(a ^ w) = popc(a) + popc(w) - 2 popc(a & w), so
//   s = 4c - 2 popc(a ^ w) = (4c - 2 pw) - 2 pa + 4 and,
// pa a position's window popcount (summed from the A words each lane loads
// anyway), pw a feature's tap popcount (on a warp's first tile, by all-ones
// A rows against the same B fragments, which leaves pw in the accumulator
// lanes that need it).
// The identity holds for any bits, so words with bits set past c count as
// the plain version counts them, and zero padding adds to none of pa, pw
// and and.
//
// Fragments (PTX ISA, mma.m16n8k256 with .b1): lane 4g + t holds A rows g
// and g + 8 and B column g, 32 K bits a register, at bits 32t and 128 + 32t
// of the step; the accumulator holds rows g and g + 8 at columns 2t and
// 2t + 1.  The K order inside a step is free as long as A and B agree, so
// lane t takes the step's words 2t and 2t + 1 as its two registers: one
// 8-byte shared load a row when CW is even, and a pair never straddles the
// two runs (2 CW is even).
//
// A block: 8 warps, one band of output rows of one frame, the whole width
// or, where one staged row of the full width does not fit shared memory,
// a chunk of its columns (the band's input rows and columns staged by
// cp.async, pitch words a row), and a tile of nslices x 32 features
// (their taps, and the fused layer's tau and flip, staged with them; taps
// as rows of kstride words; kstride is 8 mod 16, so the 8-byte B loads of
// a half warp, 4 features x 4 lanes, fall in 32 distinct banks, and with
// CW even so do the A loads of 4 positions x 4 lanes at CW <= 8).  Warp w
// owns feature slice w % nslices (32 features, four n8 tiles) and every
// (8 / nslices)-th m16 tile of the band.  With pool, a tile's 16 rows are
// 4 whole pool windows: row r is corner (r >> 2) & 3 of window
// 4 (r >> 4) + (r & 3), so lane 4g + t holds corners g >> 2 and
// 2 + (g >> 2) of window g & 3, and lane ^ 16 the other two.
// The launch geometry (Geometry: rows and columns a band, slices a block,
// K steps, the staged strides, shared memory) is the Python wrapper's
// alone (kernels/binary_conv2x2_block.py, conv_tiles); the kernels only
// carve shared memory by it.
#pragma once

#include <cstdint>

namespace repro_torch {
namespace conv_mma {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStepWords = 8;           // 256 K bits a mma step
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !ok (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n"
               "cp.async.wait_group 0;\n" ::: "memory");
}

// c (16 x 8, s32) += popc(a (16 x 256 bits, row) & b (256 x 8 bits, col))
__device__ __forceinline__ void mma_and_popc(int (&c)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The wrapper's launch geometry (conv_tiles): output rows and columns a
// band (pooled with pool), bands a frame and column chunks a band row,
// 32-feature slices a block, 256-bit K steps, words a staged tap row, and
// input columns and words a staged map row (pitch is W CW for a whole
// row, else congruent to it mod 4, so every row keeps one alignment).
struct Geometry {
  int rows, bands, cols, chunks, nslices, ksteps, kstride, in_cols, pitch;
};

// One block's band: output rows [row0, row0 + rows) x columns [col0,
// col0 + cols) of one frame (pooled with pool), windows = rows x cols
// output positions; ho, wo are the output map's rows and columns.
struct Band {
  int frame, row0, col0, rows, cols, windows;
};

// kChunked: a launch whose bands are column chunks (g.chunks > 1); whole
// rows keep the plain band arithmetic.
template <bool kChunked>
__device__ __forceinline__ Band band_of(int block, const Geometry& g, int ho,
                                        int wo) {
  Band bd;
  const int per_frame = kChunked ? g.bands * g.chunks : g.bands;
  bd.frame = block / per_frame;
  const int rem = block - bd.frame * per_frame;
  const int band = kChunked ? rem / g.chunks : rem;
  bd.row0 = band * g.rows;
  bd.col0 = kChunked ? (rem - band * g.chunks) * g.cols : 0;
  bd.rows = min(g.rows, ho - bd.row0);
  bd.cols = kChunked ? min(g.cols, wo - bd.col0) : wo;
  bd.windows = bd.rows * bd.cols;
  return bd;
}

// Row r of the band's product: the staged word offset of its window's
// top-left word, and its output position within the frame's output map
// (-1 for a padding row, which computes on word 0 and stores nothing).
struct Row {
  int base, out;
};

__device__ __forceinline__ Row row_of(int r, const Band& bd, int pitch,
                                      int cw, int wo, bool pool) {
  const int win = pool ? (r >> 4) * 4 + (r & 3) : r;
  if (win >= bd.windows) return {0, -1};
  const int yo = win / bd.cols, xo = win - yo * bd.cols;
  int y = yo, x = xo;
  if (pool) {
    const int corner = (r >> 2) & 3;
    y = 2 * yo + (corner >> 1);
    x = 2 * xo + (corner & 1);
  }
  return {y * pitch + x * cw, (bd.row0 + yo) * wo + bd.col0 + xo};
}

// Stages the n words src[0, n) so that word j lands at dst + j + shift,
// shift = src's word offset mod 16 bytes: the aligned body moves in 16-byte
// cp.async, the ragged ends in 4-byte ones, by a block of kN threads.
template <int kN = kThreads>
__device__ __forceinline__ void stage_run(uint32_t* dst,
                                          const uint32_t* __restrict__ src,
                                          int n, int shift) {
  uint32_t* d = dst + shift;
  const int head = min((4 - shift) & 3, n);
  const int body_end = head + ((n - head) & ~3);
  for (int j = threadIdx.x; j < head; j += kN) cp_async4(d + j, src + j);
  for (int j = head + 4 * threadIdx.x; j < body_end; j += 4 * kN) {
    cp_async16(d + j, src + j, true);
  }
  for (int j = body_end + threadIdx.x; j < n; j += kN) {
    cp_async4(d + j, src + j);
  }
}

// Stages the band's input rows of frame a (B, H, W, CW): from its first
// row and column, rows of min(in_cols, W - first column) columns, pitch
// words apart, so that word j of row r lands at the returned address +
// r pitch + j, which agrees with its source mod 16 bytes (pitch = W CW mod
// 4).  Whole rows (pitch W CW) move as one run.  dst is 16-byte aligned
// with 3 words of slack.
template <bool kChunked>
__device__ __forceinline__ const uint32_t* stage_band(
    uint32_t* dst, const uint32_t* __restrict__ a, const Band& bd,
    const Geometry& g, int h, int wd, int cw, bool pool) {
  const int in_row0 = pool ? 2 * bd.row0 : bd.row0;
  const int in_col0 = pool ? 2 * bd.col0 : bd.col0;
  const int rows = pool ? 2 * bd.rows + 1 : bd.rows + 1;
  const uint32_t* src =
      a + (static_cast<size_t>(bd.frame * h + in_row0) * wd + in_col0) * cw;
  const int shift =
      static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  if (!kChunked) {
    stage_run(dst, src, rows * wd * cw, shift);
  } else {
    const int n = min(g.in_cols, wd - in_col0) * cw;
    for (int r = 0; r < rows; ++r) {
      stage_run(dst + r * g.pitch, src + static_cast<size_t>(r) * wd * cw, n,
                shift);
    }
  }
  return dst + shift;
}

// Stages the taps of features [n0, n0 + nblk) as rows of kstride words:
// the 4 CW tap words, then zeros up to the step-padded ksteps x 8 words
// (features at or past f are all zeros).  w is 16-byte aligned (the
// wrapper's check).
__device__ __forceinline__ void stage_taps(const uint32_t* __restrict__ w,
                                           int f, int n0, int nblk, int cw,
                                           const Geometry& g, uint32_t* sb) {
  const int quads = g.ksteps * kStepWords / 4;
  for (int i = threadIdx.x; i < nblk * quads; i += kThreads) {
    const int fl = i / quads, q = i - fl * quads;
    const bool ok = n0 + fl < f && q < cw;
    cp_async16(sb + fl * g.kstride + 4 * q,
               ok ? w + static_cast<size_t>(n0 + fl) * 4 * cw + 4 * q : w,
               ok);
  }
}

__device__ __forceinline__ uint2 load_pair(const uint32_t* p, bool vec) {
  return vec ? *reinterpret_cast<const uint2*>(p) : make_uint2(p[0], p[1]);
}

// One m16 x n32 tile: acc[j] (n8 tile j) += and-counts of rows (base0,
// base1) of the staged map sa against the slice's 32 staged features sb,
// over ksteps; pa[0], pa[1] += the popcounts of the A words this lane
// loads (its quad's four lanes together hold each row's whole window).
// run is the staged pitch, the offset of the window's bottom row; vec:
// 8-byte loads.
// With kTaps (a warp's first tile) pw[j] += the and-counts of all-ones A
// rows on the same B fragments: the taps' popcounts at this lane's
// accumulator columns, an independent chain beside acc's.
template <bool kTaps>
__device__ __forceinline__ void mma_tile(const uint32_t* sa, int base0,
                                         int base1, const uint32_t* sb,
                                         int kstride, int ksteps, int cw,
                                         int run, bool vec, int lane,
                                         int (&acc)[4][4], int (&pa)[2],
                                         int (&pw)[4][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int s = 0; s < ksteps; ++s) {
    const int kw = s * kStepWords + 2 * t;
    uint2 a0 = make_uint2(0u, 0u), a1 = make_uint2(0u, 0u);
    if (kw < 4 * cw) {
      const int seg = kw >= 2 * cw;
      const int off = kw + seg * (run - 2 * cw);
      a0 = load_pair(sa + base0 + off, vec);
      a1 = load_pair(sa + base1 + off, vec);
    }
    pa[0] += __popc(a0.x) + __popc(a0.y);
    pa[1] += __popc(a1.x) + __popc(a1.y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint2 b =
          *reinterpret_cast<const uint2*>(sb + (8 * j + g) * kstride + kw);
      mma_and_popc(acc[j], a0.x, a1.x, a0.y, a1.y, b.x, b.y);
      if (kTaps) mma_and_popc(pw[j], ~0u, ~0u, ~0u, ~0u, b.x, b.y);
    }
  }
}

// The sum over a lane quad (the four lanes that hold one row)
__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(kFullMask, v, 1);
  return v + __shfl_xor_sync(kFullMask, v, 2);
}

// The comparator of lane (g, t)'s 8 features of a 32-feature slice whose
// tau and flip are staged at tau, flip (8-byte aligned): th[j][e] is
// feature 8 j + 2 t + e's tau; returns their flip bits in word order.
__device__ __forceinline__ uint32_t load_comparator(const int32_t* tau,
                                                    const int32_t* flip,
                                                    int t, int (&th)[4][2]) {
  uint32_t fl = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int fi = 8 * j + 2 * t;
    const int2 tp = *reinterpret_cast<const int2*>(tau + fi);
    const int2 fp = *reinterpret_cast<const int2*>(flip + fi);
    th[j][0] = tp.x;
    th[j][1] = tp.y;
    fl |= (static_cast<uint32_t>(fp.x & 1) | static_cast<uint32_t>(fp.y & 1)
           << 1) << fi;
  }
  return fl;
}

// The fused epilogue of one m16 x n32 tile: s = kc - 2 pa + 4 and (pa0,
// pa1 the quad sums of rows g and g + 8), the comparator, bit 1 (-1) iff
// !((s >= tau) ^ flip), with pool the AND of a window's four corners (two
// rows of a lane, then lane ^ 16), and the 32 features of a row ORed into
// one word over the quad.  w0 is row g's word (with pool, window g & 3's
// in lanes g < 4), w1 row g + 8's, in every lane of the quad.
__device__ __forceinline__ void fused_words(const int (&acc)[4][4], int pa0,
                                            int pa1, const int (&kc)[4][2],
                                            const int (&th)[4][2],
                                            uint32_t fl, int t, bool pool,
                                            uint32_t& w0, uint32_t& w1) {
  w0 = 0;
  w1 = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int bit = 8 * j + 2 * t + e;
      w0 |= static_cast<uint32_t>(kc[j][e] - 2 * pa0 + 4 * acc[j][e] >=
                                  th[j][e]) << bit;
      w1 |= static_cast<uint32_t>(kc[j][e] - 2 * pa1 + 4 * acc[j][2 + e] >=
                                  th[j][e]) << bit;
    }
  }
  const uint32_t mine = 0x03030303u << (2 * t);  // this lane's 8 bits
  w0 = ~(w0 ^ fl) & mine;
  w1 = ~(w1 ^ fl) & mine;
  if (pool) {                   // corners g >> 2, 2 + (g >> 2); lane ^ 16
    w0 &= w1;
    w0 &= __shfl_xor_sync(kFullMask, w0, 16);
  }
  w0 |= __shfl_xor_sync(kFullMask, w0, 1);
  w0 |= __shfl_xor_sync(kFullMask, w0, 2);
  w1 |= __shfl_xor_sync(kFullMask, w1, 1);
  w1 |= __shfl_xor_sync(kFullMask, w1, 2);
}

// Shared memory of a block, in words, at the wrapper's geometry (conv_tiles
// sizes it to this order): the taps (nblk rows of kstride), the fused
// layer's tau and flip (nblk each), then the band (in_rows rows of pitch,
// 16-byte aligned as kstride % 4 == 0 and nblk % 32 == 0, with 3 words of
// slack).
struct Smem {
  uint32_t* taps;
  int32_t* tau;
  int32_t* flip;
  uint32_t* band;
};

__device__ __forceinline__ Smem carve(uint32_t* smem, int nblk,
                                      int kstride) {
  uint32_t* thr = smem + nblk * kstride;
  return {smem, reinterpret_cast<int32_t*>(thr),
          reinterpret_cast<int32_t*>(thr + nblk), thr + 2 * nblk};
}

}  // namespace conv_mma
}  // namespace repro_torch
