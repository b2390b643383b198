// The whole-network member body on Hopper's tensor cores (sm_90a), one
// thread-block cluster a frame: the body of the composite megakernel
// (megakernel.cu), of both stages of the fused cascade (cascade.cu) and of
// the delta gate's recompute (delta.cu).
//
// A member is one program of a (composite) weight image, as megakernel.cuh
// describes it: conv layer l reads rows [f_off, f_off + F) of cw (Lc,
// F_total, 4, Cw_max) and the first C/32 words of each tap; FC layer i rows
// [n_off, n_off + N) of fw (Lf, N_total, Kw_max).
//
// Design: the launch's clusters are `cluster` blocks of kWarps warps; one
// cluster runs one frame of one member.  Every block (rank) holds its own
// copy of the current packed map in shared memory, ping-ponged between two
// buffers at the map's global layout (H, W, Cw words), of which it keeps
// valid the rows its next layer reads.
//  * Conv layer l of Ho output rows: rank r computes output rows
//    [Ho r / cluster, Ho (r + 1) / cluster) (band_start), all columns and
//    all F features, as conv_block.cu computes a band: conv_mma.cuh's
//    binary implicit GEMM (mma.sync m16n8k256 .b1 .and.popc, the XNOR
//    count from the AND count) on the map in place (pitch W Cw words, no
//    im2col), warp w on feature slice w % (F/32) and every
//    (kWarps / (F/32))-th m16 tile of the band, the slice's B fragments in
//    registers, the fused comparator / pool / pack epilogue on the
//    fragments, the words stored to its own next buffer.
//  * The epilogue also stores each word of a row that another rank's next
//    layer reads to that rank's map (st.shared::cluster): one or two halo
//    rows a layer, as a 2x2 conv reads one input row below its output row
//    (two below and one more with pool), so the exchange is a few rows,
//    not the map.  A cluster barrier ends the layer.
//  * A rank stages the whole layer's taps, tau and flip (32 KB of taps at
//    S=1) by cp.async, the next layer's while the current one runs.
//  * The thermometer pack: a rank packs the input rows its first layer
//    reads, a warp walking positions at one channel word, so each lane's
//    channel, plane and threshold stay in registers and a word is a shared
//    load of a staged pixel, a compare and a ballot.  The delta gate packs
//    through the same pack_positions, so its words are the network's input
//    words.  The delta recompute instead loads the gate's words of those
//    rows.
//  * The FC tail: rank r takes the 32-output chunks r, r + cluster, ...
//    (one warp a chunk) on the whole final map, which the last layer's
//    epilogues stored to the tail's ranks; hidden layers sign and pack with
//    a ballot (bits past N stay 0) and store the word to every rank
//    (st.shared::cluster), the final layer writes int32 logits.  A
//    cluster barrier follows every remote store, so no block exits while
//    another may still write its shared memory.
//  * What bounds it (the clock64 split, launch/time_members.py --clocks;
//    PERF.md section 6): instruction issue in each layer's tiles, about
//    300 instructions a 16 x 32 tile (the MMAs, the epilogue's compares
//    and shuffles, the stores) over 16 warps, then the cluster barrier
//    that ends the layer and the next layer's tap copies.
// The launch geometry (cluster size, buffer sizes, tap strides, K steps a
// layer) is the Python wrapper's (kernels/megakernel.py
// cluster_geometry); the kernels carve shared memory by it.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "conv_mma.cuh"
#include "megakernel.cuh"

namespace repro_torch {
namespace member_mma {

constexpr int kWarps = 16;       // two warps a feature slice at S=1
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCluster = 8;   // a portable cluster: 256 features / 32

// The wrapper's launch geometry (cluster_geometry): blocks a cluster, words
// of each map buffer (a multiple of 4), words a staged tap row (8 mod 16),
// feature rows of each tap buffer (the widest layer's F), words of the
// pixel staging buffer, the dynamic shared memory bytes, and each member's
// K steps a conv layer.
struct Geometry {
  int cluster, map_words, kstride, fmax, pix_words, smem_bytes;
  int ksteps[kMaxMembers][kMaxLayers];
};

// Reads the int array (cluster, map_words, kstride, fmax, pix_words,
// smem_bytes, then every member's conv layers' K steps in order) and checks
// it against the launch table; false on a geometry the kernels cannot take.
inline bool parse_geometry(const int* g, int n, const LaunchTable& t,
                           Geometry* out) {
  int i = 0;
  auto next = [&]() { return i < n ? g[i++] : -1; };
  out->cluster = next();
  out->map_words = next();
  out->kstride = next();
  out->fmax = next();
  out->pix_words = next();
  out->smem_bytes = next();
  if (out->cluster < 1 || out->cluster > kMaxCluster ||
      out->map_words < 0 || out->map_words % 4 || out->kstride % 16 != 8 ||
      out->fmax < 32 || out->fmax % 32 || out->pix_words < 4 ||
      out->pix_words % 4 ||
      out->smem_bytes != 4 * (2 * out->map_words +
                              2 * out->fmax * (out->kstride + 2) +
                              out->pix_words)) {
    return false;
  }
  for (int m = 0; m < t.n_members; ++m) {
    const MemberSpec& s = t.member[m];
    if (s.cwio < 1 || s.cwio > kMaxCw || s.h * s.w * s.cwio > out->map_words) {
      return false;
    }
    for (int l = 0; l < s.n_conv; ++l) {
      const int ks = next();
      const int fwo = s.conv_f[l] / 32;
      if (ks < (s.conv_c[l] / 8 + 7) / 8 || 8 * ks > out->kstride ||
          s.conv_f[l] % 32 || fwo < 1 || kWarps % fwo ||
          s.conv_f[l] > out->fmax || s.conv_c[l] % 32 ||
          s.conv_c[l] / 32 > kMaxCw) {
        return false;
      }
      out->ksteps[m][l] = ks;
    }
  }
  return i == n;
}

// Shared memory at the geometry, in words: the two map buffers, two tap
// buffers of fmax rows of kstride, two (tau, flip) pairs of fmax, and the
// pixel staging buffer (after the pack, each layer's row readers), each
// 16-byte aligned.
struct Smem {
  uint32_t* map[2];
  uint32_t* taps[2];
  int32_t* tau[2];
  int32_t* flip[2];
  uint32_t* pix;
};

__device__ __forceinline__ Smem carve(uint32_t* smem, const Geometry& g) {
  Smem s;
  s.map[0] = smem;
  s.map[1] = smem + g.map_words;
  s.taps[0] = smem + 2 * g.map_words;
  s.taps[1] = s.taps[0] + g.fmax * g.kstride;
  int32_t* thr = reinterpret_cast<int32_t*>(s.taps[1] + g.fmax * g.kstride);
  s.tau[0] = thr;
  s.flip[0] = thr + g.fmax;
  s.tau[1] = thr + 2 * g.fmax;
  s.flip[1] = thr + 3 * g.fmax;
  s.pix = reinterpret_cast<uint32_t*>(thr + 4 * g.fmax);
  return s;
}

// Division by a divisor d >= 1 fixed for a loop: magic = ceil(2^32 / d),
// exact for dividends below 2^32 / d (every index here is below 2^16), a
// multiply-high where the runtime divide is some twenty instructions.
struct FastDiv {
  int d;
  unsigned magic;
  __device__ __forceinline__ int operator()(int n) const {
    return d == 1 ? n
                  : static_cast<int>(__umulhi(static_cast<unsigned>(n),
                                              magic));
  }
};

__device__ __forceinline__ FastDiv fast_div(int d) {
  return {d, d > 1 ? 0xffffffffu / static_cast<unsigned>(d) + 1u : 0u};
}

// Rank r's first output row of a layer of ho rows split over n ranks; its
// band is [band_start(ho, r, n), band_start(ho, r + 1, n)), maybe empty.
__device__ __forceinline__ int band_start(int ho, int r, const FastDiv& n) {
  return n(ho * r);
}

// ---------------------------------------------------------------------------
// The cluster
// ---------------------------------------------------------------------------

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every block of the cluster arrives; the release/acquire
// pair makes each block's shared-memory stores, local and remote, visible
// to the whole cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Stores v at rank's copy of the shared-memory word p (an address in this
// block's shared memory).
__device__ __forceinline__ void store_rank(const uint32_t* p, int rank,
                                           uint32_t v) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(conv_mma::smem_addr(p)), "r"(rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;"
               :: "r"(remote), "r"(v) : "memory");
}

// ---------------------------------------------------------------------------
// The thermometer pack
// ---------------------------------------------------------------------------

// Stages the n words src[0, n) by cp.async so that word j lands at dst +
// j + the returned shift, which agrees with src mod 16 bytes (dst is
// 16-byte aligned with 3 words of slack).
__device__ __forceinline__ int stage_words(uint32_t* dst,
                                           const uint32_t* __restrict__ src,
                                           int n) {
  const int shift =
      static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  conv_mma::stage_run<kThreads>(dst, src, n, shift);
  return shift;
}

// Stages the pixels of positions [pos0, pos1) of a frame (H, W, Cin int32)
// by cp.async; returns where pixel (pos0, 0) lands.
__device__ __forceinline__ const int32_t* stage_pixels(
    uint32_t* dst, const int32_t* __restrict__ frame, int cin, int pos0,
    int pos1) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(frame) +
                        static_cast<size_t>(pos0) * cin;
  return reinterpret_cast<const int32_t*>(
      dst + stage_words(dst, src, (pos1 - pos0) * cin));
}

// The thermometer words of positions [pos0, pos1) from their staged pixels
// pix: warp w (of the warps that are a multiple of cwio) takes channel word
// w % cwio and walks the positions w / cwio, w / cwio + warps / cwio, ...
// Lane j computes channel 32 * word + j as (float)pixel < thr[plane]
// against the host's float32 threshold table (channels past cin * per are
// the constant +1 bias, bit 0); the ballot is the word.  emit(pos, word
// index, word) runs in every lane of the warp.
template <typename Emit>
__device__ __forceinline__ void pack_positions(const MemberSpec& s,
                                               const int32_t* pix,
                                               const float* __restrict__ thr,
                                               int pos0, int pos1,
                                               Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the spec's fields as values: a kernel's __grid_constant__ parameter is
  // reread through its generic address after every store otherwise
  const int cin = s.cin, cwio = s.cwio, per = s.per;
  const int active = kWarps - kWarps % cwio;
  if (warp >= active) return;
  const int cwi = warp % cwio;
  const int ch = cwi * 32 + lane;
  const bool valid = ch < cin * per;
  // a bias lane reads pixel 0 against -inf: bit 0 without a branch
  const float minus_inf = __int_as_float(static_cast<int>(0xff800000u));
  const int c = valid ? ch / per : 0;
  const float t = valid ? thr[ch - c * per] : minus_inf;
  const int step = active / cwio;
  constexpr int kBatch = 4;      // loads in flight before their ballots
  int pos = pos0 + warp / cwio;
  for (; pos + (kBatch - 1) * step < pos1; pos += kBatch * step) {
    int v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      v[j] = pix[(pos + j * step - pos0) * cin + c];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      emit(pos + j * step, cwi,
           __ballot_sync(kFullMask, static_cast<float>(v[j]) < t));
    }
  }
  for (; pos < pos1; pos += step) {
    emit(pos, cwi,
         __ballot_sync(kFullMask,
                       static_cast<float>(pix[(pos - pos0) * cin + c]) < t));
  }
}

// ---------------------------------------------------------------------------
// The conv chain and the FC tail
// ---------------------------------------------------------------------------

// Stages conv layer l's taps (F rows of kstride words: the 4 Cw tap
// words, then zeros up to ksteps x 8) and its tau and flip by cp.async (the
// caller commits and waits).  The image is 16-byte aligned and F and its
// row offsets are multiples of 32, so a member at the image's full width
// stages whole 16-byte runs; a narrower one gathers words.
__device__ __forceinline__ void stage_layer(const MemberSpec& s,
                                            const ImageRef& img, int l,
                                            int ksteps, int kstride,
                                            uint32_t* taps, int32_t* tau,
                                            int32_t* flip) {
  using conv_mma::cp_async16;
  using conv_mma::cp_async4;
  const int cw = s.conv_c[l] / 32, f = s.conv_f[l];
  const int kw = 4 * cw, kpad = ksteps * conv_mma::kStepWords;
  const size_t row0 = static_cast<size_t>(l) * img.ftot + s.conv_foff[l];
  const int cwmax = img.cwmax;
  const uint32_t* src = img.cw + row0 * 4 * cwmax;
  const int32_t* ct = img.ct + row0;
  const int32_t* cf = img.cf + row0;
  const FastDiv by_cw = fast_div(cw);
  if (cw == cwmax) {
    for (int i = threadIdx.x; i < f * cw; i += kThreads) {
      const int fl = by_cw(i), q = i - fl * cw;
      cp_async16(taps + fl * kstride + 4 * q, src + fl * kw + 4 * q, true);
    }
  } else {
    const FastDiv by_kw = fast_div(kw);
    for (int i = threadIdx.x; i < f * kw; i += kThreads) {
      const int fl = by_kw(i), k = i - fl * kw;
      const int tap = by_cw(k);
      cp_async4(taps + fl * kstride + k,
                src + (static_cast<size_t>(fl) * 4 + tap) * cwmax +
                    (k - tap * cw));
    }
  }
  if (kpad > kw) {
    const FastDiv by_pad = fast_div(kpad - kw);
    for (int i = threadIdx.x; i < f * (kpad - kw); i += kThreads) {
      const int fl = by_pad(i);
      taps[fl * kstride + kw + (i - fl * (kpad - kw))] = 0u;
    }
  }
  for (int i = threadIdx.x; i < f / 2; i += kThreads) {
    const bool t = i < f / 4;
    const int q = 4 * (t ? i : i - f / 4);
    cp_async16((t ? tau : flip) + q, (t ? ct : cf) + q, true);
  }
}

// The input rows [first, last) that output rows [o0, o1) of a layer read
// (none for an empty band).
struct Rows {
  int first, last;
};

__device__ __forceinline__ Rows rows_read(Rows band, bool pool) {
  if (band.first >= band.last) return {0, 0};
  return pool ? Rows{2 * band.first, 2 * band.last + 1}
              : Rows{band.first, band.last + 1};
}

// The output rows of conv layer l, and rank r's band of them (of n ranks).
__device__ __forceinline__ int out_rows(const MemberSpec& s, int l) {
  return s.conv_pool[l] ? (s.conv_h[l] - 1) / 2 : s.conv_h[l] - 1;
}

__device__ __forceinline__ Rows layer_band(const MemberSpec& s, int l, int r,
                                           const FastDiv& n) {
  const int ho = out_rows(s, l);
  return {band_start(ho, r, n), band_start(ho, r + 1, n)};
}

// The input rows rank r reads at conv layer l.
__device__ __forceinline__ Rows layer_reads(const MemberSpec& s, int l, int r,
                                            const FastDiv& n) {
  return rows_read(layer_band(s, l, r, n), s.conv_pool[l] != 0);
}

// Product row r of a band of `windows` output positions, wo a row,
// starting at output row row0 (pooled with pool; r's window and corner as
// conv_mma.cuh row_of): the offset of its window's first word from the
// band's first input row, its output position and output row; out is -1
// for a padding row, which computes on word 0 and stores nothing.
struct BandRow {
  int base, out, y;
};

__device__ __forceinline__ BandRow band_row(int r, int row0, int windows,
                                            const FastDiv& by_wo, int pitch,
                                            int cw, bool pool) {
  const int win = pool ? (r >> 4) * 4 + (r & 3) : r;
  if (win >= windows) return {0, -1, 0};
  const int wo = by_wo.d;
  const int yo = by_wo(win);
  const int xo = win - yo * wo;
  int y = yo, x = xo;
  if (pool) {
    const int corner = (r >> 2) & 3;
    y = 2 * yo + (corner >> 1);
    x = 2 * xo + (corner & 1);
  }
  return {y * pitch + x * cw, (row0 + yo) * wo + xo, row0 + yo};
}

// The m16 tiles mt = first, first + step, ... (< tiles) of one feature
// slice over a band: the slice's B fragments (KSTEPS K steps, 4 n8 tiles)
// stay in registers, the taps' popcounts pw come from all-ones A rows and
// each window's popcount pa from an all-ones B column, both on the tensor
// cores; the fused epilogue's word goes to this rank's nxt and to each
// reader of its row.  kVec: Cw even, so a lane's two A words are one
// 8-byte load and K needs no padding.
template <int KSTEPS, bool kVec>
__device__ __forceinline__ void band_tiles(
    const uint32_t* sa, const uint32_t* sb, int kstride, int c, int pitch,
    int wo, int row0, int windows, bool pool, int first, int step,
    int fwo, int slice, const int32_t* tau, const int32_t* flip,
    uint32_t* nxt, const uint32_t* readers) {
  using namespace conv_mma;
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int cw = c / 32;
  const int tiles = ((pool ? 4 * windows : windows) + 15) / 16;
  uint2 b[KSTEPS][4];
  int off[KSTEPS];
  bool ok[KSTEPS];
  int pw[4][4] = {};
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    const int kw = s * kStepWords + 2 * t;
    ok[s] = kVec || kw < 4 * cw;
    off[s] = kw + (kw >= 2 * cw ? pitch - 2 * cw : 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[s][j] = *reinterpret_cast<const uint2*>(sb + (8 * j + gr) * kstride +
                                                kw);
      mma_and_popc(pw[j], ~0u, ~0u, ~0u, ~0u, b[s][j].x, b[s][j].y);
    }
  }
  int kc[4][2];               // 4c - 2 pw
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) kc[j][e] = 4 * c - 2 * pw[j][e];
  }
  int th[4][2];
  const uint32_t fl =
      load_comparator(tau + 32 * slice, flip + 32 * slice, t, th);
  const FastDiv by_wo = fast_div(wo);
  for (int mt = first; mt < tiles; mt += step) {
    const BandRow r0 =
        band_row(16 * mt + gr, row0, windows, by_wo, pitch, cw, pool);
    const BandRow r1 =
        band_row(16 * mt + gr + 8, row0, windows, by_wo, pitch, cw, pool);
    int acc[4][4] = {};
    int pa[4] = {};
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      uint2 a0 = make_uint2(0u, 0u), a1 = make_uint2(0u, 0u);
      if (ok[s]) {
        a0 = load_pair(sa + r0.base + off[s], kVec);
        a1 = load_pair(sa + r1.base + off[s], kVec);
      }
      mma_and_popc(pa, a0.x, a1.x, a0.y, a1.y, ~0u, ~0u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_and_popc(acc[j], a0.x, a1.x, a0.y, a1.y, b[s][j].x, b[s][j].y);
      }
    }
    uint32_t w0, w1;
    fused_words(acc, pa[0], pa[2], kc, th, fl, t, pool, w0, w1);
    if (t == 0) {
      auto put = [&](const BandRow& r, uint32_t w) {
        uint32_t* p = nxt + r.out * fwo + slice;
        *p = w;
        for (uint32_t q = readers[r.y]; q; q &= q - 1) {
          store_rank(p, __ffs(q) - 1, w);
        }
      };
      if (pool) {
        if (gr < 4 && r0.out >= 0) put(r0, w0);
      } else {
        if (r0.out >= 0) put(r0, w0);
        if (r1.out >= 0) put(r1, w1);
      }
    }
  }
}

// Conv layer l of this rank: its band of output rows, every column and
// feature, read from cur in place, written to its own nxt and, row by
// row, to the ranks whose bits readers[row] sets.
__device__ __forceinline__ void conv_band(const MemberSpec& s, int l,
                                          int ksteps, const Geometry& g,
                                          int rank, const uint32_t* taps,
                                          const int32_t* tau,
                                          const int32_t* flip,
                                          const uint32_t* cur, uint32_t* nxt,
                                          const uint32_t* readers,
                                          const FastDiv& by_cluster) {
  const int warp = threadIdx.x >> 5;
  const int wd = s.conv_w[l], c = s.conv_c[l], fwo = s.conv_f[l] / 32;
  const bool pool = s.conv_pool[l] != 0;
  const int cw = c / 32, pitch = wd * cw;
  const int wo = pool ? (wd - 1) / 2 : wd - 1;
  const Rows band = layer_band(s, l, rank, by_cluster);
  const int windows = (band.last - band.first) * wo;
  if (windows <= 0) return;
  const uint32_t* sa = cur + rows_read(band, pool).first * pitch;
  const int slice = warp % fwo;
  const uint32_t* sb = taps + 32 * slice * g.kstride;
#define REPRO_BAND_TILES(K, V)                                             \
  band_tiles<K, V>(sa, sb, g.kstride, c, pitch, wo, band.first, windows,   \
                   pool, warp / fwo, kWarps / fwo, fwo, slice, tau, flip, \
                   nxt, readers)
  if (cw & 1) {                  // Cw 1, 3, 5, 7: 1-4 K steps, padded
    switch (ksteps) {
      case 1: REPRO_BAND_TILES(1, false); break;
      case 2: REPRO_BAND_TILES(2, false); break;
      case 3: REPRO_BAND_TILES(3, false); break;
      default: REPRO_BAND_TILES(4, false);
    }
  } else {                       // Cw 2, 4, 6, 8: 1-4 whole K steps
    switch (ksteps) {
      case 1: REPRO_BAND_TILES(1, true); break;
      case 2: REPRO_BAND_TILES(2, true); break;
      case 3: REPRO_BAND_TILES(3, true); break;
      default: REPRO_BAND_TILES(4, true);
    }
  }
#undef REPRO_BAND_TILES
}

// FC layer fi on the flattened map in cur: this rank's 32-output chunks,
// one warp a chunk.  Hidden layers store their packed words to nxt of
// every rank, the final layer writes int32 logits to out.
__device__ __forceinline__ void fc_words(const MemberSpec& s,
                                         const ImageRef& img, int fi,
                                         const Geometry& g, int rank,
                                         const uint32_t* cur, uint32_t* nxt,
                                         int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = s.fc_k[fi], n = s.fc_n[fi];
  const int kw = (k + 31) / 32;
  const bool final_layer = fi == s.n_fc - 1;
  const int cluster = g.cluster, kwmax = img.kwmax;
  const uint32_t* rows =
      img.fw + (static_cast<size_t>(fi) * img.ntot + s.fc_noff[fi]) * kwmax;
  for (int chunk = rank + cluster * warp; chunk < (n + 31) / 32;
       chunk += cluster * kWarps) {
    const int nn = chunk * 32 + lane;
    int sum = 0;
    if (nn < n) {
      const uint32_t* row = rows + static_cast<size_t>(nn) * kwmax;
      int acc = 0;
      for (int i = 0; i < kw; ++i) acc += __popc(cur[i] ^ row[i]);
      sum = k - 2 * acc;
    }
    if (final_layer) {
      if (nn < n) out[nn] = sum;
    } else {
      const uint32_t word = __ballot_sync(kFullMask, nn < n && sum < 0);
      if (lane < cluster) store_rank(nxt + chunk, lane, word);
    }
  }
}

// run_frame's phase hook: nothing (member_clocks.cu stamps the time).
struct NoStamp {
  __device__ __forceinline__ void operator()() const {}
};

// One frame of member m -> its int32 logits in out[0 .. classes).  Every
// thread of every block of the cluster calls it.  kWords: the input is the
// frame's packed words (H, W, cwio; 16-byte aligned), else its (H, W, Cin)
// int32 pixels with the member's thresholds thr.  stamp() runs in every
// thread after each phase: the staging, the pack, then for each conv layer
// the issue of the next layer's taps, its tiles, the wait for those taps
// and the cluster barrier, and last the FC tail.
template <bool kWords, typename Stamp = NoStamp>
__device__ __forceinline__ void run_frame(
    const MemberSpec& s, const ImageRef& img, const Geometry& g, int m,
    const int32_t* __restrict__ frame, const float* __restrict__ thr,
    const uint32_t* __restrict__ words, int32_t* __restrict__ out,
    uint32_t* smem, Stamp stamp = Stamp()) {
  const int rank = cluster_rank();
  const int lane = threadIdx.x & 31;
  const Smem sm = carve(smem, g);
  // the buffers as swapped pointers: indexing sm's arrays by the layer's
  // parity would put them on the stack and lose their address space
  uint32_t* cur = sm.map[0];
  uint32_t* nxt = sm.map[1];
  uint32_t* taps = sm.taps[0];
  uint32_t* taps_next = sm.taps[1];
  int32_t* tau = sm.tau[0];
  int32_t* tau_next = sm.tau[1];
  int32_t* flip = sm.flip[0];
  int32_t* flip_next = sm.flip[1];
  const int row_words = s.w * s.cwio;
  const FastDiv by_cluster = fast_div(g.cluster);
  // the input rows this rank reads: its first layer's, or all for the FC
  const Rows in =
      s.n_conv > 0 ? layer_reads(s, 0, rank, by_cluster) : Rows{0, s.h};

  // 1. the input rows, the packed words or the pixels, then layer 0's
  //    taps, in two cp.async groups: the pack waits for the first only
  const int32_t* pix = nullptr;
  if (kWords) {
    const uint32_t* src = words + in.first * row_words;
    uint32_t* dst = cur + in.first * row_words;
    const int n = (in.last - in.first) * row_words;
    if (row_words % 4 == 0) {
      for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads) {
        conv_mma::cp_async16(dst + i, src + i, true);
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        conv_mma::cp_async4(dst + i, src + i);
      }
    }
  } else {
    pix = stage_pixels(sm.pix, frame, s.cin, in.first * s.w,
                       in.last * s.w);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (s.n_conv > 0) {
    stage_layer(s, img, 0, g.ksteps[m][0], g.kstride, taps, tau, flip);
  }
  asm volatile("cp.async.commit_group;\n"
               "cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  stamp();
  if (!kWords) {
    const int cwio = s.cwio;
    pack_positions(s, pix, thr, in.first * s.w, in.last * s.w,
                   [&](int pos, int cwi, uint32_t word) {
                     if (lane == 0) cur[pos * cwio + cwi] = word;
                   });
  }
  conv_mma::cp_async_wait_all();         // layer 0's taps
  // every block of the cluster runs before the first remote store
  cluster_sync();
  stamp();

  // 2. the conv chain, the next layer's taps staged while one runs
  for (int l = 0; l < s.n_conv; ++l) {
    const bool last = l + 1 == s.n_conv;
    if (!last) {
      stage_layer(s, img, l + 1, g.ksteps[m][l + 1], g.kstride, taps_next,
                  tau_next, flip_next);
    }
    stamp();
    // readers[y]: the other ranks that read output row y of this rank's
    // band next (their next layer's rows, or after the last layer the
    // whole map at the FC tail's ranks), one bit each, in the pixel buffer
    // the pack is done with
    const int ho = out_rows(s, l);
    const Rows band = layer_band(s, l, rank, by_cluster);
    uint32_t* readers = sm.pix;
    for (int y = band.first + static_cast<int>(threadIdx.x); y < band.last;
         y += kThreads) {
      uint32_t bits = 0;
      for (int q = 0; q < g.cluster; ++q) {
        const Rows need =
            !last ? layer_reads(s, l + 1, q, by_cluster)
                  : q < (s.fc_n[0] + 31) / 32 ? Rows{0, ho} : Rows{0, 0};
        if (q != rank && y >= need.first && y < need.last) bits |= 1u << q;
      }
      readers[y] = bits;
    }
    __syncthreads();
    conv_band(s, l, g.ksteps[m][l], g, rank, taps, tau, flip, cur, nxt,
              readers, by_cluster);
    stamp();
    conv_mma::cp_async_wait_all();
    stamp();
    // the layer's words, local and pushed, are visible to the cluster
    cluster_sync();
    stamp();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
    t = taps;
    taps = taps_next;
    taps_next = t;
    int32_t* p = tau;
    tau = tau_next;
    tau_next = p;
    p = flip;
    flip = flip_next;
    flip_next = p;
  }

  // 3. the FC tail
  for (int fi = 0; fi < s.n_fc; ++fi) {
    fc_words(s, img, fi, g, rank, cur, nxt, out);
    if (fi != s.n_fc - 1) {
      cluster_sync();
      uint32_t* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
  stamp();
}

// Launches kernel(arg) as clusters of `cluster` blocks of kThreads threads
// on grid, with smem_bytes of dynamic shared memory, after checking with
// cudaOccupancyMaxActiveClusters that such a cluster fits the device
// (cudaErrorInvalidConfiguration if none does).  Returns the first error.
template <typename Arg>
inline cudaError_t launch_clusters(void (*kernel)(Arg), const Arg& arg,
                                   dim3 grid, int cluster, int smem_bytes,
                                   cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, arg);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace member_mma
}  // namespace repro_torch
