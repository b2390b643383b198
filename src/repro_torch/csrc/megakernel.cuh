// The member spec and launch table of the whole-network kernels
// (megakernel.cu, cascade.cu, delta.cu, parse_table), and the one-block
// member body, one member's whole network per thread block, which the fused
// cascade (cascade.cu) alone still runs: the composite megakernel and the
// delta gate run the cluster body of member_mma.cuh, and the cascade moves
// there next (ROADMAP 2.2), which deletes run_member and conv_block.cuh.
//
// A member is one program inside a weight image.  A composite image packs
// several programs side by side: conv layer l of every member lives in
// cw (Lc, F_total, 4, Cw_max), ct/cf (Lc, F_total), and member m reads its
// rows [f_off, f_off + F) and the first C/32 of the Cw_max words of each
// tap; FC layer i lives in fw (Lf, N_total, Kw_max) at rows
// [n_off, n_off + N).  A solo program is the one-member case, all offsets
// 0.  Rows past a member's depth are zero and never read.
//
// Design: one block of kMegaWarps warps runs one frame of one member.
//  * The block thermometer-packs its raw pixels into shared memory
//    (thermometer_word): lane j of a warp computes channel 32*i + j of one
//    position as (float)pixel < t[p] against the host's float32 threshold
//    table, and the ballot is the packed word.
//  * The conv chain ping-pongs the packed maps between two shared-memory
//    buffers.  Warp w owns feature word w % (F/32) for a whole layer, with
//    its lane's 4 x C/32 weight words in registers, and strides over
//    positions; the per-word arithmetic is conv_block.cuh's.
//  * Weights are read from global memory: the S=1 conv image is 256 KB,
//    above the 227 KB a block may hold, so it stays in the 50 MB L2.
//  * The FC tail reads the flattened final map (its (H, W, F/32) word order
//    is the FC's K order), one warp per 32 outputs; hidden layers sign and
//    pack with a ballot (bits past N stay 0), the final layer writes int32
//    logits.  Only each layer's true (N, Kw) of the zero-padded fw is read.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "conv_block.cuh"

namespace repro_torch {

constexpr int kMegaWarps = 16;
constexpr int kMaxLayers = 16;   // the chip's program memory holds 16 slots
constexpr int kMaxMembers = 4;   // 4 x S=4 sub-arrays tile the 256 channels

struct MemberSpec {
  int h, w, cin, per, cwio;      // IO geometry; cwio = encoded channels / 32
  int n_conv;
  int conv_h[kMaxLayers], conv_w[kMaxLayers], conv_c[kMaxLayers];
  int conv_f[kMaxLayers], conv_pool[kMaxLayers], conv_foff[kMaxLayers];
  int n_fc;
  int fc_k[kMaxLayers], fc_n[kMaxLayers], fc_noff[kMaxLayers];
};

struct ImageRef {
  const uint32_t* cw;            // (Lc, ftot, 4, cwmax)
  const int32_t* ct;             // (Lc, ftot)
  const int32_t* cf;             // (Lc, ftot)
  const uint32_t* fw;            // (Lf, ntot, kwmax)
  int ftot, cwmax, ntot, kwmax;
};

// The int32 table the Python wrapper builds (kernels/megakernel.py
// composite_table): n_members, then per member
//   h, w, cin, per, cwio, n_conv, n_conv x (h, w, c, f, pool, f_off),
//   n_fc, n_fc x (k, n, n_off),
// then ftot, cwmax, ntot, kwmax.  Returns false on a table the kernels
// cannot take.
struct LaunchTable {
  int n_members;
  MemberSpec member[kMaxMembers];
  int ftot, cwmax, ntot, kwmax;
};

inline bool parse_table(const int* t, int n, LaunchTable* out) {
  int i = 0;
  auto next = [&]() { return i < n ? t[i++] : -1; };
  out->n_members = next();
  if (out->n_members < 1 || out->n_members > kMaxMembers) return false;
  for (int m = 0; m < out->n_members; ++m) {
    MemberSpec& s = out->member[m];
    s.h = next();
    s.w = next();
    s.cin = next();
    s.per = next();
    s.cwio = next();
    s.n_conv = next();
    if (s.n_conv < 0 || s.n_conv > kMaxLayers) return false;
    for (int l = 0; l < s.n_conv; ++l) {
      s.conv_h[l] = next();
      s.conv_w[l] = next();
      s.conv_c[l] = next();
      s.conv_f[l] = next();
      s.conv_pool[l] = next();
      s.conv_foff[l] = next();
    }
    s.n_fc = next();
    if (s.n_fc < 1 || s.n_fc > kMaxLayers) return false;
    for (int l = 0; l < s.n_fc; ++l) {
      s.fc_k[l] = next();
      s.fc_n[l] = next();
      s.fc_noff[l] = next();
    }
  }
  out->ftot = next();
  out->cwmax = next();
  out->ntot = next();
  out->kwmax = next();
  return i == n;
}

// Words in each of a member's two ping-pong map buffers: its largest map.
inline int member_smem_words(const MemberSpec& s) {
  int words = s.h * s.w * s.cwio;
  for (int l = 0; l < s.n_conv; ++l) {
    int ho = s.conv_h[l] - 1, wo = s.conv_w[l] - 1;
    if (s.conv_pool[l]) {
      ho /= 2;
      wo /= 2;
    }
    const int out = ho * wo * (s.conv_f[l] / 32);
    if (out > words) words = out;
  }
  for (int l = 0; l < s.n_fc; ++l) {
    const int out = (s.fc_n[l] + 31) / 32;
    if (out > words) words = out;
  }
  return words;
}

// The frame's elements and the member's class count.
__host__ __device__ inline int frame_elems(const MemberSpec& s) {
  return s.h * s.w * s.cin;
}
__host__ __device__ inline int classes(const MemberSpec& s) {
  return s.fc_n[s.n_fc - 1];
}

// Thermometer-packed word `item` of one frame: position item / cwio,
// channel word item % cwio.  Lane j computes channel 32 * word + j as
// (float)pixel < thr[plane] against the host's float32 threshold table
// (channels past cin * per are the constant +1 bias, bit 0); the ballot is
// the word, returned to every lane of the warp.
__device__ __forceinline__ uint32_t thermometer_word(
    const MemberSpec& spec, const int32_t* __restrict__ frame,
    const float* __restrict__ thr, int item, int lane) {
  const int pos = item / spec.cwio;
  const int ch = (item - pos * spec.cwio) * 32 + lane;
  uint32_t bit = 0u;
  if (ch < spec.cin * spec.per) {
    const int c = ch / spec.per;
    const int p = ch - c * spec.per;
    bit = static_cast<float>(frame[pos * spec.cin + c]) < thr[p];
  }
  return __ballot_sync(kFullMask, bit);
}

// The three phases of run_member, each called by every thread of the
// block (member_clocks.cu stamps the time between them).  pack_frame:
// (H, W, Cin) int32 pixels -> (H, W, cwio) words in cur.
__device__ __forceinline__ void pack_frame(const MemberSpec& spec,
                                           const int32_t* __restrict__ frame,
                                           const float* __restrict__ thr,
                                           uint32_t* cur) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int items = spec.h * spec.w * spec.cwio;
  for (int item = warp; item < items; item += kMegaWarps) {
    const uint32_t word = thermometer_word(spec, frame, thr, item, lane);
    if (lane == 0) cur[item] = word;
  }
}

// Conv layer l: the map in cur -> the next map in nxt.
__device__ __forceinline__ void conv_layer(const MemberSpec& spec,
                                           const ImageRef& img, int l,
                                           const uint32_t* cur,
                                           uint32_t* nxt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = spec.conv_h[l], wd = spec.conv_w[l];
  const int c = spec.conv_c[l], f = spec.conv_f[l];
  const bool pool = spec.conv_pool[l] != 0;
  const int cwl = c / 32, fwo = f / 32;
  const int ho = pool ? (h - 1) / 2 : h - 1;
  const int wo = pool ? (wd - 1) / 2 : wd - 1;
  const int fwi = warp % fwo;                    // kMegaWarps % fwo == 0
  const int fidx = fwi * 32 + lane;
  const size_t row0 = static_cast<size_t>(l) * img.ftot + spec.conv_foff[l];
  uint32_t wr[4 * kMaxCw];
  load_taps(img.cw + row0 * 4 * img.cwmax, fidx, cwl, img.cwmax, wr);
  const int tau = img.ct[row0 + fidx];
  const int flip = img.cf[row0 + fidx];
  for (int pos = warp / fwo; pos < ho * wo; pos += kMegaWarps / fwo) {
    const int yo = pos / wo;
    const int xo = pos - yo * wo;
    const uint32_t word = conv_word(cur, wd, cwl, yo, xo, pool, wr, 4 * c,
                                    tau, flip);
    if (lane == 0) nxt[pos * fwo + fwi] = word;
  }
}

// FC layer fi on the flattened packed map in cur: hidden layers sign and
// pack into nxt, the final layer writes int32 logits to out.
__device__ __forceinline__ void fc_layer(const MemberSpec& spec,
                                         const ImageRef& img, int fi,
                                         const uint32_t* cur, uint32_t* nxt,
                                         int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = spec.fc_k[fi], n = spec.fc_n[fi];
  const int kw = (k + 31) / 32;
  const bool final_layer = fi == spec.n_fc - 1;
  const uint32_t* rows =
      img.fw + (static_cast<size_t>(fi) * img.ntot + spec.fc_noff[fi]) *
                   img.kwmax;
  for (int chunk = warp; chunk < (n + 31) / 32; chunk += kMegaWarps) {
    const int nn = chunk * 32 + lane;
    int s = 0;
    if (nn < n) {
      const uint32_t* row = rows + static_cast<size_t>(nn) * img.kwmax;
      int acc = 0;
      for (int i = 0; i < kw; ++i) acc += __popc(cur[i] ^ row[i]);
      s = k - 2 * acc;
    }
    if (final_layer) {
      if (nn < n) out[nn] = s;
    } else {
      const uint32_t word = __ballot_sync(kFullMask, nn < n && s < 0);
      if (lane == 0) nxt[chunk] = word;
    }
  }
}

// One frame (H, W, Cin int32 pixels) of one member -> its int32 logits in
// out[0 .. classes).  Every thread of the block calls it; smem holds two
// buffers of smem_words words each.
__device__ __forceinline__ void run_member(
    const MemberSpec& spec, const ImageRef& img,
    const int32_t* __restrict__ frame, const float* __restrict__ thr,
    int32_t* __restrict__ out, uint32_t* smem, int smem_words) {
  uint32_t* cur = smem;
  uint32_t* nxt = smem + smem_words;
  pack_frame(spec, frame, thr, cur);
  __syncthreads();
  for (int l = 0; l < spec.n_conv; ++l) {
    conv_layer(spec, img, l, cur, nxt);
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int fi = 0; fi < spec.n_fc; ++fi) {
    fc_layer(spec, img, fi, cur, nxt, out);
    if (fi != spec.n_fc - 1) {
      __syncthreads();
      uint32_t* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
}

// Raise the dynamic shared-memory cap of `kernel` when a launch needs more
// than the 48 KB default.  The opt-in is per device, so it is set on every
// launch (a cheap host call) rather than remembered once for the process.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

}  // namespace repro_torch
