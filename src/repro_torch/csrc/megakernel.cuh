// The member spec and launch table of the whole-network kernels
// (megakernel.cu, cascade.cu, delta.cu and the clock probe
// member_clocks.cu), which run one member frame on a thread-block cluster
// (member_mma.cuh).
//
// A member is one program inside a weight image.  A composite image packs
// several programs side by side: conv layer l of every member lives in
// cw (Lc, F_total, 4, Cw_max), ct/cf (Lc, F_total), and member m reads its
// rows [f_off, f_off + F) and the first C/32 of the Cw_max words of each
// tap; FC layer i lives in fw (Lf, N_total, Kw_max) at rows
// [n_off, n_off + N).  A solo program is the one-member case, all offsets
// 0.  Rows past a member's depth are zero and never read.
//
// Conventions (those of repro.core.binarize): +1 -> bit 0, -1 -> bit 1,
// 32 channels per uint32 word, LSB first.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {

constexpr int kMaxCw = 8;        // 256 channels: the widest map the chip has
constexpr unsigned kFullMask = 0xffffffffu;
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

// The frame's elements and the member's class count.
__host__ __device__ inline int frame_elems(const MemberSpec& s) {
  return s.h * s.w * s.cin;
}
__host__ __device__ inline int classes(const MemberSpec& s) {
  return s.fc_n[s.n_fc - 1];
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
