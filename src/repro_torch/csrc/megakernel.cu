// Whole-network binary CNN megakernel for Hopper (sm_90a), solo program.
//
// Replaces: repro/kernels/megakernel.py:_composite_kernel in its one-member
// case (entry megakernel_forward): raw frames in, int32 logits out, with
// the thermometer encode, every conv layer and the FC tail in one launch
// and no feature map in device memory between layers.
//
// What bounds it on the H100: integer issue on the SMs that have work.  A
// cifar9 S=1 frame is about 31 M xor+popc word-ops (popc issues at 16 per
// clock per SM), and this design gives each frame one thread block, so a
// batch of B frames occupies at most B of the 132 SMs.  At batch 8 that
// leaves most of the card idle; spreading one frame over several SMs
// (clusters, or a per-layer split of positions) is the first thing a
// faster version changes.
//
// Design: one block of 16 warps per frame.
//  * The block thermometer-packs its raw pixels into shared memory: lane j
//    of a warp computes channel 32*i + j of one position as
//    (float)pixel < t[p] against the host's float32 threshold table, and
//    the ballot is the packed word.
//  * The conv chain ping-pongs the packed maps between two shared-memory
//    buffers (at S=1 the largest maps are 32x32x8 and 31x31x8 words, about
//    64 KB in all, above the 48 KB default, hence the opt-in attribute).
//    Warp w owns feature word w % (F/32) for a whole layer, with its lane's
//    4 x C/32 weight words in registers, and strides over positions; the
//    per-word arithmetic is conv_block.cuh's, shared with conv_block.cu.
//  * Weights are read from global memory: the S=1 conv image is 256 KB,
//    above the 227 KB a block may hold, so it stays in the 50 MB L2.
//  * The FC tail reads the flattened final map (its (H, W, F/32) word order
//    is the FC's K order), one warp per 32 outputs; hidden layers sign and
//    pack with a ballot (bits past N stay 0), the final layer writes int32
//    logits.  Only each layer's true (N, Kw) of the zero-padded fw is read.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv_block.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kMaxLayers = 16;   // the chip's program memory holds 16 slots

struct MegaSpec {
  int h, w, cin, per, cwio;      // IO geometry; cwio = encoded channels / 32
  int n_conv;
  int conv_h[kMaxLayers], conv_w[kMaxLayers], conv_c[kMaxLayers];
  int conv_f[kMaxLayers], conv_pool[kMaxLayers];
  int n_fc;
  int fc_k[kMaxLayers], fc_n[kMaxLayers];
  int nmax, kwmax;               // fw (Lf, Nmax, Kwmax) strides
  int smem_words;                // words in each ping-pong buffer
};

__global__ void __launch_bounds__(kWarps * 32)
megakernel(const int32_t* __restrict__ frames, const float* __restrict__ thr,
           const uint32_t* __restrict__ cw, const int32_t* __restrict__ ct,
           const int32_t* __restrict__ cf, const uint32_t* __restrict__ fw,
           int32_t* __restrict__ out, const MegaSpec spec) {
  extern __shared__ uint32_t smem[];
  uint32_t* cur = smem;
  uint32_t* nxt = smem + spec.smem_words;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;

  // 1. thermometer pack: (H, W, Cin) int32 pixels -> (H, W, cwio) words
  {
    const int32_t* frame =
        frames + static_cast<size_t>(b) * spec.h * spec.w * spec.cin;
    const int used = spec.cin * spec.per;
    const int items = spec.h * spec.w * spec.cwio;
    for (int item = warp; item < items; item += kWarps) {
      const int pos = item / spec.cwio;
      const int ch = (item - pos * spec.cwio) * 32 + lane;
      uint32_t bit = 0u;
      if (ch < used) {
        const int c = ch / spec.per;
        const int p = ch - c * spec.per;
        bit = static_cast<float>(frame[pos * spec.cin + c]) < thr[p];
      }
      const uint32_t word = __ballot_sync(repro_torch::kFullMask, bit);
      if (lane == 0) cur[item] = word;
    }
  }
  __syncthreads();

  // 2. the conv chain, maps ping-ponged in shared memory
  for (int l = 0; l < spec.n_conv; ++l) {
    const int h = spec.conv_h[l], wd = spec.conv_w[l];
    const int c = spec.conv_c[l], f = spec.conv_f[l];
    const bool pool = spec.conv_pool[l] != 0;
    const int cwl = c / 32, fwo = f / 32;
    const int ho = pool ? (h - 1) / 2 : h - 1;
    const int wo = pool ? (wd - 1) / 2 : wd - 1;
    const int fwi = warp % fwo;                    // kWarps % fwo == 0
    const int fidx = fwi * 32 + lane;
    uint32_t wr[4 * repro_torch::kMaxCw];
    repro_torch::load_taps(cw + static_cast<size_t>(l) * f * 4 * cwl, fidx,
                           cwl, wr);
    const int tau = ct[l * f + fidx];
    const int flip = cf[l * f + fidx];
    for (int pos = warp / fwo; pos < ho * wo; pos += kWarps / fwo) {
      const int yo = pos / wo;
      const int xo = pos - yo * wo;
      const uint32_t word = repro_torch::conv_word(cur, wd, cwl, yo, xo, pool,
                                                   wr, 4 * c, tau, flip);
      if (lane == 0) nxt[pos * fwo + fwi] = word;
    }
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  // 3. the FC tail on the flattened packed map
  for (int fi = 0; fi < spec.n_fc; ++fi) {
    const int k = spec.fc_k[fi], n = spec.fc_n[fi];
    const int kw = (k + 31) / 32;
    const bool final_layer = fi == spec.n_fc - 1;
    for (int chunk = warp; chunk < (n + 31) / 32; chunk += kWarps) {
      const int nn = chunk * 32 + lane;
      int s = 0;
      if (nn < n) {
        const uint32_t* row =
            fw + (static_cast<size_t>(fi) * spec.nmax + nn) * spec.kwmax;
        int acc = 0;
        for (int i = 0; i < kw; ++i) acc += __popc(cur[i] ^ row[i]);
        s = k - 2 * acc;
      }
      if (final_layer) {
        if (nn < n) out[static_cast<size_t>(b) * n + nn] = s;
      } else {
        const uint32_t word = __ballot_sync(repro_torch::kFullMask,
                                            nn < n && s < 0);
        if (lane == 0) nxt[chunk] = word;
      }
    }
    if (!final_layer) {
      __syncthreads();
      uint32_t* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
}

}  // namespace

// spec_host: the int32 stage table built by the Python wrapper, in the
// order io (h, w, cin, per, cwio), n_conv, n_conv x (h, w, c, f, pool),
// n_fc, n_fc x (k, n), nmax, kwmax, smem_words.  frames (B, H, W, Cin)
// int32, thr (per,) float32, the weight image cw/ct/cf/fw, out (B, classes)
// int32.  Returns a CUDA error code: cudaErrorInvalidValue for a stage
// table the kernel cannot take, else cudaGetLastError() after the launch.
extern "C" int megakernel_launch(const void* frames, const void* thr,
                                 const void* cw, const void* ct, const void* cf,
                                 const void* fw, void* out,
                                 const int* spec_host, int n_spec, int batch,
                                 void* stream) {
  MegaSpec spec{};
  int i = 0;
  auto next = [&]() { return i < n_spec ? spec_host[i++] : -1; };
  spec.h = next();
  spec.w = next();
  spec.cin = next();
  spec.per = next();
  spec.cwio = next();
  spec.n_conv = next();
  if (spec.n_conv < 0 || spec.n_conv > kMaxLayers) return cudaErrorInvalidValue;
  for (int l = 0; l < spec.n_conv; ++l) {
    spec.conv_h[l] = next();
    spec.conv_w[l] = next();
    spec.conv_c[l] = next();
    spec.conv_f[l] = next();
    spec.conv_pool[l] = next();
  }
  spec.n_fc = next();
  if (spec.n_fc < 1 || spec.n_fc > kMaxLayers) return cudaErrorInvalidValue;
  for (int l = 0; l < spec.n_fc; ++l) {
    spec.fc_k[l] = next();
    spec.fc_n[l] = next();
  }
  spec.nmax = next();
  spec.kwmax = next();
  spec.smem_words = next();
  if (i != n_spec || spec.smem_words <= 0) return cudaErrorInvalidValue;

  const int smem_bytes = 2 * spec.smem_words * static_cast<int>(sizeof(uint32_t));
  // The opt-in is per device, so it is set on every launch (a cheap host
  // call) rather than remembered once for the process.
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        megakernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  megakernel<<<batch, kWarps * 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(frames), static_cast<const float*>(thr),
      static_cast<const uint32_t*>(cw), static_cast<const int32_t*>(ct),
      static_cast<const int32_t*>(cf), static_cast<const uint32_t*>(fw),
      static_cast<int32_t*>(out), spec);
  return static_cast<int>(cudaGetLastError());
}
