// Fused detector -> recognizer cascade for Hopper (sm_90a).
//
// Replaces: repro/kernels/megakernel.py:_cascade_kernel (entry
// cascade_forward): the detector runs on every frame, the escalation
// decision is taken on the device (the int32 logit margin
// pos - max(others) >= ctrl[0], lanes at or past ctrl[1] = n_real never
// escalate), the escalated frame indices are compacted in frame order
// into a queue, and the recognizer runs on the queued frames, rec[k]
// answering frame queue[k].  counts[0] is the escalated count E;
// counts[1] is the recognizer slots repro's bounded drain loop bills:
// rb * sum(min(check_every, n_chunks - g0)) over the chunk groups
// g0 = 0, check_every, ... with g0 * rb < E, n_chunks = ceil(bpad / rb).
// Rows of rec and of queue from E on are zero.
//
// Nothing crosses to the host between the stages: cascade_launch enqueues
// three kernels on the caller's stream.
//  1. detector_kernel: one block per frame, the member body of
//     megakernel.cuh on the detector's rows of the shared image.
//  2. escalate_kernel: one block of 1024 threads reads the detector
//     logits and ctrl, computes the margins and compacts the mask in frame
//     order (scan.cuh: tiles of 1024 frames, a ballot per warp, a shuffle
//     scan over the 32 warp totals), and writes queue and counts.
//  3. recognizer_kernel: one block per queue row; a block reads E from
//     counts, zeroes its row and exits if it is at or past E, else runs
//     the recognizer's member body on frame queue[k].
// The recognizer computes the E escalated frames only; counts[1] is the
// chip's bill, not the GPU's work.
//
// What bounds it on the H100: as the megakernel, integer issue on the SMs
// that have work: B detector blocks, then E recognizer blocks (an S=1
// recognizer takes 64 KB of shared memory per block).  The scan is a few
// microseconds at serving batch sizes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "megakernel.cuh"
#include "scan.cuh"

namespace {

using repro_torch::kMegaWarps;

struct CascadeArgs {
  repro_torch::MemberSpec det, rec;
  repro_torch::ImageRef img;
  const int32_t* frames;         // (B, H, W, Cin), one stream for both
  const float* thr_det;
  const float* thr_rec;
  const int32_t* ctrl;           // [threshold, n_real]
  int32_t* det_out;              // (B, Cd)
  int32_t* rec_out;              // (B, Cr)
  int32_t* queue;                // (B,)
  int32_t* counts;               // (2,)
  int batch, bpad, rb, check_every, positive_class;
  int smem_det, smem_rec;        // words per ping-pong buffer
};

__global__ void __launch_bounds__(kMegaWarps * 32)
detector_kernel(const CascadeArgs a) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  repro_torch::run_member(
      a.det, a.img,
      a.frames + static_cast<size_t>(b) * repro_torch::frame_elems(a.det),
      a.thr_det,
      a.det_out + static_cast<size_t>(b) * repro_torch::classes(a.det), smem,
      a.smem_det);
}

__global__ void __launch_bounds__(repro_torch::kScanThreads)
escalate_kernel(const CascadeArgs a) {
  const int thr = a.ctrl[0];
  const int n_real = a.ctrl[1];
  const int ncd = repro_torch::classes(a.det);
  const int pc = a.positive_class;
  const int e = repro_torch::compact_in_order(
      [&](int i) {
        if (i >= n_real) return false;
        const int32_t* lg = a.det_out + static_cast<size_t>(i) * ncd;
        int rest = INT_MIN;
        for (int c = 0; c < ncd; ++c) {
          if (c != pc && lg[c] > rest) rest = lg[c];
        }
        // int32 wrap-around, as the reference's int32 subtraction
        const int m = static_cast<int>(static_cast<uint32_t>(lg[pc]) -
                                       static_cast<uint32_t>(rest));
        return m >= thr;
      },
      a.batch, a.queue);
  if (threadIdx.x == 0) {
    a.counts[0] = e;
    a.counts[1] = repro_torch::drain_slots(e, a.bpad, a.rb, a.check_every);
  }
}

__global__ void __launch_bounds__(kMegaWarps * 32)
recognizer_kernel(const CascadeArgs a) {
  extern __shared__ uint32_t smem[];
  const int k = blockIdx.x;
  const int ncr = repro_torch::classes(a.rec);
  int32_t* out = a.rec_out + static_cast<size_t>(k) * ncr;
  if (k >= a.counts[0]) {
    for (int c = threadIdx.x; c < ncr; c += blockDim.x) out[c] = 0;
    return;
  }
  const int frame = a.queue[k];
  repro_torch::run_member(
      a.rec, a.img,
      a.frames + static_cast<size_t>(frame) * repro_torch::frame_elems(a.rec),
      a.thr_rec, out, smem, a.smem_rec);
}

}  // namespace

// table: the 2-member launch table (megakernel.cuh parse_table), detector
// first.  frames (B, H, W, Cin) int32; thr_det/thr_rec the members'
// float32 thermometer thresholds; the weight image cw/ct/cf/fw; ctrl (2,)
// int32 on the device; outputs det (B, Cd), rec (B, Cr), queue (B,),
// counts (2,) int32.  bpad/rb/check_every: the drain schedule the bill
// follows (bpad = ceil(B / bb) * bb, 1 <= rb <= bpad).  Returns a CUDA
// error code: cudaErrorInvalidValue for arguments the kernels cannot take,
// else the first launch error.
extern "C" int cascade_launch(const void* frames, const void* thr_det,
                              const void* thr_rec, const void* cw,
                              const void* ct, const void* cf, const void* fw,
                              const void* ctrl, void* det, void* rec,
                              void* queue, void* counts, const int* table,
                              int n_table, int batch, int bpad, int rb,
                              int check_every, int positive_class,
                              void* stream) {
  repro_torch::LaunchTable t;
  if (!repro_torch::parse_table(table, n_table, &t) || t.n_members != 2 ||
      batch < 1 || bpad < batch || rb < 1 || rb > bpad || check_every < 1 ||
      positive_class < 0 || positive_class >= repro_torch::classes(t.member[0])) {
    return cudaErrorInvalidValue;
  }
  CascadeArgs a{};
  a.det = t.member[0];
  a.rec = t.member[1];
  a.img = {static_cast<const uint32_t*>(cw), static_cast<const int32_t*>(ct),
           static_cast<const int32_t*>(cf), static_cast<const uint32_t*>(fw),
           t.ftot, t.cwmax, t.ntot, t.kwmax};
  a.frames = static_cast<const int32_t*>(frames);
  a.thr_det = static_cast<const float*>(thr_det);
  a.thr_rec = static_cast<const float*>(thr_rec);
  a.ctrl = static_cast<const int32_t*>(ctrl);
  a.det_out = static_cast<int32_t*>(det);
  a.rec_out = static_cast<int32_t*>(rec);
  a.queue = static_cast<int32_t*>(queue);
  a.counts = static_cast<int32_t*>(counts);
  a.batch = batch;
  a.bpad = bpad;
  a.rb = rb;
  a.check_every = check_every;
  a.positive_class = positive_class;
  a.smem_det = repro_torch::member_smem_words(a.det);
  a.smem_rec = repro_torch::member_smem_words(a.rec);

  const auto s = static_cast<cudaStream_t>(stream);
  const int det_bytes = 2 * a.smem_det * static_cast<int>(sizeof(uint32_t));
  const int rec_bytes = 2 * a.smem_rec * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = repro_torch::allow_smem(detector_kernel, det_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = repro_torch::allow_smem(recognizer_kernel, rec_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);

  detector_kernel<<<batch, kMegaWarps * 32, det_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  escalate_kernel<<<1, repro_torch::kScanThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  recognizer_kernel<<<batch, kMegaWarps * 32, rec_bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
