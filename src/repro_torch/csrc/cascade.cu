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
//  1. detector_kernel: one thread-block cluster per frame, the member body
//     of member_mma.cuh (run_frame) on the detector's rows of the shared
//     image, at the detector's own cluster geometry.
//  2. escalate_kernel: one block of 1024 threads reads the detector
//     logits and ctrl, computes the margins and compacts the mask in frame
//     order (scan.cuh: tiles of 1024 frames, a ballot per warp, a shuffle
//     scan over the 32 warp totals), and writes queue and counts.
//  3. recognizer_kernel: one cluster per queue row at the recognizer's
//     geometry.  Every block of cluster k reads E from counts (one global
//     word, written by the scan before this launch, so all ranks agree):
//     at or past E, rank 0 zeroes rec[k] and the whole cluster returns
//     before its first cluster barrier; else the cluster runs the member
//     body on frame queue[k], packing its own words from the pixels (the
//     two programs' thermometer IO may differ).
// The recognizer computes the E escalated frames only; counts[1] is the
// chip's bill, not the GPU's work.
//
// What bounds it on the H100: the two members' binary MACs on the tensor
// cores in principle (face -> owner at batch 8, every frame escalated:
// 8.9 G MACs), in practice each member frame's chain of dependent layers,
// as in the megakernel (megakernel.cu): a detector wave of clusters, the
// scan's few microseconds, then a recognizer wave.  Each stage gets its
// own cluster geometry (kernels/megakernel.py cascade_geometry), so the
// narrow detector neither carves the recognizer's shared memory nor waits
// on its cluster shape.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "member_mma.cuh"
#include "scan.cuh"

namespace {

namespace mm = repro_torch::member_mma;

struct CascadeArgs {
  repro_torch::MemberSpec det, rec;
  repro_torch::ImageRef img;
  mm::Geometry det_geo, rec_geo;
  const int32_t* frames;         // (B, H, W, Cin), one stream for both
  const float* thr_det;
  const float* thr_rec;
  const int32_t* ctrl;           // [threshold, n_real]
  int32_t* det_out;              // (B, Cd)
  int32_t* rec_out;              // (B, Cr)
  int32_t* queue;                // (B,)
  int32_t* counts;               // (2,)
  int batch, bpad, rb, check_every, positive_class;
};

__global__ void __launch_bounds__(mm::kThreads)
detector_kernel(const __grid_constant__ CascadeArgs a) {
  extern __shared__ uint4 smem4[];
  const int b = blockIdx.x / a.det_geo.cluster;
  mm::run_frame<false>(
      a.det, a.img, a.det_geo, 0,
      a.frames + static_cast<size_t>(b) * repro_torch::frame_elems(a.det),
      a.thr_det, nullptr,
      a.det_out + static_cast<size_t>(b) * repro_torch::classes(a.det),
      reinterpret_cast<uint32_t*>(smem4));
}

__global__ void __launch_bounds__(repro_torch::kScanThreads)
escalate_kernel(const __grid_constant__ CascadeArgs a) {
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

__global__ void __launch_bounds__(mm::kThreads)
recognizer_kernel(const __grid_constant__ CascadeArgs a) {
  extern __shared__ uint4 smem4[];
  const int k = blockIdx.x / a.rec_geo.cluster;
  const int ncr = repro_torch::classes(a.rec);
  int32_t* out = a.rec_out + static_cast<size_t>(k) * ncr;
  // the same global word in every block of the cluster: the whole
  // cluster returns together, before any cluster barrier
  if (k >= a.counts[0]) {
    if (mm::cluster_rank() == 0) {
      for (int c = threadIdx.x; c < ncr; c += mm::kThreads) out[c] = 0;
    }
    return;
  }
  mm::run_frame<false>(
      a.rec, a.img, a.rec_geo, 0,
      a.frames + static_cast<size_t>(a.queue[k]) *
                     repro_torch::frame_elems(a.rec),
      a.thr_rec, nullptr, out, reinterpret_cast<uint32_t*>(smem4));
}

// The one-member table of member m of t (its offsets into the image kept),
// which a stage's geometry is checked against.
repro_torch::LaunchTable stage_table(const repro_torch::LaunchTable& t,
                                     int m) {
  repro_torch::LaunchTable s = t;
  s.n_members = 1;
  s.member[0] = t.member[m];
  return s;
}

}  // namespace

// table: the 2-member launch table (megakernel.cuh parse_table), detector
// first; det_geo and rec_geo: each stage's cluster geometry
// (member_mma.cuh parse_geometry), checked against the one-member table of
// its stage.  frames (B, H, W, Cin) int32; thr_det/thr_rec the members'
// float32 thermometer thresholds; the weight image cw/ct/cf/fw; ctrl (2,)
// int32 on the device; outputs det (B, Cd), rec (B, Cr), queue (B,),
// counts (2,) int32.  bpad/rb/check_every: the drain schedule the bill
// follows (bpad = ceil(B / bb) * bb, 1 <= rb <= bpad).  Returns a CUDA
// error code: cudaErrorInvalidValue for arguments the kernels cannot take,
// cudaErrorInvalidConfiguration if a stage's cluster fits no device slot,
// else the first launch error.
extern "C" int cascade_launch(const void* frames, const void* thr_det,
                              const void* thr_rec, const void* cw,
                              const void* ct, const void* cf, const void* fw,
                              const void* ctrl, void* det, void* rec,
                              void* queue, void* counts, const int* table,
                              int n_table, const int* det_geo, int n_det_geo,
                              const int* rec_geo, int n_rec_geo, int batch,
                              int bpad, int rb, int check_every,
                              int positive_class, void* stream) {
  repro_torch::LaunchTable t;
  CascadeArgs a{};
  if (!repro_torch::parse_table(table, n_table, &t) || t.n_members != 2 ||
      !mm::parse_geometry(det_geo, n_det_geo, stage_table(t, 0),
                          &a.det_geo) ||
      !mm::parse_geometry(rec_geo, n_rec_geo, stage_table(t, 1),
                          &a.rec_geo) ||
      batch < 1 || bpad < batch || rb < 1 || rb > bpad || check_every < 1 ||
      positive_class < 0 ||
      positive_class >= repro_torch::classes(t.member[0])) {
    return cudaErrorInvalidValue;
  }
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

  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = mm::launch_clusters(
      detector_kernel, a,
      dim3(static_cast<unsigned>(a.det_geo.cluster * batch)),
      a.det_geo.cluster, a.det_geo.smem_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  escalate_kernel<<<1, repro_torch::kScanThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mm::launch_clusters(
      recognizer_kernel, a,
      dim3(static_cast<unsigned>(a.rec_geo.cluster * batch)),
      a.rec_geo.cluster, a.rec_geo.smem_bytes, s));
}
