// Whole-network binary CNN megakernel for Hopper (sm_90a): solo programs
// and shared-array composites.
//
// Replaces: repro/kernels/megakernel.py:_composite_kernel, both in its
// one-member case (entry megakernel_forward) and with several members
// (entry composite_forward): raw frames in, int32 logits out, with the
// thermometer encode, every conv layer and the FC tail of every member in
// one launch and no feature map in device memory between layers.  The
// members of a composite are programs whose S-modes tile the 256-channel
// array; each reads its own rows of one composite weight image
// (megakernel.cuh).
//
// What bounds it on the H100: the tensor cores' binary MACs in principle
// (cifar9_s1 at batch 8: 8.05 G conv MACs, 0.0010 ms at the binary MAC
// peak, chip_smoke.py phase 2's probe), against a few hundred KB of frames,
// weights and logits.  In practice a frame's chain of dependent layers,
// each a few tiles a warp and a cluster barrier, sets the time of a launch
// at serving batches (PERF.md section 6, row 4; the clock64 split of
// launch/time_members.py --clocks).  The body this replaced, one block
// a frame, ran a frame's 31 M xor+popc word-ops on one SM's CUDA cores:
// batch 8 kept 8 of 132 SMs busy for 1.42 ms.
//
// Design: the member body of member_mma.cuh, one thread-block cluster a
// frame, its blocks splitting each conv layer's output rows and trading
// halo rows through distributed shared memory.  Grid (cluster x max B_m,
// members): blockIdx.y selects the member's stage table, frame batch and
// logits, blockIdx.x / cluster the frame; clusters past a member's ragged
// batch return at once, all their blocks together.  One cluster shape
// serves the launch, and every member splits its rows over all of its
// blocks.  The cluster shape, shared memory and tap strides come from the
// Python wrapper (kernels/megakernel.py cluster_geometry); the launch
// checks with cudaOccupancyMaxActiveClusters that a cluster fits and
// fails otherwise.  TPU lane grouping (repro's _run_group) is a schedule
// of the same arithmetic and has no counterpart here.

#include <cuda_runtime.h>

#include <cstdint>

#include "member_mma.cuh"

namespace {

using repro_torch::kMaxMembers;
namespace mm = repro_torch::member_mma;

struct CompositeArgs {
  repro_torch::MemberSpec member[kMaxMembers];
  const int32_t* frames[kMaxMembers];    // (B_m, H, W, Cin)
  const float* thr[kMaxMembers];         // (per,)
  int32_t* out[kMaxMembers];             // (B_m, classes)
  int batch[kMaxMembers];
  repro_torch::ImageRef img;
  mm::Geometry geo;
};

__global__ void __launch_bounds__(mm::kThreads)
composite_kernel(const __grid_constant__ CompositeArgs args) {
  extern __shared__ uint4 smem4[];
  const int m = blockIdx.y;
  const int b = blockIdx.x / args.geo.cluster;
  if (b >= args.batch[m]) return;        // the whole cluster
  const repro_torch::MemberSpec& spec = args.member[m];
  mm::run_frame<false>(
      spec, args.img, args.geo, m,
      args.frames[m] + static_cast<size_t>(b) * repro_torch::frame_elems(spec),
      args.thr[m], nullptr,
      args.out[m] + static_cast<size_t>(b) * repro_torch::classes(spec),
      reinterpret_cast<uint32_t*>(smem4));
}

}  // namespace

// table: the int32 launch table (megakernel.cuh parse_table) and geo the
// launch geometry (member_mma.cuh parse_geometry), both built by the
// Python wrapper.  frames/thr/out/batch: one entry per member, in member
// order.  cw/ct/cf/fw: the (composite) weight image.  Returns a CUDA error
// code: cudaErrorInvalidValue for a table or geometry the kernel cannot
// take, cudaErrorInvalidConfiguration if no cluster fits the device, else
// the launch's error.
extern "C" int composite_launch(const void* const* frames,
                                const void* const* thr, const void* cw,
                                const void* ct, const void* cf, const void* fw,
                                void* const* out, const int* batch,
                                const int* table, int n_table, const int* geo,
                                int n_geo, void* stream) {
  repro_torch::LaunchTable t;
  CompositeArgs args{};
  if (!repro_torch::parse_table(table, n_table, &t) ||
      !mm::parse_geometry(geo, n_geo, t, &args.geo)) {
    return cudaErrorInvalidValue;
  }
  int bmax = 0;
  for (int m = 0; m < t.n_members; ++m) {
    args.member[m] = t.member[m];
    args.frames[m] = static_cast<const int32_t*>(frames[m]);
    args.thr[m] = static_cast<const float*>(thr[m]);
    args.out[m] = static_cast<int32_t*>(out[m]);
    args.batch[m] = batch[m];
    if (batch[m] < 0) return cudaErrorInvalidValue;
    if (batch[m] > bmax) bmax = batch[m];
  }
  if (bmax == 0) return cudaErrorInvalidValue;
  args.img = {static_cast<const uint32_t*>(cw), static_cast<const int32_t*>(ct),
              static_cast<const int32_t*>(cf), static_cast<const uint32_t*>(fw),
              t.ftot, t.cwmax, t.ntot, t.kwmax};
  const dim3 grid(static_cast<unsigned>(args.geo.cluster * bmax),
                  static_cast<unsigned>(t.n_members));
  return static_cast<int>(mm::launch_clusters(
      composite_kernel, args, grid, args.geo.cluster, args.geo.smem_bytes,
      static_cast<cudaStream_t>(stream)));
}
