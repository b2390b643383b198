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
// What bounds it on the H100: integer issue on the SMs that have work.  A
// cifar9 S=1 frame is about 31 M xor+popc word-ops (popc issues at 16 per
// clock per SM), and this design gives each frame of each member one
// thread block, so a launch occupies at most sum(B_m) of the 132 SMs.  At
// batch 8 that leaves most of the card idle; spreading one frame over
// several SMs (clusters, or a per-layer split of positions) is the first
// thing a faster version changes.
//
// Design: grid (max B_m, members).  blockIdx.y selects the member's stage
// table, frame batch and logits; blocks past a member's ragged batch
// return at once.  Each block runs run_member (megakernel.cuh) on one
// frame.  Dynamic shared memory is the largest member's two ping-pong map
// buffers (64 KB for an S=1 member, above the 48 KB default, hence the
// opt-in; 16 KB for a 4 x S=4 composite).  TPU lane grouping
// (repro's _run_group) is a schedule of the same arithmetic and has no
// counterpart here: every member runs its own blocks.

#include <cuda_runtime.h>

#include <cstdint>

#include "megakernel.cuh"

namespace {

using repro_torch::kMaxMembers;
using repro_torch::kMegaWarps;

struct CompositeArgs {
  repro_torch::MemberSpec member[kMaxMembers];
  const int32_t* frames[kMaxMembers];    // (B_m, H, W, Cin)
  const float* thr[kMaxMembers];         // (per,)
  int32_t* out[kMaxMembers];             // (B_m, classes)
  int batch[kMaxMembers];
  repro_torch::ImageRef img;
  int smem_words;
};

__global__ void __launch_bounds__(kMegaWarps * 32)
composite_kernel(const CompositeArgs args) {
  extern __shared__ uint32_t smem[];
  const int m = blockIdx.y;
  const int b = blockIdx.x;
  if (b >= args.batch[m]) return;
  const repro_torch::MemberSpec& spec = args.member[m];
  repro_torch::run_member(
      spec, args.img,
      args.frames[m] + static_cast<size_t>(b) * repro_torch::frame_elems(spec),
      args.thr[m],
      args.out[m] + static_cast<size_t>(b) * repro_torch::classes(spec), smem,
      args.smem_words);
}

}  // namespace

// table: the int32 launch table (megakernel.cuh parse_table) built by the
// Python wrapper.  frames/thr/out/batch: one entry per member, in member
// order.  cw/ct/cf/fw: the (composite) weight image.  Returns a CUDA error
// code: cudaErrorInvalidValue for a table the kernel cannot take, else
// cudaGetLastError() after the launch.
extern "C" int composite_launch(const void* const* frames,
                                const void* const* thr, const void* cw,
                                const void* ct, const void* cf, const void* fw,
                                void* const* out, const int* batch,
                                const int* table, int n_table, void* stream) {
  repro_torch::LaunchTable t;
  if (!repro_torch::parse_table(table, n_table, &t)) {
    return cudaErrorInvalidValue;
  }
  CompositeArgs args{};
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
  args.smem_words = 0;
  for (int m = 0; m < t.n_members; ++m) {
    const int words = repro_torch::member_smem_words(t.member[m]);
    if (words > args.smem_words) args.smem_words = words;
  }

  const int smem_bytes = 2 * args.smem_words * static_cast<int>(sizeof(uint32_t));
  const cudaError_t err = repro_torch::allow_smem(composite_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bmax),
                  static_cast<unsigned>(t.n_members));
  composite_kernel<<<grid, kMegaWarps * 32, smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
