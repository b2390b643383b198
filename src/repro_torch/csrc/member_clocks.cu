// Clock probe of the cluster member body: not a port of a TPU kernel.
// cluster_clocks_kernel runs member_mma.cuh's run_frame (the body of the
// megakernel, the cascade's two stages and the delta recompute), one
// cluster a frame, through run_frame's phase hook (the staging, the pack,
// each conv layer, the FC tail).  Thread 0 of each block stamps clock64
// and %globaltimer after each phase (the FC tail's stamp follows no
// barrier).  The stamps of one thread on one SM are subtracted on the
// device and written as signed 64-bit deltas, so a reading can be held
// against the call's device time: src/repro_torch/launch/time_members.py
// --clocks prints and checks them.

#include <cuda_runtime.h>

#include <cstdint>

#include "member_mma.cuh"

namespace {

using repro_torch::kMaxLayers;

constexpr int kPhases = 4 * kMaxLayers + 3;  // the stamps of run_frame

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

namespace mm = repro_torch::member_mma;

// run_frame's phase hook: thread 0 writes the deltas since the last stamp
struct ClockStamp {
  long long* clk;
  long long* ns;
  int phase;
  long long c0, n0;
  __device__ __forceinline__ void operator()() {
    if (threadIdx.x == 0) {
      const long long c1 = clock64(), n1 = global_ns();
      clk[phase] = c1 - c0;
      ns[phase] = n1 - n0;
      c0 = c1;
      n0 = n1;
    }
    ++phase;
  }
};

struct ClusterClockArgs {
  repro_torch::MemberSpec spec;
  repro_torch::ImageRef img;
  mm::Geometry geo;
  const int32_t* frames;         // (B, H, W, Cin)
  const float* thr;
  int32_t* out;                  // (B, classes)
  long long* clocks;             // (B x cluster, kPhases) clock64 deltas
  long long* nanos;              // (B x cluster, kPhases) %globaltimer
};

__global__ void __launch_bounds__(mm::kThreads)
cluster_clocks_kernel(const __grid_constant__ ClusterClockArgs a) {
  extern __shared__ uint4 smem4[];
  const int b = blockIdx.x / a.geo.cluster;
  const size_t row = static_cast<size_t>(blockIdx.x) * kPhases;
  const ClockStamp stamp{a.clocks + row, a.nanos + row, 0, clock64(),
                         global_ns()};
  mm::run_frame<false>(
      a.spec, a.img, a.geo, 0,
      a.frames + static_cast<size_t>(b) * repro_torch::frame_elems(a.spec),
      a.thr, nullptr,
      a.out + static_cast<size_t>(b) * repro_torch::classes(a.spec),
      reinterpret_cast<uint32_t*>(smem4), stamp);
}

}  // namespace

// The cluster body's probe: table and geo as composite_launch takes them
// (one member); clocks and nanos (B x cluster, 4 kMaxLayers + 3) int64,
// block-major: phase 0 the staging, 1 the pack, 2 + 4 l .. 5 + 4 l conv
// layer l's taps issue, tiles, taps wait and cluster barrier, 2 + 4 n_conv
// the FC tail.  Returns a CUDA error code.
extern "C" int cluster_clocks_launch(const void* frames, const void* thr,
                                     const void* cw, const void* ct,
                                     const void* cf, const void* fw,
                                     void* out, void* clocks, void* nanos,
                                     const int* table, int n_table,
                                     const int* geo, int n_geo, int batch,
                                     void* stream) {
  repro_torch::LaunchTable t;
  ClusterClockArgs a{};
  if (!repro_torch::parse_table(table, n_table, &t) || t.n_members != 1 ||
      !mm::parse_geometry(geo, n_geo, t, &a.geo) || batch < 1) {
    return cudaErrorInvalidValue;
  }
  a.spec = t.member[0];
  a.img = {static_cast<const uint32_t*>(cw), static_cast<const int32_t*>(ct),
           static_cast<const int32_t*>(cf), static_cast<const uint32_t*>(fw),
           t.ftot, t.cwmax, t.ntot, t.kwmax};
  a.frames = static_cast<const int32_t*>(frames);
  a.thr = static_cast<const float*>(thr);
  a.out = static_cast<int32_t*>(out);
  a.clocks = static_cast<long long*>(clocks);
  a.nanos = static_cast<long long*>(nanos);
  return static_cast<int>(mm::launch_clusters(
      cluster_clocks_kernel, a,
      dim3(static_cast<unsigned>(a.geo.cluster * batch)), a.geo.cluster,
      a.geo.smem_bytes, static_cast<cudaStream_t>(stream)));
}
