// Delta-gated whole-network inference for Hopper (sm_90a).
//
// Replaces: repro/kernels/megakernel.py:_delta_kernel (entry delta_forward).
// Batch slot b is stream b of an always-on deployment.  Each frame is
// thermometer-packed and compared with the stream's resident last-frame
// words: delta[b] = sum over the frame's words of popc(cur ^ last[b]).  A
// lane changes when b < n_real (ctrl[1]) and delta[b] >= ctrl[0]; a changed
// lane's last words advance to the current frame, every other lane keeps
// its own.  The changed lanes are compacted in frame order into a queue
// (counts[0] = K), recomputed through the network, and their fresh logits
// are scattered over the cached logits llog; the merged logits are the
// next call's llog.  counts[1] is the frame slots repro's bounded drain
// loop bills (scan.cuh drain_slots).  deltas[b] is 0 for b >= n_real.
//
// repro's drain gathers whole chunks of queue rows, and rows from K on
// hold index 0, so it also recomputes frame 0 and writes it over lane 0's
// cached logits whenever it drains a row at or past K: lane 0's logits
// come out fresh iff min(counts[1], bpad) > K, even when lane 0 did not
// change (its last words do not advance).  This kernel reproduces that.
//
// Nothing crosses to the host: delta_launch enqueues three kernels on the
// caller's stream.
//  1. gate_kernel: one block per stream.  The block packs its frame into
//     shared memory through megakernel.cuh's thermometer_word (the member
//     body packs through the same function, so the gate's words are the
//     network's input words), sums popc(cur ^ last[b]) with a block
//     reduction, writes deltas[b], new_last[b] = changed ? cur : last[b]
//     and logits[b] = llog[b].
//  2. change_scan_kernel: one block of 1024 threads compacts the change
//     mask in frame order (scan.cuh, shared with the cascade's escalation
//     scan) and writes queue (zeros from K on) and counts.
//  3. recompute_kernel: one block per queue row.  Block k < K runs the
//     member body on frame queue[k] into logits[queue[k]]; block K also
//     recomputes frame 0 into logits[0] when the lane-0 rule above holds
//     (then lane 0 is not in the queue, so K < B); every other block exits.
//
// What bounds it on the H100: the bound is the bytes the gate moves (each
// frame and its last words once) plus the K member frames' word-ops; the
// kernels are far from it.  The gate runs one frame per block on B SMs and
// is bound by instruction throughput there: about 100 instructions a
// packed word (the index arithmetic of thermometer_word, the compares, the
// ballot), 0.12 ms at cifar9_s1 B=8.  The recompute is K member blocks side
// by side, each as the megakernel's integer throughput on one SM.  Spreading a
// frame over several blocks waits for the megakernel's occupancy work
// (ROADMAP 4.1).

#include <cuda_runtime.h>

#include <cstdint>

#include "megakernel.cuh"
#include "scan.cuh"

namespace {

using repro_torch::kMegaWarps;

// A gate block takes twice the member body's warps, every lane loads the
// last word before the ballot (one broadcast address, no load in a
// divergent branch), and the loop is unrolled so several iterations' loads
// are in flight: together 0.20 -> 0.13 ms at cifar9_s1 B=8 (PERF.md).
constexpr int kGateWarps = 32;

struct DeltaArgs {
  repro_torch::MemberSpec spec;
  repro_torch::ImageRef img;
  const int32_t* frames;         // (B, H, W, Cin)
  const float* thr;              // thermometer thresholds
  const uint32_t* last;          // (B, H, W, cwio) last-frame words
  const int32_t* llog;           // (B, C) cached logits
  const int32_t* ctrl;           // [threshold, n_real]
  int32_t* logits;               // (B, C) merged logits
  uint32_t* new_last;            // (B, H, W, cwio)
  int32_t* queue;                // (B,)
  int32_t* counts;               // (2,)
  int32_t* deltas;               // (B,)
  int batch, bpad, rb, check_every;
  int smem_words;                // words per ping-pong buffer of the member
};

__global__ void __launch_bounds__(kGateWarps * 32)
gate_kernel(const DeltaArgs a) {
  extern __shared__ uint32_t cur[];
  __shared__ int warp_sum[kGateWarps];
  __shared__ int changed;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int items = a.spec.h * a.spec.w * a.spec.cwio;
  const int32_t* frame =
      a.frames + static_cast<size_t>(b) * repro_torch::frame_elems(a.spec);
  const uint32_t* last = a.last + static_cast<size_t>(b) * items;
  int acc = 0;
#pragma unroll 4
  for (int item = warp; item < items; item += kGateWarps) {
    const uint32_t prev = last[item];
    const uint32_t word =
        repro_torch::thermometer_word(a.spec, frame, a.thr, item, lane);
    if (lane == 0) cur[item] = word;
    acc += __popc(word ^ prev);   // the same sum in every lane of the warp
  }
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int d = 0;
    for (int w = 0; w < kGateWarps; ++w) d += warp_sum[w];
    const bool live = b < a.ctrl[1];
    changed = live && d >= a.ctrl[0];
    a.deltas[b] = live ? d : 0;
  }
  __syncthreads();
  const uint32_t* src = changed ? cur : last;
  uint32_t* dst = a.new_last + static_cast<size_t>(b) * items;
  for (int i = threadIdx.x; i < items; i += blockDim.x) dst[i] = src[i];
  const int nc = repro_torch::classes(a.spec);
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    a.logits[static_cast<size_t>(b) * nc + c] =
        a.llog[static_cast<size_t>(b) * nc + c];
  }
}

__global__ void __launch_bounds__(repro_torch::kScanThreads)
change_scan_kernel(const DeltaArgs a) {
  const int thr = a.ctrl[0];
  const int n_real = a.ctrl[1];
  const int k = repro_torch::compact_in_order(
      [&](int i) { return i < n_real && a.deltas[i] >= thr; }, a.batch,
      a.queue);
  if (threadIdx.x == 0) {
    a.counts[0] = k;
    a.counts[1] = repro_torch::drain_slots(k, a.bpad, a.rb, a.check_every);
  }
}

__global__ void __launch_bounds__(kMegaWarps * 32)
recompute_kernel(const DeltaArgs a) {
  extern __shared__ uint32_t smem[];
  const int row = blockIdx.x;
  const int k = a.counts[0];
  int frame;
  if (row < k) {
    frame = a.queue[row];
  } else {
    // repro's drain recomputes frame 0 over lane 0 when it covers a row
    // at or past K; if lane 0 changed, queue[0] == 0 already recomputes it
    const int covered = a.counts[1] < a.bpad ? a.counts[1] : a.bpad;
    if (row != k || covered <= k || a.queue[0] == 0) return;
    frame = 0;
  }
  repro_torch::run_member(
      a.spec, a.img,
      a.frames + static_cast<size_t>(frame) * repro_torch::frame_elems(a.spec),
      a.thr,
      a.logits + static_cast<size_t>(frame) * repro_torch::classes(a.spec),
      smem, a.smem_words);
}

}  // namespace

// table: the one-member launch table (megakernel.cuh parse_table).  frames
// (B, H, W, Cin) int32; thr the member's float32 thermometer thresholds;
// the weight image cw/ct/cf/fw; last (B, H, W, cwio) words and llog (B, C)
// int32, the resident state; ctrl (2,) int32 on the device; outputs logits
// (B, C), new_last (B, H, W, cwio), queue (B,), counts (2,), deltas (B,).
// bpad/rb/check_every: the drain schedule the bill follows (bpad =
// ceil(B / bb) * bb, 1 <= rb <= bpad).  Returns a CUDA error code:
// cudaErrorInvalidValue for arguments the kernels cannot take, else the
// first launch error.
extern "C" int delta_launch(const void* frames, const void* thr,
                            const void* cw, const void* ct, const void* cf,
                            const void* fw, const void* last,
                            const void* llog, const void* ctrl, void* logits,
                            void* new_last, void* queue, void* counts,
                            void* deltas, const int* table, int n_table,
                            int batch, int bpad, int rb, int check_every,
                            void* stream) {
  repro_torch::LaunchTable t;
  if (!repro_torch::parse_table(table, n_table, &t) || t.n_members != 1 ||
      batch < 1 || bpad < batch || rb < 1 || rb > bpad || check_every < 1) {
    return cudaErrorInvalidValue;
  }
  DeltaArgs a{};
  a.spec = t.member[0];
  a.img = {static_cast<const uint32_t*>(cw), static_cast<const int32_t*>(ct),
           static_cast<const int32_t*>(cf), static_cast<const uint32_t*>(fw),
           t.ftot, t.cwmax, t.ntot, t.kwmax};
  a.frames = static_cast<const int32_t*>(frames);
  a.thr = static_cast<const float*>(thr);
  a.last = static_cast<const uint32_t*>(last);
  a.llog = static_cast<const int32_t*>(llog);
  a.ctrl = static_cast<const int32_t*>(ctrl);
  a.logits = static_cast<int32_t*>(logits);
  a.new_last = static_cast<uint32_t*>(new_last);
  a.queue = static_cast<int32_t*>(queue);
  a.counts = static_cast<int32_t*>(counts);
  a.deltas = static_cast<int32_t*>(deltas);
  a.batch = batch;
  a.bpad = bpad;
  a.rb = rb;
  a.check_every = check_every;
  a.smem_words = repro_torch::member_smem_words(a.spec);

  const auto s = static_cast<cudaStream_t>(stream);
  const int gate_bytes =
      a.spec.h * a.spec.w * a.spec.cwio * static_cast<int>(sizeof(uint32_t));
  const int member_bytes =
      2 * a.smem_words * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = repro_torch::allow_smem(gate_kernel, gate_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = repro_torch::allow_smem(recompute_kernel, member_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);

  gate_kernel<<<batch, kGateWarps * 32, gate_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  change_scan_kernel<<<1, repro_torch::kScanThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  recompute_kernel<<<batch, kMegaWarps * 32, member_bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
