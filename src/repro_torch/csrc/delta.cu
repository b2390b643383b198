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
//  1. gate_kernel: grid (blocks, B); block g of stream b stages the pixels
//     and last words of its share of the frame's positions by cp.async,
//     packs them through member_mma.cuh's pack_positions (the member body
//     packs through the same function, so the gate's words are the
//     network's input words), writes the words to the scratch cur[b] and
//     its partial sum of popc(cur ^ last[b]) to partial[b][g]; block 0 of
//     a stream copies logits[b] = llog[b].
//  2. change_scan_kernel: one block of 1024 threads sums each stream's
//     partials (integers, so the total is the one-block sum), writes
//     deltas, compacts the change mask in frame order (scan.cuh, shared
//     with the cascade's escalation scan) and writes queue (zeros from K
//     on) and counts.
//  3. recompute_kernel: one thread-block cluster per queue row.  Cluster b
//     first writes new_last[b] = changed ? cur[b] : last[b], which needs
//     the total, so it follows the scan.  Cluster k < K then runs the
//     member body (member_mma.cuh) on the gate's words of frame queue[k]
//     into logits[queue[k]]; cluster K also recomputes frame 0 into
//     logits[0] when the lane-0 rule above holds (then lane 0 is not in
//     the queue, so K < B): it reads cur[0], the gate's words of frame 0,
//     not new_last[0], which holds last[0] there.  Every other cluster
//     exits after its copy.
//
// What bounds it on the H100: the bytes the gate moves (each frame and its
// last words once, new_last written once) plus the K member frames' binary
// MACs on the tensor cores.  The gate spreads a frame over the blocks the
// wrapper sizes (512 words a block at most), so at E = 0 a call is three
// short kernels; with E frames recomputed it is the megakernel's cluster
// chain (megakernel.cu) after them.  The launch geometry (gate blocks, the
// scratch stride, the cluster body's geometry) is the Python wrapper's
// (kernels/megakernel.py gate_geometry, cluster_geometry).

#include <cuda_runtime.h>

#include <cstdint>

#include "member_mma.cuh"
#include "scan.cuh"

namespace {

namespace mm = repro_torch::member_mma;

struct DeltaArgs {
  repro_torch::MemberSpec spec;
  repro_torch::ImageRef img;
  mm::Geometry geo;
  const int32_t* frames;         // (B, H, W, Cin)
  const float* thr;              // thermometer thresholds
  const uint32_t* last;          // (B, H, W, cwio) last-frame words
  const int32_t* llog;           // (B, C) cached logits
  const int32_t* ctrl;           // [threshold, n_real]
  uint32_t* cur;                 // (B, cur_stride) the gate's words
  int32_t* partial;              // (B, gate_blocks) partial deltas
  int32_t* logits;               // (B, C) merged logits
  uint32_t* new_last;            // (B, H, W, cwio)
  int32_t* queue;                // (B,)
  int32_t* counts;               // (2,)
  int32_t* deltas;               // (B,)
  int batch, bpad, rb, check_every;
  int gate_blocks, gate_pix_words, cur_stride;
};

__global__ void __launch_bounds__(mm::kThreads)
gate_kernel(const __grid_constant__ DeltaArgs a) {
  extern __shared__ uint4 smem4[];
  __shared__ int warp_sum[mm::kWarps];
  const int g = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const repro_torch::MemberSpec& s = a.spec;
  const int hw = s.h * s.w, items = hw * s.cwio;
  const int pos0 = hw * g / a.gate_blocks;
  const int pos1 = hw * (g + 1) / a.gate_blocks;
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const int32_t* pix = mm::stage_pixels(
      smem, a.frames + static_cast<size_t>(b) * repro_torch::frame_elems(s),
      s.cin, pos0, pos1);
  uint32_t* last_dst = smem + a.gate_pix_words;
  const uint32_t* last =
      last_dst +
      mm::stage_words(last_dst,
                      a.last + static_cast<size_t>(b) * items + pos0 * s.cwio,
                      (pos1 - pos0) * s.cwio);
  repro_torch::conv_mma::cp_async_wait_all();
  __syncthreads();
  uint32_t* cur = a.cur + static_cast<size_t>(b) * a.cur_stride;
  const int cwio = s.cwio;
  int acc = 0;                   // the same sum in every lane of a warp
  mm::pack_positions(s, pix, a.thr, pos0, pos1,
                     [&](int pos, int cwi, uint32_t word) {
                       const int i = pos * cwio + cwi;
                       acc += __popc(word ^ last[i - pos0 * cwio]);
                       if (lane == 0) cur[i] = word;
                     });
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int d = 0;
    for (int w = 0; w < mm::kWarps; ++w) d += warp_sum[w];
    a.partial[static_cast<size_t>(b) * a.gate_blocks + g] = d;
  }
  if (g == 0) {
    const int nc = repro_torch::classes(s);
    for (int c = threadIdx.x; c < nc; c += blockDim.x) {
      a.logits[static_cast<size_t>(b) * nc + c] =
          a.llog[static_cast<size_t>(b) * nc + c];
    }
  }
}

__global__ void __launch_bounds__(repro_torch::kScanThreads)
change_scan_kernel(const __grid_constant__ DeltaArgs a) {
  const int thr = a.ctrl[0];
  const int n_real = a.ctrl[1];
  const int blocks = a.gate_blocks;
  for (int i = threadIdx.x; i < a.batch; i += repro_torch::kScanThreads) {
    const int32_t* p = a.partial + static_cast<size_t>(i) * blocks;
    int d = 0;
    for (int g = 0; g < blocks; ++g) d += p[g];
    a.deltas[i] = i < n_real ? d : 0;
  }
  __syncthreads();
  const int k = repro_torch::compact_in_order(
      [&](int i) { return i < n_real && a.deltas[i] >= thr; }, a.batch,
      a.queue);
  if (threadIdx.x == 0) {
    a.counts[0] = k;
    a.counts[1] = repro_torch::drain_slots(k, a.bpad, a.rb, a.check_every);
  }
}

__global__ void __launch_bounds__(mm::kThreads)
recompute_kernel(const __grid_constant__ DeltaArgs a) {
  extern __shared__ uint4 smem4[];
  const int cluster = a.geo.cluster;
  const int row = blockIdx.x / cluster;
  const int rank = mm::cluster_rank();
  const repro_torch::MemberSpec& s = a.spec;
  const int items = s.h * s.w * s.cwio;
  // new_last of stream row, split over the cluster's blocks
  const bool changed = row < a.ctrl[1] && a.deltas[row] >= a.ctrl[0];
  const uint32_t* src =
      changed ? a.cur + static_cast<size_t>(row) * a.cur_stride
              : a.last + static_cast<size_t>(row) * items;
  uint32_t* dst = a.new_last + static_cast<size_t>(row) * items;
  for (int i = rank * mm::kThreads + threadIdx.x; i < items;
       i += cluster * mm::kThreads) {
    dst[i] = src[i];
  }
  // the frame this queue row recomputes, the same in every block of the
  // cluster
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
  mm::run_frame<true>(
      s, a.img, a.geo, 0, nullptr, nullptr,
      a.cur + static_cast<size_t>(frame) * a.cur_stride,
      a.logits + static_cast<size_t>(frame) * repro_torch::classes(s),
      reinterpret_cast<uint32_t*>(smem4));
}

}  // namespace

// table: the one-member launch table (megakernel.cuh parse_table) and geo
// its cluster geometry (member_mma.cuh parse_geometry).  frames
// (B, H, W, Cin) int32; thr the member's float32 thermometer thresholds;
// the weight image cw/ct/cf/fw; last (B, H, W, cwio) words and llog (B, C)
// int32, the resident state; ctrl (2,) int32 on the device; scratch cur
// (B, cur_stride) words (16-byte aligned, cur_stride a multiple of 4) and
// partial (B, gate_blocks) int32; outputs logits (B, C), new_last
// (B, H, W, cwio), queue (B,), counts (2,), deltas (B,).
// bpad/rb/check_every: the drain schedule the bill follows (bpad =
// ceil(B / bb) * bb, 1 <= rb <= bpad).  gate_blocks, gate_pix_words and
// gate_smem: the gate's blocks a stream, the words of its pixel staging
// buffer and its dynamic shared memory bytes (gate_geometry).  Returns a
// CUDA error code: cudaErrorInvalidValue for arguments the kernels cannot
// take, cudaErrorInvalidConfiguration if no cluster fits the device, else
// the first launch error.
extern "C" int delta_launch(const void* frames, const void* thr,
                            const void* cw, const void* ct, const void* cf,
                            const void* fw, const void* last,
                            const void* llog, const void* ctrl, void* cur,
                            void* partial, void* logits, void* new_last,
                            void* queue, void* counts, void* deltas,
                            const int* table, int n_table, const int* geo,
                            int n_geo, int batch, int bpad, int rb,
                            int check_every, int gate_blocks,
                            int gate_pix_words, int gate_smem, int cur_stride,
                            void* stream) {
  repro_torch::LaunchTable t;
  DeltaArgs a{};
  if (!repro_torch::parse_table(table, n_table, &t) || t.n_members != 1 ||
      !mm::parse_geometry(geo, n_geo, t, &a.geo) || batch < 1 ||
      bpad < batch || rb < 1 || rb > bpad || check_every < 1 ||
      gate_blocks < 1 || gate_blocks > t.member[0].h * t.member[0].w ||
      gate_pix_words % 4 || cur_stride % 4 ||
      cur_stride < t.member[0].h * t.member[0].w * t.member[0].cwio) {
    return cudaErrorInvalidValue;
  }
  a.spec = t.member[0];
  a.img = {static_cast<const uint32_t*>(cw), static_cast<const int32_t*>(ct),
           static_cast<const int32_t*>(cf), static_cast<const uint32_t*>(fw),
           t.ftot, t.cwmax, t.ntot, t.kwmax};
  a.frames = static_cast<const int32_t*>(frames);
  a.thr = static_cast<const float*>(thr);
  a.last = static_cast<const uint32_t*>(last);
  a.llog = static_cast<const int32_t*>(llog);
  a.ctrl = static_cast<const int32_t*>(ctrl);
  a.cur = static_cast<uint32_t*>(cur);
  a.partial = static_cast<int32_t*>(partial);
  a.logits = static_cast<int32_t*>(logits);
  a.new_last = static_cast<uint32_t*>(new_last);
  a.queue = static_cast<int32_t*>(queue);
  a.counts = static_cast<int32_t*>(counts);
  a.deltas = static_cast<int32_t*>(deltas);
  a.batch = batch;
  a.bpad = bpad;
  a.rb = rb;
  a.check_every = check_every;
  a.gate_blocks = gate_blocks;
  a.gate_pix_words = gate_pix_words;
  a.cur_stride = cur_stride;

  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = repro_torch::allow_smem(gate_kernel, gate_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gate_kernel<<<dim3(static_cast<unsigned>(gate_blocks),
                     static_cast<unsigned>(batch)),
                mm::kThreads, gate_smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  change_scan_kernel<<<1, repro_torch::kScanThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mm::launch_clusters(
      recompute_kernel, a, dim3(static_cast<unsigned>(a.geo.cluster * batch)),
      a.geo.cluster, a.geo.smem_bytes, s));
}
