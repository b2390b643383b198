// Ordered compaction into a queue, and repro's drain bill, shared by the
// fused cascade's escalation scan (cascade.cu) and the delta gate's change
// scan (delta.cu).
//
// One block of kScanThreads threads walks the items in tiles of
// kScanThreads: each warp takes a ballot of its 32 predicates, warp 0 scans
// the 32 warp totals with shuffles, and every selected item lands at
// queue[base + warp offset + its rank in the ballot], so the queue holds the
// selected indices in ascending order.  The queue's rows from K on are
// zeroed.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "megakernel.cuh"

namespace repro_torch {

constexpr int kScanThreads = 1024;

// Writes the indices i in [0, n) with pred(i) to queue[0 .. K) in ascending
// order and zeros to queue[K .. n); returns K to every thread.  Every thread
// of a block of kScanThreads threads calls it; pred is called once per i < n.
template <typename Pred>
__device__ __forceinline__ int compact_in_order(Pred pred, int n,
                                                int32_t* __restrict__ queue) {
  __shared__ int warp_base[kScanThreads / 32];
  __shared__ int tile_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int base = 0;
  for (int t0 = 0; t0 < n; t0 += kScanThreads) {
    const int i = t0 + threadIdx.x;
    const bool take = i < n && pred(i);
    const uint32_t bal = __ballot_sync(kFullMask, take);
    if (lane == 0) warp_base[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {             // exclusive scan of the 32 warp totals
      const int v = warp_base[lane];
      int incl = v;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFullMask, incl, d);
        if (lane >= d) incl += y;
      }
      warp_base[lane] = incl - v;
      if (lane == 31) tile_total = incl;
    }
    __syncthreads();
    if (take) {
      queue[base + warp_base[warp] + __popc(bal & ((1u << lane) - 1u))] = i;
    }
    base += tile_total;
    __syncthreads();             // tile_total and warp_base are rewritten
  }
  for (int i = base + threadIdx.x; i < n; i += kScanThreads) queue[i] = 0;
  return base;
}

// The frame slots repro's bounded drain loop computes for a queue of k
// entries, which the serving layer bills: every chunk group g0 = 0,
// check_every, ... (n_chunks = ceil(bpad / rb) chunks of rb) with
// g0 * rb < k runs whole.
__host__ __device__ inline int drain_slots(int k, int bpad, int rb,
                                           int check_every) {
  const long long n_chunks = (bpad + rb - 1) / rb;
  long long slots = 0;
  for (long long g0 = 0; g0 < n_chunks; g0 += check_every) {
    if (g0 * rb < k) {
      const long long n = n_chunks - g0;
      slots += rb * (n < check_every ? n : check_every);
    }
  }
  return static_cast<int>(slots);
}

}  // namespace repro_torch
