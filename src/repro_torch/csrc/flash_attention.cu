// Flash-attention forward for Hopper (sm_90a): causal (or not) GQA
// attention with an online softmax, the S x S scores never leaving the SM.
//
// Replaces: repro/kernels/flash_attention.py:_flash_fwd_kernel (entry
// flash_attention_fwd): q (B, S, H, D), k and v (B, S, KH, D) -> o
// (B, S, H, D); s = (q . k) * scale in float32, the causal mask
// col <= row with -1e30 for masked scores, the running max m and sum l in
// float32, p rounded to v's type before p . v (p.astype(v.dtype)), float32
// accumulation, and o = acc / max(l, 1e-37) stored in q's type.  Head h
// reads KV head h / G, G = H / KH: the G query heads of one KV head are
// folded into the rows of a block, row = position * G + g, as the Pallas
// kernel folds them into its q-block rows.
//
// What bounds it on the H100, at SmolLM-360M's prefill (B=4, S=512,
// H=15, KH=5, D=64): 2.0 GFLOP of causal q.k and p.v.  In bfloat16 the
// 10.5 MB of q, k, v and o (3.1 us at 3.35 TB/s) outweigh the FLOPs at the
// tensor cores' 989 TFLOP/s (2.0 us); in float32, which has no tensor-core
// path without TF32, the FLOPs at 67 TFLOP/s (30 us) bound it.  Design,
// right and simple first: CUDA-core FP32 FMAs for both types (no TF32, so
// float32 meets 2e-5), one block per (batch x KV head, tile of 64 rows of
// (position, head-in-group)), any G since a row tile need not start at a
// position boundary.  The block stages its q rows once and then each 64-key
// tile of k and v in shared memory (as float32; bf16 products are exact in
// float32), and loops over the key tiles up to the causal diagonal of its
// last row: the TPU's sequential third grid axis becomes this loop, and the
// tiles above the diagonal, which add exactly nothing, are skipped.  Four
// threads own a row: each scores 16 of the tile's keys, the row's max and
// sum are shuffles among the four, and each keeps 16 or 32 of the D output
// accumulators (and m, l) in registers.  Shared rows are padded so the
// warp's accesses fall in distinct banks.  Tensor cores (mma.sync or
// wgmma), TMA and a tuned tiling are a later PR's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                  // (position, g) rows per block
constexpr int kKeys = 64;                  // keys per tile
constexpr int kTpr = 4;                    // threads per row
constexpr int kThreads = kRows * kTpr;
constexpr int kKeysPerThread = kKeys / kTpr;
constexpr int kPStride = kKeys + 4;        // 4 r + t: distinct banks
constexpr float kNegInf = -1e30f;          // NEG_INF of the Pallas kernel

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);                            // round to nearest even
}

// p.astype(v.dtype), back in float32 for the accumulation
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <int D>
constexpr int smem_floats() {
  return kRows * (D + 1) + kKeys * (D + 1) + kKeys * D + kRows * kPStride;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int s, int h,
                 int kh, float scale, int causal) {
  constexpr int kStride = D + 1;
  constexpr int kDpt = D / kTpr;           // output dims per thread
  extern __shared__ float smem[];
  float* q_s = smem;                       // kRows x (D + 1)
  float* k_s = q_s + kRows * kStride;      // kKeys x (D + 1)
  float* v_s = k_s + kKeys * kStride;      // kKeys x D
  float* p_s = v_s + kKeys * D;            // kRows x kPStride

  const int g = h / kh;
  const int b = blockIdx.y / kh;
  const int head = blockIdx.y % kh;
  const long rows = static_cast<long>(s) * g;
  const long r0 = static_cast<long>(blockIdx.x) * kRows;
  const int tid = threadIdx.x;
  const int r = tid / kTpr;
  const int t = tid % kTpr;
  const long row = r0 + r;
  const bool row_ok = row < rows;
  const int qpos = row_ok ? static_cast<int>(row / g) : s - 1;

  // this block's q rows: row (pos, gg) is q[b, pos, head * G + gg, :]
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int rr = i / D;
    const int d = i - rr * D;
    const long ri = r0 + rr;
    float x = 0.0f;
    if (ri < rows) {
      const long pos = ri / g;
      const long gg = ri - pos * g;
      x = to_float(q[((static_cast<long>(b) * s + pos) * h + head * g + gg)
                     * D + d]);
    }
    q_s[rr * kStride + d] = x;
  }

  // keys this block can see: up to the diagonal of its last row
  const long last = (r0 + kRows < rows ? r0 + kRows : rows) - 1;
  const int n_keys = causal ? static_cast<int>(last / g) + 1 : s;

  float m = kNegInf;
  float l = 0.0f;
  float acc[kDpt];
#pragma unroll
  for (int i = 0; i < kDpt; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    __syncthreads();                       // the last tile's readers are done
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      const int key = k0 + j;
      float kx = 0.0f;
      float vx = 0.0f;
      if (key < s) {
        const long off = ((static_cast<long>(b) * s + key) * kh + head) * D + d;
        kx = to_float(k[off]);
        vx = to_float(v[off]);
      }
      k_s[j * kStride + d] = kx;
      v_s[j * D + d] = vx;
    }
    __syncthreads();

    // scores of this thread's keys t, t + 4, ..., float32 FMAs
    float sc[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) sc[i] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qd = q_s[r * kStride + d];
#pragma unroll
      for (int i = 0; i < kKeysPerThread; ++i)
        sc[i] = fmaf(qd, k_s[(t + kTpr * i) * kStride + d], sc[i]);
    }
    float tile_max = kNegInf;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int key = k0 + t + kTpr * i;
      const bool ok = key < s && (!causal || key <= qpos);
      sc[i] = ok ? sc[i] * scale : kNegInf;
      tile_max = fmaxf(tile_max, sc[i]);
    }
    // the row's four threads are neighbouring lanes of one warp
#pragma unroll
    for (int off = 1; off < kTpr; off <<= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const float p = expf(sc[i] - m_new);
      psum += p;
      p_s[r * kPStride + t + kTpr * i] = round_to<T>(p);
    }
#pragma unroll
    for (int off = 1; off < kTpr; off <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();                          // the row's p, written in-warp

#pragma unroll
    for (int i = 0; i < kDpt; ++i) acc[i] *= alpha;
    for (int j = 0; j < kKeys; ++j) {
      const float pj = p_s[r * kPStride + j];
#pragma unroll
      for (int i = 0; i < kDpt; ++i)
        acc[i] = fmaf(pj, v_s[j * D + t + kTpr * i], acc[i]);
    }
  }

  if (row_ok) {
    const long pos = row / g;
    const long gg = row - pos * g;
    T* out = o + ((static_cast<long>(b) * s + pos) * h + head * g + gg) * D;
    const float denom = fmaxf(l, 1e-37f);
#pragma unroll
    for (int i = 0; i < kDpt; ++i)
      out[t + kTpr * i] = from_float<T>(acc[i] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s, int h, int kh, float scale, int causal,
           cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  // the >48 KB opt-in is per device: set on every launch
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long rows = static_cast<long>(s) * (h / kh);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows),
                  static_cast<unsigned>(b * kh));
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, h, kh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int s, int h, int kh, int d, float scale, int causal,
             cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, o, b, s, h, kh, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, s, h, kh, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, S, H, D), k and v (B, S, KH, D), o (B, S, H, D), all contiguous
// and of one type (float32, or bfloat16 when bf16 != 0), H % KH == 0,
// D in {64, 128} (checked by the Python wrapper).  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int s,
                                      int h, int kh, int d, int bf16,
                                      float scale, int causal, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, b, s, h, kh, d, scale, causal,
                                   st);
  return launch_d<float>(q, k, v, o, b, s, h, kh, d, scale, causal, st);
}
