// Flash-attention forward for Hopper (sm_90a): causal (or not) GQA
// attention with an online softmax, the S x S scores never leaving the SM.
//
// Replaces: repro/kernels/flash_attention.py:_flash_fwd_kernel (entry
// flash_attention_fwd): q (B, S, H, D), k and v (B, S, KH, D) -> o
// (B, S, H, D); s = (q . k) * scale in float32, the causal mask
// col <= row with -1e30 for masked scores, the running max m and sum l in
// float32, float32 accumulation of p . v, and o = acc / max(l, 1e-37)
// stored in q's type.  Head h reads KV head h / G, G = H / KH: the G query
// heads of one KV head are folded into the rows of a block, row =
// position * G + g, as the Pallas kernel folds them into its q-block rows.
// The probability type is the caller's (bf16_probs): 1 rounds p and v to
// bf16 before p . v (the Pallas kernel's p.astype(v.dtype) for bf16
// inputs, chunked_attention's probs_bf16=True); 0 keeps p in float32
// (chunked_attention's probs_bf16=False, and p.astype(float32)).
//
// What bounds it on the H100, at SmolLM-360M's prefill (B=4, S=512,
// H=15, KH=5, D=64): 2.0 GFLOP of causal q.k and p.v.  In bfloat16 the
// 10.5 MB of q, k, v and o (3.1 us at 3.35 TB/s) outweigh the FLOPs at the
// tensor cores' 989 TFLOP/s (2.0 us); in float32, which has no tensor-core
// path without TF32, the FLOPs at 67 TFLOP/s (30 us) bound it.
//
// bfloat16 runs on the tensor cores (flash_fwd_mma).  One block of four
// warps per (batch x KV head, tile of 64 rows of (position, g)), each warp
// owning 16 rows, any G since a row tile (or a warp's 16 rows) need not
// start at a position boundary: the causal mask takes qpos = row / G per
// row.  The row tiles launch heaviest first (the grid's slow axis runs
// them in reverse), so the causal triangle leaves a short tail.  q . k and
// p . v are mma.sync.m16n8k16 (bf16 in, float32 accumulate): q's A
// fragments come from ldmatrix once per block, k's B fragments from
// ldmatrix and v's from ldmatrix.trans; the scores stay in the accumulator
// fragments, where the online softmax runs in log2 units on the SFU's
// ex2 (a row's max and sum reduce as trees, then shuffles within the quad
// of lanes that hold it), and p goes back into A fragments in registers.
// Float32 p is carried as p_hi + p_lo, two bf16 halves (p_lo =
// bf16(p - p_hi)), accumulated by two MMAs into one float32 accumulator:
// p's relative error is then about 2^-17, far below the output's bf16
// rounding, at twice the p . v MMAs.  K and V tiles of 64
// keys are double-buffered in shared memory by 16-byte cp.async (keys at
// or past S zero-filled and scored -1e30), tile k + 1 in flight while tile
// k computes; rows are padded by 16 bytes, so each ldmatrix phase's eight
// rows fall in distinct banks.  The output goes back through the warp's
// own q rows in shared memory and leaves in 16-byte stores; rows at or
// past S * G store nothing.  134 registers a thread (130 with bf16 p)
// leave room for three blocks an SM.  Measured at SmolLM's prefill
// (chip_smoke.py phase 7, PERF.md): the kernel is far from both bounds; a
// block alone on an SM takes 1.46 us a key tile, and three blocks an SM
// raise the SM's rate only 1.4x, so each warp's chain of q.k MMAs,
// softmax and p.v MMAs sets the time.  Four blocks an SM (fewer
// registers), 32 rows a warp, three stages with one barrier a tile, and
// tile t + 1's q.k issued before tile t's softmax were each no faster;
// wgmma with a TMA producer warp is the next step (ROADMAP 2.2).
//
// float32 keeps CUDA-core FP32 FMAs (flash_fwd_f32; TF32 would miss
// repro's 2e-5): four threads own a row, each scoring 16 of a 64-key
// tile's keys; q, k and v are staged in shared memory (v rounded to bf16
// there when bf16_probs asks), the row's max and sum are shuffles among
// the four, and each keeps D / 4 output accumulators in registers.
//
// Both are instantiated at D = 16, 32, 64 and 128: the full configs' 64
// and 128 and the scaled() configs' 16 and 32.  The wrapper refuses any
// other D on the card (qwen1.5-110b's scaled() 8 is below one k16 step of
// the MMA), so a prefill never leaves this kernel silently.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kRows = 64;                  // (position, g) rows per block
constexpr int kKeys = 64;                  // keys per tile
constexpr float kNegInf = -1e30f;          // NEG_INF of the Pallas kernel
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// to bf16 (round to nearest even) and back
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int kTpr = 4;                    // threads per row
constexpr int kThreads = kRows * kTpr;
constexpr int kKeysPerThread = kKeys / kTpr;
constexpr int kPStride = kKeys + 4;        // 4 r + t: distinct banks

template <int D>
constexpr int f32_smem_bytes() {
  return (kRows * (D + 1) + kKeys * (D + 1) + kKeys * D + kRows * kPStride)
         * static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int s,
              int h, int kh, float scale, int causal, int bf16_probs) {
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
      x = q[((static_cast<long>(b) * s + pos) * h + head * g + gg) * D + d];
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
        kx = k[off];
        vx = bf16_probs ? bf16_round(v[off]) : v[off];
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
      p_s[r * kPStride + t + kTpr * i] = bf16_probs ? bf16_round(p) : p;
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
    float* out = o + ((static_cast<long>(b) * s + pos) * h + head * g + gg) * D;
    const float denom = fmaxf(l, 1e-37f);
#pragma unroll
    for (int i = 0; i < kDpt; ++i) out[t + kTpr * i] = acc[i] / denom;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async double buffering
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;                  // 16 rows each
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kPad = 8;                    // bf16 padding a shared row (16 B)

template <int D>
constexpr int mma_smem_bytes() {           // q (the output later), 2 K, 2 V
  return (kRows + 4 * kKeys) * (D + kPad) * static_cast<int>(sizeof(bf16));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !ok (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr,
                                              unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// 2^x on the SFU (one MUFU.EX2; relative error about 2^-22, inputs below
// -126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 x) {
  unsigned u;
  memcpy(&u, &x, sizeof(u));
  return u;
}

// (x0, x1) as bf16 pairs, x0 in the low half: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_pair(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  hi = bits(h2);
  lo = bits(__floats2bfloat162_rn(x0 - __low2float(h2),
                                  x1 - __high2float(h2)));
}

template <int D, bool kSplit>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int s, int h,
              int kh, float scale_log2, int causal) {
  constexpr int kStride = D + kPad;        // a shared row, in bf16
  constexpr int kChunks = D / 8;           // 16-byte chunks a row
  constexpr int kTile = kKeys * kStride;
  constexpr int kDTiles = D / 8;           // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // kRows rows; the output
  bf16* k_s = q_s + kRows * kStride;              // 2 stages
  bf16* v_s = k_s + 2 * kTile;                    // 2 stages

  const int g = h / kh;
  const int b = blockIdx.x / kh;
  const int head = blockIdx.x % kh;
  const long tile = static_cast<long>(gridDim.y) - 1 - blockIdx.y;
  const long rows = static_cast<long>(s) * g;
  const long r0 = tile * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  auto q_off = [&](long row) {             // q / o offset of a folded row
    const long pos = row / g;
    return ((static_cast<long>(b) * s + pos) * h + head * g + (row - pos * g))
           * D;
  };

  for (int i = tid; i < kRows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const bool ok = r0 + r < rows;
    cp_async16(smem_addr(q_s + r * kStride + c * 8),
               q + (ok ? q_off(r0 + r) : 0) + c * 8, ok);
  }

  // keys this block can see: up to the diagonal of its last row
  const long last = (r0 + kRows < rows ? r0 + kRows : rows) - 1;
  const int n_keys = causal ? static_cast<int>(last / g) + 1 : s;
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  const int first_pos = static_cast<int>(r0 / g);

  auto load_kv = [&](int t) {
    const int k0 = t * kKeys;
    bf16* ks = k_s + (t & 1) * kTile;
    bf16* vs = v_s + (t & 1) * kTile;
    for (int i = tid; i < kKeys * kChunks; i += kMmaThreads) {
      const int j = i / kChunks;
      const int c = i - j * kChunks;
      const bool ok = k0 + j < s;
      const long off = ok ? ((static_cast<long>(b) * s + k0 + j) * kh + head)
                            * D + c * 8 : 0;
      cp_async16(smem_addr(ks + j * kStride + c * 8), k + off, ok);
      cp_async16(smem_addr(vs + j * kStride + c * 8), v + off, ok);
    }
  };

  load_kv(0);
  cp_async_commit();                       // group 0: q and tile 0

  // this thread's rows of the warp's 16: lane / 4 and lane / 4 + 8
  const int wrow = warp * 16 + lane / 4;
  const int qpos[2] = {static_cast<int>((r0 + wrow) / g),
                       static_cast<int>((r0 + wrow + 8) / g)};
  const int quad = 2 * (lane % 4);         // this thread's first column
  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8
  const int lm_row = (lane % 8) + ((lane / 8) % 2) * 8;
  const int lm_col = (lane / 16) * 8;
  const int lk_row = (lane % 8) + (lane / 16) * 8;
  const int lk_col = ((lane / 8) % 2) * 8;

  unsigned qf[D / 16][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};               // this thread's columns only

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {                 // its stage was freed last tile
      load_kv(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        ldsm_x4(smem_addr(q_s + (warp * 16 + lm_row) * kStride + kd * 16
                          + lm_col), qf[kd]);
    }
    const bf16* ks = k_s + (t & 1) * kTile;
    const bf16* vs = v_s + (t & 1) * kTile;

    // s = q . k^T: 16 rows x 64 keys a warp, 8 n-tiles of 8 keys
    float sc[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[n][c] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j) {
        unsigned kb[4];
        ldsm_x4(smem_addr(ks + (j * 16 + lk_row) * kStride + kd * 16
                          + lk_col), kb);
        mma_bf16(sc[2 * j], qf[kd], kb[0], kb[1]);
        mma_bf16(sc[2 * j + 1], qf[kd], kb[2], kb[3]);
      }
    }

    // scale (log2 units), mask where the tile crosses S or the diagonal
    const int k0 = t * kKeys;
    const bool need_mask = k0 + kKeys > s
                           || (causal && k0 + kKeys - 1 > first_pos);
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = sc[n][c] * scale_log2;
        if (need_mask) {
          const int key = k0 + n * 8 + quad + (c & 1);
          const bool ok = key < s && (!causal || key <= qpos[c / 2]);
          x = ok ? x : kNegInf;
        }
        sc[n][c] = x;
      }

    // online softmax on the fragments: a row's 64 scores are spread over
    // the four lanes of a quad, 16 each
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx[kKeys / 8];                 // a tree, not a chain
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
        mx[n] = fmaxf(sc[n][2 * i], sc[n][2 * i + 1]);
#pragma unroll
      for (int w = kKeys / 16; w > 0; w /= 2)
#pragma unroll
        for (int n = 0; n < w; ++n) mx[n] = fmaxf(mx[n], mx[n + w]);
      float row_max = fmaxf(m[i], mx[0]);
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
      alpha[i] = exp2_approx(m[i] - row_max);
      m[i] = row_max;
    }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= alpha[c / 2];
    float ps[kKeys / 8][2];                // per-n-tile row sums
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sc[n][2 * i] = exp2_approx(sc[n][2 * i] - m[i]);
        sc[n][2 * i + 1] = exp2_approx(sc[n][2 * i + 1] - m[i]);
        ps[n][i] = sc[n][2 * i] + sc[n][2 * i + 1];
      }
#pragma unroll
    for (int w = kKeys / 16; w > 0; w /= 2)
#pragma unroll
      for (int n = 0; n < w; ++n) {
        ps[n][0] += ps[n + w][0];
        ps[n][1] += ps[n + w][1];
      }
    l[0] = l[0] * alpha[0] + ps[0][0];
    l[1] = l[1] * alpha[1] + ps[0][1];

    // acc += p . v: p's accumulator fragments are the A fragments of the
    // next product (keys 16 kk .. 16 kk + 15 are n-tiles 2 kk, 2 kk + 1)
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      unsigned hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* pp = &sc[2 * kk + i / 2][2 * (i % 2)];
        if (kSplit) {
          split_pair(pp[0], pp[1], hi[i], lo[i]);
        } else {
          hi[i] = bits(__floats2bfloat162_rn(pp[0], pp[1]));
        }
      }
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        unsigned vb[4];
        ldsm_x4_trans(smem_addr(vs + (kk * 16 + lm_row) * kStride + j * 16
                                + lm_col), vb);
        mma_bf16(acc[2 * j], hi, vb[0], vb[1]);
        mma_bf16(acc[2 * j + 1], hi, vb[2], vb[3]);
        if (kSplit) {
          mma_bf16(acc[2 * j], lo, vb[0], vb[1]);
          mma_bf16(acc[2 * j + 1], lo, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();                       // this stage's readers are done
  }

  // o = acc / max(l, 1e-37), staged through the warp's own q rows
  float denom[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    denom[i] = fmaxf(sum, 1e-37f);
  }
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(
          q_s + (wrow + 8 * i) * kStride + n * 8 + quad) =
          __floats2bfloat162_rn(acc[n][2 * i] / denom[i],
                                acc[n][2 * i + 1] / denom[i]);
    }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = warp * 16 + i / kChunks;
    const int c = i % kChunks;
    if (r0 + r < rows)
      *reinterpret_cast<uint4*>(o + q_off(r0 + r) + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + r * kStride + c * 8);
  }
}

// the >48 KB opt-in is per device: set on every launch that needs it
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int s, int h, int kh, float scale, int causal, int bf16_probs,
               cudaStream_t stream) {
  const int bytes = f32_smem_bytes<D>();
  const cudaError_t err = allow_smem(flash_fwd_f32<D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long rows = static_cast<long>(s) * (h / kh);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows),
                  static_cast<unsigned>(b * kh));
  flash_fwd_f32<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s, h, kh, scale,
      causal, bf16_probs);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kSplit>
int launch_mma(const void* q, const void* k, const void* v, void* o, int b,
               int s, int h, int kh, float scale, int causal,
               cudaStream_t stream) {
  const int bytes = mma_smem_bytes<D>();
  const cudaError_t err = allow_smem(flash_fwd_mma<D, kSplit>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long rows = static_cast<long>(s) * (h / kh);
  // (batch x KV head, row tile): the slow axis runs the tiles in reverse
  const dim3 grid(static_cast<unsigned>(b * kh),
                  static_cast<unsigned>((rows + kRows - 1) / kRows));
  flash_fwd_mma<D, kSplit><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), s, h, kh,
      scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int s, int h, int kh, float scale, int causal, int bf16_probs,
                cudaStream_t stream) {
  if (bf16_probs)
    return launch_mma<D, false>(q, k, v, o, b, s, h, kh, scale, causal,
                                stream);
  return launch_mma<D, true>(q, k, v, o, b, s, h, kh, scale, causal, stream);
}

}  // namespace

// q (B, S, H, D), k and v (B, S, KH, D), o (B, S, H, D), all contiguous
// and of one type (float32, or bfloat16 when bf16 != 0, then 16-byte
// aligned), H % KH == 0, D in {16, 32, 64, 128} (checked by the Python
// wrapper).
// bf16_probs != 0 rounds p and v to bf16 before p . v.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int s,
                                      int h, int kh, int d, int bf16,
                                      float scale, int causal,
                                      int bf16_probs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bf16 ? d : -d) {
    case 16:
      return launch_bf16<16>(q, k, v, o, b, s, h, kh, scale, causal,
                             bf16_probs, st);
    case 32:
      return launch_bf16<32>(q, k, v, o, b, s, h, kh, scale, causal,
                             bf16_probs, st);
    case 64:
      return launch_bf16<64>(q, k, v, o, b, s, h, kh, scale, causal,
                             bf16_probs, st);
    case 128:
      return launch_bf16<128>(q, k, v, o, b, s, h, kh, scale, causal,
                              bf16_probs, st);
    case -16:
      return launch_f32<16>(q, k, v, o, b, s, h, kh, scale, causal,
                            bf16_probs, st);
    case -32:
      return launch_f32<32>(q, k, v, o, b, s, h, kh, scale, causal,
                            bf16_probs, st);
    case -64:
      return launch_f32<64>(q, k, v, o, b, s, h, kh, scale, causal,
                            bf16_probs, st);
    case -128:
      return launch_f32<128>(q, k, v, o, b, s, h, kh, scale, causal,
                             bf16_probs, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
