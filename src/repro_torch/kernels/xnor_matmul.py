"""Packed XNOR-popcount binary matmul: CUDA kernel and plain version.

The counterpart of ``repro.kernels.xnor_matmul``:
``out[m, n] = K - 2 * popcount(a[m] ^ w[n])`` over 32-bit words, and the
``pack_out`` variant that signs the sums and packs them along N.  The
kernel is ``csrc/xnor_matmul.cu``; :func:`xnor_matmul_plain` is the same
function in PyTorch, which the CPU path and the tests use.  Both
variants are one binary GEMM on the tensor cores (``mma.sync.m16n8k256
.b1``) whose launch geometry is :func:`xnor_tiles`; the packed variant's
epilogue signs the sums and packs them a word of 32 columns at a time, so
its warps take strips of whole words (``PACK_WARP_TILES``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.binarize import (PACK_WIDTH, pack_bit_lanes,
                                       xnor_dot_popcount)
from repro_torch.kernels import _build
from repro_torch.kernels.binary_conv2x2_block import sm_count

WARPS = 8                    # csrc/xnor_matmul.cu: kWarps
STEP_WORDS = 8               # 256 K bits a mma.sync m16n8k256 step
KCHUNK = 4                   # K steps a staged chunk, the most (a power
                             # of 2; launch/time_packed.py --sweep)
WARP_TILES = (1, 2, 4, 5, 8)  # n8 tiles a warp: the kernel's instantiations
PACK_WARP_TILES = (4, 8)     # the packed variant's: strips of whole words
SMEM_DEFAULT = 48 * 1024     # shared memory a block has without the opt-in
GRID_M_LIMIT = 65535         # gridDim.y
SMS = 132                    # H100 SXM

# kernel launches since the last reset, per kernel (not per variant call)
LAUNCHES = {"xnor_matmul": 0, "xnor_matmul_pack": 0}
# xnor_matmul_launch: a, w, out; m, n, kw, k, pack_out, XnorTiles.args, the
# copy width, the grid and shared memory; the stream
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 15 + [ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class XnorTiles:
    """Launch geometry of the tensor-core kernel (see xnor_tiles);
    the kernel takes it as it is (csrc/xnor_matmul.cu Tiles) and computes
    none of it."""
    tn: int              # n8 tiles a warp (a warp: one m16 x 8 tn strip)
    wm: int              # warps along M (a block: 16 wm rows)
    wn: int              # warps along N (a block: 8 tn wn columns)
    kchunk: int          # 256-bit K steps a staged chunk
    nchunks: int         # chunks: ceil(ksteps / kchunk)
    kstride: int         # words a staged row (8 mod 16)
    grid: tuple          # (N tiles, M tiles)
    smem: int            # dynamic shared memory bytes a block

    @property
    def bm(self) -> int:
        return 16 * self.wm

    @property
    def bn(self) -> int:
        return 8 * self.tn * self.wn

    @property
    def args(self) -> tuple:
        """The C entry point's geometry arguments, in its order (the copy
        width, which depends on the operands, goes after)."""
        return (self.tn, self.wm, self.wn, self.kchunk, self.nchunks,
                self.kstride)


def make_tiles(m: int, n: int, kw: int, wm: int, tn: int,
               kchunk: int = KCHUNK) -> XnorTiles:
    """The geometry of ``wm`` x (WARPS / wm) warps of m16 x n(8 tn) strips
    on an (M, N, Kw) product, K staged ``kchunk`` steps at a time (a power
    of 2; the least power of 2 that holds all of K when K has fewer steps),
    double-buffered when it has more than one chunk."""
    ksteps = -(-kw // STEP_WORDS)
    while kchunk > 1 and kchunk // 2 >= ksteps:
        kchunk //= 2
    nchunks = -(-ksteps // kchunk)
    kstride = kchunk * STEP_WORDS + (8 if kchunk % 2 == 0 else 0)
    wn = WARPS // wm
    bm, bn = 16 * wm, 8 * tn * wn
    smem = 4 * (2 if nchunks > 1 else 1) * (bm + bn) * kstride
    return XnorTiles(tn, wm, wn, kchunk, nchunks, kstride,
                     (-(-n // bn), -(-m // bm)), smem)


@functools.lru_cache(maxsize=None)
def xnor_tiles(m: int, n: int, kw: int, sms: int = SMS,
               pack: bool = False) -> XnorTiles:
    """Block tile, K chunking and shared memory of one launch; ``pack``
    (the packed variant) takes only ``PACK_WARP_TILES``, so every warp's
    strip, and every block's, starts at a multiple of 32 columns and holds
    whole words.

    A block of ``WARPS`` warps, ``wm`` along M and ``wn`` along N, computes
    a (16 wm) x (8 tn wn) tile; a warp row wholly past M is never taken
    (so M <= 16 is one block along M).  Of the tiles whose staged chunks
    fit the default 48 KB, the one with the least work on the busiest SM
    wins (waves over ``sms`` SMs x the tile's outputs), then the fewest
    blocks, then the fewest staged rows: at BitLinear's 256 x 2560, 64 x 80
    tiles, 128 blocks in one wave.  The packed variant breaks a tie on work
    by the least work over all blocks (its strips of whole words overhang a
    small N), then toward more blocks: at 256 x 2560 (K=960) 160 blocks of
    64 x 64, two on some SMs, each hiding the other's latency, took 0.00437
    ms against 0.00477 for 80 of 64 x 128 (``launch/time_packed.py
    --sweep`` on an H100).  K is staged ``KCHUNK`` steps at a time
    (its four steps at BitLinear in one chunk), or, where no tile's
    double-buffered chunks fit at that (the packed variant's wide strips
    at a small M and a long K), half as many, down to one.
    """
    kchunk = KCHUNK
    while True:
        best = None
        for wm in (1, 2, 4, 8):
            if 16 * (wm - 1) >= m:
                break
            for tn in PACK_WARP_TILES if pack else WARP_TILES:
                t = make_tiles(m, n, kw, wm, tn, kchunk)
                if t.smem > SMEM_DEFAULT or t.grid[1] > GRID_M_LIMIT:
                    continue
                blocks = t.grid[0] * t.grid[1]
                work = t.bm * t.bn
                key = ((-(-blocks // sms) * work, blocks * work, -blocks,
                        t.bm + t.bn) if pack else
                       (-(-blocks // sms) * work, blocks, t.bm + t.bn))
                if best is None or key < best[0]:
                    best = (key, t)
        if best is not None:
            return best[1]
        if kchunk == 1:
            raise ValueError(f"no tile fits M={m}, N={n}")
        kchunk //= 2


def copy_words(kw: int, *ptrs: int) -> int:
    """Words a cp.async stages (4, 2 or 1): the widest that divides Kw and
    keeps every operand's rows aligned to its bytes."""
    for cpw in (4, 2):
        if kw % cpw == 0 and all(p % (4 * cpw) == 0 for p in ptrs):
            return cpw
    return 1


def xnor_matmul_plain(a_words: torch.Tensor, w_words: torch.Tensor, k: int,
                      *, pack_out: bool = False) -> torch.Tensor:
    """Plain PyTorch version: (M, Kw) x (N, Kw) words -> (M, N) int32
    sums, or (M, N // 32) sign words when ``pack_out``."""
    s = xnor_dot_popcount(a_words[:, None, :], w_words[None, :, :], k)
    if pack_out:
        return pack_bit_lanes(s < 0)
    return s


def check_args(a_words: torch.Tensor, w_words: torch.Tensor, k: int,
               pack_out: bool) -> None:
    """Raise on operands neither version takes."""
    for name, t in (("a_words", a_words), ("w_words", w_words)):
        if t.dtype != torch.int32 or t.ndim != 2:
            raise ValueError(f"{name} must be a 2-D int32 word tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if a_words.device != w_words.device:
        raise ValueError(f"operands on {a_words.device} and {w_words.device}")
    (m, kw), (n, kw2) = a_words.shape, w_words.shape
    if kw != kw2:
        raise ValueError(f"word counts differ: {kw} vs {kw2}")
    if not 0 < k <= kw * PACK_WIDTH:
        raise ValueError(f"k={k} does not fit {kw} words")
    if pack_out and n % PACK_WIDTH:
        raise ValueError(f"pack_out needs N % {PACK_WIDTH} == 0, got N={n}")
    if m < 1 or n < 1:
        raise ValueError(f"empty product: M={m}, N={n}")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("xnor_matmul").xnor_matmul_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def xnor_matmul(a_words: torch.Tensor, w_words: torch.Tensor, k: int, *,
                pack_out: bool = False,
                tiles: XnorTiles = None) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (raises on any other device).

    a_words: (M, Kw) int32 words; w_words: (N, Kw) int32 words; k: the
    true channel count.  Returns (M, N) int32, or (M, N // 32) int32 words
    when ``pack_out``.  ``tiles`` overrides :func:`xnor_tiles` (a
    :func:`make_tiles` geometry, for tile sweeps; with ``pack_out`` its tn
    must be one of ``PACK_WARP_TILES``).
    """
    check_args(a_words, w_words, k, pack_out)
    if a_words.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{a_words.device}")
    a = a_words.contiguous()
    w = w_words.contiguous()
    (m, kw), n = a.shape, w.shape[0]
    out = torch.empty((m, n // PACK_WIDTH if pack_out else n),
                      dtype=torch.int32, device=a.device)
    t = tiles or xnor_tiles(m, n, kw, sm_count(a.device), pack_out)
    geometry = (*t.args, copy_words(kw, a.data_ptr(), w.data_ptr()),
                *t.grid, t.smem)
    with torch.cuda.device(a.device):
        err = _launcher()(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n,
                          kw, k, int(pack_out), *geometry,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"xnor_matmul launch failed: CUDA error {err}")
    LAUNCHES["xnor_matmul_pack" if pack_out else "xnor_matmul"] += 1
    return out
