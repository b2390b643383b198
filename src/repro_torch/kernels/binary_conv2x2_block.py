"""Fused packed conv layer: CUDA kernel and plain version.

The counterpart of ``repro.kernels.binary_conv2x2_block``: a 2x2 stride-1
XNOR-popcount convolution, the folded integer comparator
``(s >= tau) XOR flip``, an optional 2x2/2 max-pool in the sign domain
(AND of the sign bits) and the repack to 32 neurons per word.  Packed
words in, packed words out.  The kernel is ``csrc/conv_block.cu``;
:func:`conv_block_body` (with :func:`accumulate_tap_popcounts`) is the
same function in PyTorch, which the CPU path, the plain megakernel and the
tests use.  :func:`conv_tiles` is the launch geometry of this kernel and of
the unfused ``csrc/binary_conv2x2.cu``, which share the tensor-core tile
``csrc/conv_mma.cuh``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.binarize import PACK_WIDTH, pack_bit_lanes, popcount32
from repro_torch.kernels import _build

MAX_CHANNEL_WORDS = 8        # 256 channels, the chip's widest map
WARPS = 8                    # conv_mma.cuh: kWarps, one m16 tile each
STEP_WORDS = 8               # 256 K bits a mma.sync m16n8k256 step
SMEM_LIMIT = 232_448         # 227 KB, the most a block can opt in to
SMEM_DEFAULT = 48 * 1024     # without the opt-in
SMS = 132                    # H100 SXM

# kernel launches since the last reset
LAUNCHES = {"conv_block": 0}
# conv_block_launch: a, w, tau, flip, out; b, h, wd, cw, f, k4, pool and
# ConvTiles.args; the stream
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 18 + [ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class ConvTiles:
    """Launch geometry of the conv_mma.cuh kernels (see conv_tiles); the
    kernels take it as it is (conv_mma.cuh Geometry) and compute none of
    it."""
    rows: int            # output rows a band (pooled rows with pool)
    bands: int           # bands a frame
    cols: int            # output columns a band (pooled with pool)
    chunks: int          # bands a band row: ceil(Wo / cols)
    nslices: int         # 32-feature slices a block
    grid: tuple          # (B * bands * chunks, feature tiles)
    ksteps: int          # 256-bit K steps: ceil(4 Cw / 8 words)
    kstride: int         # words a staged feature row (8 mod 16)
    in_cols: int         # input columns a band stages
    pitch: int           # words a staged input row (= W Cw mod 4)
    smem: int            # dynamic shared memory bytes a block

    @property
    def args(self) -> tuple:
        """The C entry points' geometry arguments, in their order."""
        return (self.rows, self.bands, self.cols, self.chunks, self.nslices,
                self.ksteps, self.kstride, self.in_cols, self.pitch,
                self.grid[1], self.smem)


def conv_out(h: int, wd: int, pool: bool):
    """Output rows and columns: (H-1, W-1), or (H-1)//2 x (W-1)//2 pooled
    (the odd trailing conv row and column are never read)."""
    return ((h - 1) // 2, (wd - 1) // 2) if pool else (h - 1, wd - 1)


@functools.lru_cache(maxsize=None)
def conv_tiles(b: int, h: int, wd: int, f: int, cw: int, pool: bool, *,
               sms: int = SMS) -> ConvTiles:
    """Bands, feature tiles and shared memory of one conv launch.

    A block computes one band of ``rows`` output rows of one frame (rows
    enough for one m16 tile a warp, 8 x 16 product rows; a pooled row is
    4 product rows a window) against ``nslices`` x 32 features.  Feature
    tiles are as wide as leaves a block for every SM (else one slice), and
    shared memory within the default 48 KB; bands shrink until the
    block's taps and input rows fit 227 KB, and where one whole input row
    does not, a band is one output row cut into ``chunks`` runs of
    ``cols`` columns, so any width runs.
    """
    ho, wo = conv_out(h, wd, pool)
    fslices = -(-f // 32)
    ksteps = -(-4 * cw // STEP_WORDS)
    kpad = ksteps * STEP_WORDS
    kstride = kpad + 8 if kpad % 16 == 0 else kpad

    def span(n: int) -> int:                 # input rows (columns) n read
        return 2 * n + 1 if pool else n + 1

    def smem(rows: int, ns: int, pitch: int) -> int:  # taps, tau, flip, band
        return 4 * (32 * ns * (kstride + 2) + span(rows) * pitch + 3)

    full = wd * cw
    rows = max(1, min(ho, WARPS * 16 // max(1, wo * (4 if pool else 1))))
    ns = 1
    for cand in (8, 4, 2):
        if (cand <= fslices and smem(rows, cand, full) <= SMEM_DEFAULT
                and b * -(-ho // rows) * -(-fslices // cand) >= sms):
            ns = cand
            break
    while smem(rows, ns, full) > SMEM_LIMIT and rows > 1:
        rows -= 1
    cols, chunks, in_cols, pitch = wo, 1, wd, full
    if smem(rows, ns, full) > SMEM_LIMIT:    # column chunks of one row
        room = (SMEM_LIMIT // 4 - 3 - 32 * ns * (kstride + 2)) // span(1)
        cols = ((room - 3) // cw - 1) // (2 if pool else 1)
        if cols < 1:
            raise ValueError(f"{cw} channel words do not fit one band in "
                             f"shared memory")
        chunks = -(-wo // cols)
        cols = -(-wo // chunks)
        in_cols = span(cols)
        pitch = in_cols * cw + (full - in_cols * cw) % 4
    bands = -(-ho // rows) if ho > 0 and wo > 0 else 0
    return ConvTiles(rows, bands, cols, chunks, ns,
                     (b * bands * chunks, -(-fslices // ns)), ksteps,
                     kstride, in_cols, pitch, smem(rows, ns, pitch))


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t contiguous with a 16-byte aligned start (the kernels' cp.async)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def accumulate_tap_popcounts(a: torch.Tensor, w: torch.Tensor, h: int,
                             wd: int) -> torch.Tensor:
    """The 2x2 conv as 4 shifted XNOR-popcount contractions.

    a: (B, H, W, Cw) int32 words; w: (F, 4, Cw) taps, (dy, dx) row-major.
    Returns (B, H-1, W-1, F) int32 popcounts of disagreeing bits.  One
    channel word at a time, so the widest temporary is one int64 per
    output neuron.
    """
    acc = torch.zeros((a.shape[0], h - 1, wd - 1, w.shape[0]),
                      dtype=torch.int32, device=a.device)
    for dy in range(2):
        for dx in range(2):
            patch = a[:, dy:dy + h - 1, dx:dx + wd - 1, :]     # (B,H-1,W-1,Cw)
            tap = w[:, 2 * dy + dx, :]                         # (F, Cw)
            for i in range(a.shape[-1]):
                acc += popcount32(torch.bitwise_xor(patch[..., i:i + 1],
                                                    tap[:, i]))
    return acc


def conv_block_body(a: torch.Tensor, w: torch.Tensor, tau: torch.Tensor,
                    flip: torch.Tensor, *, k4: int, h: int, wd: int,
                    pool: bool) -> torch.Tensor:
    """Plain PyTorch version of the fused layer: conv -> threshold ->
    pool -> repack.

    a: (B, H, W, Cw) int32 words; w: (F, 4, Cw) int32 words; tau/flip:
    (F,) int32.  Returns (B, Ho, Wo, F // 32) int32 words, Ho = (H-1)//2
    with ``pool`` (the odd trailing row and column dropped), else H-1.
    """
    b = a.shape[0]
    f = w.shape[0]
    s = k4 - 2 * accumulate_tap_popcounts(a, w, h, wd)       # integer sums
    # output is +1 iff (s >= tau) XOR flip; the sign bit is its negation
    ge = (s >= tau).to(torch.int32)
    bits = 1 - torch.bitwise_xor(ge, flip.to(torch.int32))
    if pool:
        # max over +/-1 == any +1 in the window == AND of the sign bits
        ho, wo = (h - 1) // 2, (wd - 1) // 2
        bits = bits[:, :ho * 2, :wo * 2, :].reshape(b, ho, 2, wo, 2, f)
        bits = bits[:, :, 0] & bits[:, :, 1]
        bits = bits[:, :, :, 0, :] & bits[:, :, :, 1, :]
    return pack_bit_lanes(bits)


def check_args(a_words, w_words, tau, flip, c: int) -> None:
    """Raise on operands neither version takes."""
    for name, t in (("a_words", a_words), ("w_words", w_words),
                    ("tau", tau), ("flip", flip)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if t.device != a_words.device:
            raise ValueError(f"{name} on {t.device}, a_words on "
                             f"{a_words.device}")
    if a_words.ndim != 4 or w_words.ndim != 3:
        raise ValueError(f"want a (B, H, W, Cw) and w (F, 4, Cw), got "
                         f"{tuple(a_words.shape)} and {tuple(w_words.shape)}")
    b, h, wd, cw = a_words.shape
    f, taps, cw2 = w_words.shape
    if taps != 4 or cw != cw2:
        raise ValueError(f"w {tuple(w_words.shape)} does not match a "
                         f"{tuple(a_words.shape)}")
    if f % PACK_WIDTH or f < PACK_WIDTH:
        raise ValueError(f"packed output needs F % {PACK_WIDTH} == 0, got {f}")
    if not 0 < cw <= MAX_CHANNEL_WORDS or not 0 < c <= cw * PACK_WIDTH:
        raise ValueError(f"c={c} over {cw} channel words is out of range")
    if tuple(tau.shape) != (f,) or tuple(flip.shape) != (f,):
        raise ValueError(f"tau/flip must be ({f},), got "
                         f"{tuple(tau.shape)}/{tuple(flip.shape)}")
    if b < 1 or h < 2 or wd < 2:
        raise ValueError(f"no conv output for a {tuple(a_words.shape)} map")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("conv_block").conv_block_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def binary_conv2x2_block(a_words: torch.Tensor, w_words: torch.Tensor,
                         tau: torch.Tensor, flip: torch.Tensor, *, c: int,
                         pool: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (raises on any other device).

    a_words: (B, H, W, Cw) int32 words; w_words: (F, 4, Cw) int32 words;
    tau/flip: (F,) int32 thresholds and directions (flip in {0, 1}); c:
    the true channel count, so the dot length is 4*c.  Returns
    (B, Ho, Wo, F // 32) int32 words.
    """
    check_args(a_words, w_words, tau, flip, c)
    if a_words.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{a_words.device}")
    a, w = aligned16(a_words), aligned16(w_words)
    tau, flip = aligned16(tau), aligned16(flip)
    b, h, wd, cw = a.shape
    f = w.shape[0]
    ho, wo = conv_out(h, wd, pool)
    out = torch.empty((b, ho, wo, f // PACK_WIDTH), dtype=torch.int32,
                      device=a.device)
    if out.numel() == 0:
        return out
    tiles = conv_tiles(b, h, wd, f, cw, pool, sms=sm_count(a.device))
    with torch.cuda.device(a.device):
        err = _launcher()(a.data_ptr(), w.data_ptr(), tau.data_ptr(),
                          flip.data_ptr(), out.data_ptr(), b, h, wd, cw, f,
                          4 * c, int(pool), *tiles.args,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"conv_block launch failed: CUDA error {err}")
    LAUNCHES["conv_block"] += 1
    return out
