"""Fused packed conv layer: CUDA kernel and plain version.

The counterpart of ``repro.kernels.binary_conv2x2_block``: a 2x2 stride-1
XNOR-popcount convolution, the folded integer comparator
``(s >= tau) XOR flip``, an optional 2x2/2 max-pool in the sign domain
(AND of the sign bits) and the repack to 32 neurons per word.  Packed
words in, packed words out.  The kernel is ``csrc/conv_block.cu``;
:func:`conv_block_body` (with :func:`accumulate_tap_popcounts`) is the
same function in PyTorch, which the CPU path, the plain megakernel and the
tests use.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.binarize import PACK_WIDTH, pack_bit_lanes, popcount32
from repro_torch.kernels import _build

MAX_CHANNEL_WORDS = 8        # 256 channels, the chip's widest map

# kernel launches since the last reset
LAUNCHES = {"conv_block": 0}


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
def _launcher():
    fn = _build.library("conv_block").conv_block_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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
    a, w = a_words.contiguous(), w_words.contiguous()
    tau, flip = tau.contiguous(), flip.contiguous()
    b, h, wd, cw = a.shape
    f = w.shape[0]
    ho, wo = (h - 1) // 2 if pool else h - 1, (wd - 1) // 2 if pool else wd - 1
    out = torch.empty((b, ho, wo, f // PACK_WIDTH), dtype=torch.int32,
                      device=a.device)
    with torch.cuda.device(a.device):
        err = _launcher()(a.data_ptr(), w.data_ptr(), tau.data_ptr(),
                          flip.data_ptr(), out.data_ptr(), b, h, wd, cw, f,
                          4 * c, int(pool),
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"conv_block launch failed: CUDA error {err}")
    LAUNCHES["conv_block"] += 1
    return out
