"""Unfused packed 2x2 binary convolution: CUDA kernel and plain version.

The counterpart of ``repro.kernels.binary_conv2x2``: packed maps
(B, H, W, Cw) or (H, W, Cw) and packed taps (F, 4, Cw), (dy, dx)
row-major -> int32 sums (B, H-1, W-1, F) (or (H-1, W-1, F)) =
``4c - 2 * popcount(a ^ w)`` over the 2x2 window, for any channel count
c up to 2048, any map of at least 2x2 (of any width: a band too wide for
shared memory is cut into column chunks) and any F.  The kernel is
``csrc/binary_conv2x2.cu``, on the fused layer's tensor-core tile and
launch geometry (``binary_conv2x2_block.conv_tiles``);
:func:`binary_conv2x2_plain` is the same function in PyTorch (through the
fused layer's ``accumulate_tap_popcounts``), which the CPU path and the
tests use.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.binarize import PACK_WIDTH
from repro_torch.kernels import _build
from repro_torch.kernels.binary_conv2x2_block import (
    accumulate_tap_popcounts, aligned16, conv_tiles, sm_count)

MAX_CHANNEL_WORDS = 64       # 2048 channels: the kernel's shared-memory taps

# kernel launches since the last reset
LAUNCHES = {"binary_conv2x2": 0}
# binary_conv2x2_launch: a, w, out; b, h, wd, cw, f, k4 and ConvTiles.args;
# the stream
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 17 + [ctypes.c_void_p]


def binary_conv2x2_plain(a_words: torch.Tensor, w_words: torch.Tensor,
                         c: int) -> torch.Tensor:
    """Plain PyTorch version: (B, H, W, Cw) or (H, W, Cw) words and
    (F, 4, Cw) taps -> (B, H-1, W-1, F) or (H-1, W-1, F) int32 sums."""
    squeeze = a_words.ndim == 3
    a = a_words[None] if squeeze else a_words
    h, wd = a.shape[1:3]
    out = 4 * c - 2 * accumulate_tap_popcounts(a, w_words, h, wd)
    return out[0] if squeeze else out


def check_args(a_words: torch.Tensor, w_words: torch.Tensor, c: int) -> None:
    """Raise on operands neither version takes."""
    for name, t in (("a_words", a_words), ("w_words", w_words)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 words, got {t.dtype}")
    if w_words.device != a_words.device:
        raise ValueError(f"w_words on {w_words.device}, a_words on "
                         f"{a_words.device}")
    if a_words.ndim not in (3, 4) or w_words.ndim != 3:
        raise ValueError(f"want a (B, H, W, Cw) or (H, W, Cw) and w "
                         f"(F, 4, Cw), got {tuple(a_words.shape)} and "
                         f"{tuple(w_words.shape)}")
    h, wd, cw = a_words.shape[-3:]
    f, taps, cw2 = w_words.shape
    if taps != 4 or cw != cw2:
        raise ValueError(f"w {tuple(w_words.shape)} does not match a "
                         f"{tuple(a_words.shape)}")
    if not 0 < cw <= MAX_CHANNEL_WORDS:
        raise ValueError(f"{cw} channel words: the kernel takes 1 to "
                         f"{MAX_CHANNEL_WORDS} ({MAX_CHANNEL_WORDS * 32} "
                         f"channels)")
    if not 0 < c <= cw * PACK_WIDTH:
        raise ValueError(f"c={c} does not fit {cw} channel words")
    if f < 1 or h < 2 or wd < 2 or (a_words.ndim == 4
                                     and a_words.shape[0] < 1):
        raise ValueError(f"no conv output for a {tuple(a_words.shape)} map "
                         f"and {f} features")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("binary_conv2x2").binary_conv2x2_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def binary_conv2x2(a_words: torch.Tensor, w_words: torch.Tensor, *,
                   c: int) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (raises on any other device).

    a_words: (B, H, W, Cw) or (H, W, Cw) int32 words; w_words: (F, 4, Cw)
    int32 words; c: the true channel count, so the dot length is 4*c.
    Returns (B, H-1, W-1, F) or (H-1, W-1, F) int32 sums.
    """
    check_args(a_words, w_words, c)
    if a_words.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{a_words.device}")
    squeeze = a_words.ndim == 3
    a = aligned16(a_words[None] if squeeze else a_words)
    w = aligned16(w_words)
    b, h, wd, cw = a.shape
    f = w.shape[0]
    out = torch.empty((b, h - 1, wd - 1, f), dtype=torch.int32,
                      device=a.device)
    tiles = conv_tiles(b, h, wd, f, cw, False, sms=sm_count(a.device))
    with torch.cuda.device(a.device):
        err = _launcher()(a.data_ptr(), w.data_ptr(), out.data_ptr(), b, h,
                          wd, cw, f, 4 * c, *tiles.args,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"binary_conv2x2 launch failed: CUDA error {err}")
    LAUNCHES["binary_conv2x2"] += 1
    return out[0] if squeeze else out
