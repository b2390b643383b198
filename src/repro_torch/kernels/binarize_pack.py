"""Fused sign + bitpack: CUDA kernel and plain version.

The counterpart of ``repro.kernels.binarize_pack``: (M, K) float32 ->
(M, ceil(K/32)) packed sign words, bit 1 iff ``x < 0`` (the Pallas body's
test, so -0.0 and NaN give bit 0), K padded with +1.0 (bit 0).  The
kernel is ``csrc/binarize_pack.cu``, two paths: the flat one (16-byte
loads, words assembled by shuffles) where K % 32 == 0 and x is 16-byte
aligned, else the row path (one ballot a word); :func:`pack_path` picks
and :func:`pack_blocks` sizes the grid.  :func:`binarize_pack_plain` is
the same function in PyTorch, which the CPU path and the tests use.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.binarize import PACK_WIDTH, pack_bit_lanes
from repro_torch.kernels import _build
from repro_torch.kernels.binary_conv2x2_block import sm_count

WARPS = 8                    # csrc/binarize_pack.cu: kWarps
CHUNKS = 4                   # csrc/binarize_pack.cu: kChunks
BLOCKS_PER_SM = 8            # 2048 threads an SM / 256 a block
SMS = 132                    # H100 SXM

# kernel launches since the last reset
LAUNCHES = {"binarize_pack": 0}
# binarize_pack_launch: x, out; m, k, flat, blocks; the stream
ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def binarize_pack_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (M, K) float32 -> (M, ceil(K/32)) int32
    words."""
    k = x.shape[-1]
    bits = x < 0
    pad = -k % PACK_WIDTH
    if pad:                                              # +1.0 -> bit 0
        bits = torch.nn.functional.pad(bits, (0, pad), value=False)
    return pack_bit_lanes(bits)


def check_args(x: torch.Tensor) -> None:
    """Raise on inputs neither version takes."""
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"x must be a 2-D float32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")


def pack_path(k: int, ptr: int) -> bool:
    """True for the flat path: K % 32 == 0 and x 16-byte aligned."""
    return k % PACK_WIDTH == 0 and ptr % 16 == 0


def pack_blocks(m: int, k: int, flat: bool, sms: int = SMS) -> int:
    """8-warp blocks of one launch: a warp an item (flat: a tile of CHUNKS
    128-float chunks; rows: CHUNKS words of a row), at most as many as the
    SMs hold at once (the kernels loop over the rest)."""
    kw = -(-k // PACK_WIDTH)
    if flat:
        items = -(-m * k // (128 * CHUNKS))
    else:
        items = m * -(-kw // CHUNKS)
    return max(1, min(-(-items // WARPS), sms * BLOCKS_PER_SM))


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("binarize_pack").binarize_pack_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def binarize_pack(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor (raises on any other
    device): (M, K) float32 -> (M, ceil(K/32)) int32 words."""
    check_args(x)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{x.device}")
    x = x.contiguous()
    m, k = x.shape
    out = torch.empty((m, -(-k // PACK_WIDTH)), dtype=torch.int32,
                      device=x.device)
    flat = pack_path(k, x.data_ptr())
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), out.data_ptr(), m, k, int(flat),
                          pack_blocks(m, k, flat, sm_count(x.device)),
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"binarize_pack launch failed: CUDA error {err}")
    LAUNCHES["binarize_pack"] += 1
    return out
