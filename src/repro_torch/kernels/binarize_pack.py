"""Fused sign + bitpack: CUDA kernel and plain version.

The counterpart of ``repro.kernels.binarize_pack``: (M, K) float32 ->
(M, ceil(K/32)) packed sign words, bit 1 iff ``x < 0`` (the Pallas body's
test, so -0.0 and NaN give bit 0), K padded with +1.0 (bit 0).  The
kernel is ``csrc/binarize_pack.cu``; :func:`binarize_pack_plain` is the
same function in PyTorch, which the CPU path and the tests use.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.binarize import PACK_WIDTH, pack_bit_lanes
from repro_torch.kernels import _build

# kernel launches since the last reset
LAUNCHES = {"binarize_pack": 0}


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


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("binarize_pack").binarize_pack_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
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
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), out.data_ptr(), m, k,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"binarize_pack launch failed: CUDA error {err}")
    LAUNCHES["binarize_pack"] += 1
    return out
