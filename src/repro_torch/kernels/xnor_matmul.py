"""Packed XNOR-popcount binary matmul: CUDA kernel and plain version.

The counterpart of ``repro.kernels.xnor_matmul``:
``out[m, n] = K - 2 * popcount(a[m] ^ w[n])`` over 32-bit words, and the
``pack_out`` variant that signs the sums and packs them along N.  The
kernel is ``csrc/xnor_matmul.cu``; :func:`xnor_matmul_plain` is the same
function in PyTorch, which the CPU path and the tests use.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.binarize import (PACK_WIDTH, pack_bit_lanes,
                                       xnor_dot_popcount)
from repro_torch.kernels import _build

# kernel launches since the last reset, per kernel (not per variant call)
LAUNCHES = {"xnor_matmul": 0, "xnor_matmul_pack": 0}


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
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def xnor_matmul(a_words: torch.Tensor, w_words: torch.Tensor, k: int, *,
                pack_out: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (raises on any other device).

    a_words: (M, Kw) int32 words; w_words: (N, Kw) int32 words; k: the
    true channel count.  Returns (M, N) int32, or (M, N // 32) int32 words
    when ``pack_out``.
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
    with torch.cuda.device(a.device):
        err = _launcher()(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n,
                          kw, k, int(pack_out),
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"xnor_matmul launch failed: CUDA error {err}")
    LAUNCHES["xnor_matmul_pack" if pack_out else "xnor_matmul"] += 1
    return out
