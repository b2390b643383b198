"""The kernel dispatch: CUDA tensors launch the kernels, CPU tensors run
the plain PyTorch versions.

The counterpart of ``repro.kernels.ops``.  The choice follows the device
of the tensors only: there is no fallback, so a CUDA tensor either
launches its kernel or raises, and a tensor on any other device raises.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import binary_conv2x2_block as _bcb
from repro_torch.kernels import megakernel as _mk
from repro_torch.kernels import xnor_matmul as _xm

_COUNTERS = (_bcb.LAUNCHES, _xm.LAUNCHES, _mk.LAUNCHES)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def xnor_matmul(a_words: torch.Tensor, w_words: torch.Tensor, k: int, *,
                pack_out: bool = False) -> torch.Tensor:
    """Packed binary matmul: (M, Kw) x (N, Kw) words -> (M, N) int32, or
    (M, N // 32) sign words when ``pack_out``."""
    if _on_cuda(a_words):
        return _xm.xnor_matmul(a_words, w_words, k, pack_out=pack_out)
    _xm.check_args(a_words, w_words, k, pack_out)
    return _xm.xnor_matmul_plain(a_words, w_words, k, pack_out=pack_out)


def binary_conv2x2_block(a_words: torch.Tensor, w_words: torch.Tensor,
                         tau: torch.Tensor, flip: torch.Tensor, c: int, *,
                         pool: bool = False) -> torch.Tensor:
    """Fused packed conv layer: conv -> integer threshold -> pool -> repack.
    (B, H, W, Cw) words in, (B, Ho, Wo, F//32) words out."""
    if _on_cuda(a_words):
        return _bcb.binary_conv2x2_block(a_words, w_words, tau, flip, c=c,
                                         pool=pool)
    _bcb.check_args(a_words, w_words, tau, flip, c)
    h, w = a_words.shape[1:3]
    return _bcb.conv_block_body(a_words, w_words, tau, flip, k4=4 * c, h=h,
                                wd=w, pool=pool)


def megakernel_forward(image: Dict[str, torch.Tensor], frames: torch.Tensor,
                       *, spec) -> torch.Tensor:
    """Whole-network inference for one program: raw frames -> int32
    logits, every stage of ``spec`` (``InferencePlan.mega``) in one
    launch on the GPU."""
    if _on_cuda(frames):
        return _mk.megakernel_forward(image, frames, spec=spec)
    _mk.check_args(image, frames, spec)
    return _mk.megakernel_plain(image, frames, spec=spec)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`, by
    kernel name (the CPU path launches nothing)."""
    return {name: n for counter in _COUNTERS for name, n in counter.items()}


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for name in counter:
            counter[name] = 0
