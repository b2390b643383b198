"""BitLinear: the paper's W1A1 compute as a drop-in projection layer.

The counterpart of ``repro.core.binary_layers``.  Training path:
fake-quant with the STE (BinaryNet semantics), sign(x) . sign(W),
differentiable through both binarizations.  A learnable per-output scale
``g`` plays the role the chip's BatchNorm-comparator plays.

Inference path: bitpacked XNOR-popcount, ``binarize_pack`` then
``xnor_matmul`` (the CUDA kernels on the GPU).  Both paths scale the same
exact integer sums by the same expression, so they agree bit for bit.
"""

from __future__ import annotations

import math

import torch

from repro_torch import device as _device
from repro_torch.core import binarize
from repro_torch.kernels import ops as kops


def init(generator: torch.Generator, d_in: int, d_out: int, *,
         device=None):
    """``{"w": (d_out, d_in) N(0, 1/d_in), "g": ones(d_out)}`` float32,
    drawn on the host from ``generator`` and placed on ``device``."""
    dev = _device.resolve(device)
    w = torch.randn((d_out, d_in), generator=generator) / math.sqrt(d_in)
    return {"w": w.to(dev), "g": torch.ones(d_out, device=dev)}


def _scale(k: int, like: torch.Tensor) -> torch.Tensor:
    """float32 1 / sqrt(K), as ``repro``'s: the correctly rounded float32
    root (taken in float64 and rounded once, see
    ``binarize.fold_bn_to_threshold``), then a float32 division."""
    root = torch.tensor(math.sqrt(k), dtype=torch.float32, device=like.device)
    return 1.0 / root


def apply_train(params, x: torch.Tensor) -> torch.Tensor:
    """STE fake-quant path (differentiable): (..., K) -> (..., N)."""
    xb = binarize.ste_sign(x)
    wb = binarize.ste_sign(params["w"])
    y = torch.einsum("...k,nk->...n", xb, wb)
    return y * params["g"] * _scale(x.shape[-1], y)


def apply_infer(params, x: torch.Tensor) -> torch.Tensor:
    """Packed XNOR-popcount path (deployment): (..., K) -> (..., N)."""
    w_signs = binarize.hard_sign(params["w"])
    y = kops.binary_linear(x, w_signs).to(torch.float32)
    return y * params["g"] * _scale(x.shape[-1], y)
