"""Functional model of the 64-neuron / 4-sub-neuron BinarEye array.

The counterpart of ``repro.core.chip.neuron_array``, with its two compute
paths: the float +/-1 path (training, and the reference the packed
pipeline is held against) and the packed XNOR-popcount path of the same
integer sums (``conv2x2_packed``, ``fc_packed``, through the kernel
dispatch), plus the packed thermometer encoder.  Maps are (B, H, W, C),
as in ``repro``.

The float path sums +/-1 products in float32, which is exact for every
sum the chip can reach (|s| <= 4*256), on the CPU and on the GPU alike.
"""

from __future__ import annotations

import torch

from repro_torch.core import binarize
from repro_torch.kernels import ops as kops


# ---------------------------------------------------------------------------
# IO layer: thermometer encoding of b-bit images into +/-1 channels
# ---------------------------------------------------------------------------

def thermometer_encode(images: torch.Tensor, bits: int,
                       channels: int) -> torch.Tensor:
    """(B, H, W, C_in) integer images in [0, 2^bits) -> (B, H, W, channels)
    +/-1 float32: plane i of color c is sign(x_c - t_i); leftover planes
    are constant +1 (bias)."""
    b, h, w, cin = images.shape
    per = channels // cin
    t = binarize.thermometer_thresholds(bits, per, device=images.device)
    x = images.to(torch.float32)[..., None]              # (B,H,W,Cin,1)
    planes = torch.where(x >= t, 1.0, -1.0)              # (B,H,W,Cin,per)
    planes = planes.reshape(b, h, w, cin * per)
    pad = channels - cin * per
    if pad:
        planes = torch.nn.functional.pad(planes, (0, pad), value=1.0)
    return planes


def thermometer_encode_packed(images: torch.Tensor, bits: int,
                              channels: int) -> torch.Tensor:
    """Thermometer-encode straight into packed words: bit-identical to
    ``pack_signs(thermometer_encode(...))`` without the float planes.
    Returns (B, H, W, channels // 32) int32."""
    return binarize.thermometer_pack(images, bits, images.shape[-1],
                                     channels)


# ---------------------------------------------------------------------------
# CONV: F x C x 2x2 stride-1 VALID, all neurons in parallel
# ---------------------------------------------------------------------------

def conv2x2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Float path. x: (B, H, W, C) +/-1; w: (F, 2, 2, C) +/-1 ->
    (B, H-1, W-1, F), as 4 shifted contractions."""
    h, wd = x.shape[1], x.shape[2]
    out = 0.0
    for dy in range(2):
        for dx in range(2):
            patch = x[:, dy:h - 1 + dy, dx:wd - 1 + dx, :]
            out = out + torch.einsum("byxc,fc->byxf", patch, w[:, dy, dx, :])
    return out


def conv2x2_packed(x_signs: torch.Tensor,
                   w_signs: torch.Tensor) -> torch.Tensor:
    """Packed XNOR-popcount path of :func:`conv2x2`: float +/-1 in, float32
    sums out, through the ``binary_conv2x2`` kernel on the GPU.  The
    activations are packed by the ``binarize_pack`` kernel (equal to
    ``pack_signs`` on +/-1 values), the taps by ``pack_signs``.  The fully
    packed pipeline is ``interpreter.InferencePlan``."""
    c = x_signs.shape[-1]
    f = w_signs.shape[0]
    x_words = kops.pack(x_signs)                                  # (B,H,W,Cw)
    w_words = binarize.pack_signs(w_signs.reshape(f, 4, c), axis=-1)
    return kops.binary_conv2x2(x_words, w_words, c).to(torch.float32)


# ---------------------------------------------------------------------------
# Streamed max-pool and the binary comparator
# ---------------------------------------------------------------------------

def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max-pool; odd trailing row/col dropped (as streamed HW)."""
    b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, :h2 * 2, :w2 * 2, :].reshape(b, h2, 2, w2, 2, c)
    return x.amax(dim=(2, 4))


def comparator(s: torch.Tensor, tau: torch.Tensor,
               flip: torch.Tensor) -> torch.Tensor:
    """Per-feature threshold comparator (folded BN+sign), +/-1 output."""
    return binarize.threshold_activation(s, tau, flip)


# ---------------------------------------------------------------------------
# FC layer
# ---------------------------------------------------------------------------

def fc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, IN) +/-1; w: (OUT, IN) +/-1 -> (B, OUT) integer scores."""
    return torch.einsum("bi,oi->bo", x, w)


def fc_packed(x_signs: torch.Tensor, w_signs: torch.Tensor) -> torch.Tensor:
    """Packed XNOR-popcount path of :func:`fc`: float +/-1 in, float32
    sums out, through the ``xnor_matmul`` kernel on the GPU."""
    xw = binarize.pack_signs(x_signs, axis=-1)
    ww = binarize.pack_signs(w_signs, axis=-1)
    return kops.xnor_matmul(xw, ww, x_signs.shape[-1]).to(torch.float32)
