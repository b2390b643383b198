"""The binary network in plain PyTorch float arithmetic.

A frozen copy of the BinarEye network's mathematics, written from the
paper's description and independent of the program under test: a b-bit
thermometer input layer, 2x2 stride-1 VALID convolutions of +/-1 weights
on +/-1 maps followed by batch norm and a sign (folded here into a
per-feature threshold and direction), streamed 2x2 max-pools, and binary
fully connected layers.  Every sum is a sum of +/-1 products of at most
1024 terms, computed in float32 with TF32 off, so it is an exact integer.

Layers are the configuration's own layer list (``configs/*.json``):

    {"kind": "io",   "h", "w", "cin", "bits", "channels"}
    {"kind": "conv", "h", "w", "c", "f", "pool"}
    {"kind": "fc",   "k", "n", "final"}

Raw parameters are the layout the benchmark draws (``gen.draw_params``):
``conv[i]`` holds ``w`` (F, 2, 2, C) latent floats and batch norm's
``gamma``, ``beta``, ``mean``, ``var``; ``fc[i]`` holds ``w`` (N, K).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

BN_EPS = 1e-4


@contextlib.contextmanager
def exact_float32():
    """float32 matmuls without TF32 for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def sign(x: torch.Tensor) -> torch.Tensor:
    """+1 where x >= 0, else -1 (float32)."""
    return torch.where(x >= 0, 1.0, -1.0).to(torch.float32)


def fold(params: Dict[str, list]) -> Dict[str, list]:
    """Fold batch norm + sign into a threshold and a direction a feature.

    sign(gamma * (s - mean) / sqrt(var + eps) + beta) is +1 exactly when
    ``(s >= tau) xor flip``, with ``tau = mean - beta * std / gamma`` and
    ``flip = gamma < 0``, evaluated in float32 in this order, the root
    taken in float64 and rounded to float32 (the correctly rounded
    float32 root).  Conv weights become (4C, F) +/-1 columns, taps
    (dy, dx) row-major, each tap's C channels in order.
    """
    convs = []
    for p in params["conv"]:
        f, _, _, c = p["w"].shape
        std = torch.sqrt((p["var"] + BN_EPS).to(torch.float64)).to(
            torch.float32)
        tau = p["mean"] - p["beta"] * std / p["gamma"]
        convs.append(dict(w=sign(p["w"]).reshape(f, 4 * c).t().contiguous(),
                          tau=tau, flip=p["gamma"] < 0))
    fcs = [dict(w=sign(p["w"]).t().contiguous()) for p in params["fc"]]
    return {"conv": convs, "fc": fcs}


def thresholds(bits: int, per: int, device=None) -> torch.Tensor:
    """The thermometer's ``per`` float32 thresholds of a ``bits``-bit
    input: ``(i + 0.5) * (2**bits / per)``."""
    return ((torch.arange(per, dtype=torch.float32, device=device) + 0.5)
            * (2 ** bits / per))


def thermometer(x: torch.Tensor, bits: int, channels: int) -> torch.Tensor:
    """(B, H, W, Cin) integer pixels -> (B, H, W, channels) +/-1 planes:
    plane i of color c is +1 iff x_c >= t_i; leftover planes are +1."""
    b, h, w, cin = x.shape
    per = channels // cin
    t = thresholds(bits, per, device=x.device)
    planes = torch.where(x.to(torch.float32)[..., None] >= t, 1.0, -1.0)
    planes = planes.reshape(b, h, w, cin * per)
    if channels > cin * per:
        planes = torch.nn.functional.pad(planes, (0, channels - cin * per),
                                         value=1.0)
    return planes


def conv2x2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) +/-1 maps x (4C, F) columns -> (B, H-1, W-1, F) sums."""
    h, wd = x.shape[1], x.shape[2]
    patches = torch.cat([x[:, dy:h - 1 + dy, dx:wd - 1 + dx, :]
                         for dy in (0, 1) for dx in (0, 1)], dim=-1)
    return patches @ w


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max-pool of (B, H, W, C); an odd last row or column
    is dropped."""
    b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, :2 * h2, :2 * w2, :].reshape(b, h2, 2, w2, 2, c)
    return x.amax(dim=(2, 4))


def forward(folded, layers: List[dict], frames: torch.Tensor,
            block: int = 128, input_mask: int = -1) -> torch.Tensor:
    """(B, H, W, Cin) integer frames -> (B, classes) int32 logits, in
    blocks of ``block`` frames.  ``input_mask`` is and-ed into every pixel
    first (-1 keeps all bits; the lower-precision control drops some)."""
    outs = []
    with exact_float32():
        for i in range(0, frames.shape[0], block):
            outs.append(_forward_block(folded, layers,
                                       frames[i:i + block] & input_mask))
    if not outs:
        n = layers[-1]["n"]
        return torch.zeros((0, n), dtype=torch.int32, device=frames.device)
    return torch.cat(outs)


def _forward_block(folded, layers, frames):
    ci = fi = 0
    x = None
    for ly in layers:
        if ly["kind"] == "io":
            x = thermometer(frames, ly["bits"], ly["channels"])
        elif ly["kind"] == "conv":
            p = folded["conv"][ci]
            s = conv2x2(x, p["w"])
            x = torch.where(torch.logical_xor(s >= p["tau"], p["flip"]),
                            1.0, -1.0)
            if ly["pool"]:
                x = maxpool2x2(x)
            ci += 1
        else:
            x = x.reshape(x.shape[0], -1) @ folded["fc"][fi]["w"]
            if not ly["final"]:
                x = sign(x)
            fi += 1
    return torch.round(x).to(torch.int32)
