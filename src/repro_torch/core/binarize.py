"""Binarization primitives: sign, bitpacking, BatchNorm->threshold folding.

The counterpart of ``repro.core.binarize``.  A BinaryNet dot product of
two +/-1 vectors of length K is

    dot(a, w) = K - 2 * popcount(xor(pack(a), pack(w)))

with the convention  +1 -> bit 0,  -1 -> bit 1, and 32 channels per word,
packed LSB-first.

Packed words are ``torch.int32`` tensors holding the bit patterns of
``repro``'s ``uint32`` words: PyTorch's CPU ``uint32`` has no shifts or
comparisons, and there is no popcount operator.  Shifts and popcounts here
therefore widen to ``int64`` and mask to 32 bits first, because ``>>`` on a
negative ``int32`` (bit 31 set) is arithmetic.

``ste_sign`` and its straight-through gradient are not ported yet: only
the inference path and the forward pass that warms BN statistics are.
"""

from __future__ import annotations

import torch

PACK_WIDTH = 32  # binary channels per 32-bit word
_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Sign
# ---------------------------------------------------------------------------

def hard_sign(x: torch.Tensor) -> torch.Tensor:
    """Non-differentiable sign in {-1, +1} (ties -> +1)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


# ---------------------------------------------------------------------------
# Bitpacking:  +/-1 (or {0,1} sign bits) <-> 32-bit words held as int32
# ---------------------------------------------------------------------------

def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _shifts(device) -> torch.Tensor:
    return torch.arange(PACK_WIDTH, dtype=torch.int64, device=device)


def _to_word(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same 32 bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _to_unsigned(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 values in [0, 2^32) with the same 32 bits."""
    return words.to(torch.int64) & _MASK32


def pack_bit_lanes(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (..., K) tensor of {0,1} sign bits into (..., K//32) words.

    The same LSB-first lane order as :func:`pack_signs`.  K must be a
    multiple of 32.
    """
    k = bits.shape[-1]
    assert k % PACK_WIDTH == 0, k
    lanes = bits.to(torch.int64).reshape(
        bits.shape[:-1] + (k // PACK_WIDTH, PACK_WIDTH))
    return _to_word(torch.sum(lanes << _shifts(bits.device), dim=-1))


def pack_signs(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a +/-1 tensor into words along ``axis`` (bit=1 means -1).

    The packed axis length becomes ceil(K / 32); K is padded with +1
    (bit 0), so padding never flips an xor and popcount sees zeros there.
    """
    axis = axis % x.ndim
    k = x.shape[axis]
    kp = _round_up(k, PACK_WIDTH)
    x = torch.movedim(x, axis, -1)
    bits = x < 0
    if kp != k:
        bits = torch.nn.functional.pad(bits, (0, kp - k), value=False)
    return torch.movedim(pack_bit_lanes(bits), -1, axis)


def unpack_signs(words: torch.Tensor, k: int, axis: int = -1,
                 dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_signs`; returns +/-1 of length ``k``."""
    axis = axis % words.ndim
    words = torch.movedim(words, axis, -1)
    bits = (_to_unsigned(words)[..., None] >> _shifts(words.device)) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * PACK_WIDTH,))
    signs = torch.where(flat == 1, -1.0, 1.0).to(dtype)[..., :k]
    return torch.movedim(signs, -1, axis)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count of int32 words (all 32 bits), as int32.

    SWAR on int64: the word is masked to 32 bits first, so a set bit 31
    counts once and the right shifts are logical.
    """
    v = _to_unsigned(words)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = ((v * 0x01010101) & _MASK32) >> 24
    return v.to(torch.int32)


def xnor_dot_popcount(a_words: torch.Tensor, w_words: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Binary dot product from packed words: ``K - 2*popcount(a ^ w)``.

    a_words: (..., Kw) int32 words; w_words: (..., Kw) broadcastable.
    Returns the int32 dot product of the +/-1 vectors of length k.
    """
    pc = popcount32(torch.bitwise_xor(a_words, w_words))
    return (k - 2 * torch.sum(pc, dim=-1, dtype=torch.int32)).to(torch.int32)


def thermometer_thresholds(bits: int, per: int, device=None) -> torch.Tensor:
    """The (per,) float32 thermometer thresholds of a ``bits``-bit input.

    ``(i + 0.5) * (2**bits / per)`` in float32, the exact values of
    ``repro.core.binarize.thermometer_pack``.  The megakernel receives
    this table from the host, so the kernel and the plain version compare
    against one set of thresholds.
    """
    levels = 2 ** bits
    return ((torch.arange(per, dtype=torch.float32, device=device) + 0.5)
            * (levels / per))


def thermometer_pack(images: torch.Tensor, bits: int, cin: int,
                     channels: int) -> torch.Tensor:
    """Thermometer-encode integer pixels straight into packed words.

    Plane i of color c is -1 (bit 1) exactly when ``x_c < t_i``; leftover
    planes are constant +1 bias (bit 0).  ``channels`` must be a multiple
    of 32.  (..., H, W, cin) int -> (..., H, W, channels//32) int32.
    """
    assert channels % PACK_WIDTH == 0, channels
    lead = images.shape[:-1]
    per = channels // cin
    t = thermometer_thresholds(bits, per, device=images.device)
    neg = images.to(torch.float32)[..., None] < t
    neg = neg.reshape(lead + (cin * per,))
    pad = channels - cin * per
    if pad:                                              # +1 bias -> bit 0
        neg = torch.nn.functional.pad(neg, (0, pad), value=False)
    return pack_bit_lanes(neg)


# ---------------------------------------------------------------------------
# BatchNorm -> threshold folding (the chip's binary comparator)
# ---------------------------------------------------------------------------

def fold_bn_to_threshold(gamma, beta, mean, var, eps: float = 1e-5):
    """Fold BatchNorm + sign into a threshold on the popcount sum.

    sign(gamma * (s - mean)/sqrt(var+eps) + beta) ==
        (s >= tau)  if gamma > 0  else  (s <= tau),
    with tau = mean - beta*sqrt(var+eps)/gamma, evaluated in float32 in
    this operation order (``threshold_to_int`` takes a ceil, which flips at
    integer boundaries, so the order matters for bit-exactness).

    Returns (tau, flip) where flip==True encodes the gamma<0 direction.

    The square root is taken in float64 and rounded to float32, which is
    the correctly rounded float32 root (a double rounding is harmless for
    sqrt): PyTorch's vectorized CPU float32 sqrt is off by one ulp on some
    inputs, and the ceil downstream would turn that into another
    threshold.
    """
    std = torch.sqrt((var + eps).to(torch.float64)).to(torch.float32)
    tau = mean - beta * std / gamma
    flip = gamma < 0
    return tau, flip


def threshold_activation(s: torch.Tensor, tau: torch.Tensor,
                         flip: torch.Tensor) -> torch.Tensor:
    """Apply the folded comparator: +/-1 float32 output."""
    ge = s >= tau
    return torch.where(torch.logical_xor(ge, flip), 1.0, -1.0).to(
        torch.float32)


def threshold_to_int(tau: torch.Tensor) -> torch.Tensor:
    """Quantize the folded float threshold to the int32 the chip stores.

    Conv sums are integers, so ``s >= tau``  <=>  ``s >= ceil(tau)``.  Inf
    thresholds saturate to the int32 range (as float32), preserving the
    always/never-fire behaviour for any reachable ``s``.
    """
    lo, hi = float(-2 ** 31), float(2 ** 31 - 256)
    return torch.clamp(torch.ceil(tau.to(torch.float32)), lo, hi).to(
        torch.int32)
