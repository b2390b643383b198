"""The kernel dispatch: CUDA tensors launch the kernels, CPU tensors run
the plain PyTorch versions.

The counterpart of ``repro.kernels.ops``.  The choice follows the device
of the tensors only: there is no fallback, so a CUDA tensor either
launches its kernel or raises, and a tensor on any other device raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import binarize
from repro_torch.kernels import binarize_pack as _bp
from repro_torch.kernels import binary_conv2x2 as _bc
from repro_torch.kernels import binary_conv2x2_block as _bcb
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import megakernel as _mk
from repro_torch.kernels import xnor_matmul as _xm

_COUNTERS = (_bcb.LAUNCHES, _xm.LAUNCHES, _mk.LAUNCHES, _bc.LAUNCHES,
             _bp.LAUNCHES, _fa.LAUNCHES)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def pack(x: torch.Tensor) -> torch.Tensor:
    """Fused sign+pack for a (..., K) float32 tensor -> (..., ceil(K/32))
    int32 words, bit 1 iff x < 0, K padded with +1."""
    lead = x.shape[:-1]
    flat = x.reshape((-1, x.shape[-1]))
    if _on_cuda(flat):
        out = _bp.binarize_pack(flat)
    else:
        _bp.check_args(flat)
        out = _bp.binarize_pack_plain(flat)
    return out.reshape(lead + (out.shape[-1],))


def xnor_matmul(a_words: torch.Tensor, w_words: torch.Tensor, k: int, *,
                pack_out: bool = False) -> torch.Tensor:
    """Packed binary matmul: (M, Kw) x (N, Kw) words -> (M, N) int32, or
    (M, N // 32) sign words when ``pack_out``."""
    if _on_cuda(a_words):
        return _xm.xnor_matmul(a_words, w_words, k, pack_out=pack_out)
    _xm.check_args(a_words, w_words, k, pack_out)
    return _xm.xnor_matmul_plain(a_words, w_words, k, pack_out=pack_out)


def binary_conv2x2(a_words: torch.Tensor, w_words: torch.Tensor,
                   c: int) -> torch.Tensor:
    """Unfused packed 2x2 conv: (B, H, W, Cw) or (H, W, Cw) words and
    (F, 4, Cw) taps -> (B, H-1, W-1, F) or (H-1, W-1, F) int32 sums."""
    if _on_cuda(a_words):
        return _bc.binary_conv2x2(a_words, w_words, c=c)
    _bc.check_args(a_words, w_words, c)
    return _bc.binary_conv2x2_plain(a_words, w_words, c)


def binary_conv2x2_block(a_words: torch.Tensor, w_words: torch.Tensor,
                         tau: torch.Tensor, flip: torch.Tensor, c: int, *,
                         pool: bool = False, tiles=None) -> torch.Tensor:
    """Fused packed conv layer: conv -> integer threshold -> pool -> repack.
    (B, H, W, Cw) words in, (B, Ho, Wo, F//32) words out.  ``tiles`` (a
    ``make_conv_tiles`` geometry) is the kernel's launch geometry, None
    for ``conv_tiles``; the plain version computes the same words at
    any."""
    if _on_cuda(a_words):
        return _bcb.binary_conv2x2_block(a_words, w_words, tau, flip, c=c,
                                         pool=pool, tiles=tiles)
    _bcb.check_args(a_words, w_words, tau, flip, c)
    h, w = a_words.shape[1:3]
    return _bcb.conv_block_body(a_words, w_words, tau, flip, k4=4 * c, h=h,
                                wd=w, pool=pool)


def _check_cluster(spec, cluster: Optional[int]) -> None:
    """The plain versions compute the same logits at any cluster size, but
    refuse one the kernel cannot take, as the kernel's wrapper does."""
    if cluster is not None:
        _mk.cluster_geometry(spec, cluster)


def megakernel_forward(image: Dict[str, torch.Tensor], frames: torch.Tensor,
                       *, spec, cluster: Optional[int] = None
                       ) -> torch.Tensor:
    """Whole-network inference for one program: raw frames -> int32
    logits, every stage of ``spec`` (``InferencePlan.mega``) in one
    launch on the GPU, in clusters of ``cluster`` blocks (None: the
    kernel's own choice)."""
    if _on_cuda(frames):
        return _mk.megakernel_forward(image, frames, spec=spec,
                                      cluster=cluster)
    _mk.check_args(image, (frames,), _mk.solo_member_spec(spec))
    _check_cluster(_mk.solo_member_spec(spec), cluster)
    return _mk.megakernel_plain(image, frames, spec=spec)


def composite_forward(image: Dict[str, torch.Tensor],
                      frames: Sequence[torch.Tensor], *, spec,
                      cluster: Optional[int] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """Shared-array inference: one frame batch per member of the composite
    ``spec`` (``CompositePlan.spec``) -> one int32 logits tensor per
    member, every member in one launch on the GPU (``cluster`` as
    :func:`megakernel_forward`)."""
    frames = tuple(frames)
    if _on_cuda(frames[0]):
        return _mk.composite_forward(image, frames, spec=spec,
                                     cluster=cluster)
    _mk.check_args(image, frames, spec)
    _check_cluster(spec, cluster)
    return _mk.composite_plain(image, frames, spec=spec)


def cascade_forward(image: Dict[str, torch.Tensor], frames: torch.Tensor,
                    ctrl: torch.Tensor, *, spec, bb: int = 8, rb: int = 0,
                    check_every: int = 1, positive_class: int = 1,
                    det_cluster: int = 0):
    """Fused detector -> recognizer cascade (``CascadePlan.spec``): frames
    -> ``(det, rec, queue, counts)``, the escalation decided on the device
    and the recognizer run on the escalated frames only (``det_cluster``:
    the detector's blocks a cluster, 0 to pick by the batch)."""
    kw = dict(spec=spec, bb=bb, rb=rb, check_every=check_every,
              positive_class=positive_class)
    if _on_cuda(frames):
        return _mk.cascade_forward(image, frames, ctrl,
                                   det_cluster=det_cluster, **kw)
    _mk.check_cascade_args(image, frames, ctrl, spec, bb=bb, rb=rb,
                           check_every=check_every,
                           positive_class=positive_class)
    if det_cluster:
        _check_cluster(spec[:1], det_cluster)
    return _mk.cascade_plain(image, frames, ctrl, **kw)


def delta_forward(image: Dict[str, torch.Tensor], frames: torch.Tensor,
                  last: torch.Tensor, llog: torch.Tensor, ctrl: torch.Tensor,
                  *, spec, bb: int = 8, rb: int = 0, check_every: int = 1,
                  cluster: Optional[int] = None):
    """Delta-gated whole-network inference (``DeltaPlan.spec``): frames and
    the resident state -> ``(logits, new_last, queue, counts, deltas)``,
    the gate decided on the device and only the changed streams
    recomputed (``cluster`` as :func:`megakernel_forward`)."""
    kw = dict(spec=spec, bb=bb, rb=rb, check_every=check_every)
    if _on_cuda(frames):
        return _mk.delta_forward(image, frames, last, llog, ctrl,
                                 cluster=cluster, **kw)
    _mk.check_delta_args(image, frames, last, llog, ctrl, spec, bb=bb, rb=rb,
                         check_every=check_every)
    _check_cluster(spec, cluster)
    return _mk.delta_plain(image, frames, last, llog, ctrl, **kw)


def binary_linear(x: torch.Tensor, w_signs: torch.Tensor) -> torch.Tensor:
    """End-to-end W1A1 linear for inference: float x, +/-1 weights.

    x: (..., K) float32; w_signs: (N, K) in {-1, +1}.  Returns (..., N)
    int32, the exact binary dot products (the caller applies threshold or
    scale): x packed by :func:`pack`, then :func:`xnor_matmul`.
    """
    k = x.shape[-1]
    lead = x.shape[:-1]
    a_words = pack(x.reshape((-1, k)))
    w_words = binarize.pack_signs(w_signs, axis=-1)
    out = xnor_matmul(a_words, w_words, k)
    return out.reshape(lead + (w_signs.shape[0],))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    probs_bf16: Optional[bool] = None) -> torch.Tensor:
    """GQA attention forward with an online softmax: q (B, S, H, D), k and
    v (B, S, KH, D) -> (B, S, H, D) in q's type, float32 or bfloat16.
    ``probs_bf16`` is ``chunked_attention``'s (bf16 or float32 p . v);
    ``None`` rounds p to v's type."""
    kw = dict(causal=causal, scale=scale, probs_bf16=probs_bf16)
    if _on_cuda(q):
        return _fa.flash_attention(q, k, v, **kw)
    _fa.check_args(q, k, v)
    return _fa.flash_attention_plain(q, k, v, **kw)


member_groups = _mk.member_groups
solo_member_spec = _mk.solo_member_spec


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`, by
    kernel name (the CPU path launches nothing)."""
    return {name: n for counter in _COUNTERS for name, n in counter.items()}


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for name in counter:
            counter[name] = 0
