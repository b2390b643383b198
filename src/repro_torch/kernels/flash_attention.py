"""Flash-attention forward: CUDA kernel and plain version.

The counterpart of ``repro.kernels.flash_attention``: q (B, S, H, D),
k and v (B, S, KH, D) -> (B, S, H, D), causal or not, head h reading KV
head ``h // (H // KH)``.  Scores are float32 (``(q . k) * scale``, masked
with -1e30), the running max and sum float32, ``p . v`` accumulated in
float32, and the output is ``acc / max(l, 1e-37)`` in q's type.  The
probability type follows ``repro.models.attention.chunked_attention``:
``probs_bf16=True`` rounds p and v to bf16 before ``p . v``, ``False``
keeps p (and v) in float32, and ``None`` rounds p to v's type, the Pallas
kernel's ``p.astype(v.dtype)``.  The kernel is ``csrc/flash_attention.cu``
(bf16 on the tensor cores, float32 p carried as two bf16 halves; float32
on CUDA cores); :func:`flash_attention_plain` is the Pallas body written
out in PyTorch (the key-tile loop with its online softmax), which the CPU
path and the tests use.  Unlike ``repro``'s wrapper, both take any
S >= 1: the ragged last key tile is masked.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK_K = 64                 # keys per tile (the kernel's kKeys)
HEAD_DIMS = (16, 32, 64, 128)    # the kernel's instantiations

# kernel launches since the last reset
LAUNCHES = {"flash_attention": 0}


def bf16_probs_of(dtype: torch.dtype, probs_bf16: Optional[bool]) -> bool:
    """Whether p (and v) are rounded to bf16 before ``p . v``:
    ``probs_bf16`` where given, else p takes v's type."""
    return dtype == torch.bfloat16 if probs_bf16 is None else probs_bf16


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None,
                          probs_bf16: Optional[bool] = None) -> torch.Tensor:
    """Plain PyTorch version: the online softmax over the kernel's key
    tiles of ``BLOCK_K``, in its order, all query rows at once, rows
    folded as (position, g)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rounded = bf16_probs_of(v.dtype, probs_bf16)
    # rows (position, g) of one KV head: (B, KH, S*G, D)
    qf = q.float().reshape(b, s, kh, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, kh, s * g, d)
    kf = k.float().permute(0, 2, 1, 3)                    # (B, KH, S, D)
    vf = v.float().permute(0, 2, 1, 3)
    if rounded:
        vf = vf.to(torch.bfloat16).float()
    rows = torch.arange(s * g, device=q.device) // g
    m = torch.full((b, kh, s * g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kh, s * g, d), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, s, BLOCK_K):
        kt, vt = kf[:, :, k0:k0 + BLOCK_K], vf[:, :, k0:k0 + BLOCK_K]
        sc = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2], device=q.device)
            sc = torch.where(cols[None, :] <= rows[:, None], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        if rounded:
            p = p.to(torch.bfloat16).float()
        acc = acc * alpha[..., None] + torch.matmul(p, vt)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-37)[..., None]
    out = out.reshape(b, kh, s, g, d).permute(0, 2, 1, 3, 4)
    return out.reshape(b, s, h, d).to(q.dtype)


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on inputs neither version takes."""
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k and v must share one type, float32 or "
                         f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, S, H, D) and k, v (B, S, KH, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if b < 1 or s < 1 or k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"need B, S >= 1 and H % KH == 0; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    probs_bf16: Optional[bool] = None) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (raises on any other device,
    on non-contiguous or, in bf16, not 16-byte aligned inputs and on D
    outside ``HEAD_DIMS``)."""
    check_args(q, k, v)
    if not (q.device.type == "cuda" and q.device == k.device == v.device):
        raise ValueError(f"the CUDA kernel needs CUDA tensors on one device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16
                                         for x in (q, k, v)):
        raise ValueError("bf16 q, k and v must be 16-byte aligned (the "
                         "kernel copies 16-byte chunks)")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), b, s, h, k.shape[2], d,
                          int(q.dtype == torch.bfloat16), scale, int(causal),
                          int(bf16_probs_of(v.dtype, probs_bf16)),
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
