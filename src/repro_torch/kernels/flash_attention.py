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
S >= 1 (the ragged last key tile is masked) and the kernel any head dim d
from 1 to ``MAX_HEAD_DIM``: it runs on the next of its instantiations
``HEAD_DIMS`` up (:func:`kernel_dim`), with zeros in the columns past d,
and stores d columns; the scale stays ``1/sqrt(d)`` of the true d.

:func:`flash_attention_op` is the dispatcher op
``repro_torch::flash_attention`` over the two: CUDA tensors launch the
kernel, CPU tensors run the plain version, meta tensors get the output's
shape and type (``register_fake``) and any other device raises.  Its
FLOPs are registered with ``torch.utils.flop_counter``
(:func:`attention_flops`), so a counter over a step sees one op with a
known cost where the kernel runs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK_K = 64                 # keys per tile (the kernel's kKeys)
HEAD_DIMS = (16, 32, 64, 128)    # the kernel's instantiations
MAX_HEAD_DIM = HEAD_DIMS[-1]

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
    if not h:                                     # a block of no heads
        return torch.empty_like(q)
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
    kh = k.shape[2]
    if b < 1 or s < 1 or (h % kh if kh else h):
        raise ValueError(f"need B, S >= 1 and H % KH == 0 (H = KH = 0: a "
                         f"block of no heads); got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")


def kernel_dim(d: int) -> int:
    """The instantiation a head dim ``d`` runs on: the least of
    ``HEAD_DIMS`` at or above it (the columns past d are zeros)."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the flash kernel takes 1 to "
                         f"{MAX_HEAD_DIM}")
    return next(x for x in HEAD_DIMS if x >= d)


def copy_bytes(d: int, *ptrs: int) -> int:
    """Bytes a bf16 row copy moves (16, 8, 4 or 2): the widest that
    divides a row's 2 d bytes and keeps every pointer aligned to it."""
    return next(w for w in (16, 8, 4, 2)
                if 2 * d % w == 0 and all(p % w == 0 for p in ptrs))


# flash_attention_launch: q, k, v, o; b, s, h, kh, d, bf16; scale; causal,
# bf16_probs, copy_bytes; the stream
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("flash_attention").flash_attention_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    probs_bf16: Optional[bool] = None) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (raises on any other device,
    on non-contiguous inputs and on a head dim past ``MAX_HEAD_DIM``); a
    block of no heads (H = KH = 0, a device's share of heads that do not
    fill the devices) is returned empty, nothing launched."""
    check_args(q, k, v)
    if not (q.device.type == "cuda" and q.device == k.device == v.device):
        raise ValueError(f"the CUDA kernel needs CUDA tensors on one device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    b, s, h, d = q.shape
    kernel_dim(d)                                  # raises past the limit
    if not h:
        return torch.empty_like(q)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    cw = copy_bytes(d, *(x.data_ptr() for x in (q, k, v, out)))
    with torch.cuda.device(q.device):
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), b, s, h, k.shape[2], d,
                          int(q.dtype == torch.bfloat16), scale, int(causal),
                          int(bf16_probs_of(v.dtype, probs_bf16)), cw,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out


def attention_flops(b: int, s: int, h: int, d: int, causal: bool) -> int:
    """FLOPs of the two products (q.k and p.v), 2 a MAC: 4 B H D S^2, or
    over the causal triangle with its diagonal, 4 B H D S (S + 1) / 2."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * b * h * d * pairs


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True, scale: Optional[float] = None,
                       probs_bf16: Optional[bool] = None) -> torch.Tensor:
    """The kernel on CUDA tensors (no fallback: it launches or raises), the
    plain version on CPU tensors; any other device raises."""
    kw = dict(causal=causal, scale=scale, probs_bf16=probs_bf16)
    if q.device.type == "cuda":
        return flash_attention(q, k, v, **kw)
    if q.device.type == "cpu":
        check_args(q, k, v)
        # contiguous, as the kernel's output and the fake's
        return flash_attention_plain(q, k, v, **kw).contiguous()
    raise ValueError(f"no kernel or plain version for device {q.device}")


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal=True, scale=None, probs_bf16=None):
    check_args(q, k, v)
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flop(q_shape, k_shape, v_shape, causal=True, *args,
                          **kwargs) -> int:
    b, s, h, d = q_shape
    return attention_flops(b, s, h, d, causal)


def heads_align(h: int, kh: int, n: int) -> bool:
    """Whether ``torch.chunk``'s blocks of ``h`` q heads over ``n``
    devices read exactly the same blocks of ``kh`` KV heads (q head i
    reads KV head i // (h // kh)): ceil(h / n) == (h / kh) ceil(kh / n).
    Even splits of KV heads align; so does any split at a group of one
    (15 q and 15 KV heads over 16: one each, the last device none)."""
    return -(-h // n) == (h // kh) * -(-kh // n)


def _register_sharding() -> None:
    """The op's DTensor sharding: q, k, v and the output all replicated,
    all split on the batch, or all split on the heads, a device's q heads
    with the KV heads they read.  The batch split is offered where every
    mesh dim of several devices divides the batch; the head split where
    on each such mesh dim ``torch.chunk``'s blocks of the q heads read
    its blocks of the KV heads (:func:`heads_align`), even or not
    (DTensor itself declines a split of fewer heads than devices).  Any
    other placement is redistributed to one of these first; each device
    then runs the op, the kernel on a card, on its blocks
    (``models/attention.py`` hands it blocks of the q heads and each
    device's KV heads on its own, for any split)."""
    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _flash_attention_sharding(q, k, v, causal=True, scale=None,
                                  probs_bf16=None):
        sizes = [n for n in q.mesh.shape if n > 1]
        h, kh = q.shape[2], k.shape[2]
        fits = {0: all(q.shape[0] % n == 0 for n in sizes),
                2: kh > 0 and all(heads_align(h, kh, n) for n in sizes)}
        flags = [None, None, None]
        return [([p], [p, p, p] + flags)
                for p, dim in ((Replicate(), None), (Shard(0), 0),
                               (Shard(2), 2))
                if dim is None or fits[dim]]


_register_sharding()
