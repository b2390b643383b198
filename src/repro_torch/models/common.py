"""Shared model components: norms, RoPE (+M-RoPE), projections, embeddings.

The counterpart of ``repro.models.common``.  All modules are functional:
``*_init`` returns a parameter dict of tensors, ``*_apply`` consumes it.
Initialisers draw from a ``torch.Generator`` on the target device, so the
weights are the port's own (``convert.lm_params_from_numpy`` carries
``repro``'s across).  Projections honor ``quant="binary"`` (BinaryNet W1A1
with the straight-through estimator).  ``bf16_grads`` keeps the forward
and casts the cotangent to bf16 before both gradient matmuls
(:class:`MatmulBF16Grads`, ``repro``'s custom VJP).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import binarize


# ---------------------------------------------------------------------------
# dtype helpers
# ---------------------------------------------------------------------------

def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def dtype_of(cfg) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, device=None, lead=()):
    return {"scale": torch.zeros(tuple(lead) + (d,), dtype=dtype,
                                 device=device)}   # gemma-style (1 + scale)


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].float())).to(dt)


# ---------------------------------------------------------------------------
# Linear (optionally binary)
# ---------------------------------------------------------------------------

def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, dtype=torch.float32, device=None,
                lead=()):
    shape = tuple(lead) + (d_in, d_out)
    p = {"w": torch.randn(shape, generator=gen, dtype=dtype, device=device)
         / math.sqrt(d_in)}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (d_out,), dtype=dtype,
                             device=device)
    return p


class MatmulBF16Grads(torch.autograd.Function):
    """``x @ w`` whose backward casts the cotangent to bf16 BEFORE the two
    gradient matmuls (``repro.models.common._matmul_bf16_grads``): the
    activation-gradient stream in bf16, as Megatron's bf16 gradient
    collectives; dx and dw come back in their operands' types (dw is
    accumulated in float32 by the optimizer's update)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        dx = torch.matmul(g16, w.to(torch.bfloat16).t())
        # contract every leading dim: (..., K) x (..., N) -> (K, N)
        dw = torch.matmul(x.to(torch.bfloat16).reshape(-1, x.shape[-1]).t(),
                          g16.reshape(-1, g16.shape[-1]))
        return dx.to(x.dtype), dw.to(w.dtype)


def linear_apply(params, x: torch.Tensor, *, quant: str = "none",
                 bf16_grads: bool = False) -> torch.Tensor:
    w = params["w"]
    if quant == "binary":
        # BinaryNet W1A1 with STE; 1/sqrt(K) keeps activations in range
        # the product in the operands' promoted type, as jnp.einsum
        # promotes bf16 activations against float32 weights
        dt = torch.promote_types(x.dtype, w.dtype)
        xb = binarize.ste_sign(x).to(dt)
        wb = binarize.ste_sign(w).to(dt)
        y = torch.matmul(xb, wb) * (1.0 / math.sqrt(x.shape[-1]))
        y = y.to(x.dtype)
    elif bf16_grads:
        y = MatmulBF16Grads.apply(x, w.to(x.dtype))
    else:
        y = torch.matmul(x, w.to(x.dtype))
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE + Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (..., S) int -> cos/sin (..., S, head_dim//2) float32."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections) -> tuple:
    """Qwen2-VL multimodal RoPE.

    positions: (B, S, 3) — temporal/height/width position ids.  The
    head_dim/2 frequency slots are split into ``sections`` (t, h, w); each
    section rotates by its own position stream.
    """
    if sum(sections) != head_dim // 2:
        raise ValueError(f"sections {sections} do not cover head_dim "
                         f"{head_dim} // 2")
    freqs = rope_freqs(head_dim, theta, positions.device)        # (hd/2,)
    ang_3 = positions[..., None, :].float() * freqs[None, None, :, None]
    owner = torch.repeat_interleave(
        torch.arange(3, device=positions.device),
        torch.tensor(tuple(sections), device=positions.device))
    idx = owner[None, None, :, None].expand(ang_3.shape[:-1] + (1,))
    ang = torch.gather(ang_3, -1, idx)[..., 0]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) -> rotated x (rotate-half)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32,
               device=None):
    return {"table": torch.randn((vocab, d), generator=gen, dtype=dtype,
                                 device=device) * 0.02}


def embed_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, params["table"])


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]
