"""Gated MLP (SwiGLU/GeGLU) with optional BinaryNet quantization.

The counterpart of ``repro.models.mlp``.
"""

from __future__ import annotations

import torch

from repro_torch.models import common


def init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32,
         device=None, lead=()):
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "wi": common.linear_init(gen, d_model, d_ff, **kw),
        "wg": common.linear_init(gen, d_model, d_ff, **kw),
        "wo": common.linear_init(gen, d_ff, d_model, **kw),
    }


def apply(params, x: torch.Tensor, *, act: str = "silu", quant: str = "none",
          bf16_grads: bool = False) -> torch.Tensor:
    h = common.linear_apply(params["wi"], x, quant=quant,
                            bf16_grads=bf16_grads)
    g = common.linear_apply(params["wg"], x, quant=quant,
                            bf16_grads=bf16_grads)
    h = common.act_fn(act)(g) * h
    return common.linear_apply(params["wo"], h, quant=quant,
                               bf16_grads=bf16_grads)
