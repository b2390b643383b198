"""Mamba (S6) block for the Jamba hybrid: the selective state-space mixer.

The counterpart of ``repro.models.mamba``.  Projections and the causal
conv run over the whole sequence at once; only the (B, d_inner, d_state)
float32 recurrence runs token by token, ``op_cost.scan`` (a Python loop)
here where ``repro`` runs ``lax.scan`` (a decode step is the loop's one
step).
Decode carries (conv_state, ssm_state) explicitly.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.launch.op_cost import scan
from repro_torch.models import common


def _dims(cfg):
    mc = cfg.mamba
    d_inner = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)
    return d_inner, dt_rank, mc.d_state, mc.d_conv


def init(gen: torch.Generator, cfg, dtype=torch.float32, device=None,
         lead=()):
    d = cfg.d_model
    di, dtr, ds, dc = _dims(cfg)
    lead = tuple(lead)
    kw = dict(dtype=dtype, device=device, lead=lead)

    def normal(shape, scale):
        return torch.randn(lead + shape, generator=gen, dtype=dtype,
                           device=device).mul_(scale)

    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": common.linear_init(gen, d, 2 * di, **kw),
        "conv_w": normal((dc, di), 1.0 / math.sqrt(dc)),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=device),
        "x_proj": common.linear_init(gen, di, dtr + 2 * ds, **kw),
        "dt_proj": {"w": normal((dtr, di), 1.0 / math.sqrt(dtr)),
                    "b": torch.full(lead + (di,), math.log(math.expm1(0.01)),
                                    dtype=dtype, device=device)},
        "A_log": a_log.expand(lead + (di, ds)).clone(),
        "D": torch.ones(lead + (di,), dtype=torch.float32, device=device),
        "out_proj": common.linear_init(gen, di, d, **kw),
        "dt_norm": common.rmsnorm_init(dtr, **kw),    # Jamba's extra norms
        "b_norm": common.rmsnorm_init(ds, **kw),
        "c_norm": common.rmsnorm_init(ds, **kw),
    }


def _causal_conv(x, w, b, state=None):
    """x: (B, S, di); w: (dc, di) depthwise causal; state: (B, dc-1, di)
    or None.  Returns (out, new_state)."""
    dc = w.shape[0]
    if state is None:
        pad = shd.built_like(lambda sh: torch.zeros(
            sh, dtype=x.dtype, device=x.device),
            (x.shape[0], dc - 1, x.shape[2]), x, {0: 0, 2: 2})
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(dc))
    new_state = xp[:, -(dc - 1):, :] if dc > 1 else None
    return out + b, new_state


def _ssm_inputs(params, cfg, xc):
    """The shared projections: xc (B, S, di) -> dt (B, S, di), B and C
    (B, S, ds), all float32."""
    di, dtr, ds, _ = _dims(cfg)
    proj = common.linear_apply(params["x_proj"], xc, quant=cfg.quant,
                               bf16_grads=cfg.bf16_grads)
    # x_proj contracts d_inner, which "model" splits: its partial sums are
    # reduced here, once a layer, as XLA does, so that dt, B and C reach
    # the per-token recurrence whole (the identity without a mesh)
    proj = shd.constrain(proj, ("dp", None, None))
    dt, bm, cm = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = common.rmsnorm_apply(params["dt_norm"], dt, cfg.norm_eps)
    bm = common.rmsnorm_apply(params["b_norm"], bm, cfg.norm_eps)
    cm = common.rmsnorm_apply(params["c_norm"], cm, cfg.norm_eps)
    dt = common.matmul(dt, params["dt_proj"]["w"])
    dt = F.softplus(dt.float() + params["dt_proj"]["b"].float())
    return dt, bm.float(), cm.float()


def apply(params, cfg, x: torch.Tensor, *, state=None):
    """x: (B, S, d_model) -> (y, new_state); state = (conv, ssm), None
    from zeros."""
    b, s, _ = x.shape
    di, _, ds, _ = _dims(cfg)
    kw = dict(quant=cfg.quant, bf16_grads=cfg.bf16_grads)
    xz = common.linear_apply(params["in_proj"], x, **kw)
    xin, z = xz.chunk(2, dim=-1)
    xc, new_conv = _causal_conv(xin, params["conv_w"].to(x.dtype),
                                params["conv_b"].to(x.dtype),
                                state[0] if state is not None else None)
    xc = F.silu(xc)
    dt, bm, cm = _ssm_inputs(params, cfg, xc)
    a = -torch.exp(params["A_log"])                     # (di, ds)
    xf = xc.float()
    h = (state[1] if state is not None
         else shd.built_like(lambda sh: torch.zeros(
             sh, dtype=torch.float32, device=x.device), (b, di, ds), xf,
             {0: 0, 1: 2}))

    def step(h, t):
        dtt = dt[:, t]
        da = torch.exp(dtt[:, :, None] * a[None])       # (B, di, ds)
        dbx = (dtt * xf[:, t])[:, :, None] * bm[:, t, None, :]
        h = da * h + dbx
        return h, torch.einsum("bds,bs->bd", h, cm[:, t])

    h, y = scan(shd.carry_placed(step, h), h, s, dim=1)
    y = y + xf * params["D"][None, None, :]
    y = y.to(x.dtype) * F.silu(z)
    out = common.linear_apply(params["out_proj"], y, **kw)
    return out, (new_conv, h)


def init_state(cfg, batch: int, dtype=torch.float32, device=None, lead=()):
    di, _, ds, dc = _dims(cfg)
    lead = tuple(lead)
    return (torch.zeros(lead + (batch, dc - 1, di), dtype=dtype,
                        device=device),
            torch.zeros(lead + (batch, di, ds), dtype=torch.float32,
                        device=device))
