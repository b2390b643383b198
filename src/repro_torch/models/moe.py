"""Mixture-of-Experts: a top-k router and two execution paths.

The counterpart of ``repro.models.moe``.

* :func:`apply_dense` runs every expert on every token and combines them
  by the router's weights: exact (no capacity drops), at E/k times the
  routed work.  It is the path without a mesh, or on a mesh whose model
  axis has one device, as on one card.
* :func:`apply_ep` is expert parallelism over the ambient mesh's
  ``model`` axis, one process a device (``distributed/context.py``, the
  torch twin of ``repro``'s ``shard_map``): each rank routes its block of
  the sequence, sorts the (token, expert) pairs by expert into capacity
  slots (overflow dropped), sends each expert's slots to the rank holding
  it (an all-to-all, the slots in ``float8_e4m3fn`` bits with
  ``dispatch_fp8``), runs its E/n experts, sends the results back (an
  all-to-all) and scatter-adds them by the gates.
  :func:`apply_ep_decode`, for few tokens, keeps them replicated over the
  model axis: each rank runs its local experts on the tokens routed to
  them, then a sum over the axis.  :func:`apply` dispatches as
  ``repro``'s does.

The dtypes and the order are ``repro``'s: the router in float32, softmax,
then top-k, then the renormalisation; expert weights cast to the
activation type before the products; the combine weights cast to it
before the combine.  The expert products are plain batched matmuls in
(expert, token, feature) layout, which reads each weight once.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from repro_torch.configs.base import eff_d_expert
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.models import common


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg, dtype=torch.float32, device=None,
         lead=()):
    m = cfg.moe
    d = cfg.d_model
    fe = eff_d_expert(cfg)
    e = m.num_experts

    def normal(shape, dt, scale):
        return torch.randn(tuple(lead) + shape, generator=gen, dtype=dt,
                           device=device).mul_(scale)

    p = {
        "router": normal((d, e), torch.float32, 1.0 / math.sqrt(d)),
        "wi": normal((e, d, fe), dtype, 1.0 / math.sqrt(d)),
        "wg": normal((e, d, fe), dtype, 1.0 / math.sqrt(d)),
        "wo": normal((e, fe, d), dtype, 1.0 / math.sqrt(fe)),
    }
    if m.num_shared_experts:
        fs = fe * m.num_shared_experts
        kw = dict(dtype=dtype, device=device, lead=lead)
        p["shared"] = {"wi": common.linear_init(gen, d, fs, **kw),
                       "wg": common.linear_init(gen, d, fs, **kw),
                       "wo": common.linear_init(gen, fs, d, **kw)}
    return p


def _route(x2d: torch.Tensor, router_w: torch.Tensor, m):
    """x2d: (T, D) -> gates (T, k), sel (T, k) int64, aux loss (float32)."""
    logits = torch.matmul(x2d.float(), router_w.float())      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, sel = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # Switch-style load-balance loss + router z-loss
    me = probs.mean(dim=0)
    # the experts each token chose, as 0/1 (the top-k are distinct):
    # F.one_hot(sel).sum(1), built the same on every device (one_hot
    # checks its input on the host off CUDA, and decomposes on meta)
    # (a DTensor's blocks beside DTensor routes: the scatter is in place)
    chosen = shd.built_like(lambda sh: torch.zeros(
        sh, dtype=torch.float32, device=sel.device),
        (sel.shape[0], m.num_experts), sel, {0: 0}).scatter_(1, sel, 1.0)
    ce = chosen.mean(dim=0) / m.top_k
    lb = m.num_experts * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return gates, sel, m.router_aux_weight * lb + 1e-4 * z


def _expert_ffn(h_tokens, wi, wg, wo, act: str) -> torch.Tensor:
    """h_tokens: (E, C, D), or (C, D) given to every expert; wi/wg:
    (E, D, F), wo: (E, F, D) -> (E, C, D)."""
    hi = torch.matmul(h_tokens, wi)
    hg = torch.matmul(h_tokens, wg)
    return torch.matmul(common.act_fn(act)(hg) * hi, wo)


# ---------------------------------------------------------------------------
# Dense path (reference)
# ---------------------------------------------------------------------------

def apply_dense(params, cfg, x: torch.Tensor):
    """x: (B, S, D) -> (y (B, S, D), aux loss)."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    gates, sel, aux = _route(xf, params["router"], m)
    y_all = _expert_ffn(xf, params["wi"].to(x.dtype),
                        params["wg"].to(x.dtype), params["wo"].to(x.dtype),
                        cfg.act)                              # (E, T, D)
    # the top-k indices are distinct, so scattering the gates is exact
    comb = torch.zeros((xf.shape[0], m.num_experts), dtype=gates.dtype,
                       device=x.device).scatter(1, sel, gates).to(x.dtype)
    y = torch.einsum("te,etd->td", comb, y_all)
    y = y + _shared(params, cfg, xf)
    return y.reshape(b, s, d), aux


def _shared(params, cfg, xf):
    if "shared" not in params:
        return 0.0
    sp = params["shared"]
    kw = dict(quant=cfg.quant, bf16_grads=cfg.bf16_grads)
    h = common.linear_apply(sp["wi"], xf, **kw)
    g = common.linear_apply(sp["wg"], xf, **kw)
    return common.linear_apply(sp["wo"], common.act_fn(cfg.act)(g) * h,
                               **kw)


# ---------------------------------------------------------------------------
# Expert-parallel path: capacity dispatch and all-to-all over "model"
# ---------------------------------------------------------------------------

class _DispatchFp8(torch.autograd.Function):
    """The dispatch all-to-all in ``float8_e4m3fn``, sent as its bits in
    ``uint8`` (gloo has no fp8 type), back in the activations' type; the
    gradient takes the same way back, as JAX's transposes of the casts
    and the all-to-all do."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _fp8_all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _fp8_all_to_all(g, ctx.mesh, ctx.axis), None, None


def _fp8_all_to_all(x, mesh, axis):
    bits = x.to(torch.float8_e4m3fn).view(torch.uint8)
    got = dctx.all_to_all(bits, mesh, axis)
    return got.view(torch.float8_e4m3fn).to(x.dtype)


def _sorted_slots(fe, n_keys: int, cap: int):
    """Pairs sorted (stably) by expert key ``fe`` (T*k,): the order, and
    each one's position among its key's pairs."""
    order = torch.argsort(fe, stable=True)
    fe_s = fe[order]
    # bincount, written so that meta tensors take it (its output length
    # depends on the data, so it has no meta kernel)
    counts = torch.zeros(n_keys, dtype=torch.int64,
                         device=fe.device).index_add_(0, fe,
                                                      torch.ones_like(fe))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(fe.shape[0], device=fe.device) - starts[fe_s]
    return order, fe_s, pos


def _ep_local(xf, router_w, wi, wg, wo, *, cfg, n_shards, mesh, ep_axis):
    """One rank's body.  xf: (T_loc, D); wi/wg/wo: its (E_loc, ...)
    experts."""
    m = cfg.moe
    t, d = xf.shape
    e, k = m.num_experts, m.top_k
    e_loc = e // n_shards
    cap = int(-(-t * k * m.capacity_factor // e))  # per (device, expert)

    gates, sel, aux = _route(xf, router_w, m)
    fe = sel.reshape(-1)                               # (T*k,) expert ids
    ft = torch.arange(t * k, device=xf.device) // k    # token ids
    fg = gates.reshape(-1)
    order, fe_s, pos = _sorted_slots(fe, e, cap)
    ft_s, fg_s = ft[order], fg[order]
    valid = pos < cap
    slot = torch.where(valid, fe_s * cap + pos, e * cap)  # sentinel drops
    buf = xf.new_zeros((e * cap + 1, d)).index_put((slot,), xf[ft_s])[:-1]

    # dispatch: rows e_loc*j .. e_loc*(j+1) go to shard j
    buf = buf.reshape(n_shards, e_loc * cap, d)
    if m.dispatch_fp8:
        recv = _DispatchFp8.apply(buf, mesh, ep_axis)
    else:
        recv = dctx.all_to_all(buf, mesh, ep_axis)
    tok = recv.reshape(n_shards, e_loc, cap, d).transpose(0, 1)
    tok = tok.reshape(e_loc, n_shards * cap, d)
    y = _expert_ffn(tok, wi.to(xf.dtype), wg.to(xf.dtype), wo.to(xf.dtype),
                    cfg.act)
    y = y.reshape(e_loc, n_shards, cap, d).transpose(0, 1)
    y = y.reshape(n_shards, e_loc * cap, d)
    back = dctx.all_to_all(y, mesh, ep_axis).reshape(e * cap, d)

    gathered = back[torch.clamp_max(slot, e * cap - 1)]   # (T*k, D)
    w = (fg_s * valid).to(xf.dtype)[:, None]
    out = xf.new_zeros((t, d)).index_add(0, ft_s, gathered * w)
    return out, dctx.pmean(aux, mesh, ep_axis)


def _expert_blocks(params, mesh, repeated=()):
    """This rank's router (whole) and its experts' weights (``repeated``:
    the mesh axes whose devices run the experts alike)."""
    return ((dctx.local_block(params["router"], mesh, P(None, None),
                              repeated),)
            + tuple(dctx.local_block(params[n], mesh, P("model", None, None),
                                     repeated)
                    for n in ("wi", "wg", "wo")))


def apply_ep(params, cfg, x: torch.Tensor, mesh):
    """x: (B, S, D), global; each rank takes its block sharded over the
    data axes (batch) and ``model`` (sequence).  Shared experts run
    outside, on the whole x."""
    m = cfg.moe
    b, s, d = x.shape
    dp = dctx.data_axes(mesh)
    n_shards = mesh.shape["model"]
    if m.num_experts % n_shards:
        raise ValueError(f"{m.num_experts} experts over {n_shards} shards")
    spec = P(dp, "model", None)
    xl = dctx.local_block(x, mesh, spec)
    bl, sl, _ = xl.shape
    out, aux = _ep_local(xl.reshape(-1, d), *_expert_blocks(params, mesh),
                         cfg=cfg, n_shards=n_shards, mesh=mesh,
                         ep_axis="model")
    for ax in dp:
        aux = dctx.pmean(aux, mesh, ax)
    out, aux = _global(out.reshape(bl, sl, d), aux, mesh, spec, x)
    if "shared" in params:
        out = out + _shared(params, cfg, x.reshape(-1, d)).reshape(b, s, d)
    return out, aux


def _global(out, aux, mesh, spec, x):
    """The body's output block as the global value of ``x``'s shape, and
    its (replicated) aux loss; on a DTensor ``x``, both DTensors on its
    mesh, so that their gradients come back as blocks."""
    dmesh = getattr(x, "device_mesh", None)
    out = dctx.global_value(out, mesh, spec, x.shape, dmesh)
    if dmesh is not None:
        aux = dctx.global_value(aux, mesh, P(), aux.shape, dmesh)
    return out, aux


# ---------------------------------------------------------------------------
# Decode path: tokens are few (B x 1): replicated over the model axis, each
# shard runs its local experts on the tokens routed to them, then a sum.
# No all-to-all: the traffic is the output's sum (B x D a layer).
# ---------------------------------------------------------------------------

def _ep_decode_local(xf, router_w, wi, wg, wo, *, cfg, n_shards, mesh,
                     ep_axis):
    m = cfg.moe
    t, d = xf.shape
    e, k = m.num_experts, m.top_k
    e_loc = e // n_shards
    e_off = dctx.axis_index(mesh, ep_axis) * e_loc
    cap = max(1, int(-(-t * k * max(m.capacity_factor, 4.0) // e)))

    gates, sel, aux = _route(xf, router_w, m)
    fe = sel.reshape(-1) - e_off                      # local expert ids
    ft = torch.arange(t * k, device=xf.device) // k
    fg = gates.reshape(-1)
    local = (fe >= 0) & (fe < e_loc)
    fe_key = torch.where(local, fe, e_loc)            # sentinel bucket
    order, fe_s, pos = _sorted_slots(fe_key, e_loc + 1, cap)
    ft_s, fg_s, loc_s = ft[order], fg[order], local[order]
    valid = loc_s & (pos < cap)
    slot = torch.where(valid, fe_s * cap + pos, e_loc * cap)
    buf = xf.new_zeros((e_loc * cap + 1, d)).index_put((slot,),
                                                       xf[ft_s])[:-1]
    y = _expert_ffn(buf.reshape(e_loc, cap, d), wi.to(xf.dtype),
                    wg.to(xf.dtype), wo.to(xf.dtype), cfg.act)
    y = y.reshape(e_loc * cap, d)
    gathered = y[torch.clamp_max(slot, e_loc * cap - 1)]
    w = (fg_s * valid).to(xf.dtype)[:, None]
    out = xf.new_zeros((t, d)).index_add(0, ft_s, gathered * w)
    out = dctx.psum(out, mesh, ep_axis)
    return out, dctx.pmean(aux, mesh, ep_axis)


def apply_ep_decode(params, cfg, x: torch.Tensor, mesh):
    """x: (B, S, D), global; the batch split over the data axes where
    they divide it, the tokens replicated over ``model``."""
    b, s, d = x.shape
    dp = dctx.data_axes(mesh)
    n_shards = mesh.shape["model"]
    dp_size = math.prod(mesh.shape[a] for a in dp)
    spec = P(dp if b % dp_size == 0 else None, None, None)
    # a batch that does not split over the data axes: their devices run
    # the experts alike, its gradients are whole there, and the aux loss
    # is the same on each (its mean over them, the identity, would hand
    # each a share of a gradient that is not summed there)
    repeated = () if spec[0] else dp
    xl = dctx.local_block(x, mesh, spec, repeated)
    bl, sl, _ = xl.shape
    out, aux = _ep_decode_local(xl.reshape(-1, d),
                                *_expert_blocks(params, mesh, repeated),
                                cfg=cfg,
                                n_shards=n_shards, mesh=mesh,
                                ep_axis="model")
    for ax in dp:
        if ax not in repeated:
            aux = dctx.pmean(aux, mesh, ax)
    out, aux = _global(out.reshape(bl, sl, d), aux, mesh, spec, x)
    if "shared" in params:
        out = out + _shared(params, cfg, x.reshape(-1, d)).reshape(b, s, d)
    return out, aux


def apply(params, cfg, x: torch.Tensor):
    """Dispatch on ``cfg.moe.impl``, the ambient mesh
    (``context.current_mesh``) and the shape, as ``repro``'s ``apply``
    does."""
    m = cfg.moe
    mesh = dctx.current_mesh()
    impl = m.impl
    n = dctx.model_axis_size(mesh)
    ep_ok = (mesh is not None and n > 1 and m.num_experts % n == 0
             and m.num_experts >= n)
    if impl == "auto":
        impl = "ep" if ep_ok else "dense"
    if impl == "ep" and ep_ok:
        dp_size = math.prod(mesh.shape[a] for a in dctx.data_axes(mesh))
        if (x.shape[1] % n == 0 and x.shape[1] >= n
                and x.shape[0] % dp_size == 0):
            return apply_ep(params, cfg, x, mesh)
        return apply_ep_decode(params, cfg, x, mesh)
    return apply_dense(params, cfg, x)


# ---------------------------------------------------------------------------
# Routing records: comparing the experts two runs chose
# ---------------------------------------------------------------------------

NEAR_TIE = 1e-5    # the k-th and (k+1)-th probabilities this close: a tie


@contextlib.contextmanager
def record_routes():
    """Record every routing :func:`apply_dense` makes while open: a list,
    in call order, of (the chosen experts (T, k) sorted, the gap between
    the k-th and (k+1)-th probabilities (T,)) as numpy arrays.  Only set
    membership matters to the dense combine, which sums over k."""
    global _route
    records, real = [], _route

    def spy(x2d, router_w, m):
        gates, sel, aux = real(x2d, router_w, m)
        with torch.no_grad():
            if m.top_k < m.num_experts:
                probs = torch.softmax(torch.matmul(x2d.float(),
                                                   router_w.float()), dim=-1)
                top = torch.topk(probs, m.top_k + 1, dim=-1).values
                gap = (top[:, m.top_k - 1] - top[:, m.top_k]).cpu().numpy()
            else:
                gap = np.full(sel.shape[0], np.inf, np.float32)
        records.append((sel.sort(dim=-1).values.cpu().numpy(), gap))
        return gates, sel, aux

    _route = spy
    try:
        yield records
    finally:
        _route = real


def route_table(records, segments, n_layers: int):
    """Key one run's routing records by (MoE layer, batch row, position).
    ``segments``: the run's forward calls in order, each (first position,
    length), each making ``n_layers`` routings of (B x length) tokens."""
    table, it = {}, iter(records)
    for start, length in segments:
        for layer in range(n_layers):
            sel, gap = next(it)
            for t in range(sel.shape[0]):
                table[(layer, t // length, start + t % length)] = (
                    tuple(sel[t].tolist()), float(gap[t]))
    if next(it, None) is not None:
        raise ValueError("more routing records than segments x layers")
    return table


def route_divergence(a, b, tol: float = NEAR_TIE):
    """Where the route tables (:func:`route_table`) of two runs chose
    different experts.

    A token routed differently changes its row's hidden states at later
    layers and at its own and later positions; inside that shadow any
    routing may differ.  Every difference outside the shadow of an
    earlier one must be a near-tie (a gap at most ``tol`` in either run)
    and raises ``AssertionError`` otherwise.  Returns ({row: the first
    such position}, their count): outputs at and past that position of
    the row are not comparable."""
    roots = []
    for key in sorted(k for k in a.keys() & b.keys() if a[k][0] != b[k][0]):
        layer, row, pos = key
        if any(r == row and layer > lr and pos >= p for lr, r, p in roots):
            continue
        if min(a[key][1], b[key][1]) > tol:
            raise AssertionError(
                f"layer {layer}, row {row}, position {pos} routed to "
                f"{a[key][0]} and {b[key][0]} with no near-tie (gaps "
                f"{a[key][1]:.3e}, {b[key][1]:.3e})")
        roots.append(key)
    first = {}
    for _, row, pos in roots:
        first[row] = min(first.get(row, pos), pos)
    return first, len(roots)
