"""Mixture-of-Experts: a top-k router and the dense execution path.

The counterpart of ``repro.models.moe``.  :func:`apply_dense` runs every
expert on every token and combines them by the router's weights: exact
(no capacity drops), at E/k times the routed work.  It is the path
``repro`` takes without a mesh, the only case one card reaches, so
:func:`apply` takes it there.  The expert-parallel paths (``apply_ep``,
``apply_ep_decode``: capacity dispatch and all-to-all over a mesh's model
axis) need a mesh and raise: ROADMAP §1 item 5.5.

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
    chosen = torch.zeros((sel.shape[0], m.num_experts), dtype=torch.float32,
                         device=sel.device).scatter_(1, sel, 1.0)
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
# Expert-parallel paths: not ported
# ---------------------------------------------------------------------------

def _ep_not_ported(name: str):
    raise NotImplementedError(
        f"moe.{name} needs a mesh: expert parallelism (capacity dispatch, "
        f"all-to-all) is not ported yet (ROADMAP §1 item 5.5)")


def apply_ep(params, cfg, x, mesh):
    _ep_not_ported("apply_ep")


def apply_ep_decode(params, cfg, x, mesh):
    _ep_not_ported("apply_ep_decode")


def apply(params, cfg, x: torch.Tensor, mesh=None):
    """Dispatch on ``cfg.moe.impl``, the mesh and the shape, as ``repro``'s
    ``apply`` does on its ambient mesh.  ``mesh``: the devices of an
    expert-parallel group (a tuple of ``torch.device``), None on one card,
    which takes the dense path; a mesh the expert-parallel paths would
    take raises rather than run dense."""
    m = cfg.moe
    n = len(mesh) if mesh is not None else 1
    ep_ok = (mesh is not None and n > 1 and m.num_experts % n == 0
             and m.num_experts >= n)
    impl = m.impl
    if impl == "auto":
        impl = "ep" if ep_ok else "dense"
    if impl == "ep" and ep_ok:
        if x.shape[1] % n == 0 and x.shape[1] >= n:
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
