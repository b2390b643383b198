"""Optimizers for the chip tier's training: pure functions over a nested
parameter dict.

The counterpart of ``repro.optim.optimizers`` (its ``adamw``, ``sgdm``,
``cosine_schedule`` and ``make``), kept in its functional shape:
``Optimizer(init, update)`` with ``update(grads, state, params, step) ->
(new_params, new_state, grad_norm)``.  ``torch.optim`` is not used,
because ``repro``'s update differs from it in ways parity needs:

* the global-norm clip runs over every leaf first;
* AdamW decays *every* leaf, including the BN running ``mean``/``var``
  that ``forward_train`` just wrote (their gradient is zero);
* ``t = step + 1`` and the bias corrections are float32, ``eps`` sits
  outside the square root.

A tree is a nest of dicts, lists and tuples with tensors at the leaves,
walked with dict keys sorted (``jax.tree`` order).  A gradient leaf that
is ``None`` (autograd's answer for a leaf the loss does not reach)
counts as zeros.  Updates are computed under ``torch.no_grad()`` into new
tensors; nothing is updated in place.

``adafactor`` is ``repro``'s optimizer for the LM substrate: a factored
second moment (row and column means) for leaves whose last two dims are
both at least ``min_dim_size_to_factor``, no momentum, update clipping to
RMS 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, step) -> (params, state, gnorm)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> List[Any]:
    """The leaves of a nest of dicts/lists/tuples, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same positions of
    ``rest`` (trees of ``tree``'s structure), rebuilt in that structure;
    leaves are visited in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def value_and_grad(fn: Callable, params) -> Tuple[Tuple[Any, Any], Any]:
    """``jax.value_and_grad(fn, has_aux=True)(params)`` for a parameter
    tree: ``fn(params) -> (loss, aux)``; returns ``((loss, aux), grads)``,
    ``grads`` in ``params``' structure, zeros where the loss does not
    reach a leaf, the loss detached."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = fn(leaves)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(grads)
    grads = tree_map(lambda p: _zeros_if_none(next(it), p), leaves)
    return (loss.detach(), aux), grads


def _zeros_if_none(g, p):
    return torch.zeros_like(p, dtype=torch.float32) if g is None else g


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Global norm
# ---------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree) if x is not None]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by min(1, max_norm / max(norm, 1e-9)); returns
    (clipped grads, norm before clipping)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn


def _fill(grads, params):
    return tree_map(lambda p, g: _zeros_if_none(g, p), params, grads)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          clip_norm: float = 1.0) -> Optimizer:
    """fp32 m/v, decoupled weight decay on every leaf, bias correction."""
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, gn = clip_by_global_norm(_fill(grads, params), clip_norm)
        lr = lr_fn(step).to(gn.device)
        t = _f32(float(step) + 1.0, gn)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t

        def upd(p, g, m, v):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            u = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype), m, v

        out = tree_map(upd, params, grads, state["m"], state["v"])
        pick = lambda i: tree_map(lambda p, o: o[i], params, out)
        return pick(0), {"m": pick(1), "v": pick(2)}, gn

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum)
# ---------------------------------------------------------------------------

def adafactor(lr_fn, decay=0.8, eps=1e-30, clip_norm: float = 1.0,
              min_dim_size_to_factor: int = 128) -> Optimizer:
    """Shazeer & Stern (2018) as ``repro`` has it: ``beta = 1 - t^-decay``,
    factored ``vr``/``vc`` for leaves whose last two dims are both at
    least ``min_dim_size_to_factor``, else a full ``v``; the update
    clipped to RMS <= 1; the global-norm clip first."""
    def _factored(shape):
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def init(params):
        def mk(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"v": tree_map(mk, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, gn = clip_by_global_norm(_fill(grads, params), clip_norm)
        lr = lr_fn(step).to(gn.device)
        t = _f32(float(step) + 1.0, gn)
        beta = 1.0 - t ** (-decay)

        def upd(p, g, s):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if "vr" in s:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = (vr[..., :, None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1, keepdim=True)[
                             ..., None], min=eps))
                u = g * torch.rsqrt(denom + eps)
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                ns = {"v": v}
            # update clipping (RMS <= 1), as in the paper
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms, min=1.0)
            return (p.to(torch.float32) - lr * u).to(p.dtype), ns

        # the walk follows params, so each leaf's state dict comes whole
        out = tree_map(upd, params, grads, state["v"])
        pick = lambda i: tree_map(lambda p, o: o[i], params, out)
        return pick(0), {"v": pick(1)}, gn

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# SGD with momentum
# ---------------------------------------------------------------------------

def sgdm(lr_fn, momentum=0.9, clip_norm: float = 0.0) -> Optimizer:
    """Momentum SGD (fp32 momentum), optional global-norm clip."""
    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32), params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads = _fill(grads, params)
        gn = global_norm(grads)
        if clip_norm:
            grads, gn = clip_by_global_norm(grads, clip_norm)
        lr = lr_fn(step).to(gn.device)

        def upd(p, g, m):
            m = momentum * m + g.to(torch.float32)
            return (p.to(torch.float32) - lr * m).to(p.dtype), m

        out = tree_map(upd, params, grads, state["m"])
        pick = lambda i: tree_map(lambda p, o: o[i], params, out)
        return pick(0), {"m": pick(1)}, gn

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Agreement of two runs
# ---------------------------------------------------------------------------

def step_tolerance(want, grads, lr: float, rel: float = 1e-4,
                   floor: float = 1e-7):
    """How far two float32 runs of one adamw step from the same params and
    state (the CPU and the GPU, or this package and ``repro``) may land
    apart, per element: ``max(rel x the leaf's max abs, floor)``, widened
    by ``2 lr`` where ``grads`` (the reference gradient) is itself within
    that tolerance of 0.  The gradients differ by float rounding (the BN
    backward sums in another order), and Adam steps by about
    ``lr x sign(g)`` however small g is, so a gradient at rounding level
    can step either way.  ``want`` and ``grads`` are trees of tensors or
    numpy arrays; returns the tree of bounds.  The BN running statistics
    have zero gradient, so their bound is loose: hold them to a relative
    tolerance instead."""
    def leaf_tol(x) -> float:
        return max(rel * float(abs(x).max()), floor)

    def bound(p, g):
        return leaf_tol(p) + (abs(g) <= leaf_tol(g)) * (2 * lr)

    return tree_map(bound, want, grads)


# ---------------------------------------------------------------------------
# Schedules + factory
# ---------------------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup over ``warmup`` steps, then a cosine from ``peak_lr``
    down to ``floor * peak_lr`` at ``total``; float32, as ``repro``'s."""
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def make(name: str, lr_fn, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgdm": sgdm}[name](
        lr_fn, **kw)
