"""Step builders: train / eval, with chunked cross-entropy.

The counterpart of ``repro.train.steps``.  The LM head + softmax is the
peak-memory site at large vocab: :func:`chunked_ce` runs the sequence in
``cfg.loss_chunk`` slices, each under ``torch.utils.checkpoint`` (its
logits recomputed in the backward, as ``repro`` puts each chunk under
``jax.checkpoint``), bounding logits memory to B x chunk x V with the
same gradients.  A step is eager: ``repro`` ``jax.jit``\\ s it.

The train state is ``{"params", "opt_state", "step"}`` as ``repro``'s, so
``checkpoint.ckpt`` saves and restores it in either package's format;
``step`` is an int32 scalar tensor.  :func:`state_shape` is the state on
meta tensors (shapes and types, nothing allocated); :func:`state_specs`
its partition specs on a mesh.  The logits of each CE chunk carry
``repro``'s sharding constraint (``sharding.constrain``: the identity
without a mesh or on one device).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer
from repro_torch.optim import optimizers as opt


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _ce_chunk(params, cfg, h_chunk, labels_chunk):
    """Summed CE of one chunk: (B, c, D) hidden and (B, c) labels, or
    (B, c, ncb) with codebooks (logits (B, c, ncb, V): the softmax and the
    gather run over the last axis either way)."""
    logits = transformer.lm_logits(params, cfg, h_chunk).to(torch.float32)
    logits = shd.constrain(
        logits, ("dp",) + (None,) * (logits.ndim - 2) + ("tp",))
    labels_chunk = labels_chunk.to(torch.int64)
    vocab_axis = shd.sharded_axis(logits, logits.ndim - 1)
    if vocab_axis is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels_chunk[..., None])[..., 0]
    else:
        lse, gold = _vocab_parallel_lse_gold(logits, labels_chunk,
                                             vocab_axis)
    return torch.sum(shd.grad_placed(lse - gold))


def _vocab_parallel_lse_gold(logits, labels, axis: int):
    """``logsumexp(logits, -1)`` and ``logits`` at ``labels`` for a DTensor
    whose vocab (last) axis is split over mesh dim ``axis``, as XLA
    partitions both: each device reduces its block (max, then the sum of
    exponentials) and picks the labels inside it (the others masked to
    0), and the (B, c) partial results are all-reduced over ``axis``;
    the logits are never gathered."""
    from torch.distributed.tensor import DTensor, Replicate
    dmesh, mesh = logits.device_mesh, dctx.current_mesh()
    name = dmesh.mesh_dim_names[axis]
    place = list(logits.placements)
    place[axis] = Replicate()            # the (B, c) results' placements
    lg = logits.to_local()
    lab = labels.redistribute(dmesh, place).to_local()
    m = dctx.pmax(lg.detach().amax(dim=-1), mesh, name)
    s = dctx.psum(torch.exp(lg - m[..., None]).sum(dim=-1), mesh, name)
    lse = torch.log(s) + m
    v = lg.shape[-1]
    rel = lab - dmesh.get_local_rank(axis) * v
    inside = (rel >= 0) & (rel < v)
    pick = torch.gather(lg, -1, torch.where(inside, rel, 0)[..., None])
    gold = dctx.psum(torch.where(inside, pick[..., 0], 0.0), mesh, name)
    return (DTensor.from_local(lse, dmesh, place),
            DTensor.from_local(gold, dmesh, place))


def chunked_ce(params, cfg, h, labels):
    """h: (B, S, D); labels: (B, S), or (B, S, ncb) with codebooks.  Mean
    CE over every label (B·S·ncb of them, as ``repro`` divides by
    ``labels.size``), a chunk of ``cfg.loss_chunk`` positions at a time
    (one chunk when it does not divide S)."""
    b, s, _ = h.shape
    c = min(cfg.loss_chunk, s)
    if s % c:
        c = s                               # fallback: a single chunk
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    chunk = dctx.under_current_mesh(_ce_chunk)
    for i in range(0, s, c):
        # no draws in a chunk: no RNG state to stash and restore
        tot = tot + checkpoint(chunk, params, cfg, h[:, i:i + c],
                               labels[:, i:i + c], use_reentrant=False,
                               preserve_rng_state=False)
    return tot / max(labels.numel(), 1)


# ---------------------------------------------------------------------------
# Train / eval steps
# ---------------------------------------------------------------------------

def make_loss_fn(cfg):
    """(params, batch) -> (loss, {"ce", "aux"})."""
    def loss_fn(params, batch):
        h, _, aux = transformer.forward(params, cfg, batch, mode="train")
        ce = chunked_ce(params, cfg, h, batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}
    return loss_fn


def build_train_step(cfg, optimizer: opt.Optimizer):
    """(state, batch) -> (new state, metrics): the loss and its gradients,
    then one optimizer update.  The old state is not changed."""
    loss_fn = make_loss_fn(cfg)

    def train_step(state, batch):
        # sharded: each gradient comes back placed as its parameter
        # (all-reduced or reduce-scattered over the batch's devices)
        (loss, parts), grads = opt.value_and_grad(
            lambda p: loss_fn(opt.tree_map(shd.grad_placed, p), batch),
            state["params"])
        new_params, new_opt, gnorm = optimizer.update(
            grads, state["opt_state"], state["params"], state["step"])
        metrics = {"loss": loss, "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(), "grad_norm": gnorm}
        return {"params": new_params, "opt_state": new_opt,
                "step": state["step"] + 1}, metrics

    return train_step


def build_eval_step(cfg):
    loss_fn = make_loss_fn(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, parts = loss_fn(params, batch)
        return {"loss": loss, **parts}

    return eval_step


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

def create_state(cfg, seed: int, optimizer: opt.Optimizer, device=None):
    """Parameters from ``seed`` (``transformer.init_params``: the port's
    own draws, not ``repro``'s), the optimizer's state and step 0, on
    ``device``."""
    dev = _device.resolve(device)
    params = transformer.init_params(cfg, seed=seed, device=dev)
    return {"params": params, "opt_state": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def state_shape(cfg, optimizer: opt.Optimizer):
    """The train state's shapes and types without allocating anything:
    :func:`create_state` on meta tensors (``repro``'s ``jax.eval_shape``
    of it)."""
    return create_state(cfg, 0, optimizer, device="meta")


def state_specs(cfg, mesh, optimizer: opt.Optimizer):
    """The partition specs of the whole train state on ``mesh``.

    Optimizer leaves mirror their parameter's spec exactly; adafactor's
    factored vectors keep the axes of the dims they keep ("vr" drops the
    last dim, "vc" the second-to-last)."""
    shapes = state_shape(cfg, optimizer)
    pspecs = shd.param_specs(cfg, mesh, shapes["params"])
    by_path = dict(shd.leaves_with_path(pspecs))

    def opt_spec(path, leaf):
        parts = list(path)
        tail = parts[-1] if parts and parts[-1] in ("vr", "vc", "v") else None
        core = parts[1:-1] if tail else parts[1:]   # strip the m|v dict key
        ref = by_path.get("/".join(core))
        if ref is None and tail is None:
            ref = by_path.get("/".join(parts[1:]))
        if ref is None:
            return shd.P(*([None] * len(leaf.shape)))
        if tail == "vr":
            return shd.P(*ref[:-1])
        if tail == "vc":
            return shd.P(*ref[:-2], ref[-1])
        return ref

    ospecs = shd.tree_map_with_path(opt_spec, shapes["opt_state"])
    return {"params": pspecs, "opt_state": ospecs, "step": shd.P()}
