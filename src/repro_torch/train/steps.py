"""Step builders: train / eval, with chunked cross-entropy.

The counterpart of ``repro.train.steps``.  The LM head + softmax is the
peak-memory site at large vocab: :func:`chunked_ce` runs the sequence in
``cfg.loss_chunk`` slices, each under ``torch.utils.checkpoint`` (its
logits recomputed in the backward, as ``repro`` puts each chunk under
``jax.checkpoint``), bounding logits memory to B x chunk x V with the
same gradients.  A step is eager: ``repro`` ``jax.jit``\\ s it.

The train state is ``{"params", "opt_state", "step"}`` as ``repro``'s, so
``checkpoint.ckpt`` saves and restores it in either package's format;
``step`` is an int32 scalar tensor.  ``state_shape`` and ``state_specs``
are sharding, which waits for the training half of the distributed
layer (ROADMAP §1 item 5.5).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.models import transformer
from repro_torch.optim import optimizers as opt


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _ce_chunk(params, cfg, h_chunk, labels_chunk):
    """Summed CE of one chunk: (B, c, D) hidden and (B, c) labels."""
    logits = transformer.lm_logits(params, cfg, h_chunk).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels_chunk.to(torch.int64)[..., None])[..., 0]
    return torch.sum(lse - gold)


def chunked_ce(params, cfg, h, labels):
    """h: (B, S, D); labels: (B, S).  Mean CE over all tokens, a chunk of
    ``cfg.loss_chunk`` positions at a time (one chunk when it does not
    divide S)."""
    b, s, _ = h.shape
    c = min(cfg.loss_chunk, s)
    if s % c:
        c = s                               # fallback: a single chunk
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, c):
        tot = tot + checkpoint(_ce_chunk, params, cfg, h[:, i:i + c],
                               labels[:, i:i + c], use_reentrant=False)
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
        (loss, parts), grads = opt.value_and_grad(
            lambda p: loss_fn(p, batch), state["params"])
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
