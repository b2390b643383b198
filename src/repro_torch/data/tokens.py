"""Deterministic synthetic LM token pipeline.

The counterpart of ``repro.data.tokens``: the batch for global step
``s`` is a pure function of ``(seed, s, host_id)``, a noisy affine Markov
chain over the vocab, ``tok -> (tok * 31 + 7) % V`` with 10% of steps
replaced by a uniform draw, so models show real learning signal offline.

``jax.random`` cannot be reproduced in PyTorch, so the draws (start
tokens, noise mask, noise tokens) come from ``torch.Generator``\\ s seeded
from ``(seed, step, host_id)``: the tokens are not ``repro``'s tokens.
The chain itself is :func:`markov_chain`, which the tests hold against
``repro``'s given the same draws.  Draws are made on the host and the
batch is placed on ``device``.
"""

from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.data.images import step_generator


def batch_for_step(cfg, step: int, *, global_batch: int, seq_len: int,
                   seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                   device=None):
    """Returns {"tokens": (B_host, S), "labels": (B_host, S)} int32."""
    if global_batch % num_hosts:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{num_hosts} hosts")
    out = _gen(step_generator(seed, step, host_id), cfg,
               global_batch // num_hosts, seq_len)
    dev = _device.resolve(device)
    return {k: v.to(dev) for k, v in out.items()}


def markov_chain(x0: torch.Tensor, noise: torch.Tensor, rand: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """x0 (B,), noise (B, T) bool and rand (B, T) ints -> (B, T): step t
    is ``rand[:, t]`` where ``noise[:, t]`` else ``(prev * 31 + 7) % V``,
    prev starting at ``x0`` (which is not part of the output)."""
    tok = x0.to(torch.int64)
    seq = []
    for t in range(noise.shape[1]):
        tok = torch.where(noise[:, t], rand[:, t].to(torch.int64),
                          (tok * 31 + 7) % vocab)
        seq.append(tok)
    return torch.stack(seq, dim=1)


def _gen(gen: torch.Generator, cfg, batch: int, seq_len: int):
    if cfg.num_codebooks > 1:
        raise NotImplementedError("multi-codebook token streams are not "
                                  "ported yet (ROADMAP §1 item 5)")
    v = cfg.vocab_size
    x0 = torch.randint(0, v, (batch,), generator=gen)
    noise = torch.rand((batch, seq_len + 1), generator=gen) < 0.1
    rand = torch.randint(0, v, (batch, seq_len + 1), generator=gen)
    seq = markov_chain(x0, noise, rand, v)               # (B, S+1)
    return {"tokens": seq[:, :-1].to(torch.int32),
            "labels": seq[:, 1:].to(torch.int32)}
