"""Deterministic synthetic LM token pipeline.

The counterpart of ``repro.data.tokens``: the batch for global step
``s`` is a pure function of ``(seed, s, host_id)``, a noisy affine Markov
chain over the vocab, ``tok -> (tok * 31 + 7) % V`` with 10% of steps
replaced by a uniform draw, so models show real learning signal offline.

``jax.random`` cannot be reproduced in PyTorch, so the draws (start
tokens, noise mask, noise tokens) come from ``torch.Generator``\\ s seeded
from ``(seed, step, host_id)``: the tokens are not ``repro``'s tokens.
The chain itself is :func:`markov_chain`, which the tests hold against
``repro``'s given the same draws.  A multi-codebook config (MusicGen)
draws ``(B, S+1, ncb)`` and runs one chain a codebook; a config without
an input table (the VLM stub) trains on :func:`vlm_batch_for_step`'s
patch embeddings and M-RoPE grid.  Draws are made on the host and the
batch is placed on ``device``.
"""

from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.data.images import step_generator
from repro_torch.models import common


def batch_for_step(cfg, step: int, *, global_batch: int, seq_len: int,
                   seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                   device=None):
    """Returns {"tokens": (B_host, S), "labels": (B_host, S)} int32, each
    (B_host, S, ncb) for a multi-codebook config."""
    if global_batch % num_hosts:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{num_hosts} hosts")
    out = _gen(step_generator(seed, step, host_id), cfg,
               global_batch // num_hosts, seq_len)
    dev = _device.resolve(device)
    return {k: v.to(dev) for k, v in out.items()}


def markov_chain(x0: torch.Tensor, noise: torch.Tensor, rand: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """x0 (B, ...), noise (B, T, ...) bool and rand (B, T, ...) ints ->
    (B, T, ...): step t is ``rand[:, t]`` where ``noise[:, t]`` else
    ``(prev * 31 + 7) % V``, prev starting at ``x0`` (which is not part of
    the output); every trailing index (a codebook) is a chain of its own,
    as ``repro``'s ``lax.scan`` carries ``x0`` of shape (B, ncb)."""
    tok = x0.to(torch.int64)
    seq = []
    for t in range(noise.shape[1]):
        tok = torch.where(noise[:, t], rand[:, t].to(torch.int64),
                          (tok * 31 + 7) % vocab)
        seq.append(tok)
    return torch.stack(seq, dim=1)


def _gen(gen: torch.Generator, cfg, batch: int, seq_len: int):
    v, ncb = cfg.vocab_size, cfg.num_codebooks
    lane = (ncb,) if ncb > 1 else ()
    x0 = torch.randint(0, v, (batch,) + lane, generator=gen)
    noise = torch.rand((batch, seq_len + 1) + lane, generator=gen) < 0.1
    rand = torch.randint(0, v, (batch, seq_len + 1) + lane, generator=gen)
    seq = markov_chain(x0, noise, rand, v)               # (B, S+1, ...)
    return {"tokens": seq[:, :-1].to(torch.int32),
            "labels": seq[:, 1:].to(torch.int32)}


def vlm_batch_for_step(cfg, step: int, *, global_batch: int, seq_len: int,
                       seed: int = 0, device=None):
    """The VLM stub's batch: {"embeds": (B, S, d_model) precomputed "patch
    embeddings" in ``cfg.dtype`` at scale 0.02, "labels": (B, S) int32,
    "positions": (B, S, 3) int32}, the grid ``repro`` gives M-RoPE (t a
    block of side² patches, h and w rasterised within it).

    The draws come from a generator keyed by ``(seed + 7, step)`` as
    ``repro``'s key, with ``(0, 1)`` after it: ``SeedSequence`` ignores
    trailing zeros, so ``(seed + 7, step)`` alone would be
    :func:`batch_for_step`'s key at host 0."""
    gen = step_generator(seed + 7, step, 0, 1)
    embeds = torch.randn((global_batch, seq_len, cfg.d_model), generator=gen,
                         dtype=common.torch_dtype(cfg.dtype)) * 0.02
    labels = _gen(gen, cfg, global_batch, seq_len)["labels"]
    side = max(1, int(seq_len ** 0.5))
    idx = torch.arange(seq_len)
    pos = torch.stack([idx // (side * side), (idx // side) % side,
                       idx % side], dim=-1)
    positions = pos[None].expand(global_batch, seq_len, 3).to(torch.int32)
    dev = _device.resolve(device)
    return {"embeds": embeds.to(dev), "labels": labels.to(dev),
            "positions": positions.contiguous().to(dev)}
