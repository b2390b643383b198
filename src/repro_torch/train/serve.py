"""Serving: building the prefill and decode steps, and sampling.

The counterpart of ``repro.train.serve``:

* ``prefill_step`` runs the full prompt and returns last-position logits
  and a cache padded to ``max_len``;
* ``decode_step`` advances every sequence of the batch one token against
  the cache, which it updates in place (the attention blocks' KV, the
  recurrent blocks' constant-size states);
* ``sample`` is greedy (``torch.argmax``, the first maximum, as
  ``jnp.argmax``) or temperature sampling by the Gumbel-max trick from a
  ``torch.Generator`` (``repro``'s distribution, not its bits).

The steps run eagerly; ``repro`` ``jax.jit``\\ s them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import transformer


def _pad_cache_to(cfg, cache, max_len: int):
    """Pad the prefill KV leaves of the attention blocks, (B, S, KH, D) or
    stacked (R, B, S, KH, D), to ``max_len`` along the sequence axis,
    ndim - 3; the recurrent blocks' states have no sequence axis and stay
    as they are."""
    def pad(leaf):
        s_ax = leaf.ndim - 3
        cur = leaf.shape[s_ax]
        if cur == max_len:
            return leaf
        widths = [0, 0] * (leaf.ndim - 1 - s_ax) + [0, max_len - cur]
        return torch.nn.functional.pad(leaf, widths)

    def by_kind(kind, c):
        return (tuple(pad(x) for x in c) if kind in transformer.ATTN_KINDS
                else c)

    return {"prefix": [by_kind(kind, c)
                       for kind, c in zip(cfg.prefix, cache["prefix"])],
            "blocks": {f"pos{i}": by_kind(kind, cache["blocks"][f"pos{i}"])
                       for i, kind in enumerate(cfg.pattern)}}


def build_prefill_step(cfg, max_len: Optional[int] = None):
    def prefill_step(params, batch):
        h, cache, _ = transformer.forward(params, cfg, batch, mode="prefill")
        logits = transformer.lm_logits(params, cfg, h[:, -1:])
        if max_len is not None:
            cache = _pad_cache_to(cfg, cache, max_len)
        return logits, cache
    return prefill_step


def build_decode_step(cfg):
    def decode_step(params, cache, tokens_or_embeds, cache_len: int):
        """tokens: (B, 1), (B, 1, ncb) with codebooks, or embeds (B, 1, D)
        without an input table; cache_len: the position of the new token
        (all three M-RoPE axes take it, as in ``repro``)."""
        if cfg.embed_inputs:
            batch = {"tokens": tokens_or_embeds}
        else:
            batch = {"embeds": tokens_or_embeds}
        b = tokens_or_embeds.shape[0]
        pos = torch.full((b, 1), int(cache_len), dtype=torch.int32,
                         device=tokens_or_embeds.device)
        batch["positions"] = pos[..., None].expand(b, 1, 3) if cfg.mrope \
            else pos
        h, cache, _ = transformer.forward(params, cfg, batch, mode="decode",
                                          cache=cache, cache_len=cache_len)
        return transformer.lm_logits(params, cfg, h), cache
    return decode_step


def sample(gen: Optional[torch.Generator], logits: torch.Tensor,
           temperature: float = 0.0) -> torch.Tensor:
    """logits (B, 1, V) -> int32 token ids (B, 1); (B, 1, ncb, V) ->
    (B, 1, ncb) with codebooks, each codebook drawn on its own."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    # Gumbel-max: argmax(logits / T + G), G = -log(E), E ~ Exp(1)
    e = torch.empty(logits.shape, dtype=torch.float32,
                    device=logits.device).exponential_(generator=gen)
    return torch.argmax(logits.float() / temperature - torch.log(e),
                        dim=-1).to(torch.int32)
