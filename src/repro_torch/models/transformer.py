"""Model assembly: the pattern-based decoder, dense attention blocks.

The counterpart of ``repro.models.transformer``.  A config's layer stack
is ``prefix`` (unscanned leading layers) followed by ``pattern`` repeated
R times over parameters stacked on a leading R axis, the same parameter
and cache layout as ``repro``'s; ``repro``'s ``lax.scan`` over the stack
is a Python loop over ``r`` here.

Block kinds ported: ``attn``, ``local``, ``global`` and ``dense``.
``attn_moe``, ``mamba``, ``mamba_moe``, ``rwkv`` and ``num_codebooks > 1``
raise ``NotImplementedError``: they are ROADMAP §1 item 5's remaining
work.  ``forward`` returns final hidden states; ``lm_logits`` maps them
to logits for serving.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import device as _device
from repro_torch.configs import base as cfgbase
from repro_torch.models import attention, common, mlp

ATTN_KINDS = ("attn", "local", "global", "dense")


def _check_kind(kind: str) -> None:
    if kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP §1 item 5: MoE, "
            f"mamba and rwkv6 blocks)")


def _check_cfg(cfg) -> None:
    for kind in cfg.prefix + cfg.pattern:
        _check_kind(kind)
    if cfg.num_codebooks > 1:
        raise NotImplementedError(
            "multi-codebook (MusicGen) embeddings and heads are not ported "
            "yet (ROADMAP §1 item 5)")


def tree_index(tree, r: int):
    """Slice ``r`` of every leaf of a nest of dicts/lists/tuples."""
    if isinstance(tree, dict):
        return {k: tree_index(v, r) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_index(v, r) for v in tree)
    return tree[r]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(gen, cfg, dtype, device, lead=()):
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device, lead=lead)
    p: Dict[str, Any] = {"ln1": common.rmsnorm_init(d, **kw)}
    p["attn"] = attention.init(gen, cfg, **kw)
    p["ln2"] = common.rmsnorm_init(d, **kw)
    p["mlp"] = mlp.init(gen, d, cfgbase.eff_d_ff(cfg), **kw)
    if cfg.post_block_norm:
        p["ln1_post"] = common.rmsnorm_init(d, **kw)
        p["ln2_post"] = common.rmsnorm_init(d, **kw)
    return p


def init_params(cfg, *, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters in ``repro``'s layout, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (not ``repro``'s values)."""
    _check_cfg(cfg)
    dev = _device.resolve(device)
    dtype = common.torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: Dict[str, Any] = {}
    if cfg.embed_inputs:
        params["embed"] = common.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                            dtype, dev)
    if cfg.prefix:
        params["prefix"] = [_block_init(gen, cfg, dtype, dev)
                            for _ in cfg.prefix]
    r = cfg.num_pattern_repeats
    params["blocks"] = {f"pos{i}": _block_init(gen, cfg, dtype, dev,
                                               lead=(r,))
                        for i in range(len(cfg.pattern))}
    params["final_norm"] = common.rmsnorm_init(cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = common.linear_init(gen, cfg.d_model,
                                               cfg.vocab_size, dtype=dtype,
                                               device=dev)
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _residual(x, y, params, which, cfg):
    if cfg.post_block_norm:
        y = common.rmsnorm_apply(params[f"{which}_post"], y, cfg.norm_eps)
    return x + y


def block_apply(params, cfg, kind, x, cos, sin, *, mode="train",
                cache=None, cache_len=None):
    """Returns (x, new_cache, aux)."""
    _check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = common.rmsnorm_apply(params["ln1"], x, cfg.norm_eps)
    y, new_kv = attention.apply(params["attn"], cfg, h, cos, sin, kind=kind,
                                mode=mode, cache=cache, cache_len=cache_len)
    x = _residual(x, y, params, "ln1", cfg)
    h = common.rmsnorm_apply(params["ln2"], x, cfg.norm_eps)
    y = mlp.apply(params["mlp"], h, act=cfg.act, quant=cfg.quant,
                  bf16_grads=cfg.bf16_grads)
    x = _residual(x, y, params, "ln2", cfg)
    return x, new_kv, aux


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed(params, cfg, batch):
    if not cfg.embed_inputs:
        x = batch["embeds"]
    else:
        x = common.embed_apply(params["embed"], batch["tokens"])
    if getattr(cfg, "embed_scale", False):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _rope(cfg, batch, x):
    b, s = x.shape[:2]
    pos = batch.get("positions")
    if cfg.mrope:
        if pos is None:
            pos = torch.arange(s, device=x.device)[None, :, None].expand(
                b, s, 3)
        return common.mrope_cos_sin(pos, cfg.head_dim, cfg.rope_theta,
                                    cfg.mrope_sections)
    if pos is None:
        pos = torch.arange(s, device=x.device)[None, :].expand(b, s)
    return common.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)


def forward(params, cfg, batch, *, mode: str = "train",
            cache: Optional[dict] = None, cache_len=None):
    """Returns (hidden (B,S,D), new_cache, aux_loss).

    Prefill returns the cache as (k, v) leaves of (R, B, S, KH, D); decode
    updates the given cache in place and returns it.
    """
    _check_cfg(cfg)
    x = _embed(params, cfg, batch).to(common.dtype_of(cfg))
    cos, sin = _rope(cfg, batch, x)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    new_prefix_cache = []
    for i, kind in enumerate(cfg.prefix):
        c = cache["prefix"][i] if cache is not None else None
        x, nc, aux = block_apply(params["prefix"][i], cfg, kind, x, cos, sin,
                                 mode=mode, cache=c, cache_len=cache_len)
        new_prefix_cache.append(nc)
        aux_total = aux_total + aux

    blk_cache = cache["blocks"] if cache is not None else None
    per_layer = {f"pos{i}": [] for i in range(len(cfg.pattern))}
    for r in range(cfg.num_pattern_repeats):
        for i, kind in enumerate(cfg.pattern):
            key = f"pos{i}"
            c = (tree_index(blk_cache[key], r) if blk_cache is not None
                 else None)
            x, nc, aux = block_apply(tree_index(params["blocks"][key], r),
                                     cfg, kind, x, cos, sin, mode=mode,
                                     cache=c, cache_len=cache_len)
            per_layer[key].append(nc)
            aux_total = aux_total + aux

    x = common.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if mode == "train":
        return x, None, aux_total
    if mode == "decode":       # the layers wrote into views of the stack
        new_blk_cache = blk_cache
    else:
        new_blk_cache = {key: tuple(torch.stack(leaves) for leaves in
                                    zip(*layers))
                         for key, layers in per_layer.items()}
    return x, {"prefix": new_prefix_cache, "blocks": new_blk_cache}, aux_total


def lm_logits(params, cfg, hidden):
    """hidden (B,S,D) -> logits (B,S,V)."""
    _check_cfg(cfg)
    if cfg.tie_embeddings:
        logits = torch.matmul(hidden,
                              params["embed"]["table"].to(hidden.dtype).t())
    else:
        logits = common.linear_apply(params["lm_head"], hidden)
    if cfg.logit_softcap:
        logits = common.softcap(logits, cfg.logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# Cache construction (decode)
# ---------------------------------------------------------------------------

def _block_cache(cfg, batch: int, max_len: int, dtype, device, lead=()):
    shape = tuple(lead) + (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_cache(cfg, batch: int, max_len: int, device=None):
    _check_cfg(cfg)
    dev = _device.resolve(device)
    dtype = common.dtype_of(cfg)
    prefix = [_block_cache(cfg, batch, max_len, dtype, dev)
              for _ in cfg.prefix]
    r = cfg.num_pattern_repeats
    blocks = {f"pos{i}": _block_cache(cfg, batch, max_len, dtype, dev,
                                      lead=(r,))
              for i in range(len(cfg.pattern))}
    return {"prefix": prefix, "blocks": blocks}
