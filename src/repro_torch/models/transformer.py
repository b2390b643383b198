"""Model assembly: the pattern-based decoder.

The counterpart of ``repro.models.transformer``.  A config's layer stack
is ``prefix`` (unscanned leading layers) followed by ``pattern`` repeated
R times over parameters stacked on a leading R axis, the same parameter
and cache layout as ``repro``'s; ``repro``'s ``lax.scan`` over the stack
is a Python loop over ``r`` here.

Block kinds: ``attn``, ``local``, ``global``, ``dense`` and ``attn_moe``
(attention), ``mamba`` and ``mamba_moe`` (the selective state-space
mixer), ``rwkv`` (RWKV-6, which keeps its own norm and channel mix);
``*_moe`` replaces the MLP by the mixture of experts.  A multi-codebook
config (MusicGen, ``num_codebooks > 1``) sums one embedding table a
codebook and predicts with one head a codebook; a config without an
input table (``embed_inputs=False``, the VLM stub) takes ``embeds``.
``forward`` returns final hidden states; ``lm_logits`` maps them to
logits for serving.  In training with ``cfg.remat`` each repeat of the
pattern runs under ``torch.utils.checkpoint``, its activations recomputed
in the backward, as ``repro`` wraps its scan body in ``jax.checkpoint``;
the prefix layers keep theirs.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.configs import base as cfgbase
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention, common, mamba, mlp, moe, rwkv6

ATTN_KINDS = ("attn", "local", "global", "dense", "attn_moe")
MAMBA_KINDS = ("mamba", "mamba_moe")


def tree_index(tree, r: int):
    """Slice ``r`` of every leaf of a nest of dicts/lists/tuples."""
    if isinstance(tree, dict):
        return {k: tree_index(v, r) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_index(v, r) for v in tree)
    return tree[r]


def tree_stack(trees):
    """The nests in ``trees`` (one structure) stacked leaf by leaf on a new
    leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_stack(list(z)) for z in zip(*trees))
    return torch.stack(trees)


def _copy_into(dst, src) -> None:
    """Write a block's new cache ``src`` into ``dst``, views of the stacked
    cache; leaves a block updated in place (attention's KV) are ``dst``'s
    own tensors and are skipped."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    elif src is not dst:
        dst.copy_(src)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(gen, cfg, kind: str, dtype, device, lead=()):
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device, lead=lead)
    p: Dict[str, Any] = {"ln1": common.rmsnorm_init(d, **kw)}
    if kind in ATTN_KINDS:
        p["attn"] = attention.init(gen, cfg, **kw)
    elif kind in MAMBA_KINDS:
        p["mamba"] = mamba.init(gen, cfg, **kw)
    elif kind == "rwkv":
        p["rwkv"] = rwkv6.init(gen, cfg, **kw)
        return p   # rwkv keeps its own ln2/channel-mix internally
    else:
        raise ValueError(kind)
    p["ln2"] = common.rmsnorm_init(d, **kw)
    if kind.endswith("_moe"):
        p["moe"] = moe.init(gen, cfg, **kw)
    else:
        p["mlp"] = mlp.init(gen, d, cfgbase.eff_d_ff(cfg), **kw)
    if cfg.post_block_norm:
        p["ln1_post"] = common.rmsnorm_init(d, **kw)
        p["ln2_post"] = common.rmsnorm_init(d, **kw)
    return p


def init_params(cfg, *, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters in ``repro``'s layout, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (not ``repro``'s values).
    On ``"meta"`` (shapes and types only, ``jax.eval_shape``'s
    counterpart) the draws take a CPU generator, which meta accepts."""
    dev = _device.resolve(device)
    dtype = common.torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    params: Dict[str, Any] = {}
    ncb, v, d = cfg.num_codebooks, cfg.vocab_size, cfg.d_model
    if cfg.embed_inputs:
        if ncb > 1:
            params["embed"] = {"table": torch.randn(
                (ncb, v, d), generator=gen, dtype=dtype, device=dev) * 0.02}
        else:
            params["embed"] = common.embed_init(gen, v, d, dtype, dev)
    if cfg.prefix:
        params["prefix"] = [_block_init(gen, cfg, kind, dtype, dev)
                            for kind in cfg.prefix]
    r = cfg.num_pattern_repeats
    params["blocks"] = {f"pos{i}": _block_init(gen, cfg, kind, dtype, dev,
                                               lead=(r,))
                        for i, kind in enumerate(cfg.pattern)}
    params["final_norm"] = common.rmsnorm_init(cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        if ncb > 1:
            params["lm_head"] = {"w": torch.randn(
                (ncb, d, v), generator=gen, dtype=dtype, device=dev)
                / math.sqrt(d)}
        else:
            params["lm_head"] = common.linear_init(gen, d, v, dtype=dtype,
                                                   device=dev)
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _stream(x):
    """The residual stream as ``forward`` lays it out on a mesh: the
    batch over the data axes, whole on "model", so that each sublayer's
    partial sums are reduced where they join it, as Megatron's tensor
    parallelism reduces them; the identity without a mesh or on one
    device."""
    return shd.constrain(x, ("dp", None, None))


def _residual(x, y, params, which, cfg):
    if cfg.post_block_norm:
        # a sublayer's partial sum reduced once, in its own dtype, before
        # the norm: left to the norm, DTensor would reduce it after the
        # norm's float32 cast, once for x * x and once for x * rsqrt
        y = common.rmsnorm_apply(params[f"{which}_post"], _stream(y),
                                 cfg.norm_eps)
    return _stream(x + y)


def block_apply(params, cfg, kind, x, cos, sin, *, mode="train",
                cache=None, cache_len=None):
    """Returns (x, new_cache, aux).  An attention block's new cache is its
    (k, v), in decode the given cache written in place; a recurrent
    block's is its new state."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = common.rmsnorm_apply(params["ln1"], x, cfg.norm_eps)
    if kind == "rwkv":
        st = cache or {}
        y, tm_state = rwkv6.time_mix(
            params["rwkv"], cfg, h,
            state=(st.get("tm_shift"), st.get("wkv")) if cache else None,
            mode=mode)
        x = _stream(x + y)
        h2 = common.rmsnorm_apply(params["rwkv"]["ln_x2"], x, cfg.norm_eps)
        y2, cm_shift = rwkv6.channel_mix(
            params["rwkv"], cfg, h2, state=st.get("cm_shift") if cache
            else None)
        x = _stream(x + y2)
        new_cache = {"tm_shift": tm_state[0], "wkv": tm_state[1],
                     "cm_shift": cm_shift}
        return x, new_cache, aux

    if kind in ATTN_KINDS:
        y, new_cache = attention.apply(params["attn"], cfg, h, cos, sin,
                                       kind=kind, mode=mode, cache=cache,
                                       cache_len=cache_len)
    elif kind in MAMBA_KINDS:
        y, new_cache = mamba.apply(params["mamba"], cfg, h, state=cache)
    else:
        raise ValueError(kind)
    x = _residual(x, y, params, "ln1", cfg)
    h = common.rmsnorm_apply(params["ln2"], x, cfg.norm_eps)
    if kind.endswith("_moe"):
        y, aux = moe.apply(params["moe"], cfg, h)
    else:
        y = mlp.apply(params["mlp"], h, act=cfg.act, quant=cfg.quant,
                      bf16_grads=cfg.bf16_grads)
    x = _residual(x, y, params, "ln2", cfg)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed(params, cfg, batch):
    if not cfg.embed_inputs:
        x = batch["embeds"]
    elif cfg.num_codebooks > 1:
        # tokens (B, S, ncb), tables (ncb, V, D): summed in codebook order
        tbl, toks = params["embed"]["table"], batch["tokens"]
        x = sum(common.embedding(toks[..., c], tbl[c])
                for c in range(cfg.num_codebooks))
    else:
        x = common.embed_apply(params["embed"], batch["tokens"])
    if getattr(cfg, "embed_scale", False):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _rope(cfg, batch, x):
    if not any(k in ATTN_KINDS for k in cfg.prefix + cfg.pattern):
        return None, None
    b, s = x.shape[:2]
    pos = batch.get("positions")
    # positions built on each device for its rows of the batch
    if cfg.mrope:
        if pos is None:
            pos = shd.built_like(lambda sh: torch.arange(
                s, device=x.device)[None, :, None].expand(sh), (b, s, 3), x,
                {0: 0})
        return common.mrope_cos_sin(pos, cfg.head_dim, cfg.rope_theta,
                                    cfg.mrope_sections)
    if pos is None:
        pos = shd.built_like(lambda sh: torch.arange(
            s, device=x.device)[None, :].expand(sh), (b, s), x, {0: 0})
    return common.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)


def _train_repeat(block_params, cfg, x, aux_total, cos, sin):
    """One repeat of the pattern in training: (x, aux_total) after it."""
    for i, kind in enumerate(cfg.pattern):
        x, _, aux = block_apply(block_params[f"pos{i}"], cfg, kind, x, cos,
                                sin, mode="train")
        aux_total = aux_total + aux
    return x, aux_total


def forward(params, cfg, batch, *, mode: str = "train",
            cache: Optional[dict] = None, cache_len=None):
    """Returns (hidden (B,S,D), new_cache, aux_loss).

    Prefill returns the cache with each block's leaves stacked on the
    leading R axis: (k, v) of (R, B, S, KH, D) for attention, the states
    for mamba and rwkv.  Decode updates the given cache in place (the
    attention blocks write their KV into views of the stack, the
    recurrent blocks' new states are copied into theirs) and returns it.
    """
    x = _embed(params, cfg, batch).to(common.dtype_of(cfg))
    x = _stream(x)
    cos, sin = _rope(cfg, batch, x)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    new_prefix_cache = []
    for i, kind in enumerate(cfg.prefix):
        c = cache["prefix"][i] if cache is not None else None
        x, nc, aux = block_apply(params["prefix"][i], cfg, kind, x, cos, sin,
                                 mode=mode, cache=c, cache_len=cache_len)
        if mode == "decode":
            _copy_into(c, nc)
            nc = c
        new_prefix_cache.append(nc)
        aux_total = aux_total + aux

    blk_cache = cache["blocks"] if cache is not None else None
    per_layer = {f"pos{i}": [] for i in range(len(cfg.pattern))}
    repeat = dctx.under_current_mesh(_train_repeat)
    for r in range(cfg.num_pattern_repeats):
        if cfg.remat and mode == "train":
            # repro's jax.checkpoint of the scan body: one repeat's
            # activations recomputed in the backward; its parameter slices
            # taken outside, as lax.scan slices xs outside the body (no
            # draws inside: no RNG state to stash and restore)
            x, aux_total = checkpoint(
                repeat, tree_index(params["blocks"], r), cfg, x, aux_total,
                cos, sin, use_reentrant=False, preserve_rng_state=False)
            continue
        for i, kind in enumerate(cfg.pattern):
            key = f"pos{i}"
            c = (tree_index(blk_cache[key], r) if blk_cache is not None
                 else None)
            x, nc, aux = block_apply(tree_index(params["blocks"][key], r),
                                     cfg, kind, x, cos, sin, mode=mode,
                                     cache=c, cache_len=cache_len)
            if mode == "decode":
                _copy_into(c, nc)
            else:
                per_layer[key].append(nc)
            aux_total = aux_total + aux

    x = common.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if mode == "train":
        return x, None, aux_total
    if mode == "decode":
        new_blk_cache = blk_cache
    else:
        new_blk_cache = {key: tree_stack(layers)
                         for key, layers in per_layer.items()}
    return x, {"prefix": new_prefix_cache, "blocks": new_blk_cache}, aux_total


def lm_logits(params, cfg, hidden):
    """hidden (B,S,D) -> logits (B,S,V), or (B,S,ncb,V) with codebooks."""
    if cfg.num_codebooks > 1:
        w = params["lm_head"]["w"]                       # (ncb, D, V)
        if hasattr(hidden, "placements"):
            # a product a codebook (common.matmul: on each device's
            # blocks): the einsum's one batched product would merge the
            # batch's mesh dims with the codebooks'
            logits = torch.stack([common.matmul(hidden, w[c].to(hidden.dtype))
                                  for c in range(cfg.num_codebooks)], dim=2)
        else:
            logits = torch.einsum("bsd,cdv->bscv", hidden,
                                  w.to(hidden.dtype))
    elif cfg.tie_embeddings:
        logits = common.matmul(hidden,
                               params["embed"]["table"].to(hidden.dtype).t())
    else:
        logits = common.linear_apply(params["lm_head"], hidden)
    if cfg.logit_softcap:
        logits = common.softcap(logits, cfg.logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# Cache construction (decode)
# ---------------------------------------------------------------------------

def _block_cache(cfg, kind, batch: int, max_len: int, dtype, device,
                 lead=()):
    if kind in ATTN_KINDS:
        shape = tuple(lead) + (batch, max_len, cfg.num_kv_heads,
                               cfg.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))
    if kind in MAMBA_KINDS:
        return mamba.init_state(cfg, batch, dtype, device, lead)
    if kind == "rwkv":
        return rwkv6.init_state(cfg, batch, dtype, device, lead)
    raise ValueError(kind)


def init_cache(cfg, batch: int, max_len: int, device=None):
    dev = _device.resolve(device)
    dtype = common.dtype_of(cfg)
    prefix = [_block_cache(cfg, kind, batch, max_len, dtype, dev)
              for kind in cfg.prefix]
    r = cfg.num_pattern_repeats
    blocks = {f"pos{i}": _block_cache(cfg, kind, batch, max_len, dtype, dev,
                                      lead=(r,))
              for i, kind in enumerate(cfg.pattern)}
    return {"prefix": prefix, "blocks": blocks}
