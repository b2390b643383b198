"""GQA attention: chunked (flash-style) causal/sliding attention + decode.

The counterpart of ``repro.models.attention``.  Prefill and train run an
online softmax over KV chunks with a static chunk schedule
(:func:`chunked_attention`); decode attends one new query against the
cache (:func:`decode_attention`).  :func:`apply` routes ``mode="prefill"``
through the flash-attention kernel (``kernels.ops.flash_attention``) for
every config :func:`uses_flash` admits, as ``repro`` deploys its Pallas
kernel on the TPU.

``repro``'s sharding constraints stand where it puts them
(``sharding.constrain``: the identity without a mesh or on one device).
On DTensors each device attends on its blocks of the batch and the
heads (:func:`_on_head_blocks`), or, where a mesh dim has m devices a
head, on its share of a head's query rows (:func:`query_row_attention`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch._prims_common import make_contiguous_strides_for

from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.models import common

NEG_INF = -2.3819763e38  # bf16-safe large negative


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg, dtype=torch.float32, device=None,
         lead=()):
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {
        "wq": common.linear_init(gen, d, h * dh, bias=cfg.qkv_bias, **kw),
        "wk": common.linear_init(gen, d, kv * dh, bias=cfg.qkv_bias, **kw),
        "wv": common.linear_init(gen, d, kv * dh, bias=cfg.qkv_bias, **kw),
        "wo": common.linear_init(gen, h * dh, d, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = common.rmsnorm_init(dh, **kw)
        p["k_norm"] = common.rmsnorm_init(dh, **kw)
    return p


# ---------------------------------------------------------------------------
# Core chunked attention
# ---------------------------------------------------------------------------

def _attend_chunk(q, k, softcap, scale, *, q0=0, k0=0, causal=False,
                  window=None, k_valid=None):
    """q: (B,cq,H,D) k: (B,ck,KH,D) -> float32 scores (B,cq,KH,G,ck)."""
    b, cq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, cq, kh, g, d)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), k.float()) * scale
    if softcap is not None:
        s = common.softcap(s, softcap)
    if causal or window is not None or k_valid is not None:
        qi = torch.arange(cq, device=q.device)[:, None] + q0
        ki = torch.arange(k.shape[1], device=q.device)[None, :] + k0
        ok = torch.ones((cq, k.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            ok = ok & (ki <= qi)
        if window is not None:
            ok = ok & (ki > qi - window)
        if k_valid is not None:
            ok = ok & (ki < k_valid)
        s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
    return s


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      chunk_q: int = 1024, chunk_k: int = 1024,
                      scale: Optional[float] = None,
                      probs_bf16: bool = False, q0: int = 0):
    """q: (B,Sq,H,D), k/v: (B,S,KH,D) -> (B,Sq,H,D).  Causal within the
    same sequence: q's rows are its positions q0 to q0 + Sq - 1 and k's
    start at 0 (q0 = 0 and Sq = S: the whole sequence); query chunk ``i``
    visits only the KV chunks its causal/window horizon allows, KV chunks
    of the sequence's own size whatever rows q holds.  ``probs_bf16``
    rounds the exp'd probabilities to bf16 for the p@v matmul (running
    max and denominator stay float32)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    cq = min(chunk_q, s)
    ck = min(chunk_k, k.shape[1])
    sp = (-s) % cq
    if sp:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, sp))
    skp = (-k.shape[1]) % ck
    if skp:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, skp))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, skp))
    nq, nk = q.shape[1] // cq, k.shape[1] // ck
    g = h // kh

    outs = []
    for i in range(nq):
        qi = q[:, i * cq:(i + 1) * cq]
        q_lo, q_hi = q0 + i * cq, q0 + i * cq + cq - 1
        j_hi = min(nk - 1, q_hi // ck) if causal else nk - 1
        j_lo = 0
        if window is not None:
            j_lo = max(0, (q_lo - window) // ck)
        acc = torch.zeros((b, cq, kh, g, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, cq, kh, g), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, cq, kh, g), dtype=torch.float32, device=q.device)
        for j in range(j_lo, j_hi + 1):
            kj = k[:, j * ck:(j + 1) * ck]
            vj = v[:, j * ck:(j + 1) * ck]
            need_mask = ((causal and j * ck + ck - 1 > q_lo)
                         or (window is not None
                             and j * ck < q_lo - window + cq)
                         or (sp and i == nq - 1) or (skp and j == nk - 1))
            sc = _attend_chunk(
                qi, kj, softcap, scale, q0=q_lo, k0=j * ck,
                causal=causal and need_mask,
                window=window if need_mask else None,
                k_valid=(k.shape[1] - skp) if (need_mask and skp
                                               and j == nk - 1) else None)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            if probs_bf16:
                # bf16 operands, float32 accumulation
                pv = torch.einsum("bqhgk,bkhd->bqhgd",
                                  p.to(torch.bfloat16).float(),
                                  vj.to(torch.bfloat16).float())
            else:
                pv = torch.einsum("bqhgk,bkhd->bqhgd", p, vj.float())
            acc = acc * alpha[..., None] + pv
            l = l * alpha + p.sum(dim=-1)
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-37)
        outs.append(out.reshape(b, cq, h, d))
    out = torch.cat(outs, dim=1)[:, :s]
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len: int, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None):
    """q: (B,1,H,D); caches: (B,L,KH,D); cache_len: count of valid
    positions INCLUDING the token at cache_len-1 (the one just written).
    DTensor caches whose positions are split over a mesh dim take
    :func:`_split_k_decode`."""
    axis = shd.sharded_axis(k_cache, 1)
    if axis is not None:
        return _split_k_decode(q, k_cache, v_cache, cache_len, axis,
                               window=window, softcap=softcap, scale=scale)
    b, _, h, d = q.shape
    kh = k_cache.shape[2]
    g = h // kh
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = q.reshape(b, kh, g, d)
    # split-K decode: the cache's sequence over the model axis
    s = torch.einsum("bhgd,blhd->bhgl", qg, k_cache).float() * scale
    s = shd.constrain(s, ("dp", None, None, "sp"))
    if softcap is not None:
        s = common.softcap(s, softcap)
    lpos = torch.arange(k_cache.shape[1], device=q.device)
    mask = lpos < cache_len
    if window is not None:
        mask = mask & (lpos > cache_len - 1 - window)
    s = torch.where(mask[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgl,blhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def _split_k_decode(q, k_cache, v_cache, cache_len: int, axis: int, *,
                    window=None, softcap=None, scale=None):
    """:func:`decode_attention` on DTensor caches whose positions are
    split over mesh dim ``axis``, as XLA partitions it: each device
    scores its block of the cache against every head of its rows of q
    (gathered over that dim), and the softmax's maxima and sums and the
    weighted values' partial sums, (B, KH, G[, D]) each, are all-reduced
    over it; the cache is never gathered.  A batch the data axes leave
    idle (a batch of one) splits the weighted values' head dim over them,
    as XLA splits that product there, gathered after the reduction (a
    decode step: no gradient).  The output is placed as the cache's
    rows, whole on every other mesh dim."""
    from torch.distributed.tensor import DTensor, Replicate
    dmesh, mesh = k_cache.device_mesh, dctx.current_mesh()
    name = dmesh.mesh_dim_names[axis]
    place = [p if p.is_shard(0) else Replicate() for p in k_cache.placements]
    ql = q.redistribute(dmesh, place).to_local()
    kl, vl = k_cache.to_local(), v_cache.to_local()
    b, _, h, d = ql.shape
    kh, n = kl.shape[2], kl.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = torch.einsum("bhgd,blhd->bhgl", ql.reshape(b, kh, h // kh, d),
                     kl).float() * scale
    if softcap is not None:
        s = common.softcap(s, softcap)
    lpos = (torch.arange(n, device=kl.device)
            + dmesh.get_local_rank(axis) * n)
    mask = lpos < cache_len
    if window is not None:
        mask = mask & (lpos > cache_len - 1 - window)
    s = torch.where(mask[None, None, None, :], s, NEG_INF)
    m = dctx.pmax(s.amax(dim=-1, keepdim=True), mesh, name)
    e = torch.exp(s - m)
    z = dctx.psum(e.sum(dim=-1, keepdim=True), mesh, name)
    idle, at, parts = shd.share_of(dmesh, shd.idle_dims(k_cache), d)
    vl = vl.float().narrow(3, at * (d // parts), d // parts)
    out = dctx.psum(torch.einsum("bhgl,blhd->bhgd", e, vl), mesh, name) / z
    if idle:
        out = shd.gather_blocks(out, 3, [dmesh.get_group(i) for i in idle],
                                at)
    return DTensor.from_local(out.reshape(b, 1, h, d).to(q.dtype), dmesh,
                              place)


def _kv_of_q_heads(q, k):
    """``k`` (B, S, KH, D) made ready for q's head blocks.  A DTensor q
    whose heads a mesh dim splits (``torch.chunk``'s blocks,
    :func:`sharding.heads_view`) gets, on each device, the KV heads its
    own q heads read: the KV heads of its block move to it
    (:func:`sharding.gather_ranges`), and where its q heads straddle a
    group boundary (SmolLM's 5 groups of 3 q heads over 4 devices: 4, 4,
    4, 3) each local q head gets its own KV head (an index select, a
    local group of 1).  The local group is gcd(G, ceil(H / n)), which
    divides every device's block, so the result is a DTensor of H /
    that many heads whose ``torch.chunk`` blocks match q's: head u
    reads KV head u * group // G.  Anything else is returned as it
    is."""
    axis = shd.sharded_axis(q, 2)
    if axis is None:
        return k
    from torch.distributed.tensor import DTensor, Shard
    dmesh = q.device_mesh
    n, rank = dmesh.size(axis), dmesh.get_local_rank(axis)
    h, kh = q.shape[2], k.shape[2]
    g = h // kh
    gl = math.gcd(g, -(-h // n))
    blocks = shd.chunk_ranges(h, n)
    need = [(a // g, (b - 1) // g + 1) if b > a else (0, 0)
            for a, b in blocks]
    local = shd.gather_ranges(k, 2, need, axis)
    a, b = blocks[rank]
    idx = [u * gl // g - need[rank][0] for u in range(a // gl, b // gl)]
    if idx != list(range(local.shape[2])):
        local = local.index_select(
            2, torch.tensor(idx, dtype=torch.long, device=local.device))
    shape = (k.shape[0], k.shape[1], h // gl, k.shape[3])
    place = [Shard(2) if i == axis else p
             for i, p in enumerate(k.placements)]
    return DTensor.from_local(local, dmesh, place, shape=torch.Size(shape),
                              stride=make_contiguous_strides_for(shape))


def _on_head_blocks(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)``, attention in which every (row, head) is
    independent.  On DTensors it runs on each device's blocks
    (:func:`sharding.on_blocks`): a mesh dim keeps q's split of the
    batch, and of the heads (k and v, from :func:`_kv_of_q_heads`, are
    split alike); every other dim is made whole first.  A device whose
    block holds no head computes nothing.  Plain tensors run as they
    are."""
    if not hasattr(q, "placements"):
        return fn(q, k, v, **kw)

    def local(ql, kl, vl):
        if ql.shape[2]:
            return fn(ql, kl, vl, **kw)
        # no head: an empty block, still joined to k and v so that this
        # device takes part in the backward's collectives
        return ql + (kl.sum() + vl.sum()).to(ql.dtype)

    return shd.on_blocks(local, q, [(t, 0, 2) for t in (q, k, v)],
                         [(q.shape, 0, 2)])


def row_shares(q: torch.Tensor, heads: int) -> int:
    """m where a mesh dim of m * ``heads`` devices, m > 1, splits the
    columns of ``q``, a projection's output (B, S, heads * D) as a
    DTensor, in blocks of a head's D / m columns, and the batch is its
    only other split: each head's query rows are then shared by its m
    devices (:func:`query_row_attention`); else 0."""
    axes = shd.split_axes(q, 2)
    if len(axes) != 1:
        return 0
    n = q.device_mesh.size(axes[0])
    m = n // heads
    d = q.shape[2] // heads
    if (m < 2 or n % heads or d % m or q.shape[1] % (2 * m)
            or any(i != axes[0] and not (p.is_replicate() or p.is_shard(0))
                   for i, p in enumerate(q.placements))):
        return 0
    return m


def query_row_attention(q, k, v, m: int, rotate, cos, sin, **kw):
    """Causal chunked attention on DTensors where m devices share each
    head (:func:`row_shares`): ``q`` the projection's output (B, S, H * D)
    in blocks of D / m columns, ``k`` and ``v`` (B, S, KH, D) rotated.
    Device j of a head's m takes the head's query rows of the zig-zag
    pair of the sequence's 2m equal parts j and 2m - 1 - j, so each has
    the same (query, key) pairs under the causal mask: its rows of the
    head's columns move to it from its partners (one all-to-all of
    uneven splits), are rotated there (``rotate(q, cos, sin, local)``,
    ``local`` the parameters' blocks), and attend over the head's whole
    KV (:func:`sharding.gather_ranges`: the KV head, every row), each
    part through :func:`chunked_attention` at its offset, every row's
    softmax whole on one device.  The output rows move back to the
    column blocks ``wo`` reads (the exchange reversed).  Returns that
    (B, S, H * D) DTensor, placed as ``q``."""
    from torch.distributed.tensor import DTensor, Partial
    axis = shd.split_axes(q, 2)[0]
    dmesh = q.device_mesh
    n, rank = dmesh.size(axis), dmesh.get_local_rank(axis)
    group = dmesh.get_group(axis)
    head, mine = divmod(rank, m)
    group_size = (n // m) // k.shape[2]              # q heads a KV head
    s = q.shape[1]
    part = s // (2 * m)

    def rows(t, j):
        """The rows of share j: parts j and 2m - 1 - j."""
        return torch.cat([t.narrow(1, j * part, part),
                          t.narrow(1, (2 * m - 1 - j) * part, part)], 1)

    ql = q.to_local()
    width = ql.shape[2]
    partners = [p // m == head for p in range(n)]
    share = [rows(ql, p % m) if on else ql.narrow(1, 0, 2 * part).narrow(
        2, 0, 0) for p, on in enumerate(partners)]
    ql = shd.send_pieces(share, [width if on else 0 for on in partners], 2,
                         group)
    split = [Partial() if p.is_shard() else p for p in q.placements]
    ql = rotate(ql.unsqueeze(2), rows(cos.to_local(), mine),
                rows(sin.to_local(), mine), split)
    want = [((p // m) // group_size, (p // m) // group_size + 1)
            for p in range(n)]
    kl, vl = (shd.gather_ranges(t, 2, want, axis) for t in (k, v))
    yl = torch.cat([chunked_attention(ql.narrow(1, i * part, part), kl, vl,
                                      causal=True, q0=j * part, **kw)
                    for i, j in enumerate((mine, 2 * m - 1 - mine))], 1)
    yl = yl.flatten(2)
    back = [yl.narrow(2, (p % m) * width, width) if on
            else yl.narrow(1, 0, 0).narrow(2, 0, width)
            for p, on in enumerate(partners)]
    yl = shd.send_pieces(back, [2 * part if on else 0 for on in partners],
                         1, group)
    # the shares' rows back in the sequence's order: part t is in share
    # min(t, 2m - 1 - t), first or second of its two
    yl = torch.cat([yl.narrow(1, (2 * min(t, 2 * m - 1 - t) + (t >= m))
                              * part, part) for t in range(2 * m)], 1)
    return DTensor.from_local(yl, dmesh, list(q.placements), shape=q.shape,
                              stride=q.stride())


# ---------------------------------------------------------------------------
# Full block-level apply
# ---------------------------------------------------------------------------

def uses_flash(cfg, kind: str) -> bool:
    """Whether prefill attention of a ``kind`` block goes through the
    flash-attention kernel, decided from the config alone.

    The kernel takes no sliding window and no score softcap; it computes
    the config's probability type, as :func:`chunked_attention` does
    (``probs_bf16=cfg.attn_probs_bf16``: bf16 p and v before p.v, or
    float32 p, which the bf16 kernel carries as two bf16 halves on the
    tensor cores)."""
    window = cfg.sliding_window if kind == "local" else None
    return window is None and cfg.attn_softcap is None


def apply(params, cfg, x, cos, sin, *, kind: str = "attn",
          mode: str = "train", cache=None, cache_len=None,
          chunk_q: int = 1024, chunk_k: int = 1024):
    """Returns (y, new_kv); new_kv is (k, v) for building or updating the
    cache.

    ``mode="prefill"`` runs ``ops.flash_attention`` (the CUDA kernel on a
    card, its plain version on the CPU) where :func:`uses_flash` holds,
    else :func:`chunked_attention`; ``mode="train"`` (the teacher-forced
    forward) runs :func:`chunked_attention` on every device.  Decode
    writes the new (k, v) into the preallocated cache IN PLACE at
    ``cache_len`` (``repro`` returns an updated copy through
    ``dynamic_update_slice``) and returns the same cache tensors.
    """
    b, s, d = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    quant = cfg.quant
    bfg = cfg.bf16_grads
    window = cfg.sliding_window if kind == "local" else None
    flash = mode == "prefill" and uses_flash(cfg, kind)
    qf, k, v = (common.linear_apply(params[w], x, quant=quant, bf16_grads=bfg)
                for w in ("wq", "wk", "wv"))
    # m devices a head of a mesh dim of m * H share its query rows (the
    # chunked path; flash takes no query offset), else a head axis split
    # over devices keeps whole heads on each device: torch.chunk's blocks
    # of q's heads by their count, of k's and v's by theirs
    # (sharding.heads_view; plain tensors are reshaped)
    m = row_shares(qf, h) if mode in ("train", "prefill") and not flash \
        else 0
    q = None if m else shd.heads_view(qf, 2, (b, s, h, dh))
    k, v = (shd.heads_view(t, 2, (b, s, kv, dh)) for t in (k, v))

    def norm(t, name, split=None):
        if not cfg.qk_norm:
            return t
        p = params[name]
        if split is not None:        # a device's rows: a partial gradient
            p = {"scale": p["scale"].to_local(grad_placements=split)}
        return common.rmsnorm_apply(p, t, cfg.norm_eps)

    if q is not None:
        q = common.apply_rope(norm(q, "q_norm"), cos, sin)
    k = common.apply_rope(norm(k, "k_norm"), cos, sin)

    if mode in ("train", "prefill"):
        kw = dict(window=window, softcap=cfg.attn_softcap, chunk_q=chunk_q,
                  chunk_k=chunk_k, probs_bf16=cfg.attn_probs_bf16)
        if m:
            y = query_row_attention(
                qf, k, v, m, lambda t, c, sn, split: common.apply_rope(
                    norm(t, "q_norm", split), c, sn), cos, sin, **kw)
        else:
            kq, vq = _kv_of_q_heads(q, k), _kv_of_q_heads(q, v)
            if flash:
                y = _on_head_blocks(ops.flash_attention, q, kq, vq,
                                    causal=True,
                                    probs_bf16=cfg.attn_probs_bf16)
            else:
                y = _on_head_blocks(chunked_attention, q, kq, vq,
                                    causal=True, **kw)
        if mode == "prefill":              # cache leaves: sequence-sharded
            k = shd.constrain(k, ("dp", "sp", None, None))
            v = shd.constrain(v, ("dp", "sp", None, None))
        new_kv = (k, v)
    else:  # decode: write (k, v) at position cache_len
        kc, vc = cache
        idx = int(cache_len)
        shd.write_position(kc, idx, k)
        shd.write_position(vc, idx, v)
        kc = shd.constrain(kc, ("dp", "sp", None, None))
        vc = shd.constrain(vc, ("dp", "sp", None, None))
        y = decode_attention(q, kc, vc, idx + 1, window=window,
                             softcap=cfg.attn_softcap)
        new_kv = (kc, vc)
    if not m:
        y = shd.heads_view(y, 2, (b, s, h * dh))
    return common.linear_apply(params["wo"], y, quant=quant,
                               bf16_grads=bfg), new_kv
