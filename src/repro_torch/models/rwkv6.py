"""RWKV-6 "Finch" block: data-dependent-decay linear attention.

The counterpart of ``repro.models.rwkv6``: the ddlerp token shift
(LoRA-modulated), a per-channel data-dependent decay w_t =
exp(-exp(w0 + lora(x))), the bonus-u WKV recurrence with a float32
(head, hs, hs) state, the per-head norm and the squared-ReLU channel mix.
The WKV recurrence runs token by token (``op_cost.scan``, a Python loop
where ``repro`` runs ``lax.scan``; a decode step is one step), or
chunked (:func:`_wkv_chunked`, a scan over the chunks) when the config
sets ``rwkv.chunk`` and it divides the sequence.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import eff_d_ff
from repro_torch.distributed import sharding as shd
from repro_torch.launch.op_cost import scan
from repro_torch.models import common

_MIX_KEYS = ("w", "k", "v", "r", "g")


def init(gen: torch.Generator, cfg, dtype=torch.float32, device=None,
         lead=()):
    d = cfg.d_model
    rc = cfg.rwkv
    hs = rc.head_size
    nh = d // hs
    lead = tuple(lead)
    kw = dict(dtype=dtype, device=device, lead=lead)

    def normal(shape, scale=0.01):
        return torch.randn(lead + shape, generator=gen, dtype=dtype,
                           device=device).mul_(scale)

    def full(value, dt=dtype):
        return torch.full(lead + (d,), value, dtype=dt, device=device)

    ff = eff_d_ff(cfg)
    return {
        # token-shift ddlerp
        "mu_x": full(0.5),
        "mu": {k: full(0.5) for k in _MIX_KEYS},
        "mix_w1": normal((d, 5 * rc.mix_lora)),
        "mix_w2": normal((5, rc.mix_lora, d)),
        # data-dependent decay
        "w0": full(-5.0, torch.float32),
        "w1": normal((d, rc.decay_lora)),
        "w2": normal((rc.decay_lora, d)),
        "u": torch.zeros(lead + (nh, hs), dtype=torch.float32,
                         device=device),
        # projections
        "wr": common.linear_init(gen, d, d, **kw),
        "wk": common.linear_init(gen, d, d, **kw),
        "wv": common.linear_init(gen, d, d, **kw),
        "wg": common.linear_init(gen, d, d, **kw),
        "wo": common.linear_init(gen, d, d, **kw),
        "ln_x": common.rmsnorm_init(d, **kw),
        # channel mix (with its own pre-norm; the block's ln1 covers the
        # time mix)
        "ln_x2": common.rmsnorm_init(d, **kw),
        "cm_mu_k": full(0.5),
        "cm_mu_r": full(0.5),
        "cm_wk": common.linear_init(gen, d, ff, **kw),
        "cm_wv": common.linear_init(gen, ff, d, **kw),
        "cm_wr": common.linear_init(gen, d, d, **kw),
    }


def _shifted(x, shift_state):
    """The previous-token stream; shift_state: (B, 1, d), the last token
    of the prior chunk, or None (zeros)."""
    if shift_state is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = shift_state.to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _wkv_chunked(rh, kh, vh, wh, u, S0, chunk: int, sub_chunk: int = 16):
    """GLA-style chunked WKV, the same math as the per-token recurrence,
    ``repro``'s ``_wkv_chunked`` (its docstring derives it): the state
    is carried once a chunk, pairs inside a sub-chunk take their exact
    pairwise decay, and pairs across sub-chunks are rebased at the target
    sub-chunk's entry decay, so no factor exceeds 1.  A ``sub_chunk``
    that does not divide ``chunk`` falls back to one sub-chunk spanning
    the chunk.  (B, S, H, hs) inputs, (B, H, hs, hs) state -> (S, y)."""
    b, s, nh, hs = rh.shape
    n = s // chunk
    sub = sub_chunk if (sub_chunk and chunk % sub_chunk == 0) else chunk
    m = chunk // sub
    dev = rh.device

    def chunked(t):                             # (n, B, H, C, hs)
        return t.reshape(b, n, chunk, nh, hs).permute(1, 0, 3, 2, 4)

    rc_, kc, vc, wc = chunked(rh), chunked(kh), chunked(vh), chunked(wh)
    # wc = exp(-exp(wraw)) in (0, 1); log w <= 0, floored against log(0)
    logw = torch.log(torch.clamp_min(wc, 1e-30))
    la = torch.cumsum(logw, dim=3)                          # cumulative decay
    la_prev = torch.cat([torch.zeros_like(la[..., :1, :]), la[..., :-1, :]],
                        dim=3)                              # la_{t-1}
    r_tld = rc_ * torch.exp(la_prev)
    k_out = kc * torch.exp(la[..., -1:, :] - la)
    p_last = torch.exp(la[..., -1, :])                      # (n, B, H, hs)

    sub_mask = torch.tril(torch.ones((sub, sub), dtype=torch.bool,
                                     device=dev), -1)
    # target sub-chunk i sees sources strictly before its entry
    cross_mask = (torch.arange(chunk, device=dev)[None, :]
                  < (torch.arange(m, device=dev) * sub)[:, None]).to(rh.dtype)

    def step(S, i):
        r_t, v_t, k_o, p_l = r_tld[i], vc[i], k_out[i], p_last[i]
        r_raw, k_raw, la_c, la_p = rc_[i], kc[i], la[i], la_prev[i]
        bb, hh = r_raw.shape[:2]
        y_state = torch.einsum("bhci,bhij->bhcj", r_t, S)

        def subs(t):                                        # (B, H, m, c, hs)
            return t.reshape(bb, hh, m, sub, hs)

        rr, kr, vr = subs(r_raw), subs(k_raw), subs(v_t)
        la_r, la_pr = subs(la_c), subs(la_p)
        # the exact per-pair decay inside each sub-chunk: exponent <= 0
        diff = la_pr[..., :, None, :] - la_r[..., None, :, :]
        decay = torch.exp(torch.where(sub_mask[None, None, None, :, :, None],
                                      diff, float("-inf")))
        scores_d = torch.einsum("bhmti,bhmtsi,bhmsi->bhmts", rr, decay, kr)
        y_intra = torch.einsum("bhmts,bhmsj->bhmtj", scores_d, vr)
        if m > 1:
            # across sub-chunks, rebased at the target's entry E_i; the
            # clamp only touches masked-out columns
            e_i = la_pr[..., :, 0, :]                       # (B, H, m, hs)
            r_reb = rr * torch.exp(la_pr - e_i[..., :, None, :])
            k_reb = k_raw[:, :, None, :, :] * torch.exp(torch.clamp_max(
                e_i[..., :, None, :] - la_c[..., None, :, :], 0.0))
            scores_x = torch.einsum("bhmti,bhmsi->bhmts", r_reb, k_reb)
            scores_x = scores_x * cross_mask[None, None, :, None, :]
            y_intra = y_intra + torch.einsum("bhmts,bhsj->bhmtj", scores_x,
                                             v_t)
        y_intra = y_intra.reshape(bb, hh, chunk, hs)
        y_bonus = torch.einsum("bhci,bhci->bhc", r_raw * u[None, :, None, :],
                               k_raw)[..., None] * v_t
        S = p_l[..., :, None] * S + torch.einsum("bhci,bhcj->bhij", k_o, v_t)
        return S, y_state + y_intra + y_bonus

    S, y = scan(step, S0, n, dim=0)
    y = y.permute(1, 0, 3, 2, 4).reshape(b, s, nh, hs)
    return S, y


def _wkv_scan(rh, kh, vh, wh, u, S, cols=None, heads=None):
    """The per-token WKV recurrence: (B, S, H, hs) inputs -> (S, y).
    ``cols`` (start, width): y only at those of its hs columns;
    ``heads`` (start, stop): ``rh`` and ``u`` hold only those heads, and
    y is theirs; the state whole either way."""
    def step(S, t, r, k, v, w):                         # (B, H, hs) each
        kv = k[..., :, None] * v[..., None, :]             # (B, H, hs, hs)
        read, kv_read = S, kv
        if heads is not None:
            read, kv_read = (z.narrow(1, heads[0], heads[1] - heads[0])
                             for z in (read, kv_read))
        if cols is not None:
            read, kv_read = (z.narrow(3, *cols) for z in (read, kv_read))
        y = torch.einsum("bhi,bhij->bhj", r,
                         read + u[None, :, :, None] * kv_read)
        return w[..., :, None] * S + kv, y

    # the inputs scanned as lax.scan's xs: their gradient one stack of the
    # tokens' (read in the step, each token's would be its whole shape)
    return scan(step, S, rh.shape[1], dim=1, xs=(rh, kh, vh, wh))


def _model_dim(x: torch.Tensor):
    """The mesh dim named "model" of DTensor ``x``'s mesh, where it has
    several devices, else None (and None for a plain tensor)."""
    dmesh = getattr(x, "device_mesh", None)
    names = (dmesh.mesh_dim_names or ()) if dmesh is not None else ()
    if "model" not in names or dmesh.size(names.index("model")) == 1:
        return None
    return names.index("model")


def _split(w: torch.Tensor, axis: int, dim: int):
    """Weight DTensor ``w``, whole on mesh dim ``axis``, split there on
    its ``dim`` (a local slice; the gradient gathered back), or None where
    the split does not divide the dim."""
    from torch.distributed.tensor import Shard
    if (not w.placements[axis].is_replicate()
            or w.shape[dim] % w.device_mesh.size(axis)):
        return None
    place = list(w.placements)
    place[axis] = Shard(dim)
    return w.redistribute(w.device_mesh, place)


def _whole_on(x: torch.Tensor, axis: int):
    """DTensor ``x`` made whole on mesh dim ``axis`` (an all-gather, or
    an all-reduce of a partial sum; the backward reduce-scatters)."""
    from torch.distributed.tensor import Replicate
    place = list(x.placements)
    place[axis] = Replicate()
    return x.redistribute(x.device_mesh, place)


def _mixes_on_model(params, cfg, x, dx, xxx, m):
    """The ddlerp mixes and the decay on DTensors, each LoRA product on
    this device's share of "model" (mesh dim ``m``), as XLA partitions
    them: ``mix_w1``'s and the mixes' ``mix_w2`` output columns split
    there, the mixes gathered whole for the projections but the decay's,
    which stays split: ``w1`` contracts its columns (one all-reduce of the
    rank-64 sums) and ``w2`` splits its output columns again.  Returns
    (feeds, w), w split on its columns over "model"; None where a split
    does not divide its dim."""
    from torch.distributed.tensor import DTensor
    rc = cfg.rwkv
    b, s, d = x.shape
    mix_w1 = _split(params["mix_w1"], m, 1)
    mix_w2 = [_split(params["mix_w2"][i], m, 1)
              for i in range(len(_MIX_KEYS))]
    w1, w2 = _split(params["w1"], m, 0), _split(params["w2"], m, 1)
    if any(t is None for t in [mix_w1, w1, w2] + mix_w2):
        return None
    lora = _whole_on(torch.tanh(common.matmul(xxx, mix_w1)), m)
    lora = shd.heads_view(lora, 2, (b, s, len(_MIX_KEYS), rc.mix_lora))
    mods = [common.matmul(lora[:, :, i], mix_w2[i])
            for i in range(len(_MIX_KEYS))]
    feeds = {k: x + dx * (params["mu"][k].to(x.dtype) + _whole_on(mods[i], m))
             for i, k in enumerate(_MIX_KEYS) if k != "w"}
    # the decay's mix on this device's columns: x's and dx's blocks (their
    # gradients partial sums over "model"), never a gather
    place = mods[0].placements
    fw = shd.block_of(x, place) + shd.block_of(dx, place) * (
        params["mu"]["w"].to(x.dtype) + mods[0]).to_local()
    fw = DTensor.from_local(fw, x.device_mesh, place, shape=x.shape,
                            stride=x.stride())
    decay_in = torch.tanh(_whole_on(common.matmul(fw, w1), m))
    wraw = params["w0"] + common.matmul(decay_in, w2).float()
    return feeds, torch.exp(-torch.exp(wraw))


def time_mix(params, cfg, x: torch.Tensor, *, state=None, mode="train"):
    """x: (B, S, d); state = (shift (B, 1, d), wkv (B, H, hs, hs)) or None
    -> (y, new state)."""
    b, s, d = x.shape
    rc = cfg.rwkv
    hs = rc.head_size
    nh = d // hs
    kw = dict(quant=cfg.quant, bf16_grads=cfg.bf16_grads)
    xs = _shifted(x, state[0] if state is not None else None)
    dx = xs - x
    xxx = x + dx * params["mu_x"].to(x.dtype)
    m = _model_dim(x)
    placed = m is not None and _mixes_on_model(params, cfg, x, dx, xxx, m)
    if placed:
        feeds, w = placed
    else:
        # the LoRA products through common.matmul: on DTensors each on
        # the devices' blocks (split over a data axis the batch leaves
        # idle)
        lora = torch.tanh(common.matmul(xxx, params["mix_w1"]))
        lora = shd.heads_view(lora, 2, (b, s, 5, rc.mix_lora))
        if hasattr(lora, "placements"):
            # one product a mix: the einsum's batched product is DTensor's
            mods = torch.stack([common.matmul(lora[:, :, i],
                                              params["mix_w2"][i])
                                for i in range(len(_MIX_KEYS))], dim=2)
        else:
            mods = torch.einsum("bsfm,fmd->bsfd", lora,
                                params["mix_w2"].to(x.dtype))
        feeds = {k: x + dx * (params["mu"][k].to(x.dtype) + mods[:, :, i])
                 for i, k in enumerate(_MIX_KEYS)}
        decay_in = torch.tanh(common.matmul(feeds["w"], params["w1"]))
        wraw = params["w0"] + common.matmul(decay_in, params["w2"]).float()
        w = torch.exp(-torch.exp(wraw))                  # (B, S, d) in (0, 1)

    r = common.linear_apply(params["wr"], feeds["r"], **kw)
    k = common.linear_apply(params["wk"], feeds["k"], **kw)
    v = common.linear_apply(params["wv"], feeds["v"], **kw)
    g = F.silu(common.linear_apply(params["wg"], feeds["g"], **kw))

    # a head axis split over devices keeps whole heads on each device,
    # torch.chunk's blocks of them (sharding.heads_view: 40 heads over 16
    # devices, 3 on each of 13, 1 on the 14th)
    rh, kh, vh, wh = (shd.heads_view(t, 2, (b, s, nh, hs))
                      for t in (r, k, v, w))
    rh, kh, vh = rh.float(), kh.float(), vh.float()
    u = params["u"]                                      # (H, hs)
    S0 = (state[1] if state is not None
          else shd.built_like(lambda sh: torch.zeros(
              sh, dtype=torch.float32, device=x.device), (b, nh, hs, hs),
              rh, {0: 0, 1: 2}))
    chunk = rc.chunk
    if chunk and s % chunk == 0 and not (s == 1 and mode == "decode"):
        def wkv(*xs):
            return _wkv_chunked(*xs, chunk,
                                sub_chunk=getattr(rc, "sub_chunk", 16))
    else:
        wkv = _wkv_scan
    if hasattr(rh, "placements"):
        # each device runs the recurrence on its heads, as shard_map does
        args = [(rh, 0, 2), (kh, 0, 2), (vh, 0, 2), (wh, 0, 2), (u, None, 0),
                (S0, 0, 1)]
        outs = [(S0.shape, 0, 1), (rh.shape, 0, 2)]
        if state is not None and not shd.split_axes(S0, 1):
            # the cache keeps the state's heads whole (they do not divide
            # the axis): each device updates the whole state, as the
            # cache's spec holds it, and reads y at its own heads only; a
            # batch the data axes leave idle splits y's hs columns over
            # them too, gathered (a decode step: no gradient)
            dmesh = rh.device_mesh
            split = shd.split_axes(rh, 2)
            heads = (shd.chunk_ranges(nh, dmesh.size(split[0]))[
                dmesh.get_local_rank(split[0])] if split else None)
            dims, at, n = shd.share_of(dmesh, shd.idle_dims(rh), hs)
            groups = [dmesh.get_group(i) for i in dims]
            cols = (at * (hs // n), hs // n) if dims else None

            def wkv(*xs):
                S, y = _wkv_scan(*xs, cols=cols, heads=heads)
                return S, (shd.gather_blocks(y, 3, groups, at) if dims
                           else y)
            args = [(rh, 0, 2), (kh, 0, None), (vh, 0, None),
                    (wh, 0, None), (u, None, 0), (S0, 0, None)]
            outs[0] = (S0.shape, 0, None)
        S, y = shd.on_blocks(wkv, rh, args, outs)
    else:
        S, y = wkv(rh, kh, vh, wh, u, S0)
    y = shd.heads_view(y, 2, (b, s, d)).to(x.dtype)
    y = common.rmsnorm_apply(params["ln_x"], y, cfg.norm_eps) * g
    out = common.linear_apply(params["wo"], y, **kw)
    return out, (x[:, -1:], S)


def channel_mix(params, cfg, x: torch.Tensor, *, state=None):
    """The squared-ReLU channel mix; state: (B, 1, d) shift or None."""
    kw = dict(quant=cfg.quant, bf16_grads=cfg.bf16_grads)
    dx = _shifted(x, state) - x
    xk = x + dx * params["cm_mu_k"].to(x.dtype)
    xr = x + dx * params["cm_mu_r"].to(x.dtype)
    k = torch.square(F.relu(common.linear_apply(params["cm_wk"], xk, **kw)))
    kv = common.linear_apply(params["cm_wv"], k, **kw)
    gate = torch.sigmoid(common.linear_apply(params["cm_wr"], xr, **kw))
    return gate * kv, x[:, -1:]


def init_state(cfg, batch: int, dtype=torch.float32, device=None, lead=()):
    d = cfg.d_model
    hs = cfg.rwkv.head_size
    lead = tuple(lead)
    return {
        "tm_shift": torch.zeros(lead + (batch, 1, d), dtype=dtype,
                                device=device),
        "wkv": torch.zeros(lead + (batch, d // hs, hs, hs),
                           dtype=torch.float32, device=device),
        "cm_shift": torch.zeros(lead + (batch, 1, d), dtype=dtype,
                                device=device),
    }
