"""The port's recurrent blocks (``models/mamba.py``, ``models/rwkv6.py``)
and the configs built on them (Jamba's Mamba + attention + MoE hybrid,
RWKV6-3B) against ``repro``'s, in float32 at ``scaled()`` sizes.

``repro``'s parameters are carried into the port by
``convert.lm_params_from_numpy`` and inputs are made with numpy.
Tolerance: rtol = atol = 2e-4 throughout, ``repro``'s own for the chunked
WKV against the per-token scan (tests/test_rwkv_chunked.py) and for
prefill + decode against the teacher-forced forward
(tests/test_serve_equiv.py); Jamba's MoE layers follow the near-tie rule
of tests/test_torch_moe.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro.models import rwkv6 as jrwkv
from repro_torch import convert
from repro_torch.models import mamba as tmamba
from repro_torch.models import rwkv6 as trwkv
from tests.test_torch_interpreter import one_torch_thread  # noqa: F401
from tests.test_torch_moe import cfgs, close, serve_matches_repro


def _block(module_j, arch, seed=1, **rwkv_over):
    jcfg, tcfg = cfgs(arch)
    if rwkv_over:
        jcfg = jcfg.with_(rwkv=dataclasses.replace(jcfg.rwkv, **rwkv_over))
        tcfg = tcfg.with_(rwkv=dataclasses.replace(tcfg.rwkv, **rwkv_over))
    jp = module_j.init(jax.random.PRNGKey(seed), jcfg)
    # nonzero norms, conv bias and bonus so every parameter matters
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    return jcfg, tcfg, jp, convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _close_tree(got, want):
    """A port state (nest of tensors) vs repro's, leaf by leaf."""
    want = jax.tree.leaves(want)
    got = _flat(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def test_mamba_train_prefill_and_decode_match_repro():
    """The whole sequence (train and prefill: the scan from zeros), a
    second chunk from the carried (conv, ssm) state, and single-step
    decodes, outputs and states, against repro's; the carried run equals
    the unbroken one."""
    jcfg, tcfg, jp, tp = _block(jmamba, "jamba-v0.1-52b")
    x = _x(jcfg, 2, 12, 3)
    whole = tmamba.apply(tp, tcfg, torch.from_numpy(x))
    for mode in ("train", "prefill"):
        jy, jst = jmamba.apply(jp, jcfg, jnp.asarray(x), mode=mode)
        close(whole[0], jy)
        _close_tree(whole[1], jst)
    ty, tst = tmamba.apply(tp, tcfg, torch.from_numpy(x[:, :8]))
    jy, jst = jmamba.apply(jp, jcfg, jnp.asarray(x[:, :8]), mode="prefill")
    close(ty, jy)
    _close_tree(tst, jst)
    ys = [ty]
    for lo, hi in ((8, 10), (10, 11), (11, 12)):
        mode = "decode" if hi - lo == 1 else "prefill"
        ty, tst = tmamba.apply(tp, tcfg, torch.from_numpy(x[:, lo:hi]),
                               state=tst)
        jy, jst = jmamba.apply(jp, jcfg, jnp.asarray(x[:, lo:hi]), mode=mode,
                               state=jst)
        close(ty, jy)
        _close_tree(tst, jst)
        ys.append(ty)
    close(torch.cat(ys, dim=1), whole[0].detach().numpy())
    for g, w in zip(tst, whole[1]):
        close(g, w.detach().numpy())
    init = tmamba.init_state(tcfg, 3)
    want = jmamba.init_state(jcfg, 3)
    assert [tuple(t.shape) for t in init] == [w.shape for w in want]
    assert init[1].dtype == torch.float32


# ---------------------------------------------------------------------------
# RWKV-6: the chunked WKV, time mix and channel mix
# ---------------------------------------------------------------------------

def _wkv_inputs(b, s, h, hs, seed, w_lo=0.6):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, hs)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(w_lo, 0.9999, (b, s, h, hs)).astype(np.float32)
    u = (rng.standard_normal((h, hs)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((b, h, hs, hs)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


# tests/test_rwkv_chunked.py's cases: (b, s, h, hs, chunk, sub, w_lo)
WKV_CASES = ([(2, 64, 3, 8, c, 16, 0.6) for c in (4, 16, 32)]
             + [(1, 32, 2, 4, 16, 16, 0.05)]
             + [(2, 64, 3, 8, 32, sub, 0.6) for sub in (4, 8, 16, 32, 7)]
             + [(1, 64, 2, 4, 64, sub, 0.01) for sub in (4, 16)])


@pytest.mark.parametrize("b,s,h,hs,chunk,sub,w_lo", WKV_CASES)
def test_wkv_chunked_matches_repro_and_the_scan(b, s, h, hs, chunk, sub,
                                                w_lo):
    """Chunks of 4-64, sub-chunks dividing the chunk and not (7: one exact
    sub-chunk), decay past e^-88 within a chunk (w down to 0.01): the
    port's chunked WKV == repro's == the port's per-token scan."""
    arrs = _wkv_inputs(b, s, h, hs, seed=chunk + sub, w_lo=w_lo)
    js, jy = jrwkv._wkv_chunked(*map(jnp.asarray, arrs), chunk,
                                sub_chunk=sub)
    ts, ty = trwkv._wkv_chunked(*map(torch.from_numpy, arrs), chunk,
                                sub_chunk=sub)
    assert torch.isfinite(ty).all()
    close(ty, jy)
    close(ts, js)
    r, k, v, w, u, s0 = map(torch.from_numpy, arrs)
    scan_s, scan_y = trwkv._wkv_scan(r, k, v, w, u, s0)
    close(ty, scan_y.numpy())
    close(ts, scan_s.numpy())


@pytest.mark.parametrize("chunk", [None, 16])
def test_time_mix_and_channel_mix_match_repro(chunk):
    """By the per-token scan (RWKV6-3B's own chunk=None) and by the
    chunked WKV (chunk 16, sub-chunk 4): 32 tokens from zeros, 16 more from
    the carried state, then a decode step, against repro's; the channel
    mix with and without its shift state."""
    jcfg, tcfg, jp, tp = _block(jrwkv, "rwkv6-3b", chunk=chunk, sub_chunk=4)
    x = _x(jcfg, 2, 49, 4)
    jst = tst = None
    for lo, hi in ((0, 32), (32, 48), (48, 49)):
        mode = "decode" if hi - lo == 1 else "prefill"
        jy, jst = jrwkv.time_mix(jp, jcfg, jnp.asarray(x[:, lo:hi]),
                                 state=jst, mode=mode)
        ty, tst = trwkv.time_mix(tp, tcfg, torch.from_numpy(x[:, lo:hi]),
                                 state=tst, mode=mode)
        close(ty, jy)
        _close_tree(tst, jst)
    jc, jcs = jrwkv.channel_mix(jp, jcfg, jnp.asarray(x[:, :20]))
    tc, tcs = trwkv.channel_mix(tp, tcfg, torch.from_numpy(x[:, :20]))
    close(tc, jc)
    close(tcs, jcs)
    jc, _ = jrwkv.channel_mix(jp, jcfg, jnp.asarray(x[:, 20:21]), state=jcs)
    tc, _ = trwkv.channel_mix(tp, tcfg, torch.from_numpy(x[:, 20:21]),
                              state=tcs)
    close(tc, jc)
    want = jrwkv.init_state(jcfg, 3)
    got = trwkv.init_state(tcfg, 3)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-3b"])
def test_prefill_and_decode_match_repro(arch, monkeypatch):
    """Two pattern repeats, so decode writes each recurrent block's new
    state into its slice of the stacked cache."""
    serve_matches_repro(arch, monkeypatch)
