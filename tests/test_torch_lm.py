"""The port's LM serving path vs ``repro``'s, in float32 at ``scaled()``
sizes: the copied configs, ``common``, attention in prefill and decode,
the transformer's forward, prefill and decode steps, the parameter
bridge, the token pipeline and the serve entry point.

``repro``'s parameters are carried into the port by
``convert.lm_params_from_numpy``, and inputs are made with numpy, so both
packages see the same numbers.  Tolerances, each with its reason:

* configs, the parameter bridge, the Markov token chain, the serve
  entry point's batching and order, greedy argmax ties: exact;
* norms, RoPE, projections, single attention calls: rtol = atol = 1e-5
  (float32 matmuls and exps summed in another order);
* logits and caches of whole models through prefill and decode steps:
  rtol = atol = 2e-4, ``repro``'s own tolerance for prefill + decode vs
  the teacher-forced forward (tests/test_serve_equiv.py);
* greedy tokens: equal, except where ``repro``'s top two logits lie
  within that 2e-4 of each other; such near-ties are counted and only
  they may differ.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import tokens as jtok
from repro.launch import serve as jlaunch
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.serving import queue as jqueue
from repro.train import serve as jserve
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.data import tokens as ttok
from repro_torch.kernels import ops
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.serving import queue as tqueue
from repro_torch.train import serve as tserve
from tests.test_torch_interpreter import one_torch_thread  # noqa: F401

ARCHS = ("smollm-360m", "qwen3-8b", "gemma2-2b")
TOL = 2e-4


def _cfgs(arch):
    """(repro's, the port's) float32 scaled config; gemma2's window is 8
    so windowing happens inside the test's 24 tokens, as in repro's test."""
    over = dict(dtype="float32", param_dtype="float32")
    if arch == "gemma2-2b":
        over["sliding_window"] = 8
    return (jreg.get_config(arch).scaled().with_(**over),
            treg.get_config(arch).scaled().with_(**over))


def _params(arch, seed=0):
    jcfg, tcfg = _cfgs(arch)
    jparams = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, convert.lm_params_from_numpy(np_params,
                                                             device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# configs and the parameter bridge
# ---------------------------------------------------------------------------

def test_registry_configs_equal_repro():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    for arch in jreg.ARCH_IDS:
        j, t = jreg.get_config(arch), treg.get_config(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
        assert (dataclasses.asdict(t.scaled())
                == dataclasses.asdict(j.scaled())), arch
        assert t.head_dim == j.head_dim
        assert t.num_pattern_repeats == j.num_pattern_repeats


def test_param_bridge_round_trips_bit_exact():
    jcfg, _, jparams, tparams = _params("gemma2-2b")
    np_params = jax.tree.map(np.asarray, jparams)
    back = convert.lm_params_to_numpy(tparams)
    flat_a, tree_a = jax.tree.flatten(np_params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b and len(flat_a) > 10
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    # stacked blocks keep their leading R axis
    r = jcfg.num_pattern_repeats
    assert tparams["blocks"]["pos0"]["attn"]["wq"]["w"].shape[0] == r
    # bfloat16 and int32 leaves keep their dtype and bits
    mixed = {"a": np.asarray(jnp.linspace(-3, 3, 7, dtype=jnp.bfloat16)),
             "b": [np.arange(5, dtype=np.int32)]}
    t = convert.lm_params_from_numpy(mixed, device="cpu")
    assert t["a"].dtype == torch.bfloat16 and t["b"][0].dtype == torch.int32
    round_trip = convert.lm_params_to_numpy(t)
    assert round_trip["a"].dtype == np.uint16          # the bits
    assert round_trip["a"].view(jnp.bfloat16).dtype == mixed["a"].dtype
    np.testing.assert_array_equal(round_trip["a"],
                                  mixed["a"].view(np.uint16))
    np.testing.assert_array_equal(round_trip["b"][0], mixed["b"][0])


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------

def test_common_matches_repro():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    _close(tcommon.rmsnorm_apply({"scale": torch.from_numpy(scale)},
                                 torch.from_numpy(x), 1e-6),
           jcommon.rmsnorm_apply({"scale": jnp.asarray(scale)},
                                 jnp.asarray(x), 1e-6), 1e-5)
    for theta in (1e4, 1e6):
        np.testing.assert_array_equal(
            tcommon.rope_freqs(16, theta).numpy(),
            np.asarray(jcommon.rope_freqs(16, theta)))
        pos = rng.integers(0, 64, (2, 5))
        tc, ts = tcommon.rope_cos_sin(torch.from_numpy(pos), 16, theta)
        jc, js = jcommon.rope_cos_sin(jnp.asarray(pos), 16, theta)
        _close(tc, jc, 1e-5)
        _close(ts, js, 1e-5)
        _close(tcommon.apply_rope(torch.from_numpy(x), tc, ts),
               jcommon.apply_rope(jnp.asarray(x), jc, js), 1e-5)
    pos3 = rng.integers(0, 64, (2, 5, 3))
    for t, j in zip(tcommon.mrope_cos_sin(torch.from_numpy(pos3), 16, 1e4,
                                          (2, 3, 3)),
                    jcommon.mrope_cos_sin(jnp.asarray(pos3), 16, 1e4,
                                          (2, 3, 3))):
        _close(t, j, 1e-5)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    for quant in ("none", "binary"):
        _close(tcommon.linear_apply({"w": torch.from_numpy(w),
                                     "b": torch.from_numpy(b)},
                                    torch.from_numpy(x), quant=quant),
               jcommon.linear_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                    jnp.asarray(x), quant=quant), 1e-5)
    table = rng.standard_normal((40, 8)).astype(np.float32)
    toks = rng.integers(0, 40, (3, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        tcommon.embed_apply({"table": torch.from_numpy(table)},
                            torch.from_numpy(toks)).numpy(),
        np.asarray(jcommon.embed_apply({"table": jnp.asarray(table)},
                                       jnp.asarray(toks))))
    _close(tcommon.softcap(torch.from_numpy(x) * 40, 30.0),
           jcommon.softcap(jnp.asarray(x) * 40, 30.0), 1e-5)
    for act in ("silu", "gelu"):
        _close(tcommon.act_fn(act)(torch.from_numpy(x)),
               jcommon.act_fn(act)(jnp.asarray(x)), 1e-5)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [("smollm-360m", "attn"),
                                       ("qwen3-8b", "attn"),
                                       ("gemma2-2b", "local"),
                                       ("gemma2-2b", "global")])
def test_attention_prefill_and_decode_match_repro(arch, kind):
    jcfg, tcfg, jparams, tparams = _params(arch, seed=1)
    pos_i = jcfg.pattern.index(kind)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][f"pos{pos_i}"])["attn"]
    tp = ttf.tree_index(tparams["blocks"][f"pos{pos_i}"], 0)["attn"]
    rng = np.random.default_rng(2)
    b, s, L = 2, 20, 24
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s))
    jc, js = jcommon.rope_cos_sin(jnp.asarray(pos), jcfg.head_dim,
                                  jcfg.rope_theta)
    tc, ts = tcommon.rope_cos_sin(torch.from_numpy(pos.copy()),
                                  tcfg.head_dim, tcfg.rope_theta)
    jy, (jk, jv) = jattn.apply(jp, jcfg, jnp.asarray(x), jc, js, kind=kind,
                               mode="prefill", chunk_q=8, chunk_k=8)
    ty, (tk, tv) = tattn.apply(tp, tcfg, torch.from_numpy(x), tc, ts,
                               kind=kind, mode="prefill", chunk_q=8,
                               chunk_k=8)
    for t, j in ((ty, jy), (tk, jk), (tv, jv)):
        _close(t, j, 1e-5)

    # decode one token at position s against the prefilled cache
    pad = ((0, 0), (0, L - s), (0, 0), (0, 0))
    kc, vc = np.pad(np.asarray(jk), pad), np.pad(np.asarray(jv), pad)
    x1 = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    p1 = np.full((b, 1), s)
    jc1, js1 = jcommon.rope_cos_sin(jnp.asarray(p1), jcfg.head_dim,
                                    jcfg.rope_theta)
    tc1, ts1 = tcommon.rope_cos_sin(torch.from_numpy(p1), tcfg.head_dim,
                                    tcfg.rope_theta)
    jy1, (jkc, jvc) = jattn.apply(jp, jcfg, jnp.asarray(x1), jc1, js1,
                                  kind=kind, mode="decode",
                                  cache=(jnp.asarray(kc), jnp.asarray(vc)),
                                  cache_len=jnp.int32(s))
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ty1, (okc, ovc) = tattn.apply(tp, tcfg, torch.from_numpy(x1), tc1, ts1,
                                  kind=kind, mode="decode", cache=(tkc, tvc),
                                  cache_len=s)
    assert okc is tkc and ovc is tvc                 # written in place
    for t, j in ((ty1, jy1), (tkc, jkc), (tvc, jvc)):
        _close(t, j, 1e-5)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-8b"])
def test_attention_prefill_with_bf16_probs_matches_repro(arch):
    """A float32 config with ``attn_probs_bf16``: the port's prefill (the
    flash route) vs ``repro``'s (``chunked_attention(probs_bf16=True)``),
    within repro's bf16 tolerance (p rounds to bf16 in both, from running
    maxima of other tile sizes)."""
    jcfg, tcfg, jparams, tparams = _params(arch, seed=1)
    jcfg, tcfg = (c.with_(attn_probs_bf16=True) for c in (jcfg, tcfg))
    assert tattn.uses_flash(tcfg, "attn")
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"])["attn"]
    tp = ttf.tree_index(tparams["blocks"]["pos0"], 0)["attn"]
    rng = np.random.default_rng(6)
    b, s = 2, 20
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s))
    jc, js = jcommon.rope_cos_sin(jnp.asarray(pos), jcfg.head_dim,
                                  jcfg.rope_theta)
    tc, ts = tcommon.rope_cos_sin(torch.from_numpy(pos.copy()),
                                  tcfg.head_dim, tcfg.rope_theta)
    jy, _ = jattn.apply(jp, jcfg, jnp.asarray(x), jc, js, mode="prefill",
                        chunk_q=8, chunk_k=8)
    ty, _ = tattn.apply(tp, tcfg, torch.from_numpy(x), tc, ts,
                        mode="prefill")
    _close(ty, jy, 3e-2)


@pytest.mark.parametrize("window,softcap", [(None, None), (6, None),
                                            (None, 20.0), (5, 10.0)])
def test_chunked_attention_matches_repro(window, softcap):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 19, 6, 8)).astype(np.float32)
    k = rng.standard_normal((2, 19, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 19, 2, 8)).astype(np.float32)
    for probs_bf16 in (False, True):
        kw = dict(causal=True, window=window, softcap=softcap, chunk_q=8,
                  chunk_k=4, probs_bf16=probs_bf16)
        _close(tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                       **kw),
               jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw),
               1e-5)


def test_prefill_routes_through_flash_by_config(monkeypatch):
    calls = []
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, 500, (2, 12)).astype(np.int32))
    for arch, want in (("smollm-360m", True), ("qwen3-8b", True),
                       ("gemma2-2b", False)):
        _, tcfg = _cfgs(arch)
        tcfg = tcfg.with_(num_layers=2 * len(tcfg.pattern))
        params = ttf.init_params(tcfg, seed=0, device="cpu")
        for mode in ("train", "prefill"):
            calls.clear()
            ttf.forward(params, tcfg, {"tokens": toks}, mode=mode)
            n = tcfg.num_layers if (want and mode == "prefill") else 0
            assert len(calls) == n, (arch, mode)
    # the kernel computes the config's probability type, so the activations'
    # type and attn_probs_bf16 do not decide the route: a float32 config
    # with bf16 probabilities prefills through it too, as chunked
    # attention computes them (repro's bf16 tolerance: p rounds to bf16)
    _, tcfg = _cfgs("smollm-360m")
    for dtype in ("float32", "bfloat16"):
        for probs_bf16 in (False, True):
            assert tattn.uses_flash(tcfg.with_(dtype=dtype,
                                               attn_probs_bf16=probs_bf16),
                                    "attn")
    tcfg = tcfg.with_(num_layers=2, attn_probs_bf16=True)
    params = ttf.init_params(tcfg, seed=0, device="cpu")
    calls.clear()
    got, _, _ = ttf.forward(params, tcfg, {"tokens": toks}, mode="prefill")
    assert len(calls) == 2
    want, _, _ = ttf.forward(params, tcfg, {"tokens": toks}, mode="train")
    _close(got, want.numpy(), 3e-2)


# ---------------------------------------------------------------------------
# the transformer, prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_repro(arch):
    jcfg, tcfg, jparams, tparams = _params(arch)
    B, T, K = 2, 24, 4
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                             (B, T)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)

    # the teacher-forced forward
    jh, _, _ = jtf.forward(jparams, jcfg, {"tokens": jt}, mode="train")
    want = jtf.lm_logits(jparams, jcfg, jh)
    th, tcache, _ = ttf.forward(tparams, tcfg, {"tokens": tt}, mode="train")
    assert tcache is None
    teacher = ttf.lm_logits(tparams, tcfg, th)
    _close(teacher, want)

    # prefill T-K tokens, then K decode steps
    jlog, jcache = jserve.build_prefill_step(jcfg, max_len=T + 4)(
        jparams, {"tokens": jt[:, :T - K]})
    tlog, tcache = tserve.build_prefill_step(tcfg, max_len=T + 4)(
        tparams, {"tokens": tt[:, :T - K]})
    _close(tlog, jlog)
    jleaves, jtree = jax.tree.flatten(jcache)
    tleaves = [tcache["blocks"][f"pos{i}"][j]
               for i in range(len(tcfg.pattern)) for j in (0, 1)]
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        assert tuple(t.shape) == j.shape
        _close(t, j)
    jdec, tdec = jserve.build_decode_step(jcfg), tserve.build_decode_step(tcfg)
    jouts, touts = [jlog], [tlog]
    for i in range(K):
        lg, jcache = jdec(jparams, jcache, jt[:, T - K + i][:, None],
                          jnp.int32(T - K + i))
        jouts.append(lg)
        lg, tcache = tdec(tparams, tcache, tt[:, T - K + i][:, None],
                          T - K + i)
        touts.append(lg)
    got = torch.cat(touts, dim=1)
    jgot = np.asarray(jnp.concatenate(jouts, axis=1))
    _close(got, jgot)
    # the port's own prefill + decode == its teacher-forced forward
    _close(got, teacher[:, T - K - 1:T].detach().numpy())
    for t, j in zip([tcache["blocks"][f"pos{i}"][j]
                     for i in range(len(tcfg.pattern)) for j in (0, 1)],
                    jax.tree.leaves(jcache)):
        _close(t, j)

    # greedy tokens: equal but at repro's near-ties
    top2 = np.sort(jgot, axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= TOL * (1 + np.abs(top2[..., 1]))
    differ = (tserve.sample(None, got).numpy()
              != np.asarray(jserve.sample(None, jnp.asarray(jgot))))
    assert not (differ & ~near).any(), (int(differ.sum()), int(near.sum()))


@pytest.mark.parametrize("arch", list(jreg.ARCH_IDS))
def test_init_params_has_repros_leaf_paths_and_shapes(arch):
    """Every config initialises in the port: at scaled() size its
    parameters have repro's leaf paths, shapes and dtypes (repro's read
    with ``jax.eval_shape``, no allocation)."""
    jcfg, tcfg = (r.get_config(arch).scaled().with_(dtype="float32",
                                                    param_dtype="float32")
                  for r in (jreg, treg))
    want = jax.eval_shape(lambda k: jtf.init_params(k, jcfg),
                          jax.random.PRNGKey(0))
    got = ttf.init_params(tcfg, seed=0, device="cpu")
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g, _ = jax.tree_util.tree_flatten_with_path(got)
    assert ([jax.tree_util.keystr(k) for k, _ in flat_g]
            == [jax.tree_util.keystr(k) for k, _ in flat_w])
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    cache = ttf.init_cache(tcfg, 1, 4, device="cpu")
    assert len(cache["prefix"]) == len(tcfg.prefix)


def test_sample_greedy_ties_and_gumbel_distribution():
    logits = torch.tensor([[[0.5, 2.0, 2.0, -1.0]], [[3.0, 3.0, 3.0, 3.0]]])
    np.testing.assert_array_equal(
        tserve.sample(None, logits).numpy(),
        np.asarray(jserve.sample(jax.random.PRNGKey(0),
                                 jnp.asarray(logits.numpy()))))
    assert tserve.sample(None, logits).dtype == torch.int32
    lg = torch.tensor([[[1.0, 0.0, -1.0, 2.0]]]).expand(4000, 1, 4)
    draws = [tserve.sample(torch.Generator().manual_seed(s), lg, 0.7)
             for s in (9, 9)]
    assert torch.equal(draws[0], draws[1])
    freq = np.bincount(draws[0].numpy().ravel(), minlength=4) / 4000
    want = torch.softmax(lg[0, 0] / 0.7, -1).numpy()
    np.testing.assert_allclose(freq, want, atol=0.03)


# ---------------------------------------------------------------------------
# tokens and the serve entry point
# ---------------------------------------------------------------------------

def test_markov_chain_equals_repro_given_the_same_draws():
    jcfg, tcfg = _cfgs("smollm-360m")
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    b, s, v = 3, 17, jcfg.vocab_size
    want = jtok._gen(key, jcfg, b, s)
    # repro's own draws, as _gen makes them
    k1, k2, k3 = jax.random.split(key, 3)
    x0 = np.array(jax.random.randint(k1, (b,), 0, v))
    noise = np.array(jax.random.bernoulli(k2, 0.1, (b, s + 1)))
    rand = np.array(jax.random.randint(k3, (b, s + 1), 0, v))
    seq = ttok.markov_chain(torch.from_numpy(x0), torch.from_numpy(noise),
                            torch.from_numpy(rand), v).numpy()
    np.testing.assert_array_equal(seq[:, :-1], np.asarray(want["tokens"]))
    np.testing.assert_array_equal(seq[:, 1:], np.asarray(want["labels"]))

    got = ttok.batch_for_step(tcfg, 5, global_batch=4, seq_len=s,
                              device="cpu")
    again = ttok.batch_for_step(tcfg, 5, global_batch=4, seq_len=s,
                                device="cpu")
    other = ttok.batch_for_step(tcfg, 6, global_batch=4, seq_len=s,
                                device="cpu")
    assert got["tokens"].dtype == torch.int32
    assert tuple(got["tokens"].shape) == (4, s)
    assert torch.equal(got["tokens"], again["tokens"])
    assert not torch.equal(got["tokens"], other["tokens"])
    assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])
    assert int(got["tokens"].min()) >= 0 and int(got["tokens"].max()) < v
    # mostly the affine chain: the noise replaces about 10% of steps
    follow = (got["tokens"].long() * 31 + 7) % v == got["labels"]
    assert 0.7 < float(follow.float().mean()) <= 1.0


class _VirtualTime:
    """A clock that only sleep() and sampled tokens move: each sample call
    stands for `tick` seconds of model time, in both packages alike."""

    def __init__(self, tick):
        self.t, self.tick = 100.0, tick

    def clock(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def _serve(main, queue_cls, serve_mod, argv, monkeypatch, capsys, tick):
    vt = _VirtualTime(tick)
    pulls = []
    real_next, real_sample = queue_cls.next_batch, serve_mod.sample

    def next_batch(self, capacity):
        got = real_next(self, capacity)
        if got is not None:
            pulls.append(len(got[1]))
        return got

    def sample(*a, **kw):
        vt.t += vt.tick
        return real_sample(*a, **kw)

    monkeypatch.setattr(queue_cls, "next_batch", next_batch)
    monkeypatch.setattr(serve_mod, "sample", sample)
    capsys.readouterr()
    main(argv, clock=vt.clock, sleep=vt.sleep)
    out = capsys.readouterr().out
    monkeypatch.undo()
    order = [int(m) for m in re.findall(r"^req (\d+):", out, re.M)]
    return pulls, order


def test_serve_main_batches_like_repro_under_a_virtual_clock(monkeypatch,
                                                             capsys):
    argv = ["--arch", "smollm-360m", "--scaled", "--requests", "9",
            "--batch", "4", "--prompt-len", "6", "--gen-len", "3",
            "--rate", "40", "--slo-ms", "400"]
    jp, jo = _serve(jlaunch.main, jqueue.FrameQueue, jserve, argv,
                    monkeypatch, capsys, 0.02)
    tp, to = _serve(tlaunch.main, tqueue.FrameQueue, tserve,
                    argv + ["--device", "cpu"], monkeypatch, capsys, 0.02)
    assert tp == jp and to == jo
    assert sum(tp) == 9 and sorted(to) == list(range(9))
    assert tp == [1, 2, 2, 3, 1]              # the EWMA sizing moved


def test_serve_main_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", "smollm-360m", "--scaled"])


def test_vlm_embeds_and_mrope_forward_match_repro():
    over = dict(dtype="float32", param_dtype="float32")
    jcfg = jreg.get_config("qwen2-vl-2b").scaled().with_(**over)
    tcfg = treg.get_config("qwen2-vl-2b").scaled().with_(**over)
    jparams = jtf.init_params(jax.random.PRNGKey(2), jcfg)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           device="cpu")
    rng = np.random.default_rng(6)
    embeds = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 12, (2, 12, 3)).astype(np.int32)
    for mode in ("train", "prefill"):
        jh, _, _ = jtf.forward(jparams, jcfg, {"embeds": jnp.asarray(embeds),
                                               "positions": jnp.asarray(pos)},
                               mode=mode)
        th, _, _ = ttf.forward(tparams, tcfg,
                               {"embeds": torch.from_numpy(embeds),
                                "positions": torch.from_numpy(pos)},
                               mode=mode)
        _close(th, jh)
