"""MusicGen's codebooks and the VLM batch in the port against ``repro``, in
float32 at ``scaled()`` sizes: the codebook token chain, the VLM batch's
M-RoPE grid, MusicGen's parameters, forward, prefill and decode,
Qwen2-VL-2B's prefill and decode from embeds, one adamw step of each, and
the two launchers.

``repro``'s parameters are carried into the port by
``convert.lm_params_from_numpy`` and inputs are made with numpy, so both
packages see the same numbers.  Tolerances, each with its reason:

* the codebook chain given ``repro``'s draws, the VLM positions, leaf
  paths and shapes, a single-codebook batch and other configs'
  parameters against values pinned before the codebooks were ported:
  exact (integers, or float64 sums of the same draws);
* hidden states, logits and caches of whole models through the forward,
  prefill and decode: rtol = atol = 2e-4, ``repro``'s own tolerance for
  prefill + decode vs the teacher-forced forward
  (``tests/test_serve_equiv.py``);
* greedy tokens: equal, except where ``repro``'s top two logits lie
  within that 2e-4 of each other;
* a train step's loss, ce and gradient norm: 2e-4; its gradients within
  1e-4 of each leaf's max (``step_tolerance``'s rounding level); its
  parameters within ``optimizers.step_tolerance`` against ``repro``'s
  gradients, for Qwen2-VL with the rounding level carried through
  Adam's first step (``adam_eps``; the test says why);
* ``chunked_ce`` across chunk sizes: rtol 1e-5 (float32 sums in another
  order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import tokens as jtok
from repro.launch import serve as jlaunch
from repro.models import transformer as jtf
from repro.optim import optimizers as jopt
from repro.train import serve as jserve
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.data import tokens as ttok
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttf
from repro_torch.optim import optimizers as topt
from repro_torch.train import serve as tserve
from repro_torch.train import steps as tsteps
from tests.test_torch_interpreter import one_torch_thread  # noqa: F401

TOL = 2e-4
LR = (1e-3, 2, 10)           # cosine_schedule(peak, warmup, total)
MUSIC, VLM = "musicgen-medium", "qwen2-vl-2b"


def _cfgs(arch):
    over = dict(dtype="float32", param_dtype="float32")
    return (jreg.get_config(arch).scaled().with_(**over),
            treg.get_config(arch).scaled().with_(**over))


def _params(arch, seed=0):
    jcfg, tcfg = _cfgs(arch)
    jparams = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _greedy_agrees(got, jgot):
    """The port's greedy ids == repro's, but at repro's near-ties."""
    top2 = np.sort(jgot, axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= TOL * (1 + np.abs(top2[..., 1]))
    ours = tserve.sample(None, got).numpy()
    theirs = np.asarray(jserve.sample(None, jnp.asarray(jgot)))
    assert ours.shape == theirs.shape == jgot.shape[:-1]
    differ = ours != theirs
    assert not (differ & ~near).any(), (int(differ.sum()), int(near.sum()))


# ---------------------------------------------------------------------------
# tokens: the codebook chain and the VLM batch
# ---------------------------------------------------------------------------

def test_codebook_chain_equals_repro_given_the_same_draws():
    jcfg, tcfg = _cfgs(MUSIC)
    ncb, v = jcfg.num_codebooks, jcfg.vocab_size
    assert ncb == 4
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    b, s = 3, 17
    want = jtok._gen(key, jcfg, b, s)
    # repro's own draws, as its _gen makes them
    k1, k2, k3 = jax.random.split(key, 3)
    shape = (b, s + 1, ncb)
    x0 = np.array(jax.random.randint(k1, (b, ncb), 0, v))
    noise = np.array(jax.random.bernoulli(k2, 0.1, shape))
    rand = np.array(jax.random.randint(k3, shape, 0, v))
    seq = ttok.markov_chain(torch.from_numpy(x0), torch.from_numpy(noise),
                            torch.from_numpy(rand), v).numpy()
    assert seq.shape == shape
    np.testing.assert_array_equal(seq[:, :-1], np.asarray(want["tokens"]))
    np.testing.assert_array_equal(seq[:, 1:], np.asarray(want["labels"]))

    got = ttok.batch_for_step(tcfg, 5, global_batch=4, seq_len=s,
                              device="cpu")
    again = ttok.batch_for_step(tcfg, 5, global_batch=4, seq_len=s,
                                device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        assert tuple(got[k].shape) == (4, s, ncb)
        assert torch.equal(got[k], again[k])
    assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])
    assert int(got["tokens"].min()) >= 0 and int(got["tokens"].max()) < v
    # every codebook follows its own affine chain about 90% of the steps
    follow = (got["tokens"].long() * 31 + 7) % v == got["labels"]
    rate = follow.float().mean(dim=(0, 1))
    assert bool(((rate > 0.7) & (rate <= 1.0)).all()), rate
    # the codebooks are not one chain repeated
    assert not torch.equal(got["tokens"][..., 0], got["tokens"][..., 1])


def test_single_codebook_batch_is_unchanged():
    """The values the port drew before the codebooks were ported: the
    single-codebook draws keep their order and shapes."""
    cfg = treg.get_config("smollm-360m").scaled()
    got = ttok.batch_for_step(cfg, 5, global_batch=4, seq_len=6, seed=3,
                              host_id=1, num_hosts=2, device="cpu")
    assert got["tokens"].tolist() == [[232, 31, 456, 319, 168, 95],
                                      [426, 413, 10, 317, 106, 221]]
    assert got["labels"][:, -1].tolist() == [392, 202]
    cfg = treg.get_config("qwen3-8b").scaled()
    got = ttok.batch_for_step(cfg, 5, global_batch=4, seq_len=6,
                              device="cpu")
    assert got["tokens"].tolist() == [[204, 187, 172, 219, 140, 251],
                                      [148, 194, 389, 290, 293, 386],
                                      [37, 130, 453, 226, 357, 497],
                                      [413, 10, 317, 106, 221, 202]]
    assert got["labels"][:, -1].tolist() == [108, 197, 54, 125]


@pytest.mark.parametrize("arch,leaves,total,last_abs", [
    ("smollm-360m", 11, -9.817034282482766, 0.0),
    ("gemma2-2b", 24, -4.628932144931085, 0.0),
    ("qwen2-vl-2b", 14, -1.6614458040826872, 3281.7667895457303)])
def test_other_configs_parameters_are_unchanged(arch, leaves, total,
                                                last_abs):
    """float64 sums of the port's parameters at seed 1, pinned before the
    codebook branch joined ``init_params``: the draws of every config
    without codebooks keep their order."""
    cfg = treg.get_config(arch).scaled().with_(dtype="float32",
                                               param_dtype="float32")
    ls = topt.tree_leaves(ttf.init_params(cfg, seed=1, device="cpu"))
    assert len(ls) == leaves
    assert sum(float(x.double().sum()) for x in ls) == total
    assert float(ls[-1].double().abs().sum()) == last_abs


@pytest.mark.parametrize("seq_len", [1, 12, 32, 4096])
def test_vlm_batch_positions_equal_repro(seq_len):
    jcfg = jreg.get_config(VLM).scaled()
    tcfg = treg.get_config(VLM).scaled()
    want = jtok.vlm_batch_for_step(jcfg, 3, global_batch=2, seq_len=seq_len,
                                   seed=1)
    got = ttok.vlm_batch_for_step(tcfg, 3, global_batch=2, seq_len=seq_len,
                                  seed=1, device="cpu")
    assert got["positions"].dtype == torch.int32
    np.testing.assert_array_equal(got["positions"].numpy(),
                                  np.asarray(want["positions"]))
    assert tuple(got["embeds"].shape) == want["embeds"].shape == (
        2, seq_len, tcfg.d_model)
    assert str(got["embeds"].dtype).removeprefix("torch.") == str(
        want["embeds"].dtype) == tcfg.dtype
    assert tuple(got["labels"].shape) == want["labels"].shape == (2, seq_len)
    assert got["labels"].dtype == torch.int32
    if seq_len >= 32:
        std = float(got["embeds"].float().std())
        assert 0.015 < std < 0.025, std
    assert int(got["labels"].min()) >= 0
    assert int(got["labels"].max()) < tcfg.vocab_size


def test_vlm_batch_is_a_pure_function_of_its_key():
    cfg = treg.get_config(VLM).scaled().with_(dtype="float32")
    a, b = (ttok.vlm_batch_for_step(cfg, 4, global_batch=2, seq_len=16,
                                    seed=2, device="cpu") for _ in range(2))
    other = ttok.vlm_batch_for_step(cfg, 5, global_batch=2, seq_len=16,
                                    seed=2, device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["embeds"], other["embeds"])
    # its key is disjoint from batch_for_step's at seed + 7 (whose host-0
    # key would be the same without the VLM's own suffix)
    tok = ttok.batch_for_step(cfg, 4, global_batch=2, seq_len=16, seed=9,
                              device="cpu")
    assert not torch.equal(a["labels"], tok["labels"])


# ---------------------------------------------------------------------------
# MusicGen: the forward, prefill and decode
# ---------------------------------------------------------------------------

def test_musicgen_forward_and_logits_match_repro():
    jcfg, tcfg, jparams, tparams = _params(MUSIC)
    ncb, v, d = tcfg.num_codebooks, tcfg.vocab_size, tcfg.d_model
    assert tparams["embed"]["table"].shape == (ncb, v, d)
    assert tparams["lm_head"]["w"].shape == (ncb, d, v)
    toks = np.random.default_rng(4).integers(0, v, (2, 12, ncb)
                                             ).astype(np.int32)
    jh, _, _ = jtf.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                           mode="train")
    th, _, _ = ttf.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                           mode="train")
    _close(th, jh)
    jl = jtf.lm_logits(jparams, jcfg, jh)
    tl = ttf.lm_logits(tparams, tcfg, th)
    assert tuple(tl.shape) == jl.shape == (2, 12, ncb, v)
    _close(tl, jl)
    # the embedding is the sum over codebooks in codebook order
    tbl = tparams["embed"]["table"]
    want = sum(tbl[c][torch.from_numpy(toks)[..., c].long()]
               for c in range(ncb))
    assert torch.equal(ttf._embed(tparams, tcfg,
                                  {"tokens": torch.from_numpy(toks)}), want)


def test_musicgen_prefill_and_decode_match_repro():
    """tests/test_serve_equiv.py's MusicGen case (B=2, T=24, K=4) in both
    packages: prefill logits, caches, decode logits and greedy ids ==
    repro's, and the port's own prefill + decode == its teacher-forced
    forward."""
    jcfg, tcfg, jparams, tparams = _params(MUSIC)
    B, T, K = 2, 24, 4
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, T, jcfg.num_codebooks)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    th, _, _ = ttf.forward(tparams, tcfg, {"tokens": tt}, mode="train")
    teacher = ttf.lm_logits(tparams, tcfg, th)

    jlog, jcache = jserve.build_prefill_step(jcfg, max_len=T + 4)(
        jparams, {"tokens": jt[:, :T - K]})
    tlog, tcache = tserve.build_prefill_step(tcfg, max_len=T + 4)(
        tparams, {"tokens": tt[:, :T - K]})
    _close(tlog, jlog)
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
    assert tuple(got.shape) == jgot.shape == (B, K + 1, 4, jcfg.vocab_size)
    _close(got, jgot)
    _close(got, teacher[:, T - K - 1:T].detach().numpy())
    tleaves = [tcache["blocks"]["pos0"][j] for j in (0, 1)]
    jleaves = jax.tree.leaves(jcache)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        assert tuple(t.shape) == j.shape
        _close(t, j)
    _greedy_agrees(got, jgot)


def test_sample_maps_codebook_logits_to_codebook_ids():
    lg = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 1, 4, 50)).astype(np.float32))
    greedy = tserve.sample(None, lg)
    assert greedy.shape == (3, 1, 4) and greedy.dtype == torch.int32
    np.testing.assert_array_equal(
        greedy.numpy(), np.asarray(jserve.sample(None, jnp.asarray(lg))))
    drawn = tserve.sample(torch.Generator().manual_seed(0), lg, 0.8)
    again = tserve.sample(torch.Generator().manual_seed(0), lg, 0.8)
    assert drawn.shape == (3, 1, 4) and torch.equal(drawn, again)
    assert int(drawn.min()) >= 0 and int(drawn.max()) < 50


# ---------------------------------------------------------------------------
# Qwen2-VL: embeds and M-RoPE positions through prefill and decode
# ---------------------------------------------------------------------------

def test_vlm_prefill_and_decode_match_repro():
    """A prompt of embeds at the VLM batch's grid positions, then K decode
    steps of embeds, each at (s+i, s+i, s+i) as both packages' decode
    steps place it: logits and caches == repro's, and == the port's
    teacher-forced forward at those same positions."""
    jcfg, tcfg, jparams, tparams = _params(VLM, seed=2)
    B, T, K = 2, 24, 4
    s = T - K
    rng = np.random.default_rng(6)
    embeds = (rng.standard_normal((B, T, jcfg.d_model)) * 0.5
              ).astype(np.float32)
    grid = ttok.vlm_batch_for_step(tcfg, 0, global_batch=B, seq_len=s,
                                   device="cpu")["positions"].numpy()
    run_pos = np.concatenate(
        [grid, np.broadcast_to(np.arange(s, T)[None, :, None], (B, K, 3))],
        axis=1).astype(np.int32)

    th, _, _ = ttf.forward(tparams, tcfg,
                           {"embeds": torch.from_numpy(embeds),
                            "positions": torch.from_numpy(run_pos)},
                           mode="train")
    teacher = ttf.lm_logits(tparams, tcfg, th)
    jlog, jcache = jserve.build_prefill_step(jcfg, max_len=T + 4)(
        jparams, {"embeds": jnp.asarray(embeds[:, :s]),
                  "positions": jnp.asarray(grid)})
    tlog, tcache = tserve.build_prefill_step(tcfg, max_len=T + 4)(
        tparams, {"embeds": torch.from_numpy(embeds[:, :s].copy()),
                  "positions": torch.from_numpy(grid)})
    _close(tlog, jlog)
    jdec, tdec = jserve.build_decode_step(jcfg), tserve.build_decode_step(tcfg)
    jouts, touts = [jlog], [tlog]
    for i in range(K):
        e = embeds[:, s + i][:, None]
        lg, jcache = jdec(jparams, jcache, jnp.asarray(e), jnp.int32(s + i))
        jouts.append(lg)
        lg, tcache = tdec(tparams, tcache, torch.from_numpy(e.copy()), s + i)
        touts.append(lg)
    got = torch.cat(touts, dim=1)
    jgot = np.asarray(jnp.concatenate(jouts, axis=1))
    _close(got, jgot)
    _close(got, teacher[:, s - 1:T].detach().numpy())
    for t, j in zip([tcache["blocks"]["pos0"][j] for j in (0, 1)],
                    jax.tree.leaves(jcache)):
        _close(t, j)
    _greedy_agrees(got, jgot)


# ---------------------------------------------------------------------------
# one training step, and the chunked loss over codebook labels
# ---------------------------------------------------------------------------

def _batches(arch, tcfg, b=2, s=16):
    """One batch made with numpy, as jax and torch arrays."""
    rng = np.random.default_rng(7)
    if arch == MUSIC:
        seq = rng.integers(0, tcfg.vocab_size, (b, s + 1, 4), dtype=np.int32)
        nb = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    else:
        nb = {"embeds": (rng.standard_normal((b, s, tcfg.d_model)) * 0.02
                         ).astype(np.float32),
              "labels": rng.integers(0, tcfg.vocab_size, (b, s),
                                     dtype=np.int32),
              "positions": ttok.vlm_batch_for_step(
                  tcfg, 0, global_batch=b, seq_len=s,
                  device="cpu")["positions"].numpy()}
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in nb.items()})


@pytest.mark.parametrize("arch,adam_eps", [(MUSIC, None), (VLM, 1e-8)])
def test_one_adamw_step_matches_repro(arch, adam_eps):
    """One adamw step from the same parameters on the same batch: the
    loss and ce within 2e-4, the gradients within their rounding level
    (``step_tolerance``'s, 1e-4 of each leaf's max), the parameters within
    ``step_tolerance``.  Qwen2-VL's key bias has elements whose gradient
    is a cancellation (the rotary pairs that barely turn over the grid's
    few h and w positions, or not at all on t, where every position is 0)
    at a few times Adam's eps, where a gradient agreeing to 2e-9 still
    steps apart by up to 0.7% of lr: its bound carries the rounding level
    through the first step (``adam_eps``)."""
    jcfg, tcfg, jparams, tparams = _params(arch, seed=3)
    jb, tb = _batches(arch, tcfg)
    jo = jopt.make("adamw", jopt.cosine_schedule(*LR))
    to = topt.make("adamw", topt.cosine_schedule(*LR))
    jnew, jm = jax.jit(jsteps.build_train_step(jcfg, jo))(
        {"params": jparams, "opt_state": jo.init(jparams),
         "step": jnp.zeros((), jnp.int32)}, jb)
    tnew, tm = tsteps.build_train_step(tcfg, to)(
        {"params": tparams, "opt_state": to.init(tparams),
         "step": torch.zeros((), dtype=torch.int32)}, tb)
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=TOL,
                                   atol=TOL)
    jgrads = jax.grad(lambda p: jsteps.make_loss_fn(jcfg)(p, jb)[0])(jparams)

    def as_port(tree):   # repro's tree in the port's list/dict structure
        return convert.lm_params_to_numpy(convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, tree), device="cpu"))

    grads = as_port(jgrads)
    (_, _), tgrads = topt.value_and_grad(
        lambda p: tsteps.make_loss_fn(tcfg)(p, tb), tparams)
    for t, j in zip(topt.tree_leaves(tgrads), topt.tree_leaves(grads)):
        level = max(1e-4 * float(np.abs(j).max()), 1e-7)
        assert float(np.abs(t.numpy() - j).max()) <= level
    clip = min(1.0, 1.0 / max(float(jm["grad_norm"]), 1e-9))
    want = as_port(jnew["params"])
    bounds = topt.step_tolerance(
        want, topt.tree_map(lambda g: g * np.float32(clip), grads), float(
            jopt.cosine_schedule(*LR)(jnp.int32(0))), adam_eps=adam_eps)
    got = topt.tree_map(lambda x: x.detach().numpy(), tnew["params"])
    for g, w, b in zip(topt.tree_leaves(got), topt.tree_leaves(want),
                       topt.tree_leaves(bounds)):
        assert g.shape == w.shape
        assert (np.abs(g - w) <= b).all(), float(np.abs(g - w).max())


def test_chunked_ce_over_codebook_labels_matches_repro_and_chunks():
    jcfg, tcfg, jparams, tparams = _params(MUSIC, seed=4)
    rng = np.random.default_rng(8)
    h = rng.standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (2, 32, 4), dtype=np.int32)
    losses = []
    for chunk in (8, 16, 32, 24):        # 24 does not divide: one chunk
        want = float(jsteps.chunked_ce(jparams, jcfg.with_(loss_chunk=chunk),
                                       jnp.asarray(h), jnp.asarray(labels)))
        got = float(tsteps.chunked_ce(tparams, tcfg.with_(loss_chunk=chunk),
                                      torch.from_numpy(h),
                                      torch.from_numpy(labels)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        losses.append(got)
    np.testing.assert_allclose(losses, losses[0], rtol=1e-5)
    # the mean runs over all B x S x ncb labels
    logits = ttf.lm_logits(tparams, tcfg, torch.from_numpy(h)).double()
    nll = (torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, torch.from_numpy(labels).long()[..., None])[..., 0])
    np.testing.assert_allclose(losses[0], float(nll.mean()), rtol=1e-5)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_serve_main_serves_musicgen_codebooks_on_the_cpu(monkeypatch):
    """launch.serve at MusicGen's scaled() size: (1, S, 4) prompts, decode
    fed (B, 1, 4), each request's ids the first gen_len of its flattened
    (gen_len, 4) output."""
    fed, real = [], tserve.build_decode_step

    def spy(cfg):
        step = real(cfg)

        def decode(params, cache, toks, cache_len):
            fed.append(tuple(toks.shape))
            return step(params, cache, toks, cache_len)
        return decode

    monkeypatch.setattr(tserve, "build_decode_step", spy)
    outs, real_sample = [], tserve.sample

    def sample(*a, **kw):
        outs.append(real_sample(*a, **kw))
        return outs[-1]

    monkeypatch.setattr(tserve, "sample", sample)
    report = tlaunch.main(["--arch", MUSIC, "--scaled", "--requests", "3",
                           "--batch", "2", "--prompt-len", "6",
                           "--gen-len", "3", "--device", "cpu"])
    assert sorted(report.tokens) == [0, 1, 2] and report.served == 3
    assert set(fed) == {(2, 1, 4), (1, 1, 4)}
    vocab = treg.get_config(MUSIC).scaled().vocab_size
    for ids in report.tokens.values():
        assert len(ids) == 3 and all(0 <= x < vocab for x in ids)
    # the first pull's requests: their three ids are the first codebook
    # row of step 0, then the first two of step 1 (row-major flattening)
    first = torch.cat(outs[:3], dim=1)                 # (2, 3, 4)
    for i in (0, 1):
        assert report.tokens[i] == first[i].reshape(-1)[:3].tolist()


def test_both_launchers_refuse_the_vlm_stub(monkeypatch):
    """repro's launcher feeds the VLM token prompts and fails on them; the
    port's refuses in plain words, before any parameter is built and on
    any device."""
    argv = ["--arch", VLM, "--scaled", "--requests", "1", "--batch", "1",
            "--prompt-len", "4", "--gen-len", "2"]
    with pytest.raises(KeyError, match="embeds"):
        jlaunch.main(argv)
    built = []
    monkeypatch.setattr(ttf, "init_params", lambda *a, **kw: built.append(a))
    with pytest.raises(ValueError, match="embed_inputs=False.*KeyError"):
        tlaunch.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError, match="stub"):
        tlaunch.main(argv)
    assert built == []


def test_train_main_trains_the_vlm_through_its_batch(monkeypatch):
    calls, real = [], ttok.vlm_batch_for_step

    def spy(cfg, step, **kw):
        calls.append(step)
        return real(cfg, step, **kw)

    monkeypatch.setattr(ttok, "vlm_batch_for_step", spy)
    monkeypatch.setattr(ttok, "batch_for_step", None)
    _, losses = ttrain.main(["--arch", VLM, "--scaled", "--steps", "2",
                             "--global-batch", "2", "--seq-len", "16",
                             "--device", "cpu"])
    assert calls == [0, 1]
    assert len(losses) == 2 and np.isfinite(losses).all()

