"""The port's mixture of experts (``models/moe.py``) and the MoE configs
(OLMoE-1B-7B, Kimi-K2 with its shared expert and dense prefix layer,
Jamba's MoE half) against ``repro``'s, in float32 at ``scaled()`` sizes:
the router, the dense path, the dispatch, whole models through prefill
and decode, and one training step.

``repro``'s parameters are carried into the port by
``convert.lm_params_from_numpy`` and inputs are made with numpy, so both
packages compute the same thing.  Tolerances, each with its reason:

* the router's gates and aux loss, the dense path's output: rtol = atol
  = 2e-4 (float32 products summed in another order);
* the experts chosen: equal as sets (``torch.topk`` orders them
  differently from ``lax.top_k``; the dense combine sums over k), except
  at a near-tie: the k-th and (k+1)-th probabilities within
  ``moe.NEAR_TIE`` (1e-5) of each other in either package, where float32
  rounding may swap an expert.  Whole models are compared where both
  sides chose the same experts (``moe.route_divergence``: a token routed
  differently makes its row incomparable from its position on); every
  token routed differently must be a near-tie, and their count is
  printed;
* whole models' logits, caches and aux losses: rtol = atol = 2e-4,
  ``repro``'s tolerance for prefill + decode vs the teacher-forced
  forward (tests/test_serve_equiv.py);
* a training step: the loss, ce and aux within 2e-4 and the parameters
  within ``optimizers.step_tolerance``, with no token routed differently
  in the step's forward (a swapped expert changes the gradient).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.optim import optimizers as jopt
from repro.train import serve as jserve
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.optim import optimizers as topt
from repro_torch.train import serve as tserve
from repro_torch.train import steps as tsteps
from tests.test_torch_interpreter import one_torch_thread  # noqa: F401

TOL = 2e-4
LR = (1e-3, 2, 10)           # cosine_schedule(peak, warmup, total)


def cfgs(arch, repeats=1):
    """(repro's, the port's) float32 scaled config with ``repeats`` pattern
    repeats after the prefix."""
    over = dict(dtype="float32", param_dtype="float32")
    j = jreg.get_config(arch).scaled().with_(**over)
    j = j.with_(num_layers=len(j.prefix) + repeats * len(j.pattern))
    t = treg.get_config(arch).scaled().with_(**over)
    return j, t.with_(num_layers=j.num_layers)


def params(jcfg, seed=0):
    jparams = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def repro_routes(monkeypatch):
    """Record ``repro``'s routings as ``moe.record_routes`` records the
    port's: (sorted experts (T, k), k-th minus (k+1)-th probability (T,))
    a call, in call order, through ``jax.debug.callback`` (read them after
    ``jax.effects_barrier()``)."""
    records, real = [], jmoe._route

    def spy(x2d, router_w, m):
        out = real(x2d, router_w, m)
        probs = jax.nn.softmax(x2d.astype(jnp.float32) @ router_w, axis=-1)
        top = jax.lax.top_k(probs, m.top_k + 1)[0]
        jax.debug.callback(
            lambda s, g: records.append((np.sort(np.asarray(s), -1),
                                         np.asarray(g))),
            out[1], top[:, m.top_k - 1] - top[:, m.top_k], ordered=True)
        return out

    monkeypatch.setattr(jmoe, "_route", spy)
    return records


def moe_layers(cfg) -> int:
    kinds = cfg.prefix + cfg.pattern * cfg.num_pattern_repeats
    return sum(k.endswith("_moe") for k in kinds)


def comparable(first, b, positions):
    """(B, len(positions)) mask of the outputs both runs' routings allow
    comparing: those before the row's first differently routed token."""
    return np.array([[p < first.get(r, np.inf) for p in positions]
                     for r in range(b)])


def close_where(got, want, mask, tol=TOL):
    """``got`` vs ``want`` over (B, S, ...) at the (B, S) ``mask``."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got[mask], np.asarray(want, np.float32)[mask],
                               rtol=tol, atol=tol)


def serve_matches_repro(arch, monkeypatch, b=2, t=16, k=3):
    """Prefill t - k tokens then k decode steps, and the teacher-forced
    forward, in both packages: the port == repro (teacher logits and aux,
    prefill logits, caches, decode logits) and the port's own prefill +
    decode == its teacher-forced forward, where the routings allow.
    Returns the count of tokens routed differently."""
    jcfg, tcfg = cfgs(arch, repeats=2)
    jparams, tparams = params(jcfg)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                             (b, t)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    n = moe_layers(tcfg)
    jrec = repro_routes(monkeypatch)

    jh, _, jaux = jtf.forward(jparams, jcfg, {"tokens": jt}, mode="train")
    jteacher = jtf.lm_logits(jparams, jcfg, jh)
    jlog, jcache = jserve.build_prefill_step(jcfg, max_len=t + 4)(
        jparams, {"tokens": jt[:, :t - k]})
    jdec = jserve.build_decode_step(jcfg)
    jouts = [jlog]
    for i in range(k):
        lg, jcache = jdec(jparams, jcache, jt[:, t - k + i][:, None],
                          jnp.int32(t - k + i))
        jouts.append(lg)
    jax.effects_barrier()

    with tmoe.record_routes() as trec:
        th, tcache, taux = ttf.forward(tparams, tcfg, {"tokens": tt},
                                       mode="train")
        assert tcache is None
        teacher = ttf.lm_logits(tparams, tcfg, th)
        tlog, tcache = tserve.build_prefill_step(tcfg, max_len=t + 4)(
            tparams, {"tokens": tt[:, :t - k]})
        tdec = tserve.build_decode_step(tcfg)
        touts = [tlog]
        for i in range(k):
            lg, tcache = tdec(tparams, tcache, tt[:, t - k + i][:, None],
                              t - k + i)
            touts.append(lg)
    assert len(trec) == len(jrec) == n * (2 + k)

    run = [(0, t - k)] + [(t - k + i, 1) for i in range(k)]
    tables = {}
    for name, rec in (("j", jrec), ("t", trec)):
        tables[name + "teacher"] = tmoe.route_table(rec[:n], [(0, t)], n)
        tables[name + "run"] = tmoe.route_table(rec[n:], run, n)
    first_t, n_t = tmoe.route_divergence(tables["tteacher"],
                                         tables["jteacher"])
    first_r, n_r = tmoe.route_divergence(tables["trun"], tables["jrun"])
    first_s, n_s = tmoe.route_divergence(tables["trun"], tables["tteacher"])

    # the teacher-forced forward == repro's; its aux too, where no token
    # of either forward was routed differently
    close_where(teacher, jteacher, comparable(first_t, b, range(t)))
    if n_t == 0:
        close(taux, jaux)
    # prefill and decode logits, then every cache leaf, == repro's
    got = torch.cat(touts, dim=1)
    positions = range(t - k - 1, t)
    close_where(got, np.asarray(jnp.concatenate(jouts, axis=1)),
                comparable(first_r, b, positions))
    rows = torch.tensor([r for r in range(b) if r not in first_r])
    n_leaves = 0
    for part, ax in (("prefix", 0), ("blocks", 1)):    # blocks: (R, B, ...)
        tleaves = topt.tree_leaves(tcache[part])
        jleaves = jax.tree.leaves(jcache[part])
        assert len(tleaves) == len(jleaves)
        n_leaves += len(tleaves)
        for tl, jl in zip(tleaves, jleaves):
            assert tuple(tl.shape) == jl.shape
            assert str(tl.dtype)[6:] == str(jl.dtype)
            close(tl.index_select(ax, rows),
                  np.take(np.asarray(jl), rows.numpy(), axis=ax))
    assert n_leaves > 0
    # the port's prefill + decode == its own teacher-forced forward
    close_where(got, teacher[:, t - k - 1:t].detach().numpy(),
                comparable(first_s, b, positions))
    count = n_t + n_r + n_s
    print(f"{arch}: {count} tokens routed differently (near-ties)")
    return count


# ---------------------------------------------------------------------------
# the router and the dense path
# ---------------------------------------------------------------------------

MOE_ARCHS = ("olmoe-1b-7b", "kimi-k2-1t-a32b", "jamba-v0.1-52b")


def _moe_params(arch, seed=1):
    jcfg, tcfg = cfgs(arch)
    jp = jmoe.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_repro(arch):
    jcfg, tcfg, jp, tp = _moe_params(arch)
    x = np.random.default_rng(2).standard_normal(
        (48, jcfg.d_model)).astype(np.float32)
    jg, js, jaux = jmoe._route(jnp.asarray(x), jp["router"], jcfg.moe)
    tg, ts, taux = tmoe._route(torch.from_numpy(x), tp["router"], tcfg.moe)
    assert ts.dtype == torch.int64 and tuple(ts.shape) == js.shape
    # the same experts as sets; torch.topk and lax.top_k both order by
    # probability, and no gap here is a near-tie, so the gates align
    np.testing.assert_array_equal(np.sort(ts.numpy(), -1),
                                  np.sort(np.asarray(js), -1))
    close(tg, jg)
    close(taux, jaux)
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_dense_matches_repro(arch):
    """Kimi-K2 adds its shared expert, OLMoE and Jamba have none."""
    jcfg, tcfg, jp, tp = _moe_params(arch)
    assert ("shared" in tp) == (arch == "kimi-k2-1t-a32b")
    x = np.random.default_rng(3).standard_normal(
        (2, 12, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.apply_dense(jp, jcfg, jnp.asarray(x))
    with tmoe.record_routes() as rec:
        ty, taux = tmoe.apply_dense(tp, tcfg, torch.from_numpy(x))
    close(ty, jy)
    close(taux, jaux)
    assert len(rec) == 1 and rec[0][0].shape == (24, tcfg.moe.top_k)
    # the shared expert is the difference the routed experts leave
    if "shared" in tp:
        no_shared = {k: v for k, v in tp.items() if k != "shared"}
        ty0, _ = tmoe.apply_dense(no_shared, tcfg, torch.from_numpy(x))
        shared = tmoe._shared(tp, tcfg, torch.from_numpy(x).reshape(24, -1))
        close(ty - ty0, shared.reshape(ty.shape).detach().numpy(), 1e-5)


# These cases replace one that held apply to raise under a mesh the
# expert-parallel paths would take: it takes them now
# (tests/test_torch_moe_ep.py runs them on 8 ranks).
@pytest.mark.parametrize("mesh", [None, (1, 1), (4, 1), (2, 2, 1)])
@pytest.mark.parametrize("impl", ["auto", "dense", "ep"])
def test_apply_is_dense_without_a_model_axis_like_repro(impl, mesh):
    """Without a mesh, or on a mesh whose model axis has one device,
    every impl takes the dense path, as repro's apply does (its (1, 1)
    mesh is the one this host's single CPU device makes)."""
    from repro.distributed import context as jctx
    from repro_torch.checkpoint.ckpt import Mesh
    from repro_torch.distributed import context as tctx
    jcfg, tcfg, jp, tp = _moe_params("olmoe-1b-7b")
    x = np.random.default_rng(4).standard_normal(
        (2, 8, jcfg.d_model)).astype(np.float32)
    want, _ = jmoe.apply_dense(jp, jcfg, jnp.asarray(x))
    jc = jcfg.with_(moe=dataclasses.replace(jcfg.moe, impl=impl))
    tc = tcfg.with_(moe=dataclasses.replace(tcfg.moe, impl=impl))
    with jctx.mesh_context(jax.make_mesh((1, 1), ("data", "model"))):
        jy, _ = jmoe.apply(jp, jc, jnp.asarray(x))
    close(jy, want, 1e-6)
    tmesh = None if mesh is None else Mesh.abstract(
        mesh, ("pod", "data", "model")[-len(mesh):])
    with tctx.mesh_context(tmesh):
        ty, _ = tmoe.apply(tp, tc, torch.from_numpy(x))
    close(ty, want)


@pytest.mark.parametrize("mesh", [(2, 4), (1, 4), (2, 2, 2)])
@pytest.mark.parametrize("impl", ["auto", "dense", "ep"])
def test_apply_dispatches_like_repro_under_a_mesh(impl, mesh, monkeypatch):
    """On a mesh with a model axis of several devices: the same path as
    repro's apply, shape by shape (apply_ep where the sequence splits
    over the model axis and the batch over the data axes, else
    apply_ep_decode; dense for impl dense), each side's paths spied."""
    from jax.sharding import AbstractMesh
    from repro.distributed import context as jctx
    from repro_torch.checkpoint.ckpt import Mesh
    from repro_torch.distributed import context as tctx
    names = ("pod", "data", "model")[-len(mesh):]
    taken = {"repro": [], "port": []}
    for mod, side in ((jmoe, "repro"), (tmoe, "port")):
        for path in ("apply_ep", "apply_ep_decode"):
            monkeypatch.setattr(mod, path, lambda *a, _p=path, _s=side: (
                taken[_s].append(_p), (None, None))[1])
        monkeypatch.setattr(mod, "apply_dense", lambda *a, _s=side: (
            taken[_s].append("apply_dense"), (None, None))[1])
    jcfg, tcfg = cfgs("olmoe-1b-7b")
    jc = jcfg.with_(moe=dataclasses.replace(jcfg.moe, impl=impl))
    tc = tcfg.with_(moe=dataclasses.replace(tcfg.moe, impl=impl))
    shapes = [(b, s) for b in (1, 2, 3, 4) for s in (1, 2, 3, 4, 6, 8)]
    monkeypatch.setattr(jctx._state, "mesh", AbstractMesh(mesh, names),
                        raising=False)
    with tctx.mesh_context(Mesh.abstract(mesh, names)):
        for b, s in shapes:
            jmoe.apply({}, jc, jnp.zeros((b, s, 4)))
            tmoe.apply({}, tc, torch.zeros(b, s, 4))
    assert taken["port"] == taken["repro"]
    assert len(taken["port"]) == len(shapes)
    kinds = set(taken["port"])
    assert kinds == ({"apply_dense"} if impl == "dense"
                     else {"apply_ep", "apply_ep_decode"})


def test_route_divergence_follows_the_near_tie_rule():
    """A token routed differently without a near-tie raises; a near-tie
    is counted and makes its row incomparable from its position on; a
    difference in its shadow (a later layer, the same or a later position)
    is not another root."""
    def table(entries):
        return {key: (sel, gap) for key, sel, gap in entries}
    a = table([((0, 0, 3), (1, 2), 1e-6), ((1, 0, 5), (0, 2), 0.3),
               ((0, 1, 0), (4, 5), 0.2)])
    b = table([((0, 0, 3), (1, 3), 0.2), ((1, 0, 5), (0, 1), 0.3),
               ((0, 1, 0), (4, 5), 0.2)])
    first, n = tmoe.route_divergence(a, b)
    assert first == {0: 3} and n == 1
    np.testing.assert_array_equal(comparable(first, 2, range(2, 5)),
                                  [[True, False, False], [True] * 3])
    b[(0, 1, 0)] = ((4, 6), 0.2)
    with pytest.raises(AssertionError, match="no near-tie"):
        tmoe.route_divergence(a, b)
    assert tmoe.route_table([(np.array([[0, 1], [2, 3]]),
                              np.array([0.5, 0.1]))], [(4, 1)], 1) == {
        (0, 0, 4): ((0, 1), 0.5), (0, 1, 4): ((2, 3), 0.1)}


# ---------------------------------------------------------------------------
# whole models, and one training step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "kimi-k2-1t-a32b"])
def test_prefill_and_decode_match_repro(arch, monkeypatch):
    serve_matches_repro(arch, monkeypatch)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b"])
def test_one_train_step_matches_repro(arch, monkeypatch):
    """One adamw step from the same parameters on the same batch: the
    loss, its ce and aux parts, and the parameters after the update."""
    jcfg, tcfg = cfgs(arch)
    jparams, tparams = params(jcfg)
    rng = np.random.default_rng(0)
    seq = rng.integers(0, tcfg.vocab_size, (2, 17), dtype=np.int32)
    nb = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v.copy()) for k, v in nb.items()}
    jo = jopt.make("adamw", jopt.cosine_schedule(*LR))
    to = topt.make("adamw", topt.cosine_schedule(*LR))
    jrec = repro_routes(monkeypatch)
    jnew, jm = jax.jit(jsteps.build_train_step(jcfg, jo))(
        {"params": jparams, "opt_state": jo.init(jparams),
         "step": jnp.zeros((), jnp.int32)}, jb)
    jax.effects_barrier()
    monkeypatch.undo()
    with tmoe.record_routes() as trec:
        tnew, tm = tsteps.build_train_step(tcfg, to)(
            {"params": tparams, "opt_state": to.init(tparams),
             "step": torch.zeros((), dtype=torch.int32)}, tb)
    n = moe_layers(tcfg)
    assert n > 0 and len(trec) == n
    _, count = tmoe.route_divergence(
        tmoe.route_table(trec, [(0, 16)], n),
        tmoe.route_table(jrec[:n], [(0, 16)], n))
    assert count == 0
    for key in ("loss", "ce", "aux"):
        close(tm[key], jm[key])
    assert float(tm["aux"]) > 0
    jgrads = jax.grad(lambda p: jsteps.make_loss_fn(jcfg)(p, jb)[0])(jparams)

    def as_port(tree):   # repro's tree in the port's list/dict structure
        return convert.lm_params_to_numpy(convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, tree), device="cpu"))

    want = as_port(jnew["params"])
    bounds = topt.step_tolerance(want, as_port(jgrads),
                                 float(jopt.cosine_schedule(*LR)(
                                     jnp.int32(0))))
    got = topt.tree_map(lambda x: x.detach().numpy(), tnew["params"])
    leaves = list(zip(topt.tree_leaves(got), topt.tree_leaves(want),
                      topt.tree_leaves(bounds)))
    assert len(leaves) == len(jax.tree.leaves(jparams))
    for g, w, bd in leaves:
        assert g.shape == w.shape
        assert (np.abs(g - w) <= bd).all(), float(np.abs(g - w).max())
