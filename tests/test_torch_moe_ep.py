"""Expert parallelism (``models/moe.py`` ``apply_ep``, ``apply_ep_decode``)
on 8 spawned gloo ranks against ``repro``, on the CPU.

``repro``'s own EP test (``tests/test_moe_ep.py``) runs its paths under
``shard_map``, which does not run here; its per-device bodies
(``_ep_local``, ``_ep_decode_local``) do, under ``jax.vmap`` with the
axis name ``model``, and they are the oracle for the drops: each rank's
block of x, each shard of the experts, the same arithmetic.  With no drop
(capacity factor 8 = E / k) the oracle is ``repro``'s ``apply_dense``.

One spawn of 8 ranks (a (2, 4) ``("data", "model")`` mesh, ``repro``'s
test config: 8 experts, top-2, d_model 32) for the module; the ranks run
only torch and the port (this module imports JAX inside its fixtures, so
a rank importing it does not), and each case asserts on their results.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import make_mesh
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed import context as dctx
from repro_torch.launch import op_cost
from repro_torch.models import moe as tmoe

MESH = ((2, 4), ("data", "model"))
B, S, D = 4, 8, 32
# the variants each rank runs: name -> (capacity factor, fp8 dispatch)
VARIANTS = {"no_drop": (8.0, False), "drops": (0.5, False),
            "fp8": (8.0, True), "fp8_drops": (0.5, True)}
# EP against the vmap oracle of repro's bodies on the same shards: the same
# float32 arithmetic, summed in another order (XLA's scatter-add against
# index_add); with fp8 the dispatch is rounded alike on both sides
ORACLE_TOL = 1e-5
DENSE_TOL = 2e-4         # repro's tests/test_moe_ep.py
FP8_MEAN_REL = 0.1       # repro's bound on fp8 dispatch against dense


def _cfg(cf=8.0, fp8=False, moe_cfg=MoEConfig):
    return dict(
        name="moe-test", family="moe", num_layers=1, d_model=D,
        num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=128,
        pattern=("attn_moe",),
        moe=moe_cfg(num_experts=8, top_k=2, d_expert=16,
                    capacity_factor=cf, impl="ep", dispatch_fp8=fp8),
        dtype="float32", param_dtype="float32")


def _arrays():
    rng = np.random.default_rng(0)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    params = {"router": n(D, 8) / np.sqrt(D), "wi": n(8, D, 16) / np.sqrt(D),
              "wg": n(8, D, 16) / np.sqrt(D), "wo": n(8, 16, D) / 4.0}
    return params, n(B, S, D), n(B, 1, D)


def _batch_of_one():
    """x (1, S, D), a batch that does not split over "data", and the
    cotangent its output is held against."""
    rng = np.random.default_rng(1)
    return [rng.standard_normal((1, S, D)).astype(np.float32)
            for _ in range(2)]


def _ranks_body(rank, world):
    """One rank: every variant through ``moe.apply`` under the mesh (S=8:
    apply_ep, S=1: apply_ep_decode), the no-drop gradients, the
    gradients at a batch of one (``moe.apply`` takes apply_ep_decode,
    the data axis running it alike), and the counted collectives of one
    apply_ep."""
    mesh = make_mesh(*MESH, devices=["cpu"] * world)
    arrays, x, xd = _arrays()
    params = {k: torch.from_numpy(v) for k, v in arrays.items()}
    out = {}
    with dctx.mesh_context(mesh):
        for name, (cf, fp8) in VARIANTS.items():
            cfg = ModelConfig(**_cfg(cf, fp8))
            for what, xs in (("ep", x), ("decode", xd)):
                y, aux = tmoe.apply(params, cfg, torch.from_numpy(xs))
                out[f"{what}_{name}"] = (y.numpy(), float(aux))
        cfg = ModelConfig(**_cfg())
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        xg = torch.from_numpy(x).requires_grad_()
        y, _ = tmoe.apply_ep(leaves, cfg, xg, mesh)
        (y ** 2).sum().backward()
        out["grads"] = {k: v.grad.numpy() for k, v in leaves.items()}
        out["grads"]["x"] = xg.grad.numpy()
        x1, cot = (torch.from_numpy(a) for a in _batch_of_one())
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        x1.requires_grad_()
        y, aux = tmoe.apply(leaves, cfg, x1)
        ((y * cot).sum() + aux).backward()
        out["b1_grads"] = {k: v.grad.numpy() for k, v in leaves.items()}
        out["b1_grads"]["x"] = x1.grad.numpy()
        cost = op_cost.count(tmoe.apply_ep, params, cfg, torch.from_numpy(x),
                             mesh)
        out["coll"] = dict(cost.coll_breakdown)
        out["flops"] = cost.flops
    return out


@pytest.fixture(scope="module")
def ranks():
    return dctx.run_local(_ranks_body, 8, timeout=150)


@pytest.fixture(scope="module")
def oracle():
    """repro's dense path, and its EP bodies under vmap on each data
    shard, for every variant."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ModelConfig as JCfg
    from repro.configs.base import MoEConfig as JMoE
    from repro.models import moe as jmoe

    arrays, x, xd = _arrays()
    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    n = MESH[0][1]
    split = {k: jnp.asarray(v.reshape((n, 8 // n) + v.shape[1:]))
             for k, v in arrays.items() if k != "router"}
    want = {}
    for name, (cf, fp8) in VARIANTS.items():
        cfg = JCfg(**_cfg(cf, fp8, JMoE))
        for what, xs in (("ep", x), ("decode", xd)):
            want[f"dense_{what}_{name}"] = np.asarray(
                jmoe.apply_dense(jp, cfg, jnp.asarray(xs))[0])
        for what, xs, body in (("ep", x, jmoe._ep_local),
                               ("decode", xd, jmoe._ep_decode_local)):
            run = jax.vmap(functools.partial(body, cfg=cfg, n_shards=n,
                                             ep_axis="model"),
                           in_axes=(0, None, 0, 0, 0), axis_name="model")
            ys, auxes = [], []
            for half in np.split(xs, MESH[0][0]):       # the data shards
                bl, s = half.shape[:2]
                if what == "ep":                        # sequence over model
                    blocks = half.reshape(bl, n, s // n, D).transpose(
                        1, 0, 2, 3).reshape(n, -1, D)
                else:                                   # replicated
                    blocks = np.broadcast_to(half.reshape(1, -1, D),
                                             (n, bl * s, D))
                y, aux = run(jnp.asarray(blocks), jp["router"], split["wi"],
                             split["wg"], split["wo"])
                y = np.asarray(y)
                if what == "ep":
                    y = y.reshape(n, bl, s // n, D).transpose(
                        1, 0, 2, 3).reshape(bl, s, D)
                else:
                    y = y[0].reshape(bl, s, D)
                ys.append(y)
                auxes.append(float(aux[0]))
            want[f"{what}_{name}"] = (np.concatenate(ys), float(np.mean(auxes)))
    # the decode body's gradients at a batch of one: every model shard
    # runs it on the whole batch, (y . cot) + aux differentiated through
    # the vmap (x and the router summed over the shards, each expert
    # from its shard)
    x1, cot = _batch_of_one()
    cfg = JCfg(**_cfg(moe_cfg=JMoE))
    run = jax.vmap(functools.partial(jmoe._ep_decode_local, cfg=cfg,
                                     n_shards=n, ep_axis="model"),
                   in_axes=(0, None, 0, 0, 0), axis_name="model")

    def loss(x, router, wi, wg, wo):
        t = x.reshape(-1, D)
        y, aux = run(jnp.broadcast_to(t, (n,) + t.shape), router,
                     *(w.reshape((n, 8 // n) + w.shape[1:])
                       for w in (wi, wg, wo)))
        return jnp.sum(y[0].reshape(x.shape) * cot) + aux[0]
    names = ("x", "router", "wi", "wg", "wo")
    grads = jax.grad(loss, argnums=tuple(range(5)))(
        jnp.asarray(x1), *(jp[k] for k in names[1:]))
    want["b1_grads"] = {k: np.asarray(g) for k, g in zip(names, grads)}
    return want


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_every_rank_holds_the_same_global_outputs(ranks):
    for r in ranks[1:]:
        for key in VARIANTS:
            for what in ("ep", "decode"):
                np.testing.assert_array_equal(r[f"{what}_{key}"][0],
                                              ranks[0][f"{what}_{key}"][0])
                assert r[f"{what}_{key}"][1] == ranks[0][f"{what}_{key}"][1]


@pytest.mark.parametrize("what", ["ep", "decode"])
def test_no_drop_equals_repros_dense(ranks, oracle, what):
    _close(ranks[0][f"{what}_no_drop"][0], oracle[f"dense_{what}_no_drop"],
           DENSE_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("what", ["ep", "decode"])
def test_equals_repros_body_under_vmap(ranks, oracle, what, variant):
    got, aux = ranks[0][f"{what}_{variant}"]
    want, want_aux = oracle[f"{what}_{variant}"]
    _close(got, want, ORACLE_TOL)
    assert aux == pytest.approx(want_aux, rel=1e-6, abs=1e-7)


def test_drops_change_the_output(ranks, oracle):
    """At capacity factor 0.5 the drop rule is at work: the result is
    far from dense, and equal to repro's body (above)."""
    err = np.abs(ranks[0]["ep_drops"][0] - oracle["dense_ep_drops"]).max()
    assert err > 0.1, err


@pytest.mark.parametrize("variant", ["fp8", "fp8_drops"])
def test_fp8_dispatch_within_repros_bound(ranks, oracle, variant):
    dense = oracle["dense_ep_" + variant]
    got = ranks[0]["ep_" + variant][0]
    if variant == "fp8":
        err = np.abs(got - dense)
        assert err.mean() / (np.abs(dense).mean() + 1e-6) < FP8_MEAN_REL
        assert err.max() > 0          # the dispatch was rounded
    else:
        assert not np.array_equal(got, ranks[0]["ep_drops"][0])


def test_no_drop_gradients_equal_the_dense_paths(ranks):
    """apply_ep's gradients, summed over the mesh into the whole
    parameters and x, equal apply_dense's, on every rank."""
    arrays, x, _ = _arrays()
    cfg = ModelConfig(**_cfg())
    leaves = {k: torch.from_numpy(v).requires_grad_()
              for k, v in arrays.items()}
    xg = torch.from_numpy(x).requires_grad_()
    y, _ = tmoe.apply_dense(leaves, cfg, xg)
    (y ** 2).sum().backward()
    for r in ranks:
        for k, v in leaves.items():
            _close(r["grads"][k], v.grad.numpy(), DENSE_TOL)
        _close(r["grads"]["x"], xg.grad.numpy(), DENSE_TOL)


def test_decode_gradients_at_a_batch_of_one_equal_repros_body(ranks,
                                                              oracle):
    """Fault 3.11: a batch of one does not split over "data", so
    moe.apply takes apply_ep_decode and the data devices run it alike.
    The gradients of (y . cot) + aux (the load-balance and z losses
    included) == repro's decode body differentiated under vmap, on every
    rank (before the fix the aux loss's were halved by its mean over
    "data" and the rest doubled by the sum over it)."""
    want = oracle["b1_grads"]
    for r in ranks:
        assert set(r["b1_grads"]) == set(want)
        for k, w in want.items():
            _close(r["b1_grads"][k], w, ORACLE_TOL)


def test_counted_collectives_follow_the_ring_rules(ranks):
    """op_cost on one apply_ep: two all-to-alls of the (E x cap) slots
    over the model axis (n = 4), the aux's means over model (4) and data
    (2), the output's all-gather over the 8 ranks."""
    t_loc = (B // 2) * (S // 4)
    cap = -(-t_loc * 2 * 8 // 8)
    slots = 8 * cap * D * 4
    want = {"all-to-all": 2 * slots * 3 / 4,
            "all-reduce": 2 * 4 * 3 / 4 + 2 * 4 * 1 / 2,
            "all-gather": B * S * D * 4 * 7 / 8,
            "reduce-scatter": 0.0, "collective-permute": 0.0}
    for r in ranks:
        assert r["coll"] == want
        assert r["flops"] > 0


def test_dispatch_fp8_sends_bytes_not_a_wider_type(monkeypatch):
    """The fp8 dispatch hands the all-to-all uint8 bits of e4m3."""
    seen = []
    monkeypatch.setattr(tmoe.dctx, "all_to_all",
                        lambda x, mesh, axis: seen.append(x.dtype) or x)
    x = torch.randn(4, 6)
    got = tmoe._fp8_all_to_all(x, None, "model")
    assert seen == [torch.uint8]
    assert torch.equal(got, x.to(torch.float8_e4m3fn).to(torch.float32))
