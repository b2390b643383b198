"""The collectives over ``torch.distributed`` groups on spawned gloo ranks
against ``repro``, on the CPU: ``optim/grad_compress.py``
``compressed_psum_tree`` and ``distributed/pipeline.py`` ``pipelined``.

* The compressed psum over the ``pod`` axis (4 ranks) of a (4, 2)
  ``("pod", "data")`` mesh, three steps carrying the residuals: equal bit
  for bit to ``repro``'s ``compressed_psum_tree`` under ``jax.vmap`` with
  the axis name ``pod`` on the same per-rank gradients (float32 and
  bfloat16 leaves), means and residuals; counted by ``op_cost``, its wire
  bytes are the ring arithmetic by hand.
* The GPipe schedule against ``tests/test_pipeline.py``'s oracle, the
  stages applied in turn (S=4, M=8, B=16, D=32, ``tanh(x @ w + b)``, on
  the (4, 2) mesh; M=4 on a (2, 2, 2) ``("pod", "data", "model")`` mesh),
  outputs and every stage's parameter gradients within 1e-5.

One spawn of 8 ranks for the module; the ranks run only torch and the
port (this module imports JAX inside its fixtures, so a rank importing it
does not), and each case asserts on their results.
"""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import make_mesh
from repro_torch.distributed import context as dctx
from repro_torch.distributed.pipeline import pipelined
from repro_torch.launch import op_cost
from repro_torch.optim import grad_compress as tgc

WORLD = 8
PSUM_MESH = ((4, 2), ("pod", "data"))
STEPS = 3
# the gradient tree of every rank: leaf -> (shape, dtype)
LEAVES = {"a": ((5, 7), "float32"), "b": {"c": ((13,), "float32"),
                                          "d": ((3, 4), "bfloat16")}}
# pipelines: (mesh shape, axis names, stages, microbatches)
PIPES = {"pod4_data2": ((4, 2), ("pod", "data"), 4, 8),
         "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"), 2, 4)}
B, D = 16, 32
PIPE_TOL = 1e-5
# the gradients: 1e-5 of each leaf's largest entry.  They reach 12 at
# these shapes, and float32 sums of terms that size land ~2e-5 from
# float64 in either program (test_pipeline_gradients_near_float64 prints
# both), so an absolute 1e-5 holds neither of them
GRAD_TOL = 1e-5


def _grads(rank: int, step: int) -> dict:
    """Float32 arrays of each leaf (bfloat16 leaves rounded from them)."""
    rng = np.random.default_rng(1000 * step + rank)

    def leaf(spec):
        if isinstance(spec, dict):
            return {k: leaf(v) for k, v in spec.items()}
        return (rng.standard_normal(spec[0]) * (1 + rank)).astype(np.float32)
    return leaf(LEAVES)


def _map(fn, tree, spec=LEAVES):
    if isinstance(spec, dict):
        return {k: _map(fn, tree[k], spec[k]) for k in spec}
    return fn(tree, spec[1])


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _pipe_arrays():
    rng = np.random.default_rng(0)
    s = max(v[2] for v in PIPES.values())
    return ({"w": (rng.standard_normal((s, D, D)) * 0.5).astype(np.float32),
             "b": (rng.standard_normal((s, D)) * 0.1).astype(np.float32)},
            rng.standard_normal((B, D)).astype(np.float32))


def _ranks_body(rank, world):
    out = {}
    # the compressed psum over "pod", three steps carrying the residuals
    mesh = make_mesh(*PSUM_MESH, devices=["cpu"] * world)
    to_torch = lambda a, dt: torch.from_numpy(a).to(  # noqa: E731
        getattr(torch, dt))
    err = tgc.init_error_state(_map(to_torch, _grads(rank, 0)))
    with dctx.mesh_context(mesh):
        for step in range(STEPS):
            grads = _map(to_torch, _grads(rank, step))
            if step == 0:
                cost = op_cost.count(tgc.compressed_psum_tree, grads, err,
                                     "pod")
                out["coll"] = dict(cost.coll_breakdown)
                out["flops"] = cost.flops
            mean, err = tgc.compressed_psum_tree(grads, err, "pod")
            out[f"psum_{step}"] = (_map(lambda t, _: t.float().numpy(), mean),
                                   _map(lambda t, _: t.numpy(), err))
    # the pipelines: outputs and the gradients of sum(y ** 2)
    arrays, x = _pipe_arrays()
    for name, (shape, axes, s, m) in PIPES.items():
        mesh = make_mesh(shape, axes, devices=["cpu"] * world)
        params = {k: torch.from_numpy(v[:s]).requires_grad_()
                  for k, v in arrays.items()}
        y = pipelined(_stage_fn, mesh, num_microbatches=m)(
            params, torch.from_numpy(x))
        (y ** 2).sum().backward()
        out[name] = (y.detach().numpy(),
                     {k: v.grad.numpy() for k, v in params.items()})
    return out


def _failing_body(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


@pytest.fixture(scope="module")
def ranks():
    return dctx.run_local(_ranks_body, WORLD, timeout=150)


@pytest.fixture(scope="module")
def psum_oracle():
    """repro's compressed_psum_tree under vmap over the pod axis, one data
    column at a time: (means, residuals) a step, per rank."""
    import jax
    import jax.numpy as jnp
    from repro.optim import grad_compress as jgc

    pods, cols = PSUM_MESH[0]
    run = jax.vmap(lambda g, e: jgc.compressed_psum_tree(g, e, "pod"),
                   axis_name="pod")
    want = {}
    for d in range(cols):
        members = [p * cols + d for p in range(pods)]     # row-major ranks
        stack = lambda trees: jax.tree.map(  # noqa: E731
            lambda *xs: jnp.stack(xs), *trees)
        to_jax = lambda a, dt: jnp.asarray(a).astype(  # noqa: E731
            getattr(jnp, dt))
        err = stack([_map(lambda a, _: jnp.zeros(a.shape, jnp.float32),
                          _grads(r, 0)) for r in members])
        for step in range(STEPS):
            g = stack([_map(to_jax, _grads(r, step)) for r in members])
            mean, err = run(g, err)
            for i, r in enumerate(members):
                want[(r, step)] = (
                    jax.tree.map(lambda t: np.asarray(t[i], np.float32),
                                 mean),
                    jax.tree.map(lambda t: np.asarray(t[i]), err))
    return want


@pytest.fixture(scope="module")
def pipe_oracle():
    """tests/test_pipeline.py's oracle: the stages in turn, and jax.grad
    of sum(y ** 2)."""
    import jax
    import jax.numpy as jnp

    arrays, x = _pipe_arrays()
    want = {}
    for name, (_, _, s, _) in PIPES.items():
        params = {k: jnp.asarray(v[:s]) for k, v in arrays.items()}

        def seq(p, x):
            for i in range(s):
                x = jnp.tanh(x @ p["w"][i] + p["b"][i])
            return x
        y = seq(params, jnp.asarray(x))
        g = jax.grad(lambda p: jnp.sum(seq(p, jnp.asarray(x)) ** 2))(params)
        want[name] = (np.asarray(y), {k: np.asarray(v) for k, v in g.items()})
    return want


def _float64_grads(name):
    """The stages in turn in float64 (torch autograd): the gradients."""
    arrays, x = _pipe_arrays()
    s = PIPES[name][2]
    p = {k: torch.from_numpy(v[:s]).double().requires_grad_()
         for k, v in arrays.items()}
    y = torch.from_numpy(x).double()
    for i in range(s):
        y = torch.tanh(y @ p["w"][i] + p["b"][i])
    (y ** 2).sum().backward()
    return {k: v.grad.numpy() for k, v in p.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("step", range(STEPS))
def test_compressed_psum_equals_repros_bit_for_bit(ranks, psum_oracle, step):
    for rank, got in enumerate(ranks):
        mean, err = got[f"psum_{step}"]
        want_mean, want_err = psum_oracle[(rank, step)]
        for g, w in zip(_leaves(mean), _leaves(want_mean)):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(_leaves(err), _leaves(want_err)):
            np.testing.assert_array_equal(g, w)


def test_compressed_psum_means_agree_within_a_pod_line(ranks):
    pods, cols = PSUM_MESH[0]
    for d in range(cols):
        first = _leaves(ranks[d]["psum_0"][0])
        for p in range(1, pods):
            for g, w in zip(_leaves(ranks[p * cols + d]["psum_0"][0]), first):
                np.testing.assert_array_equal(g, w)
    # the two data columns reduce different gradients
    assert not np.array_equal(_leaves(ranks[0]["psum_0"][0])[0],
                              _leaves(ranks[1]["psum_0"][0])[0])


def test_counted_psum_follows_the_ring_rules(ranks):
    """Each leaf: a float32 scale max-reduced, its int32 values summed,
    both over the pod axis (n = 4): 2 * bytes * (n - 1) / n each."""
    n = PSUM_MESH[0][0]
    sizes = [a.size for a in _leaves(_grads(0, 0))]
    wire = sum(2 * 4 * (n - 1) / n + 2 * 4 * k * (n - 1) / n for k in sizes)
    for r in ranks:
        assert r["coll"] == {"all-reduce": wire, "all-gather": 0.0,
                             "reduce-scatter": 0.0, "all-to-all": 0.0,
                             "collective-permute": 0.0}
        assert r["flops"] > 0


@pytest.mark.parametrize("name", list(PIPES))
def test_pipeline_equals_the_stages_in_turn(ranks, pipe_oracle, name):
    want, _ = pipe_oracle[name]
    for r in ranks:                     # every rank holds the whole output
        np.testing.assert_allclose(r[name][0], want, rtol=PIPE_TOL,
                                   atol=PIPE_TOL)


@pytest.mark.parametrize("name", list(PIPES))
def test_pipeline_gradients_equal_the_stages_in_turn(ranks, pipe_oracle,
                                                     name):
    _, want = pipe_oracle[name]
    for r in ranks:
        for k, g in r[name][1].items():
            scale = np.abs(want[k]).max()
            assert scale > 0
            assert np.abs(g - want[k]).max() <= GRAD_TOL * scale, k


@pytest.mark.parametrize("name", list(PIPES))
def test_pipeline_gradients_near_float64(ranks, pipe_oracle, name):
    """The port's gradients are no farther from float64 than repro's
    float32 ones, give or take a float32 rounding of their scale."""
    exact = _float64_grads(name)
    for k, ref in exact.items():
        port = np.abs(ranks[0][name][1][k] - ref).max()
        jax_err = np.abs(pipe_oracle[name][1][k] - ref).max()
        print(f"{name} {k}: max |grad| {np.abs(ref).max():.3f}, from "
              f"float64: port {port:.2e}, repro {jax_err:.2e}")
        assert port <= 2 * jax_err + 1e-6 * np.abs(ref).max()


def test_run_local_raises_a_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*on "
                                           "purpose"):
        dctx.run_local(_failing_body, 2, timeout=60)
