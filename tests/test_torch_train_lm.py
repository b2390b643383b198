"""The port's LM training (``train/steps.py``, ``adafactor``, the bf16
gradient backward, ``optim/grad_compress.py``, ``launch/train.py``, the
binary-LM example twin) against ``repro``'s, in float32 at ``scaled()``
sizes, the same parameters (``repro``'s, carried across by
``convert.lm_params_from_numpy``) and the same batch given to both (the
token draws differ between the packages: ``repro_torch/data/tokens.py``).

Tolerances, each with its reason:

* chunked CE against ``repro``'s, and across chunk sizes: rtol 1e-5
  (float32 sums in another order; ``repro``'s own invariance tolerance);
* a whole train step's loss: rtol = atol = 2e-4, ``repro``'s tolerance for
  whole-model float32 agreement (``tests/test_serve_equiv.py``); its
  parameters within ``optimizers.step_tolerance`` against ``repro``'s
  gradients (Adam and Adafactor step by about lr x sign(g) however small
  g is, so a gradient at rounding level may step either way);
* ``quant="binary"``: the same, and any sign of ``ste_sign`` the two
  packages disagree on must have a pre-sign magnitude under 1e-6 of its
  row's scale in both;
* the bf16-gradient backward: dx and dw within 1e-2 relative of the
  largest element (both round the cotangent and the operands to bf16,
  8 mantissa bits, and sum in another order), the forward exact;
* int8 compression: quantized words and scales equal, residuals exact to
  float32 rounding;
* a killed and resumed ``launch/train.py`` against an unbroken run:
  equal, bit for bit (the same process, the same operations).
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.optim import grad_compress as jgc
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry as treg
from repro_torch.data import tokens as ttok
from repro_torch.examples import train_binary_lm
from repro_torch.launch import train as tlaunch
from repro_torch.models import common as tcommon
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim import optimizers as topt
from repro_torch.train import steps as tsteps
from tests.test_torch_interpreter import one_torch_thread  # noqa: F401

TOL = 2e-4
LR = (1e-3, 2, 10)           # cosine_schedule(peak, warmup, total)


def _cfgs(**over):
    over = dict(dtype="float32", param_dtype="float32", **over)
    return (jreg.get_config("smollm-360m").scaled().with_(**over),
            treg.get_config("smollm-360m").scaled().with_(**over))


def _state(jcfg, name, seed=0):
    jparams = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           device="cpu")
    return jparams, tparams


def _batch(cfg, b=2, s=32, step=0):
    """One batch made with numpy, as numpy, jax and torch."""
    rng = np.random.default_rng(step)
    seq = rng.integers(0, cfg.vocab_size, (b, s + 1), dtype=np.int32)
    nb = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v.copy()) for k, v in nb.items()})


def _np(tree):
    return topt.tree_map(lambda x: x.detach().numpy(), tree)


def _jnp_tree(tree):
    """repro's param tree as numpy, in the port's list/dict structure."""
    return convert.lm_params_to_numpy(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, tree), device="cpu"))


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------

def test_chunked_ce_matches_repro_and_is_chunk_invariant():
    jcfg, tcfg = _cfgs()
    jparams, tparams = _state(jcfg, "adamw")
    jb, tb = _batch(tcfg, b=2, s=64)
    h = np.random.default_rng(1).standard_normal(
        (2, 64, tcfg.d_model)).astype(np.float32)
    losses = []
    for chunk in (16, 32, 64, 48):        # 48 does not divide: one chunk
        want = float(jsteps.chunked_ce(jparams, jcfg.with_(loss_chunk=chunk),
                                       jnp.asarray(h), jb["labels"]))
        got = float(tsteps.chunked_ce(tparams, tcfg.with_(loss_chunk=chunk),
                                      torch.from_numpy(h), tb["labels"]))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        losses.append(got)
    np.testing.assert_allclose(losses, losses[0], rtol=1e-5)
    # the loss function's gradients do not depend on the chunking either
    grads = []
    for chunk in (16, 64):
        loss_fn = tsteps.make_loss_fn(tcfg.with_(loss_chunk=chunk))
        (_, _), g = topt.value_and_grad(lambda p: loss_fn(p, tb), tparams)
        grads.append(topt.tree_leaves(_np(g)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# one train step against repro's
# ---------------------------------------------------------------------------

def _one_step(name, jcfg, tcfg, **kw):
    jparams, tparams = _state(jcfg, name)
    jb, tb = _batch(tcfg)
    jo = jopt.make(name, jopt.cosine_schedule(*LR), **kw)
    to = topt.make(name, topt.cosine_schedule(*LR), **kw)
    jstate = {"params": jparams, "opt_state": jo.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tparams, "opt_state": to.init(tparams),
              "step": torch.zeros((), dtype=torch.int32)}
    jnew, jm = jax.jit(jsteps.build_train_step(jcfg, jo))(jstate, jb)
    tnew, tm = tsteps.build_train_step(tcfg, to)(tstate, tb)
    jgrads = jax.grad(lambda p: jsteps.make_loss_fn(jcfg)(p, jb)[0])(jparams)
    return jnew, jm, tnew, tm, jgrads, tparams, tb


def _hold_step(jnew, jm, tnew, tm, jgrads):
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=TOL, atol=TOL)
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    want, grads = _jnp_tree(jnew["params"]), _jnp_tree(jgrads)
    lr = float(jopt.cosine_schedule(*LR)(jnp.int32(0)))
    bounds = topt.step_tolerance(want, grads, lr)
    got = _np(tnew["params"])
    for g, w, b in zip(topt.tree_leaves(got), topt.tree_leaves(want),
                       topt.tree_leaves(bounds)):
        assert g.shape == w.shape
        assert (np.abs(g - w) <= b).all(), float(np.abs(g - w).max())


@pytest.mark.parametrize("name,kw", [("adamw", {}), ("adafactor", {}),
                                     ("sgdm", {})])
def test_one_train_step_matches_repro(name, kw):
    jcfg, tcfg = _cfgs()
    jnew, jm, tnew, tm, jgrads, _, _ = _one_step(name, jcfg, tcfg, **kw)
    _hold_step(jnew, jm, tnew, tm, jgrads)


def test_binary_train_step_matches_repro():
    """quant="binary": BitLinear's STE sign on both sides.  Where a sign
    differs (a pre-sign value at rounding level of 0), it must be one
    both packages put within 1e-6 of its row's scale; none does here,
    so the step is held as the float one."""
    jcfg, tcfg = _cfgs(quant="binary")
    jparams, tparams = _state(jcfg, "adamw")
    # the weight signs: identical leaves, so identical signs
    for jl, tl in zip(jax.tree.leaves(jparams),
                      topt.tree_leaves(tparams)):
        np.testing.assert_array_equal(np.sign(np.asarray(jl)),
                                      np.sign(tl.numpy()))
    # the activations entering the first BitLinears (wq, wk, wv): the
    # first block's normed embeddings, held sign by sign under the rule
    jb, tb = _batch(tcfg)
    ln1 = jax.tree.map(lambda x: x[0], jparams["blocks"]["pos0"]["ln1"])
    a = np.asarray(jcommon.rmsnorm_apply(
        ln1, jparams["embed"]["table"][jb["tokens"]], jcfg.norm_eps))
    b = tcommon.rmsnorm_apply(
        {"scale": tparams["blocks"]["pos0"]["ln1"]["scale"][0]},
        tparams["embed"]["table"][tb["tokens"].long()],
        tcfg.norm_eps).numpy()
    scale = np.abs(a).max(axis=-1, keepdims=True)
    differ = np.sign(a) != np.sign(b)
    assert (~differ | ((np.abs(a) < 1e-6 * scale)
                       & (np.abs(b) < 1e-6 * scale))).all()
    jnew, jm, tnew, tm, jgrads, _, _ = _one_step("adamw", jcfg, tcfg)
    _hold_step(jnew, jm, tnew, tm, jgrads)


def test_binary_loss_in_the_configs_own_dtypes_matches_repro():
    """bf16 activations against float32 weights (SmolLM's own dtypes):
    BitLinear's product runs in the promoted type, as ``jnp.einsum``
    promotes it (the port's matmul had refused the mixed operands).
    The loss within 1e-2 relative: bf16 activations, 8 mantissa bits."""
    over = dict(dtype="bfloat16", param_dtype="float32", quant="binary")
    jcfg = jreg.get_config("smollm-360m").scaled().with_(**over)
    tcfg = treg.get_config("smollm-360m").scaled().with_(**over)
    jparams, tparams = _state(jcfg, "adamw")
    jb, tb = _batch(tcfg)
    want = float(jsteps.make_loss_fn(jcfg)(jparams, jb)[0])
    (got, _), grads = topt.value_and_grad(
        lambda p: tsteps.make_loss_fn(tcfg)(p, tb), tparams)
    np.testing.assert_allclose(float(got), want, rtol=1e-2)
    assert all(bool(torch.isfinite(g).all())
               for g in topt.tree_leaves(grads))


def test_adafactor_factored_update_matches_repro():
    """Explicit shapes (scaled() leaves are mostly unfactored): a
    (256, 512) leaf factored into vr (256,) / vc (512,), a (2, 128, 130)
    stack factored over its last two dims, a (4,) and a (64, 200) leaf
    not; three updates, clipping on the second."""
    rng = np.random.default_rng(0)
    shapes = {"big": (256, 512), "stack": (2, 128, 130), "small": (4,),
              "thin": (64, 200)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.1
              for k, s in shapes.items()}
    jo = jopt.make("adafactor", jopt.cosine_schedule(1e-2, 1, 10))
    to = topt.make("adafactor", topt.cosine_schedule(1e-2, 1, 10))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    assert set(ts["v"]["big"]) == {"vr", "vc"}
    assert ts["v"]["big"]["vr"].shape == (256,)
    assert ts["v"]["big"]["vc"].shape == (512,)
    assert ts["v"]["stack"]["vc"].shape == (2, 130)
    assert set(ts["v"]["small"]) == set(ts["v"]["thin"]) == {"v"}
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             * (10.0 if step == 1 else 1e-3) for k, s in shapes.items()}
        jp, js, jgn = jo.update({k: jnp.asarray(v) for k, v in g.items()},
                                js, jp, jnp.int32(step))
        tp, ts, tgn = to.update({k: torch.from_numpy(v) for k, v in
                                 g.items()}, ts, tp, step)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-5)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6)
            for f in ts["v"][k]:
                np.testing.assert_allclose(ts["v"][k][f].numpy(),
                                           np.asarray(js["v"][k][f]),
                                           rtol=1e-5, atol=1e-30)


def test_optimizers_converge_on_a_quadratic():
    """The twin of repro's test_optimizer_converges: ||Wx - y||^2."""
    gen = torch.Generator().manual_seed(0)
    target = torch.randn((16, 16), generator=gen)
    x = torch.randn((32, 16), generator=gen)
    y = x @ target.T
    for name, kw in (("adamw", dict(weight_decay=0.0)),
                     ("adafactor", dict(min_dim_size_to_factor=8)),
                     ("sgdm", {})):
        o = topt.make(name, lambda s: torch.tensor(3e-2), **kw)
        params = {"w": torch.zeros((16, 16)), "b": torch.zeros(16)}
        state, losses = o.init(params), []
        for i in range(60):
            (loss, _), g = topt.value_and_grad(
                lambda p: (torch.mean((x @ p["w"].T + p["b"] - y) ** 2),
                           None), params)
            params, state, _ = o.update(g, state, params, i)
            losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.05, (name, losses[0], losses[-1])


def test_eval_step_is_the_loss_function():
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    _, tparams = _state(jcfg, "adamw")
    _, tb = _batch(tcfg)
    out = tsteps.build_eval_step(tcfg)(tparams, tb)
    loss, parts = tsteps.make_loss_fn(tcfg)(tparams, tb)
    assert float(out["loss"]) == float(loss)
    assert set(out) == {"loss", "ce", "aux"}


# ---------------------------------------------------------------------------
# the bf16-gradient backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_grads_backward_matches_repro_custom_vjp(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 8, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) / 10).astype(np.float32)
    r = rng.standard_normal((3, 8, 40)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = tcommon.torch_dtype(dtype)

    def jloss(x, w):
        y = jcommon.linear_apply({"w": w}, x.astype(jdt), bf16_grads=True)
        return jnp.sum(y.astype(jnp.float32) * r)

    (jdx, jdw) = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = tcommon.linear_apply({"w": tw}, tx.to(tdt), bf16_grads=True)
    plain = tcommon.linear_apply({"w": tw}, tx.to(tdt))
    assert torch.equal(y, plain)                  # the forward is the same
    torch.sum(y.float() * torch.from_numpy(r)).backward()
    got = (tx.grad.clone(), tw.grad.clone())
    want = tuple(torch.from_numpy(np.asarray(v, np.float32))
                 for v in (jdx, jdw))

    def bf16_products(grads):
        """Both gradients are bf16 matmul outputs (exact in bf16), each
        within one bf16 ulp (at most 2^-7 of the value) of repro's, and
        at least 99% of them equal to it (only the summation order
        differs)."""
        return all(
            torch.equal(g, g.to(torch.bfloat16).float())
            and bool(((g - v).abs() <= v.abs() * 2.0 ** -7).all())
            and float((g == v).float().mean()) >= 0.99
            for g, v in zip(grads, want))

    assert all(g.dtype == torch.float32 for g in got)
    assert bf16_products(got)
    # dw is the product of the bf16-rounded operands, bit for bit
    g16 = torch.from_numpy(r).to(torch.bfloat16).reshape(-1, 40)
    x16 = tx.detach().to(tdt).to(torch.bfloat16).reshape(-1, 96)
    assert torch.equal(got[1], (x16.t() @ g16).float())
    # the check tells a missing cast apart: in float32 the plain backward
    # (cotangent kept in float32) is no bf16 product
    tx.grad = tw.grad = None
    torch.sum(plain.float() * torch.from_numpy(r)).backward()
    if dtype == "float32":
        assert not bf16_products((tx.grad, tw.grad))
        assert not torch.equal(tw.grad, got[1])


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_compress_roundtrip_and_error_feedback_match_repro():
    g = np.random.default_rng(0).standard_normal(128).astype(np.float32)
    q, scale, err1 = tgc.compress(torch.from_numpy(g), torch.zeros(128))
    jq, jscale, jerr1 = jgc.compress(jnp.asarray(g), jnp.zeros(128))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    np.testing.assert_allclose(err1.numpy(), np.asarray(jerr1), rtol=0,
                               atol=1e-7)
    deq = tgc.decompress(q, scale)
    np.testing.assert_allclose((deq + err1).numpy(), g, rtol=1e-6,
                               atol=1e-6)
    assert float(err1.abs().max()) <= float(scale) * 0.5 + 1e-9
    # error feedback: the mean dequantized update approaches the gradient
    true_g = torch.from_numpy(
        np.random.default_rng(1).standard_normal(64).astype(np.float32)
        * 0.01)
    err, acc = torch.zeros(64), torch.zeros(64)
    for _ in range(50):
        q, scale, err = tgc.compress(true_g, err)
        acc = acc + tgc.decompress(q, scale)
    np.testing.assert_allclose((acc / 50).numpy(), true_g.numpy(),
                               rtol=0.02, atol=1e-5)
    state = tgc.init_error_state({"a": torch.ones(3, dtype=torch.bfloat16),
                                  "b": [torch.ones(2)]})
    assert state["a"].dtype == torch.float32 and state["b"][0].shape == (2,)


# ---------------------------------------------------------------------------
# the driver: killed and resumed == unbroken
# ---------------------------------------------------------------------------

ARGS = ["--arch", "smollm-360m", "--scaled", "--steps", "6",
        "--global-batch", "2", "--seq-len", "16", "--ckpt-every", "4",
        "--log-every", "100", "--device", "cpu"]


def test_launch_train_killed_and_resumed_equals_unbroken(tmp_path,
                                                         monkeypatch):
    whole, _ = tlaunch.main(ARGS + ["--ckpt-dir", str(tmp_path / "a")])
    assert ckpt.latest_step(str(tmp_path / "a")) == 6
    # SIGTERM arrives while step 2 runs: the driver finishes the step,
    # saves synchronously and exits 0
    real = ttok.batch_for_step

    def preempt(cfg, step, **kw):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(cfg, step, **kw)
    monkeypatch.setattr(ttok, "batch_for_step", preempt)
    with pytest.raises(SystemExit) as stop:
        tlaunch.main(ARGS + ["--ckpt-dir", str(tmp_path / "b")])
    assert stop.value.code == 0
    assert ckpt.latest_step(str(tmp_path / "b")) == 3
    monkeypatch.setattr(ttok, "batch_for_step", real)
    resumed, losses = tlaunch.main(ARGS + ["--ckpt-dir",
                                           str(tmp_path / "b")])
    assert len(losses) == 3                       # steps 3, 4 and 5
    for a, b in zip(topt.tree_leaves(whole), topt.tree_leaves(resumed)):
        assert torch.equal(a, b)
    assert signal.getsignal(signal.SIGTERM) is not None


def test_binary_lm_example_twin_trains_resumes_and_decodes(capsys):
    losses, gen = train_binary_lm.main(["--device", "cpu", "--steps", "24",
                                        "--crash-at", "12"])
    out = capsys.readouterr().out
    assert "simulated preemption after step 12" in out
    assert "restored checkpoint @ step 12" in out
    assert "OK: binary LM trained" in out
    assert len(losses) == 24 and all(np.isfinite(losses))
    assert gen.shape == (2, 9)


# ---------------------------------------------------------------------------
# repro's two slow "learns" tests, twinned
# ---------------------------------------------------------------------------

def _run(cfg, optimizer, n_steps):
    state = tsteps.create_state(cfg, 0, optimizer, device="cpu")
    step = tsteps.build_train_step(cfg, optimizer)
    losses = []
    for s in range(n_steps):
        batch = ttok.batch_for_step(cfg, s, global_batch=8, seq_len=64,
                                    device="cpu")
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.slow
def test_lm_training_learns():
    _, cfg = _cfgs(loss_chunk=32)
    losses = _run(cfg, topt.make("adamw", topt.cosine_schedule(3e-3, 10,
                                                                200)), 40)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.8, (losses[0], losses[-1])


@pytest.mark.slow
def test_binary_lm_training_learns():
    """BinaryNet (the paper's technique) trains via STE at LM scale."""
    _, cfg = _cfgs(loss_chunk=32, quant="binary")
    losses = _run(cfg, topt.make("adamw", topt.cosine_schedule(3e-3, 10,
                                                                200)), 40)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])
