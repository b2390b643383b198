"""The port's chip-tier training path vs ``repro``'s, on the same numpy
inputs: the STE, the differentiable ``forward_train``, the optimizers and
their schedule, one whole step, folding after it, the synthetic image
templates, and the two example twins.

Tolerances, each with its reason:

* STE values and gradients, logits, labels, folded words: exact (the
  chip tier is integer arithmetic; the STE is a compare and a mask);
* BN running means: rtol 1e-5 (XLA and PyTorch reduce the batch in
  other orders).  Running variances: rtol 1e-5 against the float64
  variance of the same batch, and rtol 3e-5 against ``repro``'s: XLA's
  float32 ``jnp.var`` over quickstart's 8 x 15 x 15 = 1,800 sums per
  feature is 1.2e-5 (relative) off the float64 value, PyTorch's 5e-8;
* gradients and the latents after a step: per leaf, max abs diff <=
  max(1e-4 x the JAX leaf's max abs, 1e-7) (the BN backward sums many
  float32 terms in another order).  After an adamw step, an element
  whose JAX gradient is itself within that tolerance of 0 may differ by
  up to 2 lr more: Adam steps by about lr x sign(g) however small g is,
  so a gradient at rounding level can step either way.  Those elements
  are counted, and the folded artifacts may differ only at the entries
  such rounding can flip;
* optimizers fed the same gradients and state: rtol 1e-6, plus an
  absolute 1e-6 x the leaf's max abs (the clip scales by the global norm,
  whose float32 sum runs in another order, and cancellation near 0 turns
  that 1e-7 into a larger relative difference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as jbin
from repro.core.chip import interpreter as jinterp, isa as jisa
from repro.core.chip import networks as jnets
from repro.data import images as jimg
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.core import binarize as tbin
from repro_torch.core.chip import interpreter as tinterp, isa as tisa
from repro_torch.core.chip import networks as tnets
from repro_torch.data import images as timg
from repro_torch.examples import always_on_detector as tdet
from repro_torch.examples import quickstart as tquick
from repro_torch.optim import optimizers as topt
from tests.test_torch_interpreter import one_torch_thread  # noqa: F401


def _quick(pkg):
    """quickstart's 16x16 S=4 program, built by either package's isa."""
    f = pkg.ARRAY_CHANNELS // 4
    return pkg.Program(s=4, instrs=(
        pkg.IOInstr(height=16, width=16, in_channels=3, bits=7, channels=f),
        pkg.ConvInstr(height=16, width=16, features=f, maxpool=True),
        pkg.ConvInstr(height=7, width=7, features=f, maxpool=True),
        pkg.FCInstr(in_features=3 * 3 * f, out_features=10, final=True)))


PROGRAMS = {"mnist5": (jnets.mnist5, tnets.mnist5),
            "quickstart": (lambda: _quick(jisa), lambda: _quick(tisa))}


def _np_params(program, seed: int):
    """init-like latents (N(0, 1/fan_in)) with BN affine parameters and
    running statistics away from their initial values."""
    rng = np.random.default_rng(seed)
    convs, fcs = [], []
    for (ins, _h, _w, c, *_rest) in jisa.layer_geometry(program):
        if isinstance(ins, jisa.ConvInstr):
            f = ins.features
            convs.append(dict(
                w=(rng.standard_normal((f, 2, 2, c)) / np.sqrt(4 * c)
                   ).astype(np.float32),
                gamma=(1 + 0.3 * rng.standard_normal(f)).astype(np.float32),
                beta=(0.3 * rng.standard_normal(f)).astype(np.float32),
                mean=rng.standard_normal(f).astype(np.float32),
                var=rng.uniform(0.5, 2.0, f).astype(np.float32)))
        elif isinstance(ins, jisa.FCInstr):
            fcs.append(dict(w=(rng.standard_normal(
                (ins.out_features, ins.in_features))
                / np.sqrt(ins.in_features)).astype(np.float32)))
    return {"conv": convs, "fc": fcs}


def _batch(program, b: int, seed: int):
    io = program.instrs[0]
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 2 ** io.bits,
                          (b, io.height, io.width, io.in_channels),
                          dtype=np.int32)
    return images, rng.integers(0, 10, b).astype(np.int32)


def _jax_loss(logits, labels):
    """quickstart's hinge loss, as repro's example writes it.  The JAX
    side runs eagerly, not under ``jax.jit`` as the example's step does:
    XLA contracts ``1 + logits * 0.1`` into a fused multiply-add, which
    moves the hinge's ties (integer logits x 0.1) off 0 and their
    gradient from 0.5 to 0 or 1.  Eager JAX and PyTorch round each
    operation, so their ties agree."""
    one_hot = jax.nn.one_hot(labels, 10)
    return jnp.mean(jnp.sum(jnp.maximum(
        0.0, 1.0 - one_hot * logits + (1 - one_hot) * logits * 0.1),
        axis=-1))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _leaf_tol(want: np.ndarray) -> float:
    return max(1e-4 * float(np.abs(want).max(initial=0.0)), 1e-7)


def _assert_close_per_leaf(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max(initial=0.0)) <= _leaf_tol(w)


def _float64_running_var(npp, jprog, images):
    """The running variances forward_train writes, with the batch variance
    of each conv layer's sums taken in float64 (the sums are integers, so
    they are exact in float32 and the float64 variance is the exact one
    to rounding)."""
    from repro.core.chip import neuron_array as jna
    p = jax.tree_util.tree_map(jnp.asarray, npp)
    out, ci, x = [], 0, None
    for ins in jprog.instrs:
        if isinstance(ins, jisa.IOInstr):
            x = jna.thermometer_encode(jnp.asarray(images), ins.bits,
                                       ins.channels)
        elif isinstance(ins, jisa.ConvInstr):
            q = p["conv"][ci]
            s = jna.conv2x2(x, jbin.ste_sign(q["w"]))
            var = np.asarray(s, np.float64).var(axis=(0, 1, 2))
            out.append(0.9 * npp["conv"][ci]["var"].astype(np.float64)
                       + 0.1 * var)
            mean, v32 = jnp.mean(s, axis=(0, 1, 2)), jnp.var(s, axis=(0, 1, 2))
            bn = q["gamma"] * (s - mean) * jax.lax.rsqrt(v32 + 1e-4) + q["beta"]
            x = jbin.ste_sign(bn)
            if ins.maxpool:
                x = jna.maxpool2x2(x)
            ci += 1
    return out


def _assert_bn_stats(tnew, jnew, npp, jprog, images):
    exact = _float64_running_var(npp, jprog, images)
    for jp, tp, v64 in zip(jnew["conv"], tnew["conv"], exact):
        assert not tp["mean"].requires_grad and not tp["var"].requires_grad
        np.testing.assert_allclose(tp["mean"].numpy(), np.asarray(jp["mean"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tp["var"].numpy(), v64, rtol=1e-5)
        np.testing.assert_allclose(tp["var"].numpy(), np.asarray(jp["var"]),
                                   rtol=3e-5)


# ---------------------------------------------------------------------------
# STE
# ---------------------------------------------------------------------------

def test_ste_sign_value_and_gradient_equal_repro():
    """Forward ties to +1 (0.0 and -0.0), backward mask inclusive at
    |x| == 1, exactly as repro's custom_vjp."""
    rng = np.random.default_rng(0)
    one, two = np.float32(1), np.float32(2)
    x = np.concatenate([
        np.array([0.0, -0.0, 1.0, -1.0, np.nextafter(one, two),
                  np.nextafter(-one, -two), np.nextafter(one, 0), 1e-30,
                  -1e-30, 2.0, -2.0, 0.5, -0.5], np.float32),
        (rng.standard_normal(200) * 1.5).astype(np.float32)])
    gout = rng.standard_normal(x.shape).astype(np.float32)
    want_y = np.asarray(jbin.ste_sign(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(
        jbin.ste_sign(v) * jnp.asarray(gout)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tbin.ste_sign(xt)
    (y * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_array_equal(xt.grad.numpy(), want_g)
    assert y.dtype == torch.float32
    assert want_g[2] == gout[2] and want_g[4] == 0.0        # 1.0 in, 1+ out


# ---------------------------------------------------------------------------
# forward_train
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_forward_train_logits_stats_and_gradients(name):
    """Logits exact, BN statistics rtol 1e-5, the hinge loss's gradient
    for every leaf within the per-leaf tolerance, every weight gradient
    nonzero."""
    jprog, tprog = (mk() for mk in PROGRAMS[name])
    npp = _np_params(jprog, seed=1)
    images, labels = _batch(jprog, 8, seed=2)

    def jloss(p):
        logits, new_p = jinterp.forward_train(p, jprog, jnp.asarray(images))
        return _jax_loss(logits, jnp.asarray(labels)), (logits, new_p)

    (jl, (jlogits, jnew)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, npp))

    def tloss(p):
        logits, new_p = tinterp.forward_train(p, tprog,
                                              torch.from_numpy(images))
        return tquick.hinge_loss(logits, torch.from_numpy(labels).long()), (
            logits, new_p)

    (tl, (tlogits, tnew)), tgrads = topt.value_and_grad(
        tloss, convert.params_from_numpy(npp, device="cpu"))
    np.testing.assert_array_equal(tlogits.detach().numpy(),
                                  np.asarray(jlogits))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    _assert_bn_stats(tnew, jnew, npp, jprog, images)
    _assert_close_per_leaf(convert.params_to_numpy(tgrads), _np(jgrads))
    for part in ("conv", "fc"):
        for g in tgrads[part]:
            assert float(g["w"].abs().max()) > 0.0


def _small_program(pkg, s):
    """tests/test_chip_interpreter.py's reduced cifar9-family program."""
    f = pkg.ARRAY_CHANNELS // s
    return pkg.Program(s=s, instrs=(
        pkg.IOInstr(height=8, width=8, in_channels=3, bits=7, channels=f),
        pkg.ConvInstr(height=8, width=8, features=f, maxpool=True),
        pkg.ConvInstr(height=3, width=3, features=f),
        pkg.FCInstr(in_features=2 * 2 * f, out_features=10, final=True)))


@pytest.mark.parametrize("s", [1, 2, 4])
def test_eval_forward_equals_folded_inference(s):
    """sign(BN(conv)) on the running statistics == the integer-threshold
    comparator path, and train=False hands the conv params back as they
    are."""
    prog = _small_program(tisa, s)
    gen = torch.Generator().manual_seed(2 + s)
    params = tinterp.init_params(gen, prog, device="cpu")
    warm = torch.randint(0, 128, (4, 8, 8, 3), generator=gen)
    _, params = tinterp.forward_train(params, prog, warm)
    imgs = torch.randint(0, 128, (3, 8, 8, 3), generator=gen)
    logits_train, new = tinterp.forward_train(params, prog, imgs, train=False)
    assert all(a is b for a, b in zip(new["conv"], params["conv"]))
    folded = tinterp.fold_params(params, prog)
    logits_inf, labels = tinterp.forward_infer(folded, prog, imgs,
                                               device="cpu")
    assert torch.equal(logits_train, logits_inf) and labels.shape == (3,)
    kl, ky = tinterp.make_infer_fn(prog, use_kernels=True, device="cpu")(
        folded, imgs)
    assert torch.equal(kl, logits_inf) and torch.equal(ky, labels)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

def test_cosine_schedule_equals_repro():
    jlr, tlr = (m.cosine_schedule(2e-3, 20, 300) for m in (jopt, topt))
    for step in (0, 19, 20, 25, 160, 300, 400):
        np.testing.assert_allclose(float(tlr(step)),
                                   float(jlr(jnp.asarray(step))), rtol=1e-6)
        assert tlr(step).dtype == torch.float32


@pytest.mark.parametrize("name,kw", [("adamw", {}),
                                     ("sgdm", {}),
                                     ("sgdm", {"clip_norm": 0.5})])
def test_optimizer_updates_equal_repro(name, kw):
    """The same numpy grads and state through three updates at steps 0, 1
    and 25 (warmup, then cosine); the BN statistics have zero gradient,
    so adamw's decoupled decay is all that moves them."""
    jprog = jnets.mnist5()
    npp = _np_params(jprog, seed=3)
    rng = np.random.default_rng(4)

    def grads_np():
        return {"conv": [{k: (rng.standard_normal(v.shape) * 0.01
                              if k in ("w", "gamma", "beta")
                              else np.zeros(v.shape)).astype(np.float32)
                          for k, v in p.items()} for p in npp["conv"]],
                "fc": [{"w": rng.standard_normal(p["w"].shape)
                        .astype(np.float32)} for p in npp["fc"]]}

    jo = jopt.make(name, jopt.cosine_schedule(2e-3, 20, 300), **kw)
    to = topt.make(name, topt.cosine_schedule(2e-3, 20, 300), **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    js = jo.init(jp)
    tp = convert.params_from_numpy(npp, device="cpu")
    ts = convert.opt_state_from_numpy(_np(js), device="cpu")
    for step in (0, 1, 25):
        g = grads_np()
        jp, js, jgn = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js,
                                jp, jnp.asarray(step))
        tp, ts, tgn = to.update(convert.opt_state_from_numpy(g, device="cpu"), ts,
                                tp, step)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
        for got, want in ((tp, jp), (ts, js)):
            got, want = _leaves(convert.params_to_numpy(got)), _leaves(_np(want))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_allclose(
                    a, b, rtol=1e-6,
                    atol=1e-6 * float(np.abs(b).max(initial=0.0)))


def test_none_gradients_count_as_zeros_and_adafactor_is_not_ported():
    p = {"a": torch.ones(3), "b": torch.full((2,), 2.0)}
    o = topt.adamw(topt.cosine_schedule(1e-2, 1, 10))
    new, _, gn = o.update({"a": None, "b": torch.ones(2)}, o.init(p), p, 0)
    zero, _, _ = o.update({"a": torch.zeros(3), "b": torch.ones(2)},
                          o.init(p), p, 0)
    assert float(gn) == pytest.approx(2 ** 0.5)
    assert all(torch.equal(new[k], zero[k]) for k in p)
    assert float(new["a"][0]) < 1.0                  # decayed, no gradient
    with pytest.raises(NotImplementedError, match="1.11"):
        topt.make("adafactor", topt.cosine_schedule(1e-2, 1, 10))


# ---------------------------------------------------------------------------
# One whole step, then folding
# ---------------------------------------------------------------------------

def _step_bounds(want, got, jgrads, lr):
    """Hold the latents after one adamw step to ``step_tolerance`` (the
    per-leaf tolerance, widened by 2 lr where the JAX gradient is itself
    at rounding level) and the BN statistics as in
    :func:`_assert_bn_stats`.  Returns each leaf's per-element bound,
    keyed (part, layer, name)."""
    tree = topt.step_tolerance(want, jgrads, lr)
    bounds = {}
    for part in ("conv", "fc"):
        for i, (wp, gp) in enumerate(zip(want[part], got[part])):
            for k in ("w", "gamma", "beta") if part == "conv" else ("w",):
                bound = tree[part][i][k]
                assert (np.abs(gp[k] - wp[k]) <= bound).all(), (part, i, k)
                bounds[part, i, k] = bound
            if part == "conv":
                np.testing.assert_allclose(gp["mean"], wp["mean"], rtol=1e-5)
                np.testing.assert_allclose(gp["var"], wp["var"], rtol=3e-5)
    return bounds


def _near_boundary(want, bounds):
    """Masks of the folded entries that the bounded differences can flip:
    latents within their bound of 0; thresholds whose distance to an
    integer (where the ceil flips) is within what the differences in
    mean, std, beta and gamma can move ``mean - beta * std / gamma``, or
    whose gamma is within its bound of 0 (the comparator direction)."""
    conv_w, conv_t, fc_w = [], [], []
    for i, p in enumerate(want["conv"]):
        conv_w.append(np.abs(p["w"]) <= bounds["conv", i, "w"])
        mean, beta = (p[k].astype(np.float64) for k in ("mean", "beta"))
        gamma = p["gamma"].astype(np.float64)
        std = np.sqrt(p["var"].astype(np.float64) + 1e-4)
        b_beta, b_gamma = bounds["conv", i, "beta"], bounds["conv", i, "gamma"]
        tau = mean - beta * std / gamma
        moved = (1e-5 * np.abs(mean) + std / np.abs(gamma) * b_beta
                 + np.abs(beta) * std / np.abs(gamma)
                 * (1.5e-5 + b_gamma / np.abs(gamma)))
        conv_t.append((np.abs(tau - np.round(tau)) <= moved)
                      | (np.abs(gamma) <= b_gamma))
    for i, p in enumerate(want["fc"]):
        fc_w.append(np.abs(p["w"]) <= bounds["fc", i, "w"])
    return conv_w, conv_t, fc_w


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_one_training_step_then_fold_equals_repro(name):
    """forward, backward and adamw from shared params and a carried JAX
    optimizer state: latents and BN statistics within the bounds of
    :func:`_step_bounds`; the packed artifacts folded from them equal
    repro's but at entries counted as near a fold boundary."""
    jprog, tprog = (mk() for mk in PROGRAMS[name])
    npp = _np_params(jprog, seed=5)
    images, labels = _batch(jprog, 8, seed=6)
    sched = (2e-3, 20, 300)
    jo = jopt.make("adamw", jopt.cosine_schedule(*sched))
    to = topt.make("adamw", topt.cosine_schedule(*sched))
    jp = jax.tree_util.tree_map(jnp.asarray, npp)

    def jloss(p):
        logits, new_p = jinterp.forward_train(p, jprog, jnp.asarray(images))
        return _jax_loss(logits, jnp.asarray(labels)), new_p

    (_, jnew), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    jp2, _, _ = jo.update(jg, jo.init(jp), jnew, jnp.asarray(3))
    tp2, ts2, _ = tquick.train_step(
        convert.params_from_numpy(npp, device="cpu"),
        convert.opt_state_from_numpy(_np(jo.init(jp)), device="cpu"), 3,
        torch.from_numpy(images), torch.from_numpy(labels).long(),
        prog=tprog, optimizer=to, loss_fn=tquick.hinge_loss)
    assert not any(t.requires_grad for t in topt.tree_leaves(tp2))
    assert not any(t.requires_grad for t in topt.tree_leaves(ts2))
    want = _np(jp2)
    lr = float(jopt.cosine_schedule(*sched)(jnp.asarray(3)))
    bounds = _step_bounds(want, convert.params_to_numpy(tp2), _np(jg), lr)

    # folding: bit-exact but at the counted near-boundary entries
    conv_w, conv_t, fc_w = _near_boundary(want, bounds)
    jfold = _np(jinterp.fold_params(jp2, jprog))
    jpack = _np(jinterp.fold_params(jp2, jprog, packed=True))
    tfold = tinterp.fold_params(tp2, tprog)
    tpack = tinterp.fold_params(tp2, tprog, packed=True)
    flipped = 0
    for i, (jf, tf) in enumerate(zip(jfold["conv"], tfold["conv"])):
        jt, tt = jpack["conv"][i], tpack["conv"][i]
        diff_w = jf["w"] != tf["w"].numpy()
        diff_t = ((jt["tau"] != tt["tau"].numpy())
                  | (jt["flip"] != tt["flip"].numpy()))
        assert not (diff_w & ~conv_w[i]).any()
        assert not (diff_t & ~conv_t[i]).any()
        flipped += int(diff_w.sum() + diff_t.sum())
        if not diff_w.any():
            np.testing.assert_array_equal(
                tt["w_words"].numpy().view(np.uint32), jt["w_words"])
    for i, (jf, tf) in enumerate(zip(jfold["fc"], tfold["fc"])):
        diff_w = jf["w"] != tf["w"].numpy()
        assert not (diff_w & ~fc_w[i]).any()
        flipped += int(diff_w.sum())
        if not diff_w.any():
            np.testing.assert_array_equal(
                tpack["fc"][i]["w_words"].numpy().view(np.uint32),
                jpack["fc"][i]["w_words"])
    near = sum(int(m.sum()) for m in conv_w + conv_t + fc_w)
    assert flipped <= near


# ---------------------------------------------------------------------------
# Synthetic data and the example twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("classes,h,w", [(10, 16, 16), (1, 32, 32),
                                         (10, 32, 32)])
def test_template_formula_equals_repro_given_the_same_freqs(classes, h, w):
    """The int cast after float32 sin/cos may land one level apart: at
    least 99.9% of pixels equal, none off by more than 1."""
    key = jax.random.PRNGKey(classes + h)
    freqs = np.array(jax.random.normal(key, (classes, 4, 3)))
    want = np.asarray(jimg.class_templates(key, classes, h, w, 3, 128))
    got = timg.templates_from_freqs(torch.from_numpy(freqs), h, w, 128)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    diff = np.abs(got.numpy().astype(np.int64) - want)
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999


def test_batch_for_step_is_deterministic_and_in_range():
    a, la = timg.batch_for_step(3, batch=16, num_classes=10, device="cpu")
    b, lb = timg.batch_for_step(3, batch=16, num_classes=10, device="cpu")
    c, _ = timg.batch_for_step(4, batch=16, num_classes=10, device="cpu")
    assert torch.equal(a, b) and torch.equal(la, lb) and not torch.equal(a, c)
    assert a.dtype == torch.int32 and tuple(a.shape) == (16, 32, 32, 3)
    assert int(a.min()) >= 0 and int(a.max()) <= 127


def test_quickstart_twin_runs_on_the_cpu(capsys):
    acc = tquick.main(["--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert 0.0 <= acc <= 1.0 and "deployed accuracy" in out
    assert "S=4:" in out


def test_detector_twin_runs_and_bills_exactly(capsys):
    hits, stats = tdet.main(["--device", "cpu", "--steps", "2",
                             "--frames", "1"])
    out = capsys.readouterr().out
    assert "frame-level agreement:" in out and hits in (0, 1)
    assert stats.total_served == len(tdet.window_coords()) == 54
    assert stats.billed == stats.total_served + sum(stats.padded.values())
    assert stats.dispatches == 1


def test_training_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        timg.batch_for_step(0, batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdet.train_detector(tnets.face_detector(), steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tquick.main(["--steps", "1"])
