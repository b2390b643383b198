"""The port's chip-tier interpreter vs ``repro``'s, for every REGISTRY
program.

The oracle is ``repro``'s float reference ``forward_infer(use_kernels=
False)`` (``repro``'s own tests prove its staged, megakernel and float
paths equal).  The port's float reference, staged plan and megakernel run
on the CPU (the plain versions of the kernels), fed both from parameters
carried by ``params_from_numpy`` and from ``repro``'s folded, packed and
weight-image artifacts carried by ``artifact_from_numpy``.  Logits and
labels must agree bit for bit (tolerance 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.chip import interpreter as jinterp, isa as jisa
from repro.core.chip import networks as jnets
from repro_torch import convert
from repro_torch.core.chip import interpreter as tinterp, isa as tisa
from repro_torch.core.chip import networks as tnets


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tests run tiny tensors: one intra-op thread per
    test process keeps parallel test workers from oversubscribing the
    cores (imported by the other test_torch_* modules)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_params(program, seed: int):
    """repro-layout latent params as numpy, with spread-out BN statistics
    so thresholds of both signs and both comparator directions occur."""
    rng = np.random.default_rng(seed)
    convs, fcs = [], []
    for (ins, _h, _w, c, *_rest) in jisa.layer_geometry(program):
        if isinstance(ins, jisa.ConvInstr):
            f = ins.features
            convs.append(dict(
                w=rng.standard_normal((f, 2, 2, c)).astype(np.float32),
                gamma=rng.standard_normal(f).astype(np.float32),
                beta=(rng.standard_normal(f) * 4).astype(np.float32),
                mean=(rng.standard_normal(f) * 16).astype(np.float32),
                var=rng.uniform(1.0, 100.0, f).astype(np.float32)))
        elif isinstance(ins, jisa.FCInstr):
            fcs.append(dict(w=rng.standard_normal(
                (ins.out_features, ins.in_features)).astype(np.float32)))
    return {"conv": convs, "fc": fcs}


def _frames(program, b, seed):
    io = program.instrs[0]
    return np.random.default_rng(seed).integers(
        0, 2 ** io.bits, (b, io.height, io.width, io.in_channels),
        dtype=np.int32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _oracle(program, npp, frames):
    folded = jinterp.fold_params(jax.tree_util.tree_map(jnp.asarray, npp),
                                 program)
    logits, labels = jinterp.make_infer_fn(program)(folded,
                                                    jnp.asarray(frames))
    return np.asarray(logits), np.asarray(labels)


def _check(got, want):
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("name", sorted(jnets.REGISTRY))
def test_registry_program_bit_exact(name):
    jprog, tprog = jnets.REGISTRY[name](), tnets.REGISTRY[name]()
    npp = np_params(jprog, seed=sorted(jnets.REGISTRY).index(name))
    frames = _frames(jprog, 2 if name == "mnist5" else 1, seed=1)
    want = _oracle(jprog, npp, frames)
    plan = tinterp.compile_plan(tprog)

    # repro's artifacts carried across, through every forward
    jparams = jax.tree_util.tree_map(jnp.asarray, npp)
    folded = convert.artifact_from_numpy(
        _np_tree(jinterp.fold_params(jparams, jprog)), device="cpu")
    packed = convert.artifact_from_numpy(
        _np_tree(jinterp.fold_params(jparams, jprog, packed=True)),
        device="cpu")
    image = convert.artifact_from_numpy(
        _np_tree(jinterp.fold_params(jparams, jprog, image=True)),
        device="cpu")
    _check(tinterp.forward_infer(folded, tprog, frames, device="cpu"), want)
    _check(plan.forward(packed, frames, device="cpu"), want)
    _check(plan.forward_mega(image, frames, device="cpu"), want)
    _assert_same_words(tinterp.ensure_image(packed, tprog), image)

    # parameters carried across fold to those same artifacts word for
    # word, so the packed plans above cover them too
    params = convert.params_from_numpy(npp, device="cpu")
    _check(tinterp.forward_infer(tinterp.fold_params(params, tprog), tprog,
                                 frames, device="cpu"), want)
    _assert_same_words(tinterp.fold_params(params, tprog, packed=True), packed)
    _assert_same_words(tinterp.fold_params(params, tprog, image=True), image)


def _assert_same_words(got, want):
    got_leaves = jax.tree_util.tree_leaves(got)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype == torch.int32
        assert torch.equal(g, w)


def test_packed_artifacts_are_bit_identical():
    """fold_params' packed and image forms equal repro's word for word."""
    jprog, tprog = jnets.mnist5(), tnets.mnist5()
    npp = np_params(jprog, seed=21)
    jparams = jax.tree_util.tree_map(jnp.asarray, npp)
    params = convert.params_from_numpy(npp, device="cpu")
    for kw in (dict(packed=True), dict(image=True)):
        want = jax.tree_util.tree_leaves(_np_tree(
            jinterp.fold_params(jparams, jprog, **kw)))
        got = jax.tree_util.tree_leaves(
            tinterp.fold_params(params, tprog, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy().view(w.dtype), w)


def test_tied_logits_take_the_first_maximum():
    """Binary logits tie often; argmax takes the first maximum in both
    packages.  Final-FC rows 2 and 6 are identical and every other row is
    their negation, so every frame ties between two (or eight) classes."""
    jprog, tprog = jnets.mnist5(), tnets.mnist5()
    npp = np_params(jprog, seed=22)
    w = npp["fc"][-1]["w"]
    w[:] = -w[2]
    w[2] = w[6] = -w[0]
    frames = _frames(jprog, 6, seed=23)
    want = _oracle(jprog, npp, frames)
    assert all(np.sum(row == row.max()) >= 2 for row in want[0])
    params = convert.params_from_numpy(npp, device="cpu")
    plan = tinterp.compile_plan(tprog)
    _check(plan.forward(tinterp.fold_params(params, tprog, packed=True),
                        frames, device="cpu"), want)
    _check(plan.forward_mega(tinterp.fold_params(params, tprog, image=True),
                             frames, device="cpu"), want)


def test_conv_less_program_uses_a_dummy_image_slot():
    """A program with no conv layer (IO straight into the FCs) gets a
    dummy conv slot in its weight image, as in repro, and still serves
    bit-exact through both plans."""
    jprog = jisa.Program(s=4, instrs=(
        jisa.IOInstr(height=4, width=4, in_channels=1, bits=4, channels=64),
        jisa.FCInstr(in_features=1024, out_features=10, final=True)))
    tprog = tisa.Program(s=4, instrs=(
        tisa.IOInstr(height=4, width=4, in_channels=1, bits=4,
                          channels=64),
        tisa.FCInstr(in_features=1024, out_features=10, final=True)))
    npp = np_params(jprog, seed=24)
    frames = _frames(jprog, 3, seed=25)
    want = _oracle(jprog, npp, frames)
    params = convert.params_from_numpy(npp, device="cpu")
    image = tinterp.fold_params(params, tprog, image=True)
    assert tuple(image["cw"].shape) == (1, 64, 4, 2)
    plan = tinterp.compile_plan(tprog)
    _check(plan.forward_mega(image, frames, device="cpu"), want)
    _check(plan.forward(tinterp.fold_params(params, tprog, packed=True),
                        frames, device="cpu"), want)


def test_forward_train_bn_statistics():
    """The BN-warming forward: running means and variances agree with
    repro's to float32 rounding (rtol 1e-5: XLA and PyTorch reduce, scale
    and sum the squared deviations in other orders).  Bit-exact training
    parity is not claimed; the deployment artifacts are what must match."""
    jprog, tprog = jnets.mnist5(), tnets.mnist5()
    npp = np_params(jprog, seed=26)
    frames = _frames(jprog, 4, seed=27)
    _, jnew = jinterp.forward_train(jax.tree_util.tree_map(jnp.asarray, npp),
                                    jprog, jnp.asarray(frames))
    _, tnew = tinterp.forward_train(convert.params_from_numpy(npp,
                                                              device="cpu"),
                                    tprog, torch.from_numpy(frames))
    for jp, tp in zip(jnew["conv"], tnew["conv"]):
        np.testing.assert_allclose(tp["mean"].numpy(), np.asarray(jp["mean"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tp["var"].numpy(), np.asarray(jp["var"]),
                                   rtol=1e-5)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    """device=None means the GPU, and there is no silent fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prog = tnets.mnist5()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinterp.init_params(torch.Generator(), prog)
    params = tinterp.init_params(torch.Generator(), prog, device="cpu")
    packed = tinterp.fold_params(params, prog, packed=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinterp.compile_plan(prog).forward(packed, _frames(prog, 1, 0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy(np_params(jnets.mnist5(), 0))
