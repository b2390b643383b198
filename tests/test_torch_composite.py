"""The port's shared-array composites vs ``repro``'s.

On every exact REGISTRY tiling, with ragged member batches, each member's
port logits and labels equal ``repro``'s float reference of that member;
on an mnist5-based 4 x S=4 composite the port equals ``repro``'s
composite kernel in Pallas interpret mode; the composite image is
bit-identical to ``repro``'s; and ``ChipServer(shared=True)`` serves the
same labels and ledger as ``repro``'s on one seeded trace.  The port runs
on the CPU (the plain versions of the kernels); tolerance 0 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.chip import interpreter as jinterp, isa as jisa
from repro.core.chip import networks as jnets
from repro.serving import ChipServer as JaxChipServer
from repro.serving import plan_shared_groups as jax_plan_shared_groups
from repro_torch import convert
from repro_torch.core.chip import interpreter as tinterp, isa as tisa
from repro_torch.core.chip import networks as tnets
from repro_torch.kernels import megakernel as mk, ops
from repro_torch.launch import chip_serve
from repro_torch.serving import ChipServer, plan_shared_groups
from tests.test_torch_interpreter import (_np_tree, _oracle,  # noqa: F401
                                          np_params, one_torch_thread)

# every exact tiling of the 256-channel array by REGISTRY programs
TILINGS = (("cifar9_s4", "cifar9_s4t", "mnist5", "face_detector"),
           ("cifar9_s2", "face_angles"),
           ("cifar9_s2", "mnist5", "face_detector"))
RAGGED = (3, 2, 1, 2)


def _frames(program, b, seed):
    io = program.instrs[0]
    return np.random.default_rng(seed).integers(
        0, 2 ** io.bits, (b, io.height, io.width, io.in_channels),
        dtype=np.int32)


def _packed(jprog, npp):
    return _np_tree(jinterp.fold_params(
        jax.tree_util.tree_map(jnp.asarray, npp), jprog, packed=True))


def _mnist_quad():
    """Four mnist5 variants (S=4 each, distinct class counts): an
    mnist5-based 4 x S=4 composite."""
    return {f"m{c}": c for c in (10, 7, 5, 2)}


@pytest.mark.parametrize("names", TILINGS, ids="+".join)
def test_registry_tiling_matches_repro_float_reference(names):
    """Each member of the composite, on its own ragged batch, equals
    repro's float reference of that member: logits and labels."""
    npps = {n: np_params(jnets.REGISTRY[n](), seed=40 + i)
            for i, n in enumerate(names)}
    frames = {n: _frames(jnets.REGISTRY[n](), b, 50 + i)
              for i, (n, b) in enumerate(zip(names, RAGGED))}
    arts = {n: convert.artifact_from_numpy(
        _packed(jnets.REGISTRY[n](), npps[n]), device="cpu") for n in names}
    cplan, cimage = tinterp.pack_programs(
        {n: tnets.REGISTRY[n]() for n in names}, arts)
    logits, labels = cplan.forward(cimage, frames, device="cpu")
    for i, n in enumerate(names):
        want_l, want_y = _oracle(jnets.REGISTRY[n](), npps[n], frames[n])
        np.testing.assert_array_equal(logits[i].numpy(), want_l)
        np.testing.assert_array_equal(labels[i].numpy(), want_y)


def test_pack_programs_image_and_spec_match_repro():
    """The composite image is bit-identical to repro's (uint32 words as
    int32) and the member specs carry the same offsets, for every
    tiling."""
    for names in TILINGS:
        npps = {n: np_params(jnets.REGISTRY[n](), seed=60 + i)
                for i, n in enumerate(names)}
        jarts = {n: _packed(jnets.REGISTRY[n](), npps[n]) for n in names}
        jplan, jimage = jinterp.pack_programs(
            {n: jnets.REGISTRY[n]() for n in names},
            jax.tree_util.tree_map(jnp.asarray, jarts))
        tplan, timage = tinterp.pack_programs(
            {n: tnets.REGISTRY[n]() for n in names},
            {n: convert.artifact_from_numpy(a, device="cpu")
             for n, a in jarts.items()})
        assert tplan.spec == jplan.spec and tplan.names == jplan.names
        assert tplan.n_groups == jplan.n_groups
        for k in ("cw", "ct", "cf", "fw"):
            want = np.asarray(jimage[k])
            np.testing.assert_array_equal(timage[k].numpy(),
                                          want.view(np.int32))


def test_mnist5_quad_matches_repro_interpret_mode():
    """The composite of four mnist5 variants on ragged batches vs repro's
    composite kernel in Pallas interpret mode (bb=2)."""
    quad = _mnist_quad()
    jprogs = {n: jnets.mnist5(classes=c) for n, c in quad.items()}
    jarts = {n: _packed(p, np_params(p, seed=70 + i))
             for i, (n, p) in enumerate(jprogs.items())}
    frames = {n: _frames(p, b, 80 + i)
              for i, ((n, p), b) in enumerate(zip(jprogs.items(), RAGGED))}
    jplan, jimage = jinterp.pack_programs(
        jprogs, jax.tree_util.tree_map(jnp.asarray, jarts))
    want_l, want_y = jplan.forward(
        jimage, {n: jnp.asarray(f) for n, f in frames.items()},
        interpret=True, bb=2)
    tplan, timage = tinterp.pack_programs(
        {n: tnets.mnist5(classes=c) for n, c in quad.items()},
        {n: convert.artifact_from_numpy(a, device="cpu")
         for n, a in jarts.items()})
    raw = ops.composite_forward(
        timage, [torch.from_numpy(frames[n]) for n in tplan.names],
        spec=tplan.spec)
    got_l, got_y = tplan.forward(timage, frames, device="cpu")
    for i in range(len(quad)):
        assert raw[i].dtype == torch.int32
        np.testing.assert_array_equal(raw[i].numpy(), np.asarray(want_l[i]))
        np.testing.assert_array_equal(got_l[i].numpy(), np.asarray(want_l[i]))
        np.testing.assert_array_equal(got_y[i].numpy(), np.asarray(want_y[i]))


def test_exact_tiling_gate_and_argument_checks():
    progs = {"mnist5": tnets.mnist5(), "cifar9_s2": tnets.cifar9(2)}
    arts = {n: chip_serve.build_artifact(p, seed=0, warm_bn=False,
                                         device="cpu")
            for n, p in progs.items()}
    with pytest.raises(tisa.ProgramError, match="tile the array"):
        tinterp.pack_programs(progs, arts)
    with pytest.raises(jisa.ProgramError, match="tile the array"):
        jinterp.pack_programs(
            {"mnist5": jnets.mnist5(), "cifar9_s2": jnets.cifar9(2)},
            {n: jinterp.fold_params(jinterp.init_params(
                jax.random.PRNGKey(0), p), p, packed=True)
             for n, p in (("mnist5", jnets.mnist5()),
                          ("cifar9_s2", jnets.cifar9(2)))})
    cplan, cimage = tinterp.pack_programs(progs, arts, exact_tiling=False)
    assert cimage["cw"].shape[1] == 64 + 128
    good = [torch.zeros((1, 14, 14, 1), dtype=torch.int32),
            torch.zeros((1, 32, 32, 3), dtype=torch.int32)]
    with pytest.raises(ValueError, match="frame batches"):
        ops.composite_forward(cimage, good[:1], spec=cplan.spec)
    with pytest.raises(ValueError, match="do not match the io stage"):
        ops.composite_forward(cimage, good[::-1], spec=cplan.spec)
    small = dict(cimage, fw=cimage["fw"][:, :5])
    with pytest.raises(ValueError, match="does not fit"):
        ops.composite_forward(small, good, spec=cplan.spec)
    with pytest.raises(ValueError, match="1 to 4 members"):
        mk.composite_table(cplan.spec * 3, tuple(cimage["cw"].shape),
                           tuple(cimage["fw"].shape))
    # no quiet CPU path in the kernel wrappers, and no launch counted
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        mk.composite_forward(cimage, good, spec=cplan.spec)
    assert set(ops.launch_counts().values()) == {0}


def test_plan_shared_groups_matches_repro():
    for names in (tuple(jnets.REGISTRY),
                  ("mnist5", "cifar9_s2", "face_detector", "cifar9_s1",
                   "face_angles"),
                  ("cifar9_s4", "mnist5", "face_detector"),
                  TILINGS[0] + ("cifar9_s2", "face_angles")):
        want = jax_plan_shared_groups({n: jnets.REGISTRY[n]() for n in names})
        assert plan_shared_groups(
            {n: tnets.REGISTRY[n]() for n in names}) == want


@pytest.fixture(scope="module")
def shared_trace():
    """Five mnist5 lanes (four tile the array, one serves solo), a seeded
    ragged trace, and repro's shared server's labels and ledger."""
    lanes = dict(_mnist_quad(), m3=3)
    jprogs = {n: jnets.mnist5(classes=c) for n, c in lanes.items()}
    jarts = {n: _packed(p, np_params(p, seed=90 + i))
             for i, (n, p) in enumerate(jprogs.items())}
    trace = [(n, f) for i, (n, p) in enumerate(jprogs.items())
             for f in _frames(p, 7 - i, 100 + i)]
    order = np.random.default_rng(110).permutation(len(trace))
    trace = [trace[i] for i in order]
    server = JaxChipServer(jprogs, jax.tree_util.tree_map(jnp.asarray, jarts),
                           batch=4, shared=True, interpret=True)
    for n, f in trace:
        server.submit(n, f)
    results = server.drain()
    st = server.stats()
    return (lanes, jarts, trace, {r.rid: r.label for r in results},
            server.shared_groups, st)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_shared_server_matches_repro(shared_trace, prefetch):
    lanes, jarts, trace, labels, groups, jst = shared_trace
    server = ChipServer({n: tnets.mnist5(classes=c) for n, c in lanes.items()},
                        {n: convert.artifact_from_numpy(a, device="cpu")
                         for n, a in jarts.items()},
                        batch=4, megakernel=True, prefetch=prefetch,
                        device="cpu", shared=True)
    assert server.shared_groups == groups and len(groups) == 1
    assert server.executor.compiled_composites == groups
    rids = [server.submit(n, f) for n, f in trace]
    results = server.drain()
    server.close()
    assert sorted(r.rid for r in results) == rids      # each exactly once
    assert {r.rid: r.label for r in results} == labels
    st = server.stats()
    assert st.served == jst.served and st.padded == jst.padded
    assert st.dispatches == jst.dispatches
    assert st.shared_dispatches == jst.shared_dispatches > 0
    assert st.array_utilization == pytest.approx(jst.array_utilization)
    assert st.billed == st.total_served + sum(st.padded.values())


def test_shared_driver_on_the_cpu(capsys):
    results, stats = chip_serve.main(
        ["--programs", "mnist5,face_detector,cifar9_s4t,cifar9_s4",
         "--requests", "8", "--batch", "2", "--shared", "--device", "cpu"])
    assert len(results) == 8 and stats.shared_dispatches == 1
    out = capsys.readouterr().out
    assert ("shared-array groups: mnist5+face_detector+cifar9_s4t+cifar9_s4"
            in out)
    assert "array utilization   : 1.00" in out


def test_shared_server_needs_a_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prog = tnets.mnist5()
    art = chip_serve.build_artifact(prog, seed=0, warm_bn=False,
                                    device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChipServer({"mnist5": prog}, {"mnist5": art}, shared=True)
