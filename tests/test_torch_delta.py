"""The port's delta-gated megakernel vs ``repro``'s.

From the same numpy inputs, all seven outputs of the port's
``DeltaPlan.forward_delta`` (on the CPU, so through ``delta_plain``) equal
``repro``'s in Pallas interpret mode — merged logits and labels, the
advanced last-frame words, the next cached logits, the change queue,
``counts`` (with the billed drain slots) and the per-lane deltas — on
mnist5 and on a small random program, at every threshold, drain schedule
and ragged batch, over a stateful sequence, and in the case where
``repro``'s drain recomputes lane 0 although lane 0 did not change.
Tolerance 0 throughout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as jbin
from repro.core.chip import interpreter as jinterp, isa as jisa
from repro.core.chip import networks as jnets
from repro_torch import convert
from repro_torch.core.chip import interpreter as tinterp, isa as tisa
from repro_torch.core.chip import networks as tnets
from repro_torch.kernels import megakernel as mk, ops
from tests.test_fold_pack_property import random_program
from tests.test_torch_interpreter import (_np_tree,  # noqa: F401
                                          np_params, one_torch_thread)

# both sentinels, zero (= the plain megakernel), a fractional value (the
# ceil in delta_ctrl) and interior thresholds: repro's own sweep
THRESHOLDS = (float("-inf"), 0.0, 1.0, 2.5, 64.0, float("inf"))
SCHEDULES = ((2, 2), (5, 1), (3, 4))           # (bb, rb)


def _frames(program, n, seed):
    io = program.instrs[0]
    return np.random.default_rng(seed).integers(
        0, 2 ** io.bits, (n, io.height, io.width, io.in_channels),
        dtype=np.int32)


def _port_program(program):
    """The same ISA program in the port's own isa module."""
    return tisa.Program(s=program.s, instrs=tuple(
        getattr(tisa, type(ins).__name__)(**dataclasses.asdict(ins))
        for ins in program.instrs))


def _pack(program, frames):
    io = program.instrs[0]
    return np.asarray(jbin.thermometer_pack(
        jnp.asarray(frames, jnp.int32), io.bits, io.in_channels,
        io.channels))


def _setup(jprog, tprog, seed):
    """Both packages' DeltaPlan + image from one numpy parameter set, five
    frames and a warm state whose deltas spread (lanes 0 and 4 unchanged,
    lane 1 one pixel off, lane 3 a 3x3 patch off, lane 2 another frame)
    under random cached logits, so interior thresholds split the batch
    and lane 0 skips."""
    art = _np_tree(jinterp.fold_params(
        jax.tree_util.tree_map(jnp.asarray, np_params(jprog, seed)), jprog,
        packed=True))
    jplan, jimage = jinterp.pack_delta(
        jprog, jax.tree_util.tree_map(jnp.asarray, art), name="p")
    tplan, timage = tinterp.pack_delta(
        tprog, convert.artifact_from_numpy(art, device="cpu"), name="p")
    frames = _frames(jprog, 5, seed + 1)
    prev = frames.copy()
    levels = 2 ** jprog.instrs[0].bits
    prev[1, 0, 0] = (prev[1, 0, 0] + levels // 2) % levels
    prev[2] = _frames(jprog, 1, seed + 2)[0]
    prev[3, :3, :3] = (prev[3, :3, :3] + levels // 2) % levels
    last = _pack(jprog, prev)
    llog = np.random.default_rng(seed + 3).integers(
        -50, 50, (5, jplan.classes), dtype=np.int32)
    return jplan, jimage, tplan, timage, frames, last, llog


@pytest.fixture(scope="module")
def mnist():
    return _setup(jnets.mnist5(), tnets.mnist5(), 40)


@pytest.fixture(scope="module")
def small_random():
    prog = random_program(4, 7)
    return _setup(prog, _port_program(prog), 50)


def _both(setup, frames, last, llog, thr, n_real, bb, rb, ce):
    """repro's forward_delta (interpret mode) and the port's on the CPU,
    from the same numpy inputs; asserts the seven outputs equal and
    returns them as numpy (state as repro's uint32 / int32)."""
    jplan, jimage, tplan, timage = setup[:4]
    want = [np.asarray(x) for x in jplan.forward_delta(
        jimage, jnp.asarray(frames), jnp.asarray(last), jnp.asarray(llog),
        jplan.delta_ctrl(thr, n_real), interpret=True, bb=bb, rb=rb,
        check_every=ce)]
    tlast, tllog = convert.state_from_numpy(last, llog, device="cpu")
    got = tplan.forward_delta(timage, frames, tlast, tllog,
                              tplan.delta_ctrl(thr, n_real), device="cpu",
                              bb=bb, rb=rb, check_every=ce)
    new_last, new_llog = convert.state_to_numpy(got[2], got[3])
    got = [got[0].numpy(), got[1].numpy(), new_last, new_llog,
           *(x.numpy() for x in got[4:])]
    for name, g, w in zip(("logits", "labels", "new_last", "new_llog",
                           "queue", "counts", "deltas"), got, want):
        assert g.dtype == w.dtype or name == "labels", name
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got


@pytest.mark.parametrize("check_every", [1, 2])
@pytest.mark.parametrize("schedule", SCHEDULES,
                         ids=lambda s: "bb%d-rb%d" % s)
@pytest.mark.parametrize("which", ["mnist5", "random"])
def test_forward_delta_matches_repro_interpret_mode(mnist, small_random,
                                                    which, schedule,
                                                    check_every):
    setup = mnist if which == "mnist5" else small_random
    frames, last, llog = setup[4:]
    changed = [int(_both(setup, frames, last, llog, thr, len(frames),
                         *schedule, check_every)[5][0])
               for thr in THRESHOLDS]
    assert changed[0] == changed[1] == len(frames) and changed[-1] == 0
    assert 0 < changed[2] < len(frames)
    assert len(set(changed)) >= 4          # the thresholds split the batch


def test_padding_lanes_stay_out_and_keep_their_state(mnist):
    """Lanes at or past n_real never enter the queue even at -inf; their
    delta reads 0 and their last words and cached logits pass through."""
    frames, last, llog = mnist[4:]
    for thr in (float("-inf"), 1.0):
        got = _both(mnist, frames, last, llog, thr, 3, 2, 2, 1)
        assert got[5][0] <= 3 and not got[6][3:].any()
        np.testing.assert_array_equal(got[2][3:], last[3:])
        np.testing.assert_array_equal(got[3][3:], llog[3:])
        if thr == float("-inf"):
            assert got[4].tolist() == [0, 1, 2, 0, 0] and got[5][0] == 3


def test_drain_recomputes_lane_zero_like_repro(mnist):
    """Only lane 1 changes, bb = 4, rb = 2: repro's drain covers queue rows
    0-1, and row 1 (past K = 1) holds index 0, so lane 0 is recomputed
    over its cached logits although it did not change; its last words do
    not advance.  The port reproduces this bit for bit."""
    jplan, jimage, tplan, timage, frames, _, _ = mnist
    frames = frames[:4]
    prev = frames.copy()
    prev[1] = (prev[1] + 1) % 2 ** jnets.mnist5().instrs[0].bits
    last = _pack(jnets.mnist5(), prev)
    llog = np.full((4, jplan.classes), 777, np.int32)
    got = _both(mnist, frames, last, llog, 1.0, 4, 4, 2, 1)
    assert got[5].tolist() == [1, 2] and got[4].tolist() == [1, 0, 0, 0]
    fresh = tinterp.compile_plan(tnets.mnist5()).forward_mega(
        timage, frames, device="cpu")[0].numpy().astype(np.int32)
    np.testing.assert_array_equal(got[3][:2], fresh[:2])  # rows 0 and 1
    assert (got[3][2:] == 777).all()
    np.testing.assert_array_equal(got[2][0], last[0])     # lane 0 coasts
    # with rb = 1 the drain stops at row 0: lane 0 keeps its cache
    got = _both(mnist, frames, last, llog, 1.0, 4, 4, 1, 1)
    assert got[5].tolist() == [1, 1] and (got[3][0] == 777).all()


def test_three_step_stateful_sequence(mnist, small_random):
    """State carried through three dispatches (cold -inf, then a 2-bit
    gate with some frames repeated and some perturbed) stays equal to
    repro's at every step."""
    for setup in (mnist, small_random):
        jplan = setup[0]
        frames0 = setup[4]
        last = np.zeros((5,) + jplan.packed_words, np.uint32)
        llog = np.zeros((5, jplan.classes), np.int32)
        rng = np.random.default_rng(60)
        frames = frames0
        for step, thr in enumerate((float("-inf"), 2.0, 2.0)):
            got = _both(setup, frames, last, llog, thr, 5, 2, 2, 2)
            last, llog = got[2], got[3]
            if step == 0:
                assert got[5][0] == 5
            frames = frames.copy()
            frames[rng.random(5) < 0.5] += 1
            frames %= 2 ** jplan.plan.program.instrs[0].bits


def test_threshold_zero_equals_megakernel(small_random):
    """At threshold 0 every live lane recomputes: the merged logits are
    the plain megakernel's, and the state warms from the current frame."""
    _, _, tplan, timage, frames, last, llog = small_random
    tlast, tllog = convert.state_from_numpy(last, llog, device="cpu")
    lg, y, nl, nllog, queue, counts, _ = tplan.forward_delta(
        timage, frames, tlast, tllog, tplan.delta_ctrl(0.0, 5),
        device="cpu")
    ml, my = tplan.plan.forward_mega(timage, frames, device="cpu")
    assert torch.equal(lg, ml) and torch.equal(y, my)
    assert torch.equal(nllog, ml.to(torch.int32))
    assert queue.tolist() == list(range(5)) and counts[0] == 5


def test_delta_ctrl_matches_repro():
    for thr in THRESHOLDS + (-3.5, 0.5, 2.0 ** 40, -2.0 ** 40, 1e-9):
        np.testing.assert_array_equal(
            tinterp.DeltaPlan.delta_ctrl(thr, 7).numpy(),
            np.asarray(jinterp.DeltaPlan.delta_ctrl(thr, 7)))
    assert tinterp.DeltaPlan.delta_ctrl(2.5, 7).dtype == torch.int32
    with pytest.raises(ValueError, match="NaN"):
        tinterp.DeltaPlan.delta_ctrl(float("nan"), 7)


def test_delta_plan_shapes_and_guards_match_repro(mnist):
    jplan, _, tplan, timage, frames, last, llog = mnist
    assert tplan.classes == jplan.classes
    assert tplan.geometry == jplan.geometry
    assert tplan.packed_words == jplan.packed_words
    tl, tg = tplan.init_state(3, device="cpu")
    jl, jg = jplan.init_state(3)
    assert tl.dtype == torch.int32 and tuple(tl.shape) == jl.shape
    assert tuple(tg.shape) == jg.shape and not tl.any() and not tg.any()
    odd = jnets.mnist5()
    io = odd.instrs[0]
    odd = dataclasses.replace(odd, instrs=(dataclasses.replace(
        io, channels=48),) + odd.instrs[1:])
    with pytest.raises(jisa.ProgramError):
        jinterp.pack_delta(odd, None)
    with pytest.raises(tisa.ProgramError):
        tinterp.pack_delta(_port_program(odd), None)
    tlast, tllog = convert.state_from_numpy(last, llog, device="cpu")
    with pytest.raises(ValueError, match="n_real"):
        tplan.forward_delta(timage, frames, tlast, tllog,
                            tplan.delta_ctrl(0.0, 6), device="cpu")
    with pytest.raises(ValueError, match="last-frame"):
        tplan.forward_delta(timage, frames, tlast[:4], tllog,
                            tplan.delta_ctrl(0.0, 5), device="cpu")
    with pytest.raises(ValueError, match="last-logits"):
        tplan.forward_delta(timage, frames, tlast, tllog[:, :3],
                            tplan.delta_ctrl(0.0, 5), device="cpu")
    with pytest.raises(ValueError, match="uint32"):
        convert.state_from_numpy(last.view(np.int32), llog, device="cpu")
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        mk.delta_forward(timage, torch.from_numpy(frames), tlast, tllog,
                         tplan.delta_ctrl(0.0, 5), spec=tplan.spec)
    assert set(ops.launch_counts().values()) == {0}
