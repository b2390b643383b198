"""The port's fused detector -> recognizer cascade vs ``repro``'s.

On ``repro``'s own mnist5 det/rec pair, all six outputs of the port's
``forward_fused`` equal ``repro``'s in Pallas interpret mode, the whole
escalation queue and ``counts`` (with the billed drain slots) included, at
every margin and drain schedule; for the full-width face -> owner pair
the port equals ``repro``'s float references plus the host rule; and
``CascadePipeline``, fused and host-side, returns the same answers and
bill as ``repro``'s on one trace.  The port runs on the CPU (the plain
versions of the kernels); tolerance 0 throughout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.chip import interpreter as jinterp, isa as jisa
from repro.core.chip import networks as jnets
from repro.serving import CascadePipeline as JaxCascadePipeline
from repro.serving import ChipServer as JaxChipServer
from repro.serving import margins_of as jax_margins_of
from repro_torch import convert
from repro_torch.core.chip import interpreter as tinterp, isa as tisa
from repro_torch.core.chip import networks as tnets
from repro_torch.kernels import megakernel as mk, ops
from repro_torch.launch import chip_serve
from repro_torch.serving import (CascadePipeline, ChipServer,
                                 margin_for_recall, margins_of)
from tests.test_torch_interpreter import (_np_tree, _oracle,  # noqa: F401
                                          np_params, one_torch_thread)

# both extremes, a fractional value (the ceil in margin_ctrl), zero and
# interior thresholds: repro's own sweep
MARGINS = (float("-inf"), -3.5, 0.0, 1.0, 7.0, float("inf"))
SCHEDULES = ((3, 2, 2), (1, 1, 1), (4, 4, 3), (7, 3, 2))


def _frames(program, n, seed):
    io = program.instrs[0]
    return np.random.default_rng(seed).integers(
        0, 2 ** io.bits, (n, io.height, io.width, io.in_channels),
        dtype=np.int32)


@pytest.fixture(scope="module")
def pair():
    """repro's mnist5 det (2 classes) / rec (5 classes) pair, its packed
    artifacts from repro's own init_params, both packs, and 7 frames."""
    det, rec = jnets.mnist5(classes=2), jnets.mnist5(classes=5)
    jarts = {n: _np_tree(jinterp.fold_params(
        jinterp.init_params(jax.random.PRNGKey(seed), p), p, packed=True))
        for n, p, seed in (("det", det, 1), ("rec", rec, 2))}
    jplan, jimage = jinterp.pack_cascade(
        {"det": det, "rec": rec}, jax.tree_util.tree_map(jnp.asarray, jarts),
        detector="det", recognizer="rec")
    tarts = {n: convert.artifact_from_numpy(a, device="cpu")
             for n, a in jarts.items()}
    tplan, timage = tinterp.pack_cascade(
        {"det": tnets.mnist5(classes=2), "rec": tnets.mnist5(classes=5)},
        tarts, detector="det", recognizer="rec")
    return jarts, tarts, jplan, jimage, tplan, timage, _frames(det, 7, 3)


def _check_vs_repro(pair, frames, margin, n_real, bb, rb, ce):
    _, _, jplan, jimage, tplan, timage, _ = pair
    want = [np.asarray(x) for x in jplan.forward_fused(
        jimage, jnp.asarray(frames), jplan.margin_ctrl(margin, n_real),
        interpret=True, bb=bb, rb=rb, check_every=ce)]
    got = [x.numpy() for x in tplan.forward_fused(
        timage, frames, tplan.margin_ctrl(margin, n_real), device="cpu",
        bb=bb, rb=rb, check_every=ce)]
    e = int(want[5][0])
    for i in (0, 1, 4, 5):               # det logits/labels, queue, counts
        np.testing.assert_array_equal(got[i], want[i])
    for i in (2, 3):                     # rec rows past E are unspecified
        np.testing.assert_array_equal(got[i][:e], want[i][:e])
    assert not got[2][e:].any()          # ... and zero in the port
    assert int(got[5][1]) == mk.drain_slots(
        e, *mk.cascade_schedule(len(frames), bb, rb), ce)
    return e


@pytest.mark.parametrize("schedule", SCHEDULES,
                         ids=lambda s: "bb%d-rb%d-ce%d" % s)
def test_forward_fused_matches_repro_interpret_mode(pair, schedule):
    frames = pair[-1]
    escalated = [_check_vs_repro(pair, frames, m, len(frames), *schedule)
                 for m in MARGINS]
    assert escalated[0] == len(frames) and escalated[-1] == 0
    assert len(set(escalated)) > 2       # the margins split the batch


def test_padding_lanes_never_escalate(pair):
    """Lanes at or past n_real stay out of the queue even at -inf."""
    frames = pair[-1][:5]
    assert _check_vs_repro(pair, frames, float("-inf"), 5, 4, 2, 1) == 5
    assert _check_vs_repro(pair, frames, float("-inf"), 3, 4, 2, 1) == 3
    *_, tplan, timage, _ = pair
    *_, queue, counts = tplan.forward_fused(
        timage, frames, tplan.margin_ctrl(float("-inf"), 3), device="cpu")
    assert queue.tolist() == [0, 1, 2, 0, 0] and counts[0] == 3


def test_margin_ctrl_matches_repro():
    for margin in MARGINS + (0.5, -0.5, 2.0 ** 40, -2.0 ** 40, 1e-9):
        np.testing.assert_array_equal(
            tinterp.CascadePlan.margin_ctrl(margin, 5).numpy(),
            np.asarray(jinterp.CascadePlan.margin_ctrl(margin, 5)))
    assert tinterp.CascadePlan.margin_ctrl(0.0, 5).dtype == torch.int32
    with pytest.raises(ValueError, match="NaN"):
        tinterp.CascadePlan.margin_ctrl(float("nan"), 5)


def test_pack_cascade_guards_match_repro(pair):
    """Each malformed pair is refused by both packages, with the same
    exception type."""
    jarts, tarts = pair[0], pair[1]
    cases = (
        (dict(detector="det", recognizer="det"), "distinct"),
        (dict(detector="det", recognizer="nope"), "missing"),
        (dict(detector="det", recognizer="rec", positive_class=2),
         "out of range"),
    )
    jprogs = {"det": jnets.mnist5(classes=2), "rec": jnets.mnist5(classes=5)}
    tprogs = {"det": tnets.mnist5(classes=2), "rec": tnets.mnist5(classes=5)}
    for kw, match in cases:
        with pytest.raises((jisa.ProgramError, KeyError), match=match) as je:
            jinterp.pack_cascade(jprogs, jarts, **kw)
        with pytest.raises((tisa.ProgramError, KeyError), match=match) as te:
            tinterp.pack_cascade(tprogs, tarts, **kw)
        assert isinstance(je.value, KeyError) == isinstance(te.value,
                                                           KeyError)
    one = {"det": tnets.mnist5(classes=1), "rec": tprogs["rec"]}
    with pytest.raises(tisa.ProgramError, match=">= 2 classes"):
        tinterp.pack_cascade(one, tarts, detector="det", recognizer="rec")
    other = {"det": tprogs["det"], "rec": tnets.cifar9(4)}
    with pytest.raises(tisa.ProgramError, match="frame geometry"):
        tinterp.pack_cascade(other, tarts, detector="det", recognizer="rec")
    *_, tplan, timage, frames = pair
    with pytest.raises(ValueError, match="n_real"):
        tplan.forward_fused(timage, frames[:2], tplan.margin_ctrl(0.0, 3),
                            device="cpu")
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        mk.cascade_forward(timage, torch.from_numpy(frames),
                           tplan.margin_ctrl(0.0, 7), spec=tplan.spec)
    assert set(ops.launch_counts().values()) == {0}


def test_fused_cascade_needs_a_card_without_device(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    *_, tplan, timage, frames = pair
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplan.forward_fused(timage, frames, tplan.margin_ctrl(0.0, 7))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChipServer({"det": tnets.mnist5(classes=2),
                    "rec": tnets.mnist5(classes=5)}, pair[1])


def test_face_owner_full_width_matches_float_references():
    """face_detector (S=4) -> owner_detector (S=1) at full width: det
    logits equal repro's float reference, the queue equals the host rule
    on them, rec[:E] equals repro's float reference of the recognizer on
    the queued frames, and counts[1] is the drain formula."""
    det, rec = jnets.face_detector(), jnets.owner_detector()
    npp = {"face_detector": np_params(det, seed=120),
           "owner_detector": np_params(rec, seed=121)}
    frames = _frames(det, 4, 122)
    ref_det, _ = _oracle(det, npp["face_detector"], frames)
    ref_rec, _ = _oracle(rec, npp["owner_detector"], frames)
    arts = {n: convert.artifact_from_numpy(_np_tree(jinterp.fold_params(
        jax.tree_util.tree_map(jnp.asarray, p), prog, packed=True)),
        device="cpu")
        for (n, p), prog in zip(npp.items(), (det, rec))}
    tplan, timage = tinterp.pack_cascade(
        {"face_detector": tnets.face_detector(),
         "owner_detector": tnets.owner_detector()}, arts,
        detector="face_detector", recognizer="owner_detector")
    host = jax_margins_of(ref_det)
    for margin in (float(np.median(host)), float("inf")):
        d, dy, r, ry, queue, counts = tplan.forward_fused(
            timage, frames, tplan.margin_ctrl(margin, len(frames)),
            device="cpu", bb=2, rb=1, check_every=2)
        want_q = np.nonzero(host >= margin)[0]
        e = len(want_q)
        np.testing.assert_array_equal(d.numpy(), ref_det)
        np.testing.assert_array_equal(dy.numpy(), np.argmax(ref_det, 1))
        assert counts.tolist() == [e, mk.drain_slots(e, 4, 1, 2)]
        np.testing.assert_array_equal(queue.numpy()[:e], want_q)
        assert not queue.numpy()[e:].any()
        np.testing.assert_array_equal(r.numpy()[:e], ref_rec[want_q])
        np.testing.assert_array_equal(ry.numpy()[:e],
                                      np.argmax(ref_rec[want_q], 1))
    assert 0 < len(np.nonzero(host >= np.median(host))[0]) < len(frames)


def _results(results):
    return sorted((r.rid, r.label, r.escalated, r.detector_label,
                   r.detector_margin, tuple(np.asarray(r.logits).tolist()))
                  for r in results)


@pytest.fixture(scope="module")
def cascade_trace(pair):
    """11 frames through repro's host cascade (batch 4, margin 0)."""
    jarts = pair[0]
    frames = _frames(jnets.mnist5(), 11, 130)
    progs = {"det": jnets.mnist5(classes=2), "rec": jnets.mnist5(classes=5)}
    want = {}
    for fused in (False, True):
        server = JaxChipServer(progs,
                               jax.tree_util.tree_map(jnp.asarray, jarts),
                               batch=4, megakernel=True, interpret=True)
        casc = JaxCascadePipeline(server, "det", "rec", fused=fused)
        casc.submit_many(frames)
        results = casc.drain()
        st = server.stats()
        want[fused] = (_results(results), casc.report(), st.served,
                       st.padded, casc.escalated)
    return frames, want


@pytest.mark.parametrize("fused", [False, True])
def test_cascade_pipeline_matches_repro(pair, cascade_trace, fused):
    """Answers (label, escalation, detector label and margin, logits of
    the answering stage), the ledger and the energy report equal repro's
    in the same mode, and the two modes agree."""
    tarts = pair[1]
    frames, want = cascade_trace
    server = ChipServer({"det": tnets.mnist5(classes=2),
                         "rec": tnets.mnist5(classes=5)}, tarts, batch=4,
                        megakernel=True, device="cpu")
    casc = CascadePipeline(server, "det", "rec", fused=fused)
    rids = casc.submit_many(frames)
    results = casc.drain()
    got = _results(results)
    w_results, w_report, w_served, w_padded, w_esc = want[fused]
    assert [r[0] for r in got] == rids
    assert got == w_results
    assert [r[:3] for r in got] == [r[:3] for r in want[not fused][0]]
    st = server.stats()
    assert st.served == w_served and st.padded == w_padded
    assert st.billed == st.total_served + sum(st.padded.values())
    assert casc.escalated == w_esc > 0
    assert dataclasses.asdict(casc.report()) == dataclasses.asdict(w_report)
    assert casc.fused_dispatches == (3 if fused else 0)


def test_margin_calibration():
    m = np.array([3.0, -1.0, 5.0, 0.0, 2.0])
    y = np.array([True, False, True, True, False])
    assert margin_for_recall(m, y, 1.0) == 0.0
    assert margin_for_recall(m, y, 0.5) == 3.0
    assert margin_for_recall(m, ~np.ones(5, bool), 0.9) == float("inf")
    lg = np.array([[1, 4, 2], [5, 0, 5]])
    np.testing.assert_array_equal(margins_of(lg), jax_margins_of(lg))


def test_cascade_driver_on_the_cpu(capsys):
    results, rep = chip_serve.main(
        ["--cascade", "--fused", "--requests", "4", "--batch", "4",
         "--margin", "inf", "--device", "cpu"])
    assert len(results) == 4 and rep.escalated == 0 and rep.frames == 4
    out = capsys.readouterr().out
    assert "fused escalation on the device, 1 dispatches" in out
    assert "billing             : 4 billed == 4 served + 0 padded" in out
