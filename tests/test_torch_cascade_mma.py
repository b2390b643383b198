"""The fused cascade on the cluster member body (``csrc/cascade.cu``)
emulated on the CPU.

``cascade_launch`` enqueues three kernels: the detector, one thread-block
cluster a frame at its own geometry; the escalation scan (``scan.cuh``
``compact_in_order``: tiles of 1024 frames, a ballot a warp, a scan of the
warp totals); the recognizer, one cluster a queue row at its geometry,
whose clusters at or past E zero their row and return together.  No CUDA
kernel runs here, so :func:`emulate_cascade` chains
``test_torch_member_mma.emulate_frame`` (every rank's band, tiles, MMA
fragments and stores) for the detector over the batch, the scan's ballots
and warp offsets, and ``emulate_frame`` for the recognizer on the queued
frames, all at the geometry the wrapper passes
(``megakernel.cascade_geometry``).  It is held bit-exact (tolerance 0) to
``cascade_plain`` and to ``repro``'s ``cascade_forward`` in Pallas
interpret mode on ``repro``'s mnist5 det/rec pair, and to ``cascade_plain``
and ``repro``'s float references on face -> owner at full width.  The
kernels themselves are held against ``cascade_plain`` on the card by
``test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.chip import interpreter as jinterp
from repro.core.chip import networks as jnets
from repro.kernels import megakernel as jmk
from repro_torch import convert
from repro_torch.core.chip import interpreter as tinterp
from repro_torch.core.chip import networks as tnets
from repro_torch.kernels import megakernel as mk
from tests.test_torch_cascade import _frames, pair  # noqa: F401
from tests.test_torch_interpreter import (_np_tree, _oracle,  # noqa: F401
                                          np_params, one_torch_thread)
from tests.test_torch_member_mma import CSRC, _ballot, emulate_frame

SCAN_THREADS = int(re.search(r"constexpr int kScanThreads = (\d+);",
                             (CSRC / "scan.cuh").read_text()).group(1))
INT32 = 2 ** 32


def compact_in_order(take, n):
    """scan.cuh compact_in_order on the predicates ``take`` (n,): each
    tile of SCAN_THREADS items a ballot a warp, an exclusive scan of the
    warp totals, item i stored at base + its warp's offset + its rank in
    the ballot; zeros from K on.  Returns (queue, K), and raises unless
    every queue slot is written once."""
    queue = np.zeros(n, np.int64)
    writes = np.zeros(n, np.int64)
    base = 0
    for t0 in range(0, n, SCAN_THREADS):
        i = t0 + np.arange(SCAN_THREADS)
        t = np.zeros(SCAN_THREADS, bool)
        t[i < n] = take[i[i < n]]
        bal = _ballot(t.reshape(-1, 32))                      # a warp each
        totals = np.array([bin(int(b)).count("1") for b in bal])
        warp_base = np.cumsum(totals) - totals
        for j in np.flatnonzero(t):
            w, lane = divmod(int(j), 32)
            below = int(bal[w]) & ((1 << lane) - 1)
            slot = base + warp_base[w] + bin(below).count("1")
            queue[slot] = i[j]
            writes[slot] += 1
        base += int(totals.sum())
    writes[base:] += 1
    assert (writes == 1).all(), "a queue slot written other than once"
    return queue, base


def escalates(det, ctrl, positive_class):
    """escalate_kernel's predicate: lane i < n_real whose int32 margin
    (positive logit minus the best other, wrapping as int32) reaches the
    threshold."""
    thr, n_real = (int(v) for v in ctrl.reshape(2))
    others = np.delete(det, positive_class, axis=1).max(axis=1)
    margin = (det[:, positive_class] - others + 2 ** 31) % INT32 - 2 ** 31
    return (margin >= thr) & (np.arange(len(det)) < n_real)


def emulate_cascade(spec, image, frames, ctrl, *, bb=8, rb=0,
                    check_every=1, positive_class=1, det_cluster=0):
    """The three launches of cascade_launch at the wrapper's
    cascade_geometry on an H100 (132 SMs): (det, rec, queue, counts) as
    int64 arrays.  Raises unless every rec row is written once, by its own
    cluster: a cluster at or past E writes its zero row and runs no member
    frame."""
    det_geo, rec_geo = mk.cascade_geometry(spec, len(frames),
                                           det_cluster=det_cluster)
    det_spec, rec_spec = spec
    b = len(frames)
    det = np.stack([emulate_frame(det_spec, 0, image, frames[i], det_geo)
                    for i in range(b)])
    queue, e = compact_in_order(escalates(det, ctrl, positive_class), b)
    bpad, rb = mk.cascade_schedule(b, bb, rb)
    counts = np.array([e, mk.drain_slots(e, bpad, rb, check_every)])
    rec = np.full((b, rec_spec[-1][2]), -1, np.int64)
    writes = np.zeros(b, np.int64)
    ran = []
    for k in range(b):                 # cluster k; every rank reads counts[0]
        if k >= counts[0]:
            rec[k] = 0                 # rank 0's zero row
        else:
            rec[k] = emulate_frame(rec_spec, 0, image, frames[queue[k]],
                                   rec_geo)
            ran.append(int(queue[k]))
        writes[k] += 1
    assert (writes == 1).all()
    assert ran == queue[:e].tolist()   # the E queued frames, nothing else
    assert not rec[e:].any()
    return det, rec, queue, counts


def _check(got, want, e):
    """got/want: (det, rec, queue, counts); rec rows from E on are
    compared only where ``e`` is None (both versions zero them)."""
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got[i], want[i])
    rows = slice(None) if e is None else slice(0, e)
    np.testing.assert_array_equal(got[1][rows], want[1][rows])


@pytest.mark.parametrize("n,margin,schedule", [
    (4, 0.0, (2, 1, 2)), (3, -3.5, (8, 0, 1)), (4, float("-inf"), (4, 3, 1))],
    ids=["B4-margin0", "B3-margin-3.5", "B4-all"])
def test_emulated_cascade_matches_plain_and_repro_on_mnist5_pair(
        pair, n, margin, schedule):
    """repro's mnist5 det (2 classes) -> rec (5 classes): the emulated
    launches equal cascade_plain (rec's zero rows included) and repro's
    cascade_forward in interpret mode (rec[:E]; repro leaves the drain's
    rows past E unspecified)."""
    _, _, jplan, jimage, tplan, timage, frames = pair
    frames = frames[:n]
    bb, rb, ce = schedule
    ctrl = tplan.margin_ctrl(margin, n)
    got = emulate_cascade(tplan.spec, timage, frames, ctrl, bb=bb, rb=rb,
                          check_every=ce)
    plain = mk.cascade_plain(timage, torch.from_numpy(frames), ctrl,
                             spec=tplan.spec, bb=bb, rb=rb, check_every=ce)
    _check(got, [x.numpy() for x in plain], None)
    want = jmk.cascade_forward(
        jimage, jnp.asarray(frames), jplan.margin_ctrl(margin, n),
        spec=jplan.spec, bb=bb, rb=rb, check_every=ce,
        positive_class=jplan.positive_class, interpret=True)
    e = int(got[3][0])
    _check(got, [np.asarray(x) for x in want], e)
    assert 0 < e <= n


@pytest.fixture(scope="module")
def face_owner():
    """face_detector (S=4) -> owner_detector (S=1) at full width from
    repro-layout params, folded by repro; two frames, and repro's float
    references of both programs on them."""
    det, rec = jnets.face_detector(), jnets.owner_detector()
    npp = {"face_detector": np_params(det, seed=140),
           "owner_detector": np_params(rec, seed=141)}
    frames = _frames(det, 2, 142)
    arts = {n: convert.artifact_from_numpy(_np_tree(jinterp.fold_params(
        jax.tree_util.tree_map(jnp.asarray, p), prog, packed=True)),
        device="cpu")
        for (n, p), prog in zip(npp.items(), (det, rec))}
    tplan, timage = tinterp.pack_cascade(
        {"face_detector": tnets.face_detector(),
         "owner_detector": tnets.owner_detector()}, arts,
        detector="face_detector", recognizer="owner_detector")
    ref_det = _oracle(det, npp["face_detector"], frames)[0]
    ref_rec = _oracle(rec, npp["owner_detector"], frames)[0]
    return tplan, timage, frames, ref_det, ref_rec


def test_emulated_cascade_matches_plain_and_float_references_face_owner(
        face_owner):
    """Full width, two frames, one escalated (the margin between the
    two): the detector at the recognizer's clusters of 8 (the wrapper's
    pick at this batch) and at its own 2, the recognizer at 8; det equals
    repro's float reference, the queue the host rule, rec[0] the
    recognizer's float reference on the escalated frame, rec[1] zero, all
    equal to cascade_plain."""
    tplan, timage, frames, ref_det, ref_rec = face_owner
    margins = _margins(ref_det)
    up = int(np.argmax(margins))
    assert margins[up] > margins[1 - up]
    ctrl = tplan.margin_ctrl(float(margins[up]), 2)
    plain = [x.numpy() for x in mk.cascade_plain(
        timage, torch.from_numpy(frames), ctrl, spec=tplan.spec)]
    det_geo, rec_geo = mk.cascade_geometry(tplan.spec, 2)
    assert (det_geo.cluster, rec_geo.cluster) == (8, 8)
    got = emulate_cascade(tplan.spec, timage, frames, ctrl)
    _check(got, plain, None)
    np.testing.assert_array_equal(got[0], ref_det)
    assert got[2].tolist() == [up, 0]
    assert got[3].tolist() == [1, mk.drain_slots(1, 2, 2, 1)]
    np.testing.assert_array_equal(got[1][0], ref_rec[up])
    assert not got[1][1].any()
    assert det_geo.smem < rec_geo.smem
    own = mk.cascade_geometry(tplan.spec, 2, det_cluster=2)[0]
    assert own == mk.cluster_geometry((tplan.spec[0],))
    for i in range(2):
        np.testing.assert_array_equal(
            emulate_frame(tplan.spec[0], 0, timage, frames[i], own),
            ref_det[i])


def _margins(det):
    """The host rule's margin: positive class 1 minus the best other."""
    return det[:, 1] - np.delete(det, 1, axis=1).max(axis=1)


def test_compact_in_order_across_tiles():
    """Past one tile of 1024 items the queue stays in ascending order and
    zero from K on, as the plain nonzero."""
    rng = np.random.default_rng(0)
    take = rng.random(2500) < 0.3
    queue, k = compact_in_order(take, 2500)
    want = np.flatnonzero(take)
    assert k == len(want)
    np.testing.assert_array_equal(queue[:k], want)
    assert not queue[k:].any()


def test_recognizer_exit_is_cluster_wide():
    """recognizer_kernel decides its exit from blockIdx and the global
    counts[0] alone, before run_frame (and so before any cluster barrier),
    the same in every rank; the detector launch and the recognizer launch
    go through launch_clusters at their own geometries."""
    src = (CSRC / "cascade.cu").read_text()
    body = src[src.index("recognizer_kernel(const"):]
    body = body[:body.index("\n}\n")]
    assert "const int k = blockIdx.x / a.rec_geo.cluster;" in body
    exit_at = body.index("if (k >= a.counts[0]) {")
    assert exit_at < body.index("run_frame") and "cluster_sync" not in body
    assert re.search(r"launch_clusters\(\s*detector_kernel, a,[^;]*"
                     r"a\.det_geo\.cluster", src)
    assert re.search(r"launch_clusters\(\s*recognizer_kernel, a,[^;]*"
                     r"a\.rec_geo\.cluster", src)


def test_cascade_geometry_per_stage():
    """Each stage's geometry is sized for its member alone; the detector
    takes the recognizer's cluster shape while the batch's clusters of it
    take at most half the SMs, else its own, or any cluster of 1 to 8
    blocks asked for; outside that it raises."""
    progs = {"face_detector": tnets.face_detector(),
             "owner_detector": tnets.owner_detector()}
    specs = {n: mk.solo_member_spec(tinterp.compile_plan(p).mega)[0]
             for n, p in progs.items()}
    spec = (specs["face_detector"], specs["owner_detector"])
    det, rec = mk.cascade_geometry(spec, 256)
    assert det == mk.cluster_geometry((spec[0],)) and det.cluster == 2
    assert rec == mk.cluster_geometry((spec[1],)) and rec.cluster == 8
    assert len(det.ksteps) == len(rec.ksteps) == 1
    assert mk.cascade_geometry(spec, 8)[0] == mk.cluster_geometry(
        (spec[0],), 8)
    assert mk.cascade_geometry(spec, 9)[0].cluster == 2
    assert mk.cascade_geometry(spec, 16)[0].cluster == 2
    assert mk.cascade_geometry(spec, 8, sms=120)[0].cluster == 2
    for n in range(1, mk.MAX_CLUSTER + 1):
        assert mk.cascade_geometry(spec, 8, det_cluster=n)[0].cluster == n
    for bad in (-1, mk.MAX_CLUSTER + 1):
        with pytest.raises(ValueError, match="cluster"):
            mk.cascade_geometry(spec, 8, det_cluster=bad)
