"""Cascaded always-on pipelines: cheap detector -> expensive recognizer.

The counterpart of ``repro.serving.cascade``.  The paper's flagship
deployment runs the 0.92 uJ/frame S=4 face *detector* on every frame and
wakes the 14.4 uJ/frame S=1 owner *recognizer* only when a face is there.
:class:`CascadePipeline` is that runtime on top of a :class:`ChipServer`:

* every submitted frame enters the **detector** lane;
* a detector result whose logit margin (positive-class logit minus the
  best other logit) reaches ``margin`` **escalates**: the frame goes to
  the **recognizer** lane, whose label becomes the cascade's answer.  At
  the default ``margin=0.0`` this is "the detector said
  ``positive_class``"; ``-inf`` recognizes everything, ``+inf`` nothing;
* everything else finalizes with the detector's label.

**Host mode** serves both stages through the ordinary server path.
Escalations are deferred until a full recognizer batch accumulates (the
trailing remainder flushes at drain), so the expensive stage wakes for
whole batches.

**Fused mode** (``fused=True``) runs each detector batch through the
fused cascade (``interpreter.pack_cascade``, one ``cascade_launch`` on
the GPU): the escalation is decided on the device and the recognizer runs
on the escalated frames in the same dispatch, with no host round trip.
Labels are bit-exact with host mode for every margin.  The bill has the
same shape: the detector on every batch slot, the recognizer on the slots
the kernel reports (``counts[1]``: escalations plus drain-chunk padding).

:meth:`CascadePipeline.report` bills the whole cascade with
``energy.cascade_report`` from the server's launch ledger.
:func:`calibrate_margin` picks the cheapest margin that still escalates
``target_recall`` of the positive frames of a held-out split.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.chip import energy, interpreter
from repro_torch.serving.queue import FrameResult
from repro_torch.serving.server import ChipServer


def margins_of(logits, positive_class: int = 1) -> np.ndarray:
    """Vectorized escalation margins: positive-class logit minus the best
    competing logit, float64, one per row of ``logits``."""
    lg = np.asarray(logits, dtype=np.float64)
    pos = lg[:, positive_class]
    rest = np.delete(lg, positive_class, axis=1).max(axis=1)
    return pos - rest


def margin_for_recall(margins, labels, target_recall: float) -> float:
    """The cheapest escalation margin meeting a recall target.

    ``margins`` are detector logit margins on a held-out split, ``labels``
    boolean "this frame must escalate" ground truth.  Returns the largest
    threshold ``thr`` such that at least ``ceil(target_recall * P)`` of the
    ``P`` positive frames satisfy ``margin >= thr``.  With no positives
    (or a zero target) every threshold meets the target, so the cheapest
    is ``+inf`` (escalate nothing).
    """
    m = np.asarray(margins, dtype=np.float64)
    y = np.asarray(labels, dtype=bool)
    if m.shape != y.shape:
        raise ValueError(f"margins {m.shape} and labels {y.shape} disagree")
    pos = np.sort(m[y])[::-1]
    k = int(math.ceil(target_recall * len(pos)))
    if k <= 0:
        return float("inf")
    if k > len(pos):
        raise ValueError(
            f"target_recall {target_recall} asks for {k} of "
            f"{len(pos)} positive frames")
    return float(pos[k - 1])


def calibrate_margin(frames, labels, target_recall: float = 0.95, *,
                     detector, artifact, positive_class: int = 1,
                     device=None) -> float:
    """Calibrate the escalation margin on a held-out split: run
    ``detector`` (an ISA program, with its ``artifact``) over ``frames``
    and return the cheapest margin capturing ``target_recall`` of the
    frames whose ``labels`` mark them positive (:func:`margin_for_recall`).
    """
    frames = np.asarray(frames)
    labels = np.asarray(labels, dtype=bool)
    if len(frames) != len(labels):
        raise ValueError(f"{len(frames)} frames vs {len(labels)} labels")
    plan = interpreter.compile_plan(detector)
    logits, _ = plan.forward(interpreter.ensure_packed(artifact), frames,
                             device=device)
    return margin_for_recall(margins_of(logits.cpu().numpy(),
                                        positive_class),
                             labels, target_recall)


@dataclasses.dataclass(frozen=True)
class CascadeResult:
    """The cascade's final answer for one submitted frame."""
    rid: int                    # cascade-level request id (arrival order)
    label: int                  # recognizer label if escalated, else the
                                # detector's label
    escalated: bool
    detector_label: int
    detector_margin: float      # positive logit - best other logit
    logits: np.ndarray          # logits of the stage that produced label


class CascadePipeline:
    """Two-stage always-on cascade over a :class:`ChipServer`.

    ``detector`` and ``recognizer`` are resident lane names on ``server``;
    both must take the same frame geometry.  ``margin`` is the escalation
    threshold on the detector's logit margin.  ``fused=True`` serves each
    detector batch as one fused cascade dispatch (``Executor.cascade_for``);
    lanes outside the cascade still serve through the ordinary server path
    in either mode.
    """

    def __init__(self, server: ChipServer, detector: str, recognizer: str,
                 *, positive_class: int = 1, margin: float = 0.0,
                 fused: bool = False):
        for lane in (detector, recognizer):
            if lane not in server.queue.lanes:
                raise KeyError(f"lane {lane!r} not resident on the server "
                               f"(have {sorted(server.queue.lanes)})")
            if len(server._lane_variants[lane]) > 1:
                raise ValueError(
                    f"cascade stage {lane!r} is a program family; cascade "
                    "stages must be single-variant lanes (the energy bill "
                    "is per stage program)")
        if detector == recognizer:
            raise ValueError("detector and recognizer must be distinct lanes")
        gd = server.executor.geometry(detector)
        gr = server.executor.geometry(recognizer)
        if gd != gr:
            raise ValueError(
                f"cascade stages disagree on frame geometry: "
                f"detector {gd} vs recognizer {gr}")
        self.server = server
        self.detector = detector
        self.recognizer = recognizer
        self.positive_class = positive_class
        self.margin = margin
        self.fused = fused
        # the fused unit packs eagerly (resident programs load their
        # weights before serving)
        self._fused = (server.executor.cascade_for(
            detector, recognizer, positive_class=positive_class)
            if fused else None)
        self.fused_dispatches = 0
        self._next_rid = 0
        self._frames: Dict[int, np.ndarray] = {}   # srid -> frame (det stage)
        self._det_rid: Dict[int, int] = {}         # det srid -> cascade rid
        self._rec_rid: Dict[int, int] = {}         # rec srid -> cascade rid
        self._det_info: Dict[int, tuple] = {}      # crid -> (label, margin)
        self._deferred: List[tuple] = []           # (crid, frame) awaiting a
                                                   # full recognizer batch
        self.other_results: List[FrameResult] = []  # results of server lanes
                                                    # outside the cascade
        self._submitted = 0
        self._escalated = 0

    # -- request side -------------------------------------------------------

    def submit(self, frame) -> int:
        """Enqueue one frame on the detector stage; returns its cascade
        request id (arrival order)."""
        rid = self._next_rid
        self._next_rid += 1
        srid = self.server.submit(self.detector, frame)
        self._det_rid[srid] = rid
        if not self.fused:       # fused dispatches gather frames on device
            self._frames[srid] = np.asarray(frame)
        self._submitted += 1
        return rid

    def submit_many(self, frames) -> List[int]:
        return [self.submit(f) for f in frames]

    # -- dispatch side ------------------------------------------------------

    def _margin(self, logits: np.ndarray) -> float:
        """Positive-class logit minus the best competing logit."""
        return float(margins_of(np.asarray(logits)[None, :],
                                self.positive_class)[0])

    def _route(self, r: FrameResult) -> Optional[CascadeResult]:
        """Process one server result: finalize, or escalate and return
        ``None`` (the recognizer's result finalizes later).  Results of
        lanes outside the cascade pass through to :attr:`other_results`."""
        if r.rid not in self._det_rid and r.rid not in self._rec_rid:
            self.other_results.append(r)
            return None
        if r.rid in self._det_rid:
            crid = self._det_rid.pop(r.rid)
            frame = self._frames.pop(r.rid)
            m = self._margin(r.logits)
            if m >= self.margin:
                self._deferred.append((crid, frame))
                self._det_info[crid] = (r.label, m)
                self._escalated += 1
                self._flush(full_only=True)
                return None
            return CascadeResult(rid=crid, label=int(r.label),
                                 escalated=False, detector_label=int(r.label),
                                 detector_margin=m, logits=r.logits)
        crid = self._rec_rid.pop(r.rid)
        det_label, det_margin = self._det_info.pop(crid)
        return CascadeResult(rid=crid, label=int(r.label), escalated=True,
                             detector_label=det_label,
                             detector_margin=det_margin, logits=r.logits)

    def _flush(self, full_only: bool = False) -> None:
        """Submit deferred escalations to the recognizer lane: whole static
        batches only when ``full_only``, everything when draining."""
        while len(self._deferred) >= self.server.batch or (
                self._deferred and not full_only):
            take = self._deferred[:self.server.batch]
            del self._deferred[:self.server.batch]
            for crid, frame in take:
                srid = self.server.submit(self.recognizer, frame)
                self._rec_rid[srid] = crid

    def _step_fused(self, reqs) -> List[CascadeResult]:
        """One fused dispatch: a detector batch through the fused cascade;
        every frame in it finalizes now (escalated frames carry the
        recognizer's answer from the same dispatch)."""
        srv = self.server
        t0 = srv.clock()
        size = srv.batch
        frames = srv.executor.pad_frames(
            reqs, srv.executor.geometry(self.detector), size)
        ctrl = interpreter.CascadePlan.margin_ctrl(self.margin, len(reqs))
        outs = self._fused["fn"](self._fused["image"], frames, ctrl)
        dl, dlab, rl, rlab, queue, counts = (t.cpu().numpy() for t in outs)
        esc, slots = int(counts[0]), int(counts[1])
        # bill both stages at launch like ChipServer._launch: the detector
        # on every batch slot, the recognizer on the slots the kernel
        # reports (escalated + drain-chunk padding)
        n = len(reqs)
        srv._bill(self.detector, n, size - n)
        srv._bill(self.recognizer, esc, slots - esc)
        srv._dispatches += 1
        # the stages run one after the other: slot-weighted occupancy
        sd = srv.programs[self.detector].s
        sr = srv.programs[self.recognizer].s
        srv._util_sum += (size / sd + slots / sr) / (size + slots)
        self.fused_dispatches += 1
        self._escalated += esc
        rank = {int(p): k for k, p in enumerate(queue[:esc])}
        out = []
        for i, r in enumerate(reqs):
            crid = self._det_rid.pop(r.rid)
            m = self._margin(dl[i])
            k = rank.get(i)
            if k is None:
                out.append(CascadeResult(
                    rid=crid, label=int(dlab[i]), escalated=False,
                    detector_label=int(dlab[i]), detector_margin=m,
                    logits=dl[i]))
            else:
                out.append(CascadeResult(
                    rid=crid, label=int(rlab[k]), escalated=True,
                    detector_label=int(dlab[i]), detector_margin=m,
                    logits=rl[k]))
        srv._host_wall_s += srv.clock() - t0
        return out

    def step(self) -> List[CascadeResult]:
        """One dispatch; returns the cascade results it finalized ([] when
        there was nothing to run).  Host mode: one server dispatch.  Fused
        mode: one detector batch through the fused cascade; the server
        only steps for lanes outside the cascade."""
        if self.fused:
            reqs = self.server.queue.take(self.detector, self.server.batch)
            if reqs:
                return self._step_fused(reqs)
            got = self.server.step()      # lanes outside the cascade
            return [c for c in map(self._route, got) if c is not None]
        got = self.server.step()
        if not got and self._deferred:
            self._flush()                  # trailing partial batch
            got = self.server.step()
        return [c for c in map(self._route, got) if c is not None]

    def drain(self) -> List[CascadeResult]:
        """Serve until every submitted frame has a final answer; results in
        finalization order."""
        out: List[CascadeResult] = []
        if self.fused:
            self.server.policy.set_flush(True)   # non-cascade lanes too
            try:
                while True:
                    got = self.step()
                    out.extend(got)
                    if not got and self.server.queue.pending() == 0:
                        return out
            finally:
                self.server.policy.set_flush(False)
        while True:
            got = self.server.step()
            if not got:
                if self._deferred:
                    self._flush()          # trailing partial batch
                    continue
                if self.server.queue.pending() == 0:
                    return out
                continue
            out.extend(c for c in map(self._route, got) if c is not None)

    # -- accounting ---------------------------------------------------------

    @property
    def submitted(self) -> int:
        return self._submitted

    @property
    def escalated(self) -> int:
        return self._escalated

    def calibrate(self, frames, labels,
                  target_recall: float = 0.95) -> float:
        """Calibrate ``self.margin`` on a held-out labelled split via
        :func:`calibrate_margin` (the pipeline's own detector program and
        artifact); returns and adopts the chosen margin."""
        ex = self.server.executor
        self.margin = calibrate_margin(
            frames, labels, target_recall,
            detector=self.server.programs[self.detector],
            artifact=ex._raw_artifacts[self.detector],
            positive_class=self.positive_class, device=ex.device)
        return self.margin

    def report(self, include_padding: bool = True) -> energy.CascadeReport:
        """The chip-model energy bill for everything served so far
        (``energy.cascade_report``), from the server's launch ledger:
        detector frames and escalations that hit the array, so a mid-stream
        report never bills frames still queued or deferred.
        ``include_padding`` bills the padding slots each stage burned."""
        stats = self.server.stats()
        padded_det = stats.padded.get(self.detector, 0)
        padded_rec = stats.padded.get(self.recognizer, 0)
        if not include_padding:
            padded_det = padded_rec = 0
        return energy.cascade_report(
            self.server.programs[self.detector],
            self.server.programs[self.recognizer],
            frames=stats.served.get(self.detector, 0),
            escalated=stats.served.get(self.recognizer, 0),
            detector_padded=padded_det, recognizer_padded=padded_rec,
            f_hz=self.server.f_hz)
