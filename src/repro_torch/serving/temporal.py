"""Temporal serving: delta-gated always-on video on top of ChipServer.

The counterpart of ``repro.serving.temporal``: the same pipeline, with the
gate state held as tensors on the server's device between dispatches.

An always-on camera feed is mostly *still*: between scene changes the
thermometer-coded frame a stream submits differs from its previous frame
by a handful of packed bits, and recomputing the whole network buys
nothing the cached answer doesn't already hold.  The paper's always-on
budget (Sec. IV) is exactly this regime — the chip that wins is the one
that spends full-inference energy only when the scene actually moved.

:class:`TemporalPipeline` is that runtime.  Each step pulls one batch
from its lane and runs the **delta-gated megakernel**
(:meth:`Executor.delta_for` -> ``kernels.megakernel.delta_forward``, one
``delta_launch`` on the GPU):
the kernel popcount-XORs every stream's packed frame against a resident
last-frame buffer, compacts the streams whose Hamming delta reaches the
gate threshold into an in-kernel change queue, recomputes the network
over *only those*, and scatters fresh logits merged with the resident
last-logits buffer — skipped streams emit their cached answer from the
same dispatch, bit-exact with the frame that produced it.

Accounting follows the launch-ledger discipline of the rest of the
serving tier, split by what the chip actually ran:

* the **server ledger** bills full-network inferences only — the slots
  the kernel's change queue drained (changed streams + drain-chunk
  padding, from the kernel's own scalar report).  ``billed == served +
  padded`` still holds per lane; skipped frames never hit the array and
  never appear in it.
* the **pipeline ledger** (:meth:`TemporalPipeline.report` ->
  :func:`energy.temporal_report`) bills every frame the delta-compute
  toll (one IO pass: the frame must stream in to be compared) and adds
  full inference energy for the computed slots — the honest
  uJ/frame-of-video figure, with the skip ratio that produced it.

**Activity coupling**: the pipeline keeps an EWMA of the changed
fraction per step and feeds it to
:meth:`OperatingPointPolicy.set_activity` when its lane is a program
family under an operating-point policy — a quiet scene both skips
frames *and* downshifts the frames it does compute to a cheaper
operating point, compounding the two scaling axes.  Variant switches
reset the gate state for the incoming variant (its packed geometry and
logits are its own), forcing one full recompute dispatch.

**Threshold calibration** (:func:`calibrate_delta_threshold`): like the
cascade's :func:`~repro_torch.serving.cascade.calibrate_margin`, run the
*ungated* network offline over a held-out video trace and pick the
cheapest (largest) threshold whose gated labels still agree with the
ungated oracle at a target rate — the threshold becomes an agreement
contract.  :func:`threshold_for_skip` solves the dual problem: the
smallest threshold achieving a target skip ratio (an energy contract).

Gate-state alignment: batch slot ``i`` carries stream ``i``'s state, so
steady submission should be round-robin across streams (``video_trace``
order).  A misaligned slot only ever *recomputes more* — a skip at
threshold ``t`` certifies the packed frames differ by fewer than ``t``
bits, whichever stream wrote the reference — so labels stay within the
gate contract; alignment is an efficiency concern, not a correctness
one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import binarize
from repro_torch.core.chip import energy, interpreter
from repro_torch.serving.policy import OperatingPointPolicy
from repro_torch.serving.queue import FrameResult
from repro_torch.serving.server import ChipServer


# ---------------------------------------------------------------------------
# threshold calibration: agreement and skip contracts
# ---------------------------------------------------------------------------

def _packed_streams(frames, program) -> Tuple[np.ndarray, np.ndarray]:
    """Normalize a video trace to ``(T, S, H, W, C)`` int frames and the
    matching packed thermometer codes ``(T, S, H, W, C_packed)`` uint32
    (exactly the kernel's in-gate packing)."""
    io = program.instrs[0]
    arr = np.asarray(frames)
    if arr.ndim == 4:                       # single stream: (T, H, W, C)
        arr = arr[:, None]
    if arr.ndim != 5:
        raise ValueError(
            f"expected (T, S, H, W, C) or (T, H, W, C) frames, "
            f"got shape {arr.shape}")
    t, s = arr.shape[:2]
    flat = torch.from_numpy(np.ascontiguousarray(
        arr.reshape((t * s,) + arr.shape[2:]), dtype=np.int32))
    packed = binarize.thermometer_pack(
        flat, io.bits, io.in_channels, io.channels).numpy().view(np.uint32)
    return arr, packed.reshape((t, s) + packed.shape[1:])


def _hamming(a: np.ndarray, b: np.ndarray) -> int:
    """Packed Hamming distance — the host reference for the kernel's
    popcount gate."""
    x = np.ascontiguousarray(np.bitwise_xor(a, b))
    return int(np.unpackbits(x.view(np.uint8)).sum())


def simulate_gate(packed: np.ndarray,
                  threshold: float) -> Tuple[np.ndarray, np.ndarray]:
    """Host reference of the stateful gate over a packed trace.

    Per stream: frame 0 always computes (cold state); frame ``t``
    recomputes iff its Hamming delta against the *last computed* frame
    reaches ``threshold`` — the reference advances only on recompute,
    exactly the kernel's resident last-frame rule.  Returns
    ``(recompute, ref)``: a ``(T, S)`` bool mask and the ``(T, S)``
    index of the frame whose (cached or fresh) answer each step emits.
    """
    t, s = packed.shape[:2]
    rec = np.zeros((t, s), dtype=bool)
    ref = np.zeros((t, s), dtype=np.int64)
    for si in range(s):
        last = 0
        for ti in range(t):
            if ti == 0 or _hamming(packed[ti, si],
                                   packed[last, si]) >= threshold:
                rec[ti, si] = True
                last = ti
            ref[ti, si] = last
    return rec, ref


def _candidate_thresholds(packed: np.ndarray) -> List[float]:
    """Thresholds worth trying: 1 (skip only bit-identical frames), every
    consecutive-frame delta the trace contains, and one past the largest
    (skip everything after the cold frame)."""
    deltas = {_hamming(packed[ti, si], packed[ti - 1, si])
              for ti in range(1, packed.shape[0])
              for si in range(packed.shape[1])}
    cands = {1.0} | {float(d) for d in deltas if d > 0}
    cands.add(max(cands) + 1.0)
    return sorted(cands)


def calibrate_delta_threshold(frames, target_agreement: float = 0.95, *,
                              program, artifact, device=None) -> float:
    """The cheapest gate threshold meeting a label-agreement target.

    Runs ``program`` (with its deployment ``artifact``) *ungated* over a
    held-out video trace — ``(T, S, H, W, C)`` or single-stream
    ``(T, H, W, C)`` — to get oracle labels, then simulates the stateful
    gate at every candidate threshold, cheapest (largest = fewest
    recomputes) first, and returns the first whose emitted labels (the
    cached label of each stream's last computed frame) agree with the
    oracle on at least ``target_agreement`` of all frames.  Threshold 1
    skips only bit-identical packed frames, whose cached labels are
    bit-exact — so the search always terminates with agreement 1.0.
    """
    if not 0.0 < target_agreement <= 1.0:
        raise ValueError(
            f"target_agreement must be in (0, 1], got {target_agreement}")
    arr, packed = _packed_streams(frames, program)
    t, s = packed.shape[:2]
    plan = interpreter.compile_plan(program)
    _, labels = plan.forward(
        interpreter.ensure_packed(artifact),
        np.ascontiguousarray(arr.reshape((t * s,) + arr.shape[2:]),
                             dtype=np.int32), device=device)
    oracle = labels.cpu().numpy().reshape(t, s)
    cols = np.arange(s)[None, :]
    for thr in sorted(_candidate_thresholds(packed), reverse=True):
        _, ref = simulate_gate(packed, thr)
        agreement = float((oracle[ref, cols] == oracle).mean())
        if agreement >= target_agreement:
            return float(thr)
    return 1.0          # unreachable: threshold 1 agrees exactly


def threshold_for_skip(frames, target_skip: float, *, program) -> float:
    """The smallest gate threshold achieving a skip-ratio target on a
    held-out video trace — the least aggressive gate that still delivers
    the energy contract.  Raises when the trace can't reach the target
    even skipping everything but each stream's cold frame."""
    if not 0.0 <= target_skip < 1.0:
        raise ValueError(
            f"target_skip must be in [0, 1), got {target_skip}")
    _, packed = _packed_streams(frames, program)
    best = 0.0
    for thr in _candidate_thresholds(packed):
        rec, _ = simulate_gate(packed, thr)
        best = max(best, 1.0 - float(rec.mean()))
        if best >= target_skip:
            return float(thr)
    raise ValueError(
        f"target_skip {target_skip} unreachable on this trace "
        f"(max achievable {best:.3f}: cold frames always compute)")


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TemporalResult:
    """The gated answer for one submitted frame."""
    rid: int                    # pipeline-level request id (arrival order)
    label: int                  # fresh if computed, else the cached label
    computed: bool              # did this frame's stream recompute?
    delta: int                  # packed Hamming delta vs the gate reference
    variant: str                # operating point that produced/cached label
    logits: np.ndarray


class TemporalPipeline:
    """Delta-gated serving for one always-on video lane.

    Wraps a :class:`ChipServer` lane: frames enqueue through the
    ordinary queue, but each step pulls one batch and runs it through
    the in-kernel delta gate instead of the plain serve path — per-slot
    last-frame/last-logits state lives in pipeline-held tensors on the
    server's device that round-trip through the kernel (resident state,
    exactly like the chip keeping the previous frame on-SRAM).

    ``threshold`` is the packed-Hamming gate (``delta >= threshold``
    recomputes; 1 skips only bit-identical frames; ``-inf`` recomputes
    everything — the gated path then matches the plain megakernel
    bit-exactly).  The first dispatch after construction, :meth:`reset`,
    or an operating-point switch forces ``-inf`` (cold state holds no
    cacheable answer).

    A single-variant lane serves under any policy.  A program-family
    lane requires an :class:`OperatingPointPolicy`: each step reports
    the activity EWMA via ``set_activity`` and asks the policy to pick
    the operating point, so quiet scenes downshift under the same budget
    machinery as ordinary serving (spend commits for the slots the gate
    actually computed).
    """

    def __init__(self, server: ChipServer, lane: str, *,
                 threshold: float = 1.0, rb: Optional[int] = None,
                 check_every: int = 1, activity_alpha: float = 0.5):
        if lane not in server.queue.lanes:
            raise KeyError(f"lane {lane!r} not resident on the server "
                           f"(have {sorted(server.queue.lanes)})")
        if math.isnan(threshold):
            raise ValueError("threshold must not be NaN")
        if not 0.0 < activity_alpha <= 1.0:
            raise ValueError(
                f"activity_alpha must be in (0, 1], got {activity_alpha}")
        self.variants = server._lane_variants[lane]
        if len(self.variants) > 1 and not isinstance(
                server.policy, OperatingPointPolicy):
            raise ValueError(
                f"lane {lane!r} is a program family; temporal serving "
                "over a family needs an OperatingPointPolicy to pick the "
                "operating point per dispatch")
        self.server = server
        self.lane = lane
        self.threshold = threshold
        self.rb = rb
        self.check_every = check_every
        self.activity_alpha = activity_alpha
        # cold scenes look "active" until measured: start the EWMA at 1
        # so a fresh pipeline never downshifts on no evidence
        self._activity = 1.0
        self._variant = (server.policy.variant_order(lane)[0]
                         if len(self.variants) > 1 else self.variants[0])
        # the gated dispatch unit packs eagerly (resident programs load
        # their weights before serving)
        server.executor.delta_for(self._variant, rb=rb,
                                  check_every=check_every)
        # per-variant resident state: variant -> (last_frames, last_logits)
        # tensors on the device; absence = cold (next dispatch recomputes)
        self._state: Dict[str, tuple] = {}
        self._rid: Dict[int, int] = {}             # server rid -> pipeline rid
        self._next_rid = 0
        self.other_results: List[FrameResult] = []  # non-lane server results
        self._submitted = 0
        self._frames_total = 0
        self._computed = 0
        self._computed_padded = 0
        self._skipped = 0
        self.gated_dispatches = 0
        # variant -> [frames, computed, computed_padded] for the bill
        self._per_variant: Dict[str, List[int]] = {}

    # -- request side -------------------------------------------------------

    def submit(self, frame) -> int:
        """Enqueue one frame; returns its pipeline request id (arrival
        order).  Submit round-robin across streams so batch slot ``i``
        keeps carrying stream ``i``'s gate state."""
        rid = self._next_rid
        self._next_rid += 1
        srid = self.server.submit(self.lane, frame)
        self._rid[srid] = rid
        self._submitted += 1
        return rid

    def submit_many(self, frames) -> List[int]:
        return [self.submit(f) for f in frames]

    # -- dispatch side ------------------------------------------------------

    def _pick_variant(self, size: int) -> str:
        """Ask the operating-point policy for this dispatch's variant
        (family lanes only), after reporting the scene-activity EWMA; a
        switch drops the incoming variant's gate state (it caches the
        *other* operating point's logits and packing)."""
        if len(self.variants) == 1:
            return self._variant
        pol = self.server.policy
        pol.set_activity(self.lane, self._activity)
        variant = pol._choose(self.lane, self.server.queue.pending(self.lane),
                              size, pol.spent_uj, pol.chip_time_s)
        if variant != self._variant:
            self._state.pop(variant, None)        # cold-start the newcomer
            self._variant = variant
        return variant

    def _step_gated(self, reqs) -> List[TemporalResult]:
        """One gated dispatch: a batch through the delta kernel; every
        frame in it finalizes immediately (skipped slots carry their
        cached answer from the same kernel)."""
        srv = self.server
        t0 = srv.clock()
        size = srv.batch
        n = len(reqs)
        variant = self._pick_variant(size)
        unit = srv.executor.delta_for(variant, rb=self.rb,
                                      check_every=self.check_every)
        frames = srv.executor.pad_frames(reqs, srv._geom[self.lane], size)
        state = self._state.get(variant)
        if state is None:
            last, llog = unit["plan"].init_state(size, device=srv.device)
            ctrl = interpreter.DeltaPlan.delta_ctrl(float("-inf"), n)
        else:
            last, llog = state
            ctrl = interpreter.DeltaPlan.delta_ctrl(self.threshold, n)
        (lg, lb, new_last, new_llog, queue, counts,
         deltas) = unit["fn"](unit["image"], frames, last, llog, ctrl)
        self._state[variant] = (new_last, new_llog)
        lg, lb, queue, counts, deltas = (
            x.cpu().numpy() for x in (lg, lb, queue, counts, deltas))
        changed, slots = int(counts[0]), int(counts[1])
        # bill at launch like ChipServer._launch, but only what the chip
        # ran the network on: the slots the change queue drained (changed
        # streams + drain-chunk padding, from the kernel's own report).
        # Skipped frames never hit the array; their delta-compute toll is
        # billed in report() via energy.temporal_report.
        srv._bill(variant, changed, slots - changed)
        srv._dispatches += 1
        srv._util_sum += 1.0 / srv.programs[variant].s
        pol = srv.policy
        pol.variant_dispatches[variant] = (
            pol.variant_dispatches.get(variant, 0) + 1)
        if isinstance(pol, OperatingPointPolicy):
            # commit budget spend for the computed slots only — the gate's
            # savings are real savings against the energy budget
            pol.spent_uj += slots * pol._e1[variant]
            pol.chip_time_s += slots * pol._t1[variant]
        self.gated_dispatches += 1
        self._frames_total += n
        self._computed += changed
        self._computed_padded += slots - changed
        self._skipped += n - changed
        pv = self._per_variant.setdefault(variant, [0, 0, 0])
        pv[0] += n
        pv[1] += changed
        pv[2] += slots - changed
        a = self.activity_alpha
        self._activity = a * (changed / n) + (1.0 - a) * self._activity
        fresh = {int(g) for g in queue[:changed]}
        out = []
        for i, r in enumerate(reqs):
            out.append(TemporalResult(
                rid=self._rid.pop(r.rid), label=int(lb[i]),
                computed=i in fresh, delta=int(deltas[i]),
                variant=variant, logits=lg[i]))
        srv._host_wall_s += srv.clock() - t0
        return out

    def step(self) -> List[TemporalResult]:
        """One dispatch; returns the gated results it finalized.  When
        the lane has nothing queued, steps the server for other resident
        lanes (their results land in :attr:`other_results`); [] when
        there was nothing to run."""
        reqs = self.server.queue.take(self.lane, self.server.batch)
        if reqs:
            return self._step_gated(reqs)
        self.other_results.extend(self.server.step())
        return []

    def drain(self) -> List[TemporalResult]:
        """Serve until every submitted frame has an answer; results in
        finalization order."""
        out: List[TemporalResult] = []
        self.server.policy.set_flush(True)       # non-gated lanes too
        try:
            while True:
                got = self.step()
                out.extend(got)
                if not got and self.server.queue.pending() == 0:
                    return out
        finally:
            self.server.policy.set_flush(False)

    def reset(self) -> None:
        """Drop all resident gate state (scene change / stream restart):
        the next dispatch per variant recomputes everything."""
        self._state.clear()
        self._activity = 1.0

    # -- accounting ---------------------------------------------------------

    @property
    def submitted(self) -> int:
        return self._submitted

    @property
    def frames(self) -> int:
        return self._frames_total

    @property
    def computed(self) -> int:
        return self._computed

    @property
    def skipped(self) -> int:
        return self._skipped

    @property
    def skip_ratio(self) -> float:
        return self._skipped / self._frames_total if self._frames_total else 0.0

    @property
    def activity(self) -> float:
        """EWMA of the changed fraction per dispatch (1.0 until the
        first dispatch lands)."""
        return self._activity

    def calibrate(self, frames, target_agreement: float = 0.95) -> float:
        """Calibrate ``self.threshold`` on a held-out video trace via
        :func:`calibrate_delta_threshold` (the pipeline's own current
        operating point); returns — and adopts — the chosen threshold."""
        ex = self.server.executor
        self.threshold = calibrate_delta_threshold(
            frames, target_agreement,
            program=self.server.programs[self._variant],
            artifact=ex._raw_artifacts[self._variant], device=ex.device)
        return self.threshold

    def report(self) -> energy.TemporalReport:
        """The chip-model energy bill for everything served so far
        (:func:`energy.temporal_report`): every frame pays the
        delta-compute toll, computed slots pay full inference energy.
        A family lane's bill sums per-variant — each variant's frames at
        its own operating point's rates."""
        per = [(v, energy.temporal_report(
                    self.server.programs[v], fr, comp, computed_padded=cpad,
                    f_hz=self.server.f_hz))
               for v, (fr, comp, cpad) in sorted(self._per_variant.items())]
        if not per:
            return energy.temporal_report(
                self.server.programs[self._variant], 0, 0,
                f_hz=self.server.f_hz)
        if len(per) == 1:
            return per[0][1]
        frames = sum(r.frames for _, r in per)
        computed = sum(r.computed for _, r in per)
        cpad = sum(r.computed_padded for _, r in per)
        skipped = frames - computed
        total_uj = sum(r.frames * r.delta_uj
                       + (r.computed + r.computed_padded) * r.full_uj
                       for _, r in per)
        ungated_uj = sum(r.frames * r.full_uj for _, r in per)
        per_frame = total_uj / frames
        ungated = ungated_uj / frames
        return energy.TemporalReport(
            frames=frames, computed=computed, computed_padded=cpad,
            skipped=skipped, skip_ratio=skipped / frames,
            delta_uj=sum(r.frames * r.delta_uj for _, r in per) / frames,
            full_uj=ungated, uj_per_frame=per_frame,
            uj_per_frame_ungated=ungated,
            savings=ungated / per_frame if per_frame else float("inf"))
