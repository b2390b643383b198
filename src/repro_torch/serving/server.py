"""ChipServer: the thin composition of queue + policy + executor.

The counterpart of ``repro.serving.server`` for static-policy serving of
resident programs, one lane each, on one device:

* :mod:`repro_torch.serving.queue` — per-lane FIFOs + the round-robin
  pointer (who is next);
* :mod:`repro_torch.serving.policy` — which program variant serves the
  lane: :class:`StaticPolicy` (each lane its own program, shared-array
  groups composite) or :class:`OperatingPointPolicy` (program families
  served at the operating point an energy budget, the backlog and the
  scene activity call for);
* :mod:`repro_torch.serving.executor` — pad/dispatch/materialize + the
  depth-k prefetch pipeline;
* :class:`ChipServer` (this module) — wires them together and keeps the
  books (served/padded/billed and the chip-model energy bill via
  ``energy.serve_report``).

``megakernel=True`` runs dispatches through the whole-network kernel,
``prefetch=k`` pipelines submission to depth k, and ``shared=True`` forms
shared-array groups at admission (programs whose S-modes tile the array
exactly), each served as one composite launch per batch.  ``families=``
registers program families (variant sets of one task) behind a single
queue lane, served through the operating-point controller (``policy=`` /
``budget_uj_s=``).  The server runs on the GPU unless ``device="cpu"`` is
passed.  Options of ``repro``'s server that are not ported yet (the
continuous policy, serving meshes) raise ``NotImplementedError`` naming
their ROADMAP.md item rather than being ignored.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.chip import energy, interpreter, isa
from repro_torch.serving.executor import Executor
from repro_torch.serving.policy import (DispatchPolicy, OperatingPointPolicy,
                                        PolicyContext, StaticPolicy)
from repro_torch.serving.queue import (FrameQueue, FrameRequest, FrameResult,
                                       plan_shared_groups)


@dataclasses.dataclass(frozen=True)
class ServeStats:
    """Host-side counters + the chip-model bill for what was served."""
    served: Dict[str, int]            # lane -> frames served
    padded: Dict[str, int]            # lane -> padding slots burned
    billed: int                       # frame slots launched (served + padded)
    dispatches: int
    host_wall_s: float                # wall time inside dispatches
    host_frames_per_s: float
    chip: energy.ServeReport          # µJ/frame, frames/s, power analogue
    array_utilization: float = 0.0    # mean sum(1/S) of live sub-arrays
                                      # per dispatch (1.0 = full array)
    shared_dispatches: int = 0        # dispatches serving >= 2 programs
    policy: str = "static"
    variant_dispatches: Dict[str, int] = dataclasses.field(
        default_factory=dict)         # program -> dispatches it ran
    energy_uj: float = 0.0            # chip-model energy billed, all lanes
    budget_uj_s: Optional[float] = None
    downshift_ratio: float = 0.0      # family dispatches served below the
                                      # top operating point
    p50_ms: float = 0.0               # input-to-label latency percentiles
    p95_ms: float = 0.0               # over timestamped frames (0.0 when
    p99_ms: float = 0.0               # nothing was stamped)
    padding_ratio: float = 0.0        # burned slots / billed slots

    @property
    def total_served(self) -> int:
        return sum(self.served.values())


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"ChipServer option {option} is not ported yet (ROADMAP.md item "
        f"{item})")


class ChipServer:
    """Continuous static-batch serving of compiled ``InferencePlan``\\ s.

    ``programs`` maps resident-program names to validated ISA programs;
    ``artifacts`` maps the same names to their deployment artifacts (any
    form of ``fold_params``; float-folded ones are packed on admission).
    ``batch`` is the static dispatch size; ``prefetch`` takes a pipeline
    depth (``True`` = 1); ``shared=True`` forms shared-array composite
    groups at admission.

    ``families`` maps a family (task) name to a sequence of resident
    program names that are variants of one task — same input geometry and
    class count, different operating points (``networks.FAMILIES``,
    ``interpreter.compile_family``).  Frames are submitted to the *family*
    name; the policy picks the served variant.  With ``families`` the
    policy defaults to the operating-point controller (``budget_uj_s``
    caps the chip-model average power in uJ/s); ``policy`` takes a
    :class:`DispatchPolicy` instance or ``"static"`` /
    ``"operating-point"``.
    """

    def __init__(self, programs: Mapping[str, isa.Program],
                 artifacts: Mapping[str, Any], *, batch: int = 8,
                 megakernel: bool = False, prefetch: bool | int = False,
                 device=None, f_hz: float = energy.F_EMIN,
                 clock=time.perf_counter,
                 shared: bool = False,
                 families: Optional[Mapping[str, Sequence[str]]] = None,
                 policy: Optional[DispatchPolicy | str] = None,
                 budget_uj_s: Optional[float] = None,
                 mesh=None):
        if policy == "continuous":
            raise _not_ported("policy='continuous'", "4.3")
        if mesh is not None:
            raise _not_ported("mesh=", "1.8")
        if set(programs) != set(artifacts):
            raise ValueError(
                f"programs {sorted(programs)} != artifacts {sorted(artifacts)}")
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if int(prefetch) < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {prefetch}")
        self.batch = batch
        self.f_hz = f_hz
        self.prefetch = int(prefetch)        # pipeline depth, 0 = sync
        self.shared = shared
        self.clock = clock                   # injectable for latency tests
        self.programs: Dict[str, isa.Program] = dict(programs)

        # -- lanes: families collapse their variants behind one lane -------
        self._families: Dict[str, Tuple[str, ...]] = {}
        owned: Dict[str, str] = {}
        for fam, members in (families or {}).items():
            members = tuple(members)
            if fam in self.programs:
                raise ValueError(
                    f"family name {fam!r} collides with a resident "
                    "program name")
            missing = [m for m in members if m not in self.programs]
            if missing:
                raise ValueError(
                    f"family {fam!r} members {missing} not resident")
            for m in members:
                if m in owned:
                    raise ValueError(
                        f"program {m!r} belongs to families "
                        f"{owned[m]!r} and {fam!r}")
                owned[m] = fam
            # validates shared geometry/classes across the variants
            interpreter.compile_family({m: self.programs[m] for m in members})
            self._families[fam] = members
        self._lanes: Tuple[str, ...] = tuple(self._families) + tuple(
            n for n in self.programs if n not in owned)
        self._lane_variants: Dict[str, Tuple[str, ...]] = {
            **self._families,
            **{n: (n,) for n in self.programs if n not in owned}}

        # -- mechanism ------------------------------------------------------
        self.executor = Executor(self.programs, artifacts, batch=batch,
                                 megakernel=megakernel,
                                 prefetch=self.prefetch, device=device,
                                 clock=clock)
        self.device = self.executor.device
        self.plans = self.executor.plans
        self.artifacts = self.executor.artifacts
        self.queue = FrameQueue(self._lanes)
        self._geom = {lane: self.executor.geometry(vs[0])
                      for lane, vs in self._lane_variants.items()}

        # -- policy ---------------------------------------------------------
        groups: Dict[str, Tuple[str, ...]] = {}
        self._groups_plan: Tuple[Tuple[str, ...], ...] = ()
        if shared:
            self._groups_plan = plan_shared_groups(
                {n: self.programs[n] for n in self._lanes
                 if n in self.programs})
            for members in self._groups_plan:
                for m in members:
                    groups[m] = members
            self.executor.warm_composites(self._groups_plan)
        self.policy = self._make_policy(policy, budget_uj_s)
        self._reports = {n: energy.analyze_net(p, f_hz)
                         for n, p in self.programs.items()}
        self.policy.bind(PolicyContext(
            batch=batch, lanes=self._lanes,
            variants=dict(self._lane_variants),
            programs=dict(self.programs), reports=dict(self._reports),
            groups=groups, clock=clock))

        # -- accounting -----------------------------------------------------
        self._next_rid = 0
        self.reset_stats()

    def _make_policy(self, policy, budget_uj_s) -> DispatchPolicy:
        if isinstance(policy, DispatchPolicy):
            return policy
        if policy is None:
            policy = "operating-point" if self._families else "static"
        if policy == "static":
            if self._families:
                raise ValueError(
                    "families need a variant-choosing policy; use "
                    "policy='operating-point' (or drop families=)")
            return StaticPolicy()
        if policy == "operating-point":
            return OperatingPointPolicy(budget_uj_s=budget_uj_s,
                                        shared=self.shared)
        raise ValueError(f"unknown policy {policy!r} (have 'static', "
                         "'operating-point', or a DispatchPolicy)")

    @property
    def shared_groups(self) -> Tuple[Tuple[str, ...], ...]:
        """The compiled shared-array groups (empty unless ``shared=True``
        and some resident S-modes tile the array exactly)."""
        return self._groups_plan

    @property
    def families(self) -> Dict[str, Tuple[str, ...]]:
        return dict(self._families)

    # -- request side -------------------------------------------------------

    def submit(self, program: str, frame,
               t_submit: Optional[float] = None) -> int:
        """Enqueue one frame on a lane (program or family name); returns
        its request id (arrival order).  ``t_submit`` overrides the
        admission timestamp (``traffic.replay`` stamps the trace's
        arrival time); by default the server clock stamps *now*."""
        if program not in self._geom:
            raise KeyError(
                f"program {program!r} not resident "
                f"(have {sorted(self._geom)})")
        h, w, c = self._geom[program]
        frame = np.asarray(frame)
        if frame.shape != (h, w, c):
            raise ValueError(
                f"{program} expects frames of shape {(h, w, c)}, "
                f"got {frame.shape}")
        rid = self._next_rid
        self._next_rid += 1
        if t_submit is None:
            t_submit = self.clock()
        self.queue.submit(FrameRequest(rid=rid, program=program, frame=frame,
                                       t_submit=t_submit))
        return rid

    def submit_many(self, program: str, frames) -> List[int]:
        return [self.submit(program, f) for f in frames]

    # -- dispatch side ------------------------------------------------------

    def _launch(self) -> Optional[Dict[str, Any]]:
        """Consult the policy for the next dispatch, run it, and bill it.
        Serving counters are billed at launch — the energy is burned the
        moment the batch hits the array, synced or not."""
        dispatch = self.policy.select(self.queue)
        if dispatch is None:
            return None
        index = self._dispatches
        self._dispatches += 1
        handle = self.executor.launch(dispatch, index)
        size = dispatch.batch if dispatch.batch is not None else self.batch
        live = []
        for ld in dispatch.lanes:
            n = len(ld.requests)
            self._bill(ld.variant, n, size - n)
            if n:
                live.append(self.programs[ld.variant])
        if dispatch.composite:
            self._shared_dispatches += 1
            self._util_sum += energy.array_occupancy(live)
        else:
            self._util_sum += 1.0 / self.programs[
                dispatch.lanes[0].variant].s
        return handle

    def step(self) -> List[FrameResult]:
        """One dispatch: pull a static batch, run its program, return
        results for the real (non-padding) frames.  [] once drained.

        With ``prefetch=k`` up to k batches are staged and dispatched
        *before* blocking on the oldest one; batches still leave the queue
        in exactly the synchronous order.  All timing goes through
        ``self.clock``.
        """
        t0 = self.clock()
        try:
            results = self.executor.step(self._launch)
        finally:
            self._host_wall_s += self.clock() - t0
        for r in results:
            if r.latency_s > 0.0:
                self._latencies.append(r.latency_s)
        return results

    def drain(self) -> List[FrameResult]:
        """Serve until the queue is empty; results in dispatch order.  The
        policy is flushed for the duration."""
        out: List[FrameResult] = []
        self.policy.set_flush(True)
        try:
            while True:
                got = self.step()
                if not got and not len(self.queue):
                    return out
                out.extend(got)
        finally:
            self.policy.set_flush(False)

    def close(self) -> None:
        """Release the background fetch thread, syncing (and discarding —
        ``drain()`` first to collect them) any in-flight dispatches; safe
        to call more than once."""
        self.executor.close()

    # -- accounting ---------------------------------------------------------

    def _bill(self, variant: str, served: int, padded: int) -> None:
        """Bill ``served + padded`` frame slots launched on ``variant``:
        the one ledger every dispatch path (static, cascade, delta gate)
        writes.  Per-lane totals are derived from it in :meth:`stats`."""
        self._vserved[variant] += served
        self._vpadded[variant] += padded
        self._billed += served + padded

    def reset_stats(self) -> None:
        """Zero the serving counters and latency books, keeping all
        compiled state."""
        self._dispatches = 0
        self._shared_dispatches = 0
        self._util_sum = 0.0
        self._vserved = {name: 0 for name in self.programs}
        self._vpadded = {name: 0 for name in self.programs}
        self._host_wall_s = 0.0
        self._billed = 0                     # frame slots launched
        self._latencies: List[float] = []    # stamped input-to-label, s
        for v in self.policy.variant_dispatches:
            self.policy.variant_dispatches[v] = 0

    def stats(self) -> ServeStats:
        chip = energy.serve_report(self.programs, self._vserved,
                                   self._vpadded, f_hz=self.f_hz,
                                   reports=self._reports,
                                   billed=self._billed)
        served = {lane: sum(self._vserved[v] for v in vs)
                  for lane, vs in self._lane_variants.items()}
        padded = {lane: sum(self._vpadded[v] for v in vs)
                  for lane, vs in self._lane_variants.items()}
        total = sum(served.values())
        fps = total / self._host_wall_s if self._host_wall_s else 0.0
        util = self._util_sum / self._dispatches if self._dispatches else 0.0
        energy_uj = sum(
            (self._vserved[v] + self._vpadded[v])
            * self._reports[v].i2l_energy_per_inference * 1e6
            for v in self.programs)
        if self._latencies:
            p50, p95, p99 = np.percentile(self._latencies, [50, 95, 99])
        else:
            p50 = p95 = p99 = 0.0
        return ServeStats(served=served, padded=padded,
                          billed=self._billed,
                          dispatches=self._dispatches,
                          host_wall_s=self._host_wall_s,
                          host_frames_per_s=fps,
                          chip=chip,
                          array_utilization=util,
                          shared_dispatches=self._shared_dispatches,
                          policy=self.policy.name,
                          variant_dispatches=dict(
                              self.policy.variant_dispatches),
                          energy_uj=energy_uj,
                          budget_uj_s=getattr(self.policy, "budget_uj_s",
                                              None),
                          downshift_ratio=self.policy.downshift_ratio(),
                          p50_ms=float(p50) * 1e3,
                          p95_ms=float(p95) * 1e3,
                          p99_ms=float(p99) * 1e3,
                          padding_ratio=(sum(padded.values()) / self._billed
                                         if self._billed else 0.0))
