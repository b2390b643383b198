"""ChipServer: the thin composition of queue + policy + executor.

The counterpart of ``repro.serving.server`` for serving resident programs
on the GPU:

* :mod:`repro_torch.serving.queue` — per-lane FIFOs + the round-robin
  pointer (who is next);
* :mod:`repro_torch.serving.policy` — which program variant serves the
  lane, and when: :class:`StaticPolicy` (each lane its own program,
  shared-array groups composite), :class:`OperatingPointPolicy` (program
  families served at the operating point an energy budget, the backlog
  and the scene activity call for) or :class:`ContinuousPolicy` (an
  SLO-bounded admission window over either);
* :mod:`repro_torch.serving.executor` — pad/dispatch/materialize + the
  depth-k prefetch pipeline, over the replica's device group;
* :class:`ChipServer` (this module) — wires them together and keeps the
  books (served/padded/billed, the per-frame latency trace and the
  chip-model energy bill via ``energy.serve_report``).

``megakernel=True`` runs dispatches through the whole-network kernel,
``prefetch=k`` pipelines submission to depth k, and ``shared=True`` forms
shared-array groups at admission (programs whose S-modes tile the array
exactly), each served as one composite launch per batch.  ``families=``
registers program families (variant sets of one task) behind a single
queue lane, served through the operating-point controller (``policy=`` /
``budget_uj_s=``); ``policy="continuous"`` adds the admission window
(``slo_ms``).  ``mesh=`` (a tuple of devices,
``distributed.sharding.serve_mesh``) replicates the artifacts on every
device of the group and scatters each dispatch's frames over them.  The
server runs on the GPU unless ``device="cpu"`` (or a CPU mesh) is passed.
``repro``'s ``donate_frames`` and ``interpret`` have no PyTorch
counterpart and are not taken.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.chip import energy, interpreter, isa
from repro_torch.distributed import sharding
from repro_torch.serving.executor import Executor
from repro_torch.serving.policy import (ContinuousPolicy, DispatchPolicy,
                                        OperatingPointPolicy, PolicyContext,
                                        StaticPolicy)
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
    dispatch_sizes: Dict[int, int] = dataclasses.field(
        default_factory=dict)         # pad target -> dispatches launched

    @property
    def total_served(self) -> int:
        return sum(self.served.values())


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
    ``"operating-point"`` / ``"continuous"`` (the admission window of
    ``slo_ms`` over the static or, with families, the operating-point
    policy).  ``mesh`` is the replica's device group: ``batch`` must
    divide over it, and continuous dispatch sizes come in multiples of its
    size.  ``warm_start`` builds every serving unit through the warm-start
    cache (``kernels/cache.py``).
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
                 mesh=None, slo_ms: float = 50.0, warm_start: bool = True):
        if set(programs) != set(artifacts):
            raise ValueError(
                f"programs {sorted(programs)} != artifacts {sorted(artifacts)}")
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if int(prefetch) < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {prefetch}")
        ndev = len(mesh) if mesh is not None else 1
        if batch % ndev:
            raise ValueError(
                f"static batch {batch} must divide over the "
                f"{ndev}-device serving mesh")
        if mesh is not None and device is not None and \
                torch.device(device) != torch.device(mesh[0]):
            raise ValueError(f"device {device} is not the first device of "
                             f"the serving mesh {tuple(mesh)}")
        self.batch = batch
        self.slo_ms = slo_ms
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
        self.mesh = (sharding.serve_mesh(mesh) if mesh is not None
                     else (_device.resolve(device),))
        self.device = self.mesh[0]
        self.executor = Executor(self.programs, artifacts, batch=batch,
                                 devices=self.mesh, megakernel=megakernel,
                                 prefetch=self.prefetch,
                                 warm_start=warm_start, clock=clock)
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
            groups=groups, quantum=ndev, clock=clock))

        # -- accounting -----------------------------------------------------
        self.failed = False                  # set by fail(); fleets skip it
        self.aborted_inflight = 0            # in-flight frames fail() dropped
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
        if policy == "continuous":
            inner = (OperatingPointPolicy(budget_uj_s=budget_uj_s,
                                          shared=self.shared)
                     if self._families else StaticPolicy())
            return ContinuousPolicy(slo_ms=self.slo_ms, inner=inner)
        raise ValueError(f"unknown policy {policy!r} (have 'static', "
                         "'operating-point', 'continuous', or a "
                         "DispatchPolicy)")

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
               t_submit: Optional[float] = None,
               rid: Optional[int] = None) -> int:
        """Enqueue one frame on a lane (program or family name); returns
        its request id (arrival order).  ``t_submit`` overrides the
        admission timestamp (``traffic.replay`` stamps the trace's
        arrival time); by default the server clock stamps *now*.  ``rid``
        overrides the locally assigned id: a fleet hands out fleet-wide
        ids, so results from different replicas never collide."""
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
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        else:
            self._next_rid = max(self._next_rid, rid + 1)
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
        self._sizes[size] = self._sizes.get(size, 0) + 1
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
        ``self.clock``: ``_host_wall_s``, ``t_submit``, ``t_done`` and the
        latency trace share it, so a ``VirtualClock`` replay never mixes
        in wall time.
        """
        t0 = self.clock()
        try:
            results = self.executor.step(self._launch)
        finally:
            self._host_wall_s += self.clock() - t0
        for r in results:
            if r.t_submit <= 0.0 or r.t_done <= 0.0:
                continue                     # unstamped: no latency account
            lat = r.t_done - r.t_submit
            self._latencies.append(lat)
            self._trace.append(dict(
                rid=r.rid, lane=r.program, variant=r.variant,
                dispatch=r.dispatch, t_submit=r.t_submit,
                t_done=r.t_done, latency_ms=lat * 1e3))
        return results

    def drain(self) -> List[FrameResult]:
        """Serve until the queue is empty; results in dispatch order.  The
        policy is flushed for the duration: a continuous policy's
        admission window never holds the final ragged batches back."""
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

    def fail(self) -> Dict[str, List[FrameRequest]]:
        """Simulated host loss: kill this replica and hand back every
        frame it had not finished serving, grouped by lane with order
        preserved (in-flight dispatches oldest-first, then the queued
        FIFO).  The energy already billed for abandoned in-flight
        dispatches stays billed — it was burned the moment the batch hit
        the array — so this replica's ``billed == served + padded`` ledger
        stays consistent; whoever serves the migrated frames bills them
        again.  The server is unusable afterwards."""
        orphans: Dict[str, List[FrameRequest]] = {
            lane: [] for lane in self._lanes}
        inflight = self.executor.abort()        # in-flight, oldest first
        self.aborted_inflight = len(inflight)   # the fleet's refired count
        for req in inflight:
            orphans[req.program].append(req)
        for lane in self._lanes:                # then the queued backlog
            while True:
                got = self.queue.take(lane, self.batch)
                if not got:
                    break
                orphans[lane].extend(got)
        self.failed = True
        return {lane: reqs for lane, reqs in orphans.items() if reqs}

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
        self._trace: List[Dict[str, Any]] = []   # per-frame latency trace
        self._sizes: Dict[int, int] = {}     # pad target -> dispatches
        for v in self.policy.variant_dispatches:
            self.policy.variant_dispatches[v] = 0

    def latency_trace(self) -> List[Dict[str, Any]]:
        """Per-frame admission-to-label records (stamped frames only), in
        completion order."""
        return list(self._trace)

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
                                         if self._billed else 0.0),
                          dispatch_sizes=dict(sorted(self._sizes.items())))
