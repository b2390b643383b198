"""ChipServer: the thin composition of queue + policy + executor.

The counterpart of ``repro.serving.server`` for static-policy serving of
resident programs, one lane each, on one device:

* :mod:`repro_torch.serving.queue` — per-lane FIFOs + the round-robin
  pointer (who is next);
* :mod:`repro_torch.serving.policy` — :class:`StaticPolicy`: every lane
  is served by its own program;
* :mod:`repro_torch.serving.executor` — pad/dispatch/materialize + the
  depth-k prefetch pipeline;
* :class:`ChipServer` (this module) — wires them together and keeps the
  books (served/padded/billed and the chip-model energy bill via
  ``energy.serve_report``).

``megakernel=True`` runs dispatches through the whole-network kernel,
``prefetch=k`` pipelines submission to depth k.  The server runs on the
GPU unless ``device="cpu"`` is passed.  Options of ``repro``'s server that
this slice does not port (shared-array groups, program families and their
policies, serving meshes) raise ``NotImplementedError`` naming their
ROADMAP.md item rather than being ignored.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from repro_torch.core.chip import energy, isa
from repro_torch.serving.executor import Executor
from repro_torch.serving.policy import PolicyContext, StaticPolicy
from repro_torch.serving.queue import FrameQueue, FrameRequest, FrameResult


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
    array_utilization: float = 0.0    # mean 1/S of the dispatched programs
    policy: str = "static"
    variant_dispatches: Dict[str, int] = dataclasses.field(
        default_factory=dict)         # program -> dispatches it ran
    energy_uj: float = 0.0            # chip-model energy billed, all lanes
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
    depth (``True`` = 1).
    """

    def __init__(self, programs: Mapping[str, isa.Program],
                 artifacts: Mapping[str, Any], *, batch: int = 8,
                 megakernel: bool = False, prefetch: bool | int = False,
                 device=None, f_hz: float = energy.F_EMIN,
                 clock=time.perf_counter,
                 shared: bool = False, families=None, policy=None,
                 mesh=None):
        if shared:
            raise _not_ported("shared=True", "1.5")
        if families or policy not in (None, "static"):
            raise _not_ported("families=/policy=", "4.3")
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
        self.clock = clock                   # injectable for latency tests
        self.programs: Dict[str, isa.Program] = dict(programs)
        self._lanes = tuple(self.programs)

        # -- mechanism ------------------------------------------------------
        self.executor = Executor(self.programs, artifacts, batch=batch,
                                 megakernel=megakernel,
                                 prefetch=self.prefetch, device=device,
                                 clock=clock)
        self.device = self.executor.device
        self.plans = self.executor.plans
        self.artifacts = self.executor.artifacts
        self.queue = FrameQueue(self._lanes)
        self._geom = {lane: self.executor.geometry(lane)
                      for lane in self._lanes}

        # -- policy ---------------------------------------------------------
        self.policy = StaticPolicy()
        self._reports = {n: energy.analyze_net(p, f_hz)
                         for n, p in self.programs.items()}
        self.policy.bind(PolicyContext(
            batch=batch, lanes=self._lanes,
            variants={n: (n,) for n in self._lanes},
            programs=dict(self.programs), reports=dict(self._reports),
            groups={}, clock=clock))

        # -- accounting -----------------------------------------------------
        self._next_rid = 0
        self.reset_stats()

    # -- request side -------------------------------------------------------

    def submit(self, program: str, frame) -> int:
        """Enqueue one frame on a lane, stamped with the server clock;
        returns its request id (arrival order)."""
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
        self.queue.submit(FrameRequest(rid=rid, program=program, frame=frame,
                                       t_submit=self.clock()))
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
        ld, = dispatch.lanes
        n = len(ld.requests)
        self._served[ld.lane] += n
        self._padded[ld.lane] += size - n
        self._billed += size
        self._util_sum += 1.0 / self.programs[ld.variant].s
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
        """Serve until the queue is empty; results in dispatch order."""
        out: List[FrameResult] = []
        while True:
            got = self.step()
            if not got and not len(self.queue):
                return out
            out.extend(got)

    def close(self) -> None:
        """Release the background fetch thread, syncing (and discarding —
        ``drain()`` first to collect them) any in-flight dispatches; safe
        to call more than once."""
        self.executor.close()

    # -- accounting ---------------------------------------------------------

    def reset_stats(self) -> None:
        """Zero the serving counters and latency books, keeping all
        compiled state."""
        self._dispatches = 0
        self._util_sum = 0.0
        self._served = {lane: 0 for lane in self._lanes}
        self._padded = {lane: 0 for lane in self._lanes}
        self._host_wall_s = 0.0
        self._billed = 0                     # frame slots launched
        self._latencies: List[float] = []    # stamped input-to-label, s
        for v in self.policy.variant_dispatches:
            self.policy.variant_dispatches[v] = 0

    def stats(self) -> ServeStats:
        chip = energy.serve_report(self.programs, self._served,
                                   self._padded, f_hz=self.f_hz,
                                   reports=self._reports,
                                   billed=self._billed)
        total = sum(self._served.values())
        fps = total / self._host_wall_s if self._host_wall_s else 0.0
        util = self._util_sum / self._dispatches if self._dispatches else 0.0
        energy_uj = sum(
            (self._served[v] + self._padded[v])
            * self._reports[v].i2l_energy_per_inference * 1e6
            for v in self.programs)
        if self._latencies:
            p50, p95, p99 = np.percentile(self._latencies, [50, 95, 99])
        else:
            p50 = p95 = p99 = 0.0
        padded = sum(self._padded.values())
        return ServeStats(served=dict(self._served),
                          padded=dict(self._padded),
                          billed=self._billed,
                          dispatches=self._dispatches,
                          host_wall_s=self._host_wall_s,
                          host_frames_per_s=fps,
                          chip=chip,
                          array_utilization=util,
                          policy=self.policy.name,
                          variant_dispatches=dict(
                              self.policy.variant_dispatches),
                          energy_uj=energy_uj,
                          p50_ms=float(p50) * 1e3,
                          p95_ms=float(p95) * 1e3,
                          p99_ms=float(p99) * 1e3,
                          padding_ratio=(padded / self._billed
                                         if self._billed else 0.0))
