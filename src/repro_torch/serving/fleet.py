"""ServeFleet: N chip replicas, host-major scatter, failover migration.

One BinarEye die is a complete serving unit — weights in SRAM,
instructions in program memory, frames in and labels out.  A deployment
that needs more throughput (or availability) than one die runs a *board*
of them: identical images, each chip serving its share of the stream.
The counterpart of ``repro.serving.fleet``: a :class:`ServeFleet` runs N
:class:`~repro_torch.serving.server.ChipServer` replicas — "simulated
hosts" over disjoint device groups
(:func:`repro_torch.distributed.sharding.partition_serve_meshes`; with
fewer devices than replicas they share devices, as on a one-card machine)
— behind the same ``submit/step/drain`` surface a single server exposes,
so :func:`repro_torch.serving.traffic.replay` drives a fleet unmodified.

* **Scatter** — admitted frames route host-major: each lane hands out
  blocks of ``batch`` consecutive frames to the live replicas in
  rotation, so replicas receive whole dispatches, not interleaved
  singles.  Request ids are fleet-global (the fleet stamps them; replicas
  accept them via ``submit(rid=...)``).
* **Failover** — a pluggable :class:`FaultInjector` kills a replica
  mid-replay.  The victim's unfinished frames (in-flight dispatches
  first, then its queued FIFO — order preserved) migrate to the
  survivors' lane *fronts* (:meth:`FrameQueue.requeue_front`): they are
  older than anything admitted after the failure, so they serve first.
  Served labels stay bit-exact with zero frame loss; energy the victim
  billed for abandoned in-flight work stays billed and migrated in-flight
  frames are billed again by whoever serves them (``refired_frames``).
* **Replacement** — with ``replace=True`` a failed host is rebuilt on its
  own devices: the device layout comes back through the
  restore-after-fault path (:func:`repro_torch.checkpoint.ckpt.make_mesh`)
  and the bring-up runs under :func:`repro_torch.distributed.fault.
  retry_step` with deterministic exponential backoff (injectable sleep).
  Because serving units are built through the warm-start cache
  (:mod:`repro_torch.kernels.cache`), a replacement on the same keys and
  artifacts skips plan compilation and the artifact upload — the
  kill-to-first-served-frame time is :attr:`ServeFleet.recovery_ms`.
* **Stats** — :meth:`stats` merges per-replica books into
  :class:`FleetStats`: latency percentiles recomputed over the merged
  traces, served/padded/billed/energy summed (fleet-wide ``billed ==
  served + padded`` holds because it holds per replica), and the
  chip-model bill aggregated by :func:`energy.fleet_report`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import ckpt
from repro_torch.core.chip import energy, isa
from repro_torch.distributed import fault, sharding
from repro_torch.kernels import cache as warmcache
from repro_torch.serving.queue import FrameRequest, FrameResult
from repro_torch.serving.server import ChipServer, ServeStats


class FaultInjector:
    """Kill ``victim`` once the fleet has served ``after_served`` frames.

    The base injector fires exactly once, from :meth:`ServeFleet.step`
    (i.e. mid-replay when a traffic replay is driving the fleet).
    Subclass and override :meth:`poll` for richer schedules — return a
    live replica name to kill it now, ``None`` to do nothing.
    """

    def __init__(self, victim: str, after_served: int = 0):
        self.victim = victim
        self.after_served = after_served
        self.fired = False

    def poll(self, fleet: "ServeFleet") -> Optional[str]:
        if (not self.fired and fleet.total_served >= self.after_served
                and self.victim in fleet.live_replicas):
            self.fired = True
            return self.victim
        return None


@dataclasses.dataclass(frozen=True)
class FleetStats:
    """Fleet-level books: per-replica stats plus the merged bill."""
    replicas: Dict[str, ServeStats]   # replica name -> its own books
    served: Dict[str, int]            # lane -> frames served, fleet-wide
    padded: Dict[str, int]            # lane -> padding burned, fleet-wide
    dispatches: int
    host_wall_s: float                # sum of replica dispatch wall time
                                      # (replicas share this process)
    host_frames_per_s: float
    chip: energy.FleetReport          # chip-model bill, N dies in parallel
    billed: int                       # frame slots launched fleet-wide
    p50_ms: float = 0.0               # percentiles over the MERGED traces
    p95_ms: float = 0.0               # (not averaged per-replica numbers)
    p99_ms: float = 0.0
    padding_ratio: float = 0.0
    energy_uj: float = 0.0
    migrated_frames: int = 0          # orphans moved to survivors
    refired_frames: int = 0           # migrated frames that were in flight
                                      # on the victim (billed twice)
    failed_replicas: Tuple[str, ...] = ()
    recovery_ms: Optional[float] = None   # kill -> replacement's first
                                          # served frame (None: no
                                          # replacement has served yet)
    warm_start: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def total_served(self) -> int:
        return sum(self.served.values())


class ServeFleet:
    """N ChipServer replicas behind one ``submit/step/drain`` surface.

    Replica names come out as ``host0..host{N-1}``; replacements append a
    generation suffix (``host1r1``).  ``devices`` (default: every CUDA
    device; ``["cpu"]`` for the CPU) are partitioned host-major into
    per-replica groups; with fewer devices than replicas the replicas
    share devices.  All per-server options (``shared``/``policy``/
    ``families``/``prefetch``/``megakernel``/...) pass through
    ``**server_kw`` to every replica; every replica shares the fleet's
    injected ``clock``.

    ``injector`` arms a :class:`FaultInjector`; ``replace=True`` rebuilds
    a killed host (``retries``/``backoff_s``/``sleep`` parameterize the
    :func:`~repro_torch.distributed.fault.retry_step` bring-up loop).
    """

    def __init__(self, programs: Mapping[str, isa.Program],
                 artifacts: Mapping[str, Any], *, replicas: int = 2,
                 batch: int = 8, devices=None,
                 injector: Optional[FaultInjector] = None,
                 replace: bool = False, retries: int = 2,
                 backoff_s: float = 0.0,
                 sleep=time.sleep, clock=time.perf_counter,
                 **server_kw):
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        self.clock = clock
        self.injector = injector
        self.replace = replace
        self._retries = retries
        self._backoff_s = backoff_s
        self._sleep = sleep
        self._programs = dict(programs)
        self._artifacts = dict(artifacts)
        self._server_kw = dict(server_kw, batch=batch, clock=clock)
        self.batch = batch
        meshes = sharding.partition_serve_meshes(replicas, devices)
        self.replicas: Dict[str, ChipServer] = {}
        self._devices: Dict[str, list] = {}
        self._live: List[str] = []
        for i, mesh in enumerate(meshes):
            name = f"host{i}"
            self.replicas[name] = ChipServer(
                self._programs, self._artifacts, mesh=mesh,
                **self._server_kw)
            self._devices[name] = list(mesh)
            self._live.append(name)
        self.lanes = self.replicas[self._live[0]].queue.lanes
        # -- books ----------------------------------------------------------
        self._next_rid = 0
        self._routed: Dict[str, int] = {lane: 0 for lane in self.lanes}
        self._dead: Dict[str, ChipServer] = {}    # victims keep their books
        self._migrated = 0
        self._refired = 0
        self.retry_stats: Dict[str, Any] = {}     # retry_step's out-dict
        self._recovery: Optional[Dict[str, Any]] = None

    # -- surface (duck-types ChipServer for traffic.replay) -----------------

    @property
    def live_replicas(self) -> Tuple[str, ...]:
        return tuple(self._live)

    @property
    def failed_replicas(self) -> Tuple[str, ...]:
        return tuple(self._dead)

    @property
    def total_served(self) -> int:
        return sum(sum(s._vserved.values())
                   for s in list(self.replicas.values())
                   + list(self._dead.values()))

    def _route(self, lane: str) -> str:
        """Host-major block scatter: blocks of ``batch`` consecutive
        admissions on a lane go to one live replica, rotating."""
        i = self._routed[lane]
        self._routed[lane] = i + 1
        return self._live[(i // self.batch) % len(self._live)]

    def submit(self, program: str, frame,
               t_submit: Optional[float] = None) -> int:
        """Enqueue one frame; the fleet assigns the (global) request id
        and routes the frame to a live replica."""
        rid = self._next_rid
        target = self.replicas[self._route(program)]
        target.submit(program, frame, t_submit=t_submit, rid=rid)
        self._next_rid += 1
        return rid

    def submit_many(self, program: str, frames) -> List[int]:
        return [self.submit(program, f) for f in frames]

    def step(self) -> List[FrameResult]:
        """One fleet tick: poll the fault injector, then one dispatch on
        every live replica.  Results are the concatenation, replica
        order; [] once every replica is drained."""
        if self.injector is not None:
            victim = self.injector.poll(self)
            if victim is not None:
                self.fail(victim)
        out: List[FrameResult] = []
        for name in list(self._live):
            got = self.replicas[name].step()
            if got and self._recovery is not None and \
                    self._recovery["t_first"] is None and \
                    name == self._recovery["replica"]:
                self._recovery["t_first"] = self.clock()
            out.extend(got)
        return out

    def drain(self) -> List[FrameResult]:
        """Serve until every live replica's queue is empty."""
        out: List[FrameResult] = []
        flushed = set()

        def flush_live():
            # replacements spawned mid-drain must flush too
            for name in self._live:
                if name not in flushed:
                    self.replicas[name].policy.set_flush(True)
                    flushed.add(name)

        flush_live()
        try:
            while True:
                got = self.step()
                flush_live()
                out.extend(got)
                if got:
                    continue
                if not any(len(self.replicas[n].queue)
                           for n in self._live):
                    return out
        finally:
            for name in flushed:
                if name in self.replicas:
                    self.replicas[name].policy.set_flush(False)

    def close(self) -> None:
        for name in self._live:
            self.replicas[name].close()

    # -- failover -----------------------------------------------------------

    def fail(self, name: str) -> Dict[str, List[FrameRequest]]:
        """Kill replica ``name``: harvest its unfinished frames, migrate
        them to the survivors' lane fronts, and (with ``replace=True``)
        bring up a replacement host on the victim's devices.  Returns
        the migrated orphans by lane (order as re-enqueued)."""
        if name not in self.replicas or name in self._dead:
            raise KeyError(f"replica {name!r} not live "
                           f"(live: {self._live})")
        t_kill = self.clock()
        victim = self.replicas.pop(name)
        self._live.remove(name)
        orphans = victim.fail()
        self._dead[name] = victim        # its ledger stays in the bill
        for reqs in orphans.values():
            self._migrated += len(reqs)
        self._refired += victim.aborted_inflight
        if self.replace:
            self._spawn_replacement(name, t_kill)
        if not self._live:
            raise RuntimeError(
                f"replica {name!r} failed with no survivors; its "
                f"{sum(map(len, orphans.values()))} frames are lost")
        # older-than-anything-admitted-since: front of a survivor's lane,
        # one survivor per lane (rotating) so migration stays balanced
        # without interleaving a lane's orphans across hosts
        for i, (lane, reqs) in enumerate(sorted(orphans.items())):
            survivor = self.replicas[self._live[i % len(self._live)]]
            survivor.queue.requeue_front(lane, reqs)
        return orphans

    def _spawn_replacement(self, dead_name: str, t_kill: float) -> None:
        """Rebuild a host on the victim's devices via the
        restore-after-fault layout, retrying with backoff."""
        devs = self._devices[dead_name]
        gen = 1
        name = f"{dead_name}r{gen}"
        while name in self.replicas or name in self._dead:
            gen += 1
            name = f"{dead_name}r{gen}"

        def build() -> ChipServer:
            mesh = ckpt.make_mesh((len(devs),), (sharding.SERVE_AXIS,),
                                  devices=devs)
            return ChipServer(self._programs, self._artifacts,
                              mesh=tuple(mesh.devices.flat),
                              **self._server_kw)

        self.retry_stats = {}
        replacement = fault.retry_step(
            build, retries=self._retries, backoff_s=self._backoff_s,
            sleep=self._sleep, stats=self.retry_stats)
        self.replicas[name] = replacement
        self._devices[name] = devs
        self._live.append(name)
        self._recovery = dict(replica=name, t_kill=t_kill, t_first=None)

    @property
    def recovery_ms(self) -> Optional[float]:
        """Kill-to-first-served-frame of the latest replacement replica
        (fleet clock); None until a replacement has served a frame."""
        if self._recovery is None or self._recovery["t_first"] is None:
            return None
        return (self._recovery["t_first"] - self._recovery["t_kill"]) * 1e3

    # -- accounting ---------------------------------------------------------

    def latency_trace(self) -> List[Dict[str, Any]]:
        """Merged per-frame traces of every replica (dead ones included),
        each record tagged with its serving replica, completion order
        within a replica preserved."""
        out: List[Dict[str, Any]] = []
        for name, server in list(self.replicas.items()) + \
                list(self._dead.items()):
            for rec in server.latency_trace():
                out.append(dict(rec, replica=name))
        return out

    def stats(self) -> FleetStats:
        """Merge every replica's books (victims included — their energy
        was spent) into the fleet bill."""
        per: Dict[str, ServeStats] = {}
        for name, server in list(self.replicas.items()) + \
                list(self._dead.items()):
            per[name] = server.stats()
        served: Dict[str, int] = {lane: 0 for lane in self.lanes}
        padded: Dict[str, int] = {lane: 0 for lane in self.lanes}
        for st in per.values():
            for lane in self.lanes:
                served[lane] += st.served.get(lane, 0)
                padded[lane] += st.padded.get(lane, 0)
        dispatches = sum(st.dispatches for st in per.values())
        wall = sum(st.host_wall_s for st in per.values())
        billed = sum(st.billed for st in per.values())
        lats = [rec["latency_ms"] for rec in self.latency_trace()]
        if lats:
            p50, p95, p99 = np.percentile(lats, [50, 95, 99])
        else:
            p50 = p95 = p99 = 0.0
        total = sum(served.values())
        pad_total = sum(padded.values())
        return FleetStats(
            replicas=per, served=served, padded=padded,
            dispatches=dispatches, host_wall_s=wall,
            host_frames_per_s=(total / wall) if wall else 0.0,
            chip=energy.fleet_report({n: st.chip for n, st in per.items()}),
            billed=billed,
            p50_ms=float(p50), p95_ms=float(p95), p99_ms=float(p99),
            padding_ratio=(pad_total / billed) if billed else 0.0,
            energy_uj=sum(st.energy_uj for st in per.values()),
            migrated_frames=self._migrated,
            refired_frames=self._refired,
            failed_replicas=self.failed_replicas,
            recovery_ms=self.recovery_ms,
            warm_start=warmcache.stats())
