"""Dispatch policies: *what to run next* on the serving mechanism.

The counterpart of ``repro.serving.policy``, copied apart from imports:

* :class:`DispatchPolicy` — the interface: given the queue, return the
  next :class:`Dispatch` (which lane(s), which resident program variant
  per lane, which frames).  The mechanism guarantees whatever the policy
  selects is executed and billed; the policy guarantees fairness (it must
  serve the round-robin head lane and advance the pointer past it).
* :class:`StaticPolicy` — every lane is served by its own program;
  lanes of a shared-array group (``ChipServer(shared=True)``) dispatch
  together as one composite.
* :class:`OperatingPointPolicy` — the paper's energy-accuracy controller:
  lanes are program *families* (one task compiled at several operating
  points, ``networks.FAMILIES``), and the controller picks the served
  variant per dispatch from an energy budget (uJ/s of chip time), the
  lane's backlog and, when a temporal runtime reports it, the scene's
  activity.  With ``shared=True`` other backlogged lanes whose chosen
  variants tile the array exactly ride the same dispatch as a composite.
* :class:`ContinuousPolicy` — rolling/continuous batching: an
  SLO-bounded admission window autoscales the dispatch size against the
  lane's measured EWMA arrival rate and launches early-and-small when the
  oldest queued frame's deadline approaches; *what* runs the frames is
  left to an ``inner`` policy.  Sizes are quantised onto the ladder
  ``{q, 2q, 4q, ..., batch}`` (``q`` the serving group's device count).

Budget semantics: the controller commits every dispatch's chip-model
energy and time at *selection* and picks the most accurate variant whose
inclusion keeps ``spent_uj / chip_time_s`` at or under ``budget_uj_s``;
when none fits it pins to the cheapest, so for any feasible budget the
spend never exceeds the allowance by more than one dispatch.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.chip import energy, isa
from repro_torch.serving.queue import FrameQueue, FrameRequest


@dataclasses.dataclass(frozen=True)
class LaneDispatch:
    """One lane's share of a dispatch: the frames pulled from ``lane``
    and the resident program ``variant`` that will run them.  For static
    lanes ``variant == lane``; an empty ``requests`` tuple means the lane
    rides a composite as pure padding (its sub-array burns the batch)."""
    lane: str
    variant: str
    requests: Tuple[FrameRequest, ...]


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """A policy decision: one batch per member lane, executed as one
    array pass (solo for a single lane, a shared-array composite for
    several).  ``batch`` is this dispatch's pad target — every member
    lane's pull is padded to it; ``None`` means the server's static
    batch (the pre-continuous behaviour)."""
    lanes: Tuple[LaneDispatch, ...]
    batch: Optional[int] = None

    @property
    def composite(self) -> bool:
        return len(self.lanes) > 1


@dataclasses.dataclass(frozen=True)
class PolicyContext:
    """Everything a policy may consult, bound once by the server."""
    batch: int                                  # max/static dispatch size
    lanes: Tuple[str, ...]                      # queue lanes (RR order)
    variants: Dict[str, Tuple[str, ...]]        # lane -> its variants
    programs: Dict[str, isa.Program]            # variant -> ISA program
    reports: Dict[str, energy.NetReport]        # variant -> chip model
    groups: Dict[str, Tuple[str, ...]]          # lane -> shared group
    quantum: int = 1                            # dispatch sizes must be
                                                # multiples of this (the
                                                # serve mesh device count)
    clock: Any = time.perf_counter              # the server's clock


class DispatchPolicy:
    """Base policy: subclasses implement :meth:`select`.

    ``bind`` is called once by the server before serving starts;
    ``variant_dispatches`` is read back into ``ServeStats`` so callers
    can see which operating points actually ran.
    """

    name = "policy"

    def __init__(self) -> None:
        self.ctx: Optional[PolicyContext] = None
        self.variant_dispatches: Dict[str, int] = {}
        self.flush = False              # drain mode: never hold frames back

    def bind(self, ctx: PolicyContext) -> None:
        self.ctx = ctx
        self.variant_dispatches = {v: 0 for v in ctx.programs}
        self.flush = False
        self._bound()

    def _bound(self) -> None:       # subclass hook
        pass

    def set_flush(self, flush: bool) -> None:
        """Drain mode: a flushing policy must dispatch whatever is queued
        rather than wait for its window/deadline conditions."""
        self.flush = flush

    def select(self, queue: FrameQueue) -> Optional[Dispatch]:
        raise NotImplementedError

    def select_sized(self, queue: FrameQueue,
                     size: int) -> Optional[Dispatch]:
        """Like :meth:`select` but with the dispatch pad target forced to
        ``size`` (the continuous layer's autoscaled batch).  Policies that
        support batch autoscaling override; the base implementation
        ignores ``size`` and keeps the static batch."""
        return self.select(queue)

    def _count(self, dispatch: Dispatch) -> Dispatch:
        for ld in dispatch.lanes:
            self.variant_dispatches[ld.variant] = (
                self.variant_dispatches.get(ld.variant, 0) + 1)
        return dispatch

    def variant_order(self, lane: str) -> Tuple[str, ...]:
        """The lane's variants, best operating point first — the order
        ``downshift_ratio`` measures against.  The base policy uses the
        registered declaration order; subclasses that re-rank (the
        operating-point controller sorts energy-descending) override."""
        return self.ctx.variants[lane]

    def downshift_ratio(self) -> float:
        """Over multi-variant (family) lanes: the fraction of dispatches
        served below the lane's top operating point."""
        if self.ctx is None:
            return 0.0
        total = below = 0
        for lane in self.ctx.lanes:
            order = self.variant_order(lane)
            if len(order) < 2:
                continue
            total += sum(self.variant_dispatches.get(v, 0) for v in order)
            below += sum(self.variant_dispatches.get(v, 0)
                         for v in order[1:])
        return below / total if total else 0.0


class StaticPolicy(DispatchPolicy):
    """Serve every lane with its own program; shared-array groups
    dispatch as composites when >= 2 members are backlogged (including
    idle members, whose sub-arrays burn their batch — the always-on
    array never idles).  Exactly the pre-policy scheduler."""

    name = "static"

    def select(self, queue: FrameQueue) -> Optional[Dispatch]:
        return self.select_sized(queue, self.ctx.batch)

    def select_sized(self, queue: FrameQueue,
                     size: int) -> Optional[Dispatch]:
        pulled = queue.next_batch_shared(size, self.ctx.groups)
        if pulled is None:
            return None
        if len(pulled) > 1:
            # composite dispatch: every group member's sub-array runs this
            # batch — backlogged lanes carry frames, the rest burn padding.
            members = self.ctx.groups[next(iter(pulled))]
            lanes = tuple(LaneDispatch(m, m, tuple(pulled.get(m, ())))
                          for m in members)
        else:
            (name, reqs), = pulled.items()
            lanes = (LaneDispatch(name, name, tuple(reqs)),)
        batch = None if size == self.ctx.batch else size
        return self._count(Dispatch(lanes, batch=batch))


class OperatingPointPolicy(DispatchPolicy):
    """The energy-accuracy operating-point controller (paper Fig. 5).

    Per family lane the variants are held energy-descending (= accuracy
    descending along the Pareto front, see ``energy.operating_points``);
    each dispatch picks the most accurate variant affordable under
    ``budget_uj_s`` and downshifts one extra step when the lane's backlog
    reaches ``backlog_high`` frames (catching up at a cheaper, faster
    point).  With ``shared=True`` other backlogged lanes whose chosen
    variants tile the 256-channel array exactly ride the same dispatch
    as an on-the-fly composite.

    A temporal runtime (``serving/temporal.py``) may additionally report
    each lane's *scene activity* — the fraction of its streams whose
    frame delta crossed the gate threshold — via :meth:`set_activity`;
    a lane whose activity sits below ``activity_low`` downshifts one
    extra step (a quiet scene needs neither the accuracy nor the energy
    of the top operating point).  Lanes that never report activity are
    untouched.
    """

    name = "operating-point"

    def __init__(self, budget_uj_s: Optional[float] = None,
                 backlog_high: Optional[int] = None,
                 shared: bool = False,
                 activity_low: float = 0.25) -> None:
        super().__init__()
        if budget_uj_s is not None and budget_uj_s <= 0:
            raise ValueError(
                f"budget_uj_s must be positive, got {budget_uj_s}")
        if not 0.0 <= activity_low <= 1.0:
            raise ValueError(
                f"activity_low must be in [0, 1], got {activity_low}")
        self.budget_uj_s = budget_uj_s
        self.backlog_high = backlog_high
        self.shared = shared
        self.activity_low = activity_low
        self.spent_uj = 0.0             # committed chip-model energy
        self.chip_time_s = 0.0          # committed chip-model time
        self._activity: Dict[str, float] = {}   # lane -> reported activity

    def _bound(self) -> None:
        ctx = self.ctx
        # binding attaches the policy to a fresh server: committed totals
        # reset (a reused instance must not carry another server's spend)
        self.spent_uj = 0.0
        self.chip_time_s = 0.0
        self._activity = {}
        self._backlog_high = (self.backlog_high if self.backlog_high
                              is not None else 4 * ctx.batch)
        # variants energy-descending per lane; one frame of variant v
        # costs e1[v] uJ and t1[v] seconds of chip time — a dispatch of
        # n frames commits n * e1 / n * t1, so variable-size dispatches
        # bill exactly what they run
        self._e1 = {v: r.i2l_energy_per_inference * 1e6
                    for v, r in ctx.reports.items()}
        self._t1 = {v: 1.0 / r.inferences_per_s
                    for v, r in ctx.reports.items()}
        self._order = {
            lane: tuple(sorted(vs, key=lambda v: -self._e1[v]))
            for lane, vs in ctx.variants.items()}

    def variant_order(self, lane: str) -> Tuple[str, ...]:
        return self._order[lane]

    def set_activity(self, lane: str, activity: float) -> None:
        """Report a lane's scene activity in [0, 1] — the fraction of
        its streams whose frame delta crossed the gate threshold (the
        temporal runtime's per-step signal, typically an EWMA).  Quiet
        lanes (below ``activity_low``) downshift one extra operating
        point on subsequent dispatches."""
        if lane not in self._order:
            raise KeyError(f"unknown lane {lane!r} "
                           f"(have {sorted(self._order)})")
        if not 0.0 <= activity <= 1.0:
            raise ValueError(
                f"activity must be in [0, 1], got {activity}")
        self._activity[lane] = activity

    def _choose(self, lane: str, pending: int, size: int,
                spent: float, time: float) -> str:
        """Most accurate affordable variant for ``lane`` at dispatch size
        ``size``, given committed totals ``(spent, time)``; backlog
        pressure and quiet-scene activity each downshift one more step;
        the cheapest variant is the unconditional floor."""
        order = self._order[lane]
        idx = len(order) - 1                      # floor: cheapest
        for i, v in enumerate(order):
            if self.budget_uj_s is None or (
                    (spent + size * self._e1[v])
                    <= self.budget_uj_s * (time + size * self._t1[v])):
                idx = i
                break
        if pending >= self._backlog_high:
            idx = min(idx + 1, len(order) - 1)    # catch-up downshift
        act = self._activity.get(lane)
        if act is not None and act < self.activity_low:
            idx = min(idx + 1, len(order) - 1)    # quiet-scene downshift
        return order[idx]

    def select(self, queue: FrameQueue) -> Optional[Dispatch]:
        return self.select_sized(queue, self.ctx.batch)

    def select_sized(self, queue: FrameQueue,
                     size: int) -> Optional[Dispatch]:
        lane = queue.first_backlogged()
        if lane is None:
            return None
        queue.advance_past(lane)
        spent, time = self.spent_uj, self.chip_time_s

        head = self._choose(lane, queue.pending(lane), size, spent, time)
        picks = [(lane, head)]
        occ = 1.0 / self.ctx.programs[head].s
        spent += size * self._e1[head]
        time += size * self._t1[head]

        if self.shared and occ < 1.0 - 1e-9:
            # riders: other backlogged lanes whose chosen variants fill
            # the freed sub-array lanes — commit only on an exact tiling
            for other in queue.rr_lanes():
                if other == lane or not queue.pending(other):
                    continue
                v = self._choose(other, queue.pending(other), size,
                                 spent, time)
                w = 1.0 / self.ctx.programs[v].s
                if occ + w > 1.0 + 1e-9:
                    continue
                picks.append((other, v))
                occ += w
                spent += size * self._e1[v]
                time += size * self._t1[v]
                if occ >= 1.0 - 1e-9:
                    break
            if occ < 1.0 - 1e-9 and len(picks) > 1:
                picks = picks[:1]                 # no exact tiling: solo
                spent = self.spent_uj + size * self._e1[head]
                time = self.chip_time_s + size * self._t1[head]

        self.spent_uj, self.chip_time_s = spent, time
        lanes = tuple(LaneDispatch(l, v, tuple(queue.take(l, size)))
                      for l, v in picks)
        batch = None if size == self.ctx.batch else size
        return self._count(Dispatch(lanes, batch=batch))


class ContinuousPolicy(DispatchPolicy):
    """Rolling/continuous batching: an SLO-bounded admission window.

    Instead of padding every dispatch to the fixed lane batch, the head
    lane's frames are admitted into an in-flight window and dispatched
    when one of three things happens:

    * the window reaches its *target size* — ``ceil(rate * slo_s *
      headroom)`` frames, the number the lane's EWMA arrival rate is
      expected to deliver inside the SLO budget (clamped to
      ``[min_batch, ctx.batch]``);
    * the oldest queued frame's **deadline approaches** — its queueing
      delay exceeds ``slo_s * deadline_frac`` — and the dispatcher
      launches early-and-small rather than blow the SLO waiting to fill
      the pad;
    * the server is **flushing** (drain), which disables waiting
      entirely.

    The dispatch size is then quantised up onto a bucket ladder
    ``{q, 2q, 4q, ... ctx.batch}`` (``q = ctx.quantum``, the serve mesh
    device count) so every launch divides over the serving group and a
    program's kernels see at most ``log2(batch) + 1`` batch sizes.

    *What* runs the frames is delegated to ``inner`` (default
    :class:`StaticPolicy`): the operating-point controller autoscales
    the **variant**, this layer autoscales the **batch** — composition,
    not replacement.  ``variant_dispatches`` is shared with the inner
    policy so accounting (and ``downshift_ratio``) reflects what ran.

    Unstamped requests (``t_submit == 0``) carry no deadline, so they
    dispatch immediately — replay-style callers that never stamp get
    static-like behaviour at size ``min(pending, batch)``.
    """

    name = "continuous"

    def __init__(self, slo_ms: float = 50.0, min_batch: int = 1,
                 headroom: float = 0.5, deadline_frac: float = 0.5,
                 inner: Optional[DispatchPolicy] = None) -> None:
        super().__init__()
        if slo_ms <= 0:
            raise ValueError(f"slo_ms must be positive, got {slo_ms}")
        if min_batch < 1:
            raise ValueError(f"min_batch must be >= 1, got {min_batch}")
        if not 0.0 < headroom <= 1.0:
            raise ValueError(f"headroom must be in (0, 1], got {headroom}")
        if not 0.0 <= deadline_frac <= 1.0:
            raise ValueError(
                f"deadline_frac must be in [0, 1], got {deadline_frac}")
        self.slo_ms = slo_ms
        self.min_batch = min_batch
        self.headroom = headroom
        self.deadline_frac = deadline_frac
        self.inner = inner if inner is not None else StaticPolicy()

    def _bound(self) -> None:
        self.inner.bind(self.ctx)
        # one shared accounting dict: the inner policy does the counting
        # (it builds every Dispatch), this layer reads the same totals
        self.variant_dispatches = self.inner.variant_dispatches
        q = max(1, self.ctx.quantum)
        ladder = []
        s = q
        while s < self.ctx.batch:
            ladder.append(s)
            s *= 2
        ladder.append(self.ctx.batch)
        self._ladder = tuple(ladder)

    def set_flush(self, flush: bool) -> None:
        super().set_flush(flush)
        self.inner.set_flush(flush)

    def variant_order(self, lane: str) -> Tuple[str, ...]:
        return self.inner.variant_order(lane)

    def downshift_ratio(self) -> float:
        return self.inner.downshift_ratio()

    def _bucket(self, n: int) -> int:
        """Smallest ladder size >= n (the pad is billed, so round up as
        little as possible)."""
        for s in self._ladder:
            if s >= n:
                return s
        return self._ladder[-1]

    def _target(self, rate: float) -> int:
        """Window target: how many frames the lane's arrival rate should
        deliver within ``headroom`` of the SLO budget."""
        if rate <= 0.0:
            return self.min_batch
        want = math.ceil(rate * (self.slo_ms / 1e3) * self.headroom)
        return max(self.min_batch, min(want, self.ctx.batch))

    def select(self, queue: FrameQueue) -> Optional[Dispatch]:
        lane = queue.first_backlogged()
        if lane is None:
            return None
        pending = queue.pending(lane)
        if not self.flush:
            target = self._target(queue.arrival_rate(lane))
            oldest = queue.oldest_submit(lane)
            if oldest is None:
                deadline_near = True      # unstamped: no deadline to wait on
            else:
                waited = self.ctx.clock() - oldest
                deadline_near = waited >= (
                    self.slo_ms / 1e3) * self.deadline_frac
            if pending < target and not deadline_near:
                return None               # keep the window open
        size = self._bucket(min(pending, self.ctx.batch))
        return self.inner.select_sized(queue, size)
