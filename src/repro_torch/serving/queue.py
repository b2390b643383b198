"""Frame queue mechanism: per-lane FIFOs + the round-robin pointer.

The counterpart of ``repro.serving.queue``, copied apart from imports.

This is the *mechanism* half of the serving scheduler (policies live in
:mod:`repro.serving.policy`): lanes hold submitted frames in FIFO order
and a round-robin pointer rotates across non-empty lanes so no resident
task starves.  A :class:`~repro.serving.policy.DispatchPolicy` decides
*what to run* (which lane, which program variant, solo or shared); the
queue only answers "who is next" and "hand me their frames".

The primitives a policy composes:

* :meth:`FrameQueue.rr_lanes` / :meth:`first_backlogged` — lane names in
  round-robin order from the pointer;
* :meth:`FrameQueue.take` — pop up to ``capacity`` requests from a lane
  (never moves the pointer);
* :meth:`FrameQueue.advance_past` — advance the pointer past a served
  lane (the fairness-critical step: a policy that serves lane L must
  advance past L, and may serve *extra* lanes without moving the pointer
  — extra service is always sooner than the solo schedule, never later).

:meth:`next_batch` and :meth:`next_batch_shared` are the two canonical
compositions (solo round-robin, and the shared-array pull); the
static dispatch policy is built on them.

For latency-aware policies the queue additionally keeps two per-lane
signals, both derived purely from submission (no wall-clock reads of its
own): an EWMA **arrival-rate estimate** (:class:`EwmaRate`, updated from
each request's ``t_submit`` stamp) and the **oldest queued timestamp**
(:meth:`oldest_submit` — the admission deadline anchor).  Requests
without a timestamp (``t_submit == 0``) leave both signals untouched, so
pure-Python scheduling tests keep working unchanged.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.chip import isa


@dataclasses.dataclass(frozen=True)
class FrameRequest:
    """One frame awaiting inference under a resident program (lane)."""
    rid: int                  # server-global request id (arrival order)
    program: str              # lane name (resident program or family)
    frame: Any                # (H, W, C) integer image
    t_submit: float = 0.0     # admission timestamp (server clock; 0 =
                              # unstamped, latency accounting skips it)


@dataclasses.dataclass(frozen=True)
class FrameResult:
    rid: int
    program: str              # the lane the request was submitted to
    label: int
    logits: np.ndarray
    dispatch: int             # index of the static batch that served it
    variant: str = ""         # resident program that actually ran it (==
                              # program for static lanes; a family lane's
                              # controller-chosen operating point)
    t_submit: float = 0.0     # admission timestamp carried from the request
    t_done: float = 0.0       # label available on the host (same clock)

    @property
    def latency_s(self) -> float:
        """Input-to-label latency; 0.0 when the request was unstamped."""
        if self.t_submit <= 0.0 or self.t_done <= 0.0:
            return 0.0
        return self.t_done - self.t_submit


class EwmaRate:
    """EWMA arrival-rate estimator over inter-arrival gaps.

    ``observe(t)`` feeds one arrival timestamp; :attr:`rate` is
    ``1 / ewma(dt)`` in arrivals/s, 0.0 until two timestamped arrivals
    have been seen.  Non-positive gaps (clock ties, unstamped requests
    replayed at t=0) are skipped so the estimate only ever reflects real
    spacing.  Purely deterministic given the observation sequence.
    """

    def __init__(self, alpha: float = 0.2):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._last: Optional[float] = None
        self._dt: Optional[float] = None

    def observe(self, t: float) -> None:
        if self._last is not None:
            dt = t - self._last
            if dt > 0.0:
                self._dt = (dt if self._dt is None
                            else self.alpha * dt + (1 - self.alpha) * self._dt)
        self._last = t

    @property
    def rate(self) -> float:
        return 1.0 / self._dt if self._dt else 0.0


class FrameQueue:
    """Per-program FIFO lanes + round-robin dispatch across non-empty lanes.

    The solo fairness contract (:meth:`next_batch`, property-tested in
    tests/test_chip_serve.py): a lane is never dispatched twice while
    another lane has been waiting non-empty the whole time — the pointer
    advances past each served lane and only skips lanes that are empty at
    their turn.  :meth:`next_batch_shared` deliberately relaxes the
    "never twice" half for lanes *inside a shared-array group* (a
    composite dispatch serves every backlogged group member each time the
    pointer hits any of them), but keeps the no-starvation bound every
    consumer actually relies on: any lane non-empty before a dispatch is
    itself served within the next ``n_lanes`` dispatches, and no lane is
    ever served *later* than the solo schedule would have served it.
    """

    def __init__(self, programs: Iterable[str]):
        self._order: List[str] = list(programs)
        if not self._order:
            raise ValueError("FrameQueue needs at least one resident program")
        if len(set(self._order)) != len(self._order):
            raise ValueError(f"duplicate program names: {self._order}")
        self._lanes: Dict[str, collections.deque] = {
            name: collections.deque() for name in self._order}
        self._rates: Dict[str, EwmaRate] = {
            name: EwmaRate() for name in self._order}
        self._rr = 0

    def submit(self, req: FrameRequest) -> None:
        if req.program not in self._lanes:
            raise KeyError(
                f"program {req.program!r} not resident "
                f"(have {self._order})")
        if req.t_submit > 0.0:
            self._rates[req.program].observe(req.t_submit)
        self._lanes[req.program].append(req)

    def pending(self, program: Optional[str] = None) -> int:
        if program is not None:
            return len(self._lanes[program])
        return sum(len(q) for q in self._lanes.values())

    def __len__(self) -> int:
        return self.pending()

    # -- policy-facing primitives ------------------------------------------

    @property
    def lanes(self) -> Tuple[str, ...]:
        return tuple(self._order)

    def rr_lanes(self) -> List[str]:
        """All lane names, one full rotation starting at the pointer."""
        n = len(self._order)
        return [self._order[(self._rr + i) % n] for i in range(n)]

    def first_backlogged(self) -> Optional[str]:
        """The next non-empty lane in round-robin order (pointer unmoved)."""
        for name in self.rr_lanes():
            if self._lanes[name]:
                return name
        return None

    def arrival_rate(self, lane: str) -> float:
        """EWMA arrival rate for ``lane`` in frames/s (0.0 until two
        timestamped submissions have been observed)."""
        return self._rates[lane].rate

    def oldest_submit(self, lane: str) -> Optional[float]:
        """``t_submit`` of the lane's head request — the deadline anchor
        for SLO-aware dispatch.  ``None`` when the lane is empty or its
        head request is unstamped."""
        q = self._lanes[lane]
        if not q or q[0].t_submit <= 0.0:
            return None
        return q[0].t_submit

    def take(self, lane: str, capacity: int) -> List[FrameRequest]:
        """Pop up to ``capacity`` requests from ``lane`` (FIFO); the
        round-robin pointer is NOT moved — pair with
        :meth:`advance_past` for the lane the dispatch was *for*."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        q = self._lanes[lane]
        return [q.popleft() for _ in range(min(capacity, len(q)))]

    def advance_past(self, lane: str) -> None:
        """Move the round-robin pointer just past ``lane``."""
        self._rr = (self._order.index(lane) + 1) % len(self._order)

    def requeue_front(self, lane: str, reqs: Iterable[FrameRequest]) -> None:
        """Push requests back at the *front* of a lane, preserving their
        relative order (``reqs[0]`` becomes the new head).

        This is the failover-migration primitive: frames orphaned by a
        dead replica are older than anything a survivor admitted after
        the failure, so they re-enter at the head of the FIFO and are
        served first.  The arrival-rate estimator is NOT fed — these are
        re-arrivals of already-observed admissions, not new traffic."""
        q = self._lanes[lane]
        for req in reversed(list(reqs)):
            if req.program != lane:
                raise ValueError(
                    f"request rid={req.rid} belongs to lane "
                    f"{req.program!r}, not {lane!r}")
            q.appendleft(req)

    # -- canonical compositions --------------------------------------------

    def next_batch(self, capacity: int) -> Optional[Tuple[str, List[FrameRequest]]]:
        """Up to ``capacity`` requests from the next non-empty lane in
        round-robin order; ``None`` once fully drained."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        name = self.first_backlogged()
        if name is None:
            return None
        self.advance_past(name)
        return name, self.take(name, capacity)

    def next_batch_shared(self, capacity: int,
                          groups: Mapping[str, Tuple[str, ...]]
                          ) -> Optional[Dict[str, List[FrameRequest]]]:
        """Round-robin like :meth:`next_batch`, but when the selected lane
        belongs to a shared-array group with >= 2 backlogged members, pull
        up to ``capacity`` from *every* backlogged member — one composite
        dispatch serves them all concurrently.  Lanes served early keep
        their round-robin position (they are simply empty — or shorter —
        when the pointer reaches them), so the no-starvation contract is
        untouched: a backlogged lane is only ever served *sooner*.
        Returns ``{name: requests}`` (single-entry for a solo dispatch),
        ``None`` once fully drained.
        """
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        name = self.first_backlogged()
        if name is None:
            return None
        self.advance_past(name)
        members = groups.get(name, (name,))
        backlogged = [m for m in members if self._lanes[m]]
        take_from = backlogged if len(backlogged) >= 2 else [name]
        return {m: self.take(m, capacity) for m in take_from}


def plan_shared_groups(programs: Mapping[str, isa.Program]
                       ) -> Tuple[Tuple[str, ...], ...]:
    """Partition resident programs into shared-array groups.

    First-fit-decreasing bin packing on sub-array width (256/S channels)
    into 256-channel bins; only bins that end *exactly* full with >= 2
    members become composite groups (the chip can only recombine
    sub-arrays that tile the array), everything else dispatches solo.
    Deterministic given admission order, so every server replica forms
    the same groups.
    """
    # stable sort: widest sub-arrays (smallest S) first, admission order
    # preserved within a width class
    items = sorted(programs.items(), key=lambda kv: kv[1].s)
    bins: List[Tuple[int, List[str]]] = []    # (free channels, members)
    for name, prog in items:
        width = isa.ARRAY_CHANNELS // prog.s
        for i, (free, members) in enumerate(bins):
            if width <= free:
                bins[i] = (free - width, members + [name])
                break
        else:
            bins.append((isa.ARRAY_CHANNELS - width, [name]))
    return tuple(tuple(members) for free, members in bins
                 if free == 0 and len(members) >= 2)
