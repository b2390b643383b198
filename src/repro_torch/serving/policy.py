"""Dispatch policies: *what to run next* on the serving mechanism.

The counterpart of ``repro.serving.policy``, copied apart from imports,
for the static policy:

* :class:`DispatchPolicy` — the interface: given the queue, return the
  next :class:`Dispatch` (which lane(s), which resident program variant
  per lane, which frames).  The mechanism guarantees whatever the policy
  selects is executed and billed; the policy guarantees fairness (it must
  serve the round-robin head lane and advance the pointer past it).
* :class:`StaticPolicy` — every lane is served by its own program;
  lanes of a shared-array group (``ChipServer(shared=True)``) dispatch
  together as one composite.

The operating-point controller and continuous batching are not ported
yet (ROADMAP.md item 4.3).
"""

from __future__ import annotations

import dataclasses
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
