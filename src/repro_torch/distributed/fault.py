"""Fault tolerance: preemption, stragglers, step retry.

The counterpart of ``repro.distributed.fault``; the code is a copy (the
module is framework-free).  Layers of defense (exercised in
tests/test_torch_checkpoint_fault.py):

1. **Checkpoint/restart** — ``checkpoint.ckpt.AsyncCheckpointer`` every N
   steps; a loop resumes from ``latest_step`` after any crash.
2. **Preemption** — SIGTERM/SIGINT flips a flag; the loop checkpoints at
   the next step boundary and exits cleanly.
3. **Straggler mitigation** — StepTimer keeps a rolling step-time
   distribution; steps slower than ``threshold x median`` raise a flag the
   driver uses to log the slow host or replace it (detect-and-replace).
4. **Elastic re-scale** — checkpoints are topology-free (full arrays), so
   a restart restores onto whatever devices survived
   (``checkpoint.ckpt.make_mesh``).
5. **Step retry** — transient failures raise; ``retry_step`` re-runs the
   step function up to k times with deterministic exponential backoff
   between attempts (the injectable sleep keeps tests instant).  The
   serving fleet brings replacement replicas up through it after a host
   loss (``serving/fleet.py``).
"""

from __future__ import annotations

import collections
import signal
import statistics
import time
from typing import Callable, Optional


class PreemptionGuard:
    """SIGTERM/SIGINT -> request a clean checkpoint-and-exit."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:  # non-main thread (tests)
                    pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for sig, h in self._prev.items():
            signal.signal(sig, h)


class StepTimer:
    """Rolling step-time stats + straggler detection."""

    def __init__(self, window: int = 50, threshold: float = 3.0):
        self.times = collections.deque(maxlen=window)
        self.threshold = threshold
        self._t0: Optional[float] = None
        self.stragglers = 0

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        dt = time.monotonic() - self._t0
        self.slow = False
        if len(self.times) >= 5:
            med = statistics.median(self.times)
            if dt > self.threshold * med:
                self.stragglers += 1
                self.slow = True
        self.times.append(dt)
        return False

    @property
    def median(self) -> Optional[float]:
        return statistics.median(self.times) if self.times else None


def retry_step(fn: Callable, *args, retries: int = 2,
               exceptions=(RuntimeError,), on_retry: Callable = None,
               backoff_s: float = 0.0, backoff_factor: float = 2.0,
               max_backoff_s: float = 30.0,
               sleep: Callable[[float], None] = time.sleep,
               stats: Optional[dict] = None):
    """Re-run a pure step on transient failure (inputs are immutable).

    Failed attempt ``k`` (0-based) waits ``backoff_s * backoff_factor**k``
    seconds (capped at ``max_backoff_s``) before the next try —
    deterministic exponential backoff, so a retry loop never hammers a
    still-failing replica during failover.  ``sleep`` is injectable
    (tests pass a virtual sleep and stay instant).  ``on_retry(attempt,
    delay_s)`` fires before each backoff; ``stats`` (an optional dict)
    surfaces the final count to the caller: ``stats["attempts"]`` is the
    total number of calls made and ``stats["backoff_s"]`` the total
    backoff requested.  The default ``backoff_s=0.0`` keeps the
    pre-backoff immediate-retry behaviour.
    """
    if backoff_s < 0.0 or backoff_factor < 1.0 or max_backoff_s < 0.0:
        raise ValueError(
            f"bad backoff ({backoff_s=}, {backoff_factor=}, "
            f"{max_backoff_s=})")
    total_backoff = 0.0
    for attempt in range(retries + 1):
        try:
            result = fn(*args)
        except exceptions:
            if stats is not None:
                stats["attempts"] = attempt + 1
                stats["backoff_s"] = total_backoff
            if attempt == retries:
                raise
            delay = min(backoff_s * backoff_factor ** attempt, max_backoff_s)
            if on_retry:
                on_retry(attempt, delay)
            if delay > 0.0:
                sleep(delay)
                total_backoff += delay
            continue
        if stats is not None:
            stats["attempts"] = attempt + 1
            stats["backoff_s"] = total_backoff
        return result
