"""Host spans and the reduction of a ``torch.profiler`` trace.

:class:`Spans` marks the benchmark's own host spans around its calls into
the program (``pool.next``, ``plan.call``, ``labels.fetch``) in a profiler's
trace with ``record_function``, so the device timeline can be read against
them.  :func:`reduce_profile` turns the trace into the device's busy
seconds over the traced window, the device operations that took most
time, and the idle gaps by the host span that was open in each.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "window"
SPANS = ("pool.next", "plan.call", "labels.fetch")
MARKS = (WINDOW,) + SPANS


class Spans:
    """The host spans' marks in a ``torch.profiler`` trace, while one
    records (``marking``); outside a trace a span costs nothing."""

    def __init__(self):
        self.marking = False

    def __call__(self, name: str):
        if self.marking:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_profile(prof, top: int = 10) -> Optional[dict]:
    """``{"busy_s", "window_s", "device_ops", "idle_gaps"}`` of a trace
    whose window is marked by a ``WINDOW`` span, or None where the trace
    holds no device activity inside it.

    busy: the union of the device operations' intervals (kernels and
    copies) clipped to the window.  device_ops: seconds by operation name,
    largest first.  idle_gaps: the idle seconds between busy intervals,
    each gap charged to the host span open at its midpoint (the spans do
    not nest; "none" where none is open), largest first.
    """
    from torch.autograd import DeviceType
    window = None
    host, device = [], []
    for ev in prof.events():
        a, b = ev.time_range.start, ev.time_range.end
        if ev.name in MARKS:
            # the spans' own marks, also echoed on the device's timeline
            if ev.device_type != DeviceType.CUDA:
                if ev.name == WINDOW:
                    window = (a, b)
                else:
                    host.append((ev.name, a, b))
        elif ev.device_type == DeviceType.CUDA:
            device.append((ev.name, a, b))
    if window is None:
        return None
    w0, w1 = window
    clipped = [(n, max(a, w0), min(b, w1)) for n, a, b in device
               if b > w0 and a < w1]
    if not clipped:
        return None
    by_name: Dict[str, float] = defaultdict(float)
    for n, a, b in clipped:
        by_name[n] += (b - a) * 1e-6
    busy = _merge([(a, b) for _, a, b in clipped])
    gaps = []
    cursor = w0
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < w1:
        gaps.append((cursor, w1))
    host.sort(key=lambda s: s[1])
    starts = [s[1] for s in host]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        name = host[i][0] if i >= 0 and host[i][2] >= mid else "none"
        idle[name] += (b - a) * 1e-6
    busy_s = sum(b - a for a, b in busy) * 1e-6
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": sorted(([n, s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                            key=lambda x: -x[1])[:top],
    }
