"""Device timers of the port's timing scripts and ``chip_smoke.py``.

* :func:`graph_ms` — the kernel table's timer: ``calls`` calls of ``fn``
  captured in one CUDA graph, replayed between two CUDA events, so a
  call's time is device time with no host gap and no profiler in the way.
  It does not drift within a long process (``launch/profiler_drift.py``).
* :func:`events_ms` — CUDA events around back-to-back calls: for calls
  that cannot be captured (one that reads a value back to the host), and
  beside the graph reading as the host path's cost a call.
* :func:`device_ms` — ``torch.profiler`` device time a call, kept beside
  the others (it reads up to 40% low late in a long process).

Each needs a CUDA device; inputs are the caller's, so L2 stays warm as
in steady serving.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

PROFILE_TRIES = 3               # profiler sessions before giving up


def graph_ms(fn: Callable[[], object], calls: int = 50) -> float:
    """Mean ms a call of ``fn`` replayed from a CUDA graph of ``calls``
    calls, between two CUDA events.  Raises where ``fn`` cannot be
    captured (it synchronizes or reads a value back to the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def events_ms(fn: Callable[[], object], iters: int, warmup: int = 3) -> float:
    """Mean ms a call over ``iters`` back-to-back calls, by CUDA events
    after a warm-up (the host's launch path included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn: Callable[[], object], iters: int,
              name: str = "") -> Optional[float]:
    """Device ms a call of ``fn``'s CUDA kernels whose names hold ``name``
    (all of them for ""), from ``torch.profiler`` over ``iters`` calls;
    None when no session of PROFILE_TRIES records device activity (a
    session now and then comes back empty)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == DeviceType.CUDA and name in ev.name]
        if us:
            return sum(us) / 1e3 / iters
    return None
