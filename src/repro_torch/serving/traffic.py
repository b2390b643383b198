"""Deterministic traffic generation + trace replay for serving benches.

The counterpart of ``repro.serving.traffic``, copied whole (it is numpy
only): the same seeds give the same arrival and video traces.

BinarEye's headline workloads are *streaming*: an always-on camera feeds
frames at whatever rate the scene produces, and the chip's 0.92-14.4
uJ/f operating points are quoted per frame of that stream.  Measuring
our serving stack the same way needs arrival processes, not offline
batches — this module provides seeded, reproducible ones:

* :func:`poisson_trace` — homogeneous Poisson arrivals (exponential
  gaps), the null model of independent frame sources;
* :func:`bursty_trace` — a 2-state Markov-modulated Poisson process
  (MMPP): a calm state and a burst state with geometric dwell times,
  the camera-pan / motion-trigger pattern that stresses the admission
  window;
* :func:`diurnal_trace` — Poisson thinned by a sinusoidal envelope, the
  slow rate drift an always-on deployment sees over a day (compressed
  into the trace duration).

Every generator returns an :class:`ArrivalTrace`: lane-tagged arrival
offsets (seconds from trace start), fully determined by ``(kind, seed,
rate, ...)`` so the committed bench trace is reproducible bit-for-bit on
any host.  Traces serialize to JSON (:func:`save_trace` /
:func:`load_trace`) — the bench commits its trace parameters and CI can
re-derive the identical arrival sequence.

:func:`replay` feeds a trace into a :class:`~repro_torch.serving.server.
ChipServer` with real-time pacing: each frame is submitted at its trace
offset (``t_submit`` stamped with the *due* time, so queueing delay is
measured against the arrival process, not the replay loop's jitter), and
the server is stepped opportunistically between arrivals.  Pass
``speed`` to time-compress a trace, or a :class:`VirtualClock` (plus its
``sleep``) to replay deterministically in tests without wall-clock
waits.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

TRAFFIC_KINDS = ("poisson", "bursty", "diurnal")


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """A seeded arrival process realised over one or more lanes.

    ``t`` holds arrival offsets in seconds from trace start (sorted
    ascending); ``lane[i]`` names the lane frame ``i`` arrives on.
    ``meta`` records the generator parameters — enough to regenerate the
    trace exactly.
    """
    kind: str
    seed: int
    t: np.ndarray                       # float64 offsets, sorted
    lane: Tuple[str, ...]               # lane name per arrival
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in TRAFFIC_KINDS:
            raise ValueError(
                f"kind must be one of {TRAFFIC_KINDS}, got {self.kind!r}")
        if len(self.t) != len(self.lane):
            raise ValueError(
                f"{len(self.t)} arrival times vs {len(self.lane)} lane tags")
        if len(self.t) and np.any(np.diff(self.t) < 0):
            raise ValueError("arrival times must be sorted ascending")

    def __len__(self) -> int:
        return len(self.t)

    @property
    def duration_s(self) -> float:
        return float(self.t[-1]) if len(self.t) else 0.0

    @property
    def mean_rate(self) -> float:
        """Realised arrivals/s over the trace span."""
        if len(self.t) < 2 or self.duration_s <= 0.0:
            return 0.0
        return (len(self.t) - 1) / self.duration_s


def _spread(rng: np.random.Generator, n: int,
            lanes: Sequence[str],
            weights: Optional[Sequence[float]]) -> Tuple[str, ...]:
    """Tag each arrival with a lane, i.i.d. by ``weights`` (uniform when
    omitted) — a mixed program population over one arrival process."""
    lanes = tuple(lanes)
    if not lanes:
        raise ValueError("need at least one lane")
    if weights is None:
        p = None
    else:
        w = np.asarray(weights, dtype=np.float64)
        if len(w) != len(lanes) or np.any(w < 0) or w.sum() <= 0:
            raise ValueError(f"bad lane weights {weights} for {lanes}")
        p = w / w.sum()
    idx = rng.choice(len(lanes), size=n, p=p)
    return tuple(lanes[i] for i in idx)


def poisson_trace(lanes: Sequence[str], rate: float, n: int, *,
                  seed: int = 0,
                  weights: Optional[Sequence[float]] = None) -> ArrivalTrace:
    """Homogeneous Poisson arrivals: ``n`` frames at ``rate``/s total."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    t = np.cumsum(gaps)
    t -= t[0]                            # first arrival at offset 0
    return ArrivalTrace(kind="poisson", seed=seed, t=t,
                        lane=_spread(rng, n, lanes, weights),
                        meta=dict(rate=rate, n=n,
                                  lanes=list(lanes),
                                  weights=list(weights) if weights else None))


def bursty_trace(lanes: Sequence[str], rate: float, n: int, *,
                 seed: int = 0, burst_factor: float = 8.0,
                 p_enter: float = 0.05, p_exit: float = 0.25,
                 weights: Optional[Sequence[float]] = None) -> ArrivalTrace:
    """2-state MMPP: calm arrivals at a base rate, bursts at
    ``burst_factor`` times it; state flips per arrival with the given
    geometric probabilities.  The base rate is derived so the *mean*
    rate over states matches ``rate``.
    """
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if burst_factor < 1.0:
        raise ValueError(f"burst_factor must be >= 1, got {burst_factor}")
    if not (0.0 < p_enter < 1.0 and 0.0 < p_exit < 1.0):
        raise ValueError(
            f"transition probs must be in (0, 1), got {p_enter}, {p_exit}")
    rng = np.random.default_rng(seed)
    # stationary burst occupancy and the base rate matching the mean
    pi_b = p_enter / (p_enter + p_exit)
    base = rate / (1.0 - pi_b + pi_b * burst_factor)
    gaps = np.empty(n)
    burst = False
    for i in range(n):
        r = base * (burst_factor if burst else 1.0)
        gaps[i] = rng.exponential(1.0 / r)
        flip = rng.random()
        burst = (flip < p_enter) if not burst else (flip >= p_exit)
    t = np.cumsum(gaps)
    t -= t[0]
    return ArrivalTrace(kind="bursty", seed=seed, t=t,
                        lane=_spread(rng, n, lanes, weights),
                        meta=dict(rate=rate, n=n, burst_factor=burst_factor,
                                  p_enter=p_enter, p_exit=p_exit,
                                  lanes=list(lanes),
                                  weights=list(weights) if weights else None))


def diurnal_trace(lanes: Sequence[str], rate: float, n: int, *,
                  seed: int = 0, period_s: float = 10.0,
                  depth: float = 0.8,
                  weights: Optional[Sequence[float]] = None) -> ArrivalTrace:
    """Poisson arrivals thinned by a sinusoidal envelope — peak rate
    ``rate``, trough ``rate * (1 - depth)``, one full cycle every
    ``period_s`` (a day compressed to the trace duration).  Thinning a
    peak-rate Poisson stream by the envelope is the standard exact
    non-homogeneous construction.
    """
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if not 0.0 <= depth < 1.0:
        raise ValueError(f"depth must be in [0, 1), got {depth}")
    if period_s <= 0:
        raise ValueError(f"period_s must be positive, got {period_s}")
    rng = np.random.default_rng(seed)
    kept: List[float] = []
    t = 0.0
    while len(kept) < n:
        t += rng.exponential(1.0 / rate)
        envelope = 1.0 - depth * 0.5 * (
            1.0 + np.sin(2.0 * np.pi * t / period_s))
        if rng.random() < envelope:
            kept.append(t)
    arr = np.asarray(kept)
    arr -= arr[0]
    return ArrivalTrace(kind="diurnal", seed=seed, t=arr,
                        lane=_spread(rng, n, lanes, weights),
                        meta=dict(rate=rate, n=n, period_s=period_s,
                                  depth=depth, lanes=list(lanes),
                                  weights=list(weights) if weights else None))


_GENERATORS: Dict[str, Callable[..., ArrivalTrace]] = {
    "poisson": poisson_trace,
    "bursty": bursty_trace,
    "diurnal": diurnal_trace,
}


def make_trace(kind: str, lanes: Sequence[str], rate: float, n: int, *,
               seed: int = 0, **kwargs) -> ArrivalTrace:
    """Dispatch on ``kind`` — the CLI entry point's one-liner."""
    try:
        gen = _GENERATORS[kind]
    except KeyError:
        raise ValueError(
            f"unknown traffic kind {kind!r} (have {TRAFFIC_KINDS})")
    return gen(lanes, rate, n, seed=seed, **kwargs)


# ---------------------------------------------------------------------------
# video content: seeded frame sequences for the delta-gated temporal path
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VideoTrace:
    """A seeded multi-stream video *content* trace.

    Where :class:`ArrivalTrace` answers "when do frames arrive", this
    answers "what do the frames look like" — the signal the delta-gated
    serving path (``serving/temporal.py``) keys on.  ``frames`` is
    time-major: ``frames[t, s]`` is stream ``s``'s frame at step ``t``,
    so submitting step-by-step round-robin keeps each stream pinned to
    its batch slot.  ``changed[t, s]`` is the pixel-exact ground truth
    "does frame t differ from frame t-1 on stream s" (step 0 is always
    True: there is no predecessor to coast on).  ``meta`` records the
    generator parameters — enough to regenerate the trace exactly.
    """
    seed: int
    frames: np.ndarray                  # (T, streams, H, W, C) int32
    changed: np.ndarray                 # (T, streams) bool
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.frames.ndim != 5:
            raise ValueError(
                f"frames must be (T, streams, H, W, C), "
                f"got shape {self.frames.shape}")
        if self.changed.shape != self.frames.shape[:2]:
            raise ValueError(
                f"changed must be {self.frames.shape[:2]}, "
                f"got {self.changed.shape}")

    def __len__(self) -> int:
        return self.frames.shape[0]

    @property
    def streams(self) -> int:
        return self.frames.shape[1]

    @property
    def change_ratio(self) -> float:
        """Realised fraction of (step, stream) frames that changed."""
        return float(self.changed.mean()) if self.changed.size else 0.0


def video_trace(shape: Tuple[int, int, int], n: int, *, streams: int = 1,
                seed: int = 0, change_rate: float = 0.5,
                scene_change_every: int = 0, patch: int = 4,
                levels: int = 16) -> VideoTrace:
    """Seeded always-on camera content: static background + moving patch
    + optional scene-change events.

    Per stream: a random static background; each step the frame either
    *repeats bit-identically* (probability ``1 - change_rate`` — the
    quiet-scene case the delta gate skips) or the background reappears
    with a ``patch`` x ``patch`` block shifted by half the intensity
    range at a fresh random position (local motion).  Every
    ``scene_change_every`` steps (0 = never) the whole background
    regenerates — the scene-change event that must flush cached labels.
    ``shape`` is (H, W, C); ``levels`` is the pixel intensity range
    (``2 ** io.bits`` for a given program).  Deterministic in ``seed``;
    ``changed`` is computed pixel-exactly from the emitted frames, so it
    is ground truth even when two motion events coincide.
    """
    h, w, c = shape
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if streams < 1:
        raise ValueError(f"streams must be >= 1, got {streams}")
    if not 0.0 <= change_rate <= 1.0:
        raise ValueError(
            f"change_rate must be in [0, 1], got {change_rate}")
    if levels < 2:
        raise ValueError(f"levels must be >= 2, got {levels}")
    if scene_change_every < 0:
        raise ValueError(f"scene_change_every must be >= 0, "
                         f"got {scene_change_every}")
    rng = np.random.default_rng(seed)
    ph, pw = min(patch, h), min(patch, w)
    frames = np.empty((n, streams, h, w, c), dtype=np.int32)
    changed = np.zeros((n, streams), dtype=bool)
    bg = rng.integers(0, levels, (streams, h, w, c), dtype=np.int32)
    for t in range(n):
        for s in range(streams):
            scene_cut = t > 0 and scene_change_every and (
                t % scene_change_every == 0)
            if scene_cut:
                bg[s] = rng.integers(0, levels, (h, w, c), dtype=np.int32)
            if t == 0 or scene_cut:
                frames[t, s] = bg[s]
            elif rng.random() < change_rate:
                f = bg[s].copy()
                y = int(rng.integers(0, h - ph + 1))
                x = int(rng.integers(0, w - pw + 1))
                f[y:y + ph, x:x + pw] = (
                    f[y:y + ph, x:x + pw] + levels // 2) % levels
                frames[t, s] = f
            else:
                frames[t, s] = frames[t - 1, s]    # quiet: bit-identical
            changed[t, s] = t == 0 or not np.array_equal(
                frames[t, s], frames[t - 1, s])
    return VideoTrace(seed=seed, frames=frames, changed=changed,
                      meta=dict(kind="video", shape=list(shape), n=n,
                                streams=streams, change_rate=change_rate,
                                scene_change_every=scene_change_every,
                                patch=patch, levels=levels))


# ---------------------------------------------------------------------------
# serialization: the committed bench trace must be host-independent
# ---------------------------------------------------------------------------

def save_trace(trace: ArrivalTrace, path: str) -> None:
    with open(path, "w") as f:
        json.dump(dict(kind=trace.kind, seed=trace.seed,
                       t=[float(x) for x in trace.t],
                       lane=list(trace.lane), meta=trace.meta), f)


def load_trace(path: str) -> ArrivalTrace:
    with open(path) as f:
        d = json.load(f)
    return ArrivalTrace(kind=d["kind"], seed=d["seed"],
                        t=np.asarray(d["t"], dtype=np.float64),
                        lane=tuple(d["lane"]), meta=d.get("meta", {}))


# ---------------------------------------------------------------------------
# replay: feed a trace into a running server with arrival-time pacing
# ---------------------------------------------------------------------------

class VirtualClock:
    """A manually-advanced clock + matching sleep, for deterministic
    replay in tests: pass ``clock=vc, sleep=vc.sleep`` and simulated
    time advances only when the replay loop sleeps."""

    def __init__(self, start: float = 1.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def sleep(self, dt: float) -> None:
        if dt > 0:
            self.now += dt

    def advance(self, dt: float) -> None:
        self.now += dt


def replay(server, trace: ArrivalTrace,
           frames: Mapping[str, Any], *, speed: float = 1.0,
           clock: Optional[Callable[[], float]] = None,
           sleep: Optional[Callable[[float], None]] = None,
           ) -> List[Any]:
    """Replay ``trace`` against ``server`` in (scaled) real time.

    ``frames[lane]`` is an array of frames cycled per lane.  Each
    arrival is submitted no earlier than its trace offset (``speed > 1``
    compresses time) and stamped with its *due* time, so measured
    latency is relative to the arrival process.  Between arrivals the
    server is stepped so dispatches overlap admission; a final
    ``drain()`` collects the tail.  Returns all ``FrameResult``s.
    """
    if speed <= 0:
        raise ValueError(f"speed must be positive, got {speed}")
    import time as _time
    clock = clock if clock is not None else _time.perf_counter
    sleep = sleep if sleep is not None else _time.sleep
    counts: Dict[str, int] = {lane: 0 for lane in frames}
    results: List[Any] = []
    t0 = clock()
    for i in range(len(trace)):
        due = t0 + float(trace.t[i]) / speed
        while True:
            now = clock()
            if now >= due:
                break
            # serve whatever the policy will release, else wait it out
            got = server.step()
            if got:
                results.extend(got)
            else:
                sleep(max(0.0, min(due - clock(), 1e-3)))
        lane = trace.lane[i]
        bank = frames[lane]
        server.submit(lane, bank[counts[lane] % len(bank)], t_submit=due)
        counts[lane] += 1
    results.extend(server.drain())
    return results
