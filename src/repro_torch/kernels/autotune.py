"""Persistent launch-geometry autotuner: measure-and-cache on the card.

The counterpart of ``repro.kernels.autotune`` over the port's own launch
geometry.  The chip has one fixed datapath; the H100 kernels have
schedule knobs whose best values depend on the (program, card, batch)
triple:

* the cluster body's blocks a cluster (``cluster``, 1 to 8): the solo
  megakernel, every composite and the delta gate's recompute
  (``kernels.megakernel.cluster_geometry``); the formula takes one block
  for each feature word of the widest conv layer;
* the fused cascade's detector clusters (``det_cluster``), under the
  pair's composite key (``cascade_geometry``);
* the staged conv layers' feature slices a block and output rows a band
  (``nslices``, ``rows``: ``binary_conv2x2_block.make_conv_tiles``), one
  pair for every conv layer of a program, ``rows`` capped at each
  layer's output rows.

``repro``'s frame tile ``bb`` and f-tile ``ft``/``ftg`` have no
counterpart: a cluster runs one frame, and one launch has one cluster
size.  A field's 0 means the formula's choice, and a cold cache resolves
every field to 0, so a cold cache launches exactly the formula's
geometry.  Every geometry computes the same integers: tuning is a pure
schedule choice, never a numeric one.

* ``tune_mega`` / ``tune_composite`` / ``tune_staged_conv`` time their
  candidate grid on the card (a call in a CUDA graph, best of ``iters``:
  ``launch.timing.graph_ms``), skip a candidate the geometry refuses, and
  record the winner with its ``ms`` only if, timed again alternately
  with the formula's geometry, it beats it by more than ``MARGIN``;
  otherwise they record 0 (the formula) with the formula's ``ms``, so
  readings within their own spread never steer a later launch.  They raise on a CPU device unless
  given a ``timer``.
* The cache is a flat JSON file (default ``build/repro_torch/
  autotune.json``, override with ``REPRO_TORCH_AUTOTUNE_CACHE``; never
  ``repro``'s ``BENCH_autotune.json``) keyed
  ``v{SCHEMA}/{kind}/{program key}/b{batch}/{backend fingerprint}`` with
  ``kernels.cache``'s ``program_key``, ``composite_key`` and
  ``backend_fingerprint`` (card name, compute capability, torch and CUDA
  versions, or ``cpu``).  A missing, corrupt or foreign file is cold.
* ``mega_tiles`` / ``composite_tiles`` / ``cascade_tiles`` /
  ``conv_tiles`` are the read side, consulted by the plans at every
  call: explicit arguments win, then an exact cache hit, then the
  nearest-batch entry of the same program and backend, then the
  formula.  A resolution is memoised by the program (or member tuple),
  batch and device, so a dispatch hashes nothing; :func:`record` and
  :func:`invalidate` drop the memos.

The serve functions of the warm-start cache (``kernels.cache``) are the
plans' methods bound to a device, and resolve here at call time: an
entry recorded after a server was built steers its next dispatch (where
``repro`` resolves at trace time, so an already built function keeps its
tiles).  Their signatures do not change, so ``cache.SCHEMA`` stays.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

from repro_torch import device as _device
from repro_torch.kernels import cache

DEFAULT_CACHE = os.path.join("build", "repro_torch", "autotune.json")
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
SCHEMA = 1          # bump when tuned fields / kernel schedules change shape

# the formula's geometry (0 = the formula's choice for the field), the
# cold-cache behaviour
DEFAULTS = {
    "mega": {"cluster": 0},
    "cascade": {"det_cluster": 0},
    "staged_conv": {"nslices": 0, "rows": 0},
}
CLUSTERS = (1, 2, 4, 8)                  # tune_mega / tune_composite
NSLICES = (0, 1, 2, 4, 8)                # tune_staged_conv
ROWS = (0, 1, 2, 4, 8)
# a candidate replaces the formula only if it is this much faster in a
# confirmation that times the two alternately (CONFIRM readings each):
# the grid's own readings drift with the card's clock over a grid, by up
# to 7% between calls at cifar9_s1's staged conv on the H100 (PERF.md)
MARGIN = 0.03
CONFIRM = 2

_cache: Optional[Dict[str, dict]] = None
_cache_file: Optional[str] = None
# (kind, id(key object), batch, device) -> (key object, resolved fields),
# and id(program or member tuple) -> (it, its key): holding the object
# keeps its id from being reused
_resolved: Dict[tuple, tuple] = {}
_pkeys: Dict[int, tuple] = {}


def cache_path() -> str:
    return os.environ.get(CACHE_ENV, DEFAULT_CACHE)


def _fingerprint(device) -> str:
    return cache.backend_fingerprint(_device.resolve(device))


def _once(obj, compute: Callable[[], str]) -> str:
    hit = _pkeys.get(id(obj))
    if hit is None or hit[0] is not obj:
        hit = _pkeys[id(obj)] = (obj, compute())
    return hit[1]


def program_key(program) -> str:
    """``kernels.cache.program_key``, computed once a program object."""
    return _once(program, lambda: cache.program_key(program))


def composite_key(programs) -> str:
    """``kernels.cache.composite_key``, computed once a member tuple."""
    return _once(programs, lambda: cache.composite_key(programs))


def _entry_key(kind: str, pkey: str, batch: int, fingerprint: str) -> str:
    # the vN prefix versions the schema: entries written for an older
    # schedule never match and degrade to the formula
    return f"v{SCHEMA}/{kind}/{pkey}/b{int(batch)}/{fingerprint}"


def _load() -> Dict[str, dict]:
    global _cache, _cache_file
    path = cache_path()
    if _cache is None or _cache_file != path:
        try:
            with open(path) as f:
                _cache = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError, OSError,
                UnicodeDecodeError):
            _cache = {}
        if not isinstance(_cache, dict):
            # valid JSON but not a cache (a truncated or foreign file):
            # cold, since the cache may only ever change a schedule
            _cache = {}
        _cache_file = path
        _resolved.clear()
    return _cache


def invalidate() -> None:
    """Drop the in-process cache and every memo (tests, or after an
    external refresh of the file)."""
    global _cache, _cache_file
    _cache, _cache_file = None, None
    _resolved.clear()
    _pkeys.clear()


def lookup(kind: str, pkey: str, batch: int, device=None) -> Optional[dict]:
    """Exact (kind, program, batch, backend) entry, else the same program
    and backend's nearest-batch entry (the smaller batch on a tie), else
    None (cold)."""
    cache_ = _load()
    fp = _fingerprint(device)
    hit = cache_.get(_entry_key(kind, pkey, batch, fp))
    if hit is not None:
        return hit
    prefix = f"v{SCHEMA}/{kind}/{pkey}/b"
    suffix = f"/{fp}"
    nearest = None
    for key, entry in cache_.items():
        if not (key.startswith(prefix) and key.endswith(suffix)):
            continue
        try:
            b = int(key[len(prefix):len(key) - len(suffix)])
        except ValueError:
            continue
        if nearest is None or (abs(b - batch), b) < nearest[0]:
            nearest = ((abs(b - batch), b), entry)
    return nearest[1] if nearest else None


def record(kind: str, pkey: str, batch: int, entry: dict,
           device=None) -> dict:
    """Persist a tuned entry (merged into the JSON file, written
    atomically) and drop the resolution memos."""
    cache_ = _load()
    key = _entry_key(kind, pkey, batch, _fingerprint(device))
    cache_[key] = dict(entry)
    path = cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(cache_, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    _resolved.clear()
    return cache_[key]


# ---------------------------------------------------------------------------
# Read side: geometry resolution (explicit args > cache > formula)
# ---------------------------------------------------------------------------

def _resolve(kind: str, pkey: str, batch: int, device=None) -> tuple:
    """The cache's fields for ``kind``: each from the entry ``lookup``
    finds, else ``DEFAULTS[kind]`` (the formula); field names and order
    from ``DEFAULTS[kind]``.  Explicit arguments are applied over it by
    the read functions."""
    defaults = DEFAULTS[kind]
    entry = lookup(kind, pkey, batch, device) or {}
    return tuple(int(entry.get(f, defaults[f])) for f in defaults)


def _cached(kind: str, obj, pkey_of: Callable[[], str], batch: int,
            device) -> tuple:
    """_resolve memoised by (kind, obj, batch, device): a hit costs one
    dict lookup."""
    key = (kind, id(obj), batch, device)
    hit = _resolved.get(key)
    if hit is None or hit[0] is not obj:
        hit = _resolved[key] = (obj, _resolve(kind, pkey_of(), batch,
                                              device))
    return hit[1]


def mega_tiles(program, batch: int, cluster: Optional[int] = None,
               device=None) -> int:
    """Blocks a cluster for the solo megakernel (and the delta gate's
    recompute) on ``program`` at ``batch``; 0 = the formula's."""
    if cluster is not None:
        return int(cluster)
    return _cached("mega", program, lambda: program_key(program), batch,
                   device)[0]


def composite_tiles(programs, batch: int, cluster: Optional[int] = None,
                    device=None) -> int:
    """Blocks a cluster for a composite launch of ``programs`` (a tuple,
    in member order: the memo holds it) at ``batch``, the composite's
    own entry; 0 = the formula's."""
    if cluster is not None:
        return int(cluster)
    return _cached("mega", programs, lambda: composite_key(programs), batch,
                   device)[0]


def cascade_tiles(programs, batch: int, det_cluster: Optional[int] = None,
                  device=None) -> int:
    """The fused cascade's detector blocks a cluster, under the pair's
    composite key; 0 = ``cascade_geometry``'s pick by the batch."""
    if det_cluster is not None:
        return int(det_cluster)
    return _cached("cascade", programs, lambda: composite_key(programs),
                   batch, device)[0]


def conv_tiles(program, batch: int, nslices: Optional[int] = None,
               rows: Optional[int] = None, device=None):
    """(nslices, rows) for the staged plan's fused conv layers; 0 = the
    formula's."""
    if nslices is not None and rows is not None:
        return int(nslices), int(rows)
    ns, r = _cached("staged_conv", program, lambda: program_key(program),
                    batch, device)
    return (ns if nslices is None else int(nslices),
            r if rows is None else int(rows))


# ---------------------------------------------------------------------------
# Write side: measure-and-cache tuners
# ---------------------------------------------------------------------------

def _timer(fn: Callable[[], object], iters: int) -> float:
    """Best of ``iters`` readings of a call's ms in a CUDA graph (the min
    is the least noisy estimator on a shared host)."""
    from repro_torch.launch.timing import graph_ms
    return min(graph_ms(fn) for _ in range(iters))


def _tune(kind: str, pkey: str, batch: int, dev, fields, candidates,
          formula: tuple, call: Callable, check: Callable, timer,
          iters: int, report: Optional[list]) -> dict:
    """Time every candidate ``check`` accepts, in grid order (``formula``,
    the candidate that launches the formula's geometry, first if the grid
    lacks it).  If the fastest is another, time it and the formula
    alternately ``CONFIRM`` times more and record it only if its best
    confirmation reading beats the formula's by more than ``MARGIN``;
    else record 0 for every field (the formula).  ``ms`` is the recorded
    geometry's time (its confirmation reading where there was one)."""
    if timer is None:
        if dev.type != "cuda":
            raise ValueError(f"the tuners time the card's kernels and need "
                             f"a CUDA device, got {dev}; pass timer= to "
                             f"script one")
        timer = _timer
    check(*formula)
    times = {}
    candidates = list(candidates)
    for cand in ([] if formula in candidates else [formula]) + candidates:
        try:
            check(*cand)
        except ValueError:
            continue
        times[cand] = float(timer(lambda: call(*cand), iters))
        if report is not None:
            report.append((dict(zip(fields, cand)), times[cand]))
    best = min(times, key=times.get)
    if best != formula:
        # the grid's winner is picked from many noisy readings: confirm it
        # on fresh ones, alternated with the formula's so a drift during
        # the grid cannot pass for a gain
        again = {formula: [], best: []}
        for _ in range(CONFIRM):
            for cand in (formula, best):
                again[cand].append(float(timer(lambda: call(*cand), iters)))
        times = {c: min(v) for c, v in again.items()}
    if times[best] >= times[formula] * (1 - MARGIN):
        best = (0,) * len(fields)
        times[best] = times[formula]
    entry = dict(zip(fields, best), ms=times[best])
    return record(kind, pkey, batch, entry, dev)


def tune_mega(plan, image, frames, *, clusters=CLUSTERS, iters: int = 3,
              timer=None, report: Optional[list] = None) -> dict:
    """Time the solo megakernel's cluster sizes for ``plan`` on the card
    of ``frames`` and cache the winner under (program, card, batch).
    Returns the recorded entry ({"cluster", "ms"}; cluster 0 where no
    size beat the formula's by ``MARGIN``); ``report``, a list, collects
    ({field: value}, ms) for every candidate timed."""
    from repro_torch.kernels import megakernel as mk
    dev = frames.device
    image = _device.to_device(image, dev)     # no copy inside a capture
    spec = mk.solo_member_spec(plan.mega)
    return _tune(
        "mega", program_key(plan.program), frames.shape[0], dev,
        ("cluster",), [(c,) for c in clusters],
        (mk.cluster_geometry(spec).cluster,),
        lambda c: plan.forward_mega(image, frames, device=dev, cluster=c),
        lambda c: mk.cluster_geometry(spec, c), timer, iters, report)


def tune_composite(cplan, image, frames, *, clusters=CLUSTERS,
                   iters: int = 3, timer=None,
                   report: Optional[list] = None) -> dict:
    """Time a composite's cluster sizes (the group's one cluster: one
    launch takes one size) and cache the winner under the composite's
    key.  ``frames``: one batch per member, in ``cplan.names`` order."""
    from repro_torch.kernels import megakernel as mk
    frames = tuple(frames)
    dev = frames[0].device
    image = _device.to_device(image, dev)
    batch = max(f.shape[0] for f in frames)
    return _tune(
        "mega", composite_key(cplan.programs), batch, dev, ("cluster",),
        [(c,) for c in clusters], (mk.cluster_geometry(cplan.spec).cluster,),
        lambda c: cplan.forward(image, frames, device=dev, cluster=c),
        lambda c: mk.cluster_geometry(cplan.spec, c), timer, iters, report)


def tune_staged_conv(plan, packed, frames, *, nslices=NSLICES, rows=ROWS,
                     iters: int = 3, timer=None,
                     report: Optional[list] = None) -> dict:
    """Time the staged plan's conv geometry grid, ``nslices`` x ``rows``
    (0 = the formula's), and cache the winner under (program, card,
    batch)."""
    from repro_torch.core.chip import isa
    dev = frames.device
    packed = _device.to_device(packed, dev)
    batch = frames.shape[0]
    fslices = isa.ARRAY_CHANNELS // plan.program.s // 32
    grid = [(n, r) for n in sorted({min(n, fslices) for n in nslices})
            for r in rows]
    return _tune(
        "staged_conv", program_key(plan.program), batch, dev,
        ("nslices", "rows"), grid, (0, 0),
        lambda n, r: plan.forward(packed, frames, device=dev,
                                  conv_tiles=(n, r)),
        lambda n, r: plan.conv_geometry(batch, n, r, dev), timer, iters,
        report)
