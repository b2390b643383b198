"""Warm-start cache: what a replica's executor builds, keyed like tiles.

BinarEye keeps *everything* resident — weights in SRAM, instructions in
the 16-slot program memory — so a chip powers up serving-ready the moment
its image is loaded.  The counterpart of ``repro.kernels.cache``: where
``repro`` memoises jit'd (trace + XLA-compiled) serve functions, the port
memoises what its executor builds for a serving unit (a program, a
shared-array composite, a cascade pair, a delta-gated unit) on a device
group: the compiled plan, the serve functions bound to each device, and
each admitted artifact in its serving form on each device.  A second
executor asking for the same key on the same artifacts (a fleet's
replacement replica) skips plan compilation, the artifact's conversion
and its upload.  The kernels' ``nvcc`` build stays once a process
(``kernels/_build.py``); a failed build raises, and this cache never
hides it.

* **Keys** fingerprint the computation, ``v{SCHEMA}/{kind}/{pkey}/{devs}/
  {opts}/{fingerprint}``: the program words + S (:func:`program_key`, or
  the order-sensitive :func:`composite_key`), the unit's kind (which
  folds in the options that change it: ``cascade.p1``, ``delta.r2.c1``),
  the device group as device ids (``dcuda:0-cuda:0``: a group of two
  devices is another key than one device), the megakernel option, and
  the backend (:func:`backend_fingerprint`: device name, compute
  capability, torch and CUDA versions, or ``cpu``).  The ``v1/`` prefix
  versions the schema: when a serve function's signature changes, the
  version bumps and stale entries degrade to a cold build.
* **Artifacts** are cached inside an entry by the identity of the raw
  artifacts they came from (the entry keeps those objects alive, so an
  identity is never reused): replicas built from the same admitted
  artifacts share one read-only copy a device; other weights under the
  same key build their own.

The in-process ledger (:func:`stats`) records hits/misses of keys and the
seconds spent building on misses.  There is no persistent tier: the
kernels build from source each process, in seconds.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import torch

from repro_torch.core.chip import isa

SCHEMA = 1          # bump when serve-fn signatures / kernel schedules change

_entries: Dict[str, Dict[str, Any]] = {}
_stats = {"hits": 0, "misses": 0, "build_s": 0.0}


def program_key(program: isa.Program) -> str:
    """Fingerprint of the assembled program words + S (the same hash as
    ``repro.kernels.autotune.program_key``)."""
    words = isa.assemble(program)
    return hashlib.sha1(words.tobytes()
                        + bytes([program.s])).hexdigest()[:12]


def composite_key(programs: Iterable[isa.Program]) -> str:
    """Order-sensitive fingerprint of a composite's member programs (the
    same hash as ``repro.kernels.autotune.composite_key``)."""
    joined = "+".join(program_key(p) for p in programs)
    return "comp-" + hashlib.sha1(joined.encode()).hexdigest()[:12]


def backend_fingerprint(device) -> str:
    """The machine class and toolchain a build is valid for: ``cpu``, or
    the card's name, compute capability and the torch and CUDA
    versions."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    props = torch.cuda.get_device_properties(dev)
    name = props.name.replace(" ", "_")
    return (f"{name}:sm{props.major}{props.minor}:torch{torch.__version__}"
            f":cuda{torch.version.cuda}")


def serve_fn_key(programs: Iterable[isa.Program], *,
                 devices: Sequence = ("cpu",), megakernel: bool = False,
                 kind: str = "serve") -> str:
    """Cache key for a serving unit.

    ``programs`` is the ordered member tuple — one program for a solo
    unit, the composite's member order for a shared-array one (order is
    part of the image layout).  ``devices`` is the replica's device
    group; units of different groups never share an entry."""
    programs = tuple(programs)
    pkey = (program_key(programs[0]) if len(programs) == 1
            else composite_key(programs))
    devices = tuple(torch.device(d) for d in devices)
    devs = "d" + "-".join(str(d) for d in devices)
    opts = f"mk{int(megakernel)}"
    return (f"v{SCHEMA}/{kind}/{pkey}/{devs}/{opts}/"
            f"{backend_fingerprint(devices[0])}")


def lookup(key: str) -> Optional[Dict[str, Any]]:
    """The entry under ``key`` (None = cold); the ledger counts the
    outcome."""
    entry = _entries.get(key)
    if entry is None:
        _stats["misses"] += 1
    else:
        _stats["hits"] += 1
    return entry


def get_or_build(key: str, build: Callable[[], Dict[str, Any]]
                 ) -> Dict[str, Any]:
    """A hit returns the cached entry; a miss runs ``build`` (timed into
    the ledger) and records the dict it returns."""
    entry = lookup(key)
    if entry is None:
        t0 = time.perf_counter()
        entry = dict(build(), uploads={})
        _stats["build_s"] += time.perf_counter() - t0
        _entries[key] = entry
    return entry


def upload(entry: Dict[str, Any], raws: tuple, build: Callable[[], Any]):
    """The entry's artifact built from the raw artifacts ``raws``: cached
    by their identity (the entry holds them), else ``build()``."""
    ids = tuple(id(r) for r in raws)
    hit = entry["uploads"].get(ids)
    if hit is None:
        hit = entry["uploads"][ids] = (raws, build())
    return hit[1]


def stats() -> Dict[str, Any]:
    """Ledger snapshot: hits/misses, seconds spent building on misses,
    entry count."""
    return dict(_stats, entries=len(_entries))


def invalidate() -> None:
    """Drop every entry and zero the ledger (tests, cold-start
    measurement)."""
    _entries.clear()
    _stats.update(hits=0, misses=0, build_s=0.0)
