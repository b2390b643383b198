"""The harness: one run of one cell of ``BENCHMARK.json``.

Everything particular to a cell lives in files found by name:

* ``configs/<config>.json`` — the network(s), each with its own copy of
  its layer list, checked against the program's ``isa.layer_geometry``;
* ``traffic/<traffic>.json`` — the traffic mix's parameters, among them
  ``entry``, the plan entry it drives;
* ``entries/<entry>.py`` — ``build(run)`` returns the entry: it makes its
  weights and frame pool from the seed, calls the program, and knows what
  the program's answers and the reference's are;
* ``metrics/<metric>.py`` — ``read(window)`` returns a per-layer metric's
  value, or None where the window holds nothing for it.

A run: set-up (weights, pool, the program's plan, a warm-up that builds
every kernel), then a closed loop for ``seconds``: take the next batch
from the pool on the device, call the plan entry, queue the copy of its
labels to the host, keep ``in_flight`` dispatches in flight and read each
dispatch's labels on the host before its slot is reused.  A host slot is
filled with -1 before each copy, so a label that never reaches the host
counts as missing.  With tracing, the same loop runs with CUDA events
around each call, then a short loop under ``torch.profiler``.  Then the check: a sample of the window's
dispatches, drawn from the seed, is compared with the plain reference
(``reference/``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import random
import statistics
import subprocess
import sys
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from portbench import gen, trace

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACED_SECONDS = 3.0             # the profiled loop of a traced run
INPUT_LSB_OFF = ~1               # the control: 6 of the 7 input bits
UNANSWERED = -1                  # a host slot's contents before its copy


def load_bench(path: Optional[Path] = None) -> dict:
    with open(path or CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str, root: Path = HERE) -> dict:
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = HERE):
    path = root / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or its package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def layers_of(program) -> List[dict]:
    """A program's layer list in the configuration files' form."""
    from repro_torch.core.chip import isa
    out = []
    for ins, h, w, c, *_ in isa.layer_geometry(program):
        if isinstance(ins, isa.IOInstr):
            out.append(dict(kind="io", h=ins.height, w=ins.width,
                            cin=ins.in_channels, bits=ins.bits,
                            channels=ins.channels))
        elif isinstance(ins, isa.ConvInstr):
            out.append(dict(kind="conv", h=h, w=w, c=c, f=ins.features,
                            pool=ins.maxpool))
        else:
            out.append(dict(kind="fc", k=ins.in_features,
                            n=ins.out_features, final=ins.final))
    return out


class Run:
    """What an entry is built from."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 t_start: float = 0.0, log=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.t_start, self.log = t_start, log

    def mark(self, what: str) -> None:
        """Logs the set-up's time so far, the device's work done."""
        if self.log is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.log(f"setup: {what} at "
                 f"{time.perf_counter() - self.t_start:.3f} s")

    @staticmethod
    def program(stage: dict):
        """The program's ISA program for a configuration stage, after
        checking that the stage's own layer list is the program's."""
        from repro_torch.core.chip import networks
        program = networks.REGISTRY[stage["program"]]()
        if layers_of(program) != stage["layers"]:
            raise ValueError(f"the configuration's layers of "
                             f"{stage['program']} are not the program's")
        return program


class _NoEvent:
    """A CUDA event's stand-in on the CPU: always complete, no time."""

    def record(self):
        pass

    def synchronize(self):
        pass


def _event(dev, timing: bool = False):
    if dev.type == "cuda":
        return torch.cuda.Event(enable_timing=timing)
    return _NoEvent()


class Window:
    """What a loop measured; the per-layer readers read it."""

    def __init__(self, kind: str):
        self.kind = kind
        self.dispatches = 0
        self.frames = 0
        self.seconds = 0.0
        self.macs = 0
        self.latency_s: List[float] = []
        self.issue_s: List[float] = []
        self.counts: List[tuple] = []
        self.calls: List[tuple] = []      # (MACs, bytes, device s)
        self.launches: Dict[str, int] = {}
        self.profile: Optional[dict] = None


class Loop:
    """The closed loop over one entry; dispatch numbers run on across
    the set-up, the window and the traced window."""

    def __init__(self, entry, in_flight: int, dev, seed: int,
                 fault: Optional[Callable] = None):
        self.entry, self.in_flight, self.dev = entry, in_flight, dev
        self.fault = fault
        self.n = 0
        self.slots = None
        self.spans = trace.Spans()
        self.rng = random.Random(gen.sub_seed(seed, "sample"))
        self.kept: List[tuple] = []
        self.seen = 0
        self.last = None

    def _slots(self, out):
        pin = self.dev.type == "cuda"
        return [[torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                 for t in self.entry.fetch(out)]
                for _ in range(self.in_flight)]

    def _offer(self, item) -> None:
        """Reservoir sample of the window's dispatches, seeded."""
        k = self.entry.keep
        if self.seen < k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < k:
                self.kept[j] = item
        self.seen += 1
        self.last = item

    def run(self, seconds: float, *, max_dispatches: Optional[int] = None,
            events: bool = False, sample: bool = True) -> Window:
        from repro_torch.kernels import ops
        entry, spans, dev = self.entry, self.spans, self.dev
        w = Window(entry.kind)
        pending = deque()
        before = ops.launch_counts()

        def finish():
            n, t_call, out, slot, ready, ev = pending.popleft()
            ready.synchronize()
            w.latency_s.append(time.perf_counter() - t_call)
            info = entry.answer(n, [h.clone() for h in slot])
            w.frames += info["frames"]
            w.macs += info["macs"]
            if info["counts"] is not None:
                w.counts.append(info["counts"])
            if ev is not None:
                w.calls.append((info["macs"], info["nbytes"], ev))
            if sample:
                self._offer((n, out, info))

        start = time.perf_counter()
        stop_at = start + seconds
        while time.perf_counter() < stop_at and (
                max_dispatches is None or w.dispatches < max_dispatches):
            n = self.n
            with spans("pool.next"):
                frames = entry.frames(n)
            ev = (_event(dev, True), _event(dev, True)) if events else None
            if ev:
                ev[0].record()
            t_call = time.perf_counter()
            with spans("plan.call"):
                out = entry.call(n, frames)
            w.issue_s.append(time.perf_counter() - t_call)
            if ev:
                ev[1].record()
            if self.fault is not None:
                out = self.fault(entry, n, out)
            entry.accept(out)
            if self.slots is None:
                self.slots = self._slots(out)
            slot = self.slots[n % self.in_flight]
            for host, t in zip(slot, entry.fetch(out)):
                host.fill_(UNANSWERED)
                host.copy_(t, non_blocking=True)
            ready = _event(dev)
            ready.record()
            pending.append((n, t_call, out, slot, ready, ev))
            self.n += 1
            w.dispatches += 1
            if len(pending) >= self.in_flight:
                with spans("labels.fetch"):
                    finish()
        with spans("labels.fetch"):
            while pending:
                finish()
        w.seconds = time.perf_counter() - start
        after = ops.launch_counts()
        w.launches = {k: after[k] - before.get(k, 0) for k in after}
        if events:
            w.calls = [(m, b, ev[0].elapsed_time(ev[1]) * 1e-3)
                       for m, b, ev in w.calls]
        return w

    def traced(self, seconds: float) -> Optional[dict]:
        """A loop of ``seconds`` under ``torch.profiler``, reduced."""
        from torch.profiler import ProfilerActivity, profile
        self.spans.marking = True
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function(trace.WINDOW):
                    self.run(seconds)
                torch.cuda.synchronize()
        finally:
            self.spans.marking = False
        return trace.reduce_profile(prof)


def compare(observed: List[dict], expected: List[dict]) -> Dict[str, int]:
    """Elements that differ, a key summed over the sampled dispatches."""
    out: Dict[str, int] = {}
    for obs, exp in zip(observed, expected):
        for key, want in exp.items():
            got = obs[key].detach().cpu()
            want = want.detach().cpu()
            if got.shape != want.shape:
                bad = max(got.numel(), want.numel())
            else:
                bad = int((got.to(want.dtype) != want).sum())
            out[key] = out.get(key, 0) + bad
    return out


def card() -> dict:
    """The card's name, power limit and clocks from ``nvidia-smi``."""
    query = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        text = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"nvidia_smi": "unavailable"}
    return dict(zip(query.split(","), (v.strip() for v in text.split(","))))


def percentile(values: List[float], q: int) -> float:
    """The q-th percentile (Python's ``statistics.quantiles``, n=100)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100)[q - 1]


def resolve(bench: dict, workload: str, root: Path = HERE) -> dict:
    """The cell's entry in ``bench`` and the files it names: its
    configuration, traffic mix, plan entry and per-layer readers."""
    cell = next(c for c in bench["workloads"] if c["name"] == workload)
    traffic = load_json("traffic", cell["traffic"], root)
    metrics = [m["name"] for m in bench["per_layer"]
               if workload in m.get("workloads", [workload])]
    return {"cell": cell,
            "config": load_json("configs", cell["config"], root),
            "traffic": traffic,
            "entry": root / "entries" / f"{traffic['entry']}.py",
            "metrics": {m: root / "metrics" / f"{m}.py" for m in metrics}}


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             t_start: float, bench: Optional[dict] = None, root: Path = HERE,
             device: str = "cuda", overrides: Optional[dict] = None,
             fault: Optional[Callable] = None,
             max_dispatches: Optional[int] = None,
             control: bool = False, log=print) -> dict:
    """One run of ``workload``; returns the result line's object.

    ``device``, ``overrides`` (traffic keys), ``fault`` (applied to each
    dispatch's outputs), ``max_dispatches`` and ``control`` are for tests
    and for the control's readings; a benchmark run leaves them alone.
    With ``control`` the reference at the control's precision takes the
    program's place in the comparison, so ``correct`` has to come out
    false.
    """
    bench = bench or load_bench()
    files = resolve(bench, workload, root)
    cfg = files["config"]
    traffic = dict(files["traffic"], **(overrides or {}))
    dev = torch.device(device)
    run = Run(cfg, traffic, seed, dev, t_start, log)
    run.mark("harness imported")
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats()
        run.mark("CUDA context made")
    entry = load_module("entries", traffic["entry"], root).build(run)
    run.mark("weights, pool and plan made")
    for name, value in getattr(entry, "shares", {}).items():
        log(f"traffic share {name} {value!r}")
    loop = Loop(entry, traffic["in_flight"], dev, seed, fault)
    loop.run(math.inf, max_dispatches=2 * traffic["in_flight"] + 2,
             sample=False)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    # the set-up's objects leave the collector's view: no full collection
    # walks them inside the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    log(f"setup: warm-up done at {setup_s:.3f} s")
    before = card() if dev.type == "cuda" else {}
    w = loop.run(seconds, max_dispatches=max_dispatches, events=traced)
    after = card() if dev.type == "cuda" else {}
    if traced and dev.type == "cuda":
        w.profile = loop.traced(min(seconds, TRACED_SECONDS))
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else 0)
    log(f"card before {before} after {after}")
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or its package loaded: {bad}")

    kept = list(loop.kept)
    if loop.last is not None and all(k[0] != loop.last[0] for k in kept):
        kept.append(loop.last)
    kept.sort(key=lambda k: k[0])
    observed = entry.observed(kept)
    entry.release()
    loop.kept = loop.last = None
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_ref = time.perf_counter()
    expected = entry.reference(kept)
    if control:
        observed = entry.reference(kept, input_mask=INPUT_LSB_OFF)
    checks = {"missing": w.dispatches * entry.batch - w.frames}
    checks.update(compare(observed, expected))
    log(f"checked dispatches {[k[0] for k in kept]} of {loop.n} "
        f"({len(kept) * entry.batch} frames) in "
        f"{time.perf_counter() - t_ref:.3f} s")
    correct = all(v == 0 for v in checks.values())

    names = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if not traced:
        values = {"frames_per_s": w.frames / w.seconds,
                  "label_p95_ms": 1e3 * percentile(w.latency_s, 95),
                  "setup_s": setup_s}
        wanted = [m["name"] for m in bench["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    else:
        values = {}
        wanted = list(files["metrics"])
        for name in wanted:
            value = load_module("metrics", name, root).read(w)
            if value is not None:
                values[name] = value
    for name in wanted:
        if name in values:
            metrics[name] = {"value": values[name], "unit": names[name]["unit"]}
    result = {"correct": correct,
              "attempted": w.dispatches * entry.batch,
              "failed": checks["missing"],
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": peak}}
    if traced and w.profile:
        result["device"]["busy_s"] = w.profile["busy_s"]
        result["device"]["window_s"] = w.profile["window_s"]
        result["breakdown"] = {"device_ops": w.profile["device_ops"],
                               "idle_gaps": w.profile["idle_gaps"]}
    result["window"] = {"dispatches": w.dispatches, "seconds": w.seconds,
                        "setup_s": setup_s, "card": after}
    result["checks"] = {k: {"value": v, "limit": 0}
                        for k, v in checks.items()}
    return result
