"""Dispatch executor: the mechanism that runs a policy's decisions.

The counterpart of ``repro.serving.executor``.  It owns everything
between a :class:`~repro_torch.serving.policy.Dispatch` decision and
host-side results:

* **launch** — pad each member lane's pull to the dispatch's batch (the
  always-on pipeline never idles: short lanes pad with the last real
  frame, empty lanes with zeros), copy the frames host -> device,
  scattered over the replica's device group, and run the program's serve
  function (the staged plan or the megakernel) on each device's share; the
  shares gather back in order.  A multi-lane dispatch runs as ONE
  shared-array composite launch a device (``interpreter.pack_programs``);
  composites, fused cascades (``interpreter.pack_cascade``) and
  delta-gated units (``interpreter.pack_delta``) are packed lazily and
  cached.  The cascade and the delta gate run on the group's first device.
* **warm start** — with ``warm_start=True`` every unit is built through
  the warm-start cache (:mod:`repro_torch.kernels.cache`): a second
  executor on the same programs, options, device group and artifacts (a
  fleet's replacement replica) reuses the plan, the serve functions and
  the artifacts already on its devices.
* **materialize / finish** — sync a dispatch's device tensors to host
  numpy (``.cpu()``) and unpack them into per-request
  :class:`FrameResult`\\ s.
* **depth-k prefetch pipeline** — :meth:`step` keeps up to ``prefetch``
  dispatches in flight before blocking on the oldest one, with finished
  results fetched to the host by a background thread at depth >= 2; the
  policy is consulted in exactly the synchronous order, so pipelining
  never changes the schedule.

Dispatches carry their own pad target (``Dispatch.batch``): a continuous
policy's early-and-small launches pad only to their ladder size, so the
burned-slot bill shrinks with the window.
"""

from __future__ import annotations

import collections
import concurrent.futures
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.chip import interpreter, isa
from repro_torch.distributed import sharding
from repro_torch.kernels import cache as warmcache
from repro_torch.serving.policy import Dispatch
from repro_torch.serving.queue import FrameRequest, FrameResult


class Executor:
    """Launch/materialize/finish + the prefetch pipeline for one server.

    ``programs``/``artifacts`` are keyed by resident program name;
    ``artifacts`` holds admission-time artifacts in any form, converted
    here to the form the serve function reads and replicated on every
    device of ``devices``, the replica's serving group (a tuple of
    ``torch.device``\\ s, ``distributed.sharding.serve_mesh``).
    """

    def __init__(self, programs: Mapping[str, isa.Program],
                 artifacts: Mapping[str, Any], *, batch: int,
                 devices: Tuple[torch.device, ...],
                 megakernel: bool = False, prefetch: int = 0,
                 warm_start: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self.batch = batch
        self.prefetch = prefetch
        self.clock = clock
        self.devices = tuple(devices)
        self.device = self.devices[0]
        self._megakernel = megakernel
        self._warm_start = warm_start
        self.programs: Dict[str, isa.Program] = dict(programs)
        self._raw_artifacts: Dict[str, Any] = dict(artifacts)
        self.plans: Dict[str, interpreter.InferencePlan] = {}
        self.artifacts: Dict[str, Any] = {}     # on the group's first device
        self._replicas: Dict[str, tuple] = {}   # one a group device
        self._fns: Dict[str, tuple] = {}        # one a group device
        self._geom: Dict[str, Tuple[int, int, int]] = {}
        for name, prog in self.programs.items():
            isa.validate(prog)
            io = prog.instrs[0]
            self._geom[name] = (io.height, io.width, io.in_channels)
            unit = self._unit(
                (prog,), (artifacts[name],), "serve",
                lambda prog=prog, raw=artifacts[name]: (
                    interpreter.compile_plan(prog),
                    interpreter.ensure_image(raw, prog) if megakernel
                    else interpreter.ensure_packed(raw)),
                lambda plan, d: plan.make_serve_fn(megakernel=megakernel,
                                                   device=d))
            self.plans[name] = unit["plan"]
            self._replicas[name] = unit["images"]
            self.artifacts[name] = unit["image"]
            self._fns[name] = unit["fns"]
        self._composites: Dict[Tuple[str, ...], Dict[str, Any]] = {}
        self._cascades: Dict[Tuple[str, str, int], Dict[str, Any]] = {}
        self._deltas: Dict[Tuple[str, Optional[int], int], Dict[str, Any]] = {}
        self._inflight: collections.deque = collections.deque()
        # background fetch only pays off at depth >= 2: with one handle in
        # flight the consumer blocks on it at once
        self._fetch_pool: Optional[concurrent.futures.ThreadPoolExecutor] = (
            concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="serve-fetch")
            if self.prefetch >= 2 else None)

    def _unit(self, progs, raws, kind: str, pack, make_fn,
              devices=None) -> Dict[str, Any]:
        """Build (or warm-start) a serving unit on ``devices`` (default:
        the group): ``pack() -> (plan, artifact)`` and
        ``make_fn(plan, device) -> serve fn``.  Returns ``plan``, the
        per-device ``images`` and ``fns``, and the first device's
        ``image`` and ``fn``."""
        devices = self.devices if devices is None else devices
        packed = []

        def build():
            plan, art = pack()
            packed.append(art)
            return dict(plan=plan,
                        fns=tuple(make_fn(plan, d) for d in devices))

        def place():
            art = packed[0] if packed else pack()[1]
            return sharding.replicate_artifact(devices, art)

        if self._warm_start:
            key = warmcache.serve_fn_key(
                progs, devices=devices,
                megakernel=self._megakernel and kind == "serve", kind=kind)
            entry = warmcache.get_or_build(key, build)
            images = warmcache.upload(entry, raws, place)
        else:
            entry = build()
            images = place()
        return dict(plan=entry["plan"], images=images, fns=entry["fns"],
                    image=images[0], fn=entry["fns"][0])

    def geometry(self, variant: str) -> Tuple[int, int, int]:
        return self._geom[variant]

    # -- composite and cascade packing --------------------------------------

    def composite_for(self, variants: Tuple[str, ...]) -> Dict[str, Any]:
        """The packed shared-array composite for an ordered variant tuple
        (lazy; cached): its plan, its image and serve function on each
        group device (``images``/``fns``), the first device's as
        ``image``/``fn``."""
        comp = self._composites.get(variants)
        if comp is None:
            comp = self._unit(
                tuple(self.programs[v] for v in variants),
                tuple(self._raw_artifacts[v] for v in variants), "composite",
                lambda: interpreter.pack_programs(
                    {v: self.programs[v] for v in variants},
                    {v: self._raw_artifacts[v] for v in variants}),
                lambda plan, d: plan.make_serve_fn(device=d))
            self._composites[variants] = comp
        return comp

    def cascade_for(self, detector: str, recognizer: str, *,
                    positive_class: int = 1) -> Dict[str, Any]:
        """The packed fused detector -> recognizer cascade for a variant
        pair on the group's first device (lazy; cached like
        :meth:`composite_for`, keyed with the positive class)."""
        key = (detector, recognizer, positive_class)
        casc = self._cascades.get(key)
        if casc is None:
            pair = (detector, recognizer)
            casc = self._unit(
                tuple(self.programs[v] for v in pair),
                tuple(self._raw_artifacts[v] for v in pair),
                f"cascade.p{positive_class}",
                lambda: interpreter.pack_cascade(
                    {v: self.programs[v] for v in pair},
                    {v: self._raw_artifacts[v] for v in pair},
                    detector=detector, recognizer=recognizer,
                    positive_class=positive_class),
                lambda plan, d: plan.make_serve_fn(device=d),
                devices=self.devices[:1])
            self._cascades[key] = casc
        return casc

    def delta_for(self, variant: str, *, rb: Optional[int] = None,
                  check_every: int = 1) -> Dict[str, Any]:
        """The delta-gated serving unit for one resident variant on the
        group's first device (lazy; cached by ``(variant, rb,
        check_every)``): its ``DeltaPlan``, its weight image and its serve
        function ``(image, frames, last, llog, ctrl) -> gated outputs``
        with the drain schedule fixed."""
        key = (variant, rb, check_every)
        dl = self._deltas.get(key)
        if dl is None:
            dl = self._unit(
                (self.programs[variant],), (self._raw_artifacts[variant],),
                "delta.r%s.c%d" % (rb or 0, check_every),
                lambda: interpreter.pack_delta(
                    self.programs[variant], self._raw_artifacts[variant],
                    name=variant),
                lambda plan, d: plan.make_serve_fn(
                    device=d, rb=rb, check_every=check_every),
                devices=self.devices[:1])
            self._deltas[key] = dl
        return dl

    def warm_composites(self, groups) -> None:
        """Pack the composites of admission-time groups up front (the chip
        loads every resident program's weights before serving)."""
        for members in groups:
            self.composite_for(tuple(members))

    @property
    def compiled_composites(self) -> Tuple[Tuple[str, ...], ...]:
        return tuple(self._composites)

    # -- launch / materialize / finish --------------------------------------

    def pad_frames(self, reqs: List[FrameRequest],
                   geom: Tuple[int, int, int],
                   size: Optional[int] = None) -> np.ndarray:
        """Stack a lane's pull into a batch of ``size`` (default: the
        static batch): short lanes pad with the last real frame, empty
        lanes with zeros; the burned slots are billed."""
        size = self.batch if size is None else size
        if reqs:
            frames = np.stack([r.frame for r in reqs])
            if len(reqs) < size:
                pad = np.broadcast_to(
                    frames[-1], (size - len(reqs),) + frames.shape[1:])
                frames = np.concatenate([frames, pad])
        else:
            frames = np.zeros((size,) + geom, dtype=np.int32)
        return frames

    def launch(self, dispatch: Dispatch, index: int) -> Dict[str, Any]:
        """Run one policy decision on the group; returns the in-flight
        handle (device tensors on the first device, not yet synced)."""
        size = dispatch.batch if dispatch.batch is not None else self.batch
        # per lane, its frames scattered: shares[lane][device]
        shares = [sharding.scatter_frames(self.devices, torch.from_numpy(
            np.ascontiguousarray(self.pad_frames(
                list(ld.requests), self._geom[ld.variant], size),
                dtype=np.int32))) for ld in dispatch.lanes]
        gather = lambda parts: sharding.gather_frames(self.devices, parts)
        if dispatch.composite:
            comp = self.composite_for(
                tuple(ld.variant for ld in dispatch.lanes))
            outs = [fn(img, tuple(s[i] for s in shares)) for i, (fn, img)
                    in enumerate(zip(comp["fns"], comp["images"]))]
            logits = tuple(gather([o[0][m] for o in outs])
                           for m in range(len(dispatch.lanes)))
            labels = tuple(gather([o[1][m] for o in outs])
                           for m in range(len(dispatch.lanes)))
        else:
            ld, = dispatch.lanes
            outs = [fn(img, s) for fn, img, s in zip(
                self._fns[ld.variant], self._replicas[ld.variant],
                shares[0])]
            logits = gather([o[0] for o in outs])
            labels = gather([o[1] for o in outs])
        done = None
        if self.device.type == "cuda":
            # the fetch thread copies on its own stream, so it waits on
            # this mark of the launch stream first
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return dict(dispatch=dispatch, index=index, logits=logits,
                    labels=labels, done=done)

    @staticmethod
    def materialize(handle: Dict[str, Any]):
        """Sync an in-flight dispatch's device tensors to host numpy (runs
        on the fetch thread when prefetching)."""
        if handle["done"] is not None:
            handle["done"].synchronize()
        if handle["dispatch"].composite:
            return (tuple(lg.cpu().numpy() for lg in handle["logits"]),
                    tuple(y.cpu().numpy() for y in handle["labels"]))
        return handle["logits"].cpu().numpy(), handle["labels"].cpu().numpy()

    def finish(self, handle: Dict[str, Any]) -> List[FrameResult]:
        """Block on an in-flight dispatch and materialize its results."""
        if "future" in handle:
            logits, labels = handle["future"].result()
        else:
            logits, labels = self.materialize(handle)
        dispatch: Dispatch = handle["dispatch"]
        t_done = self.clock()        # label available on the host, now
        if not dispatch.composite:
            logits, labels = (logits,), (labels,)
        return [FrameResult(rid=r.rid, program=ld.lane,
                            label=int(labels[mi][i]), logits=logits[mi][i],
                            dispatch=handle["index"], variant=ld.variant,
                            t_submit=r.t_submit, t_done=t_done)
                for mi, ld in enumerate(dispatch.lanes)
                for i, r in enumerate(ld.requests)]

    # -- the prefetch pipeline ----------------------------------------------

    def _fill(self, launch_fn: Callable[[], Optional[Dict[str, Any]]]) -> None:
        """Launch dispatches until ``prefetch`` are in flight (or the
        queue drains), handing each to the background fetch thread."""
        while len(self._inflight) < self.prefetch:
            handle = launch_fn()
            if handle is None:
                return
            if self._fetch_pool is not None:
                handle["future"] = self._fetch_pool.submit(
                    self.materialize, handle)
            self._inflight.append(handle)

    def step(self, launch_fn: Callable[[], Optional[Dict[str, Any]]]
             ) -> List[FrameResult]:
        """One dispatch through the pipeline: synchronous when
        ``prefetch == 0``, else keep the pipeline filled and block only
        on the oldest in-flight dispatch."""
        if not self.prefetch:
            cur = launch_fn()
            return [] if cur is None else self.finish(cur)
        self._fill(launch_fn)
        if not self._inflight:
            return []
        cur = self._inflight.popleft()
        self._fill(launch_fn)                  # stage N+1.. while N runs
        return self.finish(cur)

    def abort(self) -> List[FrameRequest]:
        """Simulated host loss: drop every in-flight dispatch WITHOUT
        materializing results and hand back the orphaned requests, oldest
        dispatch first (a fleet re-enqueues them, in order, at the front
        of a survivor's lanes).  Device work already launched is
        abandoned; its energy was billed at launch.

        The fetch thread is shut down before this returns: queued fetches
        are cancelled and a fetch already running completes into a future
        nobody reads, so no result of this executor reaches anyone after
        ``abort``.  The abandoned device tensors stay referenced by their
        handles until then; the caching allocator reuses their memory only
        in stream order, after the kernels writing them, so replicas
        sharing a card are safe."""
        orphans: List[FrameRequest] = []
        while self._inflight:
            handle = self._inflight.popleft()
            fut = handle.get("future")
            if fut is not None:
                fut.cancel()
            for ld in handle["dispatch"].lanes:
                orphans.extend(ld.requests)
        if self._fetch_pool is not None:
            self._fetch_pool.shutdown(wait=True, cancel_futures=True)
            self._fetch_pool = None
        return orphans

    def close(self) -> None:
        """Release the background fetch thread, syncing (and discarding)
        any in-flight dispatches; safe to call more than once."""
        while self._inflight:
            self.finish(self._inflight.popleft())
        if self._fetch_pool is not None:
            self._fetch_pool.shutdown(wait=True)
            self._fetch_pool = None
