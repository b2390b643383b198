"""Dispatch executor: the mechanism that runs a policy's decisions.

The counterpart of ``repro.serving.executor`` for single-program
dispatches.  It owns everything between a :class:`~repro_torch.serving.
policy.Dispatch` decision and host-side results:

* **launch** — pad the lane's pull to the dispatch's batch (the always-on
  pipeline never idles: short lanes pad with the last real frame, empty
  lanes with zeros), copy the frames host -> device, and run the
  program's serve function (the staged plan or the megakernel).
* **materialize / finish** — sync a dispatch's device tensors to host
  numpy (``.cpu()``) and unpack them into per-request
  :class:`FrameResult`\\ s.
* **depth-k prefetch pipeline** — :meth:`step` keeps up to ``prefetch``
  dispatches in flight before blocking on the oldest one, with finished
  results fetched to the host by a background thread at depth >= 2; the
  policy is consulted in exactly the synchronous order, so pipelining
  never changes the schedule.
"""

from __future__ import annotations

import collections
import concurrent.futures
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.chip import interpreter, isa
from repro_torch.serving.policy import Dispatch
from repro_torch.serving.queue import FrameRequest, FrameResult


class Executor:
    """Launch/materialize/finish + the prefetch pipeline for one server.

    ``programs``/``artifacts`` are keyed by resident program name;
    ``artifacts`` holds admission-time artifacts in any form, converted
    here to the form the serve function reads and placed on ``device``.
    """

    def __init__(self, programs: Mapping[str, isa.Program],
                 artifacts: Mapping[str, Any], *, batch: int,
                 megakernel: bool = False, prefetch: int = 0,
                 device=None,
                 clock: Callable[[], float] = time.perf_counter):
        self.batch = batch
        self.prefetch = prefetch
        self.clock = clock
        self.device = _device.resolve(device)
        self.programs: Dict[str, isa.Program] = dict(programs)
        self.plans: Dict[str, interpreter.InferencePlan] = {}
        self.artifacts: Dict[str, Any] = {}
        self._fns: Dict[str, Any] = {}
        self._geom: Dict[str, Tuple[int, int, int]] = {}
        for name, prog in self.programs.items():
            isa.validate(prog)
            plan = interpreter.compile_plan(prog)
            if megakernel:
                art = interpreter.ensure_image(artifacts[name], prog)
            else:
                art = interpreter.ensure_packed(artifacts[name])
            io = prog.instrs[0]
            self.plans[name] = plan
            self.artifacts[name] = _device.to_device(art, self.device)
            self._geom[name] = (io.height, io.width, io.in_channels)
            self._fns[name] = plan.make_serve_fn(megakernel=megakernel,
                                                 device=self.device)
        self._inflight: collections.deque = collections.deque()
        # background fetch only pays off at depth >= 2: with one handle in
        # flight the consumer blocks on it at once
        self._fetch_pool: Optional[concurrent.futures.ThreadPoolExecutor] = (
            concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="serve-fetch")
            if self.prefetch >= 2 else None)

    def geometry(self, variant: str) -> Tuple[int, int, int]:
        return self._geom[variant]

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
        """Run one policy decision on the device; returns the in-flight
        handle (device tensors, not yet synced)."""
        size = dispatch.batch if dispatch.batch is not None else self.batch
        ld, = dispatch.lanes
        frames = torch.from_numpy(np.ascontiguousarray(
            self.pad_frames(list(ld.requests), self._geom[ld.variant], size),
            dtype=np.int32)).to(self.device)
        logits, labels = self._fns[ld.variant](self.artifacts[ld.variant],
                                               frames)
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
        labels = handle["labels"].cpu().numpy()
        logits = handle["logits"].cpu().numpy()
        return logits, labels

    def finish(self, handle: Dict[str, Any]) -> List[FrameResult]:
        """Block on an in-flight dispatch and materialize its results."""
        if "future" in handle:
            logits, labels = handle["future"].result()
        else:
            logits, labels = self.materialize(handle)
        dispatch: Dispatch = handle["dispatch"]
        t_done = self.clock()        # label available on the host, now
        ld, = dispatch.lanes
        return [FrameResult(rid=r.rid, program=ld.lane, label=int(labels[i]),
                            logits=logits[i], dispatch=handle["index"],
                            variant=ld.variant,
                            t_submit=r.t_submit, t_done=t_done)
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
        """Drop every in-flight dispatch WITHOUT materializing results and
        hand back the orphaned requests, oldest dispatch first.  Device
        work already launched is abandoned; its energy was billed at
        launch."""
        orphans: List[FrameRequest] = []
        while self._inflight:
            handle = self._inflight.popleft()
            fut = handle.get("future")
            if fut is not None:
                fut.cancel()
            for ld in handle["dispatch"].lanes:
                orphans.extend(ld.requests)
        if self._fetch_pool is not None:
            self._fetch_pool.shutdown(wait=False, cancel_futures=True)
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
