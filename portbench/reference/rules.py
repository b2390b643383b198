"""The cascade's escalation rule and the delta gate's rule, in plain
PyTorch: what a fused detector -> recognizer dispatch and a delta-gated
tick must answer, given the network (``net.forward``) as a function.

Frozen copies of the deployment's semantics:

* The drain bill.  A dispatch of B frames pads to ``bpad = ceil(B / bb) *
  bb`` slots (bb = 8); the recogniser (or the recompute) drains its queue
  in chunks of ``rb`` (0 means bb), ``check_every`` chunks a group, and
  every group that starts below the queue's length K runs whole, so
  ``slots = sum over groups g0 with g0 * rb < K of rb * min(check_every,
  chunks - g0)``.
* Escalation.  A frame escalates when its detector margin, the
  positive-class logit minus the best other logit, reaches the integer
  threshold ``ceil(margin)`` and its lane is below ``n_real``.  The queue
  lists the escalated frames in ascending order, zeros after them; the
  recogniser's answer k belongs to frame queue[k], rows from E on are 0.
* The gate.  Each stream's frame is compared, as thermometer bit planes,
  with the frame it last recomputed on; the distance is the count of
  differing planes.  A lane changes when its distance reaches the
  threshold (and its lane is below ``n_real``): its last frame advances
  and its logits are recomputed; the others emit their cached logits.
  The drain recomputes whole chunks, and queue rows from K on hold lane
  0, so lane 0 is recomputed on its current frame whenever the drain
  covers a row at or past K (``min(slots, bpad) > K``), even unchanged;
  its last frame does not advance then.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from . import net

INT32_MIN = -2 ** 31
INT32_MAX = 2 ** 31 - 1


def threshold_int(threshold: float) -> int:
    """The integer a float threshold means for integer values:
    ``v >= t  <=>  v >= ceil(t)``; infinities clamp to the int32 ends."""
    if threshold == float("-inf"):
        return INT32_MIN
    if threshold == float("inf"):
        return INT32_MAX
    return int(min(max(math.ceil(threshold), INT32_MIN), INT32_MAX))


def schedule(b: int, bb: int = 8, rb: int = 0) -> Tuple[int, int]:
    """``(bpad, rb)`` of a dispatch of ``b`` frames."""
    bb = max(1, min(bb, b))
    bpad = -(-b // bb) * bb
    return bpad, max(1, min(rb if rb else bb, bpad))


def drain_slots(k: int, bpad: int, rb: int, check_every: int = 1) -> int:
    """Slots the drain runs, and bills, for a queue of ``k`` entries."""
    chunks = -(-bpad // rb)
    return sum(rb * min(check_every, chunks - g0)
               for g0 in range(0, chunks, check_every) if g0 * rb < k)


def margins(det: torch.Tensor, positive: int) -> torch.Tensor:
    """(B, C) integer logits -> (B,) positive-class margin over the best
    other class."""
    others = torch.cat([det[:, :positive], det[:, positive + 1:]], dim=1)
    return det[:, positive] - others.amax(dim=1)


def cascade(det_net: Callable, rec_net: Callable, frames: torch.Tensor,
            threshold: int, positive: int, n_real: int = None):
    """One fused dispatch: ``(det (B, Cd), rec (B, Cr), queue (B,),
    counts (2,))``, int32; ``det_net`` and ``rec_net`` map frames to
    logits."""
    b = frames.shape[0]
    n_real = b if n_real is None else n_real
    det = det_net(frames)
    lane = torch.arange(b, device=frames.device)
    idx = torch.nonzero((margins(det, positive) >= threshold)
                        & (lane < n_real))[:, 0]
    e = int(idx.numel())
    queue = torch.zeros(b, dtype=torch.int32, device=frames.device)
    queue[:e] = idx.to(torch.int32)
    rec_part = rec_net(frames[idx])
    rec = torch.zeros((b, rec_part.shape[1]), dtype=torch.int32,
                      device=frames.device)
    rec[:e] = rec_part
    bpad, rb = schedule(b)
    counts = torch.tensor([e, drain_slots(e, bpad, rb)], dtype=torch.int32,
                          device=frames.device)
    return det, rec, queue, counts


def plane_counts(bits: int, per: int, device=None) -> torch.Tensor:
    """(2**bits,) int32: for each pixel value v, the thermometer planes at
    +1 (``#{i : v >= t_i}``).  Two values differ in exactly
    ``|count(v) - count(u)|`` planes; a value's planes at -1 number
    ``per - count(v)``."""
    v = torch.arange(2 ** bits, dtype=torch.float32, device=device)
    t = net.thresholds(bits, per, device=device)
    return (v[:, None] >= t[None, :]).sum(dim=1).to(torch.int32)


class Gate:
    """The delta gate's state machine over a stream of ticks.

    Tracks, for every stream, which frame its last-frame state holds and
    which frame its cached logits were computed on, as references into the
    caller's frame store (``None`` for the cold state), and turns each
    tick's frames into the gate's answers.  The network is not run here:
    :meth:`step` returns which lanes compute, and the caller evaluates
    logits only where it compares them.
    """

    def __init__(self, io: dict, streams: int, device=None):
        self.streams = streams
        self.per = io["channels"] // io["cin"]
        self.table = plane_counts(io["bits"], self.per, device=device)
        self.last = None       # (S, H, W, Cin) plane counts of last frames
        self.last_ref = torch.full((streams,), -1, dtype=torch.int64,
                                   device=device)
        self.logit_ref = torch.full((streams,), -1, dtype=torch.int64,
                                    device=device)

    def step(self, counts_now: torch.Tensor, tick: int, threshold: int,
             n_real: int = None):
        """Advance every stream by one tick.

        ``counts_now`` is ``plane_counts`` of this tick's frames, (S, H,
        W, Cin); ``tick`` names this tick's frames for the references.
        Returns ``(deltas, mask, queue, counts, fresh)``: int32 distances,
        the changed lanes, the queue and [K, slots] as the gate writes
        them, and the lanes whose logits are recomputed.
        """
        s = self.streams
        n_real = s if n_real is None else n_real
        dev = counts_now.device
        if self.last is None:    # cold: zero words, every plane at +1
            self.last = torch.full_like(counts_now, self.per)
        d = (counts_now - self.last).abs().sum(dim=(1, 2, 3)).to(torch.int32)
        live = torch.arange(s, device=dev) < n_real
        mask = (d >= threshold) & live
        deltas = torch.where(live, d, torch.zeros_like(d))
        idx = torch.nonzero(mask)[:, 0]
        k = int(idx.numel())
        queue = torch.zeros(s, dtype=torch.int32, device=dev)
        queue[:k] = idx.to(torch.int32)
        bpad, rb = schedule(s)
        slots = drain_slots(k, bpad, rb)
        fresh = mask.clone()
        if min(slots, bpad) > k and int(queue[0]) != 0:
            fresh[0] = True
        self.last = torch.where(mask[:, None, None, None], counts_now,
                                self.last)
        self.last_ref = torch.where(mask, torch.full_like(self.last_ref,
                                                          tick),
                                    self.last_ref)
        self.logit_ref = torch.where(fresh, torch.full_like(self.logit_ref,
                                                            tick),
                                     self.logit_ref)
        counts = torch.tensor([k, slots], dtype=torch.int32, device=dev)
        return deltas, mask, queue, counts, fresh


def pack_planes(frames: torch.Tensor, bits: int, channels: int,
                block: int = 256) -> torch.Tensor:
    """(B, H, W, Cin) pixels -> (B, H, W, channels // 32) int32 words of
    the thermometer planes, bit 1 for a -1 plane, 32 channels a word
    least significant bit first, channel ``c * per + i`` for plane i of
    color c, leftover channels 0; in blocks of ``block`` frames."""
    shifts = torch.arange(32, device=frames.device)
    out = []
    for i in range(0, frames.shape[0], block):
        planes = net.thermometer(frames[i:i + block], bits, channels) < 0
        b, h, w, _ = planes.shape
        lanes = planes.reshape(b, h, w, channels // 32, 32).to(torch.int64)
        words = (lanes << shifts).sum(dim=-1)
        out.append(torch.where(words >= 2 ** 31, words - 2 ** 32,
                               words).to(torch.int32))
    return torch.cat(out)
