"""The fused cascade: ``CascadePlan.forward_fused``, a detector on every
frame and a recogniser on the frames whose margin reaches the threshold,
in one dispatch.

The pool holds exactly the traffic's share of frames at or above the
escalation threshold (``gen.escalation_pool``, calibrated on the
reference detector during set-up); the threshold reaches the program as
an input, through the plan's own ``margin_ctrl``.  A frame's label on the
host is the recogniser's where it escalated, else the detector's.
"""

from __future__ import annotations

import torch

from portbench import counts, gen
from portbench.reference import net, rules


class Cascade:
    kind = "cascade"
    keep = 8

    def __init__(self, run):
        from repro_torch.core.chip import interpreter
        run.mark("program imported")
        det, rec = run.cfg["stages"]
        self.det_layers, self.rec_layers = det["layers"], rec["layers"]
        self.positive = run.cfg["positive_class"]
        programs = {det["program"]: run.program(det),
                    rec["program"]: run.program(rec)}
        t = run.traffic
        self.batch = t["batch"]
        self.device = run.device
        self.classes = max(det["layers"][-1]["n"], rec["layers"][-1]["n"])
        self.params = {
            st["program"]: gen.draw_params(st["layers"], run.seed,
                                           "weights/" + st["program"],
                                           run.device)
            for st in (det, rec)}
        run.mark("weights drawn")
        det_fold = net.fold(self.params[det["program"]])
        self.pool, self.margin, self.shares = gen.escalation_pool(
            t["pool_batches"], self.batch, self.det_layers[0], run.seed,
            run.device, share=t["escalate_share"],
            candidates=t["candidates"],
            margin_of=lambda f: rules.margins(
                net.forward(det_fold, self.det_layers, f, block=512),
                self.positive))
        run.mark("escalation pool drawn")
        artifacts = {name: interpreter.fold_params(
            self.params[name], prog, image=True)
            for name, prog in programs.items()}
        self.plan, self.image = interpreter.pack_cascade(
            programs, artifacts, detector=det["program"],
            recognizer=rec["program"], positive_class=self.positive)
        self.names = (det["program"], rec["program"])
        run.mark("plan packed and weights folded")

    def frames(self, n: int):
        return self.pool[n % self.pool.shape[0]]

    def call(self, n: int, frames):
        ctrl = self.plan.margin_ctrl(float(self.margin), self.batch)
        return self.plan.forward_fused(
            self.image, frames, ctrl.to(self.device, non_blocking=True),
            device=self.device)

    def accept(self, out) -> None:
        pass

    @staticmethod
    def fetch(out):
        _dl, det_y, _rl, rec_y, queue, cnt = out
        return [det_y, rec_y, queue, cnt]

    def answer(self, n: int, host) -> dict:
        det_y, rec_y, queue, cnt = host
        e = int(cnt[0])
        labels = det_y.clone()
        labels[queue[:e].long()] = rec_y[:e]
        answered = int(((labels >= 0) & (labels < self.classes)).sum())
        macs, nbytes = counts.cascade_call(self.det_layers, self.rec_layers,
                                           self.batch, e)
        return dict(labels=labels, frames=answered, macs=macs,
                    nbytes=nbytes, counts=(e, int(cnt[1])))

    # -- the check ---------------------------------------------------------

    def release(self) -> None:
        self.image = self.plan = None

    @staticmethod
    def observed(kept):
        return [dict(det_logits=out[0], det_labels=out[1],
                     rec_logits=out[2], rec_labels=out[3], queue=out[4],
                     counts=out[5], host_labels=info["labels"])
                for _n, out, info in kept]

    def reference(self, kept, input_mask: int = -1):
        det_fold = net.fold(self.params[self.names[0]])
        rec_fold = net.fold(self.params[self.names[1]])
        out = []
        for n, _out, _info in kept:
            det, rec, queue, cnt = rules.cascade(
                lambda f: net.forward(det_fold, self.det_layers, f,
                                      input_mask=input_mask),
                lambda f: net.forward(rec_fold, self.rec_layers, f,
                                      input_mask=input_mask),
                self.frames(n), self.margin, self.positive)
            det, rec = det.to(torch.float32), rec.to(torch.float32)
            det_y, rec_y = det.argmax(dim=-1), rec.argmax(dim=-1)
            e = int(cnt[0])
            labels = det_y.clone()
            labels[queue[:e].long()] = rec_y[:e]
            out.append(dict(det_logits=det, det_labels=det_y,
                            rec_logits=rec, rec_labels=rec_y, queue=queue,
                            counts=cnt, host_labels=labels.cpu()))
        return out


def build(run):
    return Cascade(run)
