"""The solo megakernel: ``InferencePlan.forward_mega`` on a batch of frames.

Each dispatch classifies ``batch`` frames from a pool of uniform pixels
on the device; the labels are what reach the host.
"""

from __future__ import annotations

import torch

from portbench import counts, gen
from portbench.reference import net


class Solo:
    kind = "solo"
    keep = 8                     # dispatches the check samples

    def __init__(self, run):
        from repro_torch.core.chip import interpreter
        run.mark("program imported")
        stage = run.cfg["stages"][0]
        self.layers = stage["layers"]
        program = run.program(stage)
        t = run.traffic
        self.batch = t["batch"]
        self.device = run.device
        self.classes = self.layers[-1]["n"]
        self.params = gen.draw_params(self.layers, run.seed,
                                      "weights/" + stage["program"],
                                      run.device)
        run.mark("weights drawn")
        self.plan = interpreter.compile_plan(program)
        self.image = interpreter.fold_params(self.params, program,
                                             image=True)
        run.mark("plan compiled and weights folded")
        self.pool = gen.uniform_pool(t["pool_batches"], self.batch,
                                     self.layers[0], run.seed, run.device)
        self.macs, self.nbytes = counts.solo_call(self.layers, self.batch)

    def frames(self, n: int):
        return self.pool[n % self.pool.shape[0]]

    def call(self, n: int, frames):
        return self.plan.forward_mega(self.image, frames, device=self.device)

    def accept(self, out) -> None:
        pass

    @staticmethod
    def fetch(out):
        return [out[1]]

    def answer(self, n: int, host) -> dict:
        labels = host[0]
        answered = int(((labels >= 0) & (labels < self.classes)).sum())
        return dict(labels=labels, frames=answered, macs=self.macs,
                    nbytes=self.nbytes, counts=None)

    # -- the check ---------------------------------------------------------

    def release(self) -> None:
        self.image = self.plan = None

    @staticmethod
    def observed(kept):
        return [dict(logits=out[0],
                     labels=out[1], host_labels=info["labels"])
                for _n, out, info in kept]

    def reference(self, kept, input_mask: int = -1):
        folded = net.fold(self.params)
        out = []
        for n, _out, _info in kept:
            logits = net.forward(folded, self.layers, self.frames(n),
                                 input_mask=input_mask)
            logits = logits.to(torch.float32)
            labels = torch.argmax(logits, dim=-1)
            out.append(dict(logits=logits, labels=labels,
                            host_labels=labels.cpu()))
        return out


def build(run):
    return Solo(run)
