"""The delta gate: ``DeltaPlan.forward_delta`` over always-on streams.

Each dispatch is one tick of ``batch`` camera streams, one frame each,
from a cycled pool of ticks (``gen.video_pool``).  The gate's state (each
stream's last frame and cached logits) carries from tick to tick on the
device.  The first tick, in set-up, starts cold at threshold -inf, so
every stream computes; every later tick gates at the traffic's
threshold, through the plan's own ``delta_ctrl``.  All of a tick's
streams' labels reach the host, skipped or computed.
"""

from __future__ import annotations

import torch

from portbench import counts, gen
from portbench.reference import net, rules


class Delta:
    kind = "delta"
    keep = 3

    def __init__(self, run):
        from repro_torch.core.chip import interpreter
        run.mark("program imported")
        stage = run.cfg["stages"][0]
        self.layers = stage["layers"]
        program = run.program(stage)
        t = run.traffic
        self.batch = t["batch"]
        self.threshold = t["gate_threshold"]
        self.device = run.device
        self.classes = self.layers[-1]["n"]
        self.params = gen.draw_params(self.layers, run.seed,
                                      "weights/" + stage["program"],
                                      run.device)
        run.mark("weights drawn")
        self.pool, changed = gen.video_pool(
            t["pool_batches"], self.batch, self.layers[0], run.seed,
            run.device, change_rate=t["change_rate"], patch=t["patch"])
        self.shares = {"changed": float(changed.float().mean())}
        run.mark("video pool drawn")
        self.plan, self.image = interpreter.pack_delta(
            program, interpreter.fold_params(self.params, program,
                                             image=True),
            name=stage["program"])
        self.state = self.plan.init_state(self.batch, device=run.device)
        run.mark("plan packed, weights folded, state made")

    def frames(self, n: int):
        return self.pool[n % self.pool.shape[0]]

    def _threshold(self, n: int) -> float:
        return float("-inf") if n == 0 else float(self.threshold)

    def call(self, n: int, frames):
        ctrl = self.plan.delta_ctrl(self._threshold(n), self.batch)
        last, llog = self.state
        return self.plan.forward_delta(
            self.image, frames, last, llog,
            ctrl.to(self.device, non_blocking=True), device=self.device)

    def accept(self, out) -> None:
        self.state = (out[2], out[3])

    @staticmethod
    def fetch(out):
        return [out[1], out[5]]

    def answer(self, n: int, host) -> dict:
        labels, cnt = host
        k = int(cnt[0])
        answered = int(((labels >= 0) & (labels < self.classes)).sum())
        macs, nbytes = counts.delta_call(self.layers, self.batch, k)
        return dict(labels=labels, frames=answered, macs=macs,
                    nbytes=nbytes, counts=(k, int(cnt[1])))

    # -- the check ---------------------------------------------------------

    def release(self) -> None:
        self.image = self.plan = self.state = None

    @staticmethod
    def observed(kept):
        return [dict(logits=out[0], labels=out[1], state_words=out[2],
                     state_logits=out[3], queue=out[4], counts=out[5],
                     deltas=out[6], host_labels=info["labels"])
                for _n, out, info in kept]

    def reference(self, kept, input_mask: int = -1):
        """Replays every tick from the cold start through the gate's rule
        (``rules.Gate``), then runs the network where the kept ticks'
        answers come from."""
        io = self.layers[0]
        folded = net.fold(self.params)
        gate = rules.Gate(io, self.batch, device=self.pool.device)
        lanes = torch.arange(self.batch, device=self.pool.device)
        wanted = {n for n, _o, _i in kept}
        ticks = self.pool.shape[0]
        found = {}
        for n in range(max(wanted) + 1):
            plane = gate.table[(self.frames(n) & input_mask).long()]
            thr = rules.threshold_int(self._threshold(n))
            deltas, _mask, queue, cnt, _fresh = gate.step(plane, n, thr)
            if n in wanted:
                found[n] = (deltas, queue, cnt, gate.last_ref.clone(),
                            gate.logit_ref.clone())
        out = []
        for n, _out, _info in kept:
            deltas, queue, cnt, last_ref, logit_ref = found[n]
            src = self.pool[logit_ref % ticks, lanes]
            logits = net.forward(folded, self.layers, src,
                                 input_mask=input_mask)
            words = rules.pack_planes(self.pool[last_ref % ticks, lanes]
                                      & input_mask, io["bits"],
                                      io["channels"])
            flog = logits.to(torch.float32)
            labels = flog.argmax(dim=-1)
            out.append(dict(logits=flog, labels=labels, state_words=words,
                            state_logits=logits, queue=queue, counts=cnt,
                            deltas=deltas, host_labels=labels.cpu()))
        return out


def build(run):
    return Delta(run)
