"""The plain reference against the program's CPU plain path.

The reference (``portbench/reference``) imports nothing of the program;
this test imports both and holds them to the same integers at small
batches: the network (solo), the escalation rule (cascade) and the gate
rule (delta, over several ticks from the cold start).
"""

import json
from pathlib import Path

import pytest
import torch

from portbench import gen
from portbench.harness import layers_of
from portbench.reference import net, rules
from repro_torch.core.chip import interpreter, networks

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _layers(program):
    return layers_of(networks.REGISTRY[program]())


def _params(program, seed):
    return gen.draw_params(_layers(program), seed, "test/" + program, "cpu")


@pytest.mark.parametrize("program,batch", [("cifar9_s1", 2),
                                           ("face_detector", 6),
                                           ("mnist5", 5)])
def test_network_matches_the_programs_megakernel_plain(program, batch):
    prog = networks.REGISTRY[program]()
    params = _params(program, 7)
    io = _layers(program)[0]
    frames = gen.uniform_pool(1, batch, io, 3, "cpu")[0]
    got, labels = interpreter.compile_plan(prog).forward_mega(
        interpreter.fold_params(params, prog, image=True), frames,
        device="cpu")
    want = net.forward(net.fold(params), _layers(program), frames)
    assert torch.equal(got, want.to(torch.float32))
    assert torch.equal(labels, want.to(torch.float32).argmax(dim=-1))


def test_config_layer_lists_are_the_programs():
    for path in sorted(CONFIGS.glob("*.json")):
        cfg = json.loads(path.read_text())
        for stage in cfg["stages"]:
            assert stage["layers"] == _layers(stage["program"]), path.name


@pytest.mark.parametrize("share", [0.5, 0.02])
def test_escalation_rule_matches_the_programs_cascade_plain(share):
    det_p, rec_p = "face_detector", "owner_detector"
    det_l, rec_l = _layers(det_p), _layers(rec_p)
    params = {det_p: _params(det_p, 11), rec_p: _params(rec_p, 12)}
    det_fold, rec_fold = net.fold(params[det_p]), net.fold(params[rec_p])
    pool, thr, shares = gen.escalation_pool(
        2, 8, det_l[0], 5, "cpu", share=share, candidates=2.0,
        margin_of=lambda f: rules.margins(net.forward(det_fold, det_l, f), 1))
    assert shares["escalated"] == round(share * 16) / 16
    programs = {det_p: networks.REGISTRY[det_p](),
                rec_p: networks.REGISTRY[rec_p]()}
    plan, image = interpreter.pack_cascade(
        programs, {n: interpreter.fold_params(params[n], p, image=True)
                   for n, p in programs.items()},
        detector=det_p, recognizer=rec_p, positive_class=1)
    for frames in pool:
        got = plan.forward_fused(image, frames,
                                 plan.margin_ctrl(float(thr), 8),
                                 device="cpu")
        want = rules.cascade(lambda f: net.forward(det_fold, det_l, f),
                             lambda f: net.forward(rec_fold, rec_l, f),
                             frames, thr, 1)
        assert torch.equal(got[0], want[0].to(torch.float32))
        assert torch.equal(got[2], want[1].to(torch.float32))
        for g, w in zip(got[4:], want[2:]):
            assert torch.equal(g, w)


def test_gate_rule_matches_the_programs_delta_plain_over_ticks():
    program = "cifar9_s4"
    layers = _layers(program)
    io = layers[0]
    params = _params(program, 21)
    prog = networks.REGISTRY[program]()
    pool, changed = gen.video_pool(6, 9, io, 4, "cpu", change_rate=0.34)
    plan, image = interpreter.pack_delta(
        prog, interpreter.fold_params(params, prog, image=True))
    last, llog = plan.init_state(9, device="cpu")
    gate = rules.Gate(io, 9)
    folded = net.fold(params)
    lanes = torch.arange(9)
    lane0_fresh_unchanged = 0
    for n in range(12):
        thr = float("-inf") if n == 0 else 1.0
        frames = pool[n % 6]
        logits, _y, last, llog, queue, cnt, deltas = plan.forward_delta(
            image, frames, last, llog, plan.delta_ctrl(thr, 9),
            device="cpu")
        d, mask, q, c, fresh = gate.step(gate.table[frames.long()], n,
                                         rules.threshold_int(thr))
        lane0_fresh_unchanged += int(fresh[0] and not mask[0])
        assert torch.equal(deltas, d) and torch.equal(queue, q)
        assert torch.equal(cnt, c)
        src = pool[gate.logit_ref % 6, lanes]
        assert torch.equal(llog, net.forward(folded, layers, src))
        words = rules.pack_planes(pool[gate.last_ref % 6, lanes],
                                  io["bits"], io["channels"])
        assert torch.equal(last, words)
    assert lane0_fresh_unchanged > 0      # the drain's lane-0 rule ran
