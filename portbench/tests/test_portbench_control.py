"""The check can fail: the control (the reference at 6 of the 7 input
bits in the program's place), each fault a cell can have and labels that
never reach the host turn ``correct`` false, while the sound run stays
correct.

Runs the harness on the CPU, past its look for a card, at small sizes,
with the program's plain versions under it; the faults are planted in
what each dispatch returns.
"""

import time

import pytest
import torch

from portbench import harness

SMALL = {"cifar9_s1.bulk": dict(batch=4, pool_batches=2),
         "face_cascade.busy": dict(batch=8, pool_batches=2),
         "cifar9_s1.video": dict(batch=8, pool_batches=5)}


def _run(workload, fault=None, control=False):
    return harness.run_cell(workload, 2 ** 31 + 11, 60.0, False,
                            t_start=time.perf_counter(), device="cpu",
                            overrides=SMALL[workload], fault=fault,
                            max_dispatches=3, control=control,
                            log=lambda *a: None)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_passes_and_the_control_fails(workload):
    sound = _run(workload)
    assert sound["correct"] and sound["failed"] == 0
    assert {v["value"] for v in sound["checks"].values()} == {0}
    control = _run(workload, control=True)
    assert not control["correct"]
    assert max(v["value"] for v in control["checks"].values()) > 0


def _half_left_out(entry, n, out):
    """The second half of the batch answered with the first half's."""
    out = [t.clone() for t in out]
    half = entry.batch // 2
    for i in range(len(out)):
        if out[i].ndim >= 1 and out[i].shape[0] == entry.batch and (
                out[i].dtype != torch.int32 or out[i].ndim > 1):
            out[i][half:2 * half] = out[i][:half]
    return tuple(out)


def _answer_altered(entry, n, out):
    """One logit of frame 0 moved by 2 where the kernel wrote it."""
    out = [t.clone() for t in out]
    out[0][0, 0] += 2
    return tuple(out)


def _state_unchanged(entry, n, out):
    """The gate's step hands back the state it was given."""
    out = list(out)
    out[2], out[3] = entry.state
    return tuple(out)


LABELS = {"solo": (1,), "cascade": (1, 3), "delta": (1,)}


def _labels_lost(entry, n, out):
    """Half of the batch's labels never written: still the host slot's
    contents from before the copy."""
    out = [t.clone() for t in out]
    for i in LABELS[entry.kind]:
        out[i][entry.batch // 2:] = harness.UNANSWERED
    return tuple(out)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_labels_that_never_reach_the_host_count_as_failed(workload):
    result = _run(workload, fault=_labels_lost)
    assert not result["correct"]
    assert result["failed"] == result["checks"]["missing"]["value"] > 0


FAULTS = [("cifar9_s1.bulk", _half_left_out),
          ("cifar9_s1.bulk", _answer_altered),
          ("face_cascade.busy", _half_left_out),
          ("face_cascade.busy", _answer_altered),
          ("cifar9_s1.video", _half_left_out),
          ("cifar9_s1.video", _answer_altered),
          ("cifar9_s1.video", _state_unchanged)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    result = _run(workload, fault=fault)
    assert not result["correct"]
