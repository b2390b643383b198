"""The port's checkpoints and fault tools vs ``repro``'s.

``repro_torch.checkpoint.ckpt`` writes ``repro``'s format (an ``.npz`` of
leaves under ``jax.tree_util.keystr`` keys plus a JSON manifest), so the
same nest saved by both packages gives the same files, and a checkpoint
written by either restores in the other, bit for bit.  The errors
(missing leaf, wrong shape, a layout wider than the surviving devices)
read the same, ``AsyncCheckpointer`` keeps the same files, and the
restore-after-fault path runs through.  ``repro_torch.distributed.fault``
is a copy of ``repro``'s; the cases of ``tests/test_checkpoint_fault.py``
(straggler detection, ``retry_step`` with backoff, the preemption flag)
run on both.  Tolerance 0.
"""

import collections
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.distributed import fault as jfault
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.distributed import fault as tfault

Pair = collections.namedtuple("Pair", "m v")


def _state_np(seed=0):
    """A nest of dicts, lists, tuples and a namedtuple, with float32,
    int32, uint32 (packed words) and 0-d leaves, as numpy."""
    rng = np.random.default_rng(seed)
    return {
        "conv": [{"w": rng.standard_normal((3, 2)).astype(np.float32),
                  "words": rng.integers(0, 2 ** 32, 5,
                                        dtype=np.uint64).astype(np.uint32)},
                 {"w": rng.standard_normal((2, 2)).astype(np.float32),
                  "words": rng.integers(0, 2 ** 32, 3,
                                        dtype=np.uint64).astype(np.uint32)}],
        "fc": ({"w": rng.standard_normal(4).astype(np.float32)},),
        "opt": Pair(m=np.arange(6, dtype=np.int32).reshape(2, 3),
                    v=np.float32(0.5) * np.ones(2, np.float32)),
        "step": np.asarray(7, dtype=np.int32),
    }


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, Pair):
        return Pair(*(_as_torch(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    x = np.array(tree)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(x)


def _bits(x):
    """A leaf's bytes as an int32/float32-agnostic numpy view."""
    x = np.array(x)
    return x.tobytes(), x.shape


def _leaves(tree):
    return [leaf for _, leaf in tckpt._leaves(tree)]


def test_same_nest_gives_the_same_files(tmp_path):
    state = _state_np()
    jckpt.save(str(tmp_path / "j"), jax.tree_util.tree_map(jnp.asarray,
                                                            state), step=3)
    tckpt.save(str(tmp_path / "t"), _as_torch(state), step=3)
    jm = json.loads((tmp_path / "j.json").read_text())
    tm = json.loads((tmp_path / "t.json").read_text())
    assert jm["step"] == tm["step"] == 3
    assert list(jm["leaves"]) == list(tm["leaves"])
    # the port keeps packed words as int32 (same bits); all else equal
    for k, v in jm["leaves"].items():
        want = dict(v, dtype="int32") if v["dtype"] == "uint32" else v
        assert tm["leaves"][k] == want, k
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "['conv'][0]['w']" in a.files and "['opt'].m" in a.files
        for k in a.files:
            assert _bits(a[k]) == _bits(b[k]), k


def test_repro_checkpoint_restores_in_the_port(tmp_path):
    state = _state_np(1)
    path = str(tmp_path / "ckpt_1")
    jckpt.save(path, jax.tree_util.tree_map(jnp.asarray, state), step=1)
    like = _as_torch(_state_np(2))
    got = tckpt.restore(path, like, device="cpu")
    assert isinstance(got["opt"], Pair) and isinstance(got["fc"], tuple)
    assert list(got) == list(like)
    for a, b in zip(_leaves(got), _leaves(state)):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert _bits(a.numpy()) == _bits(b)
    assert got["conv"][0]["words"].dtype == torch.int32


def test_port_checkpoint_restores_in_repro(tmp_path):
    state = _as_torch(_state_np(3))
    path = str(tmp_path / "ckpt_2")
    tckpt.save(path, state, step=2)
    like = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype),
        _state_np(4))
    got = jckpt.restore(path, like)
    for a, b in zip(jax.tree_util.tree_leaves(got), _leaves(state)):
        assert _bits(np.asarray(a)) == _bits(b.numpy())


def test_round_trip_keeps_bfloat16_and_places_on_the_device(tmp_path):
    state = {"h": torch.randn(3, 4).to(torch.bfloat16),
             "n": [torch.arange(3), None]}
    path = str(tmp_path / "c")
    tckpt.save(path, state)
    got = tckpt.restore(path, state, device="cpu")
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"],
                                                            state["h"])
    assert torch.equal(got["n"][0], state["n"][0]) and got["n"][1] is None
    assert json.loads((tmp_path / "c.json").read_text())[
        "leaves"]["['h']"] == {"shape": [3, 4], "dtype": "bfloat16"}


def test_restore_errors_read_like_repro(tmp_path):
    path = str(tmp_path / "c")
    jckpt.save(path, {"x": jnp.zeros((4,))})
    with pytest.raises(ValueError, match="shape") as want:
        jckpt.restore(path, {"x": jax.ShapeDtypeStruct((5,), jnp.float32)})
    with pytest.raises(ValueError, match="shape") as got:
        tckpt.restore(path, {"x": torch.zeros(5)}, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(KeyError) as want:
        jckpt.restore(path, {"y": jax.ShapeDtypeStruct((4,), jnp.float32)})
    with pytest.raises(KeyError) as got:
        tckpt.restore(path, {"y": torch.zeros(4)}, device="cpu")
    assert str(got.value) == str(want.value)


def test_async_checkpointer_keeps_the_same_files(tmp_path):
    files = []
    for mod, state in ((jckpt, jax.tree_util.tree_map(jnp.asarray,
                                                      _state_np())),
                       (tckpt, _as_torch(_state_np()))):
        d = tmp_path / mod.__name__.split(".")[0]
        ac = mod.AsyncCheckpointer(str(d), keep=2)
        for step in (1, 2, 3):
            ac.save(state, step)
        ac.wait()
        assert mod.latest_step(str(d)) == 3
        files.append(sorted(os.listdir(d)))
    assert files[0] == files[1] == ["ckpt_2.json", "ckpt_2.npz",
                                    "ckpt_3.json", "ckpt_3.npz"]
    assert tckpt.latest_step(str(tmp_path / "none")) is None


def test_async_checkpointer_snapshots_before_the_next_step(tmp_path):
    """The snapshot is taken at save(): changing the state afterwards
    does not reach the file."""
    state = {"w": torch.zeros(4)}
    ac = tckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(state, 1)
    state["w"].add_(1.0)
    ac.wait()
    got = tckpt.restore(str(tmp_path / "ckpt_1"), state, device="cpu")
    assert torch.equal(got["w"], torch.zeros(4))


def test_make_mesh_refuses_too_few_devices_like_repro():
    with pytest.raises(ValueError, match="devices") as want:
        jckpt.make_mesh((2, 1), ("data", "model"),
                        devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="devices") as got:
        tckpt.make_mesh((2, 1), ("data", "model"), devices=["cpu"])
    assert str(got.value) == str(want.value)
    mesh = tckpt.make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 3)
    assert mesh.devices.shape == (2, 1)
    assert mesh.axis_names == ("data", "model")
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)


def test_restore_after_fault_rebuilds_the_layout(tmp_path):
    """Checkpoint, preempt, rediscover the latest step, rebuild the layout
    on the surviving devices and restore onto it, bitwise."""
    state = _as_torch(_state_np(5))
    ac = tckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(state, step=7)
    ac.wait()
    g = tfault.PreemptionGuard(install=False)
    g._handler(15, None)
    assert g.requested
    step = tckpt.latest_step(str(tmp_path))
    assert step == 7
    mesh = tckpt.make_mesh((1,), ("frames",), devices=["cpu"])
    restored = tckpt.restore(os.path.join(tmp_path, f"ckpt_{step}"), state,
                             device=mesh.devices.flat[0])
    for a, b in zip(_leaves(restored), _leaves(state)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# fault tools: the cases of tests/test_checkpoint_fault.py, both packages
# ---------------------------------------------------------------------------

FAULT = pytest.mark.parametrize("fault", [jfault, tfault],
                                ids=["repro", "port"])


@FAULT
def test_step_timer_detects_straggler(fault):
    t = fault.StepTimer(window=20, threshold=2.5)
    for _ in range(8):
        with t:
            time.sleep(0.005)
    assert t.stragglers == 0 and t.median is not None
    with t:
        time.sleep(0.1)
    assert t.stragglers == 1 and t.slow


@FAULT
def test_retry_step_recovers_and_gives_up(fault):
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient collective failure")
        return x + 1

    assert fault.retry_step(flaky, 41, retries=3) == 42
    assert calls["n"] == 3

    def always(x):
        raise RuntimeError("hard failure")

    with pytest.raises(RuntimeError):
        fault.retry_step(always, 0, retries=2)


@FAULT
def test_retry_step_exponential_backoff(fault):
    slept, calls, stats, retried = [], {"n": 0}, {}, []

    def flaky(x):
        calls["n"] += 1
        if calls["n"] < 4:
            raise RuntimeError("transient")
        return x

    out = fault.retry_step(flaky, 7, retries=5, backoff_s=0.1,
                           backoff_factor=2.0, max_backoff_s=0.25,
                           sleep=slept.append, stats=stats,
                           on_retry=lambda a, d: retried.append((a, d)))
    assert out == 7
    assert slept == pytest.approx([0.1, 0.2, 0.25])
    assert retried == [(0, 0.1), (1, pytest.approx(0.2)), (2, 0.25)]
    assert stats["attempts"] == 4
    assert stats["backoff_s"] == pytest.approx(0.55)


@FAULT
def test_retry_step_default_is_immediate_and_rejects_bad_backoff(fault):
    slept, calls = [], {"n": 0}

    def flaky(x):
        calls["n"] += 1
        if calls["n"] < 2:
            raise RuntimeError("transient")
        return x

    assert fault.retry_step(flaky, 1, retries=2, sleep=slept.append) == 1
    assert slept == []
    for bad in (dict(backoff_s=-1.0), dict(backoff_factor=0.5),
                dict(max_backoff_s=-1.0)):
        with pytest.raises(ValueError):
            fault.retry_step(lambda: 0, **bad)


@FAULT
def test_preemption_guard_flag(fault):
    g = fault.PreemptionGuard(install=False)
    assert not g.requested
    g._handler(15, None)
    assert g.requested
    g.restore()
