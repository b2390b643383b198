"""The port's arrival traces and trace replay vs ``repro``'s.

``repro_torch.serving.traffic`` is a copy of ``repro.serving.traffic``
(numpy only).  The same seeds give the same arrival traces, the JSON form
is interchangeable, bad parameters raise the same errors, and a trace
replayed under a ``VirtualClock`` through the port's ``ChipServer`` (CPU,
plain versions of the kernels) serves the same frames, in the same
dispatches, with the same stamps as ``repro``'s server in Pallas
interpret mode.  Tolerance 0.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.chip import interpreter as jinterp, networks as jnets
from repro.serving import ChipServer as JaxChipServer
from repro.serving import traffic as jtraffic
from repro_torch import convert
from repro_torch.core.chip import networks as tnets
from repro_torch.serving import ChipServer
from repro_torch.serving import traffic as ttraffic
from tests.test_torch_interpreter import np_params, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("kind", jtraffic.TRAFFIC_KINDS)
def test_trace_json_interchanges_with_repro(kind, tmp_path):
    kw = dict(weights=[0.7, 0.3]) if kind == "poisson" else {}
    a = jtraffic.make_trace(kind, ("x", "y"), 150.0, 24, seed=9, **kw)
    b = ttraffic.make_trace(kind, ("x", "y"), 150.0, 24, seed=9, **kw)
    assert (a.duration_s, a.mean_rate) == (b.duration_s, b.mean_rate)
    pa, pb = tmp_path / "repro.json", tmp_path / "port.json"
    jtraffic.save_trace(a, str(pa))
    ttraffic.save_trace(b, str(pb))
    assert json.loads(pa.read_text()) == json.loads(pb.read_text())
    back = ttraffic.load_trace(str(pa))
    assert np.array_equal(back.t, a.t) and back.lane == a.lane
    assert (back.kind, back.seed, back.meta) == (a.kind, a.seed, a.meta)


@pytest.mark.parametrize("call", [
    lambda m: m.poisson_trace(["a"], 0.0, 4),
    lambda m: m.poisson_trace(["a"], 10.0, 0),
    lambda m: m.poisson_trace([], 10.0, 4),
    lambda m: m.poisson_trace(["a", "b"], 10.0, 4, weights=[1.0]),
    lambda m: m.bursty_trace(["a"], 10.0, 4, burst_factor=0.5),
    lambda m: m.bursty_trace(["a"], 10.0, 4, p_enter=0.0),
    lambda m: m.diurnal_trace(["a"], 10.0, 4, depth=1.0),
    lambda m: m.make_trace("sawtooth", ["a"], 10.0, 4),
    lambda m: m.ArrivalTrace(kind="poisson", seed=0, t=np.array([1.0, 0.5]),
                             lane=("a", "a")),
    lambda m: m.ArrivalTrace(kind="poisson", seed=0, t=np.array([0.0, 0.5]),
                             lane=("a",)),
], ids=["rate", "n", "lanes", "weights", "burst_factor", "transition",
        "depth", "kind", "sorted", "lane_tags"])
def test_trace_validation_matches_repro(call):
    with pytest.raises(ValueError) as want:
        call(jtraffic)
    with pytest.raises(ValueError) as got:
        call(ttraffic)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def replay_setup():
    """mnist5's packed artifact (numpy) and a small bank of frames."""
    jprog = jnets.mnist5()
    packed = jinterp.fold_params(
        jax.tree_util.tree_map(jnp.asarray, np_params(jprog, seed=41)),
        jprog, packed=True)
    io = jprog.instrs[0]
    frames = np.random.default_rng(42).integers(
        0, 2 ** io.bits, (6, io.height, io.width, io.in_channels),
        dtype=np.int32)
    return jprog, jax.tree_util.tree_map(np.asarray, packed), frames


def _replay(server_of, trace, frames, speed=1.0):
    vc = ttraffic.VirtualClock(start=1.0)
    server = server_of(vc)
    results = ttraffic.replay(server, trace, {"m": frames}, speed=speed,
                              clock=vc, sleep=vc.sleep)
    server.close()
    return server, results, vc()


def test_virtual_clock_replay_through_port_server_matches_repro(
        replay_setup):
    """A Poisson trace replayed at the trace's pace: every arrival served
    once, stamped with its due time, in the same dispatches with the same
    labels, completion stamps and ledger as ``repro``'s server."""
    jprog, packed, frames = replay_setup
    trace = ttraffic.poisson_trace(["m"], 200.0, 10, seed=5)
    jsrv, jres, jend = _replay(
        lambda vc: JaxChipServer(
            {"m": jprog}, {"m": jax.tree_util.tree_map(jnp.asarray, packed)},
            batch=4, interpret=True, clock=vc), trace, frames)
    tsrv, tres, tend = _replay(
        lambda vc: ChipServer(
            {"m": tnets.mnist5()},
            {"m": convert.artifact_from_numpy(packed, device="cpu")},
            batch=4, megakernel=True, device="cpu", clock=vc), trace, frames)
    key = lambda r: (r.rid, r.label, r.dispatch, r.t_submit, r.t_done)
    assert [key(r) for r in tres] == [key(r) for r in jres]
    assert len(tres) == len(trace)
    for i, r in enumerate(sorted(tres, key=lambda r: r.rid)):
        assert r.t_submit == 1.0 + float(trace.t[i])
    assert tend == jend
    js, ts = jsrv.stats(), tsrv.stats()
    assert ts.served == js.served == {"m": len(trace)}
    assert ts.padded == js.padded
    assert ts.billed == ts.total_served + sum(ts.padded.values())
    assert ts.dispatches == js.dispatches
    assert (ts.p50_ms, ts.p95_ms, ts.p99_ms) == (js.p50_ms, js.p95_ms,
                                                 js.p99_ms)


def test_replay_speed_compresses_time(replay_setup):
    jprog, packed, frames = replay_setup
    trace = ttraffic.poisson_trace(["m"], 50.0, 6, seed=4)
    spans = []
    for speed in (1.0, 4.0):
        _, results, end = _replay(
            lambda vc: ChipServer(
                {"m": tnets.mnist5()},
                {"m": convert.artifact_from_numpy(packed, device="cpu")},
                batch=4, megakernel=True, device="cpu", clock=vc),
            trace, frames, speed=speed)
        assert len(results) == len(trace)
        spans.append(end)
    assert spans[1] < spans[0]
    with pytest.raises(ValueError, match="speed"):
        ttraffic.replay(None, trace, {}, speed=0.0)
