"""The port's serve fleet, failover and warm start vs ``repro``'s.

The cases of ``tests/test_fleet.py`` run on both fleets with the same
artifact, frames and kill schedule (the port on the CPU with the plain
versions of the kernels, ``repro`` in Pallas interpret mode, both on one
device, so replicas share it): every timestamp comes from the injected
clock; killing one of two replicas mid-replay loses no frame and serves
the same labels, in the same dispatches, with the same stamps as
``repro``; migrated frames keep their lane order and serve first; the
last replica's ``fail()`` raises; the fleet bill (``billed == served +
padded`` with padding and an in-flight kill) and the failover counts
equal ``repro``'s; identical servers share one warm-start entry, the key
schema separates kinds, options and device groups, and a replacement
replica warm-starts.  The drivers' ``--fleet 2 --kill host0`` runs print
the same counts.  Tolerance 0.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.chip import interpreter as jinterp, networks as jnets
from repro.kernels import cache as jcache
from repro.launch import chip_serve as jdriver
from repro.serving import (ChipServer as JaxChipServer,
                           FaultInjector as JaxFaultInjector,
                           ServeFleet as JaxServeFleet)
from repro_torch import convert
from repro_torch.core.chip import networks as tnets
from repro_torch.distributed import sharding
from repro_torch.kernels import cache as tcache
from repro_torch.launch import chip_serve as tdriver
from repro_torch.serving import (ChipServer, FaultInjector, ServeFleet,
                                 VirtualClock, poisson_trace, replay)
from repro_torch.serving.queue import FrameQueue, FrameRequest
from tests.test_torch_interpreter import np_params, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    """mnist5's packed artifact in both packages' forms, 24 frames and
    the float reference's labels."""
    jprog = jnets.mnist5()
    npp = np_params(jprog, seed=3)
    packed = jinterp.fold_params(jax.tree_util.tree_map(jnp.asarray, npp),
                                 jprog, packed=True)
    io = jprog.instrs[0]
    frames = np.random.default_rng(11).integers(
        0, 2 ** io.bits, (24, io.height, io.width, io.in_channels),
        dtype=np.int32)
    folded = jinterp.fold_params(jax.tree_util.tree_map(jnp.asarray, npp),
                                 jprog)
    _, labels = jinterp.make_infer_fn(jprog)(folded, jnp.asarray(frames))
    tart = convert.artifact_from_numpy(
        jax.tree_util.tree_map(np.asarray, packed), device="cpu")
    return jprog, packed, tart, frames, np.asarray(labels)


def _fleets(setup, **kw):
    """The same fleet in both packages, each on its own virtual clock."""
    jprog, packed, tart, _, _ = setup
    kw.setdefault("replicas", 2)
    kw.setdefault("batch", 4)
    jinj, tinj = kw.pop("injector", (None, None))
    jvc, tvc = VirtualClock(), VirtualClock()
    jf = JaxServeFleet({"mnist5": jprog}, {"mnist5": packed},
                       interpret=True, clock=jvc, sleep=jvc.sleep,
                       injector=jinj, **kw)
    tf = ServeFleet({"mnist5": tnets.mnist5()}, {"mnist5": tart},
                    devices=["cpu"], megakernel=True, clock=tvc,
                    sleep=tvc.sleep, injector=tinj, **kw)
    return (jf, jvc), (tf, tvc)


def _key(r):
    return (r.rid, r.label, r.dispatch, r.t_submit, r.t_done)


def _books(st):
    """What a fleet's stats hold in common across the packages."""
    return dict(served=st.served, padded=st.padded,
                dispatches=st.dispatches,
                billed=sum(st.served.values()) + sum(st.padded.values()),
                p=(st.p50_ms, st.p95_ms, st.p99_ms),
                padding_ratio=st.padding_ratio,
                migrated=st.migrated_frames, refired=st.refired_frames,
                failed=st.failed_replicas, recovery_ms=st.recovery_ms,
                replicas={n: (s.served, s.padded, s.dispatches)
                          for n, s in st.replicas.items()})


def _injectors(victim, after):
    return JaxFaultInjector(victim, after), FaultInjector(victim, after)


# ---------------------------------------------------------------------------
# 1. the clock domain
# ---------------------------------------------------------------------------

def test_step_wall_time_comes_from_injected_clock(setup):
    """With a virtual clock that never advances, the server's wall time
    stays exactly 0.0: no wall-clock read leaks into step()."""
    _, _, tart, frames, _ = setup
    vc = VirtualClock(start=5.0)
    server = ChipServer({"mnist5": tnets.mnist5()}, {"mnist5": tart},
                        batch=4, device="cpu", clock=vc)
    for f in frames[:6]:
        server.submit("mnist5", f)
    assert len(server.drain()) == 6
    assert server._host_wall_s == 0.0
    assert server.stats().host_frames_per_s == 0.0


def test_trace_timestamps_come_from_injected_clock(setup):
    _, _, tart, frames, _ = setup
    vc = VirtualClock(start=1.0)
    server = ChipServer({"mnist5": tnets.mnist5()}, {"mnist5": tart},
                        batch=4, device="cpu", clock=vc)
    trace = poisson_trace(("mnist5",), rate=50.0, n=10, seed=7)
    assert replay(server, trace, {"mnist5": frames}, clock=vc,
                  sleep=vc.sleep)
    recs = server.latency_trace()
    assert len(recs) == 10
    for rec in recs:
        assert 1.0 <= rec["t_submit"] <= vc.now
        assert 1.0 <= rec["t_done"] <= vc.now
        assert rec["latency_ms"] >= 0.0
    assert server._host_wall_s == 0.0


# ---------------------------------------------------------------------------
# 2. failover: zero loss, bit-exact, per-lane order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,after", [("static", 4), ("continuous", 6)])
def test_failover_mid_replay_matches_repro(setup, policy, after):
    """Kill one of two replicas mid-replay (a replacement comes up): every
    frame served, labels == the float reference, and results, stamps and
    books equal ``repro``'s fleet under the same kill schedule."""
    _, _, _, frames, labels = setup
    trace = poisson_trace(("mnist5",), rate=100.0, n=20, seed=3)
    runs = []
    for fleet, vc in _fleets(setup, injector=_injectors("host0", after),
                             replace=True, policy=policy):
        results = replay(fleet, trace, {"mnist5": frames}, clock=vc,
                         sleep=vc.sleep)
        fleet.close()
        runs.append((fleet, sorted(results, key=lambda r: r.rid)))
    (jf, jres), (tf, tres) = runs
    assert [_key(r) for r in tres] == [_key(r) for r in jres]
    assert tf.injector.fired and jf.injector.fired
    for r in tres:
        assert r.label == labels[r.rid % len(frames)]
    js, ts = jf.stats(), tf.stats()
    assert _books(ts) == _books(js)
    assert ts.failed_replicas == ("host0",)
    assert ts.total_served == len(trace) + ts.refired_frames
    assert sorted({r.rid for r in tres}) == list(range(len(trace)))
    assert ts.billed == ts.total_served + sum(ts.padded.values())
    assert tf.latency_trace() == jf.latency_trace()


def test_migration_preserves_per_lane_order_like_repro(setup):
    """Migrated frames enter the survivor's lane front: they keep their
    order and serve before anything routed after the failure."""
    _, _, _, frames, _ = setup
    outs = []
    for fleet, _vc in _fleets(setup, batch=2, replace=False):
        for f in frames[:8]:
            fleet.submit("mnist5", f)
        first = [r.rid for r in fleet.step()]
        orphans = fleet.fail("host0")
        post = [fleet.submit("mnist5", f) for f in frames[8:12]]
        after = [r.rid for r in fleet.drain()]
        outs.append((first, [r.rid for r in orphans["mnist5"]], post, after))
    assert outs[0] == outs[1]
    first, migrated, post, after = outs[1]
    assert len(first) == 4 and migrated == [4, 5]
    assert sorted(after) == [4, 5, 6, 7] + post
    assert after[:2] == [4, 5]
    assert max(after.index(r) for r in [4, 5, 6, 7]) < \
        min(after.index(r) for r in post)


def test_fail_last_replica_raises_like_repro(setup):
    _, _, _, frames, _ = setup
    msgs = []
    for fleet, _vc in _fleets(setup, replicas=1, replace=False):
        fleet.submit("mnist5", frames[0])
        with pytest.raises(RuntimeError, match="no survivors") as err:
            fleet.fail("host0")
        msgs.append(str(err.value))
        with pytest.raises(KeyError):
            fleet.fail("host0")
    assert msgs[0] == msgs[1]


def test_requeue_front_order_and_lane_guard():
    q = FrameQueue(["a", "b"])
    q.submit(FrameRequest(rid=10, program="a", frame=None))
    old = [FrameRequest(rid=1, program="a", frame=None),
           FrameRequest(rid=2, program="a", frame=None)]
    q.requeue_front("a", old)
    assert [r.rid for r in q.take("a", 10)] == [1, 2, 10]
    with pytest.raises(ValueError, match="belongs to lane"):
        q.requeue_front("b", old)


# ---------------------------------------------------------------------------
# 3. billing: billed == served + padded fleet-wide
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [1, 2])
def test_fleet_billing_with_padding_and_failure_like_repro(setup, prefetch):
    """A kill with dispatches in flight (prefetch keeps them there): the
    victim's abandoned work stays billed, its in-flight frames are billed
    again by the survivor (``refired_frames``), and the whole bill equals
    ``repro``'s."""
    _, _, _, frames, labels = setup
    runs = []
    for fleet, _vc in _fleets(setup, batch=2, prefetch=prefetch,
                              injector=_injectors("host0", 2),
                              replace=False):
        for f in frames[:10]:
            fleet.submit("mnist5", f)
        results = fleet.drain()
        fleet.close()
        runs.append((fleet, sorted(results, key=lambda r: r.rid)))
    (jf, jres), (tf, tres) = runs
    assert [(r.rid, r.label) for r in tres] == [(r.rid, r.label)
                                                for r in jres]
    assert [r.rid for r in tres] == list(range(10))
    assert all(r.label == labels[r.rid] for r in tres)
    js, ts = jf.stats(), tf.stats()
    assert _books(ts) == _books(js)
    assert ts.refired_frames > 0
    assert ts.billed == ts.total_served + sum(ts.padded.values())
    assert ts.total_served == 10 + ts.refired_frames
    assert ts.chip.total_frames == ts.total_served
    assert ts.energy_uj == pytest.approx(js.energy_uj, rel=0, abs=0)
    dead = ts.replicas["host0"]
    assert dead.billed == sum(dead.served.values()) + sum(
        dead.padded.values()) > 0


def test_aborted_fetch_thread_is_stopped_and_its_results_dropped(setup):
    """``fail()`` on a replica with fetches in flight stops its fetch
    thread before returning and hands back every in-flight frame; the
    survivor's results carry none of the victim's dispatches."""
    _, _, tart, frames, _ = setup
    server = ChipServer({"mnist5": tnets.mnist5()}, {"mnist5": tart},
                        batch=2, prefetch=2, device="cpu")
    for f in frames[:8]:
        server.submit("mnist5", f)
    first = server.step()            # two in flight after this one
    orphans = server.fail()
    assert server.executor._fetch_pool is None
    assert server.aborted_inflight == 4
    assert [r.rid for r in orphans["mnist5"]] == [2, 3, 4, 5, 6, 7]
    assert [r.rid for r in first] == [0, 1]


# ---------------------------------------------------------------------------
# 4. warm start
# ---------------------------------------------------------------------------

def test_warm_start_shares_serving_units_like_repro(setup):
    jprog, packed, tart, _, _ = setup
    ledgers = []
    for cache, make in (
            (jcache, lambda **kw: JaxChipServer(
                {"mnist5": jprog}, {"mnist5": packed}, batch=4,
                interpret=True, **kw)),
            (tcache, lambda **kw: ChipServer(
                {"mnist5": tnets.mnist5()}, {"mnist5": tart}, batch=4,
                device="cpu", **kw))):
        cache.invalidate()
        s1 = make()
        one = {k: cache.stats()[k] for k in ("hits", "misses")}
        s2 = make()
        two = {k: cache.stats()[k] for k in ("hits", "misses")}
        assert s2.executor._fns["mnist5"] is s1.executor._fns["mnist5"]
        s3 = make(warm_start=False)
        assert {k: cache.stats()[k] for k in ("hits", "misses")} == two
        assert s3.executor._fns["mnist5"] is not s1.executor._fns["mnist5"]
        ledgers.append((one, two))
    assert ledgers[0] == ledgers[1] == ({"hits": 0, "misses": 1},
                                        {"hits": 1, "misses": 1})
    # the port's entry also holds the artifact on the device: the second
    # server reads the first one's tensors, other weights get their own
    tcache.invalidate()
    a = ChipServer({"mnist5": tnets.mnist5()}, {"mnist5": tart}, batch=4,
                   device="cpu", megakernel=True)
    b = ChipServer({"mnist5": tnets.mnist5()}, {"mnist5": tart}, batch=4,
                   device="cpu", megakernel=True)
    other = convert.artifact_from_numpy(jax.tree_util.tree_map(
        np.asarray, packed), device="cpu")
    c = ChipServer({"mnist5": tnets.mnist5()}, {"mnist5": other}, batch=4,
                   device="cpu", megakernel=True)
    assert b.artifacts["mnist5"] is a.artifacts["mnist5"]
    assert c.artifacts["mnist5"] is not a.artifacts["mnist5"]
    assert all(torch.equal(c.artifacts["mnist5"][k], a.artifacts["mnist5"][k])
               for k in a.artifacts["mnist5"])


def test_serve_fn_key_schema(setup):
    prog = tnets.mnist5()
    k1 = tcache.serve_fn_key((prog,), devices=("cpu",))
    assert k1.startswith(f"v{tcache.SCHEMA}/serve/")
    assert k1 == tcache.serve_fn_key((prog,), devices=("cpu",))
    assert k1.endswith("/dcpu/mk0/cpu")
    variants = {tcache.serve_fn_key((prog,), devices=("cpu",),
                                    megakernel=True),
                tcache.serve_fn_key((prog,), devices=("cpu",),
                                    kind="composite"),
                tcache.serve_fn_key((prog,), devices=("cpu", "cpu")),
                tcache.serve_fn_key((tnets.mnist5(classes=2),),
                                    devices=("cpu",))}
    assert k1 not in variants and len(variants) == 4
    # the program and composite hashes are repro's autotune keys
    from repro.kernels import autotune
    jprog = jnets.mnist5()
    assert tcache.program_key(prog) == autotune.program_key(jprog)
    assert tcache.composite_key((prog, tnets.face_detector())) == \
        autotune.composite_key((jprog, jnets.face_detector()))


def test_replacement_replica_warm_starts_like_repro(setup):
    """A replacement spawned after a kill hits the warm-start cache and
    goes on to serve fresh traffic, and recovery is measurable on the
    fleet clock."""
    _, _, _, frames, labels = setup
    jcache.invalidate()
    tcache.invalidate()
    runs = []
    for fleet, _vc in _fleets(setup, batch=2,
                              injector=_injectors("host0", 2),
                              replace=True):
        for f in frames[:4]:
            fleet.submit("mnist5", f)
        fleet.drain()
        assert fleet.failed_replicas == ("host0",)
        post = [fleet.submit("mnist5", f) for f in frames[4:12]]
        results = fleet.drain()
        assert sorted(r.rid for r in results) == post
        runs.append((fleet, results))
    (jf, jres), (tf, tres) = runs
    assert [_key(r) for r in tres] == [_key(r) for r in jres]
    for r in tres:
        assert r.label == labels[r.rid % len(frames)]
    assert tf.live_replicas == jf.live_replicas == ("host1", "host0r1")
    assert tf.stats().replicas["host0r1"].total_served > 0
    assert tf.recovery_ms == jf.recovery_ms and tf.recovery_ms >= 0.0
    ws, jws = tf.stats().warm_start, jf.stats().warm_start
    assert (ws["hits"], ws["misses"]) == (jws["hits"], jws["misses"])
    assert ws["hits"] >= 2           # host1 and the replacement
    assert tf.retry_stats == jf.retry_stats == {"attempts": 1,
                                                "backoff_s": 0.0}


def test_partition_serve_meshes_and_scatter():
    """Host-major contiguous groups, the remainder to the leading groups
    (as ``repro``'s ``partition_serve_meshes``); with fewer devices than
    replicas the groups wrap round-robin.  Frames scatter in order over a
    group and gather back."""
    cpu = torch.device("cpu")
    assert sharding.partition_serve_meshes(2, ["cpu"]) == [(cpu,), (cpu,)]
    assert [len(g) for g in sharding.partition_serve_meshes(
        3, ["cpu"] * 5)] == [2, 2, 1]
    assert [len(g) for g in sharding.partition_serve_meshes(
        2, ["cpu"] * 5)] == [3, 2]
    with pytest.raises(ValueError, match="replica"):
        sharding.partition_serve_meshes(0, ["cpu"])
    frames = torch.arange(8).reshape(4, 2)
    parts = sharding.scatter_frames((cpu, cpu), frames)
    assert [p.tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]
    assert torch.equal(sharding.gather_frames((cpu, cpu), parts), frames)
    with pytest.raises(ValueError, match="divisible"):
        sharding.scatter_frames((cpu, cpu), frames[:3])
    art = {"w": torch.ones(3)}
    reps = sharding.replicate_artifact((cpu, cpu), art)
    assert len(reps) == 2 and reps[0]["w"] is reps[1]["w"]


def test_mesh_replica_serves_scattered_frames_like_one_device(setup):
    """A replica over the group (cpu, cpu): each dispatch's frames
    scatter over the two entries and gather back in order, with the same
    results and books as the one-device server."""
    _, _, tart, frames, labels = setup
    outs = []
    for mesh in (None, ("cpu", "cpu")):
        server = ChipServer({"mnist5": tnets.mnist5()}, {"mnist5": tart},
                            batch=4, device="cpu", mesh=mesh,
                            policy="continuous", megakernel=True)
        server.submit_many("mnist5", frames[:10])
        res = server.drain()
        st = server.stats()
        outs.append(([(r.rid, r.label, r.dispatch) for r in res],
                     st.dispatch_sizes, st.billed))
    assert outs[0][0] == outs[1][0]
    assert [lab for _, lab, _ in outs[1][0]] == list(labels[:10])
    assert outs[1][1] == {4: 2, 2: 1} and outs[0][1] == {4: 2, 2: 1}


def _fleet_counts(out: str):
    rows = re.findall(r"(\w+)( \(FAILED\))?:\s+(\d+) served, (\d+) padded, "
                      r"(\d+) dispatches", out)
    return (re.search(r"fleet served (\d+) frames in (\d+) dispatches",
                      out).groups(),
            rows,
            re.search(r"failover\s+: (\d+) frames migrated \(\+(\d+) "
                      r"refired\)", out).groups(),
            re.search(r"billing\s+: (\d+) billed == (\d+) served \+ (\d+) "
                      r"padded", out).groups(),
            re.search(r"warm-start cache\s+: (\d+) hits / (\d+) misses",
                      out).groups())


def test_fleet_driver_counts_match_repro(capsys):
    argv = ["--fleet", "2", "--programs", "mnist5", "--requests", "24",
            "--batch", "4", "--kill", "host0", "--kill-after", "4"]
    jcache.invalidate()
    jdriver.main(argv)
    want = capsys.readouterr().out
    tcache.invalidate()
    results, st = tdriver.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _fleet_counts(got) == _fleet_counts(want)
    assert "host0 (FAILED)" in got and "host0r1" in got
    assert len(results) == 24 and st.billed == 24
