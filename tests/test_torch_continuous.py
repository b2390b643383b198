"""The port's continuous batching vs ``repro``'s.

``ContinuousPolicy`` is host-only Python copied from ``repro``, so its
decisions are held against ``repro``'s one for one: the cases of
``tests/test_policy.py``'s continuous section (the window held below its
target until the deadline, flushing, the ladder in device multiples, the
target against the rate, bad parameters, the composition with the
operating-point controller under a budget, the shared accounting) run on
both policies with the same inputs and give the same dispatches.  End to
end, Poisson, bursty and diurnal traces replayed under a ``VirtualClock``
through the port's ``ChipServer(policy="continuous")`` (CPU, plain
versions of the kernels) equal ``repro``'s server in Pallas interpret
mode: every result's rid, label, dispatch and stamps, the dispatch
sizes, the ledger, the percentiles and the latency trace.  The drivers'
``--policy continuous --traffic poisson`` runs print the same counts.
Tolerance 0 throughout.
"""

import dataclasses
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.chip import energy as jenergy, interpreter as jinterp
from repro.core.chip import networks as jnets
from repro.launch import chip_serve as jdriver
from repro.serving import ChipServer as JaxChipServer
from repro.serving import policy as jpolicy, queue as jqueue
from repro.serving import traffic as jtraffic
from repro_torch import convert
from repro_torch.core.chip import energy as tenergy, networks as tnets
from repro_torch.launch import chip_serve as tdriver
from repro_torch.serving import ChipServer
from repro_torch.serving import policy as tpolicy, queue as tqueue
from repro_torch.serving import traffic as ttraffic
from tests.test_torch_interpreter import np_params, one_torch_thread  # noqa: F401

JAX = (jnets, jenergy, jpolicy, jqueue)
TORCH = (tnets, tenergy, tpolicy, tqueue)


# ---------------------------------------------------------------------------
# the policy on its own, both packages on the same inputs
# ---------------------------------------------------------------------------

def _static_context(pkg, batch, clock=None, quantum=1):
    """Four S=4 lanes forming one shared-array group + a solo S=1 lane
    (``tests/test_policy.py``'s static context)."""
    nets, energy, policy, queue = pkg
    programs = {"a": nets.mnist5(), "b": nets.mnist5(classes=2),
                "c": nets.mnist5(classes=3),
                "owner": nets.cifar9(1, classes=2)}
    groups = {}
    for members in queue.plan_shared_groups(programs):
        for m in members:
            groups[m] = members
    ctx = policy.PolicyContext(
        batch=batch, lanes=tuple(programs),
        variants={n: (n,) for n in programs}, programs=programs,
        reports={n: energy.analyze_net(p) for n, p in programs.items()},
        groups=groups, quantum=quantum)
    return ctx if clock is None else dataclasses.replace(ctx, clock=clock)


def _family_context(pkg, batch):
    """Two 2-variant families and a plain lane (``tests/test_policy.py``'s
    family context)."""
    nets, energy, policy, _ = pkg
    programs = {"cifar9_s4": nets.cifar9(4),
                "cifar9_s4t": nets.cifar9_truncated(),
                "owner_detector": nets.owner_detector(),
                "face_detector": nets.face_detector(),
                "mnist5": nets.mnist5()}
    variants = {"cifar10": ("cifar9_s4", "cifar9_s4t"),
                "face": ("owner_detector", "face_detector"),
                "mnist5": ("mnist5",)}
    return policy.PolicyContext(
        batch=batch, lanes=tuple(variants), variants=variants,
        programs=programs,
        reports={n: energy.analyze_net(p) for n, p in programs.items()},
        groups={})


def _dispatch(d):
    if d is None:
        return None
    return d.batch, tuple((ld.lane, ld.variant,
                           tuple(r.rid for r in ld.requests))
                          for ld in d.lanes)


def _req(pkg, rid, lane, t=0.0):
    return pkg[3].FrameRequest(rid=rid, program=lane, frame=None,
                               t_submit=t)


def test_holds_below_target_until_deadline_like_repro():
    """A fast stamped lane holds its window (select -> None) until the
    oldest frame has waited deadline_frac of the SLO, then launches early
    and small at a ladder size."""
    seen = []
    for pkg in (JAX, TORCH):
        vc = ttraffic.VirtualClock(start=10.0)
        ctx = _static_context(pkg, 4, clock=vc)
        pol = pkg[2].ContinuousPolicy(slo_ms=100.0, headroom=0.5,
                                      deadline_frac=0.5)
        pol.bind(ctx)
        queue = pkg[3].FrameQueue(ctx.lanes)
        for rid in range(8):
            vc.advance(0.001)
            queue.submit(_req(pkg, rid, "a", vc()))
        queue.take("a", 6)
        got = []
        for dt in (0.0, 0.040, 0.020):
            vc.advance(dt)
            got.append(_dispatch(pol.select(queue)))
        seen.append(got)
    assert seen[0] == seen[1]
    assert seen[1][:2] == [None, None]
    assert seen[1][2] == (2, (("a", "a", (6, 7)),))


def test_flush_dispatches_immediately_like_repro():
    seen = []
    for pkg in (JAX, TORCH):
        vc = ttraffic.VirtualClock(start=5.0)
        pol = pkg[2].ContinuousPolicy(slo_ms=1e6)
        pol.bind(_static_context(pkg, 4, clock=vc))
        queue = pkg[3].FrameQueue(pol.ctx.lanes)
        for rid in range(2):
            vc.advance(0.001)
            queue.submit(_req(pkg, rid, "a", vc()))
        held = _dispatch(pol.select(queue))
        pol.set_flush(True)
        got = _dispatch(pol.select(queue))
        inner_flush = pol.inner.flush
        pol.set_flush(False)
        seen.append((held, got, inner_flush, pol.inner.flush))
    assert seen[0] == seen[1]
    assert seen[1] == (None, (2, (("a", "a", (0, 1)),)), True, False)


@pytest.mark.parametrize("quantum,batch,pending,size", [
    (4, 16, 5, 8), (1, 8, 3, 4), (2, 8, 1, 2), (1, 4, 9, None)])
def test_ladder_quantises_to_device_multiples_like_repro(quantum, batch,
                                                         pending, size):
    """Sizes land on {q, 2q, 4q, ..., batch}: unstamped frames dispatch at
    once, rounded up to the next rung."""
    seen = []
    for pkg in (JAX, TORCH):
        pol = pkg[2].ContinuousPolicy()
        pol.bind(_static_context(pkg, batch, clock=ttraffic.VirtualClock(),
                                 quantum=quantum))
        queue = pkg[3].FrameQueue(pol.ctx.lanes)
        for rid in range(pending):
            queue.submit(_req(pkg, rid, "owner"))
        seen.append((pol._ladder, _dispatch(pol.select(queue))))
    assert seen[0] == seen[1]
    ladder, (got_size, lanes) = seen[1]
    assert ladder[0] == quantum and ladder[-1] == batch
    assert all(s % quantum == 0 for s in ladder)
    assert got_size == size and len(lanes[0][2]) == min(pending, batch)


@pytest.mark.parametrize("rate", [0.0, 20.0, 100.0, 333.3, 10_000.0])
def test_target_scales_with_rate_like_repro(rate):
    got = []
    for pkg in (JAX, TORCH):
        pol = pkg[2].ContinuousPolicy(slo_ms=50.0, headroom=0.5)
        pol.bind(_static_context(pkg, 8))
        got.append(pol._target(rate))
    assert got[0] == got[1]
    assert got[1] == (1 if rate == 0 else
                      max(1, min(8, int(np.ceil(rate * 0.05 * 0.5)))))


@pytest.mark.parametrize("bad", [
    dict(slo_ms=0.0), dict(slo_ms=-1.0), dict(min_batch=0),
    dict(headroom=0.0), dict(headroom=1.5), dict(deadline_frac=-0.1),
    dict(deadline_frac=1.1)], ids=lambda d: "-".join(map(str, d.items())))
def test_rejects_bad_parameters_like_repro(bad):
    with pytest.raises(ValueError) as want:
        jpolicy.ContinuousPolicy(**bad)
    with pytest.raises(ValueError) as got:
        tpolicy.ContinuousPolicy(**bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", range(4))
def test_composed_controller_decisions_and_budget_like_repro(seed):
    """The continuous layer over the operating-point controller under a
    feasible budget, shared co-dispatch on or off: every dispatch and the
    committed energy and chip time equal ``repro``'s, and the spend stays
    within one dispatch of the budget."""
    rng = random.Random(seed)
    batch = rng.randint(1, 4)
    shared = bool(seed % 2)
    ctx = _family_context(JAX, batch)
    budget = (min(r.power_w for r in ctx.reports.values()) * 1e6
              * rng.randint(100, 300) / 100.0)
    lanes = list(ctx.lanes)
    script = [rng.random() < 0.6 for _ in range(80)]
    picks = [rng.choice(lanes) for _ in range(80)]
    runs = []
    for pkg in (JAX, TORCH):
        inner = pkg[2].OperatingPointPolicy(budget_uj_s=budget,
                                            shared=shared)
        pol = pkg[2].ContinuousPolicy(inner=inner)
        ctx = _family_context(pkg, batch)
        pol.bind(ctx)
        max_e = max(batch * r.i2l_energy_per_inference * 1e6
                    for r in ctx.reports.values())
        queue = pkg[3].FrameQueue(ctx.lanes)
        rid, out, i = 0, [], 0
        while rid < 24 or queue.pending():
            if rid < 24 and (script[i % 80] or not queue.pending()):
                queue.submit(_req(pkg, rid, picks[rid % 80]))
                rid += 1
            else:
                d = pol.select(queue)
                assert d is not None
                out.append(_dispatch(d))
                assert inner.spent_uj <= (budget * inner.chip_time_s
                                          + max_e + 1e-9)
            i += 1
        runs.append((out, inner.spent_uj, inner.chip_time_s,
                     dict(pol.variant_dispatches)))
    assert runs[0] == runs[1]


def test_shares_accounting_with_inner_like_repro():
    seen = []
    for pkg in (JAX, TORCH):
        pol = pkg[2].ContinuousPolicy(
            inner=pkg[2].OperatingPointPolicy(budget_uj_s=1e-6))
        pol.bind(_family_context(pkg, 2))
        assert pol.variant_dispatches is pol.inner.variant_dispatches
        queue = pkg[3].FrameQueue(pol.ctx.lanes)
        for rid in range(4):
            queue.submit(_req(pkg, rid, "cifar10"))
        while pol.select(queue) is not None:
            pass
        seen.append((dict(pol.variant_dispatches), pol.downshift_ratio(),
                     pol.variant_order("cifar10")))
    assert seen[0] == seen[1]
    assert seen[1][0]["cifar9_s4t"] > 0 and seen[1][1] == 1.0


# ---------------------------------------------------------------------------
# end to end: VirtualClock replays through both servers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mnist_setup():
    """mnist5's packed artifact (numpy) and a bank of frames."""
    jprog = jnets.mnist5()
    packed = jinterp.fold_params(
        jax.tree_util.tree_map(jnp.asarray, np_params(jprog, seed=41)),
        jprog, packed=True)
    io = jprog.instrs[0]
    frames = np.random.default_rng(42).integers(
        0, 2 ** io.bits, (8, io.height, io.width, io.in_channels),
        dtype=np.int32)
    return jprog, jax.tree_util.tree_map(np.asarray, packed), frames


def _recorded(server):
    """Record every dispatch's pad target the policy hands the server."""
    sizes = []
    select = server.policy.select

    def record(queue):
        d = select(queue)
        if d is not None:
            sizes.append(d.batch if d.batch is not None else server.batch)
        return d
    server.policy.select = record
    return sizes


def _replay(server, trace, frames, vc):
    sizes = _recorded(server)
    results = ttraffic.replay(server, trace, {"m": frames}, clock=vc,
                              sleep=vc.sleep)
    server.close()
    return results, sizes


@pytest.mark.parametrize("kind,rate,slo_ms", [
    ("poisson", 150.0, 50.0), ("bursty", 120.0, 40.0),
    ("diurnal", 90.0, 60.0)])
def test_continuous_replay_matches_repro(mnist_setup, kind, rate, slo_ms):
    jprog, packed, frames = mnist_setup
    trace = ttraffic.make_trace(kind, ["m"], rate, 20, seed=3)
    jvc, tvc = jtraffic.VirtualClock(start=1.0), ttraffic.VirtualClock(1.0)
    jsrv = JaxChipServer(
        {"m": jprog}, {"m": jax.tree_util.tree_map(jnp.asarray, packed)},
        batch=4, interpret=True, policy="continuous", slo_ms=slo_ms,
        clock=jvc)
    tsrv = ChipServer(
        {"m": tnets.mnist5()},
        {"m": convert.artifact_from_numpy(packed, device="cpu")},
        batch=4, megakernel=True, device="cpu", policy="continuous",
        slo_ms=slo_ms, clock=tvc)
    jres, jsizes = _replay(jsrv, trace, frames, jvc)
    tres, tsizes = _replay(tsrv, trace, frames, tvc)
    key = lambda r: (r.rid, r.label, r.dispatch, r.t_submit, r.t_done)
    assert [key(r) for r in tres] == [key(r) for r in jres]
    assert sorted(r.rid for r in tres) == list(range(len(trace)))
    assert tsizes == jsizes and tvc() == jvc()
    assert len(set(tsizes)) > 1              # the window really varied
    js, ts = jsrv.stats(), tsrv.stats()
    assert ts.policy == js.policy == "continuous"
    assert ts.served == js.served == {"m": len(trace)}
    assert ts.padded == js.padded
    assert ts.billed == sum(js.served.values()) + sum(js.padded.values())
    assert ts.billed == ts.total_served + sum(ts.padded.values())
    assert ts.dispatch_sizes == {s: tsizes.count(s) for s in set(tsizes)}
    assert ts.dispatches == js.dispatches
    assert (ts.p50_ms, ts.p95_ms, ts.p99_ms) == (js.p50_ms, js.p95_ms,
                                                 js.p99_ms)
    assert ts.padding_ratio == js.padding_ratio
    assert tsrv.latency_trace() == jsrv.latency_trace()


def _counts(out: str):
    """The served, dispatch and billing counts a driver run prints."""
    served = re.search(r"served (\d+) frames in (\d+) dispatches", out)
    bill = re.search(r"(\d+) served, (\d+) padded slots", out)
    return served.groups(), bill.groups()


def test_continuous_traffic_driver_counts_match_repro(capsys):
    """``--policy continuous --traffic poisson`` on both drivers: at a rate
    the host cannot keep pace with, the whole trace is admitted before
    the window opens (a ragged remainder padded on the ladder), so the
    counts do not depend on the host's speed."""
    argv = ["--programs", "mnist5", "--requests", "23", "--batch", "4",
            "--policy", "continuous", "--traffic", "poisson", "--rate",
            "1e6"]
    jdriver.main(argv)
    want = capsys.readouterr().out
    results, stats = tdriver.main(argv + ["--device", "cpu",
                                          "--megakernel"])
    got = capsys.readouterr().out
    assert _counts(got) == _counts(want) == (("23", "6"), ("23", "1"))
    assert len(results) == 23 and stats.dispatch_sizes == {4: 6}
    assert "billing             : 24 billed == 23 served + 1 padded" in got
    assert "input-to-label      : p50" in got
