"""The port's operating-point controller and family serving vs ``repro``'s.

``OperatingPointPolicy`` is host-only Python, so its decisions are held
against ``repro``'s one for one: on seeded queues and budgets, every
dispatch (lanes, chosen variants, request ids, pad target) and the
committed energy and chip time are equal, as are ``_choose`` under
backlog and scene-activity downshifts, the exact-tiling riders of
``shared=True`` and the reset on rebinding.  End to end, a ``cifar10``
family (S=1 at full width down to the truncated S=4 net) served by the
port's ``ChipServer`` on the CPU, under a budget that forces switches,
gives for every frame the logits and label of ``repro``'s float reference
of the variant that served it.  Tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.chip import energy as jenergy, interpreter as jinterp
from repro.core.chip import isa as jisa, networks as jnets
from repro.serving import policy as jpolicy, queue as jqueue
from repro_torch import convert
from repro_torch.core.chip import energy as tenergy, interpreter as tinterp
from repro_torch.core.chip import isa as tisa, networks as tnets
from repro_torch.serving import CascadePipeline, ChipServer
from repro_torch.serving import policy as tpolicy, queue as tqueue
from tests.test_torch_interpreter import (_np_tree, _oracle,  # noqa: F401
                                          np_params, one_torch_thread)

# lane -> variants: two families of different energy spreads (S=4 down to
# a truncated S=4 net, S=1 down to S=4) and two plain lanes (S=4, S=2)
LANES = {"cifar10": ("cifar9_s4", "cifar9_s4t"),
         "face": ("owner_detector", "face_detector"),
         "mnist5": ("mnist5",),
         "angles": ("face_angles",)}


def _context(pkg, batch, lanes=LANES):
    nets, energy, policy = pkg
    variants = {lane: tuple(vs) for lane, vs in lanes.items()}
    programs = {v: nets.REGISTRY[v]() for vs in variants.values()
                for v in vs}
    return policy.PolicyContext(
        batch=batch, lanes=tuple(variants), variants=variants,
        programs=programs,
        reports={n: energy.analyze_net(p) for n, p in programs.items()},
        groups={})


JAX = (jnets, jenergy, jpolicy)
TORCH = (tnets, tenergy, tpolicy)


def _floor_power(batch):
    ctx = _context(JAX, batch)
    return min(r.power_w for r in ctx.reports.values()) * 1e6


def _make(kind, batch, lanes=LANES):
    """The same policy in both packages, bound to equal contexts."""
    kw = dict(opp={}, budget=dict(budget_uj_s=_floor_power(batch) * 1.5),
              shared=dict(shared=True, budget_uj_s=1e-6),
              shared_top=dict(shared=True),
              backlog=dict(backlog_high=2 * batch))[kind]
    pols = []
    for pkg in (JAX, TORCH):
        pol = pkg[2].OperatingPointPolicy(**kw)
        pol.bind(_context(pkg, batch, lanes))
        pols.append(pol)
    return pols


def _dispatch(d):
    if d is None:
        return None
    return d.batch, tuple((ld.lane, ld.variant,
                           tuple(r.rid for r in ld.requests))
                          for ld in d.lanes)


@pytest.mark.parametrize("kind", ["opp", "budget", "shared", "shared_top",
                                  "backlog"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decisions_match_repro_on_seeded_queues(kind, seed):
    rng = np.random.default_rng(seed)
    batch = int(rng.integers(1, 5))
    jpol, tpol = _make(kind, batch)
    jq, tq = (mod.FrameQueue(tuple(LANES)) for mod in (jqueue, tqueue))
    lanes = list(LANES)
    rid = 0
    dispatches = 0
    for step in range(120):
        if rng.random() < 0.6:
            lane = lanes[int(rng.integers(len(lanes)))]
            for q, mod in ((jq, jqueue), (tq, tqueue)):
                q.submit(mod.FrameRequest(rid=rid, program=lane, frame=None))
            rid += 1
        else:
            if kind != "opp" and rng.random() < 0.3:
                act = float(rng.random())
                lane = ("cifar10", "face")[int(rng.integers(2))]
                jpol.set_activity(lane, act)
                tpol.set_activity(lane, act)
            want, got = _dispatch(jpol.select(jq)), _dispatch(tpol.select(tq))
            assert got == want, step
            dispatches += want is not None
            assert tpol.spent_uj == jpol.spent_uj
            assert tpol.chip_time_s == jpol.chip_time_s
    assert tpol.variant_dispatches == jpol.variant_dispatches
    assert tpol.downshift_ratio() == jpol.downshift_ratio()
    assert dispatches > 10


def test_choose_matches_repro_under_backlog_and_activity():
    jpol, tpol = _make("budget", 2)
    for lane in ("cifar10", "face", "mnist5"):
        assert tpol.variant_order(lane) == jpol.variant_order(lane)
    grid = [(p, s, spent, t) for p in (0, 3, 8, 20) for s in (1, 2, 4)
            for spent, t in ((0.0, 0.0), (50.0, 0.01), (1e4, 0.001))]
    for act in (None, 0.9, 0.1, 0.25, 0.0):
        if act is not None:
            jpol.set_activity("cifar10", act)
            tpol.set_activity("cifar10", act)
        for args in grid:
            assert (tpol._choose("cifar10", *args)
                    == jpol._choose("cifar10", *args)), (act, args)
    order = tpol.variant_order("cifar10")
    assert tpol._choose("cifar10", 0, 2, 0.0, 0.0) == order[1]   # quiet
    for bad in (dict(lane="nope", activity=0.5),
                dict(lane="cifar10", activity=1.5)):
        for pol in (jpol, tpol):
            with pytest.raises((KeyError, ValueError)):
                pol.set_activity(bad["lane"], bad["activity"])
    for kw in (dict(budget_uj_s=0.0), dict(activity_low=1.5)):
        with pytest.raises(ValueError):
            tpolicy.OperatingPointPolicy(**kw)


def test_riders_need_an_exact_tiling():
    """At the floor the two families run S=4 variants and face_angles is
    S=2: all three backlogged tile the array (1/4 + 1/4 + 1/2) and ride
    one dispatch; the two families alone fill half of it, so the head
    lane goes solo."""
    lanes = {k: LANES[k] for k in ("cifar10", "face", "angles")}
    for backlogged, want in ((tuple(lanes), 3), (("cifar10", "face"), 1)):
        jpol, tpol = _make("shared", 2, lanes)
        jq, tq = (mod.FrameQueue(tuple(lanes)) for mod in (jqueue, tqueue))
        for lane in backlogged:
            for q, mod in ((jq, jqueue), (tq, tqueue)):
                q.submit(mod.FrameRequest(rid=0, program=lane, frame=None))
        want_d, got_d = _dispatch(jpol.select(jq)), _dispatch(tpol.select(tq))
        assert got_d == want_d and len(got_d[1]) == want


def test_rebinding_resets_committed_state():
    tpol = tpolicy.OperatingPointPolicy(budget_uj_s=1e12)
    tpol.bind(_context(TORCH, 2))
    q = tqueue.FrameQueue(tuple(LANES))
    q.submit(tqueue.FrameRequest(rid=0, program="cifar10", frame=None))
    tpol.select(q)
    tpol.set_activity("cifar10", 0.1)
    assert tpol.spent_uj > 0
    tpol.bind(_context(TORCH, 4))
    assert tpol.spent_uj == 0.0 and tpol.chip_time_s == 0.0
    assert tpol._backlog_high == 16 and tpol._activity == {}


@pytest.fixture(scope="module")
def cifar10_family():
    """The cifar10 family's four variants from numpy params: repro's float
    references of every variant on six frames, and the port's artifacts
    carried from repro's packed ones."""
    names = jnets.FAMILIES["cifar10"]
    jprogs = {n: jnets.REGISTRY[n]() for n in names}
    npp = {n: np_params(p, 70 + i) for i, (n, p) in enumerate(jprogs.items())}
    io = jprogs[names[0]].instrs[0]
    frames = np.random.default_rng(79).integers(
        0, 2 ** io.bits, (6, io.height, io.width, io.in_channels),
        dtype=np.int32)
    oracle = {n: _oracle(jprogs[n], npp[n], frames) for n in names}
    arts = {n: convert.artifact_from_numpy(_np_tree(jinterp.fold_params(
        jax.tree_util.tree_map(jnp.asarray, npp[n]), jprogs[n],
        packed=True)), device="cpu") for n in names}
    return names, arts, frames, oracle


@pytest.mark.parametrize("megakernel", [True, False])
def test_family_served_per_chosen_variant(cifar10_family, megakernel):
    """A budget between the S=1 and S=2 powers makes the controller switch
    between them; every served frame carries the variant that ran it and
    that variant's float-reference logits and label, and the per-variant
    ledger balances."""
    names, arts, frames, oracle = cifar10_family
    tprogs = {n: tnets.REGISTRY[n]() for n in names}
    powers = {n: tenergy.analyze_net(p).power_w * 1e6
              for n, p in tprogs.items()}
    budget = (powers["cifar9_s1"] + powers["cifar9_s2"]) / 2
    server = ChipServer(tprogs, arts, batch=1, device="cpu",
                        megakernel=megakernel, families={"cifar10": names},
                        budget_uj_s=budget)
    rids = server.submit_many("cifar10", frames)
    results = server.drain()
    assert [r.rid for r in results] == rids
    used = {r.variant for r in results}
    assert len(used) >= 2 and used <= set(names)
    for i, r in enumerate(results):
        assert r.program == "cifar10"
        np.testing.assert_array_equal(r.logits, oracle[r.variant][0][i])
        assert r.label == oracle[r.variant][1][i]
    st = server.stats()
    assert st.policy == "operating-point" and st.budget_uj_s == budget
    assert 0.0 < st.downshift_ratio < 1.0
    assert st.served == {"cifar10": len(frames)}
    assert st.billed == sum(server._vserved[v] + server._vpadded[v]
                            for v in names) == len(frames)
    assert {v for v, n in st.variant_dispatches.items() if n} == used
    pol = server.policy
    assert pol.spent_uj <= budget * pol.chip_time_s + max(
        tenergy.analyze_net(p).i2l_energy_per_inference * 1e6
        for p in tprogs.values())


def test_server_guards_families_like_repro(cifar10_family):
    names, arts, _, _ = cifar10_family
    tprogs = {n: tnets.REGISTRY[n]() for n in names}
    for kw, match in ((dict(families={"cifar9_s1": ("cifar9_s2",)}),
                       "collides"),
                      (dict(families={"f": ("ghost",)}), "not resident"),
                      (dict(families={"f": ("cifar9_s1",),
                                      "g": ("cifar9_s1",)}),
                       "belongs to families"),
                      (dict(families={"f": names}, policy="static"),
                       "policy"),
                      (dict(policy="zigzag"), "unknown policy")):
        with pytest.raises(ValueError, match=match):
            ChipServer(tprogs, arts, device="cpu", **kw)
    mixed = {"cifar9_s1": tprogs["cifar9_s1"],
             "mnist5": tnets.REGISTRY["mnist5"]()}
    with pytest.raises(Exception, match="IO geometry"):
        ChipServer(mixed, {"cifar9_s1": arts["cifar9_s1"],
                           "mnist5": arts["cifar9_s1"]}, device="cpu",
                   families={"f": tuple(mixed)})


def test_cascade_stages_refuse_family_lanes(cifar10_family):
    """As in repro, a cascade stage must be a single-variant lane: its
    bill is per stage program."""
    names, arts, _, _ = cifar10_family
    tprogs = {n: tnets.REGISTRY[n]() for n in names}
    server = ChipServer(tprogs, arts, device="cpu",
                        families={"small": ("cifar9_s4", "cifar9_s4t")},
                        policy="operating-point")
    assert server.families == {"small": ("cifar9_s4", "cifar9_s4t")}
    assert set(server.queue.lanes) == {"small", "cifar9_s1", "cifar9_s2"}
    for det, rec in (("small", "cifar9_s1"), ("cifar9_s2", "small")):
        with pytest.raises(ValueError, match="program family"):
            CascadePipeline(server, det, rec)


def test_compile_family_matches_repro():
    names = jnets.FAMILIES["cifar10"]
    plans = tinterp.compile_family({n: tnets.REGISTRY[n]() for n in names})
    assert tuple(plans) == names
    assert all(p.mega == tinterp.compile_plan(tnets.REGISTRY[n]()).mega
               for n, p in plans.items())
    for nets, isa_, interp in ((tnets, tisa, tinterp),
                               (jnets, jisa, jinterp)):
        for bad, match in (({"a": nets.mnist5(), "b": nets.cifar9(4)},
                            "IO geometry"),
                           ({"a": nets.mnist5(),
                             "b": nets.mnist5(classes=5)}, "class count")):
            with pytest.raises(isa_.ProgramError, match=match):
                interp.compile_family(bad)
    with pytest.raises(ValueError):
        tinterp.compile_family({})
