"""The port's temporal tier vs ``repro``'s: video traces, the host gate
references and calibration, and ``TemporalPipeline`` end to end.

``repro`` serves in Pallas interpret mode, the port on the CPU (the plain
versions of the kernels).  Every result (label, computed, delta, variant,
logits), the server ledger per lane and per variant, the energy report
and the behaviour after ``reset`` are equal, for a single-program lane and
for a program-family lane under the operating-point controller, whose
scene-activity downshift switches variants mid-stream.  Tolerance 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.chip import interpreter as jinterp, networks as jnets
from repro.serving import ChipServer as JaxChipServer
from repro.serving import temporal as jtmp
from repro.serving import traffic as jtraffic
from repro_torch import convert
from repro_torch.core.chip import networks as tnets
from repro_torch.launch import chip_serve
from repro_torch.serving import ChipServer, StaticPolicy, temporal as ttmp
from repro_torch.serving import traffic as ttraffic
from tests.test_torch_interpreter import (_np_tree,  # noqa: F401
                                          np_params, one_torch_thread)


def _artifact(program, seed):
    """repro's packed artifact from numpy params, as numpy."""
    return _np_tree(jinterp.fold_params(
        jax.tree_util.tree_map(jnp.asarray, np_params(program, seed)),
        program, packed=True))


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _trace(program, n, streams, seed, **kw):
    io = program.instrs[0]
    return jtraffic.video_trace((io.height, io.width, io.in_channels), n,
                                streams=streams, seed=seed,
                                levels=2 ** io.bits, **kw)


@pytest.mark.parametrize("kw", [
    dict(shape=(8, 8, 1), n=10, streams=3, seed=7, change_rate=0.4,
         scene_change_every=4, levels=16),
    dict(shape=(14, 14, 1), n=6, streams=4, seed=3, change_rate=0.3,
         levels=256),
    dict(shape=(32, 32, 3), n=5, streams=2, seed=11, change_rate=0.0,
         patch=40),
])
def test_video_trace_matches_repro(kw):
    kw = dict(kw)
    args = (kw.pop("shape"), kw.pop("n"))
    a = jtraffic.video_trace(*args, **kw)
    b = ttraffic.video_trace(*args, **kw)
    assert np.array_equal(a.frames, b.frames)
    assert np.array_equal(a.changed, b.changed)
    assert a.meta == b.meta and a.seed == b.seed
    assert a.change_ratio == b.change_ratio


def test_arrival_traces_match_repro():
    for kind in jtraffic.TRAFFIC_KINDS:
        a = jtraffic.make_trace(kind, ("x", "y"), 300.0, 40, seed=5)
        b = ttraffic.make_trace(kind, ("x", "y"), 300.0, 40, seed=5)
        assert np.array_equal(a.t, b.t) and a.lane == b.lane
        assert a.meta == b.meta


@pytest.fixture(scope="module")
def mnist_trace():
    prog = jnets.mnist5()
    art = _artifact(prog, 21)
    return prog, art, _trace(prog, 6, 4, 22, change_rate=0.3)


def test_gate_references_match_repro(mnist_trace):
    prog, art, trace = mnist_trace
    tprog = tnets.mnist5()
    j_arr, j_packed = jtmp._packed_streams(trace.frames, prog)
    t_arr, t_packed = ttmp._packed_streams(trace.frames, tprog)
    assert np.array_equal(j_arr, t_arr)
    assert t_packed.dtype == j_packed.dtype == np.uint32
    assert np.array_equal(j_packed, t_packed)
    for thr in (1.0, 2.5, 40.0, float("inf")):
        for a, b in zip(jtmp.simulate_gate(j_packed, thr),
                        ttmp.simulate_gate(t_packed, thr)):
            assert np.array_equal(a, b)
    assert (ttmp._candidate_thresholds(t_packed)
            == jtmp._candidate_thresholds(j_packed))
    for target in (0.0, 0.3, 0.6):
        assert (ttmp.threshold_for_skip(trace.frames, target, program=tprog)
                == jtmp.threshold_for_skip(trace.frames, target,
                                           program=prog))
    with pytest.raises(ValueError, match="unreachable"):
        ttmp.threshold_for_skip(trace.frames, 0.99, program=tprog)
    tart = convert.artifact_from_numpy(art, device="cpu")
    for target in (0.5, 0.95, 1.0):
        assert (ttmp.calibrate_delta_threshold(
                    trace.frames, target, program=tprog, artifact=tart,
                    device="cpu")
                == jtmp.calibrate_delta_threshold(
                    trace.frames, target, program=prog, artifact=_jax(art),
                    interpret=True))
    with pytest.raises(ValueError):
        ttmp.calibrate_delta_threshold(trace.frames, 0.0, program=tprog,
                                       artifact=tart, device="cpu")


def _results(results):
    return [(r.rid, r.label, r.computed, r.delta, r.variant,
             tuple(np.asarray(r.logits).tolist())) for r in results]


def _serve_both(progs, art, trace, families=None, reset_after=None, **kw):
    """The same trace through repro's pipeline (interpret mode) and the
    port's (CPU), submitted step by step round-robin; ``reset_after``
    resets both pipelines after that many steps."""
    lane = next(iter(families)) if families else next(iter(progs[0]))
    out = []
    for jax_side in (True, False):
        if jax_side:
            srv = JaxChipServer(progs[0], _jax(art), batch=trace.streams,
                                interpret=True, families=families)
            tmp = jtmp
        else:
            srv = ChipServer(progs[1], {n: convert.artifact_from_numpy(
                a, device="cpu") for n, a in art.items()},
                batch=trace.streams, device="cpu", families=families)
            tmp = ttmp
        pipe = tmp.TemporalPipeline(srv, lane, **kw)
        results = []
        for t in range(len(trace)):
            if t == reset_after:
                results += pipe.drain()
                pipe.reset()
            pipe.submit_many(trace.frames[t])
        results += pipe.drain()
        out.append((srv, pipe, _results(results)))
    return out


def _same_books(jside, tside):
    (jsrv, jpipe, jres), (tsrv, tpipe, tres) = jside, tside
    assert tres == jres
    js, ts = jsrv.stats(), tsrv.stats()
    assert ts.served == js.served and ts.padded == js.padded
    assert tsrv._vserved == jsrv._vserved
    assert tsrv._vpadded == jsrv._vpadded
    assert ts.billed == ts.total_served + sum(ts.padded.values()) == sum(
        tsrv._vserved[v] + tsrv._vpadded[v] for v in tsrv.programs)
    assert ts.variant_dispatches == js.variant_dispatches
    assert dataclasses.asdict(ts.chip) == dataclasses.asdict(js.chip)
    assert ts.energy_uj == js.energy_uj
    assert dataclasses.asdict(tpipe.report()) == dataclasses.asdict(
        jpipe.report())
    for attr in ("frames", "computed", "skipped", "skip_ratio", "activity",
                 "gated_dispatches", "submitted"):
        assert getattr(tpipe, attr) == getattr(jpipe, attr), attr


@pytest.mark.parametrize("threshold,rb,check_every",
                         [(1.0, 1, 1), (30.0, 2, 2), (float("-inf"), 3, 1)])
def test_pipeline_matches_repro(mnist_trace, threshold, rb, check_every):
    prog, art, trace = mnist_trace
    jside, tside = _serve_both(({"m": prog}, {"m": tnets.mnist5()}),
                               {"m": art}, trace, threshold=threshold,
                               rb=rb, check_every=check_every)
    _same_books(jside, tside)
    tpipe, tres = tside[1], tside[2]
    assert tpipe.frames == len(trace) * trace.streams
    if threshold == 1.0:        # skips only bit-identical frames
        assert tpipe.computed == int(trace.changed.sum())
        assert all(r[3] == 0 for r in tres if not r[2])
    if threshold == float("-inf"):
        assert tpipe.skipped == 0
    else:
        assert tpipe.skipped > 0


def test_pipeline_reset_matches_repro(mnist_trace):
    """reset() mid-stream drops the gate state: the next dispatch
    recomputes every stream, on both sides alike."""
    prog, art, trace = mnist_trace
    jside, tside = _serve_both(({"m": prog}, {"m": tnets.mnist5()}),
                               {"m": art}, trace, reset_after=3,
                               threshold=1.0, rb=1)
    _same_books(jside, tside)
    tres = tside[2]
    step3 = [r for r in tres if 3 * trace.streams <= r[0]
             < 4 * trace.streams]
    assert all(r[2] for r in step3)
    assert tside[1].gated_dispatches == len(trace)


def test_pipeline_calibrate_matches_repro(mnist_trace):
    """TemporalPipeline.calibrate adopts the same threshold as repro's,
    from the pipeline's own program and artifact."""
    prog, art, trace = mnist_trace
    jsrv = JaxChipServer({"m": prog}, {"m": _jax(art)}, batch=4,
                         interpret=True)
    tsrv = ChipServer({"m": tnets.mnist5()},
                      {"m": convert.artifact_from_numpy(art, device="cpu")},
                      batch=4, device="cpu")
    jpipe = jtmp.TemporalPipeline(jsrv, "m", rb=1)
    tpipe = ttmp.TemporalPipeline(tsrv, "m", rb=1)
    for target in (0.9, 1.0):
        thr = tpipe.calibrate(trace.frames, target)
        assert thr == tpipe.threshold == jpipe.calibrate(trace.frames,
                                                         target) >= 1.0


def test_family_lane_matches_repro():
    """A cifar10 family (S=4 and its truncated twin) under the
    operating-point controller: a quiet scene pulls the activity EWMA
    below activity_low, the controller downshifts, and the switch
    cold-starts the incoming variant.  Every result, the ledger per
    variant and the summed report equal repro's."""
    names = ("cifar9_s4", "cifar9_s4t")
    jprogs = {n: jnets.REGISTRY[n]() for n in names}
    tprogs = {n: tnets.REGISTRY[n]() for n in names}
    art = {n: _artifact(p, 30 + i) for i, (n, p) in enumerate(jprogs.items())}
    trace = _trace(jprogs[names[0]], 6, 2, 31, change_rate=0.0)
    jside, tside = _serve_both((jprogs, tprogs), art, trace,
                               families={"cifar10": names}, threshold=1.0,
                               rb=1)
    _same_books(jside, tside)
    res = tside[2]
    steps = [res[i:i + trace.streams]
             for i in range(0, len(res), trace.streams)]
    variants = [step[0][4] for step in steps]
    assert set(variants) == set(names)
    for prev, step in zip(variants, steps[1:]):
        if step[0][4] != prev:          # a switch cold-starts the newcomer
            assert all(r[2] for r in step)
    assert tside[0].stats().downshift_ratio > 0


def test_pipeline_validation_matches_repro():
    prog, tprog = jnets.mnist5(), tnets.mnist5()
    art = _artifact(prog, 1)
    tart = convert.artifact_from_numpy(art, device="cpu")
    jsrv = JaxChipServer({"m": prog}, {"m": _jax(art)}, batch=2,
                         interpret=True)
    tsrv = ChipServer({"m": tprog}, {"m": tart}, batch=2, device="cpu")
    for kw, exc in ((dict(lane="nope"), KeyError),
                    (dict(lane="m", threshold=float("nan")), ValueError),
                    (dict(lane="m", activity_alpha=0.0), ValueError),
                    (dict(lane="m", activity_alpha=1.5), ValueError)):
        kw = dict(kw)
        lane = kw.pop("lane")
        with pytest.raises(exc):
            jtmp.TemporalPipeline(jsrv, lane, **kw)
        with pytest.raises(exc):
            ttmp.TemporalPipeline(tsrv, lane, **kw)
    fam = {n: tnets.REGISTRY[n]() for n in ("cifar9_s4", "cifar9_s4t")}
    farts = {n: chip_serve.build_artifact(p, 0, False, "cpu")
             for n, p in fam.items()}

    srv = ChipServer(fam, farts, batch=2, device="cpu",
                     families={"cifar10": tuple(fam)}, policy=StaticPolicy())
    with pytest.raises(ValueError, match="OperatingPointPolicy"):
        ttmp.TemporalPipeline(srv, "cifar10")


def test_video_driver_on_the_cpu(capsys):
    results, rep = chip_serve.main(
        ["--video", "--programs", "mnist5", "--requests", "16", "--batch",
         "4", "--change-rate", "0.3", "--device", "cpu"])
    assert len(results) == 16 and rep.frames == 16
    assert rep.computed + rep.skipped == 16
    out = capsys.readouterr().out
    assert "temporal served 16 frames in 4 gated dispatches" in out
    assert "billed ==" in out
