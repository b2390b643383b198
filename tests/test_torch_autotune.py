"""The port's autotune cache (``repro_torch.kernels.autotune``) against
``repro``'s cache semantics, and every candidate geometry held bit-exact.

The first nine cases twin ``tests/test_autotune.py`` over the port's
fields (cluster sizes; the staged conv's feature slices and band rows):
cold defaults, explicit > cache, exact then nearest batch, fingerprints
partitioning entries, persistence across a reload, the three tuners
recording and the plans consuming (with a scripted ``timer``: the tuners
time the card's kernels, and there is none here), and a corrupt file
degrading to cold.  Then: a cold cache launches the formula's geometry
exactly; every candidate of each tuner's grid, run through the CPU
emulations of the cluster body (``tests/test_torch_member_mma.py``) and
the conv tile (``tests/test_torch_conv_mma.py``), gives the plain
versions' integers exactly (tolerance 0); a resolution assembles a
program once; a recorded entry steers the plans' next launch and
explicit arguments beat it; ``repro``'s ``BENCH_autotune.json`` is
neither read nor written.  The kernels at each geometry are held on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 5c.
"""

import builtins
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.chip import networks as jnetworks
from repro.kernels import autotune as jautotune
from repro_torch.core.binarize import thermometer_pack
from repro_torch.core.chip import interpreter, isa, networks
from repro_torch.kernels import autotune
from repro_torch.kernels import binary_conv2x2_block as bcb
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import ops as kops
from repro_torch.launch import chip_serve
from repro_torch.launch.chip_serve import build_artifact, frame_stream
from tests.test_torch_conv_mma import _case, emulate
from tests.test_torch_interpreter import one_torch_thread  # noqa: F401
from tests.test_torch_member_mma import (_random_image, emulate_delta,
                                         emulate_frame)

ROOT = Path(__file__).resolve().parents[1]
QUAD = ("cifar9_s4", "cifar9_s4t", "mnist5", "face_detector")


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    autotune.invalidate()
    yield path
    autotune.invalidate()


def scripted(values):
    """A timer that runs each candidate once (the plain versions) and
    reads its ms from ``values`` in grid order."""
    it = iter(values)

    def timer(fn, iters):
        fn()
        return next(it)
    return timer


def _setup(program, batch=6, seed=0):
    art = build_artifact(program, seed, True, "cpu")
    frames = torch.from_numpy(frame_stream(program, batch, seed + 1))
    return (interpreter.compile_plan(program), art,
            interpreter.ensure_image(art, program), frames)


def _capture(monkeypatch, name):
    """Record the keyword arguments each ``kops.<name>`` call gets."""
    seen, real = [], getattr(kops, name)

    def spy(*args, **kw):
        seen.append(kw)
        return real(*args, **kw)
    monkeypatch.setattr(kops, name, spy)
    return seen


# ---------------------------------------------------------------------------
# the cache: twins of tests/test_autotune.py
# ---------------------------------------------------------------------------

def test_cold_cache_falls_back_to_defaults(tmp_cache):
    program = networks.mnist5()
    assert autotune.mega_tiles(program, 8, device="cpu") == (
        autotune.DEFAULTS["mega"]["cluster"]) == 0
    assert autotune.conv_tiles(program, 8, device="cpu") == (
        autotune.DEFAULTS["staged_conv"]["nslices"],
        autotune.DEFAULTS["staged_conv"]["rows"]) == (0, 0)
    assert autotune.cascade_tiles((program,), 8, device="cpu") == 0


def test_explicit_arguments_beat_the_cache(tmp_cache):
    program = networks.mnist5()
    pkey = autotune.program_key(program)
    autotune.record("mega", pkey, 8, {"cluster": 2}, "cpu")
    assert autotune.mega_tiles(program, 8, device="cpu") == 2
    assert autotune.mega_tiles(program, 8, 4, device="cpu") == 4
    autotune.record("staged_conv", pkey, 8, {"nslices": 2, "rows": 4}, "cpu")
    assert autotune.conv_tiles(program, 8, device="cpu") == (2, 4)
    assert autotune.conv_tiles(program, 8, nslices=1, device="cpu") == (1, 4)
    assert autotune.conv_tiles(program, 8, 1, 0, device="cpu") == (1, 0)


def test_lookup_exact_then_nearest_batch(tmp_cache):
    program = networks.mnist5()
    pkey = autotune.program_key(program)
    autotune.record("mega", pkey, 8, {"cluster": 1}, "cpu")
    autotune.record("mega", pkey, 64, {"cluster": 4}, "cpu")
    assert autotune.mega_tiles(program, 8, device="cpu") == 1     # exact
    assert autotune.mega_tiles(program, 64, device="cpu") == 4    # exact
    assert autotune.mega_tiles(program, 48, device="cpu") == 4    # near 64
    assert autotune.mega_tiles(program, 9, device="cpu") == 1     # near 8
    assert autotune.mega_tiles(program, 36, device="cpu") == 1    # tie: 8


def test_program_and_backend_fingerprints_partition_entries(tmp_cache):
    a, b = networks.mnist5(), networks.mnist5(classes=2)
    assert autotune.program_key(a) != autotune.program_key(b)
    assert autotune.program_key(a) == autotune.program_key(networks.mnist5())
    # the same program hash as repro's (kernels/cache.py's copy)
    assert autotune.program_key(a) == jautotune.program_key(
        jnetworks.mnist5())
    autotune.record("mega", autotune.program_key(a), 8, {"cluster": 2},
                    "cpu")
    # a different program never sees another program's entry
    assert autotune.mega_tiles(b, 8, device="cpu") == 0
    # entries are keyed under the device's fingerprint: a card's entry
    # (another fingerprint) never steers the CPU, nor the CPU's a card
    raw = json.loads(tmp_cache.read_text())
    assert all(k.endswith("/cpu") and k.startswith("v1/mega/") for k in raw)
    card = "v1/mega/{}/b8/NVIDIA_H100_80GB_HBM3:sm90:torch2:cuda12".format(
        autotune.program_key(b))
    raw[card] = {"cluster": 4}
    tmp_cache.write_text(json.dumps(raw))
    autotune.invalidate()
    assert autotune.mega_tiles(b, 8, device="cpu") == 0
    # composite keys are order-sensitive and distinct from a solo key
    ck = autotune.composite_key((a, b))
    assert ck != autotune.composite_key((b, a)) and ck.startswith("comp-")


def test_cache_persists_across_process_reload(tmp_cache):
    program = networks.mnist5()
    autotune.record("staged_conv", autotune.program_key(program), 8,
                    {"nslices": 1, "rows": 2}, "cpu")
    autotune.invalidate()                      # a fresh process
    assert autotune.conv_tiles(program, 8, device="cpu") == (1, 2)


def test_tune_mega_records_and_forward_consumes(tmp_cache, monkeypatch):
    """tune_mega times the cluster grid, records the fastest (it beats the
    formula's clusters of 2 by more than MARGIN), and a forward_mega with
    no cluster then launches at it, bit-exact."""
    program = networks.mnist5()
    plan, art, image, frames = _setup(program)
    assert mk.cluster_geometry(mk.solo_member_spec(plan.mega)).cluster == 2
    report = []
    # the grid, then the confirmation: formula, winner, formula, winner
    entry = autotune.tune_mega(plan, image, frames,
                               timer=scripted([1.0, 3.0, 2.0, 4.0]
                                              + [3.0, 1.0] * 2),
                               report=report)
    assert [c["cluster"] for c, _ in report] == [1, 2, 4, 8]
    assert entry == {"cluster": 1, "ms": 1.0}
    assert autotune.mega_tiles(program, frames.shape[0], device="cpu") == 1
    seen = _capture(monkeypatch, "megakernel_forward")
    ref = plan.forward(art, frames, device="cpu")[0]
    got = plan.forward_mega(image, frames, device="cpu")[0]
    assert seen[-1]["cluster"] == 1
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("tuner", ["mega", "staged_conv", "composite"])
def test_tuners_keep_the_formula_within_the_margin(tmp_cache, tuner):
    """A candidate that beats the formula's geometry by less than MARGIN
    when the two are timed again alternately (reading noise) is not
    recorded: the entry holds 0 for every field (the formula) with the
    formula's ms, and the read side resolves to the formula; just past
    the margin the candidate is recorded; a grid reading past the margin
    that the confirmation does not repeat (a drift during the grid) is
    not.  The formula is timed even when the grid lacks it."""
    program = networks.mnist5()
    plan, art, image, frames = _setup(program, batch=2)
    near = 1.0 - autotune.MARGIN * 0.9
    far = 1.0 - autotune.MARGIN * 1.1
    if tuner == "mega":
        def run(times, **kw):
            return autotune.tune_mega(plan, image, frames,
                                      timer=scripted(times), **kw)
        # the grid's order: 1, 2 (the formula), 4, 8
        grid, fields, at = 4, ("cluster",), {"cluster": 4}
        times = lambda t: [1.5, 1.0, t, 2.0]                  # noqa: E731
    elif tuner == "staged_conv":
        def run(times, **kw):
            return autotune.tune_staged_conv(plan, art, frames,
                                             timer=scripted(times), **kw)
        grid, fields = 3 * len(autotune.ROWS), ("nslices", "rows")
        at = {"nslices": 1, "rows": 2}
        times = lambda t: [1.0] + [1.5] * (len(autotune.ROWS) + 1) + [t] + [
            1.5] * (grid - len(autotune.ROWS) - 3)            # noqa: E731
    else:
        progs = {"a": networks.mnist5(), "b": networks.mnist5(classes=2),
                 "c": networks.mnist5(classes=3),
                 "d": networks.mnist5(classes=5)}
        arts = {n: build_artifact(p, i, True, "cpu")
                for i, (n, p) in enumerate(progs.items())}
        cplan, cimage = interpreter.pack_programs(progs, arts)
        cframes = tuple(torch.from_numpy(frame_stream(p, 2, 70 + i))
                        for i, p in enumerate(progs.values()))

        def run(times, **kw):
            return autotune.tune_composite(cplan, cimage, cframes,
                                           timer=scripted(times), **kw)
        grid, fields, at = 4, ("cluster",), {"cluster": 4}
        times = lambda t: [1.5, 1.0, t, 2.0]                  # noqa: E731
    report = []
    entry = run(times(near) + [1.0, near] * autotune.CONFIRM, report=report)
    assert len(report) == grid
    assert report[len(autotune.ROWS) + 2 if tuner == "staged_conv"
                  else 2][0] == at
    assert entry == dict({f: 0 for f in fields}, ms=1.0)
    assert run(times(far) + [1.0, far] * autotune.CONFIRM) == dict(at,
                                                                   ms=far)
    # far in the grid, near when confirmed: the formula stays
    assert run(times(far) + [1.0, near, 1.01, 0.99]) == dict(
        {f: 0 for f in fields}, ms=1.0)
    if tuner == "mega":
        # a grid without the formula's 2: the formula is timed first
        report = []
        entry = run([1.0, 1.5, near] + [1.0, near] * autotune.CONFIRM,
                    clusters=(1, 4), report=report)
        assert [c["cluster"] for c, _ in report] == [2, 1, 4]
        assert entry == {"cluster": 0, "ms": 1.0}
        assert autotune.mega_tiles(program, 2, device="cpu") == 0


def test_tune_staged_conv_records(tmp_cache, monkeypatch):
    program = networks.mnist5()
    plan, art, _image, frames = _setup(program, seed=3)
    report = []
    # mnist5's F=64 is two slices: 4 and 8 clamp to 2, so the grid is
    # {0, 1, 2} x ROWS
    n = 3 * len(autotune.ROWS)
    times = [5.0] * n
    times[4] = 1.0
    entry = autotune.tune_staged_conv(plan, art, frames,
                                      timer=scripted(times + [5.0, 1.0] * 2),
                                      report=report)
    assert len(report) == n
    assert entry == dict(report[4][0], ms=1.0)
    assert autotune.conv_tiles(program, frames.shape[0], device="cpu") == (
        entry["nslices"], entry["rows"])
    seen = _capture(monkeypatch, "binary_conv2x2_block")
    ref = plan.forward(art, frames, device="cpu", conv_tiles=(0, 0))[0]
    assert all(kw["tiles"] is None for kw in seen)
    got = plan.forward(art, frames, device="cpu")[0]          # via cache
    want = plan.conv_geometry(frames.shape[0], entry["nslices"],
                              entry["rows"], "cpu")
    assert tuple(kw["tiles"] for kw in seen[-len(want):]) == want
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_tune_composite_records_and_forward_consumes(tmp_cache, monkeypatch):
    """tune_composite caches under the composite's key (not a member's)
    and CompositePlan.forward resolves through it, bit-exact."""
    progs = {"a": networks.mnist5(), "b": networks.mnist5(classes=2),
             "c": networks.mnist5(classes=3), "d": networks.mnist5(classes=5)}
    arts = {n: build_artifact(p, i, True, "cpu")
            for i, (n, p) in enumerate(progs.items())}
    frames = tuple(torch.from_numpy(frame_stream(p, 4, 50 + i))
                   for i, p in enumerate(progs.values()))
    cplan, cimage = interpreter.pack_programs(progs, arts)
    entry = autotune.tune_composite(cplan, cimage, frames,
                                    timer=scripted([2.0, 3.0, 1.5, 9.0]
                                                   + [3.0, 1.5] * 2))
    assert entry == {"cluster": 4, "ms": 1.5}
    assert autotune.composite_tiles(cplan.programs, 4, device="cpu") == 4
    # the members' solo keys stay cold
    assert autotune.mega_tiles(progs["a"], 4, device="cpu") == 0
    seen = _capture(monkeypatch, "composite_forward")
    ref = cplan.forward(cimage, frames, device="cpu", cluster=2)[0]
    got = cplan.forward(cimage, frames, device="cpu")[0]       # via cache
    assert [kw["cluster"] for kw in seen] == [2, 4]
    for r, g in zip(ref, got):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_corrupt_cache_file_degrades_to_cold(tmp_cache):
    """A broken cache file may never change behaviour: invalid JSON,
    valid non-dict JSON and bytes that are not text all read as cold."""
    program = networks.mnist5()
    for text in ("{not json", "[]", '"a string"', "3"):
        tmp_cache.write_text(text)
        autotune.invalidate()
        assert autotune.mega_tiles(program, 8, device="cpu") == 0, text
    tmp_cache.write_bytes(b"\xff\xfe\x00")
    autotune.invalidate()
    assert autotune.conv_tiles(program, 8, device="cpu") == (0, 0)


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------

def test_tuners_raise_on_the_cpu_without_a_timer(tmp_cache):
    program = networks.mnist5()
    plan, art, image, frames = _setup(program, batch=2)
    with pytest.raises(ValueError, match="CUDA device"):
        autotune.tune_mega(plan, image, frames)
    with pytest.raises(ValueError, match="CUDA device"):
        autotune.tune_staged_conv(plan, art, frames)
    assert not tmp_cache.exists()


def test_chip_serve_autotune_refuses_the_cpu():
    with pytest.raises(SystemExit):
        chip_serve.main(["--device", "cpu", "--programs", "mnist5",
                         "--megakernel", "--autotune"])


def _conv_layers(program):
    return [st[1:] for st in interpreter.compile_plan(program).mega
            if st[0] == "conv"]


@pytest.mark.parametrize("batch", [1, 8, 256])
def test_cold_cache_is_the_formula_geometry(tmp_cache, batch, monkeypatch):
    """With no entry, every plan launches the formula's geometry: the
    solo, composite, delta and cascade wrappers get no cluster (their
    own ``cluster_geometry(spec)``; 0 is that same geometry), the staged
    conv layers no tiles (``conv_tiles``), and make_conv_tiles at (0, 0)
    is conv_tiles at every REGISTRY conv layer."""
    for name in sorted(networks.REGISTRY):
        program = networks.REGISTRY[name]()
        plan = interpreter.compile_plan(program)
        spec = mk.solo_member_spec(plan.mega)
        assert mk.cluster_geometry(spec, 0) == mk.cluster_geometry(spec)
        assert autotune.mega_tiles(program, batch, device="cpu") == 0
        assert autotune.conv_tiles(program, batch, device="cpu") == (0, 0)
        assert plan.conv_geometry(batch, 0, 0, "cpu") == tuple(
            bcb.conv_tiles(batch, h, w, f, c // 32, pool)
            for h, w, c, f, pool in _conv_layers(program))
        for sms in (132, 16):
            for h, w, c, f, pool in _conv_layers(program):
                assert bcb.make_conv_tiles(
                    batch, h, w, f, c // 32, pool, sms=sms) == bcb.conv_tiles(
                    batch, h, w, f, c // 32, pool, sms=sms)
    program = networks.mnist5()
    plan, art, image, frames = _setup(program, batch=2)
    seen = {n: _capture(monkeypatch, n) for n in (
        "megakernel_forward", "binary_conv2x2_block", "delta_forward",
        "composite_forward", "cascade_forward")}
    plan.forward_mega(image, frames, device="cpu")
    plan.forward(art, frames, device="cpu")
    dplan, dimage = interpreter.pack_delta(program, art)
    last, llog = dplan.init_state(2, device="cpu")
    dplan.forward_delta(dimage, frames, last, llog,
                        dplan.delta_ctrl(float("-inf"), 2), device="cpu")
    progs = {n: networks.REGISTRY[n]() for n in QUAD}
    arts = {n: build_artifact(p, i, True, "cpu")
            for i, (n, p) in enumerate(progs.items())}
    cplan, cimage = interpreter.pack_programs(progs, arts)
    cplan.forward(cimage, [torch.from_numpy(frame_stream(p, 2, 1))
                           for p in progs.values()], device="cpu")
    assert seen["megakernel_forward"][0]["cluster"] is None
    assert seen["delta_forward"][0]["cluster"] is None
    assert seen["composite_forward"][0]["cluster"] is None
    assert all(kw["tiles"] is None for kw in seen["binary_conv2x2_block"])


def test_make_conv_tiles_refuses_what_the_kernel_cannot_take():
    for kw in (dict(nslices=3), dict(nslices=16), dict(rows=32),
               dict(nslices=4, rows=0)):
        with pytest.raises(ValueError):
            # F=64: two slices; 31 output rows
            bcb.make_conv_tiles(8, 32, 32, 64, 2, False, **kw)
    # a band of 31 rows of a 4000-wide map cannot fit shared memory; one
    # row is cut into column chunks instead
    with pytest.raises(ValueError, match="shared memory"):
        bcb.make_conv_tiles(1, 32, 4000, 256, 8, False, rows=31)
    t = bcb.make_conv_tiles(1, 32, 4000, 256, 8, False, rows=1)
    assert t.chunks > 1 and t.smem <= bcb.SMEM_LIMIT
    for rows in (1, 2, 4, 8, 31):
        for ns in (1, 2, 4, 8):
            t = bcb.make_conv_tiles(8, 32, 32, 256, 8, False, nslices=ns,
                                    rows=rows)
            assert (t.rows, t.nslices, t.bands) == (rows, ns, -(-31 // rows))
            assert t.grid == (8 * t.bands, 8 // ns)


def test_resolution_assembles_each_program_once(tmp_cache, monkeypatch):
    """Dispatches at two batches hash nothing after the first: one
    ``isa.assemble`` a program (a composite's members once each), until
    ``invalidate`` drops the memos."""
    program = networks.mnist5()
    plan, art, image, frames = _setup(program, batch=3)
    calls = []
    real = isa.assemble
    monkeypatch.setattr(isa, "assemble",
                        lambda p: calls.append(p) or real(p))
    autotune.invalidate()
    for f in (frames, frames[:2], frames, frames[:2]):
        plan.forward_mega(image, f, device="cpu")
        plan.forward(art, f, device="cpu")
    assert len(calls) == 1
    progs = {n: networks.REGISTRY[n]() for n in QUAD}
    arts = {n: build_artifact(p, i, True, "cpu")
            for i, (n, p) in enumerate(progs.items())}
    cplan, cimage = interpreter.pack_programs(progs, arts)
    calls.clear()
    for b in (2, 1, 2):
        cplan.forward(cimage, [torch.from_numpy(frame_stream(p, b, 1))
                               for p in progs.values()], device="cpu")
    assert len(calls) == len(QUAD)
    autotune.invalidate()
    calls.clear()
    plan.forward_mega(image, frames, device="cpu")
    assert len(calls) == 1


def test_a_recorded_entry_steers_every_plan_and_explicit_beats_it(
        tmp_cache, monkeypatch):
    """After ``record``, the next launch of each plan takes the recorded
    geometry (delta under the program's key, the cascade under the
    pair's composite key), an explicit argument overrides it, and a serve
    function built before the record follows it (resolved at call
    time)."""
    program = networks.mnist5()
    plan, art, image, frames = _setup(program, batch=4)
    serve = plan.make_fn(megakernel=True, device="cpu")
    pkey = autotune.program_key(program)
    seen = {n: _capture(monkeypatch, n) for n in (
        "megakernel_forward", "delta_forward", "cascade_forward")}
    serve(image, frames)
    autotune.record("mega", pkey, 4, {"cluster": 1}, "cpu")
    serve(image, frames)
    plan.forward_mega(image, frames, device="cpu", cluster=8)
    assert [kw["cluster"] for kw in seen["megakernel_forward"]] == [
        None, 1, 8]
    dplan, dimage = interpreter.pack_delta(program, art)
    last, llog = dplan.init_state(4, device="cpu")
    ctrl = dplan.delta_ctrl(float("-inf"), 4)
    dplan.forward_delta(dimage, frames, last, llog, ctrl, device="cpu")
    dplan.forward_delta(dimage, frames, last, llog, ctrl, device="cpu",
                        cluster=2)
    assert [kw["cluster"] for kw in seen["delta_forward"]] == [1, 2]
    progs = {"det": networks.mnist5(classes=2), "rec": networks.mnist5()}
    arts = {n: build_artifact(p, i, True, "cpu")
            for i, (n, p) in enumerate(progs.items())}
    cas, cimage = interpreter.pack_cascade(progs, arts, detector="det",
                                           recognizer="rec")
    f2 = torch.from_numpy(frame_stream(progs["det"], 4, 3))
    autotune.record("cascade", autotune.composite_key(cas.programs), 4,
                    {"det_cluster": 1}, "cpu")
    cas.forward_fused(cimage, f2, cas.margin_ctrl(0.0, 4), device="cpu")
    cas.forward_fused(cimage, f2, cas.margin_ctrl(0.0, 4), device="cpu",
                      det_cluster=2)
    assert [kw["det_cluster"] for kw in seen["cascade_forward"]] == [1, 2]
    # a geometry the kernel cannot take is refused on the CPU too
    with pytest.raises(ValueError):
        plan.forward_mega(image, frames, device="cpu", cluster=9)
    with pytest.raises(ValueError):
        plan.forward(art, frames, device="cpu", conv_tiles=(3, 0))


def _sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_bench_autotune_json_is_neither_read_nor_written(tmp_path,
                                                         monkeypatch):
    """With no env override the cache lives under build/, and tuning and
    resolution never open repro's BENCH_autotune.json."""
    bench = ROOT / "BENCH_autotune.json"
    before = _sha(bench)
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "BENCH_autotune.json").write_text("{}")
    opened, real_open = [], builtins.open

    def spy(file, *a, **kw):
        opened.append(str(file))
        return real_open(file, *a, **kw)
    monkeypatch.setattr(builtins, "open", spy)
    autotune.invalidate()
    program = networks.mnist5()
    plan, art, image, frames = _setup(program, batch=2)
    autotune.tune_mega(plan, image, frames,
                       timer=scripted([1.0, 2.0, 3.0, 4.0] + [2.0, 1.0] * 2))
    autotune.invalidate()
    assert autotune.mega_tiles(program, 2, device="cpu") == 1
    autotune.invalidate()
    assert autotune.cache_path() == str(Path("build", "repro_torch",
                                             "autotune.json"))
    assert opened and not any("BENCH_autotune" in p for p in opened)
    assert (tmp_path / "build" / "repro_torch" / "autotune.json").exists()
    assert _sha(bench) == before


# ---------------------------------------------------------------------------
# every candidate geometry, emulated on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cifar9_s1", "mnist5", "quad"])
def test_every_cluster_candidate_emulates_to_the_plain_logits(name):
    """tune_mega's and tune_composite's grid (CLUSTERS) at cifar9_s1,
    mnist5 and the 4 x S=4 quad: every size is a geometry the body takes,
    and the emulated cluster body at it equals the plain version, one
    frame a member (ranks may hold empty bands: ho < cluster)."""
    names = QUAD if name == "quad" else (name,)
    progs = {n: networks.REGISTRY[n]() for n in names}
    images = {n: _random_image(p, 20 + i)
              for i, (n, p) in enumerate(progs.items())}
    if name == "quad":
        cplan, image = interpreter.pack_programs(progs, images)
        spec = cplan.spec
        frames = [torch.from_numpy(frame_stream(p, 1, 40 + i))
                  for i, p in enumerate(progs.values())]
        want = mk.composite_plain(image, frames, spec=spec)
    else:
        image = images[name]
        mega = interpreter.compile_plan(progs[name]).mega
        spec = mk.solo_member_spec(mega)
        frames = [torch.from_numpy(frame_stream(progs[name], 1, 40))]
        want = (mk.megakernel_plain(image, frames[0], spec=mega),)
    for cluster in autotune.CLUSTERS:
        geo = mk.cluster_geometry(spec, cluster)
        assert geo.cluster == cluster and geo.smem <= mk.SMEM_LIMIT
        for m, (stages, f, wm) in enumerate(zip(spec, frames, want)):
            got = emulate_frame(stages, m, image, f[0].numpy(), geo)
            np.testing.assert_array_equal(got, wm[0].numpy(),
                                          err_msg=f"{name} c{cluster} m{m}")


# the delta gate's cases: program -> (B, changed lanes of each case, drain
# rb values); lane 0 unchanged in the middle case, so the drain's lane-0
# rule recomputes it
DELTA_CHANGES = {"cifar9_s1": (2, ((0, 1), (1,), ()), (0,)),
                 "mnist5": (8, (tuple(range(8)), (1, 2, 4, 6, 7), ()),
                            (0, 2))}
_DELTA_PLAIN = {}        # delta_plain's outputs, shared by the clusters


@pytest.mark.parametrize("cluster", autotune.CLUSTERS)
@pytest.mark.parametrize("name", sorted(DELTA_CHANGES))
def test_every_cluster_candidate_emulates_the_delta_recompute(name, cluster):
    """DeltaPlan.forward_delta resolves its recompute's cluster through the
    megakernel's cache entry, so every size of tune_mega's grid reaches
    csrc/delta.cu: at each, from a warm state with all, some and no lanes
    changed, the emulated gate, scan and recompute clusters give
    delta_plain's logits, new_last, queue, counts and deltas exactly, at
    the serve's drain schedule (and at rb = 2 on mnist5)."""
    b, cases, rbs = DELTA_CHANGES[name]
    prog = networks.REGISTRY[name]()
    plan, image = interpreter.pack_delta(prog, _random_image(prog, 60))
    geo = mk.cluster_geometry(plan.spec, cluster)
    assert geo.cluster == cluster and geo.smem <= mk.SMEM_LIMIT
    io = prog.instrs[0]
    frames = torch.from_numpy(frame_stream(prog, b, 61))
    llog = torch.from_numpy(np.random.default_rng(62).integers(
        -50, 50, (b, plan.classes), dtype=np.int32))
    memo = {}
    for lanes in cases:
        prev = frames.clone()
        for i in lanes:
            prev[i, :2, :2] = (prev[i, :2, :2] + 2 ** io.bits // 2) % (
                2 ** io.bits)
        last = thermometer_pack(prev, io.bits, io.in_channels, io.channels)
        ctrl = plan.delta_ctrl(1.0, b)
        for rb in rbs:
            key = (name, lanes, rb)
            if key not in _DELTA_PLAIN:
                _DELTA_PLAIN[key] = mk.delta_plain(
                    image, frames, last, llog, ctrl, spec=plan.spec, rb=rb)
            want = _DELTA_PLAIN[key]
            got = emulate_delta(plan.spec[0], image, frames, last, llog,
                                ctrl, geo, rb=rb, memo=memo)
            assert int(want[3][0]) == len(lanes)
            for g, w, what in zip(got, want, ("logits", "new_last", "queue",
                                              "counts", "deltas")):
                np.testing.assert_array_equal(
                    g, w.numpy().view(np.uint32) if what == "new_last"
                    else w.numpy(), err_msg=f"{what} {lanes} rb={rb}")


@pytest.mark.parametrize("name", ["cifar9_s1", "mnist5", "quad"])
def test_every_conv_candidate_emulates_to_the_plain_layers(name):
    """tune_staged_conv's grid (NSLICES x ROWS, clamped as the plan
    clamps them) at cifar9_s1, mnist5 and the quad's four programs: each
    candidate either is refused by make_conv_tiles at some layer (and so
    skipped) or gives every conv layer a geometry whose emulated tile
    equals conv_block_body on random words, one frame; so the staged
    logits equal the plain version's at every accepted candidate.  Each
    distinct layer geometry is emulated once."""
    names = QUAD if name == "quad" else (name,)
    rng = np.random.default_rng(len(name))
    checked, accepted = set(), 0
    for n in names:
        program = networks.REGISTRY[n]()
        plan = interpreter.compile_plan(program)
        fslices = isa.ARRAY_CHANNELS // program.s // 32
        layers = _conv_layers(program)
        cases = {}
        for ns in sorted({min(v, fslices) for v in autotune.NSLICES}):
            for rows in autotune.ROWS:
                try:
                    tiles = plan.conv_geometry(1, ns, rows, "cpu")
                except ValueError:
                    continue
                accepted += 1
                for layer, t in zip(layers, tiles):
                    if (layer, t) in checked:
                        continue
                    checked.add((layer, t))
                    h, w, c, f, pool = layer
                    if layer not in cases:
                        cases[layer] = _case(rng, 1, h, w, c, f)
                    a, wt, tau, flip = cases[layer]
                    got = emulate(a, wt, c, tau=tau, flip=flip, pool=pool,
                                  tiles=t)
                    plain = bcb.conv_block_body(
                        torch.from_numpy(a.view(np.int32)),
                        torch.from_numpy(wt.view(np.int32)),
                        torch.from_numpy(tau), torch.from_numpy(flip),
                        k4=4 * c, h=h, wd=w, pool=pool)
                    np.testing.assert_array_equal(
                        got, plain.numpy().view(np.uint32),
                        err_msg=f"{n} {layer} {t}")
    assert accepted >= len(autotune.ROWS) * len(names)
