"""Chip-tier serving driver: ``python -m repro_torch.launch.chip_serve``.

The counterpart of ``repro.launch.chip_serve`` for static-batch service
over one or more resident BinarEye programs on one GPU: seeded synthetic
frame streams are enqueued per program, the :class:`ChipServer`
dispatches fixed-size batches round-robin through each program's compiled
plan (staged kernels, or the megakernel with ``--megakernel``), and the
run closes with the host throughput plus the chip-model bill (µJ/frame,
frames/s, average power analogue) from ``chip/energy.py``::

    PYTHONPATH=src python -m repro_torch.launch.chip_serve \\
        --programs cifar9_s1,mnist5 --requests 64 --batch 8 --megakernel

``--shared`` serves programs whose S-modes tile the 256-channel array as
one composite launch per batch; ``--cascade`` runs the always-on face
cascade (S=4 ``face_detector`` on every frame, escalations to the S=1
``owner_detector``), host-side or, with ``--fused``, as one fused dispatch
per batch::

    PYTHONPATH=src python -m repro_torch.launch.chip_serve \
        --programs cifar9_s4,mnist5,face_detector,cifar9_s4t --shared
    PYTHONPATH=src python -m repro_torch.launch.chip_serve \
        --cascade --fused --requests 64 --batch 8

``--policy operating-point`` serves program *families*: names in
``--programs`` may be ``networks.FAMILIES`` entries (e.g. ``cifar10``),
whose variants are served behind one lane by the energy-accuracy
controller; ``--budget-uj-s`` caps the chip-model average power.
``--video`` serves a seeded always-on video stream through the delta-gated
``TemporalPipeline``: one camera stream per batch slot, only the streams
whose packed frame changed recompute (``--delta-threshold``, or calibrated
with ``--target-agreement`` / ``--target-skip``)::

    PYTHONPATH=src python -m repro_torch.launch.chip_serve \
        --policy operating-point --programs cifar10 --budget-uj-s 400
    PYTHONPATH=src python -m repro_torch.launch.chip_serve \
        --video --programs cifar9_s1 --batch 8 --megakernel

``--traffic {poisson,bursty,diurnal}`` replays a seeded arrival trace in
real time instead of enqueueing everything up front; ``--rate`` sets the
arrival rate (frames/s), ``--slo-ms`` the per-lane latency SLO, and
``--policy continuous`` turns on the rolling admission window that
autoscales the batch against the measured rate.  ``--fleet N`` serves
through N replica hosts over disjoint groups of the local devices (on one
card they share it), ``--kill host0`` kills one mid-stream after
``--kill-after`` served frames, its frames migrating to the survivors and
a warm-started replacement coming up unless ``--no-replace``; ``--shard``
serves one replica over every local device, frames scattered::

    PYTHONPATH=src python -m repro_torch.launch.chip_serve \
        --traffic poisson --rate 200 --policy continuous --slo-ms 50 \
        --programs cifar9_s1 --requests 400 --batch 32 --megakernel
    PYTHONPATH=src python -m repro_torch.launch.chip_serve --fleet 2 \
        --programs mnist5,cifar9_s1 --requests 48 --batch 8 --kill host0

``--device cpu`` runs the plain PyTorch versions of the kernels instead.
``repro``'s ``--autotune`` and ``--donate`` are not taken.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.chip import energy, interpreter, networks
from repro_torch.distributed import sharding
from repro_torch.serving import temporal
from repro_torch.serving.cascade import CascadePipeline
from repro_torch.serving.fleet import FaultInjector, ServeFleet
from repro_torch.serving.server import ChipServer
from repro_torch.serving.traffic import make_trace, replay, video_trace


def build_params(program, seed: int, warm_bn: bool, device=None):
    """Latent params for a program from ``seed``: init, plus an optional
    one-batch BN warm so the folded thresholds are realistic."""
    dev = _device.resolve(device)
    gen = torch.Generator().manual_seed(seed)
    params = interpreter.init_params(gen, program, device=dev)
    if warm_bn:
        io = program.instrs[0]
        imgs = torch.randint(0, 2 ** io.bits,
                             (4, io.height, io.width, io.in_channels),
                             generator=gen, dtype=torch.int32)
        _, params = interpreter.forward_train(params, program, imgs.to(dev))
    return params


def build_artifact(program, seed: int, warm_bn: bool, device=None):
    """Packed deployment artifact for a program: :func:`build_params`,
    folded and bit-packed."""
    return interpreter.fold_params(
        build_params(program, seed, warm_bn, device), program, packed=True)


def frame_stream(program, n: int, seed: int) -> np.ndarray:
    """Deterministic synthetic int32 frames shaped for the program's IO
    layer, from a numpy generator seeded with ``seed``."""
    io = program.instrs[0]
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** io.bits,
                        (n, io.height, io.width, io.in_channels),
                        dtype=np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--programs", default="mnist5",
                    help="comma-separated names from networks.REGISTRY")
    ap.add_argument("--requests", type=int, default=24,
                    help="total frames across all programs")
    ap.add_argument("--batch", type=int, default=8, help="static batch size")
    ap.add_argument("--megakernel", action="store_true",
                    help="serve through the whole-network megakernel")
    ap.add_argument("--prefetch-depth", type=int, default=0,
                    help="pipeline submission to depth k with async host "
                         "result fetch (0 = synchronous)")
    ap.add_argument("--shared", action="store_true",
                    help="shared-array dispatch: programs whose S-modes "
                         "tile the 256-channel array exactly run as ONE "
                         "composite launch per batch")
    ap.add_argument("--cascade", action="store_true",
                    help="run the always-on cascade: the S=4 face "
                         "detector screens every frame, logit-margin "
                         "positives escalate to the S=1 owner recognizer")
    ap.add_argument("--margin", type=float, default=0.0,
                    help="cascade escalation threshold on the detector's "
                         "logit margin")
    ap.add_argument("--fused", action="store_true",
                    help="serve the cascade as ONE fused dispatch per "
                         "batch: escalation and recognizer on the device")
    ap.add_argument("--target-recall", type=float, default=None,
                    metavar="R",
                    help="calibrate the escalation margin on a held-out "
                         "split instead of using --margin: the cheapest "
                         "margin whose escalations capture R of the "
                         "positive frames (detector-labelled)")
    ap.add_argument("--policy",
                    choices=("static", "operating-point", "continuous"),
                    default="static",
                    help="dispatch policy: 'static' serves each lane with "
                         "its own program; 'operating-point' serves program "
                         "families (names in --programs may be "
                         "networks.FAMILIES entries) at the energy-accuracy "
                         "point the budget and backlog call for; "
                         "'continuous' adds the rolling admission window "
                         "that autoscales the batch against the measured "
                         "arrival rate and --slo-ms (over the "
                         "operating-point controller when families are "
                         "served)")
    ap.add_argument("--traffic", choices=("poisson", "bursty", "diurnal"),
                    default=None,
                    help="replay a seeded arrival trace in real time "
                         "instead of enqueueing all frames up front")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="traffic arrival rate in frames/s (all lanes)")
    ap.add_argument("--slo-ms", type=float, default=50.0,
                    help="per-lane input-to-label latency SLO for the "
                         "continuous policy's admission window")
    ap.add_argument("--shard", action="store_true",
                    help="serve over every local device (one artifact "
                         "replica a device, frames scattered)")
    ap.add_argument("--fleet", type=int, default=1,
                    help="serve through N replica hosts (disjoint groups "
                         "of the local devices, shared when fewer; frames "
                         "scatter in blocks of --batch)")
    ap.add_argument("--kill", default=None, metavar="REPLICA",
                    help="fault-inject: kill this replica (e.g. host0) "
                         "mid-stream; its frames migrate to survivors "
                         "(requires --fleet >= 2)")
    ap.add_argument("--kill-after", type=int, default=8,
                    help="fire the --kill injection once this many frames "
                         "have been served fleet-wide")
    ap.add_argument("--no-replace", action="store_true",
                    help="do not spawn a warm-started replacement for the "
                         "killed replica")
    ap.add_argument("--budget-uj-s", type=float, default=None,
                    help="operating-point controller energy budget: max "
                         "chip-model average power in uJ/s (uW); tight "
                         "budgets force downshifts to cheaper variants")
    ap.add_argument("--video", action="store_true",
                    help="serve a seeded video stream through the delta-"
                         "gated temporal pipeline: skip unchanged frames on "
                         "the device, answer them from the last-logits "
                         "cache (first --programs entry, or a family under "
                         "--policy operating-point; batch = streams)")
    ap.add_argument("--delta-threshold", type=float, default=1.0,
                    help="packed-Hamming gate: a stream recomputes when its "
                         "frame delta vs the resident last frame reaches "
                         "this many bits (1 = skip only bit-identical "
                         "frames; -inf = gate off)")
    ap.add_argument("--target-agreement", type=float, default=None,
                    metavar="A",
                    help="calibrate the gate threshold on a held-out video "
                         "trace: the cheapest threshold whose gated labels "
                         "agree with ungated inference on at least A of the "
                         "frames")
    ap.add_argument("--target-skip", type=float, default=None, metavar="S",
                    help="calibrate the gate threshold for energy: the "
                         "smallest threshold reaching skip ratio S on a "
                         "held-out video trace")
    ap.add_argument("--change-rate", type=float, default=0.25,
                    help="video trace: per-stream probability a frame "
                         "differs from the previous one")
    ap.add_argument("--scene-every", type=int, default=0,
                    help="video trace: full scene change every N frames "
                         "(0 = never)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.cascade:
        return run_cascade(args)

    names = [n.strip() for n in args.programs.split(",") if n.strip()]
    families = {}
    if args.policy in ("operating-point", "continuous"):
        # family names expand to their member variants behind one lane
        expanded = []
        for n in names:
            if n in networks.FAMILIES:
                families[n] = networks.FAMILIES[n]
                expanded.extend(networks.FAMILIES[n])
            else:
                expanded.append(n)
        names = expanded
    unknown = [n for n in names if n not in networks.REGISTRY]
    if unknown:
        ap.error(f"unknown programs {unknown}; have "
                 f"{sorted(networks.REGISTRY)} and families "
                 f"{sorted(networks.FAMILIES)}")
    if args.video:
        return run_video(args, names, families)
    dev = _device.resolve(args.device)

    programs = {n: networks.REGISTRY[n]() for n in names}
    print(f"folding deployment artifacts for {names} ...")
    artifacts = {n: build_artifact(p, args.seed + i, True, dev)
                 for i, (n, p) in enumerate(programs.items())}
    if args.fleet > 1:
        return run_fleet(args, dev, programs, artifacts, families)
    if args.kill:
        ap.error("--kill needs --fleet >= 2 (nowhere to migrate frames)")
    mesh = (sharding.serve_mesh(None if args.device is None else [dev])
            if args.shard else None)
    server = ChipServer(programs, artifacts, batch=args.batch,
                        megakernel=args.megakernel,
                        prefetch=args.prefetch_depth, device=dev, mesh=mesh,
                        shared=args.shared, policy=args.policy,
                        families=families or None,
                        budget_uj_s=args.budget_uj_s, slo_ms=args.slo_ms)
    print(f"resident programs: {names}  (batch={args.batch}, "
          f"device={dev}, devices={len(server.mesh)}, "
          f"S-modes={[programs[n].s for n in names]}, "
          f"megakernel={args.megakernel}, prefetch={args.prefetch_depth}, "
          f"shared={args.shared}, policy={args.policy})")
    for fam, members in families.items():
        pts = energy.operating_points({m: programs[m] for m in members},
                                      networks.ACCURACY)
        print(f"family {fam}: " + " > ".join(
            f"{p.name}[{p.uj_per_frame:.2f}uJ/f @{p.accuracy:.1%}]"
            for p in pts)
            + (f"  (budget {args.budget_uj_s:,.0f} uJ/s)"
               if args.budget_uj_s else "  (no budget)"))
    if args.shared:
        groups = server.shared_groups
        print("shared-array groups: "
              + (", ".join("+".join(g) for g in groups)
                 if groups else "none (S-modes do not tile the array)"))

    lanes = list(server.queue.lanes)
    per = lane_streams(args, programs, lanes, families)
    if args.traffic:
        # seeded arrival trace, replayed with real-time pacing: frames hit
        # the queue at their trace offsets and latency is measured against
        # the arrival process
        trace = make_trace(args.traffic, lanes, args.rate, args.requests,
                           seed=args.seed)
        print(f"replaying {args.traffic} trace: {len(trace)} frames at "
              f"{args.rate:,.0f} f/s mean over {len(lanes)} lane(s), "
              f"seed {args.seed}, SLO {args.slo_ms:.0f} ms "
              f"({trace.duration_s:.2f} s span)")
        results = replay(server, trace, per)
    else:
        idx = {lane: 0 for lane in lanes}
        for submitted in range(args.requests):
            lane = lanes[submitted % len(lanes)]
            server.submit(lane, per[lane][idx[lane]])
            idx[lane] += 1
        results = server.drain()
    server.close()
    stats = server.stats()

    counts = {lane: 0 for lane in lanes}
    for r in results:
        counts[r.program] += 1
    print(f"\nserved {len(results)} frames in {stats.dispatches} dispatches "
          f"({stats.host_wall_s*1e3:.0f} ms host)")
    for lane in lanes:
        members = server.families.get(lane, (lane,))
        uj = [stats.chip.reports[m].i2l_energy_per_inference * 1e6
              for m in members]
        print(f"  {lane:>14}: {counts[lane]:3d} served, "
              f"{stats.padded[lane]} padded slots, "
              + (f"{uj[0]:.2f} uJ/frame, S={programs[lane].s}"
                 if len(members) == 1 else
                 f"{min(uj):.2f}-{max(uj):.2f} uJ/frame across "
                 f"{len(members)} operating points"))
    if stats.policy == "operating-point":
        vd = {v: n for v, n in stats.variant_dispatches.items() if n}
        print(f"operating points    : {vd} "
              f"(downshift ratio {stats.downshift_ratio:.2f}, "
              f"energy {stats.energy_uj:,.0f} uJ"
              + (f" under budget {stats.budget_uj_s:,.0f} uJ/s)"
                 if stats.budget_uj_s else ", no budget)"))
    print(f"host throughput     : {stats.host_frames_per_s:,.0f} frames/s "
          f"on {dev}")
    if stats.p99_ms > 0.0:
        trace_recs = server.latency_trace()
        met = sum(1 for e in trace_recs
                  if e["latency_ms"] <= args.slo_ms) / max(1, len(trace_recs))
        print(f"input-to-label      : p50 {stats.p50_ms:.2f} / "
              f"p95 {stats.p95_ms:.2f} / p99 {stats.p99_ms:.2f} ms "
              f"({met:.1%} within the {args.slo_ms:.0f} ms SLO)")
    print(f"dispatch sizes      : {stats.dispatch_sizes} (size: dispatches)")
    print(f"billing             : {stats.billed} billed == "
          f"{stats.total_served} served + {sum(stats.padded.values())} "
          f"padded (padding ratio {stats.padding_ratio:.3f})")
    print(f"array utilization   : {stats.array_utilization:.2f} mean "
          f"occupied fraction over {stats.dispatches} dispatches "
          f"({stats.shared_dispatches} shared)")
    print(f"chip-model bill     : {stats.chip.uj_per_frame:.2f} uJ/frame, "
          f"{stats.chip.frames_per_s:,.0f} frames/s at Emin, "
          f"{stats.chip.power_w*1e3:.2f} mW avg "
          f"(paper: up to 1700 f/s, 0.9 mW I2L at S=4)")
    return results, stats


def lane_streams(args, programs, lanes, families):
    """Seeded synthetic frames for each lane (a family lane takes its
    first variant's geometry), enough for ``--requests`` over the lanes."""
    return {lane: frame_stream(programs[families.get(lane, (lane,))[0]],
                               -(-args.requests // len(lanes)),
                               args.seed + 100 + i)
            for i, lane in enumerate(lanes)}


def run_fleet(args, dev, programs, artifacts, families):
    """Serve through a :class:`~repro_torch.serving.ServeFleet`: N replica
    hosts over disjoint groups of the local devices (shared when fewer),
    optional mid-stream fault injection (``--kill host0``) with survivor
    migration and a warm-started replacement host."""
    injector = (FaultInjector(args.kill, after_served=args.kill_after)
                if args.kill else None)
    fleet = ServeFleet(programs, artifacts, replicas=args.fleet,
                       batch=args.batch,
                       devices=None if args.device is None else [dev],
                       injector=injector, replace=not args.no_replace,
                       megakernel=args.megakernel,
                       prefetch=args.prefetch_depth, shared=args.shared,
                       policy=args.policy, families=families or None,
                       budget_uj_s=args.budget_uj_s, slo_ms=args.slo_ms)
    ndev = len({d for ds in fleet._devices.values() for d in ds})
    print(f"serve fleet: {args.fleet} replicas over {ndev} device(s), "
          f"batch={args.batch}, policy={args.policy}"
          + (f", kill {args.kill} after {args.kill_after} frames "
             f"(replace={not args.no_replace})" if args.kill else ""))

    lanes = list(fleet.lanes)
    per = lane_streams(args, programs, lanes, families)
    if args.traffic:
        trace = make_trace(args.traffic, lanes, args.rate, args.requests,
                           seed=args.seed)
        print(f"replaying {args.traffic} trace: {len(trace)} frames at "
              f"{args.rate:,.0f} f/s over {len(lanes)} lane(s)")
        results = replay(fleet, trace, per)
    else:
        idx = {lane: 0 for lane in lanes}
        results = []
        for submitted in range(args.requests):
            lane = lanes[submitted % len(lanes)]
            fleet.submit(lane, per[lane][idx[lane]])
            idx[lane] += 1
            if submitted % args.batch == args.batch - 1:
                # interleave serving so a --kill lands mid-stream
                results.extend(fleet.step())
        results = sorted(results + fleet.drain(), key=lambda r: r.rid)
    fleet.close()

    st = fleet.stats()
    print(f"\nfleet served {st.total_served} frames in {st.dispatches} "
          f"dispatches across {len(st.replicas)} replica(s)")
    for name, rs in sorted(st.replicas.items()):
        mark = " (FAILED)" if name in st.failed_replicas else ""
        print(f"  {name:>10}{mark}: {sum(rs.served.values()):3d} served, "
              f"{sum(rs.padded.values())} padded, "
              f"{rs.dispatches} dispatches")
    if st.failed_replicas:
        print(f"failover            : {st.migrated_frames} frames migrated "
              f"(+{st.refired_frames} refired), recovery "
              + (f"{st.recovery_ms:.1f} ms" if st.recovery_ms is not None
                 else "n/a (replacement served no frames)"))
    print(f"billing             : {st.billed} billed == "
          f"{st.total_served} served + {sum(st.padded.values())} padded "
          f"(padding ratio {st.padding_ratio:.3f})")
    if st.p99_ms > 0.0:
        print(f"input-to-label      : p50 {st.p50_ms:.2f} / "
              f"p95 {st.p95_ms:.2f} / p99 {st.p99_ms:.2f} ms (merged)")
    print(f"host throughput     : {st.host_frames_per_s:,.0f} frames/s on "
          f"{dev}")
    print(f"chip-model bill     : {st.chip.uj_per_frame:.2f} uJ/frame, "
          f"{st.chip.frames_per_s:,.0f} frames/s ({len(st.replicas)} "
          f"chips in parallel), {st.chip.power_w*1e3:.2f} mW total")
    ws = st.warm_start
    print(f"warm-start cache    : {ws['hits']} hits / {ws['misses']} "
          f"misses, {ws['build_s']*1e3:.0f} ms building")
    return results, st


def run_video(args, names, families):
    """Always-on video through the delta-gated temporal pipeline: one
    camera stream per batch slot over a seeded content trace
    (``traffic.video_trace``), the gate on the device against each
    stream's resident last frame, skipped frames answered from the
    last-logits cache and billed at delta-compute-only cost.

    The lane is the first ``--programs`` entry, or its family under
    ``--policy operating-point``.  ``--target-agreement`` /
    ``--target-skip`` calibrate the threshold on a held-out trace of
    another seed instead of taking ``--delta-threshold`` verbatim.
    """
    if args.target_agreement is not None and args.target_skip is not None:
        raise SystemExit("--target-agreement and --target-skip are "
                         "mutually exclusive")
    dev = _device.resolve(args.device)
    lane = next(iter(families)) if families else names[0]
    members = families.get(lane, (lane,))
    programs = {n: networks.REGISTRY[n]() for n in members}
    program = programs[members[0]]
    io = program.instrs[0]
    print(f"folding deployment artifacts for {list(members)} ...")
    artifacts = {n: build_artifact(p, args.seed + i, True, dev)
                 for i, (n, p) in enumerate(programs.items())}
    server = ChipServer(programs, artifacts, batch=args.batch,
                        megakernel=args.megakernel, device=dev,
                        policy=args.policy,
                        families={lane: members} if families else None,
                        budget_uj_s=args.budget_uj_s)
    # fine-grained drain chunks: recompute work scales with the changed
    # count instead of rounding every dispatch up to a full batch
    pipe = temporal.TemporalPipeline(server, lane,
                                     threshold=args.delta_threshold,
                                     rb=max(1, args.batch // 4))
    steps = -(-args.requests // args.batch)
    shape = (io.height, io.width, io.in_channels)
    if args.target_agreement is not None or args.target_skip is not None:
        cal = video_trace(shape, max(steps, 8), streams=args.batch,
                          seed=args.seed + 200,
                          change_rate=args.change_rate,
                          scene_change_every=args.scene_every,
                          levels=2 ** io.bits)
        if args.target_agreement is not None:
            thr = pipe.calibrate(cal.frames, args.target_agreement)
            print(f"calibrated threshold: {thr:.0f} bits (target "
                  f"agreement {args.target_agreement:.2f} on "
                  f"{len(cal) * cal.streams} held-out frames)")
        else:
            thr = temporal.threshold_for_skip(cal.frames, args.target_skip,
                                              program=program)
            pipe.threshold = thr
            print(f"calibrated threshold: {thr:.0f} bits (target skip "
                  f"{args.target_skip:.2f} on {len(cal) * cal.streams} "
                  f"held-out frames)")
    trace = video_trace(shape, steps, streams=args.batch,
                        seed=args.seed + 100, change_rate=args.change_rate,
                        scene_change_every=args.scene_every,
                        levels=2 ** io.bits)
    print(f"video stream        : {args.batch} streams x {steps} frames "
          f"(change rate {args.change_rate:.2f}, "
          f"{trace.change_ratio:.2f} actually changed, seed "
          f"{args.seed + 100}), gate >= {pipe.threshold:.0f} bits, "
          f"lane {lane} on {dev}")
    for t in range(len(trace)):
        pipe.submit_many(trace.frames[t])
    results = pipe.drain()
    server.close()
    rep = pipe.report()
    stats = server.stats()
    print(f"\ntemporal served {len(results)} frames in "
          f"{pipe.gated_dispatches} gated dispatches: {rep.computed} "
          f"computed (+{rep.computed_padded} drain padding), "
          f"{rep.skipped} skipped (skip ratio {rep.skip_ratio:.2f})")
    if families:
        vd = {v: n for v, n in stats.variant_dispatches.items() if n}
        print(f"operating points    : {vd} (downshift ratio "
              f"{stats.downshift_ratio:.2f}, final activity "
              f"{pipe.activity:.2f})")
    print(f"billing             : {stats.billed} billed == "
          f"{stats.total_served} computed + {sum(stats.padded.values())} "
          f"drain padding")
    print(f"host throughput     : {len(results) / stats.host_wall_s:,.0f} "
          f"frames/s on {dev}")
    print(f"temporal bill       : {rep.uj_per_frame:.3f} uJ/frame "
          f"({rep.delta_uj:.3f} delta toll on every frame) vs "
          f"{rep.uj_per_frame_ungated:.3f} ungated "
          f"({rep.savings:.2f}x saved)")
    return results, rep


def run_cascade(args):
    """The paper's always-on hierarchy: the S=4 face detector on every
    frame, logit-margin positives escalate to the S=1 owner recognizer.

    ``--fused`` serves it as one fused cascade dispatch per batch;
    ``--target-recall R`` calibrates the margin on a held-out split (the
    detector's own positives as the recall ground truth) instead of taking
    ``--margin`` verbatim.
    """
    dev = _device.resolve(args.device)
    det_name, rec_name = "face_detector", "owner_detector"
    programs = {det_name: networks.face_detector(),
                rec_name: networks.owner_detector()}
    print(f"folding deployment artifacts for cascade "
          f"{det_name} -> {rec_name} ...")
    artifacts = {n: build_artifact(p, args.seed + i, True, dev)
                 for i, (n, p) in enumerate(programs.items())}
    server = ChipServer(programs, artifacts, batch=args.batch,
                        megakernel=args.megakernel,
                        prefetch=args.prefetch_depth, device=dev)
    casc = CascadePipeline(server, det_name, rec_name, positive_class=1,
                           margin=args.margin, fused=args.fused)
    if args.target_recall is not None:
        # held-out calibration split (a seed disjoint from the served
        # stream); the detector's own positives are the ground truth
        cal = frame_stream(programs[det_name], max(args.requests, 32),
                           args.seed + 200)
        _, cal_labels = interpreter.compile_plan(programs[det_name]).forward(
            artifacts[det_name], cal, device=dev)
        margin = casc.calibrate(cal, cal_labels.cpu().numpy() == 1,
                                args.target_recall)
        print(f"calibrated margin   : {margin:+.1f} (target recall "
              f"{args.target_recall:.2f} on {len(cal)} held-out frames)")
    frames = frame_stream(programs[det_name], args.requests, args.seed + 100)
    casc.submit_many(frames)
    results = casc.drain()
    server.close()
    rep = casc.report()
    stats = server.stats()
    mode = ("fused escalation on the device, "
            f"{casc.fused_dispatches} dispatches" if args.fused
            else "host-side escalation")
    print(f"\ncascade served {len(results)} frames "
          f"({rep.escalated} escalated, rate {rep.escalation_rate:.2f}, "
          f"margin >= {casc.margin:+.1f}, {mode}) on {dev}")
    print(f"detector stage      : {rep.detector_uj:.2f} uJ/frame x "
          f"{rep.frames} frames (+{stats.padded[det_name]} padded)")
    print(f"recognizer stage    : {rep.recognizer_uj:.2f} uJ/frame x "
          f"{rep.escalated} frames (+{stats.padded[rec_name]} padded)")
    print(f"billing             : {stats.billed} billed == "
          f"{stats.total_served} served + {sum(stats.padded.values())} "
          f"padded")
    print(f"cascade bill        : {rep.uj_per_frame:.2f} uJ/frame vs "
          f"{rep.uj_per_frame_recognizer_only:.2f} recognizer-on-every-"
          f"frame ({rep.savings:.2f}x saved; paper: 0.92 -> 14.4 uJ/f)")
    return results, rep


if __name__ == "__main__":
    main()
