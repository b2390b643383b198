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

``--device cpu`` runs the plain PyTorch versions of the kernels instead.
The shared-array, operating-point, cascade, video, traffic and fleet
modes of ``repro``'s driver are not ported yet.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.chip import interpreter, networks
from repro_torch.serving.server import ChipServer


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    names = [n.strip() for n in args.programs.split(",") if n.strip()]
    unknown = [n for n in names if n not in networks.REGISTRY]
    if unknown:
        ap.error(f"unknown programs {unknown}; have "
                 f"{sorted(networks.REGISTRY)}")
    dev = _device.resolve(args.device)

    programs = {n: networks.REGISTRY[n]() for n in names}
    print(f"folding deployment artifacts for {names} ...")
    artifacts = {n: build_artifact(p, args.seed + i, True, dev)
                 for i, (n, p) in enumerate(programs.items())}
    server = ChipServer(programs, artifacts, batch=args.batch,
                        megakernel=args.megakernel,
                        prefetch=args.prefetch_depth, device=dev)
    print(f"resident programs: {names}  (batch={args.batch}, "
          f"device={dev}, S-modes={[programs[n].s for n in names]}, "
          f"megakernel={args.megakernel}, prefetch={args.prefetch_depth}, "
          f"policy=static)")

    lanes = list(server.queue.lanes)
    per = {lane: frame_stream(programs[lane], -(-args.requests // len(lanes)),
                              args.seed + 100 + i)
           for i, lane in enumerate(lanes)}
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
        uj = stats.chip.reports[lane].i2l_energy_per_inference * 1e6
        print(f"  {lane:>14}: {counts[lane]:3d} served, "
              f"{stats.padded[lane]} padded slots, "
              f"{uj:.2f} uJ/frame, S={programs[lane].s}")
    print(f"host throughput     : {stats.host_frames_per_s:,.0f} frames/s "
          f"on {dev}")
    print(f"billing             : {stats.billed} billed == "
          f"{stats.total_served} served + {sum(stats.padded.values())} "
          f"padded (padding ratio {stats.padding_ratio:.3f})")
    print(f"array utilization   : {stats.array_utilization:.2f} mean "
          f"occupied fraction over {stats.dispatches} dispatches")
    print(f"chip-model bill     : {stats.chip.uj_per_frame:.2f} uJ/frame, "
          f"{stats.chip.frames_per_s:,.0f} frames/s at Emin, "
          f"{stats.chip.power_w*1e3:.2f} mW avg "
          f"(paper: up to 1700 f/s, 0.9 mW I2L at S=4)")
    return results, stats


if __name__ == "__main__":
    main()
