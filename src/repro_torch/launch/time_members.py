"""Device time of the whole-network kernels (rows 4-7 of the kernel table).

Times, by CUDA events around a CUDA graph of 50 calls (``launch/timing.py``
``graph_ms``: device time with no host gap, which does not drift), with
``torch.profiler`` device time a call (every CUDA kernel the call
launches) beside it under ``profiler_ms``, the solo megakernel on cifar9_s1 at batches 8, 66, 132
and 256, and at the serves' batches 8 and 256 the 4 x S=4 composite (B a
member), the face -> owner cascade with every frame escalated (and, where
the tree's wrapper takes ``det_cluster``, with the detector at clusters
of 2 and of 8, at batch 16 too), and the delta gate on cifar9_s1 from a
warm state with every stream changed (E = B) and none (E = 0).
Weights and frames are random from fixed seeds.  It prints each time with
the card's name and power limit as ``nvidia-smi`` gives them, then one
JSON line.  It calls only the public wrappers, so the same file times any
tree of the port (run as a script, it takes the ``timing.py`` beside it
where the tree on ``PYTHONPATH`` has none): put that tree's ``src`` first on ``PYTHONPATH``, and
alternate trees in one chip call to compare them on one card::

    PYTHONPATH=src python3 src/repro_torch/launch/time_members.py

``--clocks`` instead splits each block of the cluster member body
(``csrc/member_clocks.cu``, one cluster a frame) into the staging, the
thermometer pack, each conv layer and the FC tail by ``clock64`` and
``%globaltimer`` deltas, and holds the slowest block's total against the
probe call's device time; it also times one dependent chain of each
integer MMA (``csrc/mma_rate.cu``).
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import subprocess

import torch

from repro_torch.core.binarize import thermometer_pack
from repro_torch.core.chip import interpreter, networks
from repro_torch.kernels import megakernel as mk
from repro_torch.launch.chip_serve import frame_stream

try:
    from repro_torch.launch.timing import device_ms, graph_ms
except ImportError:     # another tree first on PYTHONPATH: this file's own
    from timing import device_ms, graph_ms

ITERS, SEED = 20, 0
MEGA_BATCHES = (8, 66, 132, 256)
BATCHES = (8, 256)              # the serves' batches
QUAD = ("cifar9_s4", "cifar9_s4t", "mnist5", "face_detector")
CASCADE = ("face_detector", "owner_detector")


def both(fn) -> tuple:
    """(ms a call from a CUDA graph of 50 calls, torch.profiler device ms
    a call beside it)."""
    return graph_ms(fn), device_ms(fn, ITERS)


def random_image(prog, gen):
    """A weight image from init_params with spread-out BN statistics, so
    thresholds and both comparator directions occur."""
    params = interpreter.init_params(gen, prog, device="cpu")
    for p in params["conv"]:
        f = p["gamma"].shape[0]
        p["gamma"] = torch.randn(f, generator=gen)
        p["beta"] = torch.randn(f, generator=gen) * 4
        p["mean"] = torch.randn(f, generator=gen) * 16
        p["var"] = torch.rand(f, generator=gen) * 100 + 1
    return interpreter.fold_params(params, prog, image=True)


def frames_of(prog, b: int, seed: int, dev) -> torch.Tensor:
    return torch.from_numpy(frame_stream(prog, b, seed)).to(dev)


def mma_latency(smi: str) -> dict:
    """SM clocks a dependent mma.sync takes, .b1 m16n8k256 and .s8
    m16n8k32 (csrc/mma_rate.cu mma_latency_launch: one warp, one chain)."""
    from repro_torch.kernels import _build
    fn = _build.library("mma_rate").mma_latency_launch
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    clk = torch.zeros(1, dtype=torch.int64, device="cuda")
    iters, report = 4096, {}
    for binary, label in ((1, "m16n8k256 .b1"), (0, "m16n8k32 .s8")):
        for _ in range(2):                 # the second run is warm
            if fn(binary, iters, sink.data_ptr(), clk.data_ptr(),
                  torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("mma_latency launch failed")
            torch.cuda.synchronize()
        report[label] = int(clk.item()) / iters
    print("dependent mma.sync latency: " + ", ".join(
        f"{k} {v:.1f} cycles" for k, v in report.items()) + f" [{smi}]")
    return report


def clocks(prog, image, frames, smi: str) -> dict:
    """Run member_clocks.cu's cluster probe on ``frames`` and report each
    phase's mean over the blocks, the slowest block's total and the call's
    device time."""
    from repro_torch.kernels import _build
    spec = mk.solo_member_spec(interpreter.compile_plan(prog).mega)
    geo = mk.cluster_geometry(spec)
    convs = [f"conv {i}" for i in range(
        sum(1 for st in spec[0] if st[0] == "conv"))]
    names = (["staging", "pack"]
             + [f"{c} {part}" for c in convs
                for part in ("taps issue", "tiles", "taps wait", "barrier")]
             + ["fc"])
    ints = ctypes.POINTER(ctypes.c_int)
    fn = _build.library("member_clocks").cluster_clocks_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ints, ctypes.c_int, ints] + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cw, ct, cf, fw = (image[k].contiguous() for k in ("cw", "ct", "cf", "fw"))
    table = mk.composite_table(spec, tuple(cw.shape), tuple(fw.shape))
    b = frames.shape[0]
    blocks = b * geo.cluster
    out = torch.empty((b, spec[0][-1][2]), dtype=torch.int32,
                      device=frames.device)
    clk = torch.zeros((blocks, 4 * mk.MAX_LAYERS + 3), dtype=torch.int64,
                      device=frames.device)
    ns = torch.zeros_like(clk)
    thr = mk._member_thresholds(spec[0], frames.device)

    def launch():
        err = fn(frames.data_ptr(), thr.data_ptr(), cw.data_ptr(),
                 ct.data_ptr(), cf.data_ptr(), fw.data_ptr(), out.data_ptr(),
                 clk.data_ptr(), ns.data_ptr(),
                 (ctypes.c_int * len(table))(*table), len(table),
                 (ctypes.c_int * len(geo.args))(*geo.args), len(geo.args), b,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"clock probe launch failed: CUDA error {err}")

    call_ms = device_ms(launch, ITERS)
    launch()
    torch.cuda.synchronize()
    want = mk.composite_plain(image, (frames,), spec=spec)[0]
    if not torch.equal(out, want):
        raise AssertionError("the clock probe's logits differ from the "
                             "plain version")
    clk, ns = clk[:, :len(names)].cpu(), ns[:, :len(names)].cpu()
    if (clk <= 0).any() or (ns < 0).any():
        raise AssertionError(f"non-positive clock deltas: {clk.tolist()}")
    mean_us = (ns.double().mean(0) / 1e3).tolist()
    mean_clk = clk.double().mean(0).tolist()
    total_us = float(ns.sum(1).max()) / 1e3
    what = f"one cluster of {geo.cluster} a frame"
    print(f"clock split, {what}, B={b}, mean over {blocks} blocks: "
          + ", ".join(f"{n} {u:.2f} us ({c:,.0f} cycles)"
                      for n, u, c in zip(names, mean_us, mean_clk)))
    print(f"  slowest block {total_us:.2f} us by %globaltimer, the call "
          f"{call_ms * 1e3 if call_ms else float('nan'):.2f} us of device "
          f"time (torch.profiler); SM clock implied by the slowest block "
          f"{float(clk.sum(1).max()) / max(total_us, 1e-9):.1f} MHz [{smi}]")
    return {"card": smi, "body": what, "batch": b, "call_device_ms": call_ms,
            "slowest_block_us": total_us,
            "phases": {n: {"us": u, "cycles": c}
                       for n, u, c in zip(names, mean_us, mean_clk)}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clocks", action="store_true",
                    help="split the cluster member body by clock64")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_members needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.splitlines()[0]
    progs = {n: networks.REGISTRY[n]() for n in networks.REGISTRY}
    cifar = progs["cifar9_s1"]
    image = {k: v.to(dev) for k, v in random_image(cifar, gen).items()}
    if args.clocks:
        report = {"mma_latency_cycles": mma_latency(smi),
                  "clocks": [clocks(cifar, image, frames_of(cifar, b, 7, dev),
                                    smi) for b in (8, 132)]}
        print(json.dumps(report))
        return report

    report = {"card": smi, "megakernel_ms": {}, "profiler_ms": {}}
    prof = report["profiler_ms"]

    def put(key, fn):
        report[key], prof[key] = both(fn)

    mega = interpreter.compile_plan(cifar).mega
    for b in MEGA_BATCHES:
        frames = frames_of(cifar, b, 7, dev)
        report["megakernel_ms"][b], prof[f"megakernel_b{b}"] = both(
            lambda: mk.megakernel_forward(image, frames, spec=mega))

    images = {n: random_image(p, gen) for n, p in progs.items()}
    cplan, cimage = interpreter.pack_programs(
        {n: progs[n] for n in QUAD}, {n: images[n] for n in QUAD})
    cimage = {k: v.to(dev) for k, v in cimage.items()}
    kplan, kimage = interpreter.pack_cascade(
        {n: progs[n] for n in CASCADE}, {n: images[n] for n in CASCADE},
        detector=CASCADE[0], recognizer=CASCADE[1])
    kimage = {k: v.to(dev) for k, v in kimage.items()}
    dplan, dimage = interpreter.pack_delta(cifar, images["cifar9_s1"])
    dimage = {k: v.to(dev) for k, v in dimage.items()}
    io = cifar.instrs[0]
    levels = 2 ** io.bits
    for b in BATCHES:
        frames = tuple(frames_of(progs[n], b, 600 + i, dev)
                       for i, n in enumerate(QUAD))
        put(f"composite_ms_b{b}",
            lambda: mk.composite_forward(cimage, frames, spec=cplan.spec))
        frames = frames_of(progs[CASCADE[0]], b, 700, dev)
        ctrl = kplan.margin_ctrl(float("-inf"), b).to(dev)
        put(f"cascade_ms_b{b}",
            lambda: mk.cascade_forward(kimage, frames, ctrl,
                                       spec=kplan.spec))
        # a warm state: lane i's last frame differs in a corner patch
        frames = frames_of(cifar, b, 1100, dev)
        prev = frames.clone()
        for i in range(b):
            k = i % 32 + 1
            prev[i, :k, :k] = (prev[i, :k, :k] + levels // 2) % levels
        last = thermometer_pack(prev, io.bits, io.in_channels, io.channels)
        llog = torch.zeros((b, dplan.classes), dtype=torch.int32, device=dev)
        for e, thr in (("all", float("-inf")), ("0", float("inf"))):
            ctrl = dplan.delta_ctrl(thr, b).to(dev)
            put(f"delta_e{e}_ms_b{b}",
                lambda: mk.delta_forward(dimage, frames, last, llog, ctrl,
                                         spec=dplan.spec))
    if "det_cluster" in inspect.signature(mk.cascade_forward).parameters:
        for b in (8, 16, 256):
            frames = frames_of(progs[CASCADE[0]], b, 700, dev)
            ctrl = kplan.margin_ctrl(float("-inf"), b).to(dev)
            for n in (2, 8):
                put(f"cascade_det{n}_ms_b{b}",
                    lambda: mk.cascade_forward(kimage, frames, ctrl,
                                               spec=kplan.spec,
                                               det_cluster=n))
        print("cascade, the detector at clusters of 2 / 8: " + ", ".join(
            f"B={b} {report[f'cascade_det2_ms_b{b}']} / "
            f"{report[f'cascade_det8_ms_b{b}']} ms" for b in (8, 16, 256))
            + f" (a call in a CUDA graph) [{smi}]")
    print("megakernel cifar9_s1: " + ", ".join(
        f"B={b} {ms} ms" for b, ms in report["megakernel_ms"].items())
        + "; " + ", ".join(f"{k[:-3]} {v} ms" for k, v in report.items()
                           if k.endswith(tuple(f"_b{b}" for b in BATCHES)))
        + f" (a call in a CUDA graph; composite: "
        f"{'+'.join(QUAD)}, B a member; cascade: "
        f"{'->'.join(CASCADE)}, all escalated; delta: cifar9_s1, every "
        f"stream changed or none) [{smi}]")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
