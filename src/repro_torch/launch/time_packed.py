"""Device time of the packed binary kernels (rows 2, 3 and 9 of the kernel
table) at the shapes the main paths launch them.

Times ``xnor_matmul`` (int32 sums) at cifar9_s1's last FC layer (M=8,
K=1024, N=10) and at BitLinear's SmolLM-360M MLP up-projection (M=256
tokens, K=960, N=2560), ``xnor_matmul(pack_out=True)`` at mnist5's hidden
layer (M=8, K=256, N=64), the same layer at the serve batch (M=256) and at
BitLinear's shape (where the work, not the launch, sets the time), and
``binarize_pack`` at BitLinear's input
(256, 960), cifar9_s1's layer-2 activations at batch 8 (7688, 256) and an
odd shape (300, 100).  Each by ``torch.profiler`` device time a call, with
CUDA events over back-to-back calls and over a CUDA graph of 50 calls
(device time with no host gaps, a check on the profiler's) beside it
(the timers of ``launch/timing.py``; run as a script, this file takes the
``timing.py`` beside it where the tree on ``PYTHONPATH`` has none).
Beside each ``xnor_matmul`` shape: a bf16 ``torch.matmul`` of the same
+/-1 values, and ``fill_`` of an int32 tensor of the output's shape (the
same bytes written by a plain store kernel); and, where the tree's
``csrc/mma_rate.cu`` has it, an empty kernel (the launch floor).  Inputs
are random from a fixed seed, L2 warm.  It prints each time with the
card's name and power limit as ``nvidia-smi`` gives them, then one JSON
line.  It calls only the two wrappers, so the same file times any tree of
the port: put that tree's ``src`` first on ``PYTHONPATH``, and alternate
trees in one chip call to compare them on one card::

    PYTHONPATH=src python3 src/repro_torch/launch/time_packed.py

``--sweep`` (this tree only) instead times the int32 variant at each
``XNOR`` shape and the packed one at each ``XNOR_PACK`` shape over every
tile geometry that fits (warps along M, n8 tiles a warp, K steps a chunk;
``xnor_matmul.make_tiles``), the wrapper's own choice (``xnor_tiles``)
marked.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.core.binarize import unpack_signs
from repro_torch.kernels import binarize_pack as bp
from repro_torch.kernels import xnor_matmul as xm

try:
    from repro_torch.launch.timing import device_ms, events_ms, graph_ms
except ImportError:     # another tree first on PYTHONPATH: this file's own
    from timing import device_ms, events_ms, graph_ms

ITERS, SEED = 200, 0
# (label, M, K, N): the int32 variant's main-path shapes, then the packed one
XNOR = (("cifar9_s1 final", 8, 1024, 10), ("BitLinear", 256, 960, 2560))
XNOR_PACK = (("mnist5 hidden", 8, 256, 64),
             ("mnist5 hidden, serve batch", 256, 256, 64),
             ("BitLinear's shape", 256, 960, 2560))
# (label, M, K)
PACK = (("BitLinear input", 256, 960), ("cifar9_s1 layer 2", 8 * 31 * 31, 256),
        ("odd", 300, 100))


def floor_ms():
    """Device ms of csrc/mma_rate.cu's empty kernel, or None where the
    tree has none."""
    import ctypes

    from repro_torch.kernels import _build
    lib = _build.library("mma_rate")
    if not hasattr(lib, "empty_launch"):
        return None
    fn = lib.empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(stream):
            raise RuntimeError("empty_launch failed")
    return device_ms(launch, ITERS, "empty_kernel")


def sweep(words, smi: str) -> dict:
    """A call's ms in a CUDA graph of the int32 variant at each XNOR shape
    and of the packed one at each XNOR_PACK shape, by tile geometry."""
    report = {"card": smi}
    for label, m, k, n, pack in ([x + (False,) for x in XNOR]
                                 + [x + (True,) for x in XNOR_PACK]):
        kw = -(-k // 32)
        a, w = words(m, kw), words(n, kw)
        chosen = xm.xnor_tiles(m, n, kw, torch.cuda.get_device_properties(
            a.device).multi_processor_count, pack)
        times = []
        for wm in (1, 2, 4, 8):
            if 16 * (wm - 1) >= m:
                break
            for tn in xm.PACK_WARP_TILES if pack else xm.WARP_TILES:
                for kchunk in (1, 2, 4):
                    t = xm.make_tiles(m, n, kw, wm, tn, kchunk)
                    if t.smem > xm.SMEM_DEFAULT or t in (g for _, g in times):
                        continue
                    ms = graph_ms(lambda: xm.xnor_matmul(
                        a, w, k, pack_out=pack, tiles=t))
                    times.append((ms, t))
        times.sort(key=lambda x: x[0])
        label = f"{label}{' packed' if pack else ''}"
        report[f"{label} M={m} K={k} N={n}"] = [
            dict(ms=ms, bm=t.bm, bn=t.bn, tn=t.tn, kchunk=t.kchunk,
                 blocks=t.grid[0] * t.grid[1],
                 chosen=t == chosen)
            for ms, t in times]
        for ms, t in times:
            print(f"{label} M={m} K={k} N={n}: {ms:.5f} ms, {t.bm} x {t.bn} "
                  f"(m16 x n{8 * t.tn} a warp), {t.grid[0] * t.grid[1]} "
                  f"blocks, {t.nchunks} chunks of {t.kchunk} steps"
                  + (" <- xnor_tiles" if t == chosen else "") + f" [{smi}]")
    print(json.dumps(report))
    return report


def main() -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweep", action="store_true",
                        help="time both variants over tile geometries")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_packed needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32).to(dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.splitlines()[0]
    if args.sweep:
        return sweep(words, smi)
    report = {"card": smi, "xnor_matmul": {}, "xnor_matmul_pack": {},
              "binarize_pack": {}, "launch_floor_ms": floor_ms()}
    print(f"launch floor (empty kernel): {report['launch_floor_ms']} ms "
          f"device [{smi}]")
    for key, shapes, pack in (("xnor_matmul", XNOR, False),
                              ("xnor_matmul_pack", XNOR_PACK, True)):
        for label, m, k, n in shapes:
            a, w = words(m, -(-k // 32)), words(n, -(-k // 32))
            ab = unpack_signs(a, k).to(torch.bfloat16)      # same bits, +/-1
            wb = unpack_signs(w, k).t().contiguous().to(torch.bfloat16)

            def kernel():
                return xm.xnor_matmul(a, w, k, pack_out=pack)

            def library():
                return torch.matmul(ab, wb)
            out = torch.empty((m, n // 32 if pack else n), dtype=torch.int32,
                              device=dev)
            got = report[key][f"{label} M={m} K={k} N={n}"] = dict(
                ms=device_ms(kernel, ITERS, "xnor"),
                events_ms=events_ms(kernel, ITERS),
                graph_ms=graph_ms(kernel),
                matmul_bf16_ms=device_ms(library, ITERS),
                matmul_bf16_events_ms=events_ms(library, ITERS),
                fill_ms=device_ms(lambda: out.fill_(1), ITERS))
            print(f"{key} {label} M={m} K={k} N={n}: {got['ms']} ms device, "
                  f"{got['events_ms']:.4f} ms events, {got['graph_ms']} ms a "
                  f"call in a CUDA graph; bf16 matmul "
                  f"{got['matmul_bf16_ms']} ms device, "
                  f"{got['matmul_bf16_events_ms']:.4f} ms events; fill_ of "
                  f"the output {got['fill_ms']} ms device [{smi}]")
    for label, m, k in PACK:
        x = torch.randn((m, k), generator=gen).to(dev)

        def kernel():
            return bp.binarize_pack(x)
        got = report["binarize_pack"][f"{label} M={m} K={k}"] = dict(
            ms=device_ms(kernel, ITERS, "binarize_pack"),
            events_ms=events_ms(kernel, ITERS), graph_ms=graph_ms(kernel))
        print(f"binarize_pack {label} M={m} K={k}: {got['ms']} ms device, "
              f"{got['events_ms']:.4f} ms events, {got['graph_ms']} ms a "
              f"call in a CUDA graph [{smi}]")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
