"""Device time of the two packed 2x2 conv kernels at cifar9_s1's shapes.

Times the fused layer (``binary_conv2x2_block``) on cifar9_s1's eight
convs and the unfused conv (``binary_conv2x2``) on its first layer, at
batch 8 on random words from a fixed seed, by ``torch.profiler`` device
time a call, and prints them with the card's name and power limit as
``nvidia-smi`` gives them, then one JSON line.  It calls only the two
wrappers, so the same file times any tree of the port: put that tree's
``src`` first on ``PYTHONPATH``, and alternate trees in one process list
to compare them on one card::

    PYTHONPATH=src python3 src/repro_torch/launch/time_convs.py
"""

from __future__ import annotations

import json
import subprocess

import torch

from repro_torch.core.chip import interpreter, networks
from repro_torch.kernels import binary_conv2x2 as bc
from repro_torch.kernels import binary_conv2x2_block as bcb

try:
    from repro_torch.launch.timing import device_ms
except ImportError:     # another tree first on PYTHONPATH: this file's own
    from timing import device_ms

BATCH, ITERS, SEED = 8, 50, 0


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("time_convs needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32).to(dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.splitlines()[0]
    layers = []
    for _, h, w, c, f, pool in (st for st in interpreter.compile_plan(
            networks.REGISTRY["cifar9_s1"]()).mega if st[0] == "conv"):
        tau = torch.randint(-4 * c, 4 * c + 1, (f,), generator=gen,
                            dtype=torch.int32).to(dev)
        flip = torch.randint(0, 2, (f,), generator=gen,
                             dtype=torch.int32).to(dev)
        layers.append((words(BATCH, h, w, c // 32), words(f, 4, c // 32), tau,
                       flip, c, pool))
    report = {"card": smi, "conv_block_layers_ms": []}
    for a, wt, tau, flip, c, pool in layers:
        report["conv_block_layers_ms"].append(device_ms(
            lambda: bcb.binary_conv2x2_block(a, wt, tau, flip, c=c,
                                             pool=pool),
            ITERS, "conv_block"))
    report["conv_block_ms"] = device_ms(
        lambda: [bcb.binary_conv2x2_block(a, wt, tau, flip, c=c, pool=pool)
                 for a, wt, tau, flip, c, pool in layers],
        ITERS, "conv_block")
    a, wt, _, _, c, _ = layers[0]
    report["binary_conv2x2_ms"] = device_ms(
        lambda: bc.binary_conv2x2(a, wt, c=c), ITERS, "binary_conv2x2")
    print(f"conv_block, cifar9_s1's 8 convs at B={BATCH}: "
          f"{report['conv_block_ms']} ms a call; binary_conv2x2, layer 1: "
          f"{report['binary_conv2x2_ms']} ms a call (torch.profiler device "
          f"time) [{smi}]")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
