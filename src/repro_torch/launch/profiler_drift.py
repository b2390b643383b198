"""Does ``torch.profiler``'s device time hold over one process's life?

Times the solo megakernel on cifar9_s1 at batch 8 and 256 two ways: by
``torch.profiler`` device time a call (as ``chip_smoke.py`` phase 7 and
the ``time_*.py`` scripts do) and by CUDA events (around a CUDA graph of
50 launches at batch 8, so no host gap counts; around 20 back-to-back
calls at batch 256, which the device bounds).  It does so fresh, then
after each of three rounds of 3 s of dense float32 matmul and 10 s idle,
and prints every pair with the card's name and power limit as
``nvidia-smi`` gives them, then one JSON line.  Weights and frames are
random from fixed seeds::

    PYTHONPATH=src python3 src/repro_torch/launch/profiler_drift.py
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from repro_torch.core.chip import interpreter, networks
from repro_torch.kernels import megakernel as mk
from repro_torch.launch.time_members import frames_of, random_image
from repro_torch.launch.timing import device_ms, events_ms, graph_ms

ROUNDS, BURST_S, IDLE_S, SEED = 3, 3.0, 10.0, 0


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profiler_drift needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.splitlines()[0]
    cifar = networks.REGISTRY["cifar9_s1"]()
    gen = torch.Generator().manual_seed(SEED)
    image = {k: v.to(dev) for k, v in random_image(cifar, gen).items()}
    mega = interpreter.compile_plan(cifar).mega
    calls = {b: (lambda fr=frames_of(cifar, b, 7, dev):
                 mk.megakernel_forward(image, fr, spec=mega))
             for b in (8, 256)}
    x = torch.randn(8192, 8192, device=dev)
    report = {"card": smi, "samples": []}

    def sample(label: str) -> None:
        got = dict(label=label, b8_profiler_ms=device_ms(calls[8], 20),
                   b8_graph_events_ms=graph_ms(calls[8]),
                   b256_profiler_ms=device_ms(calls[256], 20),
                   b256_events_ms=events_ms(calls[256], 20))
        report["samples"].append(got)
        print(f"{label}: B=8 profiler {got['b8_profiler_ms']:.5f} ms, graph "
              f"events {got['b8_graph_events_ms']:.5f} ms; B=256 profiler "
              f"{got['b256_profiler_ms']:.5f} ms, events "
              f"{got['b256_events_ms']:.5f} ms [{smi}]", flush=True)

    sample("fresh")
    for i in range(ROUNDS):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < BURST_S:
            x @ x
        torch.cuda.synchronize()
        sample(f"after {BURST_S:.0f} s of matmul, round {i}")
        time.sleep(IDLE_S)
        sample(f"after {IDLE_S:.0f} s idle, round {i}")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
