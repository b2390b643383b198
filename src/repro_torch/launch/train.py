"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

The counterpart of ``repro.launch.train``: arch registry -> train state
-> deterministic data -> train step -> async checkpoints with restart on
relaunch, on one device (the card unless ``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --scaled --quant binary --steps 40 --ckpt-dir "$(mktemp -d)"

``--scaled`` takes the reduced same-family config in float32 (CPU-sized);
without it the arch's full config runs in its own dtypes.  Checkpoints
are written asynchronously every ``--ckpt-every`` steps; relaunching with
the same ``--ckpt-dir`` resumes from the latest step (the batch of a step
is a pure function of the step, so the stream realigns exactly); a
directory holding another run's checkpoints resumes that run, so give a
new run a fresh one.  SIGTERM
(preemption) saves synchronously and exits 0.  ``repro``'s mesh has no
counterpart: one process, one device.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

from repro_torch import device as _device
from repro_torch.checkpoint import ckpt
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data import tokens as dtok
from repro_torch.optim import optimizers as opt
from repro_torch.train import steps


def make_cfg(args):
    """The run's config from the flags, as ``repro``'s driver makes it."""
    cfg = get_config(args.arch)
    if args.scaled:
        cfg = cfg.scaled()
    over = {}
    if args.quant:
        over["quant"] = args.quant
    if args.width_mult:
        over["width_mult"] = args.width_mult
    if args.scaled:
        over.update(dtype="float32", param_dtype="float32", loss_chunk=64)
    return cfg.with_(**over) if over else cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--scaled", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--quant", default=None, help="binary = paper technique")
    ap.add_argument("--width-mult", type=float, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = make_cfg(args)
    optimizer = opt.make(cfg.optimizer,
                         opt.cosine_schedule(args.lr, warmup=20,
                                             total=args.steps))
    start = 0
    state = steps.create_state(cfg, 0, optimizer, device=dev)
    writer = None
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            state = ckpt.restore(os.path.join(args.ckpt_dir,
                                              f"ckpt_{latest}"), state,
                                 device=dev)
            start = latest
            print(f"resumed from step {latest}")
        writer = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=3)

    stop = {"now": False}
    previous = signal.signal(signal.SIGTERM,
                             lambda *a: stop.update(now=True))
    train_step = steps.build_train_step(cfg, optimizer)
    losses = []
    t0 = time.time()
    try:
        for i in range(start, args.steps):
            batch = dtok.batch_for_step(cfg, i,
                                        global_batch=args.global_batch,
                                        seq_len=args.seq_len, device=dev)
            state, metrics = train_step(state, batch)
            losses.append(float(metrics["loss"]))
            if i % args.log_every == 0 or i == args.steps - 1:
                dt = time.time() - t0
                tok_s = (args.global_batch * args.seq_len * args.log_every
                         / max(dt, 1e-9))
                print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}  "
                      f"tok/s {tok_s:,.0f}", flush=True)
                t0 = time.time()
            if writer and ((i + 1) % args.ckpt_every == 0 or stop["now"]):
                writer.save(state, i + 1)
            if stop["now"]:
                if writer:
                    writer.wait()
                print(f"preempted at step {i + 1}; checkpoint saved",
                      flush=True)
                sys.exit(0)
        if writer:
            writer.save(state, args.steps)
            writer.wait()
    finally:
        signal.signal(signal.SIGTERM, previous)
    print("done")
    return state, losses


if __name__ == "__main__":
    main()
