"""End-to-end serving example: BinarEye as an always-on sliding-window
face detector on QQVGA frames (the paper's Sec. III-B deployment).

The counterpart of ``examples/always_on_detector.py``.  The face detector
(``networks.face_detector``, cifar9 at S=4) is trained with the STE,
folded into the packed deployment artifact, and parked resident in the
port's ``ChipServer`` (whole-network megakernel, batch 54).  A stream of
160x120 frames is scanned with 32x32 windows at stride 16 (the paper's
setting): every frame's 54 windows are submitted as frame requests and
served in one dispatch.  Runs on the GPU unless asked for the CPU::

    PYTHONPATH=src python -m repro_torch.examples.always_on_detector \\
        [--device cpu] [--steps N] [--frames N]

The synthetic faces and backgrounds are drawn by ``torch.Generator``\\ s,
whose streams are not ``jax.random``'s, so the frame-level agreement is
reported, not held to the JAX example's count.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.chip import interpreter, networks
from repro_torch.data import images as dimg
from repro_torch.examples.quickstart import train_step
from repro_torch.optim import optimizers as opt
from repro_torch.serving.server import ChipServer

QQVGA_H, QQVGA_W = 120, 160
WIN, STRIDE = 32, 16
BATCH = 32


def detector_batch(i: int, batch: int = BATCH, device=None):
    """Half 'face' windows (smooth class template + noise), half background
    windows drawn from the SAME distribution the deployed stream sees."""
    dev = _device.resolve(device)
    faces, _ = dimg.batch_for_step(i, batch=batch // 2, num_classes=1,
                                   h=WIN, w=WIN, device=dev)
    bg = torch.randint(0, 128, (batch - batch // 2, WIN, WIN, 3),
                       generator=dimg.step_generator(3, i),
                       dtype=torch.int32).to(dev)
    images = torch.cat([faces, bg])
    labels = torch.cat([torch.ones(batch // 2, dtype=torch.int64),
                        torch.zeros(batch - batch // 2, dtype=torch.int64)])
    return images, labels.to(dev)


def detector_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Two-class hinge on the integer logits; ``torch.maximum`` so a tie
    at 0 takes gradient 0.5, as ``jnp.maximum`` does."""
    one_hot = torch.nn.functional.one_hot(labels, 2).to(logits.dtype)
    margin = 1.0 - (2 * one_hot - 1) * logits * 0.1
    return torch.mean(torch.sum(torch.maximum(margin.new_zeros(()), margin),
                                dim=-1))


def train_detector(program, steps: int = 40, batch: int = BATCH,
                   device=None, seed: int = 7):
    """Face/no-face BinaryNet, trained on synthetic 2-class data.
    Returns (params, per-step losses)."""
    dev = _device.resolve(device)
    params = interpreter.init_params(torch.Generator().manual_seed(seed),
                                     program, device=dev)
    optimizer = opt.make("adamw", opt.cosine_schedule(2e-3, 20, steps))
    opt_state = optimizer.init(params)
    losses = []
    for i in range(steps):
        images, labels = detector_batch(i, batch, device=dev)
        params, opt_state, loss = train_step(
            params, opt_state, i, images, labels, prog=program,
            optimizer=optimizer, loss_fn=detector_loss)
        losses.append(float(loss))
    return params, losses


def window_coords():
    """The (y, x) corners of the 32x32 windows at stride 16."""
    return [(y, x) for y in range(0, QQVGA_H - WIN + 1, STRIDE)
            for x in range(0, QQVGA_W - WIN + 1, STRIDE)]


def windows_of(frame: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (N, 32, 32, C) sliding windows at stride 16."""
    return np.stack([frame[y:y + WIN, x:x + WIN] for y, x in window_coords()])


def synthetic_frame(step: int, face_at=None) -> np.ndarray:
    """A QQVGA frame of background noise, optionally with a 'face' pasted."""
    frame = torch.randint(0, 128, (QQVGA_H, QQVGA_W, 3),
                          generator=dimg.step_generator(99, step),
                          dtype=torch.int32)
    if face_at is not None:
        face, _ = dimg.batch_for_step(step, batch=1, num_classes=1, h=WIN,
                                      w=WIN, device="cpu")
        y, x = face_at
        frame[y:y + WIN, x:x + WIN] = face[0]
    return frame.numpy()


def face_at(t: int):
    """Where frame t has its face: odd frames only."""
    return (16 + 16 * (t % 3), 32 + 16 * (t % 4)) if t % 2 else None


def deploy(params, program, device=None) -> ChipServer:
    """Fold BN into integer thresholds, bit-pack the weights (the
    artifact the chip's SRAMs would hold) and park the program resident
    in a ``ChipServer`` whose dispatch is one frame's windows."""
    packed = interpreter.fold_params(params, program, packed=True)
    return ChipServer({"face": program}, {"face": packed},
                      batch=len(window_coords()), megakernel=True,
                      device=device)


def serve_frame(server: ChipServer, frame: np.ndarray):
    """Submit one frame's windows; returns their labels in window order."""
    rids = server.submit_many("face", windows_of(frame))
    results = {res.rid: res for res in server.drain()}
    return [results[rid].label for rid in rids]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    # the paper's face-detection operating point: 9-layer net at S=4
    program = networks.face_detector()
    print("training the detector (synthetic face/background data)...")
    params, losses = train_detector(program, args.steps, device=dev)
    print(f"  {args.steps} steps at batch {BATCH}: loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}")
    server = deploy(params, program, device=dev)
    n_win = len(window_coords())

    # chip-level cost of one frame: 54 windows/frame at stride 16
    r = server.stats().chip.reports["face"]
    e_frame = r.i2l_energy_per_inference * n_win
    fps_1mw = 1e-3 / e_frame
    fps_10mw = 10e-3 / e_frame
    print(f"\nchip bill: {n_win} windows/frame x "
          f"{r.i2l_energy_per_inference*1e6:.2f} uJ = "
          f"{e_frame*1e6:.0f} uJ/frame")
    print(f"  -> {fps_1mw:5.1f} fps at 1 mW, {fps_10mw:5.1f} fps at 10 mW "
          "(paper: 1-20 fps @ 1 mW, 15-200 @ 10 mW, task-dependent stride)")

    print("\nstreaming QQVGA frames (windows served as frame requests):")
    hits = 0
    first_wall = 0.0               # frame 0 includes the kernel build
    coords = window_coords()
    for t in range(args.frames):
        at = face_at(t)
        wall0 = server.stats().host_wall_s
        labels = serve_frame(server, synthetic_frame(t, at))
        host_ms = (server.stats().host_wall_s - wall0) * 1e3
        if t == 0:
            first_wall = host_ms * 1e-3
        det = [coords[i] for i, y in enumerate(labels) if y == 1]
        # a window is a true hit if it overlaps the planted face
        hit = at is not None and any(
            abs(y - at[0]) <= 16 and abs(x - at[1]) <= 16 for (y, x) in det)
        hits += hit or (at is None and not det)
        chip_ms = n_win / r.inferences_per_s * 1e3
        print(f"  frame {t}: face@{at}  detections={det[:3]}"
              f"{'...' if len(det) > 3 else ''}  "
              f"[chip {chip_ms:.1f} ms, host {host_ms:.0f} ms]")
    stats = server.stats()
    server.close()
    steady_s = stats.host_wall_s - first_wall
    host_fps = (args.frames - 1) / steady_s if steady_s > 0 else 0.0
    print(f"\nframe-level agreement: {hits}/{args.frames}")
    print(f"serving stats: {stats.total_served} windows in "
          f"{stats.dispatches} dispatches, 0 padded slots expected -> "
          f"{stats.padded['face']} padded; billed {stats.billed} == served "
          f"{stats.total_served} + padded {stats.padded['face']}")
    print(f"host throughput: {host_fps:.1f} frames/s "
          f"({host_fps * n_win:,.0f} windows/s through the server)")
    print(f"chip-model serving bill: {stats.chip.uj_per_frame:.2f} uJ/window,"
          f" {stats.chip.frames_per_s:,.0f} windows/s at Emin")
    print(f"battery: 810 mWh AAA / 1 mW = {810/24:.1f} days always-on at "
          f"{fps_1mw:.1f} fps (paper: 'up to 33 days')")
    return hits, stats


if __name__ == "__main__":
    main()
