"""Quickstart: train a BinaryNet on the BinarEye chip model, fold it for
deployment, and read off the chip-level energy/latency report.

The counterpart of ``examples/quickstart.py``, on the GPU unless asked
for the CPU::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--steps N]

Walks through all three levels of the chip's flexibility:
  1. retrainable weights   (STE BinaryNet training -> fold -> deploy)
  2. programmable depth    (the ISA program defines the network)
  3. programmable width    (the S knob trades energy for accuracy)

The synthetic images are drawn by ``repro_torch.data.images``, whose
random streams are not ``repro``'s, so the losses and the accuracy differ
from the JAX example's.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import device as _device
from repro_torch.core.chip import energy, interpreter, isa, networks
from repro_torch.data import images as dimg
from repro_torch.optim import optimizers as opt

CLASSES = 10


def program() -> isa.Program:
    """cifar9(s=4) is the paper's face-detection operating point; the
    input is shrunk to 16x16 for a quick demo with the same structure."""
    f = isa.ARRAY_CHANNELS // 4
    prog = isa.Program(s=4, instrs=(
        isa.IOInstr(height=16, width=16, in_channels=3, bits=7, channels=f),
        isa.ConvInstr(height=16, width=16, features=f, maxpool=True),  # ->7
        isa.ConvInstr(height=7, width=7, features=f, maxpool=True),    # ->3
        isa.FCInstr(in_features=3 * 3 * f, out_features=CLASSES, final=True),
    ))
    isa.validate(prog)
    return prog


def hinge_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Hinge-style loss for integer BinaryNet logits.  ``torch.maximum``
    (not ``clamp``/``relu``) so a tie at 0 takes gradient 0.5, as
    ``jnp.maximum`` does."""
    one_hot = torch.nn.functional.one_hot(labels, CLASSES).to(logits.dtype)
    margin = 1.0 - one_hot * logits + (1 - one_hot) * logits * 0.1
    return torch.mean(torch.sum(torch.maximum(margin.new_zeros(()), margin),
                                dim=-1))


def train_step(params, opt_state, i, images, labels, *, prog, optimizer,
               loss_fn):
    """One STE step: forward_train, the loss's gradients, the optimizer
    update on the params carrying this batch's BN statistics.  Returns
    (params, opt_state, loss)."""
    def loss_of(p):
        logits, new_p = interpreter.forward_train(p, prog, images)
        return loss_fn(logits, labels), new_p

    (loss, new_p), grads = opt.value_and_grad(loss_of, params)
    params, opt_state, _gn = optimizer.update(grads, opt_state, new_p, i)
    return params, opt_state, loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    # --- 1. a *small* always-on program (depth = ISA program) --------------
    prog = program()

    # --- 2. train it (BinaryNet STE semantics, synthetic 10-class data) ----
    params = interpreter.init_params(torch.Generator().manual_seed(0), prog,
                                     device=dev)
    optimizer = opt.make("adamw", opt.cosine_schedule(2e-3, 20, args.steps))
    opt_state = optimizer.init(params)
    for i in range(args.steps):
        images, labels = dimg.batch_for_step(i, batch=64,
                                             num_classes=CLASSES, h=16, w=16,
                                             device=dev)
        params, opt_state, loss = train_step(
            params, opt_state, i, images, labels, prog=prog,
            optimizer=optimizer, loss_fn=hinge_loss)
        if i % 50 == 0:
            print(f"step {i:4d}  loss {float(loss):.3f}")

    # --- 3. fold + deploy (what the chip actually stores/computes) ---------
    folded = interpreter.fold_params(params, prog)
    infer = interpreter.make_infer_fn(prog, use_kernels=True, device=dev)
    images, labels = dimg.batch_for_step(10_000, batch=256,
                                         num_classes=CLASSES, h=16, w=16,
                                         device=dev)
    _, pred = infer(folded, images)
    acc = float(torch.mean((pred == labels).to(torch.float32)))
    print(f"\ndeployed accuracy (folded integer comparator, packed "
          f"kernels): {acc:.1%}")

    # --- 4. the energy/latency story (the paper's evaluation axis) ---------
    print("\nchip-level report for the paper's S operating points "
          "(9-layer net):")
    for s in (1, 2, 4):
        r = energy.analyze_net(networks.cifar9(s))
        print(f"  S={s}: {r.i2l_energy_per_inference*1e6:6.2f} uJ/frame, "
              f"{r.inferences_per_s:7.0f} inf/s, {r.power_w*1e3:5.2f} mW, "
              f"{r.i2l_tops_per_w:6.1f} I2L TOPS/W")
    print("\n(energy scales ~S^2: the third flexibility level — width)")
    return acc


if __name__ == "__main__":
    main()
