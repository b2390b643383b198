"""End-to-end training driver: a *binary* (W1A1, the paper's technique)
language model trained for a few hundred steps, with a simulated
preemption and checkpoint restart in the middle, then greedy decoding
through the serving path.

The counterpart of ``examples/train_binary_lm.py``, on the GPU unless
asked for the CPU::

    PYTHONPATH=src python -m repro_torch.examples.train_binary_lm \\
        [--device cpu] [--steps 240] [--crash-at 120]

This is the paper's contribution lifted to the LM tier: BitLinear
projections (XNOR-popcount semantics, STE-trained) inside a standard
transformer (SmolLM-360M's family at ``scaled()`` size, float32), the
BinarEye S-knob exposed as ``width_mult``.  Attention runs chunked in
training (``mode="train"``: the flash kernel has no backward, in
``repro`` either); the greedy decode's prefill runs the flash kernel on
the card, at ``scaled()``'s head dim of 32.  The parameters and the token draws are the port's own
(``torch.Generator``\\ s), so the losses are not ``repro``'s.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import torch

from repro_torch import device as _device
from repro_torch.checkpoint import ckpt
from repro_torch.configs.registry import get_config
from repro_torch.data import tokens as dtok
from repro_torch.optim import optimizers as opt
from repro_torch.train import serve, steps

TOTAL_STEPS = 240
CRASH_AT = 120          # simulated preemption
B, S = 8, 64


def make_cfg():
    # smollm family, reduced, with the paper's technique ON: every
    # FFN/attention projection is a BitLinear (W1A1 + STE)
    return (get_config("smollm-360m", quant="binary").scaled()
            .with_(dtype="float32", param_dtype="float32",
                   quant="binary", loss_chunk=32))


def train(cfg, ckpt_dir, start_step, dev, total=TOTAL_STEPS,
          crash_at=CRASH_AT):
    """Steps ``start_step`` to ``total`` (restoring the checkpoint at
    ``start_step`` if it is not 0), saving at multiples of ``crash_at``;
    returns (state, losses, preempted) with ``preempted`` after step
    ``crash_at``."""
    optimizer = opt.make(cfg.optimizer, opt.cosine_schedule(3e-3, 20, total))
    state = steps.create_state(cfg, 0, optimizer, device=dev)
    if start_step > 0:  # restart path: restore from the latest checkpoint
        state = ckpt.restore(os.path.join(ckpt_dir, f"ckpt_{start_step}"),
                             state, device=dev)
        print(f"  restored checkpoint @ step {start_step}")
    train_step = steps.build_train_step(cfg, optimizer)
    writer = ckpt.AsyncCheckpointer(ckpt_dir, keep=2)
    losses = []
    for i in range(start_step, total):
        batch = dtok.batch_for_step(cfg, i, global_batch=B, seq_len=S,
                                    device=dev)
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        if i % 40 == 0:
            print(f"  step {i:4d}  loss {losses[-1]:.3f}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
        if (i + 1) % crash_at == 0:
            writer.save(state, i + 1)
        if (i + 1) == crash_at:
            writer.wait()
            print(f"  !! simulated preemption after step {i + 1}")
            return state, losses, True
    writer.wait()
    return state, losses, False


def decode(cfg, params, dev, n_tokens: int = 8):
    """Greedy decode of ``n_tokens`` after a prompt of S/2 tokens (two
    sequences) through ``train/serve.py``: (2, n_tokens + 1) ids."""
    prefill = serve.build_prefill_step(cfg, max_len=S + 16)
    step = serve.build_decode_step(cfg)
    batch = dtok.batch_for_step(cfg, 0, global_batch=2, seq_len=S,
                                device=dev)
    prompt = batch["tokens"][:, :S // 2]
    pos = torch.arange(S // 2, device=dev)[None, :].repeat(2, 1)
    with torch.no_grad():
        logits, cache = prefill(params, {"tokens": prompt,
                                         "positions": pos})
        toks = serve.sample(None, logits)
        out = [toks]
        for t in range(n_tokens):
            logits, cache = step(params, cache, toks, S // 2 + t)
            toks = serve.sample(None, logits)
            out.append(toks)
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--steps", type=int, default=TOTAL_STEPS)
    ap.add_argument("--crash-at", type=int, default=CRASH_AT)
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    if not 0 < args.crash_at < args.steps:
        ap.error("--crash-at must fall inside the run")
    cfg = make_cfg()
    ckpt_dir = tempfile.mkdtemp(prefix="binary_lm_")
    try:
        print(f"config: {cfg.name} quant={cfg.quant} "
              f"d_model={cfg.d_model} layers={cfg.num_layers} on {dev}")

        print("\nphase 1: train until preemption")
        _, losses1, crashed = train(cfg, ckpt_dir, 0, dev, args.steps,
                                    args.crash_at)
        if not crashed:
            raise AssertionError("the run was not preempted")

        print("\nphase 2: a fresh start restores the checkpoint")
        latest = ckpt.latest_step(ckpt_dir)
        state, losses2, _ = train(cfg, ckpt_dir, latest, dev, args.steps,
                                  args.crash_at)
        losses = losses1 + losses2

        k = min(20, len(losses) // 2)
        first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
        print(f"\nloss: first-{k} avg {first:.3f} -> last-{k} avg "
              f"{last:.3f}")
        if not last < first:
            raise AssertionError("training did not reduce the loss")

        print("\nphase 3: greedy decode through the serving path")
        gen = decode(cfg, state["params"], dev)
        print(f"generated token ids: {gen.tolist()}")
        if not bool(((gen >= 0) & (gen < cfg.vocab_size)).all()):
            raise AssertionError("decoded ids outside the vocabulary")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print("\nOK: binary LM trained, survived preemption, served.")
    return losses, gen


if __name__ == "__main__":
    main()
