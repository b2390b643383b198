"""Synthetic image pipeline for the chip networks (CIFAR-like, 7-bit RGB).

The counterpart of ``repro.data.images``: class-conditional smooth
templates plus noise, so class identity is recoverable (a trained
BinaryNet separates them), deterministic per (seed, step).

``jax.random`` cannot be reproduced in PyTorch, so the random draws (the
templates' frequencies, the labels and the noise) come from
``torch.Generator``\\ s seeded from ``seed`` and ``(seed, step)``: the
images are not ``repro``'s images.  The template formula is the same, in
:func:`templates_from_freqs`, which the tests hold against ``repro``'s
given the same frequencies.  Draws are made on the host, and the batch
is placed on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device


def templates_from_freqs(freqs: torch.Tensor, h: int = 32, w: int = 32,
                         levels: int = 128) -> torch.Tensor:
    """Smooth per-class templates in [0, levels) from (classes, 4, C)
    float32 frequencies: (classes, h, w, C) int32."""
    yy = torch.linspace(0, 3.14159 * 2, h)[:, None, None]
    xx = torch.linspace(0, 3.14159 * 2, w)[None, :, None]
    t = (torch.sin(yy * (1 + freqs[:, 0][:, None, None]))
         + torch.cos(xx * (1 + freqs[:, 1][:, None, None]))
         + torch.sin((yy + xx) * freqs[:, 2][:, None, None]))
    t = (t - t.min()) / (t.max() - t.min() + 1e-9)
    return (t * (levels - 1)).to(torch.int32)


def class_templates(generator: torch.Generator, num_classes: int,
                    h: int = 32, w: int = 32, channels: int = 3,
                    levels: int = 128) -> torch.Tensor:
    """Smooth per-class templates in [0, levels), frequencies drawn from
    ``generator``: (num_classes, h, w, channels) int32."""
    freqs = torch.randn((num_classes, 4, channels), generator=generator)
    return templates_from_freqs(freqs, h, w, levels)


def step_generator(seed: int, *key: int) -> torch.Generator:
    """A generator seeded from ``(seed, *key)`` through numpy's
    ``SeedSequence``, so nearby keys give unrelated streams."""
    state = np.random.SeedSequence((seed,) + key).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def batch_for_step(step: int, *, batch: int, num_classes: int = 10,
                   h: int = 32, w: int = 32, channels: int = 3,
                   levels: int = 128, seed: int = 0, device=None):
    """Returns (images (B,H,W,C) int32 in [0,levels), labels (B,) int64)
    on ``device``."""
    dev = _device.resolve(device)
    templates = class_templates(step_generator(seed), num_classes, h, w,
                                channels, levels)
    gen = step_generator(seed, 1, step)
    labels = torch.randint(0, num_classes, (batch,), generator=gen)
    base = templates[labels]
    noise = torch.randn(base.shape, generator=gen) * levels * 0.15
    img = torch.clamp(base + noise.to(torch.int32), 0, levels - 1)
    return img.to(torch.int32).to(dev), labels.to(dev)
