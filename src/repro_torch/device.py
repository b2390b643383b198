"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the GPU.

    There is no silent fallback: without a CUDA device, ``None`` (or any
    CUDA device) raises, and the caller has to ask for the CPU by name.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU unless asked otherwise, and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    return dev


def local_devices() -> list:
    """Every CUDA device of this process (empty without a card)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def to_device(tree, device: torch.device):
    """Move every tensor of a nested dict/list/tuple artifact to ``device``
    (a no-op for tensors already there)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree
