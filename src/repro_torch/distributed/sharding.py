"""Chip-tier serving layout: replicas of the artifact, frames scattered.

The counterpart of the serving half of ``repro.distributed.sharding``
(``SERVE_AXIS`` through ``scatter_frames``; the training-side partition
specs are not ported).  The serving data-parallel layout mirrors the
chip's LD-once/CONV-many schedule, lifted one level: every device of a
serving group holds a full replica of the deployment artifact (the SRAM
contents), and each dispatch's frame batch is scattered on the batch
axis, the results gathered back in order.  Weights move to a device once;
frames stream through.

A serving mesh here is a plain tuple of ``torch.device``\\ s.  A device
may appear more than once (replicas and groups then share it, as on a
one-card machine); its artifact replica is then one copy.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch import device as _device

SERVE_AXIS = "frames"


def _devices(devices) -> List[torch.device]:
    devs = (_device.local_devices() if devices is None
            else [torch.device(d) for d in devices])
    if not devs:
        _device.resolve(None)            # raises: no card, none named
        raise ValueError("a serving mesh needs at least one device")
    for d in devs:
        _device.resolve(d)
    return devs


def serve_mesh(devices=None) -> Tuple[torch.device, ...]:
    """The 1-axis serving mesh over ``devices`` (default: every CUDA
    device of this process)."""
    return tuple(_devices(devices))


def partition_serve_meshes(n: int, devices=None
                           ) -> List[Tuple[torch.device, ...]]:
    """``n`` serving meshes over disjoint host-major device groups.

    The fleet's replica topology: the flat device list is split into
    ``n`` contiguous groups, one per simulated host, so a replica's frames
    scatter only over its own devices and a host loss takes out exactly
    one group.  Remainder devices go to the leading groups (sizes differ
    by at most one).  With fewer devices than replicas the groups wrap
    round-robin: replicas then *share* devices, which keeps a one-card
    machine (or the CPU) able to run fleet scheduling.
    """
    if n < 1:
        raise ValueError(f"need >= 1 replica, got {n}")
    devs = _devices(devices)
    if len(devs) >= n:
        base, rem = divmod(len(devs), n)
        groups, at = [], 0
        for i in range(n):
            size = base + (1 if i < rem else 0)
            groups.append(devs[at:at + size])
            at += size
    else:
        groups = [[devs[i % len(devs)]] for i in range(n)]
    return [tuple(g) for g in groups]


def replicate_artifact(mesh: Sequence[torch.device], artifact) -> tuple:
    """One full artifact replica a mesh entry, placed on that device (the
    same tensors for entries naming the same device)."""
    placed = {}
    for d in mesh:
        if d not in placed:
            placed[d] = _device.to_device(artifact, d)
    return tuple(placed[d] for d in mesh)


def scatter_frames(mesh: Sequence[torch.device], frames: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """Scatter a frame batch over the mesh's batch axis: chunk i, of
    ``B / len(mesh)`` frames, on ``mesh[i]``.  The leading dim must divide
    the mesh size (the server pads its dispatches to guarantee this)."""
    n = len(mesh)
    if frames.shape[0] % n:
        raise ValueError(
            f"frame batch {frames.shape[0]} not divisible by "
            f"{n}-device serving mesh")
    return tuple(c.to(d) for c, d in zip(frames.chunk(n), mesh))


def gather_frames(mesh: Sequence[torch.device], parts) -> torch.Tensor:
    """The inverse of :func:`scatter_frames`: per-device results
    concatenated in mesh order on ``mesh[0]``."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(mesh[0]) for p in parts])
