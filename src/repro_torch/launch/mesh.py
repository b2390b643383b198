"""Training mesh construction.

The counterpart of ``repro.launch.mesh``: the production meshes of 256
and 512 chips, the host mesh over this process's cards, and a mesh for n
devices, all as the port's one mesh type, ``checkpoint.ckpt.Mesh``.  A
builder asked for more devices than this machine holds raises, unless
its caller asks for the abstract mesh by name (``abstract=True``: the
sizes and axis names, no devices), which is what a dry run shards over.
"""

from __future__ import annotations

from repro_torch import device as _device
from repro_torch.checkpoint.ckpt import Mesh, make_mesh


def _mesh(shape, axes, devices, abstract: bool) -> Mesh:
    if abstract:
        return Mesh.abstract(shape, axes)
    return make_mesh(shape, axes, devices=devices)


def make_production_mesh(*, multi_pod: bool = False,
                         abstract: bool = False) -> Mesh:
    """16 x 16 = 256 chips a pod, ``("data", "model")``; 2 x 16 x 16 = 512
    chips across 2 pods, ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, None, abstract)


def make_host_mesh(devices=None) -> Mesh:
    """Every CUDA device of this process (or ``devices``), as (1, n)
    ``("data", "model")``; raises without a card unless devices are
    named."""
    devs = (_device.local_devices() if devices is None
            else [_device.resolve(d) for d in devices])
    if not devs:
        _device.resolve(None)            # raises: no card, none named
    return make_mesh((1, len(devs)), ("data", "model"), devices=devs)


def make_mesh_for(n_devices: int, model: int = 1, *, devices=None,
                  abstract: bool = False) -> Mesh:
    """(n / model, model) ``("data", "model")`` over the first n devices
    (or abstract)."""
    if n_devices % model:
        raise ValueError(f"model axis {model} does not divide {n_devices} "
                         f"devices")
    return _mesh((n_devices // model, model), ("data", "model"), devices,
                 abstract)
