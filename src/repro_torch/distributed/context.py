"""Ambient mesh context, and the process groups a mesh's shardings need.

The counterpart of ``repro.distributed.context``.  A launcher or step
builder installs the mesh with :func:`mesh_context`, so model code reads
it (:func:`current_mesh`, through ``sharding.constrain``) and stays
mesh-agnostic.  ``repro``'s ``shard_map`` and ``pcast`` have no torch
twin: they are JAX's surface for a body traced once per device, while a
torch program runs one process per device and moves data between them
with ``torch.distributed`` collectives (ROADMAP §1 items 5.5b-5.5c).

A DTensor placement needs a ``DeviceMesh``, and a ``DeviceMesh`` a
default process group of the mesh's size.  :func:`fake_process_group`
gives one for a mesh this machine cannot hold (torch's ``fake`` backend:
this process is rank 0 of ``world_size`` and no data moves), enough for
shard shapes on meta tensors; :func:`local_process_group` gives the one
rank of a one-process run (gloo, a ``tcp://localhost`` rendezvous).  Both
tear the group down on exit.
"""

from __future__ import annotations

import contextlib
import socket
import threading

_state = threading.local()


def current_mesh():
    """The mesh :func:`mesh_context` installed, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh):
    """Install ``mesh`` (a ``checkpoint.ckpt.Mesh``, or None for none) for
    the block; the one it replaced comes back on exit."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def data_axes(mesh) -> tuple:
    """All mesh axes that carry the batch (every one but 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def model_axis_size(mesh) -> int:
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return mesh.shape["model"]


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A default process group of ``world_size`` ranks that moves no data
    (this process rank 0), for the block."""
    import torch.distributed as dist
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    _check_free(dist)
    dist.init_process_group("fake", store=FakeStore(),
                            world_size=world_size, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def local_process_group():
    """The default process group of one rank (gloo), rendezvous at a free
    ``tcp://localhost`` port, for the block."""
    import torch.distributed as dist
    _check_free(dist)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _check_free(dist) -> None:
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized")
