"""Ambient mesh context, and the process groups a mesh's shardings need.

The counterpart of ``repro.distributed.context``.  A launcher or step
builder installs the mesh with :func:`mesh_context`, so model code reads
it (:func:`current_mesh`, through ``sharding.constrain`` and
``moe.apply``) and stays mesh-agnostic.

``repro``'s ``shard_map`` (a body traced once a device) becomes one
process a device, each rank of the default process group one device of
the mesh (row-major, as ``init_device_mesh`` lays them), with one group a
mesh axis from the mesh's ``DeviceMesh`` (:func:`axis_group`).  A global
array is a tensor every rank holds whole and alike.  :func:`local_block`
gives a rank its block under a spec (``shard_map``'s ``in_specs``) and
:func:`global_value` assembles the blocks back (``out_specs``); the
body's collectives are :func:`psum`, :func:`pmax`, :func:`pmean`,
:func:`all_to_all` (tiled on dim 0) and :func:`ppermute`, each over one
axis's group.  Gradients follow JAX's transposes for one loss every rank
computes alike: a block's gradient is summed over the mesh into the whole
(``local_block``), an assembled value hands each rank its block's
(``global_value``), a psum's is the identity (JAX's ``pvary``), an
all-to-all's and a permute's go back the way they came.  ``pcast`` has no
twin: nothing types a tensor as varying over an axis here.

A DTensor placement needs a ``DeviceMesh``, and a ``DeviceMesh`` a
default process group of the mesh's size.  :func:`fake_process_group`
gives one for a mesh this machine cannot hold (torch's ``fake`` backend:
this process is rank 0 of ``world_size`` and no data moves), enough for
shard shapes on meta tensors; :func:`local_process_group` gives the one
rank of a one-process run (gloo, a ``tcp://localhost`` rendezvous).  Both
tear the group down on exit.  :func:`run_local` runs a function on n
spawned ranks of a gloo group on this host and returns their results.
"""

from __future__ import annotations

import contextlib
import math
import queue
import socket
import threading
import time
import traceback

import torch
from torch._prims_common import make_contiguous_strides_for

_state = threading.local()
# the DeviceMesh of each mesh layout over the current default process
# group: making one creates its axes' groups, a collective call every rank
# must make alike, so it is made once a group (process-wide, as groups are)
_DMESHES: dict = {}
_DMESH_LOCK = threading.Lock()


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


def under_current_mesh(fn):
    """``fn`` run under the mesh current now (:func:`mesh_context`),
    whichever thread calls it: a recompute (``torch.utils.checkpoint``)
    runs in the backward, on CUDA in a thread of autograd's own, where
    the mesh installed on this thread is not."""
    mesh = current_mesh()

    def run(*args, **kwargs):
        with mesh_context(mesh):
            return fn(*args, **kwargs)
    return run


@contextlib.contextmanager
def sharded_step(mesh):
    """The block runs a step on DTensors over ``mesh``: the mesh
    installed (:func:`mesh_context`), and a plain tensor the step makes
    (a scalar, a mask, a table of frequencies) taken as replicated on
    every device (``implicit_replication``).  Tensors with the batch's
    rows are built as blocks at their factories instead
    (``sharding.built_like``): replicating them would build the whole
    batch on every device."""
    from torch.distributed.tensor.experimental import implicit_replication
    with mesh_context(mesh), implicit_replication():
        yield mesh


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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def local_process_group(backend: str = "gloo"):
    """The default process group of one rank, rendezvous at a free
    ``tcp://localhost`` port, for the block.  ``backend``: gloo, or
    ``"cpu:gloo,cuda:nccl"`` for a card's tensors through NCCL and the
    CPU's through gloo."""
    import torch.distributed as dist
    _check_free(dist)
    dist.init_process_group(backend,
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _check_free(dist) -> None:
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized")


# ---------------------------------------------------------------------------
# Spawned ranks on this host
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, world_size: int, port: int, args, results):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank)
    try:
        results.put((rank, True, fn(rank, world_size, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def run_local(fn, world_size: int, *args, timeout: float = 120.0) -> list:
    """``fn(rank, world_size, *args)`` on ``world_size`` spawned processes,
    each a rank of a gloo default group (a free ``tcp://localhost``
    port); their results (picklable) in rank order.  ``fn`` must be
    importable by name, from a module whose import is cheap: each child
    imports it afresh.  Raises with a rank's traceback if one fails, and
    ``TimeoutError`` (every rank killed) past ``timeout`` seconds."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, port, args, results))
             for r in range(world_size)]
    deadline = time.monotonic() + timeout
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_local: {world_size - len(out)} of "
                                   f"{world_size} ranks gave no result in "
                                   f"{timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"run_local: ranks {dead} of "
                                       f"{world_size} died with no result")
                continue
            if not ok:
                raise RuntimeError(f"run_local: rank {rank} of {world_size} "
                                   f"failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 0) + 5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]


# ---------------------------------------------------------------------------
# shard_map's torch twin: blocks, groups and collectives over mesh axes
# ---------------------------------------------------------------------------

def device_mesh(mesh):
    """The ``torch.distributed`` ``DeviceMesh`` of ``mesh`` over the
    default process group, which must have the mesh's size (an abstract
    mesh's is a :func:`fake_process_group`); made once a group.  Its
    device type is the mesh's devices' type, or ``cuda`` for an abstract
    mesh: the production meshes are cards, whatever device the caller's
    blocks lie on (meta in the dry run), and on a CPU mesh DTensor would
    gather a whole dim where on the cards it moves a block from one
    tensor dim to another by an all-to-all."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized() or dist.get_world_size() != mesh.size:
        raise RuntimeError(
            f"a DeviceMesh of {mesh.size} devices needs a default process "
            f"group of that size (fake_process_group for an abstract mesh, "
            f"local_process_group for one device, run_local for several)")
    kind = "cuda" if mesh.is_abstract else mesh.devices.flat[0].type
    key = (kind, tuple(mesh.axis_names), tuple(mesh.axis_sizes))
    world = dist.distributed_c10d._get_default_group()
    with _DMESH_LOCK:
        made = _DMESHES.get(key)
        if made is None or made[0] is not world:
            made = (world, init_device_mesh(
                kind, tuple(mesh.axis_sizes),
                mesh_dim_names=tuple(mesh.axis_names)))
            _DMESHES[key] = made
        return made[1]


def axis_group(mesh, axis: str):
    """The process group of this rank's line along mesh axis ``axis``."""
    return device_mesh(mesh).get_group(axis)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
    return device_mesh(mesh).get_coordinate()[mesh.axis_names.index(axis)]


def _entry_axes(entry) -> tuple:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def _block_slices(mesh, spec, coords, shape) -> tuple:
    """The slices of the block at mesh coordinates ``coords`` of a global
    tensor of ``shape`` under ``spec`` (a dim split over several axes
    takes them first outermost)."""
    slices = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        idx, parts = 0, 1
        for a in _entry_axes(entry):
            i = mesh.axis_names.index(a)
            idx, parts = idx * mesh.axis_sizes[i] + coords[i], \
                parts * mesh.axis_sizes[i]
        if size % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"into {parts} blocks under {spec}")
        step = size // parts
        slices.append(slice(idx * step, (idx + 1) * step))
    return tuple(slices)


def _coords(mesh, rank: int) -> tuple:
    coords = []
    for size in reversed(mesh.axis_sizes):
        coords.append(rank % size)
        rank //= size
    return tuple(reversed(coords))


def _wait(t):
    """A functional collective's result, waited for."""
    return t.wait() if hasattr(t, "wait") and callable(t.wait) else t


class _LocalBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec, repeated):
        ctx.shape = x.shape
        ctx.where = _block_slices(mesh, spec,
                                  device_mesh(mesh).get_coordinate(),
                                  x.shape)
        ctx.alike = math.prod(mesh.shape[a] for a in repeated)
        return x[ctx.where].contiguous()

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        import torch.distributed._functional_collectives as fc
        whole = g.new_zeros(ctx.shape)
        whole[ctx.where] = g
        whole = _wait(fc.all_reduce(whole, "sum", dist.group.WORLD))
        # the devices of the repeated axes gave the same gradient
        return (whole / ctx.alike if ctx.alike > 1 else whole), None, \
            None, None


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def local_block(x: torch.Tensor, mesh, spec, repeated=()) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``spec`` (a
    ``sharding.P``); its gradient, summed over every rank, is the whole
    tensor's.  The axes named in ``repeated`` are those on whose devices
    the body runs alike (a batch that does not split there): their
    devices' gradients are one and the same, counted once.  A DTensor
    ``x`` is redistributed to ``spec``'s placements and its local block
    taken; the block's gradient is a partial sum over the mesh dims the
    spec does not split, except the ``repeated`` ones: whole there.  It
    comes back through DTensor's redistribution."""
    if _is_dtensor(x):
        from torch.distributed.tensor import Partial
        from repro_torch.distributed.sharding import placements
        place = list(placements(spec, mesh))
        return x.redistribute(x.device_mesh, place).to_local(
            grad_placements=[
                Partial() if p.is_replicate() and name not in repeated
                else p for p, name in zip(place, mesh.axis_names)])
    return _LocalBlock.apply(x, mesh, spec, tuple(repeated))


class _GlobalValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec, shape):
        import torch.distributed as dist
        import torch.distributed._functional_collectives as fc
        ctx.where = _block_slices(mesh, spec,
                                  device_mesh(mesh).get_coordinate(), shape)
        # all_gather_single is all_gather_tensor's newer name
        gather = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor
        blocks = _wait(gather(x.contiguous(), 0, dist.group.WORLD))
        blocks = blocks.reshape((mesh.size,) + tuple(x.shape))
        out = x.new_empty(shape)
        for rank in range(mesh.size):
            out[_block_slices(mesh, spec, _coords(mesh, rank), shape)] = \
                blocks[rank]
        return out

    @staticmethod
    def backward(ctx, g):
        return g[ctx.where].contiguous(), None, None, None


def global_value(x: torch.Tensor, mesh, spec, shape,
                 dmesh=None) -> torch.Tensor:
    """The global tensor of ``shape`` whose block under ``spec`` this rank
    holds as ``x`` (every rank holding a block along an axis the spec does
    not split holds the same one); every rank gets it whole.  Given the
    ``DeviceMesh`` ``dmesh`` (the one of the DTensor the block came from,
    :func:`local_block`), the DTensor of those blocks instead: nothing
    moves."""
    if dmesh is not None:
        from torch.distributed.tensor import DTensor
        from repro_torch.distributed.sharding import placements
        return DTensor.from_local(x, dmesh, list(placements(spec, mesh)),
                                  shape=torch.Size(shape),
                                  stride=make_contiguous_strides_for(shape))
    return _GlobalValue.apply(x, mesh, spec, tuple(shape))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as fc
        return _wait(fc.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over ``axis`` (``jax.lax.psum``); the gradient passes as is."""
    return _PSum.apply(x, axis_group(mesh, axis))


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return psum(x, mesh, axis) / mesh.shape[axis]


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Max over ``axis`` (``jax.lax.pmax``; no gradient)."""
    import torch.distributed._functional_collectives as fc
    return _wait(fc.all_reduce(x, "max", axis_group(mesh, axis)))


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``: dim 0 split in
    the axis' size, block j to rank j, the blocks received concatenated
    in rank order."""
    import torch.distributed._functional_collectives as fc
    return _wait(fc.all_to_all_single_autograd(
        x.contiguous(), None, None, axis_group(mesh, axis)))


def _shift(x: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Send ``x`` to group rank ``to``, receive its like from ``frm``."""
    import torch.distributed as dist
    me = dist.get_rank(group)
    if to == me and frm == me:
        return x.clone()
    x = x.contiguous()
    got = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, group=group, group_peer=to),
           dist.P2POp(dist.irecv, got, group=group, group_peer=frm)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return got


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, to, frm):
        ctx.group, ctx.to, ctx.frm = group, to, frm
        return _shift(x, group, to, frm)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, ctx.frm, ctx.to), None, None, None


def ppermute_next(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.ppermute`` with ``[(i, (i + 1) % n)]``: each rank's ``x``
    to the next along ``axis``, the previous one's back; the gradient
    goes the other way."""
    n = mesh.shape[axis]
    i = axis_index(mesh, axis)
    return _Shift.apply(x, axis_group(mesh, axis), (i + 1) % n,
                        (i - 1) % n)
