"""Logical-axis sharding rules (params, batch, cache -> partition specs)
and the chip-tier serving layout.

The counterpart of ``repro.distributed.sharding``.  The training half
maps logical axes to mesh axes:

  tp    -> mesh "model"          (tensor parallel: heads / ffn hidden / vocab)
  fsdp  -> ("pod", "data")       (ZeRO-3 weight sharding, only if cfg.fsdp)
  dp    -> ("pod", "data")       (batch)
  sp    -> mesh "model"          (sequence, in MoE blocks and decode KV)
  ep    -> mesh "model"          (experts)

Rules are matched on the parameter path string (first match wins);
stacked leaves under ``blocks/`` get a leading ``None``.  A spec is a
:class:`P`, a tuple with one entry a tensor dim: a mesh axis name, a
tuple of them (the dim split over their product, the first outermost) or
None (replicated), ``jax.sharding.PartitionSpec``'s twin.  An axis is used
only where it divides the dim, so every shard has the same shape.
:func:`to_named` places a spec tree on a mesh as DTensor placements over
a ``torch.distributed`` ``DeviceMesh`` (:class:`NamedSharding`), and
:func:`constrain` is the in-model constraint: the identity without a mesh
or on a mesh of one device, else a DTensor redistributed to the spec.
Inside the model, :func:`heads_view` splits heads that do not divide the
axis in ``torch.chunk``'s blocks of whole heads, :func:`on_blocks`
runs a per-head computation on each device's blocks, and
:func:`placed_matmul` a linear layer's product, its placements written
down in both directions.

The serving half (``SERVE_AXIS`` through ``gather_frames``) mirrors the
chip's LD-once/CONV-many schedule, lifted one level: every device of a
serving group holds a full replica of the deployment artifact (the SRAM
contents), and each dispatch's frame batch is scattered on the batch
axis, the results gathered back in order.  Weights move to a device once;
frames stream through.  A serving mesh there is a plain tuple of
``torch.device``\\ s.  A device may appear more than once (replicas and
groups then share it, as on a one-card machine); its artifact replica is
then one copy.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, List, Sequence, Tuple

import torch
from torch._prims_common import make_contiguous_strides_for

from repro_torch import device as _device
from repro_torch.distributed import context as dctx


# ---------------------------------------------------------------------------
# Partition specs
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec: one entry a tensor dim (see the module
    docstring); equal to the plain tuple of its entries.  As
    ``PartitionSpec`` does, a tuple of one axis becomes the axis and an
    empty tuple None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _axes(mesh, cfg):
    dp = dctx.data_axes(mesh)
    tp = "model" if "model" in mesh.axis_names else None
    fsdp = dp if cfg.fsdp else None
    return dp, tp, fsdp


def _divisible(dim: int, axes, mesh) -> bool:
    if axes is None:
        return False
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return dim % n == 0


def _maybe(dim, axes, mesh):
    """``axes`` for this dim only if they divide it evenly, else None."""
    return axes if _divisible(dim, axes, mesh) else None


def param_rules(cfg, mesh):
    """Ordered (regex, fn(shape) -> P) rules."""
    dp, tp, fsdp = _axes(mesh, cfg)

    def embed(shape):
        lead = (None,) * (len(shape) - 2)
        return P(*lead, _maybe(shape[-2], tp, mesh),
                 _maybe(shape[-1], fsdp, mesh))

    def head(shape):
        lead = (None,) * (len(shape) - 2)
        return P(*lead, _maybe(shape[-2], fsdp, mesh),
                 _maybe(shape[-1], tp, mesh))

    def col(shape):   # (in, out) -> out on tp  (wq/wk/wv/wi/wg/in_proj...)
        return P(_maybe(shape[0], fsdp, mesh), _maybe(shape[1], tp, mesh))

    def row(shape):   # (in, out) -> in on tp   (wo/out_proj/cm_wv...)
        return P(_maybe(shape[0], tp, mesh), _maybe(shape[1], fsdp, mesh))

    def bias_tp(shape):
        return P(_maybe(shape[0], tp, mesh))

    def expert_col(shape):  # (E, D, F)
        return P(_maybe(shape[0], tp, mesh), _maybe(shape[1], fsdp, mesh),
                 None)

    def expert_row(shape):  # (E, F, D)
        return P(_maybe(shape[0], tp, mesh), None,
                 _maybe(shape[2], fsdp, mesh))

    def repl(shape):
        return P()

    return [
        (r"embed/table$", embed),
        (r"lm_head/w$", head),
        (r"(attn/(wq|wk|wv)|mlp/(wi|wg)|shared/(wi|wg)|rwkv/(wr|wk|wv|wg|"
         r"cm_wk|cm_wr)|mamba/in_proj)/w$", col),
        (r"(attn/wo|mlp/wo|shared/wo|rwkv/(wo|cm_wv)|mamba/out_proj)/w$", row),
        (r"(attn/(wq|wk|wv)|mlp/(wi|wg)|mamba/in_proj)/b$", bias_tp),
        (r"moe/(wi|wg)$", expert_col),
        (r"moe/wo$", expert_row),
        (r"moe/router$", repl),
        (r"mamba/conv_w$", lambda s: P(None, _maybe(s[1], tp, mesh))),
        (r"mamba/conv_b$", bias_tp),
        (r"mamba/x_proj/w$", lambda s: P(_maybe(s[0], tp, mesh), None)),
        (r"mamba/dt_proj/w$", lambda s: P(None, _maybe(s[1], tp, mesh))),
        (r"mamba/dt_proj/b$", bias_tp),
        (r"mamba/A_log$", lambda s: P(_maybe(s[0], tp, mesh), None)),
        (r"mamba/D$", bias_tp),
        (r"rwkv/mix_w1$", lambda s: P(_maybe(s[0], fsdp, mesh), None)),
        (r".*", repl),
    ]


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nest of dicts, lists and tuples, the path
    the keys and indices as strings; specs (:class:`P`) are leaves."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def path_str(path) -> str:
    return "/".join(path)


def leaves_with_path(tree) -> List[Tuple[str, Any]]:
    """(path string, leaf) of every leaf of ``tree``, in its order."""
    out = []
    tree_map_with_path(lambda path, leaf: out.append((path_str(path), leaf)),
                       tree)
    return out


def param_specs(cfg, mesh, params_shape):
    """The spec tree of a params (shape) tree."""
    rules = param_rules(cfg, mesh)

    def one(path, leaf):
        ps = path_str(path)
        shape = tuple(leaf.shape)
        stacked = ps.startswith("blocks/")
        eff_shape = shape[1:] if stacked else shape
        for pat, fn in rules:
            if re.search(pat, ps):
                spec = fn(eff_shape)
                break
        return P(None, *spec) if stacked else spec

    return tree_map_with_path(one, params_shape)


def batch_specs(cfg, mesh, batch_shape):
    """The batch dim over the data axes where they divide it."""
    dp, _, _ = _axes(mesh, cfg)

    def one(path, leaf):
        return P(_maybe(leaf.shape[0], dp, mesh),
                 *([None] * (len(leaf.shape) - 1)))

    return tree_map_with_path(one, batch_shape)


def cache_specs(cfg, mesh, cache_shape):
    """Decode caches: KV sequence over 'model' (split-K decode), states
    over tp."""
    dp, tp, _ = _axes(mesh, cfg)

    def one(path, leaf):
        ps = path_str(path)
        shape = tuple(leaf.shape)
        stacked = ps.startswith("blocks/")
        s = shape[1:] if stacked else shape
        if "wkv" in ps:                       # (B, H, hs, hs)
            spec = P(_maybe(s[0], dp, mesh), _maybe(s[1], tp, mesh), None,
                     None)
        elif "shift" in ps:                   # (B, 1, d)
            spec = P(_maybe(s[0], dp, mesh), None, None)
        elif len(s) == 4:                     # attn kv (B, L, KH, dh)
            spec = P(_maybe(s[0], dp, mesh), _maybe(s[1], tp, mesh), None,
                     None)
        elif len(s) == 3:                     # mamba states
            if s[2] <= 64:                    # (B, di, ds) ssm state
                spec = P(_maybe(s[0], dp, mesh), _maybe(s[1], tp, mesh),
                         None)
            else:                             # (B, dc-1, di) conv state
                spec = P(_maybe(s[0], dp, mesh), None,
                         _maybe(s[2], tp, mesh))
        else:
            spec = P(*([None] * len(s)))
        return P(None, *spec) if stacked else spec

    return tree_map_with_path(one, cache_shape)


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh
# ---------------------------------------------------------------------------

def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh axis:
    ``Shard(d)`` where tensor dim d's entry names the axis, else
    ``Replicate()``; an axis of one device splits nothing and is
    ``Replicate()`` (DTensor cannot merge a dim "split" over it with
    another).  A dim split over several axes takes them in mesh order
    (DTensor's order), which is the order the rules write them."""
    from torch.distributed.tensor import Replicate, Shard
    dims = {}
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        order = [mesh.axis_names.index(a) for a in axes]
        if order != sorted(order) or any(a in dims for a in axes):
            raise ValueError(f"spec {spec} splits a dim over axes out of "
                             f"mesh order {mesh.axis_names}, or one axis "
                             f"twice")
        dims.update({a: d for a in axes})
    return tuple(Shard(dims[a]) if a in dims and mesh.shape[a] > 1
                 else Replicate() for a in mesh.axis_names)


def device_mesh(mesh):
    """The ``torch.distributed`` ``DeviceMesh`` of ``mesh``, over the
    default process group, which must have the mesh's size
    (``context.device_mesh``, made once a group)."""
    return dctx.device_mesh(mesh)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec placed on a ``DeviceMesh`` (``jax.sharding.NamedSharding``'s
    twin)."""
    mesh: Any                    # torch.distributed DeviceMesh
    spec: P
    placements: tuple

    def distribute(self, tensor: torch.Tensor):
        """``tensor`` as a DTensor of this sharding (a meta tensor gives
        the shard's shape and moves nothing)."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(tensor, self.mesh, list(self.placements))

    def shard_shape(self, shape, dtype=torch.float32) -> tuple:
        """This process's shard of a tensor of ``shape`` (every device's:
        the rules split dims evenly)."""
        t = torch.empty(tuple(shape), dtype=dtype, device="meta")
        return tuple(self.distribute(t).to_local().shape)


def to_named(mesh, spec_tree, dmesh=None):
    """A :class:`NamedSharding` a spec of ``spec_tree``, on ``mesh``'s
    ``DeviceMesh`` (``dmesh``, or one made by :func:`device_mesh`)."""
    dmesh = dmesh if dmesh is not None else device_mesh(mesh)
    return tree_map_with_path(
        lambda _, s: NamedSharding(dmesh, s, placements(s, mesh)), spec_tree)


def distribute(tree, named_tree):
    """``tree`` with every leaf a DTensor of its :class:`NamedSharding` in
    ``named_tree`` (a meta leaf gives a meta block and moves nothing):
    the sharded step's arguments, as ``jax.jit``'s ``in_shardings``
    place them."""
    named = dict(leaves_with_path(named_tree))
    return tree_map_with_path(
        lambda path, leaf: named[path_str(path)].distribute(leaf), tree)


def split_axes(x: torch.Tensor, dim: int) -> List[int]:
    """The mesh dims of several devices over which DTensor ``x`` splits
    tensor dim ``dim`` (none for a plain tensor)."""
    dim %= max(x.ndim, 1)
    return [axis for axis, p in enumerate(getattr(x, "placements", ()))
            if p.is_shard(dim) and x.device_mesh.size(axis) > 1]


def sharded_axis(x: torch.Tensor, dim: int):
    """The mesh dim of several devices over which DTensor ``x`` splits
    tensor dim ``dim`` (the first, if several), or None: none does, or
    ``x`` is no DTensor."""
    axes = split_axes(x, dim)
    return axes[0] if axes else None


def chunk_ranges(n: int, parts: int) -> List[Tuple[int, int]]:
    """``torch.chunk``'s blocks of ``n`` over ``parts``, (start, stop) a
    part, as DTensor shards an uneven dim: blocks of ``ceil(n / parts)``,
    the last ones shorter or empty (15 over 16: fifteen of 1 and one of
    0; 40 over 16: thirteen of 3, one of 1 and two of 0)."""
    c = -(-n // parts)
    return [(min(r * c, n), min((r + 1) * c, n)) for r in range(parts)]


def _overlap(a, b) -> Tuple[int, int]:
    lo = max(a[0], b[0])
    return lo, max(lo, min(a[1], b[1]))


def holds(have, want) -> bool:
    """Whether a block of the columns ``have`` holds the columns
    ``want`` (an empty range is held anywhere)."""
    return want[1] <= want[0] or have[0] <= want[0] and want[1] <= have[1]


def _take(block: torch.Tensor, dim: int, lo: int, part) -> torch.Tensor:
    a, b = part
    return block.narrow(dim, a - lo if b > a else 0, b - a)


def move_blocks(block: torch.Tensor, dim: int, have, want, group,
                rank: int) -> torch.Tensor:
    """The columns ``want[rank]`` of dim ``dim`` of a global tensor whose
    columns ``have[rank]`` this rank holds as ``block``, every rank of
    ``group`` taking part: ``have`` partitions the dim in rank order,
    ``want`` gives each rank a range (ranges may overlap), and each rank
    sends every other the part of its block that the other wants, by one
    all-to-all of uneven splits (none where every rank holds what it
    wants).  Its gradient goes back the same way."""
    dim %= block.ndim
    lo = have[rank][0]
    if all(holds(h, w) for h, w in zip(have, want)):
        return _take(block, dim, lo, want[rank]).contiguous()
    sends = [_overlap(have[rank], w) for w in want]
    recvs = [_overlap(want[rank], h) for h in have]
    return send_pieces([_take(block, dim, lo, part) for part in sends],
                       [b - a for a, b in recvs], dim, group)


def send_pieces(pieces, recv, dim: int, group) -> torch.Tensor:
    """Each rank of ``group`` sends ``pieces[p]`` to rank p and receives
    ``recv[p]`` entries of dim ``dim`` from rank p (pieces to and from
    ranks outside an exchange empty), by one all-to-all of uneven splits;
    the pieces received, concatenated on ``dim`` in rank order.  Its
    gradient goes back the same way."""
    import torch.distributed._functional_collectives as fc
    dim %= pieces[0].ndim
    out = torch.cat(pieces, dim)
    out = dctx._wait(fc.all_to_all_single_autograd(
        out.movedim(dim, 0).contiguous(), list(recv),
        [t.shape[dim] for t in pieces], group))
    return out.movedim(0, dim).contiguous()


def heads_view(x: torch.Tensor, dim: int, shape):
    """``x`` viewed as ``shape``, which splits dim ``dim`` into (heads,
    width) or merges dims ``dim`` and ``dim + 1`` (heads, width) into
    one.  A DTensor whose heads or merged dim a mesh dim of several
    devices splits keeps that split, in whole heads: the head view has
    ``torch.chunk``'s blocks of the heads (15 heads over 16 devices: one
    a device, the last device none), the merged view the even blocks a
    projection's output has, and the columns each device lacks move
    between neighbours (:func:`move_blocks`: an all-to-all of uneven
    splits, none where the blocks already agree); the gradient moves
    back the same way.  Anything else is reshaped as it is."""
    dim %= x.ndim
    shape = tuple(shape)
    split = len(shape) == x.ndim + 1
    axes = split_axes(x, dim)
    if not axes:
        return x.reshape(shape)
    if len(axes) > 1 or (not split and split_axes(x, dim + 1)):
        raise ValueError(f"heads of {tuple(x.shape)} split over mesh dims "
                         f"{axes}: a head view keeps one")
    from torch.distributed.tensor import DTensor, Shard
    dmesh, axis = x.device_mesh, axes[0]
    n, rank = dmesh.size(axis), dmesh.get_local_rank(axis)
    heads, width = shape[dim:dim + 2] if split else x.shape[dim:dim + 2]
    flat = chunk_ranges(heads * width, n)
    whole = [(a * width, b * width) for a, b in chunk_ranges(heads, n)]
    have, want = (flat, whole) if split else (whole, flat)
    block = x.to_local()
    if not split:
        block = block.flatten(dim, dim + 1)
    block = move_blocks(block, dim, have, want, dmesh.get_group(axis), rank)
    if split:
        a, b = want[rank]
        block = block.unflatten(dim, ((b - a) // width, width))
    shift = 1 if split else -1
    place = [Shard(dim) if i == axis else
             Shard(p.dim + shift) if p.is_shard() and p.dim > dim else p
             for i, p in enumerate(x.placements)]
    return DTensor.from_local(block, dmesh, place,
                              shape=torch.Size(shape),
                              stride=make_contiguous_strides_for(shape))


def gather_ranges(x: torch.Tensor, dim: int, want, axis: int):
    """This device's block of DTensor ``x`` with dim ``dim`` made the
    global range ``want[r]``, r the device's coordinate on mesh dim
    ``axis`` (ranges may overlap): a plain tensor, every other dim the
    block ``x`` has.  ``x``'s dim split over ``axis`` moves by
    :func:`move_blocks`; whole there, each device narrows it (and the
    gradient is summed over the axis)."""
    from torch.distributed.tensor import Partial, Replicate
    dmesh = x.device_mesh
    others = [a for a in split_axes(x, dim) if a != axis]
    if others:
        x = x.redistribute(dmesh, [Replicate() if a in others else p
                                   for a, p in enumerate(x.placements)])
    rank = dmesh.get_local_rank(axis)
    if axis not in split_axes(x, dim):
        # each device reads its own range: the gradient of the whole is
        # their sum over the axis
        block = x.to_local(grad_placements=[
            Partial() if a == axis else p
            for a, p in enumerate(x.placements)])
        return _take(block, dim, 0, want[rank]).contiguous()
    have = chunk_ranges(x.shape[dim], dmesh.size(axis))
    return move_blocks(x.to_local(), dim, have, want, dmesh.get_group(axis),
                       rank)


def on_blocks(fn, like: torch.Tensor, args, outs):
    """``fn(*blocks)`` on each device's blocks, as ``shard_map`` over the
    batch and the heads.  ``like``, a DTensor with the batch at dim 0 and
    the heads at dim 2, names the layout: each mesh dim that splits its
    batch or its heads splits every argument's (``args``: (tensor, batch
    dim or None, heads dim or None)), and each other dim is made whole.
    An argument without a batch (heads) dim is whole on the mesh dims
    that split the batch (heads), and its gradient is a partial sum
    there.  ``outs`` gives each result's (global shape, batch dim, heads
    dim), None again whole: the results are DTensors of the blocks ``fn``
    returns (one, or a tuple)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dmesh = like.device_mesh
    roles = [0 if p.is_shard(0) else 2 if p.is_shard(2) else None
             for p in like.placements]

    def place(batch, heads):
        return [Shard(batch) if role == 0 and batch is not None
                else Shard(heads) if role == 2 and heads is not None
                else Replicate() for role in roles]

    blocks = []
    for t, batch, heads in args:
        want = place(batch, heads)
        blocks.append(t.redistribute(dmesh, want).to_local(grad_placements=[
            Partial() if p.is_replicate() and role is not None else p
            for p, role in zip(want, roles)]))
    got = fn(*blocks)
    single = not isinstance(got, tuple)
    got = (got,) if single else got
    wrapped = tuple(DTensor.from_local(
        block, dmesh, place(batch, heads), shape=torch.Size(shape),
        stride=make_contiguous_strides_for(shape))
        for block, (shape, batch, heads) in zip(got, outs))
    return wrapped[0] if single else wrapped


def block_of(x: torch.Tensor, place) -> torch.Tensor:
    """This device's block of DTensor ``x`` under the placements
    ``place``, a plain tensor: where ``x`` is whole on a mesh dim that
    ``place`` splits, each device narrows its own block, a local slice,
    and the gradient is a partial sum over that dim (the block's, zeros
    elsewhere), with no collective; every other mesh dim must place
    ``x`` as ``place`` does."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_box
    dmesh = x.device_mesh
    narrowed = [i for i, (p, q) in enumerate(zip(x.placements, place))
                if p.is_replicate() and q.is_shard() and dmesh.size(i) > 1]
    if any(p != q for i, (p, q) in enumerate(zip(x.placements, place))
           if i not in narrowed and dmesh.size(i) > 1):
        raise ValueError(f"block_of: {x.placements} to {place} splits "
                         f"nothing new")
    block = x.to_local(grad_placements=[
        Partial() if i in narrowed else p
        for i, p in enumerate(x.placements)])
    have_len, have_at = local_box(x.shape, dmesh, x.placements)
    want_len, want_at = local_box(x.shape, dmesh, list(place))
    for d, (n, a, b) in enumerate(zip(want_len, want_at, have_at)):
        if n != block.shape[d]:
            block = block.narrow(d, a - b, n)
    return block


class _GatherBlocks(torch.autograd.Function):
    """This device's block of dim ``dim`` gathered over ``groups`` (the
    innermost mesh dim's first, so the blocks join in mesh order); the
    backward hands each device its own block of a gradient every device
    holds whole and alike (``at``: the block's index), with no
    collective."""

    @staticmethod
    def forward(ctx, y, dim, groups, at):
        import torch.distributed._functional_collectives as fc
        # all_gather_single is all_gather_tensor's newer name
        gather = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor
        ctx.dim, ctx.width, ctx.at = dim, y.shape[dim], at
        for group in reversed(groups):
            y = dctx._wait(gather(y.contiguous(), dim, group))
        return y

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.at * ctx.width, ctx.width).contiguous(),
                None, None, None)


def gather_blocks(y: torch.Tensor, dim: int, groups, at: int):
    """``y``, this device's block ``at`` of dim ``dim``, gathered over the
    process ``groups`` of mesh dims (outermost first); the gradient, held
    whole and alike on every device, comes back as this block's, with no
    collective."""
    return _GatherBlocks.apply(y, dim, groups, at)


class _FromBlock(torch.autograd.Function):
    """``DTensor.from_local(block, dmesh, place)`` whose backward
    redistributes the cotangent to the placements ``grad`` and hands back
    its block; where ``grad`` is a partial sum, a whole cotangent is made
    one by a local division (DTensor's own redistribution declines it)."""

    @staticmethod
    def forward(ctx, block, dmesh, place, grad, shape):
        from torch.distributed.tensor import DTensor
        ctx.grad = grad
        return DTensor.from_local(block, dmesh, place, shape=shape,
                                  stride=make_contiguous_strides_for(shape))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        kept = [w.is_partial() and (p.is_partial() or p.is_replicate())
                for p, w in zip(g.placements, ctx.grad)]
        want = [p if keep else Replicate() if w.is_partial() else w
                for p, w, keep in zip(g.placements, ctx.grad, kept)]
        if list(g.placements) != want:
            g = g.redistribute(g.device_mesh, want)
        whole = math.prod(g.device_mesh.size(i) for i, w in enumerate(ctx.grad)
                          if w.is_partial() and want[i].is_replicate())
        block = g.to_local()
        return (block / whole if whole > 1 else block), None, None, None, \
            None


def idle_dims(x: torch.Tensor) -> List[int]:
    """The mesh dims of several devices other than "model" on which
    DTensor ``x`` is whole (a batch that does not split over them)."""
    dmesh = x.device_mesh
    return [i for i, p in enumerate(x.placements)
            if p.is_replicate() and dmesh.size(i) > 1
            and dmesh.mesh_dim_names[i] != "model"]


def share_of(dmesh, dims, width: int):
    """Of the mesh dims ``dims``, those (innermost first) whose product
    divides ``width``, this device's index in their product (mesh order)
    and that product: how ``width`` columns split over them."""
    chosen, n = [], 1
    for i in reversed(dims):
        if width % (n * dmesh.size(i)) == 0:
            chosen.insert(0, i)
            n *= dmesh.size(i)
    at = 0
    for i in chosen:
        at = at * dmesh.size(i) + dmesh.get_local_rank(i)
    return chosen, at, n


def _plan(x, w):
    """The role of each mesh dim in ``x @ w`` (:func:`placed_matmul`),
    and the weight's placements for the product; None where a pair of
    placements has no role here."""
    from torch.distributed.tensor import Replicate, Shard
    dmesh = x.device_mesh
    last = x.ndim - 1
    kinds, gather = [], list(w.placements)
    for i, (px, pw) in enumerate(zip(x.placements, w.placements)):
        if any(not p.is_replicate() and type(p) is not Shard
               for p in (px, pw)):
            return None                 # partial sums, strided shards
        if dmesh.size(i) == 1:
            kind = "one"
        elif px.is_shard() and px.dim != last:
            kind = "batch"
            if pw.is_shard():
                gather[i] = Replicate()             # FSDP: gathered here
        elif px.is_replicate() and pw.is_shard(1):
            kind = "col"
        elif px.is_shard(last) and pw.is_shard(0):
            kind = "row"
        elif px.is_replicate() and pw.is_shard(0):
            kind = "contract"
        elif px.is_replicate() and pw.is_replicate():
            kind = "whole" if dmesh.mesh_dim_names[i] == "model" else "idle"
        else:
            return None
        kinds.append(kind)
    return kinds, gather


def placed_matmul(x: torch.Tensor, w: torch.Tensor, product):
    """``x @ w`` as ``product(x_block, w_block)`` on each device's blocks
    of DTensors ``x`` (..., K) and ``w`` (K, N), every placement written
    down in both directions (Megatron's f and g: ``to_local``'s gradient
    placements, ``from_local``'s output placements, whose backward
    redistributes the cotangent to them), never left to DTensor's
    propagation, which for a cotangent that is a partial sum over "model"
    gathers a row-split weight whole.  Each mesh dim of several devices
    plays one role:

      batch     x split on a dim before K, w whole there (split by FSDP:
                gathered first, its gradient reduce-scattered back): y
                split alike, dw a partial sum over the dim
      col       x whole, w split on N: y split on N, dx a partial sum
      row       x split on K, w split on K: y a partial sum, which the
                caller reduces; its cotangent is reduced once (to whole)
                in the backward
      contract  x whole, w split on K (FSDP at a batch that does not
                split): x's block of K, y and dx partial sums
      idle      x and w whole on a data axis (a batch that does not
                split): w's block of N split over it, a local slice, and
                the smaller product's output gathered; dx and dw partial
                sums
      whole     x and w whole on "model" (or on a data axis whose split
                would not divide w's block of N): the product on every
                device, dx and dw partial sums

    Returns None (the caller takes DTensor's own product) where a
    placement plays none of these roles, or the mesh has one device."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_box
    if (not isinstance(x, DTensor) or not isinstance(w, DTensor)
            or x.ndim < 2 or w.ndim != 2 or x.device_mesh != w.device_mesh
            or x.device_mesh.size() == 1):
        return None
    plan = _plan(x, w)
    if plan is None:
        return None
    kinds, gather = plan
    dmesh = x.device_mesh
    if "contract" in kinds:
        # x's columns of the weight block's rows of K
        _, x_at = local_box(x.shape, dmesh, x.placements)
        w_len, w_at = local_box(w.shape, dmesh, w.placements)
        lo = w_at[0] - x_at[-1]
        if lo < 0 or lo + w_len[0] > x.to_local().shape[-1]:
            return None
    if gather != list(w.placements):
        w = w.redistribute(dmesh, gather)
    idle, at, n_idle = share_of(
        dmesh, [i for i, k in enumerate(kinds) if k == "idle"],
        w.to_local().shape[1])
    kinds = ["whole" if k == "idle" and i not in idle else k
             for i, k in enumerate(kinds)]
    part = Partial()
    x_grad = {"col": part, "contract": part, "idle": part, "whole": part}
    w_grad = {"batch": part, "idle": part, "whole": part}
    xl = x.to_local(grad_placements=[x_grad.get(k, p) for k, p in
                                     zip(kinds, x.placements)])
    wl = w.to_local(grad_placements=[w_grad.get(k, p) for k, p in
                                     zip(kinds, w.placements)])
    if "contract" in kinds:
        xl = xl.narrow(-1, lo, w_len[0])
    if idle:
        width = wl.shape[1] // n_idle
        y = product(xl, wl.narrow(1, at * width, width))
        y = gather_blocks(y, y.ndim - 1, [dmesh.get_group(i) for i in idle],
                          at)
    else:
        y = product(xl, wl)
    out = {"col": Shard(y.ndim - 1), "row": part, "contract": part}
    place = [px if k == "batch" else out.get(k, Replicate())
             for k, px in zip(kinds, x.placements)]
    # the cotangent: a partial sum is reduced where the product needs it
    # whole (row, contract: once, Megatron's g), and made one where the
    # product is whole on "model", so that dx and dw are partial sums
    # there (a local division where it arrives whole, never a reduction
    # of activations)
    grad = [part if k == "whole" else Replicate() if p.is_partial() else p
            for k, p in zip(kinds, place)]
    shape = torch.Size(tuple(x.shape[:-1]) + (w.shape[1],))
    return _FromBlock.apply(y, dmesh, place, grad, shape)


def built_like(make, shape, like: torch.Tensor, dims=None):
    """``make(shape)``: a tensor of the global ``shape`` that the step
    builds (zeros, a fill, positions).  Beside a DTensor ``like``, each
    device builds only its block: dim d of the new tensor is split as
    ``like``'s dim ``dims[d]`` is (``dims``: new dim -> ``like``'s dim,
    default each dim to itself), its block the same fraction of d, and
    every other dim is whole; the result is a DTensor on ``like``'s mesh
    (``implicit_replication`` would build the whole tensor on every
    device and cut each block out).  Beside a plain tensor, ``make(shape)``
    as it is."""
    if not hasattr(like, "placements"):
        return make(tuple(shape))
    from torch.distributed.tensor import DTensor, Replicate
    dims = dict(dims if dims is not None else
                {d: d for d in range(min(len(shape), like.ndim))})
    block = like.to_local().shape
    local = list(shape)
    for d, ld in dims.items():
        local[d] = shape[d] * block[ld] // like.shape[ld]
    to_new = {ld: d for d, ld in dims.items()}
    place = [type(p)(to_new[p.dim]) if p.is_shard() and p.dim in to_new
             and like.device_mesh.size(axis) > 1 else Replicate()
             for axis, p in enumerate(like.placements)]
    return DTensor.from_local(make(tuple(local)), like.device_mesh, place,
                              shape=torch.Size(shape),
                              stride=make_contiguous_strides_for(shape))


def carry_placed(step, carry):
    """``step`` of a scan (``carry, y = step(carry, t)``), its new carry
    redistributed to the placements a DTensor ``carry`` entered with
    where the step moved them, as ``lax.scan`` keeps a carry's sharding
    across its iterations; beside a plain ``carry``, ``step`` as it
    is."""
    want = getattr(carry, "placements", None)
    if want is None:
        return step

    def placed(c, t):
        c, y = step(c, t)
        if c.placements != want:
            c = c.redistribute(carry.device_mesh, list(want))
        return c, y
    return placed


def write_position(cache: torch.Tensor, idx: int, new: torch.Tensor):
    """``cache[:, idx:idx + 1] = new`` in place (a decode step's KV
    write).  A DTensor cache whose positions (dim 1) are split over a
    mesh dim of several devices is written as XLA partitions the update:
    every device places ``new`` as the cache with that mesh dim
    replicated (a collective all take part in) and writes one position
    of its block, the new value where the block holds ``idx`` and its
    own old value elsewhere; the blocks are never gathered."""
    axis = sharded_axis(cache, 1)
    if axis is None:
        cache[:, idx:idx + 1] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate
    dmesh = cache.device_mesh
    place = list(cache.placements)
    place[axis] = Replicate()
    block = cache.to_local()
    n = block.shape[1]
    j = idx - dmesh.get_local_rank(axis) * n
    at = min(max(j, 0), n - 1)
    new = new.redistribute(dmesh, place).to_local()
    block[:, at:at + 1] = (new if 0 <= j < n
                           else block[:, at:at + 1]).to(block.dtype)


class _GradPlaced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, list(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if list(g.placements) == ctx.placements:
            return g
        return g.redistribute(ctx.mesh, ctx.placements)


def grad_placed(x: torch.Tensor):
    """``x``, whose gradient is placed as ``x`` is before it flows on: a
    sum's gradient comes back replicated, and the ops before the sum
    would run on the whole of it on every device; a parameter's comes
    back partial over the devices that split the batch, and is summed
    into the parameter's placements, as XLA matches a gradient to its
    parameter's sharding.  Plain tensors pass as they are."""
    if not hasattr(x, "placements"):
        return x
    return _GradPlaced.apply(x)


def constrain(x: torch.Tensor, logical: tuple):
    """The in-model sharding constraint; ``logical`` entries 'dp', 'tp',
    'sp' or None, one a dim of ``x``.  The identity without a mesh, on a
    mesh of one device and where the ranks differ (as in ``repro``);
    else ``x``, a DTensor, redistributed to the spec (a plain tensor on a
    mesh of several devices raises: distribute it first)."""
    mesh = dctx.current_mesh()
    if mesh is None or mesh.size == 1 or x.ndim != len(logical):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain on a mesh of {mesh.size} devices needs "
                        f"a DTensor, got a {type(x).__name__}")
    table = {"dp": dctx.data_axes(mesh), "tp": "model", "sp": "model",
             None: None}
    spec = P(*(table[lg] if _divisible(dim, table[lg], mesh) else None
               for dim, lg in zip(x.shape, logical)))
    return x.redistribute(x.device_mesh, list(placements(spec, mesh)))


# ---------------------------------------------------------------------------
# Chip-tier serving: replicas of the artifact, frames scattered
# ---------------------------------------------------------------------------

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
