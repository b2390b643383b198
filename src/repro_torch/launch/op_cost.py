"""FLOPs, bytes and peak live memory of a step, counted op by op.

The counterpart of ``repro.launch.hlo_cost``: where ``repro`` parses the
optimized HLO text of a compiled step, :func:`count` runs the step under
a ``TorchDispatchMode`` and charges every aten op it reaches, the
backward's included.  On meta tensors (``configs/shapes.py``'s input
specs, ``init_params(device="meta")``, ``steps.state_shape``) nothing is
allocated, so a full-width cell counts on any host; on CPU or CUDA
tensors the same step gives the same numbers, because every charge is
read from shapes, strides and types alone.

Counted per op (``hlo_cost``'s conventions, where they carry over):

  flops:
    matmuls, convolutions  ``torch.utils.flop_counter``'s formulas
                           (2 * out * K), and the flash-attention op
                           ``repro_torch::flash_attention`` by the formula
                           it registers there
    pointwise              1 a output element (``torch.Tag.pointwise``;
                           transcendentals too)
    reductions             1 a input element (``torch.Tag.reduction``)
    sort, topk             n log2 n over the output elements
    copies, casts, gathers, scatters, fills
                           0 (bytes only)
    views, no-data factories (``empty``)
                           free: no flops, no bytes
    anything else          1 a output element (``hlo_cost``'s default)
  bytes:
    the operands' bytes plus the outputs' bytes of each op.  A tensor is
    charged the bytes of its storage that it spans (from its sizes and
    strides), not its element count, so a broadcast (``expand``) view
    costs what is stored, and a slice of a stack its slice.  A
    destination an op only writes (``copy_``, ``fill_``, random fills) is
    charged once, as output.

What has no counterpart: every eager op is its own kernel, so
``hlo_cost``'s fusion rule (a fusion charged at its call site, its inner
traffic free) does not apply.

Trip counts: an eager loop runs, and is charged, every iteration, except
a loop written with :func:`scan` on meta tensors under the counter.
There ``hlo_cost``'s rule for a scanned body (``repro/launch/hlo_cost.py``
``_trip_count``: one body, scaled by the trip count) becomes: the first
and the last two iterations run as they are, and one middle iteration
runs with its charges scaled by n - 3, its backward too.  Charges depend
on shapes alone, and the middle iterations are alike: each takes the
carry at its steady shape, and in the backward each gets both a carry's
and an output's gradient and adds its share to every gradient the later
iterations started (the last iteration's carry may have no gradient, so
the one before it may start one: hence two at the end).  So the count
equals the eager one exactly, and the outputs keep their full shapes.  On CPU or CUDA tensors, or with no counter, :func:`scan` is the
plain loop.

Collectives: the ``c10d`` and ``_c10d_functional`` ops a step issues over
a ``torch.distributed`` group are charged their bytes as any op, no
FLOPs, and wire bytes a card by ``hlo_cost``'s ring rules with n the
group's size: all-gather out * (n-1)/n, all-reduce 2 * bytes * (n-1)/n,
reduce-scatter in * (n-1)/n, all-to-all in * (n-1)/n, and a point-to-point
send (a collective-permute's share) its bytes.  An all-to-all of uneven
splits (``sharding.move_blocks``: blocks moved between two layouts of a
dim) is charged what this device sends to the others or receives from
them, the larger; at even splits that is the ring rule's.  A step on
one card issues none: ``coll_wire_bytes`` is 0 and ``coll_breakdown``
lists the five kinds at 0.  Inside :func:`collective_sites` the wire
bytes are also tallied by the frame that issued each collective.

DTensors (one device's share of a sharded step, ``dryrun --mesh``): an op
on DTensors is charged by the ops its DTensor dispatch runs on this
device's blocks, and the collectives its redistributions launch
(DTensor's ``_dtensor::shard_dim_alltoall`` an all-to-all) by the rules
above with n the mesh dim's size; never at the DTensor's global shape.
DTensor's sharding propagation runs ops no device runs (fake tensors of
the global shapes, an op's decomposition, the blocks' offsets on the
host), only where its cache misses: the counter charges nothing while
it runs.  ``argument_bytes``, ``output_bytes`` and ``peak_bytes`` are
the blocks'.  On plain tensors none of this applies.

``peak_bytes`` is the peak of live tensor bytes during the call: the
arguments' storages, then every storage an op creates, each counted from
its creation to its release.  A scaled :func:`scan` adds the bytes the
n - 4 iterations it does not run would hold: their outputs until the
loop's stack, and what each keeps for the backward until the backward
of the middle iteration has run (an upper bound on the eager peak, which
frees them one iteration at a time).  Under ``torch.utils.checkpoint``
they are kept as the iterations' own saved tensors are: not in the
forward, and from the recompute in the backward to the middle
iteration's backward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import traceback
import weakref
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import flash_attention as _fa  # noqa: F401
                                    # registers repro_torch::flash_attention

try:                                # torch built without distributed
    from torch.distributed.tensor import DTensor
except ImportError:                 # pragma: no cover
    DTensor = ()
from torch._subclasses.fake_tensor import FakeTensor

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

aten = torch.ops.aten

# allocate without writing: no flops, no bytes
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.lift_fresh, aten.detach, aten.alias,
         aten._unsafe_view, aten.set_, aten.resize_}
# copies, casts, gathers, scatters and fills: bytes, no flops
_MOVE = {aten._to_copy, aten.copy_, aten.clone, aten.cat, aten.stack,
         aten.constant_pad_nd, aten.slice_scatter, aten.select_scatter,
         aten.as_strided_scatter, aten.index, aten._unsafe_index,
         aten.index_select, aten.gather, aten.embedding, aten.scatter,
         aten.scatter_, aten.scatter_add, aten.scatter_add_, aten.index_put,
         aten.index_put_, aten._index_put_impl_, aten.index_add,
         aten.index_add_, aten.embedding_dense_backward, aten.zeros,
         aten.zeros_like, aten.ones, aten.ones_like, aten.full,
         aten.full_like, aten.new_zeros, aten.new_ones, aten.new_full,
         aten.scalar_tensor, aten.arange, aten.fill_, aten.zero_,
         aten.repeat, aten.expand_copy, aten.lift_fresh_copy}
# the destination is written, not read: charged once, as output
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_, aten.normal_,
               aten.uniform_, aten.exponential_, aten.bernoulli_,
               aten.random_}
_SORTS = {aten.sort, aten.topk}
# the collective ops' namespaces, and each kind by a word of the op's name
# (``c10d::allreduce_``, ``_c10d_functional::all_to_all_single``,
# DTensor's ``_dtensor::shard_dim_alltoall``, ...)
_COLL_NAMESPACES = ("c10d", "_c10d_functional", "_dtensor")
_COLL_HANDS_BACK = ("wait_tensor", "_wrap_tensor_autograd")
_COLL_KINDS = (("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
               ("allgather", "all-gather"), ("all_gather", "all-gather"),
               ("reduce_scatter", "reduce-scatter"),
               ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
               ("send", "collective-permute"))


@dataclasses.dataclass
class ModuleCost:
    flops: float               # per card
    bytes: float               # per card, bytes accessed
    coll_wire_bytes: float     # per card, ring wire bytes (0 on one card)
    coll_breakdown: Dict[str, float]
    peak_bytes: float          # peak live tensor bytes, arguments included
    argument_bytes: float = 0.0    # the arguments' storages
    output_bytes: float = 0.0      # the result's storages


def span_bytes(t: torch.Tensor) -> int:
    """Bytes of storage a tensor spans: 1 + sum((size - 1) * |stride|)
    elements, 0 when it has none."""
    if t.numel() == 0:
        return 0
    elems = 1 + sum((n - 1) * abs(st) for n, st in zip(t.shape, t.stride()))
    return elems * t.element_size()


def _tensors(tree, out=None):
    """The tensors of ``tree`` (an op's arguments or results: tensors in
    tuples, lists and dicts), in ``tree_flatten``'s order; a functional
    collective's result, an ``AsyncCollectiveTensor``, as the tensor it
    wraps."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(getattr(tree, "elem", tree) if type(tree).__name__ ==
                   "AsyncCollectiveTensor" else tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's block on this rank; any other tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Live:
    """Live tensor bytes by storage, each released by a finalizer on its
    storage (which PyTorch keeps alive exactly as long as the tensors
    on it); the peak over the call."""

    def __init__(self):
        self.lock = threading.Lock()
        self.sizes: Dict[int, int] = {}
        self.live = 0
        self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        """Track ``t``'s storage, if not yet tracked."""
        storage = t.untyped_storage()
        key = storage._cdata
        with self.lock:
            if key in self.sizes:
                return
            self.sizes[key] = storage.nbytes()
            self.live += self.sizes[key]
            self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._release, key).atexit = False

    def _release(self, key: int) -> None:
        with self.lock:
            self.live -= self.sizes.pop(key, 0)

    def grow(self, nbytes: int) -> None:
        """Bytes no tensor here holds (a scaled :func:`scan`'s iterations
        that did not run), live until :meth:`shrink`."""
        with self.lock:
            self.live += nbytes
            self.peak = max(self.peak, self.live)

    def hold(self, t: torch.Tensor, nbytes: int) -> None:
        """Charge ``nbytes`` more to ``t``'s tracked storage: live until it
        is released."""
        key = _storage_key(t)
        with self.lock:
            self.sizes[key] += nbytes
            self.live += nbytes
            self.peak = max(self.peak, self.live)

    def shrink(self, nbytes: int) -> None:
        with self.lock:
            self.live -= nbytes


class _CountMode(TorchDispatchMode):
    def __init__(self, live: _Live):
        super().__init__()
        self.live = live
        self.paused = 0         # inside DTensor's sharding propagation
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = {k: 0.0 for k in COLLECTIVES}
        self.scale = 1          # a scaled scan's middle iteration: n - 3

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if DTensor and any(issubclass(t, DTensor) for t in types):
            # DTensor's own dispatch runs the op on the local blocks (and
            # launches the redistributions' collectives), each reaching
            # this mode: one device's charges
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if self.paused or any(isinstance(t, FakeTensor)
                              for t in ins + outs):
            # DTensor's sharding propagation (:func:`_propagation_free`):
            # no device runs it
            return out
        for t in outs:
            self.live.add(t)
        packet = func.overloadpacket
        if func.namespace in _COLL_NAMESPACES:
            self._collective(func, args, ins, outs)
            return out
        if packet in _FREE or not outs:
            return out
        mutated = func._schema.is_mutable
        in_keys = {_storage_key(t) for t in ins}
        if not mutated and all(_storage_key(t) in in_keys for t in outs):
            return out                       # a view: no data moves
        if packet in _WRITE_ONLY:
            ins = ins[1:]
        self.bytes += self.scale * (sum(span_bytes(t) for t in ins)
                                    + sum(span_bytes(t) for t in outs))
        self.flops += self.scale * _flops(func, packet, args, kwargs, out,
                                          ins, outs)
        return out

    def _collective(self, func, args, ins, outs) -> None:
        """A collective: its bytes, no FLOPs, and its wire bytes by the
        ring rules.  An op that only hands its input back (``wait_tensor``,
        the autograd wrapper: on meta tensors their outputs may take a
        storage of their own) moves nothing."""
        name = func._schema.name.split("::")[-1]
        if name in _COLL_HANDS_BACK:
            return
        kind = next((k for word, k in _COLL_KINDS if word in name), None)
        in_keys = {_storage_key(t) for t in ins}
        if kind is None and all(_storage_key(t) in in_keys for t in outs):
            return
        self.bytes += self.scale * (sum(span_bytes(t) for t in ins)
                                    + sum(span_bytes(t) for t in outs))
        if kind is None:
            return
        sites = _SITES[0]
        functional = func.namespace != "c10d"
        # c10d's in-place ops take (output, input, group, ...), except
        # allreduce_ and send, which take the tensors they send first;
        # the functional ones take their input first
        first = _tensors(args[0])
        second = _tensors(args[1]) if len(args) > 1 else []
        if kind == "collective-permute":
            wire = sum(span_bytes(t) for t in first)
        elif (name == "all_to_all_single" and functional and args[2]
              and len(set(args[2]) | set(args[1])) > 1):
            # uneven splits (blocks moved between layouts): what this
            # device sends to or receives from the others, the larger
            me = _group(args).rank()
            row = first[0].element_size() * math.prod(first[0].shape[1:])
            wire = row * max(sum(args[2]) - args[2][me],
                             sum(args[1]) - args[1][me])
        else:
            n = _group(args).size()
            ratio = (n - 1) / n if n > 1 else 0.0
            if kind == "all-reduce":
                moved = 2 * sum(span_bytes(t) for t in first)
            elif kind == "all-gather":
                moved = sum(span_bytes(t) for t in (outs if functional
                                                    else first))
            else:                   # reduce-scatter, all-to-all: the input
                moved = sum(span_bytes(t) for t in (first if functional
                                                    else second))
            wire = moved * ratio
        self.coll[kind] += self.scale * wire
        if sites is not None:
            key = (kind, _site(), tuple(first[0].shape) if first else (),
                   str(first[0].dtype) if first else "")
            got = sites.setdefault(key, [0, 0.0])
            got[0] += self.scale
            got[1] += self.scale * wire


_SITES = [None]        # collective_sites()'s table, while one is open


@contextlib.contextmanager
def collective_sites():
    """Within the block, every :func:`count` also tallies
    its collectives by where they were issued: a dict, filled as they
    run, of (kind, site, the first operand's shape, its dtype) ->
    [issues, wire bytes], scaled as the charges are.  The site is the
    innermost frame of the port's model or step code (else of any of the
    port's code), and in a backward the autograd node running."""
    prev, _SITES[0] = _SITES[0], {}
    try:
        yield _SITES[0]
    finally:
        _SITES[0] = prev


def _site() -> str:
    port = [f for f in traceback.extract_stack()
            if "repro_torch" in f.filename
            and not f.filename.endswith("op_cost.py")]
    model = [f for f in port if "/models/" in f.filename
             or "/train/" in f.filename]
    where = ""
    if model or port:
        f = (model or port)[-1]
        where = (f"{f.filename.split('repro_torch/')[-1]}:{f.lineno} "
                 f"{f.name}")
    node = torch._C._current_autograd_node()
    if node is not None:
        where += f" (backward: {node.name()})"
    return where


def _group(args):
    """The process group a collective's arguments name: a functional
    collective's group name, or c10d's ``ProcessGroup``."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, str) and dist.is_initialized():
            try:
                return dist.distributed_c10d._resolve_process_group(a)
            except (ValueError, RuntimeError, KeyError):
                continue
        if (isinstance(a, torch.ScriptObject)
                and "ProcessGroup" in a._type().qualified_name()):
            return dist.ProcessGroup.unbox(a)
    raise ValueError("a collective whose arguments name no process group")


def _flops(func, packet, args, kwargs, out, ins, outs) -> float:
    if packet in flop_registry:
        return float(flop_registry[packet](*args, **kwargs, out_val=out))
    if packet in _MOVE or packet in _WRITE_ONLY:
        return 0.0
    if packet in _SORTS:
        n = sum(t.numel() for t in outs)
        return n * max(1.0, math.log2(max(n, 2)))
    if torch.Tag.reduction in func.tags:
        return float(ins[0].numel()) if ins else 0.0
    # pointwise and the default: 1 a output element
    return float(sum(t.numel() for t in outs))


def _unique_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        key = _storage_key(t)
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def count(fn: Callable, *args, **kwargs) -> ModuleCost:
    """Run ``fn(*args, **kwargs)`` once under the counter (its backward
    too, where it calls one) and return its :class:`ModuleCost`; the
    result is dropped."""
    live = _Live()
    arg_tensors = [_local(t) for t in _tensors((args, kwargs))]
    for t in arg_tensors:
        live.add(t)
    argument = live.live
    mode = _CountMode(live)
    with mode, _propagation_free(mode):
        out = fn(*args, **kwargs)
    output = _unique_bytes([_local(t) for t in _tensors(out)])
    del out
    return ModuleCost(flops=mode.flops, bytes=mode.bytes,
                      coll_wire_bytes=sum(mode.coll.values()),
                      coll_breakdown=dict(mode.coll),
                      peak_bytes=float(live.peak),
                      argument_bytes=float(argument),
                      output_bytes=float(output))


_PROPAGATORS = ("propagate", "propagate_op_sharding",
                "propagate_op_sharding_non_cached")


@contextlib.contextmanager
def _propagation_free(mode: _CountMode):
    """While DTensor's sharding propagation runs, ``mode`` charges
    nothing: it runs ops that no device runs (an op's decomposition on
    tensors of the global shapes, the blocks' sizes and offsets on the
    host), and only where its cache misses, so charging them would make
    a count depend on what ran before it.  The propagator's entry points
    (whichever of ``_PROPAGATORS`` this torch has) are wrapped for the
    block."""
    prop = getattr(getattr(DTensor, "_op_dispatcher", None),
                   "sharding_propagator", None) if DTensor else None
    own = {}
    for name in _PROPAGATORS:
        fn = getattr(prop, name, None)
        if fn is None:
            continue
        own[name] = prop.__dict__.get(name)

        def paused(*args, _fn=fn, **kwargs):
            mode.paused += 1
            try:
                return _fn(*args, **kwargs)
            finally:
                mode.paused -= 1
        setattr(prop, name, paused)
    try:
        yield
    finally:
        for name, fn in own.items():
            if fn is None:
                delattr(prop, name)
            else:
                setattr(prop, name, fn)


# ---------------------------------------------------------------------------
# The loop construct the counter scales
# ---------------------------------------------------------------------------

def _counter():
    """The innermost :func:`count` open on this thread, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _CountMode):
            return mode
    return None


def scan(step: Callable, carry: torch.Tensor, n: int, dim: int = 0,
         xs=()):
    """``for t in range(n): carry, y_t = step(carry, t, *x_t)``; returns
    the last carry and the y_t stacked on ``dim``, x_t each of ``xs``'s
    slice t of ``dim``.  ``repro``'s ``lax.scan`` over an index and
    ``xs``, as a Python loop.  ``xs`` are split once (``unbind``), so
    their gradient is one stack of the slices' (a step that indexes a
    captured tensor itself makes a gradient of its whole shape a step).
    Under :func:`count` on meta tensors (n > 4), four iterations run: the
    first and the last two as they are, and one middle one whose charges,
    forward and backward, count n - 3 times (the module docstring says
    why that is exact): the middle iterations must be alike, so a step on
    a DTensor carry keeps its placements (``sharding.carry_placed``)."""
    mode = _counter()
    if mode is None or n <= 4 or carry.device.type != "meta":
        parts = [x.unbind(dim) for x in xs]
        ys = []
        for t in range(n):
            carry, y = step(carry, t, *(p[t] for p in parts))
            ys.append(y)
        return carry, torch.stack(ys, dim)
    return _scaled_scan(mode, step, carry, n, dim, xs)


def _scaled_scan(mode: _CountMode, step, carry, n: int, dim: int, xs=()):
    k = n - 3
    grad = torch.is_grad_enabled()
    # the four iterations' slices of xs: x_0, x_1 (the middle one's),
    # x_n-2 and x_n-1
    box = {"grown": False}
    at = list(zip(*[_Slices.apply(mode, box, dim, n, x) for x in xs])) or [
        ()] * 4
    carry, y0 = step(carry, 0, *at[0])
    # the bytes the iterations not run keep for the backward, charged to
    # an empty tensor the closing window saves for its backward: so they
    # live as the saved tensors of the iterations do, until the middle
    # iteration's backward, or not at all where a recompute
    # (``torch.utils.checkpoint``) drops the saved tensors, and then as
    # long as its recompute's
    held = torch.empty(0, device="meta")
    closing = grad and carry.requires_grad
    if closing:
        carry, = _Window.apply(mode, None, k, held, carry)
    before = mode.live.live
    mode.scale *= k
    try:
        carry, ym = step(carry, 1, *at[1])
    finally:
        mode.scale //= k
    # the n - 4 iterations not run: their outputs, live until the stack,
    # and what each keeps (for the backward, or nothing)
    one = _local(ym).untyped_storage().nbytes()
    out_bytes = one * (k - 1)
    kept = max(mode.live.live - before - one, 0) * (k - 1)
    mode.live.hold(held, kept)
    mode.live.grow(out_bytes)
    try:        # a recompute may stop here, once it has what it needs
        if grad and (carry.requires_grad or ym.requires_grad):
            if not closing:
                raise RuntimeError("scan: a middle iteration whose input "
                                   "carry needs no gradient cannot be "
                                   "scaled")
            carry, ym = _Window.apply(mode, k, None, None, carry, ym)
            # the gradients of xs's slices the iterations not run hold,
            # from the middle iteration's backward to xs's stack
            carry = _Grow.apply(mode, box, sum(
                x.select(dim, 0).numel() * x.element_size()
                for x in xs if x.requires_grad) * (n - 4), carry)
        carry, y1 = step(carry, n - 2, *at[2])
        carry, y2 = step(carry, n - 1, *at[3])
        tail = (y0, ym, y1, y2)
        if grad and any(y.requires_grad for y in tail):
            ys = _Stack.apply(dim, n, *tail)
        else:
            ys = torch.stack([y0] + [ym] * k + [y1, y2], dim)
    finally:
        mode.live.shrink(out_bytes)
    return carry, ys


class _Window(torch.autograd.Function):
    """An identity whose backward multiplies (``mul``) or divides
    (``div``) the counter's scale.  On a scaled iteration's outputs it
    opens the window in the backward; on its input carry it closes it,
    and saves ``held`` (the bytes the iterations not run kept) for its
    backward, after which autograd frees it.  Autograd runs every node
    made between the two, the iteration's own, before the closing one: it
    runs ready nodes latest-made first, and those nodes feed only each
    other and the opening one."""

    @staticmethod
    def forward(ctx, mode, mul, div, held, *xs):
        ctx.set_materialize_grads(False)
        ctx.mode, ctx.mul, ctx.div = mode, mul, div
        if held is not None:
            ctx.save_for_backward(held)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.mul:
            ctx.mode.scale *= ctx.mul
        if ctx.div:
            ctx.mode.scale //= ctx.div
        return (None, None, None, None) + grads


class _Slices(torch.autograd.Function):
    """Slices 0, 1, n - 2 and n - 1 of ``x`` on ``dim``, as a scaled
    scan's iterations read them; the backward charged as the eager loop's
    (``unbind``'s: one stack of every slice's gradient, slice 1's n - 3
    times, a slice without one a zero expanded).  The n - 4 gradients of
    the slices not read, grown by :class:`_Grow` (``box``) as the middle
    iteration's backward starts, are released after the stack, as
    autograd holds the eager slices' until every one has come."""

    @staticmethod
    def forward(ctx, mode, box, dim, n, x):
        ctx.mode, ctx.box, ctx.dim, ctx.n = mode, box, dim, n
        ctx.set_materialize_grads(False)
        return tuple(x.select(dim, t) for t in (0, 1, n - 2, n - 1))

    @staticmethod
    def backward(ctx, *grads):
        like = next((g for g in grads if g is not None), None)
        if like is None:
            return None, None, None, None, None
        # unbind's backward: a slice without a gradient a zero expanded
        g0, gm, g1, g2 = (torch.zeros((), dtype=like.dtype,
                                      device=like.device).expand(like.shape)
                          if g is None else g for g in grads)
        g = torch.stack([g0] + [gm] * (ctx.n - 3) + [g1, g2], ctx.dim)
        if ctx.box["grown"]:
            ctx.mode.live.shrink(like.numel() * like.element_size()
                                 * (ctx.n - 4))
        return None, None, None, None, g


class _Grow(torch.autograd.Function):
    """An identity whose backward grows the counter's live bytes by
    ``nbytes`` (released by :class:`_Slices`) and marks ``box``."""

    @staticmethod
    def forward(ctx, mode, box, nbytes, x):
        ctx.mode, ctx.box, ctx.nbytes = mode, box, nbytes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.mode.live.grow(ctx.nbytes)
        ctx.box["grown"] = True
        return None, None, None, g


class _Stack(torch.autograd.Function):
    """``torch.stack`` of (y_0, y_m n - 3 times, y_n-2, y_n-1), charged as
    the eager loop's stack; its backward hands y_m one slice of the
    gradient (autograd would sum n - 3), as each eager iteration gets
    one."""

    @staticmethod
    def forward(ctx, dim, n, y0, ym, y1, y2):
        ctx.dim = dim
        return torch.stack([y0] + [ym] * (n - 3) + [y1, y2], dim)

    @staticmethod
    def backward(ctx, g):
        gs = g.unbind(ctx.dim)
        return None, None, gs[0], gs[1], gs[-2], gs[-1]
