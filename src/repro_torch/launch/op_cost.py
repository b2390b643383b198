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
traffic free) does not apply, and neither does its trip-count scaling
(an eager loop runs, and is counted, every iteration).  One card has no
collectives: ``coll_wire_bytes`` is 0 and ``coll_breakdown`` lists
``hlo_cost``'s five kinds at 0.

``peak_bytes`` is the peak of live tensor bytes during the call: the
arguments' storages, then every storage an op creates, each counted from
its creation to its release.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import weakref
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import flash_attention as _fa  # noqa: F401
                                    # registers repro_torch::flash_attention

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


@dataclasses.dataclass
class ModuleCost:
    flops: float               # per card
    bytes: float               # per card, bytes accessed
    coll_wire_bytes: float     # 0: one card has no collectives
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


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


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


class _CountMode(TorchDispatchMode):
    def __init__(self, live: _Live):
        super().__init__()
        self.live = live
        self.flops = 0.0
        self.bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        for t in outs:
            self.live.add(t)
        packet = func.overloadpacket
        if packet in _FREE or not outs:
            return out
        mutated = func._schema.is_mutable
        in_keys = {_storage_key(t) for t in ins}
        if not mutated and all(_storage_key(t) in in_keys for t in outs):
            return out                       # a view: no data moves
        if packet in _WRITE_ONLY:
            ins = ins[1:]
        self.bytes += (sum(span_bytes(t) for t in ins)
                       + sum(span_bytes(t) for t in outs))
        self.flops += _flops(func, packet, args, kwargs, out, ins, outs)
        return out


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
    arg_tensors = _tensors((args, kwargs))
    for t in arg_tensors:
        live.add(t)
    argument = live.live
    mode = _CountMode(live)
    with mode:
        out = fn(*args, **kwargs)
    output = _unique_bytes(_tensors(out))
    del out
    return ModuleCost(flops=mode.flops, bytes=mode.bytes,
                      coll_wire_bytes=0.0,
                      coll_breakdown={k: 0.0 for k in COLLECTIVES},
                      peak_bytes=float(live.peak),
                      argument_bytes=float(argument),
                      output_bytes=float(output))
