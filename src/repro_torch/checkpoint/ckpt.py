"""Checkpoints: save / restore / async, and the device rebuild of the
restore-after-fault path.

The counterpart of ``repro.checkpoint.ckpt`` over torch and numpy, with
the same on-disk format: one ``<path>.npz`` of flattened leaves plus a
``<path>.json`` manifest (the step, each leaf's shape and dtype), each
written atomically (tmp + rename), so a preemption mid-write never
corrupts the latest good checkpoint.  Leaf keys are the strings
``jax.tree_util.keystr`` gives for the same nest of dicts (sorted keys,
``['conv']``), lists and tuples (``[0]``) and namedtuples (``.field``),
so a checkpoint written by either package restores in the other.

Leaves are tensors, numpy arrays or numbers.  uint32 leaves restore as
int32 tensors holding the same 32 bits (the port's packed-word
convention, as in :mod:`repro_torch.convert`); bfloat16 leaves, which
numpy cannot hold, are stored as their uint16 bit patterns with the
dtype ``bfloat16`` in the manifest.

Checkpoints are topology-free (full arrays): :func:`restore` places
every leaf on one device, and a restart rebuilds its device layout on
whatever survived with :func:`make_mesh`, which refuses a layout larger
than the surviving devices.  :class:`Mesh` is the port's one mesh type:
the restart's layout, the training meshes of ``launch/mesh.py`` and, in
its abstract form (sizes, no devices), the 256- and 512-chip meshes a dry
run shards over on a machine that cannot hold them.

``AsyncCheckpointer`` snapshots to host memory synchronously (cheap) and
writes to disk on a background thread, overlapping I/O with the next
steps; ``wait()`` joins before the process exits.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device

_BF16 = "bfloat16"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in ``jax.tree_util``'s flattening order
    (dict keys sorted; ``None`` holds no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _leaves(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from an iterator of leaves."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array and the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), _BF16
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(path: str, state: Any, step: Optional[int] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, dtypes = {}, {}
    for key, leaf in _leaves(state):
        arrays[key], dtypes[key] = _host(leaf)
    manifest = {
        "step": int(step if step is not None else 0),
        "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                   for k, v in arrays.items()},
    }
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path + ".npz")
    tmpm = path + ".tmp.json"
    with open(tmpm, "w") as f:
        json.dump(manifest, f)
    os.replace(tmpm, path + ".json")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device layout: ``devices`` is an object array of
    ``torch.device`` shaped ``axis_sizes``, one name an axis; an abstract
    mesh (:meth:`abstract`) has the sizes and no devices."""
    devices: Optional[np.ndarray]
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.devices is not None:
            object.__setattr__(self, "axis_sizes", tuple(self.devices.shape))
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self.axis_sizes} do not name one axis "
                             f"each of {self.axis_names}")

    @classmethod
    def abstract(cls, axis_sizes, axis_names) -> "Mesh":
        """A mesh of ``axis_sizes`` with no devices: shapes and specs
        only (``jax.sharding.AbstractMesh``'s twin)."""
        return cls(None, tuple(axis_names), tuple(int(s) for s in axis_sizes))

    @property
    def is_abstract(self) -> bool:
        return self.devices is None

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return collections.OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_mesh(axis_shapes, axis_names, *, devices=None) -> Mesh:
    """The device layout of the restore-after-fault path and of the
    training meshes.

    A job restarted after a fault rebuilds its layout on whatever devices
    survived (default: every CUDA device) and restores the latest
    checkpoint onto it; a layout needing more devices than survived raises
    rather than hanging.
    """
    devices = (_device.local_devices() if devices is None
               else [torch.device(d) for d in devices])
    n = math.prod(int(s) for s in axis_shapes)
    if n > len(devices):
        raise ValueError(
            f"mesh {tuple(axis_shapes)} needs {n} devices, "
            f"only {len(devices)} available after restart")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(tuple(axis_shapes)), tuple(axis_names))


def _leaf_from(arr: np.ndarray, dtype: str, dev: torch.device):
    arr = np.array(arr)                  # a contiguous copy, 0-d kept
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(dev)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(dev)


def restore(path: str, state_like: Any, device=None) -> Any:
    """Restore into the structure of ``state_like`` (tensors, arrays or
    anything with a ``shape``) as tensors on ``device`` (default: the GPU;
    ``"cpu"`` by name).  Raises on a leaf the checkpoint lacks or whose
    shape differs."""
    dev = _device.resolve(device)
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    dtypes = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            dtypes = {k: v["dtype"]
                      for k, v in json.load(f)["leaves"].items()}
    leaves = []
    for key, leaf in _leaves(state_like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        want_shape = tuple(np.shape(leaf) if not hasattr(leaf, "shape")
                           else leaf.shape)
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape} != {want_shape}")
        leaves.append(_leaf_from(arr, dtypes.get(key, str(arr.dtype)), dev))
    return _unflatten(state_like, iter(leaves))


def _steps(directory: str, prefix: str) -> List[int]:
    steps = []
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".json"):
            try:
                steps.append(int(name[len(prefix):-len(".json")]))
            except ValueError:
                pass
    return steps


def latest_step(directory: str, prefix: str = "ckpt_") -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory, prefix)
    return max(steps) if steps else None


class AsyncCheckpointer:
    """Snapshot-to-host sync, write-to-disk async (one in flight)."""

    def __init__(self, directory: str, prefix: str = "ckpt_", keep: int = 3):
        self.directory = directory
        self.prefix = prefix
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, state: Any, step: int) -> None:
        self.wait()
        host_state = _unflatten(
            state, iter([_host_copy(leaf) for _, leaf in _leaves(state)]))

        def _write():
            try:
                path = os.path.join(self.directory, f"{self.prefix}{step}")
                save(path, host_state, step)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in sorted(_steps(self.directory, self.prefix))[:-self.keep]:
            for ext in (".json", ".npz"):
                try:
                    os.remove(os.path.join(self.directory,
                                           f"{self.prefix}{s}{ext}"))
                except OSError:
                    pass


def _host_copy(leaf):
    """A snapshot the next step cannot change: tensors copied to the
    host (bfloat16 kept), arrays copied."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)
