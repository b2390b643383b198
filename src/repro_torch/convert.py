"""Carry ``repro``'s parameters, optimizer states, deployment artifacts,
delta-gate state and LM parameters into the port, and parameters,
optimizer states, the gate state and LM parameters back.

The functions take and give numpy arrays only (the caller does the
``np.asarray`` on the JAX side), so this module imports neither JAX nor
``repro``.  uint32 words become int32 tensors holding the same 32 bits.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import device as _device

_CONV_PARAMS = ("w", "gamma", "beta", "mean", "var")


def params_from_numpy(np_params, device=None) -> Dict[str, Any]:
    """``{"conv": [{w, gamma, beta, mean, var}], "fc": [{w}]}`` of numpy
    arrays -> the port's float32 parameter dict on ``device``."""
    dev = _device.resolve(device)

    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    return {"conv": [{k: f32(p[k]) for k in _CONV_PARAMS}
                     for p in np_params["conv"]],
            "fc": [{"w": f32(p["w"])} for p in np_params["fc"]]}


def params_to_numpy(tree):
    """The way back: a nest of dicts/lists of float tensors (the chip
    parameter dict, its gradients, an optimizer state over it, a
    BitLinear) -> the same nest of float32 numpy arrays, in ``repro``'s
    layout, for comparing trained latents and BN statistics."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy().astype(np.float32)


def bitlinear_from_numpy(np_params, device=None) -> Dict[str, torch.Tensor]:
    """A ``repro`` BitLinear ``{"w": (N, K), "g": (N,)}`` as numpy ->
    the port's float32 tensors on ``device``."""
    dev = _device.resolve(device)
    return {k: torch.from_numpy(np.array(np_params[k], dtype=np.float32))
            .to(dev) for k in ("w", "g")}


def opt_state_from_numpy(tree, device=None):
    """An optimizer state as numpy (``repro``'s ``adamw`` ``{"m": params,
    "v": params}``, ``sgdm`` ``{"m": params}``; any nest of dicts/lists of
    float arrays) -> the same nest of float32 tensors on ``device``."""
    dev = _device.resolve(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return torch.from_numpy(np.array(t, dtype=np.float32)).to(dev)

    return walk(tree)


def _leaf(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    elif x.dtype != np.bool_:
        x = x.astype(np.int32 if np.issubdtype(x.dtype, np.integer)
                     else np.float32)
    return torch.from_numpy(x.copy()).to(dev)


def artifact_from_numpy(np_artifact, device=None):
    """Any ``repro`` artifact form as numpy arrays -> the port's.

    Works on float-folded (+/-1 float32 weights, float ``tau``, bool
    ``flip``), packed per-layer (uint32 ``w_words``, int32 ``tau``/
    ``flip``) and weight-image (``cw``/``ct``/``cf``/``fw``) artifacts:
    uint32 words become bit-identical int32 words, other integers int32,
    floats float32, bools stay bool.
    """
    dev = _device.resolve(device)
    if isinstance(np_artifact, dict) and "cw" in np_artifact:
        return {k: _leaf(v, dev) for k, v in np_artifact.items()}
    return {part: [{k: _leaf(v, dev) for k, v in layer.items()}
                   for layer in np_artifact[part]]
            for part in ("conv", "fc")}


def state_from_numpy(last, llog, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``repro``'s delta-gate state -> the port's: uint32 last-frame words
    (B, H, W, C/32) become bit-identical int32 words, int32 cached logits
    (B, classes) stay int32."""
    dev = _device.resolve(device)
    last = np.asarray(last)
    if last.dtype != np.uint32:
        raise ValueError(f"last-frame words must be uint32, got {last.dtype}")
    return _leaf(last, dev), _leaf(np.asarray(llog, dtype=np.int32), dev)


def state_to_numpy(last: torch.Tensor, llog: torch.Tensor
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The port's delta-gate state -> ``repro``'s layout: uint32 last-frame
    words and int32 cached logits."""
    return (last.cpu().numpy().view(np.uint32),
            llog.cpu().numpy().astype(np.int32))


def _lm_leaf(x, dev: torch.device) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":       # ml_dtypes' bfloat16, bits kept
        return torch.from_numpy(x.view(np.int16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(x.copy()).to(dev)


def lm_params_from_numpy(tree, device=None):
    """``repro``'s LM parameter pytree (nested dicts and lists of numpy
    arrays, stacked ``blocks/pos{i}`` leaves included) -> the same nest of
    tensors on ``device``, bit for bit, each leaf keeping its dtype."""
    dev = _device.resolve(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return _lm_leaf(t, dev)

    return walk(tree)


def lm_params_to_numpy(tree):
    """The way back: a nest of tensors -> the same nest of numpy arrays,
    bit for bit, each leaf keeping its dtype.  numpy has no bfloat16 of
    its own, so a bfloat16 leaf comes back as its bits in uint16; a
    caller with a numpy bfloat16 type (``jnp.bfloat16``) views them as
    that."""
    if isinstance(tree, dict):
        return {k: lm_params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lm_params_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
