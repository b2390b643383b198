"""Carry ``repro``'s parameters and deployment artifacts into the port.

Both functions take numpy arrays only (the caller does the ``np.asarray``
on the JAX side), so this module imports neither JAX nor ``repro``.
uint32 words become int32 tensors holding the same 32 bits.
"""

from __future__ import annotations

from typing import Any, Dict

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
