"""Assigned input-shape set + meta-tensor input specs for the dry-run.

The counterpart of ``repro.configs.shapes``.  Four shapes per LM
architecture (40 cells total):
  train_4k     seq 4096,    global_batch 256  -> train_step
  prefill_32k  seq 32768,   global_batch 32   -> prefill_step
  decode_32k   seq 32768,   global_batch 128  -> serve_step (1 new token)
  long_500k    seq 524288,  global_batch 1    -> serve_step; ONLY for
               sub-quadratic archs (rwkv6, jamba) — see DESIGN.md §4.

``input_specs`` returns tensors on ``torch.device("meta")``, PyTorch's
stand-in for ``jax.ShapeDtypeStruct``: shape and dtype, no allocation.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import common

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs allowed to run long_500k (constant/linear-state sequence mixers)
SUBQUADRATIC = ("rwkv6-3b", "jamba-v0.1-52b")


def cell_supported(cfg, shape_name: str) -> tuple[bool, str]:
    """(supported, reason-if-not) for an (arch x shape) cell."""
    if shape_name == "long_500k" and cfg.name not in SUBQUADRATIC:
        return False, ("full-attention KV cache at 524288 tokens is not a "
                       "sensible deployment (quadratic prefill; see DESIGN.md §4)")
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _token_struct(cfg, b, s):
    if cfg.num_codebooks > 1:
        return _spec((b, s, cfg.num_codebooks), torch.int32)
    return _spec((b, s), torch.int32)


def input_specs(cfg, shape: ShapeSpec) -> dict:
    """Meta-tensor stand-ins for every model input of this cell."""
    b = shape.global_batch
    dtype = common.torch_dtype(cfg.dtype)
    if shape.step == "train":
        s = shape.seq_len
        specs = {"tokens": _token_struct(cfg, b, s),
                 "labels": _token_struct(cfg, b, s)}
        if not cfg.embed_inputs:  # VLM stub: precomputed patch embeddings
            specs["embeds"] = _spec((b, s, cfg.d_model), dtype)
            specs.pop("tokens")
        if cfg.mrope:
            specs["positions"] = _spec((b, s, 3), torch.int32)
        return specs
    if shape.step == "prefill":
        s = shape.seq_len
        specs = {"tokens": _token_struct(cfg, b, s)}
        if not cfg.embed_inputs:
            specs["embeds"] = _spec((b, s, cfg.d_model), dtype)
            specs.pop("tokens")
        if cfg.mrope:
            specs["positions"] = _spec((b, s, 3), torch.int32)
        return specs
    # decode: one new token against a cache of seq_len
    specs = {"tokens": _token_struct(cfg, b, 1)}
    if not cfg.embed_inputs:
        specs["embeds"] = _spec((b, 1, cfg.d_model), dtype)
        specs.pop("tokens")
    if cfg.mrope:
        specs["positions"] = _spec((b, 1, 3), torch.int32)
    return specs
