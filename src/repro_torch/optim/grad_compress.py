"""Int8 gradient compression with error feedback.

The counterpart of ``repro.optim.grad_compress``: each gradient leaf is
quantized to int8 with a per-leaf float32 scale before a cross-pod
reduce, and the quantization residual is kept in an error-feedback
buffer (Seide et al. 2014; the 1-bit Adam lineage) so the bias cancels
over steps.  ``compress`` / ``decompress`` / ``init_error_state`` are
ported; ``compressed_psum_tree``, the reduce itself over a mesh axis,
waits for the training half of the distributed layer (ROADMAP §1 item
5.5).
"""

from __future__ import annotations

import torch

from repro_torch.optim.optimizers import tree_map


def compress(g: torch.Tensor, err: torch.Tensor):
    """g + err -> (q int8, scale float32, new_err): a symmetric per-tensor
    scale, amax / 127."""
    g32 = g.to(torch.float32) + err
    amax = torch.max(torch.abs(g32))
    scale = torch.clamp(amax, min=1e-20) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, g32 - deq


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(params):
    """Zero float32 residuals in ``params``' structure."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
