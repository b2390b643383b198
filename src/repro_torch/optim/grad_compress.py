"""Int8 gradient compression with error feedback.

The counterpart of ``repro.optim.grad_compress``: each gradient leaf is
quantized to int8 with a per-leaf float32 scale before a cross-pod
reduce, and the quantization residual is kept in an error-feedback
buffer (Seide et al. 2014; the 1-bit Adam lineage) so the bias cancels
over steps.  :func:`compressed_psum_tree` is the reduce itself, over one
axis of the ambient mesh's process groups (``distributed/context.py``):
the float32 operations of ``repro``'s, in its order, so the two agree bit
for bit.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import context as dctx
from repro_torch.optim.optimizers import tree_leaves, tree_map


def compress(g: torch.Tensor, err: torch.Tensor):
    """g + err -> (q int8, scale float32, new_err): a symmetric per-tensor
    scale, amax / 127."""
    g32 = g.to(torch.float32) + err
    amax = torch.max(torch.abs(g32))
    # the divisor a tensor on the device: CUDA applies a host scalar's
    # reciprocal, off the true quotient by an ulp at times
    scale = torch.clamp(amax, min=1e-20) / _scalar(127.0, g.device)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, g32 - deq


def _scalar(value: float, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(params):
    """Zero float32 residuals in ``params``' structure."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def compressed_psum_tree(grads, err_state, axis: str):
    """Error-feedback int8 mean of every leaf over mesh axis ``axis`` of
    the ambient mesh (``context.mesh_context``; none raises): the scales
    max-reduced (so dequantizing is conservative), each leaf requantized
    against the shared scale, int8 on the wire summed as int32, divided by
    the axis' size.  Returns (the mean gradients in each leaf's type, the
    new float32 residuals)."""
    mesh = dctx.current_mesh()
    if mesh is None or axis not in mesh.axis_names:
        raise ValueError(f"compressed_psum_tree over {axis!r} needs a mesh "
                         f"with that axis (context.mesh_context)")

    def one(g, err):
        _, scale, _ = compress(g, err)
        scale = dctx.pmax(scale, mesh, axis)              # shared scale
        # requantize against the shared scale to keep the wire int8
        g32 = g.to(torch.float32) + err
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        new_err = g32 - q.to(torch.float32) * scale
        total = dctx.psum(q.to(torch.int32), mesh, axis)
        n = _scalar(float(mesh.shape[axis]), g.device)
        return (total.to(torch.float32) * scale / n).to(g.dtype), new_err

    out = [one(g, e) for g, e in zip(tree_leaves(grads),
                                     tree_leaves(err_state))]
    firsts, seconds = iter(out), iter(out)
    return (tree_map(lambda _: next(firsts)[0], grads),
            tree_map(lambda _: next(seconds)[1], grads))
