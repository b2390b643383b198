"""GPipe pipeline parallelism over the ``pod`` mesh axis.

The counterpart of ``repro.distributed.pipeline``.  For multi-pod runs
the cheapest cross-pod traffic is boundary activations, not gradient
all-reduces, so the ``pod`` axis can be the pipeline axis: a stage is a
contiguous block of layers, and microbatches flow through a GPipe
schedule (all forward, then all backward; bubble (S-1)/(M+S-1)).

Where ``repro`` runs the schedule as a ``shard_map`` body over a
``lax.scan`` of ticks, the port runs it in each process of the mesh
(``distributed/context.py``): the stage's parameters are its block of the
stacked ones, x is this rank's block over the other axes, and each tick's
output moves to the next stage by a point-to-point send whose backward
sends the gradient back, so the function is differentiable end to end.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import context as dctx
from repro_torch.distributed.sharding import P
from repro_torch.optim.optimizers import tree_map


def pipelined(stage_fn: Callable, mesh, num_microbatches: int,
              axis: str = "pod"):
    """Returns ``fn(stage_params, x)`` running S stages over ``axis``.

    stage_params: a tree with leading dim n_stages on every leaf, each
    stage's block held by its ranks.  x: (B, ...) the global batch, split
    over the mesh's other axes; each rank's block % num_microbatches ==
    0.  The result is global (every rank holds it whole), replicated over
    the pipeline axis as ``repro``'s ``out_specs`` make it."""
    n_stages = mesh.shape[axis]
    other = tuple(a for a in mesh.axis_names if a != axis)
    x_spec = P(other if other else None)

    def run(stage_params, x):
        stage = dctx.axis_index(mesh, axis)
        params_local = tree_map(
            lambda p: dctx.local_block(p, mesh, P(axis))[0], stage_params)
        x_local = dctx.local_block(x, mesh, x_spec)
        m = num_microbatches
        mb = x_local.reshape((m, x_local.shape[0] // m)
                             + tuple(x_local.shape[1:]))
        # the stage tests as tensors, so every stage's graph holds every
        # tick (the gradients' sends must pair up across the stages)
        first = torch.tensor(stage == 0, device=x.device)
        last = torch.tensor(stage == n_stages - 1, device=x.device)
        buf = torch.zeros_like(mb[0])
        outs = [torch.zeros_like(mb[0])] * m
        for t in range(m + n_stages - 1):
            # stage 0 injects microbatch t (if any remain)
            x_in = torch.where(first, mb[t if t < m else 0].to(buf.dtype),
                               buf)
            y = stage_fn(params_local, x_in)
            # the last stage keeps microbatch t - (S - 1)
            if t >= n_stages - 1:
                i = t - (n_stages - 1)
                outs[i] = torch.where(last, y, outs[i])
            # shift boundary activations to the next stage
            buf = dctx.ppermute_next(y, mesh, axis)
        # the last stage's outputs to every stage: replicated over the axis
        outs = torch.stack(outs)
        outs = dctx.psum(torch.where(last, outs, torch.zeros_like(outs)),
                         mesh, axis)
        return dctx.global_value(outs.reshape(x_local.shape), mesh, x_spec,
                                 x.shape)

    return run
