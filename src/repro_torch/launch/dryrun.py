"""Dry run: count every (arch x shape) cell on meta tensors, on one card.

The counterpart of ``repro.launch.dryrun``.  Where ``repro`` lowers and
compiles each cell's jitted step for a 512-device mesh, this module
builds the same train, prefill or decode step, feeds it meta parameters,
state, cache and ``configs/shapes.py``'s input specs (shapes and types,
nothing allocated), counts it with ``launch/op_cost.py`` and builds the
H100 roofline (``launch/roofline.py``) at ``chips=1`` on the mesh
``"card"``.  An eager step runs its loops, so a cell traces in time
proportional to its ops, except the per-token recurrences (RWKV-6,
Mamba), which go through ``op_cost.scan``: on meta four of their
iterations run and the middle one's charges are scaled, so every cell
ends in seconds (the chunked attention at 32k tokens is the slowest).
Run one cell a process under a time limit::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape decode_32k

Each cell's record is written to ``build/repro_torch/dryrun/`` (never
``benchmarks/``): ``repro``'s keys, with ``trace_s`` for its
``lower_s``/``compile_s``; a failing cell is a bug and keeps its
traceback.

``--mesh pod`` (16 x 16, 256 chips) and ``--mesh multipod`` (2 x 16 x 16,
512) shard the cell's arguments instead: the parameters, optimizer state,
batch and cache take ``repro``'s partition specs (``distributed/
sharding.py``, ``train/steps.state_specs``) on the abstract production
mesh, placed as DTensors on a ``DeviceMesh`` under a ``fake`` process group
of 256 or 512 ranks, on meta tensors; the record gives each category's
bytes on one device, summed from the leaves' shard shapes, and
``step_counted: false``: the sharded step, one device's share of its
FLOPs, bytes and collective wire bytes, is not counted yet (ROADMAP §1
item 5.5d)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh pod \\
        --arch smollm-360m --shape train_4k

``repro``'s
``--rwkv-unroll``, ``--mamba-unroll`` and ``--moe-fp8-dispatch`` are not
offered: the port's recurrences are eager loops with nothing to unroll,
and the fp8 dispatch belongs to the expert-parallel path
(``models/moe.py`` ``apply_ep``), which a step takes only on a mesh whose
model axis has several devices: the card's one-device step is dense, and
the sharded cells do not count their step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import shapes as shp
from repro_torch.configs.base import active_param_count
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_cost, roofline
from repro_torch.models import transformer
from repro_torch.optim import optimizers as opt
from repro_torch.train import serve, steps

META = torch.device("meta")
MESH = "card"
MESHES = (MESH, "pod", "multipod")
# the argument categories of a sharded cell's record
CATEGORIES = ("params", "optimizer_state", "batch", "cache")
NOT_COUNTED = ("the sharded step's FLOPs, bytes and collective wire bytes "
               "a device are not counted yet (ROADMAP §1 item 5.5d): only "
               "its arguments are sharded")
OUT = os.path.join("build", "repro_torch", "dryrun")


def build_optimizer(cfg):
    lr = opt.cosine_schedule(3e-4, warmup=100, total=10000)
    return opt.make(cfg.optimizer, lr)


def cell_config(arch: str, overrides=None):
    """``arch``'s config with ``overrides``; the prefixes ``rwkv_``,
    ``moe_`` and ``mamba_`` go to those sub-configs, as in ``repro``."""
    overrides = dict(overrides or {})
    subs = {}
    for prefix in ("rwkv_", "moe_", "mamba_"):
        subs[prefix[:-1]] = {k[len(prefix):]: overrides.pop(k)
                             for k in list(overrides) if k.startswith(prefix)}
    cfg = get_config(arch, **overrides)
    for name, over in subs.items():
        sub = getattr(cfg, name)
        if over and sub is not None:
            cfg = cfg.with_(**{name: dataclasses.replace(sub, **over)})
    return cfg


def step_and_args(cfg, shape: shp.ShapeSpec):
    """The cell's step function and its meta arguments."""
    batch = shp.input_specs(cfg, shape)
    if shape.step == "train":
        optimizer = build_optimizer(cfg)
        return (steps.build_train_step(cfg, optimizer),
                (steps.state_shape(cfg, optimizer), batch))
    params = transformer.init_params(cfg, device=META)
    if shape.step == "prefill":
        return serve.build_prefill_step(cfg), (params, batch)
    cache = transformer.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   device=META)
    tok = list(batch.values())[0]
    # the new token at the cache's last position: every position is read
    return serve.build_decode_step(cfg), (params, cache, tok,
                                          shape.seq_len - 1)


def count_cell(cfg, shape: shp.ShapeSpec, arch: str) -> dict:
    """The record of one supported cell: its step counted on meta."""
    t0 = time.time()
    step_fn, args = step_and_args(cfg, shape)
    cost = op_cost.count(step_fn, *args)
    trace_s = time.time() - t0
    rl = roofline.analyze(
        cost, arch=arch, shape=shape.name, mesh_name=MESH, chips=1,
        model_flops=roofline.model_flops_for(cfg, shape,
                                             active_param_count(cfg)),
        dtype=cfg.dtype)
    return {
        "arch": arch, "shape": shape.name, "mesh": MESH,
        "status": "OK", "chips": 1, "trace_s": round(trace_s, 2),
        "compute_type": roofline.compute_type(cfg.dtype),
        "hlo_flops": rl.hlo_flops, "hlo_bytes": rl.hlo_bytes,
        "coll_bytes_per_chip": rl.coll_bytes_per_chip,
        "coll_breakdown": rl.coll_breakdown,
        "model_flops": rl.model_flops,
        "t_compute": rl.t_compute, "t_memory": rl.t_memory,
        "t_collective": rl.t_collective, "bottleneck": rl.bottleneck,
        "useful_flops_ratio": rl.useful_flops_ratio,
        "roofline_fraction": rl.roofline_fraction,
        "bytes_per_chip": {
            "argument": cost.argument_bytes,
            "output": cost.output_bytes,
            "temp": cost.peak_bytes - cost.argument_bytes,
        },
    }


def production_mesh(mesh_name: str):
    """The abstract production mesh of ``pod`` or ``multipod``."""
    return mesh_lib.make_production_mesh(multi_pod=mesh_name == "multipod",
                                         abstract=True)


def argument_trees(cfg, shape: shp.ShapeSpec, mesh) -> dict:
    """The cell's step arguments by category: (meta tree, spec tree), as
    ``repro``'s dry run gives them its ``in_shardings``."""
    batch = shp.input_specs(cfg, shape)
    if shape.step == "train":
        optimizer = build_optimizer(cfg)
        state = steps.state_shape(cfg, optimizer)
        specs = steps.state_specs(cfg, mesh, optimizer)
        rest = ("opt_state", "step")
        return {"params": (state["params"], specs["params"]),
                "optimizer_state": ({k: state[k] for k in rest},
                                    {k: specs[k] for k in rest}),
                "batch": (batch, shd.batch_specs(cfg, mesh, batch))}
    params = transformer.init_params(cfg, device=META)
    trees = {"params": (params, shd.param_specs(cfg, mesh, params))}
    if shape.step == "prefill":
        trees["batch"] = (batch, shd.batch_specs(cfg, mesh, batch))
        return trees
    cache = transformer.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   device=META)
    tok = list(batch.values())[0]
    trees["cache"] = (cache, shd.cache_specs(cfg, mesh, cache))
    trees["batch"] = (tok, shd.batch_specs(cfg, mesh, {"t": tok})["t"])
    return trees


def shard_bytes(tree, named_tree) -> int:
    """Bytes of one device's shards of a meta tree's leaves."""
    named = dict(shd.leaves_with_path(named_tree))
    return sum(named[path].distribute(leaf).to_local().numel()
               * leaf.element_size()
               for path, leaf in shd.leaves_with_path(tree))


def shard_cell(cfg, shape: shp.ShapeSpec, arch: str, mesh_name: str) -> dict:
    """The record of one supported cell on ``pod`` or ``multipod``: its
    arguments' bytes a device, by category, under a fake process group of
    the mesh's size (torn down after the cell)."""
    t0 = time.time()
    mesh = production_mesh(mesh_name)
    trees = argument_trees(cfg, shape, mesh)
    per_device = dict.fromkeys(CATEGORIES, 0)
    with dctx.fake_process_group(mesh.size):
        dmesh = shd.device_mesh(mesh)
        for category, (tree, specs) in trees.items():
            per_device[category] = shard_bytes(
                tree, shd.to_named(mesh, specs, dmesh))
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "status": "OK", "chips": mesh.size,
        "trace_s": round(time.time() - t0, 2),
        "step_counted": False, "step_note": NOT_COUNTED,
        "argument_bytes_per_device": per_device,
        "bytes_per_chip": {"argument": sum(per_device.values())},
    }


def skipped(cfg, arch: str, shape_name: str, mesh_name: str = MESH):
    """The SKIPPED record of a cell ``cell_supported`` refuses, else None."""
    ok, reason = shp.cell_supported(cfg, shape_name)
    if ok:
        return None
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "SKIPPED", "reason": reason}


def lower_cell(arch: str, shape_name: str, overrides=None,
               mesh_name: str = MESH) -> dict:
    """One cell's record: SKIPPED where ``cell_supported`` says so, else
    its counted step on the card, or its sharded arguments on ``pod`` or
    ``multipod`` (exceptions propagate; :func:`main` records them)."""
    cfg = cell_config(arch, overrides)
    shape = shp.SHAPES[shape_name]
    if mesh_name not in MESHES:
        raise ValueError(f"mesh {mesh_name!r} not in {MESHES}")
    return (skipped(cfg, arch, shape_name, mesh_name)
            or (count_cell(cfg, shape, arch) if mesh_name == MESH
                else shard_cell(cfg, shape, arch, mesh_name)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default=MESH, choices=MESHES,
                    help=f"{MESH}: the step counted on one card; pod, "
                         f"multipod: the arguments sharded")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--quant", default=None, help="e.g. 'binary'")
    ap.add_argument("--width-mult", type=float, default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--dump-hlo", action="store_true",
                    help="repro's HLO dump: an eager step has no HLO")
    ap.add_argument("--rwkv-chunk", type=int, default=None,
                    help="GLA-style chunked WKV (perf knob)")
    ap.add_argument("--attn-probs-bf16", action="store_true",
                    help="bf16 attention probabilities (perf knob)")
    ap.add_argument("--bf16-grads", action="store_true",
                    help="bf16 cotangents into the gradient matmuls (perf knob)")
    args = ap.parse_args(argv)
    if args.dump_hlo:
        raise SystemExit("--dump-hlo: an eager step is not compiled to HLO")

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shape_names = list(shp.SHAPES) if args.shape == "all" else [args.shape]
    overrides = {}
    if args.quant:
        overrides["quant"] = args.quant
    if args.width_mult:
        overrides["width_mult"] = args.width_mult
    if args.rwkv_chunk:
        overrides["rwkv_chunk"] = args.rwkv_chunk
    if args.attn_probs_bf16:
        overrides["attn_probs_bf16"] = True
    if args.bf16_grads:
        overrides["bf16_grads"] = True

    os.makedirs(args.out, exist_ok=True)
    results = []
    for arch in archs:
        for sn in shape_names:
            cell_id = f"{arch}__{sn}__{args.mesh}{args.tag}"
            try:
                res = lower_cell(arch, sn, overrides, args.mesh)
            except Exception as e:  # a failing cell is a bug: record it
                res = {"arch": arch, "shape": sn, "mesh": args.mesh,
                       "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
            results.append(res)
            with open(os.path.join(args.out, f"dryrun_{cell_id}.json"),
                      "w") as f:
                json.dump(res, f, indent=1)
            if res["status"] != "OK":
                tail = f" {res.get('reason', res.get('error', ''))[:90]}"
            elif "step_counted" in res:
                tail = (f" args/device="
                        f"{res['bytes_per_chip']['argument'] / 1e9:.3f}GB "
                        f"of {res['chips']} chips (step not counted)"
                        f" trace={res['trace_s']:.1f}s")
            else:
                tail = (f" dom={res['bottleneck']:10s}"
                        f" roofline={res['roofline_fraction']:.2%}"
                        f" trace={res['trace_s']:.1f}s")
            line = (f"[{res['status']:7s}] {arch:18s} {sn:12s} "
                    f"{args.mesh:8s}" + tail)
            print(line, flush=True)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n{len(results)} cells: "
          f"{sum(r['status'] == 'OK' for r in results)} ok, "
          f"{sum(r['status'] == 'SKIPPED' for r in results)} skipped, "
          f"{n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
