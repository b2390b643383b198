"""Dry run: count every (arch x shape) cell on meta tensors: the step on
one card, or one device's share of it on a production mesh.

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
512) count one device's share of the sharded step, as ``repro``'s dry run
reports one partition's counts: the parameters, optimizer state, batch
and cache take ``repro``'s partition specs (``distributed/sharding.py``,
``train/steps.state_specs``) as DTensors on a ``DeviceMesh`` of the
abstract production mesh under a ``fake`` process group of 256 or 512
ranks, their blocks on meta; the step runs on them
(``context.sharded_step``) and ``op_cost`` charges the ops on this
device's blocks and the collectives the redistributions launch, which
the fake group never executes.  The record has ``repro``'s keys (FLOPs
and bytes whole-program: one device's x chips), ``step_counted: true``
and each argument category's bytes on one device::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh pod \\
        --arch smollm-360m --shape train_4k

``repro``'s ``--rwkv-unroll`` and ``--mamba-unroll`` are not offered:
the port's recurrences are eager loops with nothing to unroll.
``--moe-fp8-dispatch`` acts where the step takes the expert-parallel
path (``models/moe.py`` ``apply_ep``), on a mesh whose model axis has
several devices: the sharded cells of the MoE archs; the card's
one-device step is dense.
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
    return _record(cfg, shape, arch, MESH, 1, cost, time.time() - t0)


def _record(cfg, shape, arch: str, mesh_name: str, chips: int, cost,
            trace_s: float) -> dict:
    """A counted cell's record: ``cost`` is one device's, the FLOPs and
    bytes ``chips`` times it (``repro``'s whole-program convention)."""
    rl = roofline.analyze(
        cost, arch=arch, shape=shape.name, mesh_name=mesh_name, chips=chips,
        model_flops=roofline.model_flops_for(cfg, shape,
                                             active_param_count(cfg)),
        dtype=cfg.dtype)
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "status": "OK", "chips": chips, "trace_s": round(trace_s, 2),
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


def _block_bytes(tree) -> int:
    """Bytes of this device's blocks of a tree of DTensors."""
    return sum(leaf.to_local().numel() * leaf.element_size()
               for _, leaf in shd.leaves_with_path(tree))


def sharded_step_and_args(cfg, shape: shp.ShapeSpec, mesh):
    """The cell's step, its arguments as DTensors of ``repro``'s specs on
    ``mesh``'s ``DeviceMesh``, and each category's bytes on one device.
    Call under a process group of the mesh's size; the arguments' blocks
    are meta."""
    step_fn, _ = step_and_args(cfg, shape)
    dmesh = shd.device_mesh(mesh)
    placed = {category: shd.distribute(tree, shd.to_named(mesh, specs,
                                                           dmesh))
              for category, (tree, specs) in
              argument_trees(cfg, shape, mesh).items()}
    per_device = dict.fromkeys(CATEGORIES, 0)
    per_device.update({category: _block_bytes(tree)
                       for category, tree in placed.items()})
    if shape.step == "train":
        args = ({"params": placed["params"], **placed["optimizer_state"]},
                placed["batch"])
    elif shape.step == "prefill":
        args = (placed["params"], placed["batch"])
    else:
        args = (placed["params"], placed["cache"], placed["batch"],
                shape.seq_len - 1)
    return step_fn, args, per_device


def count_sharded(cfg, shape: shp.ShapeSpec, mesh):
    """One device's :class:`op_cost.ModuleCost` of the cell's step on
    ``mesh`` (:func:`sharded_step_and_args`, then the step counted under
    ``context.sharded_step``), and its arguments' bytes by category."""
    step_fn, args, per_device = sharded_step_and_args(cfg, shape, mesh)
    with dctx.sharded_step(mesh):
        cost = op_cost.count(step_fn, *args)
    return cost, per_device


def shard_cell(cfg, shape: shp.ShapeSpec, arch: str, mesh_name: str) -> dict:
    """The record of one supported cell on ``pod`` or ``multipod``: one
    device's share of its sharded step counted on meta under a fake
    process group of the mesh's size (torn down after the cell), with
    its arguments' bytes a device by category."""
    t0 = time.time()
    mesh = production_mesh(mesh_name)
    with dctx.fake_process_group(mesh.size):
        cost, per_device = count_sharded(cfg, shape, mesh)
    rec = _record(cfg, shape, arch, mesh_name, mesh.size, cost,
                  time.time() - t0)
    rec["step_counted"] = True
    rec["argument_bytes_per_device"] = per_device
    return rec


def site_rows(sites) -> list:
    """:func:`op_cost.collective_sites`'s table as records, the most wire
    bytes first."""
    return [{"kind": kind, "site": site, "shape": list(shape),
             "dtype": dtype, "issues": n, "wire_bytes": wire}
            for (kind, site, shape, dtype), (n, wire) in
            sorted(sites.items(), key=lambda kv: -kv[1][1])]


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
    its step counted on the card, or one device's share of its sharded
    step on ``pod`` or ``multipod`` (exceptions propagate; :func:`main`
    records them)."""
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
                         f"multipod: one device's share of the sharded "
                         f"step")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--quant", default=None, help="e.g. 'binary'")
    ap.add_argument("--width-mult", type=float, default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--dump-hlo", action="store_true",
                    help="repro's HLO dump: an eager step has no HLO")
    ap.add_argument("--rwkv-chunk", type=int, default=None,
                    help="GLA-style chunked WKV (perf knob)")
    ap.add_argument("--moe-fp8-dispatch", action="store_true",
                    help="fp8 dispatch all-to-all for EP MoE (perf knob)")
    ap.add_argument("--attn-probs-bf16", action="store_true",
                    help="bf16 attention probabilities (perf knob)")
    ap.add_argument("--bf16-grads", action="store_true",
                    help="bf16 cotangents into the gradient matmuls (perf knob)")
    ap.add_argument("--collective-sites", type=int, default=0, metavar="N",
                    help="print each cell's N sites that issue the most "
                         "wire bytes of each collective kind, and record "
                         "every site (op_cost.collective_sites)")
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
    if args.moe_fp8_dispatch:
        overrides["moe_dispatch_fp8"] = True
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
                with op_cost.collective_sites() as sites:
                    res = lower_cell(arch, sn, overrides, args.mesh)
                if args.collective_sites and res["status"] == "OK":
                    res["coll_sites"] = site_rows(sites)
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
            else:
                tail = (f" dom={res['bottleneck']:10s}"
                        f" roofline={res['roofline_fraction']:.2%}"
                        f" trace={res['trace_s']:.1f}s")
                if res["chips"] > 1:
                    tail += (f" args/device="
                             f"{res['bytes_per_chip']['argument'] / 1e9:.3f}"
                             f"GB of {res['chips']} chips")
            line = (f"[{res['status']:7s}] {arch:18s} {sn:12s} "
                    f"{args.mesh:8s}" + tail)
            print(line, flush=True)
            for kind in op_cost.COLLECTIVES:
                rows = [r for r in res.get("coll_sites", ())
                        if r["kind"] == kind][:args.collective_sites]
                total = res["coll_breakdown"][kind] if rows else 0
                for r in rows:
                    print(f"    {kind} {r['wire_bytes']:.4e} B "
                          f"({r['wire_bytes'] / total:.1%}) x{r['issues']:g} "
                          f"{r['shape']} {r['dtype']} {r['site']}")
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n{len(results)} cells: "
          f"{sum(r['status'] == 'OK' for r in results)} ok, "
          f"{sum(r['status'] == 'SKIPPED' for r in results)} skipped, "
          f"{n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
