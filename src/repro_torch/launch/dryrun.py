"""Dry run: count every (arch x shape) cell on meta tensors, on one card.

The counterpart of ``repro.launch.dryrun``.  Where ``repro`` lowers and
compiles each cell's jitted step for a 512-device mesh, this module
builds the same train, prefill or decode step, feeds it meta parameters,
state, cache and ``configs/shapes.py``'s input specs (shapes and types,
nothing allocated), counts it with ``launch/op_cost.py`` and builds the
H100 roofline (``launch/roofline.py``) at ``chips=1`` on the mesh
``"card"``.  An eager step runs every iteration of its loops, so a cell
traces in time proportional to its ops: the per-token recurrences
(RWKV-6, Mamba) and the chunked attention at 32k tokens are the slow
ones.  Run one cell a process under a time limit::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape decode_32k

Each cell's record is written to ``build/repro_torch/dryrun/`` (never
``benchmarks/``): ``repro``'s keys, with ``trace_s`` for its
``lower_s``/``compile_s``; a failing cell is a bug and keeps its
traceback.  The meshes ``pod`` and ``multipod`` need collectives over
several cards (ROADMAP §1 item 5.5) and raise.  ``repro``'s
``--rwkv-unroll``, ``--mamba-unroll`` and ``--moe-fp8-dispatch`` are not
offered: the port's recurrences are eager loops with nothing to unroll,
and it has no expert-parallel dispatch to carry in fp8.
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
from repro_torch.launch import op_cost, roofline
from repro_torch.models import transformer
from repro_torch.optim import optimizers as opt
from repro_torch.train import serve, steps

META = torch.device("meta")
MESH = "card"
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


def skipped(cfg, arch: str, shape_name: str):
    """The SKIPPED record of a cell ``cell_supported`` refuses, else None."""
    ok, reason = shp.cell_supported(cfg, shape_name)
    if ok:
        return None
    return {"arch": arch, "shape": shape_name, "mesh": MESH,
            "status": "SKIPPED", "reason": reason}


def lower_cell(arch: str, shape_name: str, overrides=None) -> dict:
    """One cell's record: SKIPPED where ``cell_supported`` says so, else
    its counted step (exceptions propagate; :func:`main` records them)."""
    cfg = cell_config(arch, overrides)
    return (skipped(cfg, arch, shape_name)
            or count_cell(cfg, shp.SHAPES[shape_name], arch))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default=MESH,
                    help=f"{MESH} (pod and multipod: ROADMAP §1 item 5.5)")
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
    if args.mesh != MESH:
        raise SystemExit(
            f"--mesh {args.mesh}: the pod and multipod meshes need "
            f"collectives over several cards, not ported yet (ROADMAP §1 "
            f"item 5.5); this dry run counts one card, --mesh {MESH}")
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
                res = lower_cell(arch, sn, overrides)
            except Exception as e:  # a failing cell is a bug: record it
                res = {"arch": arch, "shape": sn, "mesh": args.mesh,
                       "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
            results.append(res)
            with open(os.path.join(args.out, f"dryrun_{cell_id}.json"),
                      "w") as f:
                json.dump(res, f, indent=1)
            line = (f"[{res['status']:7s}] {arch:18s} {sn:12s} {args.mesh:8s}"
                    + (f" dom={res.get('bottleneck', '-'):10s}"
                       f" roofline={res.get('roofline_fraction', 0):.2%}"
                       f" trace={res.get('trace_s', 0):.1f}s"
                       if res["status"] == "OK" else
                       f" {res.get('reason', res.get('error', ''))[:90]}"))
            print(line, flush=True)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n{len(results)} cells: "
          f"{sum(r['status'] == 'OK' for r in results)} ok, "
          f"{sum(r['status'] == 'SKIPPED' for r in results)} skipped, "
          f"{n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
