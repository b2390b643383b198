"""One device's share of a sharded step (``launch/op_cost.py`` over
DTensors, ``dryrun.count_sharded``), on the CPU.

* The counter over DTensors: an op is charged by the ops on its local
  blocks (one device's FLOPs, bytes and peak), the redistributions'
  collectives by the ring rules, DTensor's sharding propagation (fake
  tensors of the global shapes) and host bookkeeping never.
* A data-parallel (4, 1) mesh: the scaled SmolLM training step's FLOPs
  equal the unsharded step's at a quarter of the batch, apart from the
  scalars listed at the test, and its all-reduce wire bytes are the
  gradients' ring all-reduce, by hand.
* The products placed by hand (``sharding.placed_matmul``): the scaled
  Qwen3-8B step's matmul FLOPs on fake (1, 4), (2, 4) and (16, 16)
  groups == the unsharded step's share, no product taking a model-split
  dim whole.
* ``repro``'s own dry run (``lower_cell``) on an Auto (2, 4) host mesh,
  in a subprocess of 8 host devices, against the port's count on the
  same mesh shape: the measured ratios held at ``VS_REPRO``
  (``tests/test_torch_sharded_pod.py`` holds ``pod``'s).
* Real values on four gloo ranks: the scaled() train, prefill and
  decode steps on DTensors over a (2, 2) mesh == the plain steps, heads
  that do not divide "model" (q, KV or RWKV-6's), heads that share the
  model devices by query rows, a batch of one and Jamba among them;
  each role ``placed_matmul`` gives a mesh dim, product and gradients.
* The pieces the sharded step needs: the flash op's sharding (blocks on
  batch and heads, even or not) and a block of no heads,
  ``local_block`` / ``global_value`` on DTensors, the head views
  (``torch.chunk``'s blocks of whole heads), the recurrences through
  ``op_cost.scan`` with DTensor carries (scaled == eager, exactly), and
  a one-device mesh's DTensor step == the plain step, bit for bit.
"""

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.checkpoint.ckpt import Mesh
from repro_torch.configs import shapes as tshapes
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention, rwkv6
from repro_torch.train import steps

META = torch.device("meta")
MESH_2X4 = Mesh.abstract((2, 4), ("data", "model"))


def _meta(*shape):
    return torch.empty(shape, device=META)


def test_counter_charges_one_devices_blocks():
    """(x @ w).relu() @ w2, x split on rows over "data", w on columns and
    w2 on rows over "model", the result gathered back to the rows'
    layout: one device's FLOPs (its 32 x 128 x 64 and 32 x 64 x 128
    products and its 32 x 64 relu), the partial sums' all-reduce over the
    4 model devices (2 x 16,384 bytes x 3/4) and the blocks' bytes."""
    with dctx.fake_process_group(8):
        dmesh = dctx.device_mesh(MESH_2X4)
        x = shd.NamedSharding(dmesh, shd.P("data", None),
                              (Shard(0), Replicate())).distribute(
            _meta(64, 128))
        w = shd.NamedSharding(dmesh, shd.P(None, "model"),
                              (Replicate(), Shard(1))).distribute(
            _meta(128, 256))
        w2 = shd.NamedSharding(dmesh, shd.P("model", None),
                               (Replicate(), Shard(0))).distribute(
            _meta(256, 128))

        def chain(x, w, w2):
            return ((x @ w).relu() @ w2).redistribute(
                dmesh, [Shard(0), Replicate()])

        cost = op_cost.count(chain, x, w, w2)
    device = 2 * 32 * 128 * 64 + 32 * 64 + 2 * 32 * 64 * 128
    assert cost.flops == device == 1_050_624
    assert cost.coll_breakdown["all-reduce"] == 2 * 32 * 128 * 4 * 3 / 4
    assert cost.coll_wire_bytes == 24_576
    assert cost.argument_bytes == (32 * 128 + 128 * 64 + 64 * 128) * 4
    assert cost.output_bytes == 32 * 128 * 4


def test_data_parallel_step_is_the_unsharded_step_at_a_quarter_batch():
    """A (4, 1) mesh, the scaled (non-FSDP) SmolLM training step at B=8:
    each device runs the unsharded step's ops at B=2, and its gradients
    are all-reduced over the 4 data devices.

    Listed scalars (FLOPs): DTensor makes a replicated scalar partial
    over the batch's devices by dividing it by their number, once where
    ``chunked_ce`` adds the first chunk's partial sum to its zero total
    and once where ``make_loss_fn`` adds the (replicated, zero) aux loss
    to the partial CE: 2 FLOPs.  The loss stays a partial sum (nothing
    reads it whole inside the step) and the gradients are whole before
    the clip, so the grad norm adds no collective: the all-reduce is the
    gradients' alone."""
    cfg = dryrun.cell_config("smollm-360m").scaled()
    assert not cfg.fsdp
    mesh = Mesh.abstract((4, 1), ("data", "model"))
    with dctx.fake_process_group(4):
        cost, per_device = dryrun.count_sharded(
            cfg, tshapes.ShapeSpec("t", 16, 8, "train"), mesh)
    step_fn, args = dryrun.step_and_args(
        cfg, tshapes.ShapeSpec("t", 16, 2, "train"))
    quarter = op_cost.count(step_fn, *args)
    scalars = 2
    assert cost.flops == quarter.flops + scalars
    grad_bytes = sum(t.numel() * 4 for _, t in
                     shd.leaves_with_path(args[0]["params"]))
    assert cost.coll_breakdown["all-reduce"] == 2 * grad_bytes * 3 / 4
    assert cost.coll_wire_bytes == cost.coll_breakdown["all-reduce"]
    assert per_device["batch"] == 2 * 16 * 4 * 2     # tokens, labels: int32
    assert per_device["params"] == grad_bytes


MATMULS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm)


def _matmul_charges(monkeypatch) -> list:
    """The list every matmul (``MATMULS``) the counter charges from now
    on is appended to: (FLOPs, its operands' shapes)."""
    seen = []
    charge = op_cost._flops

    def spy(func, packet, args, kwargs, out, ins, outs):
        flops = charge(func, packet, args, kwargs, out, ins, outs)
        if packet in MATMULS:
            seen.append((flops, [tuple(t.shape) for t in ins]))
        return flops
    monkeypatch.setattr(op_cost, "_flops", spy)
    return seen


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 4), (16, 16)],
                         ids=lambda shape: "x".join(map(str, shape)))
def test_sharded_step_matmuls_are_the_devices_share(mesh_shape,
                                                    monkeypatch):
    """Fault 3.10: the scaled() Qwen3-8B training step (H = 4, KH = 1,
    F = 192, vocab 512: every model-split dim divides the model axis) at
    S = 64 on a fake group: one device's matmul FLOPs (mm, bmm, addmm)
    == the unsharded step's at the device's batch (B = 8 over the data
    devices; 16 on (16, 16)) over the model devices, within 2% (1.331x on
    (1, 4) and (2, 4) while DTensor's propagation placed the backward's
    products: it gathered the row-split weights whole for a cotangent
    that is a partial sum over "model"), and no product takes F or the
    vocab whole.  On (16, 16) the 4 heads share the 16 model devices by
    query rows."""
    cfg = dryrun.cell_config("qwen3-8b").scaled()
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
            cfg.vocab_size) == (4, 1, 192, 512)
    dp, tp = mesh_shape
    batch = 16 if dp == 16 else 8
    seen = _matmul_charges(monkeypatch)
    step_fn, args = dryrun.step_and_args(
        cfg, tshapes.ShapeSpec("t", 64, batch // dp, "train"))
    op_cost.count(step_fn, *args)
    whole = sum(f for f, _ in seen)
    seen.clear()
    mesh = Mesh.abstract(mesh_shape, ("data", "model"))
    with dctx.fake_process_group(mesh.size):
        dryrun.count_sharded(cfg, tshapes.ShapeSpec("t", 64, batch,
                                                    "train"), mesh)
    device = sum(f for f, _ in seen)
    print(f"{mesh_shape}: matmul FLOPs a device / (unsharded / {tp}) "
          f"{device / (whole / tp):.4f}")
    assert abs(device / (whole / tp) - 1) <= 0.02, (device, whole)
    tokens = batch // dp * 64
    split = {cfg.d_ff, cfg.vocab_size} - {tokens}
    assert not [shapes for _, shapes in seen
                if split & {d for shape in shapes for d in shape}]


# repro's lower_cell on an Auto mesh of host devices: argv[1] the mesh
# ("2x4", "pod" or "multipod"), then the cells; their records' counts
# come back as JSON
_REPRO = r"""
import json, os, sys
shape, names = {"2x4": ((2, 4), ("data", "model")),
                "pod": ((16, 16), ("data", "model")),
                "multipod": ((2, 16, 16), ("pod", "data", "model"))}[
                    sys.argv[1]]
n = 1
for size in shape:
    n *= size
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
import jax
jax.devices()               # n host devices, before repro's dryrun sets 512
from jax.sharding import AxisType
from repro.launch import dryrun
mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
out = {}
for cell in sys.argv[2:]:
    arch, shape_name = cell.split(":")
    rec = dryrun.lower_cell(arch, shape_name, mesh, sys.argv[1])
    out[cell] = {k: rec.get(k) for k in (
        "status", "chips", "hlo_flops", "hlo_bytes", "coll_bytes_per_chip",
        "coll_breakdown")}
print(json.dumps(out))
"""


def repro_counts(mesh: str, cells, timeout: float = 600):
    """Start ``repro``'s dry run of ``cells`` ("arch:shape") on an Auto
    mesh ("2x4", "pod", "multipod") in a subprocess; returns the
    process (its last stdout line is the JSON of the records)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(p for p in (
                   "src", os.environ.get("PYTHONPATH")) if p))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", _REPRO, mesh, *cells],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
# The port's count (one device's x 8) against repro's on the same (2, 4)
# mesh, port / repro, as measured: FLOPs, and the collectives' wire bytes
# by family (gathers: all-gather; reductions: all-reduce and
# reduce-scatter, summed because XLA's CPU pipeline keeps an all-reduce
# and a dynamic slice where DTensor reduce-scatters; reshards: all-to-all
# and collective-permute) where repro's family carries at least 1% of its
# wire bytes.  Both counts are deterministic, so each ratio is held within
# VS_REPRO_HOLD of its measured value: a change that moves one is a change
# of the partitioning, to be written into PERF.md section 5 with the new
# value here.  Both programs hold the arguments to the same specs; XLA's
# SPMD partitioner and DTensor propagate them through the step otherwise:
# * FLOPs: decode and SmolLM's prefill_32k agree (0.997-1.04; the port
#   splits SmolLM's 15 q and 5 KV heads over the 4 model devices in
#   torch.chunk's blocks, 4, 4, 4 and 3, each with the KV heads it reads);
#   the training steps recompute each pattern repeat in the backward, as
#   repro's jax.checkpoint does (OLMoE 1.00; 0.77 before); XLA replicates
#   more of SmolLM's step over "model" (0.52).  RWKV-6's decode runs its
#   LoRA products on each model device's columns and reads y at its heads
#   of the whole state (ROADMAP 3.15: 1.04 while the products ran whole),
#   gathering the mixes whole for the projections (gathers 0.42; 0.08
#   before).
# * gathers, 0-0.64: XLA gathers the FSDP'd and model-split weights at
#   each use, forward and backward, where the port gathers only FSDP'd
#   ones: its SmolLM training step (products placed by hand) and prefill
#   gather nothing.
# * reductions, 0.06-0.67: XLA's partitioning reduces more partial sums
#   than DTensor's (in SmolLM's prefill it reduces the attention scores
#   over the head dim it splits); the kinds are not broken down further.
# * reshards: OLMoE 0.15 (XLA moves the expert blocks and activations by
#   all-to-alls and collective-permutes in the forward and again in the
#   backward); SmolLM's prefill 0.25 (the port's all-to-alls moving the
#   projections' columns into whole heads and back).
# Where repro's family carries less than 1%, the port's must stay under
# VS_REPRO_STRAY of its own wire bytes.
VS_REPRO = {
    "smollm-360m:train_4k": {"flops": 0.5205, "gathers": 0.0,
                             "reductions": 0.3162},
    "smollm-360m:decode_32k": {"flops": 0.9965, "gathers": 0.6400,
                               "reductions": 0.6735},
    "smollm-360m:prefill_32k": {"flops": 1.0080, "gathers": 0.0,
                                "reductions": 0.0606, "reshards": 0.2489},
    "olmoe-1b-7b:train_4k": {"flops": 0.9996, "gathers": 0.0800,
                             "reductions": 0.1820, "reshards": 0.2273},
    "rwkv6-3b:decode_32k": {"flops": 1.0000, "gathers": 0.4198,
                            "reductions": 0.3745},
}
VS_REPRO_HOLD, VS_REPRO_STRAY = 0.05, 0.10
FAMILIES = {"gathers": ("all-gather",),
            "reductions": ("all-reduce", "reduce-scatter"),
            "reshards": ("all-to-all", "collective-permute")}


def _families(breakdown) -> dict:
    return {f: sum(breakdown[k] for k in kinds)
            for f, kinds in FAMILIES.items()}


def _held(got: float, want: float) -> bool:
    return abs(got - want) <= VS_REPRO_HOLD * want


def test_counts_against_repros_dry_run_on_an_auto_2x4_mesh():
    proc = repro_counts("2x4", VS_REPRO)
    port = {}
    try:
        for cell in VS_REPRO:
            arch, shape = cell.split(":")
            with dctx.fake_process_group(MESH_2X4.size):
                cost, _ = dryrun.count_sharded(dryrun.cell_config(arch),
                                               tshapes.SHAPES[shape],
                                               MESH_2X4)
            port[cell] = (cost.flops * MESH_2X4.size, cost.coll_breakdown)
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    repro = json.loads(out.strip().splitlines()[-1])
    for cell, want in VS_REPRO.items():
        flops, breakdown = port[cell]
        ratio = flops / repro[cell]["hlo_flops"]
        print(f"{cell}: FLOPs port / repro {ratio:.4f}")
        assert _held(ratio, want["flops"]), (cell, ratio)
        mine, theirs = _families(breakdown), _families(
            repro[cell]["coll_breakdown"])
        total, their_total = sum(mine.values()), sum(theirs.values())
        for family in FAMILIES:
            if family in want:
                assert theirs[family] >= 0.01 * their_total
                r = mine[family] / theirs[family]
                print(f"  {family}: {r:.4f}")
                assert _held(r, want[family]), (cell, family, r)
            else:
                assert theirs[family] < 0.01 * their_total
                assert mine[family] <= VS_REPRO_STRAY * total, (
                    cell, family, mine[family], total)


def test_flash_op_runs_on_blocks_of_batch_and_heads():
    """The op on DTensors split on the batch over "data" and on the heads
    over "model" (KH = 4 over 4 devices): its output split alike, one
    device's FLOPs, no collective, and its block == the plain version on
    its blocks.  With H = 4, KH = 2 the q blocks would not read their KV
    blocks, so the op's sharding offers no head split: the heads stay
    whole on every model device.  6 heads over 4 split unevenly, as
    torch.chunk splits them, the last device holding none."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(4, 24, 8, 16, generator=g)
    k, v = (torch.randn(4, 24, 4, 16, generator=g) for _ in range(2))
    place = [Shard(0), Shard(2)]
    with dctx.fake_process_group(8):
        dmesh = init_device_mesh("cpu", (2, 4),
                                 mesh_dim_names=("data", "model"))
        blocks = (q[:2, :, :2], k[:2, :, :1], v[:2, :, :1])
        out = ops.flash_attention(*(DTensor.from_local(t, dmesh, place)
                                    for t in blocks))
        assert list(out.placements) == place
        want = fa.flash_attention_plain(*blocks)
        np.testing.assert_allclose(out.to_local().numpy(), want.numpy(),
                                   rtol=0, atol=0)
        on_meta = [DTensor.from_local(t.to(META), dmesh, place)
                   for t in blocks]
        cost = op_cost.count(ops.flash_attention, *on_meta)
        assert cost.flops == fa.attention_flops(4, 24, 8, 16, True) / 8
        assert cost.coll_wire_bytes == 0
        q2, k2 = (DTensor.from_local(_meta(2, 24, h, 16), dmesh,
                                     [Shard(0), Replicate()])
                  for h in (4, 2))
        cost = op_cost.count(ops.flash_attention, q2, k2, k2)
        assert cost.flops == fa.attention_flops(4, 24, 4, 16, True) / 2
        assert cost.coll_wire_bytes == 0
        assert list(ops.flash_attention(q2, k2, k2).placements) == [
            Shard(0), Replicate()]
        # uneven heads: 6 over the 4 model devices, torch.chunk's blocks
        # 2, 2, 2 and 0 of q's heads and of KV's (a group of one)
        q6 = torch.randn(4, 24, 6, 16, generator=g)
        k6, v6 = (torch.randn(4, 24, 6, 16, generator=g) for _ in range(2))
        assert fa.heads_align(6, 6, 4) and not fa.heads_align(4, 2, 4)
        blocks = (q6[:2, :, :2], k6[:2, :, :2], v6[:2, :, :2])
        out = ops.flash_attention(*(DTensor.from_local(
            t, dmesh, place, shape=(4, 24, 6, 16), stride=(2304, 96, 16, 1))
            for t in blocks))
        assert list(out.placements) == place and out.shape == q6.shape
        np.testing.assert_allclose(out.to_local().numpy(),
                                   fa.flash_attention_plain(*blocks).numpy(),
                                   rtol=0, atol=0)
        on_meta = [DTensor.from_local(t.to(META), dmesh, place,
                                      shape=(4, 24, 6, 16),
                                      stride=(2304, 96, 16, 1))
                   for t in blocks]
        cost = op_cost.count(ops.flash_attention, *on_meta)
        assert cost.flops == fa.attention_flops(2, 24, 2, 16, True)
        assert cost.coll_wire_bytes == 0


def test_flash_takes_a_block_of_no_heads():
    """The last device's block of heads that do not fill the devices
    (H = KH = 0): the plain version and the op on the CPU return it
    empty; any other KH = 0 raises."""
    q = torch.zeros(2, 8, 0, 16)
    for out in (fa.flash_attention_plain(q, q, q), ops.flash_attention(q, q,
                                                                       q)):
        assert out.shape == q.shape and out.dtype == q.dtype
    with pytest.raises(ValueError):
        fa.check_args(torch.zeros(2, 8, 2, 16), q, q)


def test_local_block_and_global_value_take_dtensors():
    """local_block redistributes a DTensor to the spec and takes its
    block (the gradient comes back through DTensor); global_value given
    the DeviceMesh wraps the block as the DTensor of the spec, moving
    nothing."""
    spec = shd.P("data", "model", None)
    with dctx.fake_process_group(8):
        dmesh = dctx.device_mesh(MESH_2X4)
        x = DTensor.from_local(_meta(2, 8, 6), dmesh,
                               [Shard(0), Replicate()]).requires_grad_()
        block = dctx.local_block(x, MESH_2X4, spec)
        assert not isinstance(block, DTensor)
        assert tuple(block.shape) == (2, 2, 6)
        back = dctx.global_value(block * 2, MESH_2X4, spec, x.shape, dmesh)
        assert isinstance(back, DTensor) and back.shape == x.shape
        assert list(back.placements) == [Shard(0), Shard(1)]
        back.sum().backward()
        assert x.grad is not None and x.grad.shape == x.shape


def test_head_views_replicate_heads_that_do_not_divide_the_axis():
    """Heads that do not divide the axis are split unevenly, never
    replicated: 15 heads of 64 (SmolLM-360M's 960) over 16 devices give
    torch.chunk's blocks, one head a device and none on the last; 40
    (RWKV6-3B's) give 3 heads on each of 13 devices and 1 on the 14th; 16 one each.
    The projection's even blocks move to whole heads by one all-to-all
    of uneven splits, charged what this device receives (15 heads: its
    60 columns and 4 more, 4 rows x 4 float32; 40: its 160 and 32 more),
    none where the blocks are whole heads already (16), and the merge
    moves them back.  A plain tensor is reshaped."""
    assert shd.chunk_ranges(15, 16) == [(i, i + 1) for i in range(15)] + [
        (15, 15)]
    assert [b - a for a, b in shd.chunk_ranges(40, 16)] == [3] * 13 + [
        1, 0, 0]
    mesh = dryrun.production_mesh("pod")
    with dctx.fake_process_group(mesh.size):
        dmesh = dctx.device_mesh(mesh)
        for heads, wire in ((15, 4 * 4 * 4.0), (16, 0.0), (40, 4 * 32 * 4.0)):
            x = DTensor.from_local(_meta(1, 4, heads * 64 // 16), dmesh,
                                   [Replicate(), Shard(2)])
            cost = op_cost.count(shd.heads_view, x, 2, (1, 4, heads, 64))
            y = shd.heads_view(x, 2, (1, 4, heads, 64))
            assert list(y.placements) == [Replicate(), Shard(2)]
            assert y.shape == (1, 4, heads, 64)
            assert y.to_local().shape == (1, 4, -(-heads // 16), 64)
            assert cost.coll_wire_bytes == wire, (heads, cost.coll_breakdown)
            back = shd.heads_view(y, 2, (1, 4, heads * 64))
            assert list(back.placements) == [Replicate(), Shard(2)]
            assert back.to_local().shape == x.to_local().shape
    plain = torch.zeros(2, 960)
    assert shd.heads_view(plain, 1, (2, 15, 64)).shape == (2, 15, 64)


@pytest.mark.parametrize("remat", [False, True], ids=["kept", "remat"])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_recurrences_scale_with_dtensor_carries(arch, remat, monkeypatch):
    """The scaled() training step on the (2, 4) mesh, its per-token
    recurrences through op_cost.scan on DTensor carries: scaled (four
    iterations, the middle one's charges x (n - 3)) == every iteration
    run, FLOPs, bytes and wire bytes exactly; with ``remat`` the
    recurrences run again in the backward's recompute, on the carries'
    placements."""
    cfg = dryrun.cell_config(arch).scaled().with_(remat=remat)
    shape = tshapes.ShapeSpec("t", 16, 4, "train")
    with dctx.fake_process_group(8):
        scaled, _ = dryrun.count_sharded(cfg, shape, MESH_2X4)
        monkeypatch.setattr(op_cost, "_counter", lambda: None)
        eager, _ = dryrun.count_sharded(cfg, shape, MESH_2X4)
    assert scaled.flops == eager.flops
    assert scaled.bytes == eager.bytes
    assert scaled.coll_breakdown == eager.coll_breakdown


def test_one_device_dtensor_step_equals_the_plain_step():
    """The host mesh (1, 1) on a one-rank gloo group: the scaled SmolLM
    adamw step on DTensors of the state's specs == the plain step, bit
    for bit, with the same FLOPs and bytes (``chip_smoke.py`` phase 9
    holds the same at full width on the card)."""
    cfg = dryrun.cell_config("smollm-360m").scaled()
    optimizer = dryrun.build_optimizer(cfg)
    step = steps.build_train_step(cfg, optimizer)
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 16), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    state = steps.create_state(cfg, 0, optimizer, device="cpu")
    mesh = tmesh.make_host_mesh(devices=["cpu"])
    plain = op_cost.count(step, state, batch)
    new, metrics = step(state, batch)
    with dctx.local_process_group():
        dmesh = shd.device_mesh(mesh)
        dstate = shd.distribute(state, shd.to_named(
            mesh, steps.state_specs(cfg, mesh, optimizer), dmesh))
        dbatch = shd.distribute(batch, shd.to_named(
            mesh, shd.batch_specs(cfg, mesh, batch), dmesh))
        with dctx.sharded_step(mesh):
            sharded = op_cost.count(step, dstate, dbatch)
            dnew, dmetrics = step(dstate, dbatch)
        got = {p: x.full_tensor() for p, x in shd.leaves_with_path(dnew)}
        loss = dmetrics["loss"].full_tensor()
    assert (sharded.flops, sharded.bytes) == (plain.flops, plain.bytes)
    assert sharded.coll_wire_bytes == 0
    for path, x in shd.leaves_with_path(new):
        assert torch.equal(x, got[path]), path
    assert torch.equal(metrics["loss"], loss)
    assert math.isfinite(float(loss))


@pytest.mark.parametrize("arch", ["smollm-360m", "olmoe-1b-7b"])
def test_one_device_mesh_counts_the_plain_step_at_full_width(arch):
    """A mesh of one device, (1, 1), under a fake group of one rank: the
    full-width training step (8 x 1024) on DTensors counts exactly the
    plain step's FLOPs and bytes, and no wire bytes (what phase 9 of
    ``chip_smoke.py`` holds on the card, at its own shape)."""
    cfg = dryrun.cell_config(arch)
    shape = tshapes.ShapeSpec("t", 1024, 8, "train")
    step_fn, args = dryrun.step_and_args(cfg, shape)
    plain = op_cost.count(step_fn, *args)
    mesh = Mesh.abstract((1, 1), ("data", "model"))
    with dctx.fake_process_group(1):
        cost, _ = dryrun.count_sharded(cfg, shape, mesh)
    assert (cost.flops, cost.bytes) == (plain.flops, plain.bytes)
    assert cost.coll_wire_bytes == 0


# Real values on a (2, 2) mesh of four gloo ranks: the scaled() train,
# prefill and decode steps on DTensors against the same steps on plain
# tensors.  The heads (H, KH) of each case over the 2 model devices:
# SmolLM's scaled 2 and 1 (q one head a device, the KV head's columns
# moved to both: "moved"); 4 and 2 split evenly with their KV groups;
# 3 and 3 split unevenly (2 and 1 heads); 4 and 1 (the q heads divide
# the axis, the KV head does not).  Gemma2's window and softcap take the
# chunked attention on each device's head blocks.  RWKV-6's 3 heads
# split 2 and 1, each device running the recurrence on its heads (the
# decode, whose cache keeps the 3 heads whole, updating the whole state
# and reading y at its heads), its LoRA products on each device's
# columns (ROADMAP 3.15); Jamba
# (Mamba, MoE and attention layers, H = 4, KH = 1) reduces x_proj's
# partial sums once a layer before the scan.  The cache (L = 32) splits
# its positions over "model": the decode at position 16 writes into the
# second block only and reads both split-K.  The tied embedding's vocab
# splits over "model": the lookup and the loss are vocab-parallel.  The
# train step takes one SGD step without momentum, whose new momentum is
# the gradient.  Everything runs in float32.
REAL_MESH = ((2, 2), ("data", "model"))
_ATTN = ("_split_k_decode", "split_write", "head_blocks")
_LM = ("_vocab_parallel_lse_gold", "sharded_embedding")
# case: (arch, (H, KH) or None for the scaled config's, the DTensor-only
# paths it takes: every other path of REAL_PATHS must stay untaken)
REAL_CASES = {
    "smollm-360m": ("smollm-360m", None, _LM + _ATTN + ("flash", "moved")),
    "smollm-360m-h4": ("smollm-360m", (4, 2), _LM + _ATTN + ("flash",)),
    "smollm-360m-h3": ("smollm-360m", (3, 3),
                       _LM + _ATTN + ("flash", "moved")),
    "smollm-360m-h4-kv1": ("smollm-360m", (4, 1),
                           _LM + _ATTN + ("flash", "moved")),
    "gemma2-2b-h4": ("gemma2-2b", (4, 2), _LM + _ATTN),
    "olmoe-1b-7b": ("olmoe-1b-7b", None, _LM + _ATTN + ("flash",)),
    "rwkv6-3b": ("rwkv6-3b", None, _LM + ("moved", "wkv_blocks",
                                          "model_mixes")),
    "jamba-v0.1-52b": ("jamba-v0.1-52b", None,
                       _LM + _ATTN + ("flash", "moved")),
    "gemma2-2b-h1": ("gemma2-2b", (1, 1),
                     _LM + ("_split_k_decode", "split_write", "moved",
                            "query_rows")),
    "rwkv6-3b-b1": ("rwkv6-3b", None,
                    _LM + ("moved", "wkv_blocks", "idle_split",
                           "model_mixes")),
    "olmoe-1b-7b-b1": ("olmoe-1b-7b", None,
                       _LM + _ATTN + ("flash", "idle_split")),
    "jamba-v0.1-52b-remat": ("jamba-v0.1-52b", None,
                             _LM + _ATTN + ("flash", "moved")),
}
REAL_B, REAL_S, REAL_L = 4, 16, 32
# the cases at a batch of one, which does not split over "data" (MoE's
# training step takes the expert-parallel decode path there: fault 3.11)
REAL_BATCH = {"rwkv6-3b-b1": 1, "olmoe-1b-7b-b1": 1,
              "jamba-v0.1-52b-b1": 1}
# the cases whose training step recomputes each pattern repeat in the
# backward (cfg.remat, which scaled() turns off): placed_matmul's
# Functions and the collectives of a repeat run again there
REAL_REMAT = ("jamba-v0.1-52b-remat",)
# Jamba at a batch of one, fault 3.11's case, held apart: its Mamba
# layers' gradients differ from the plain step's by float32 rounding
# alone, up to 1.37e-5 of a leaf's largest entry, past REAL_TOL (in
# float64 the two steps agree within 2.8e-14, and the plain float32 step
# is itself up to 1.69e-5 off float64 there); every other result of
# the case is held at REAL_TOL
REAL_EP_B1 = {"jamba-v0.1-52b-b1": ("jamba-v0.1-52b", None,
                                    _LM + _ATTN + ("flash", "moved",
                                                   "idle_split"))}
# float32 sums taken in another order (the vocab blocks' partial sums,
# split-K's partial softmax, the gradients' all-reduce): 1e-5 of each
# leaf's largest entry
REAL_TOL = 1e-5
# the DTensor-only paths counted in the ranks: "flash" the op on a
# device's blocks, "moved" an all-to-all of uneven splits
# (sharding.move_blocks: heads that do not fill the devices evenly),
# "wkv_blocks" RWKV-6's recurrence on each device's heads, "model_mixes"
# RWKV-6's LoRA products on each device's columns of "model" (ROADMAP
# 3.15: the cases "rwkv6-3b" and "rwkv6-3b-b1")
REAL_PATHS = ("_split_k_decode", "_vocab_parallel_lse_gold",
              "sharded_embedding", "split_write", "head_blocks", "flash",
              "moved", "wkv_blocks", "query_rows", "idle_split",
              "model_mixes")


def _real_cfg(case):
    arch, heads, _ = {**REAL_CASES, **REAL_EP_B1}[case]
    cfg = dryrun.cell_config(arch).scaled().with_(
        dtype="float32", param_dtype="float32", remat=case in REAL_REMAT)
    if heads is not None:
        cfg = cfg.with_(num_heads=heads[0], num_kv_heads=heads[1])
    if cfg.moe:
        # EP == the dense MoE: no token dropped, and no load-balance loss
        # (EP's, as repro's, is the mean of each device's, not the
        # whole batch's)
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k,
            router_aux_weight=0.0))
    return cfg


def _real_steps(case, mesh=None, seen=None):
    """The case's train, prefill and decode steps on plain tensors, or on
    DTensors of their specs over ``mesh``; every result whole, as numpy.
    ``seen`` counts the sharded embedding and cache the steps get."""
    from repro_torch.optim import optimizers as opt
    from repro_torch.train import serve
    cfg = _real_cfg(case)
    rng = np.random.default_rng(0)
    ids = lambda *shape: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, shape).astype(np.int32))
    rows = REAL_BATCH.get(case, REAL_B)
    batch = {"tokens": ids(rows, REAL_S), "labels": ids(rows, REAL_S)}
    tok = ids(rows, 1)
    sgd = opt.sgdm(lambda step: torch.ones(()), momentum=0.0)
    state = steps.create_state(cfg, 0, sgd, device="cpu")
    _, cache = serve.build_prefill_step(cfg, max_len=REAL_L)(
        state["params"], {"tokens": batch["tokens"]})
    cache = opt.tree_map(torch.clone, cache)
    run = contextlib.nullcontext()
    if mesh is not None:
        dmesh = shd.device_mesh(mesh)
        place = lambda tree, specs: shd.distribute(
            tree, shd.to_named(mesh, specs, dmesh))
        state = place(state, steps.state_specs(cfg, mesh, sgd))
        batch, tok, cache = (place(t, f(cfg, mesh, t)) for t, f in (
            (batch, shd.batch_specs), (tok, shd.batch_specs),
            (cache, shd.cache_specs)))
        seen["sharded_embedding"] += shd.sharded_axis(
            state["params"]["embed"]["table"], 0) is not None
        seen["split_write"] += any(
            shd.sharded_axis(t, 2) is not None
            for path, t in shd.leaves_with_path(cache) if t.ndim == 5)
        run = dctx.sharded_step(mesh)
    with run:
        new, metrics = steps.build_train_step(cfg, sgd)(state, batch)
        p_logits, p_cache = serve.build_prefill_step(cfg)(
            state["params"], {"tokens": batch["tokens"]})
        d_logits, d_cache = serve.build_decode_step(cfg)(
            state["params"], cache, tok, REAL_S)
    whole = lambda t: (t.full_tensor() if hasattr(t, "full_tensor")
                       else t).detach().numpy()
    out = {f"grad/{path}": whole(g)
           for path, g in shd.leaves_with_path(new["opt_state"]["m"])}
    out.update({"loss": whole(metrics["loss"]),
                "grad_norm": whole(metrics["grad_norm"]),
                "prefill_logits": whole(p_logits),
                "decode_logits": whole(d_logits)})
    for name, tree in (("prefill_cache", p_cache), ("decode_cache", d_cache)):
        out.update({f"{name}/{path}": whole(t)
                    for path, t in shd.leaves_with_path(tree)})
    return out


@contextlib.contextmanager
def _counting_dtensor_paths(seen):
    """Count in ``seen`` the calls of the DTensor-only functions: the
    head blocks' and RWKV-6's on DTensors (its recurrence and its LoRA
    products), the flash op's (only a device's blocks reach it in a
    sharded step) and the moves of uneven blocks."""
    wrapped = {(attention, "_split_k_decode"): "_split_k_decode",
               (steps, "_vocab_parallel_lse_gold"):
                   "_vocab_parallel_lse_gold",
               (attention, "_on_head_blocks"): "head_blocks",
               (ops, "flash_attention"): "flash",
               (shd, "move_blocks"): "moved",
               (shd, "on_blocks"): "wkv_blocks",
               (attention, "query_row_attention"): "query_rows",
               (shd, "gather_blocks"): "idle_split",
               (rwkv6, "_mixes_on_model"): "model_mixes"}
    saved = {key: getattr(*key) for key in wrapped}
    taken = {
        "flash": lambda a: True,
        "moved": lambda a: not all(map(shd.holds, a[2], a[3])),
        "wkv_blocks": lambda a: "wkv" in a[0].__qualname__,
        "idle_split": lambda a: True,
        "model_mixes": lambda a: True,
    }

    def counter(fn, name):
        def counted(*a, **kw):
            seen[name] += taken.get(name, lambda a: any(
                hasattr(x, "placements") for x in a))(a)
            return fn(*a, **kw)
        return counted
    try:
        for key, name in wrapped.items():
            setattr(*key, counter(saved[key], name))
        yield
    finally:
        for key, fn in saved.items():
            setattr(*key, fn)


# sharding.placed_matmul's roles on the (2, 2) mesh, (data, model): x
# (2, 3, 8) and w (8, 12) placed so, each product and both gradients held
# to the plain ones; "fsdp" a weight split over the batch's data axis
# (gathered for the product), "contract" and "idle" a batch of one on
# "data" (x's block of K; w's block of N split again there)
MATMUL_ROLES = {
    "batch+col": ((Shard(0), Replicate()), (Replicate(), Shard(1))),
    "batch+row": ((Shard(0), Shard(2)), (Replicate(), Shard(0))),
    "fsdp+col": ((Shard(0), Replicate()), (Shard(0), Shard(1))),
    "fsdp+row": ((Shard(0), Shard(2)), (Shard(1), Shard(0))),
    "contract+col": ((Replicate(), Replicate()), (Shard(0), Shard(1))),
    "col+row": ((Replicate(), Shard(2)), (Shard(1), Shard(0))),
    "idle+col": ((Replicate(), Replicate()), (Replicate(), Shard(1))),
    "idle+whole": ((Replicate(), Replicate()), (Replicate(), Replicate())),
}


def _matmul_operands():
    rng = np.random.default_rng(1)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((2, 3, 8), (8, 12), (2, 3, 12))]


def _matmul_roles(mesh):
    """Each of MATMUL_ROLES through placed_matmul on real DTensors: the
    product, x's and w's gradients of <product, a fixed cotangent>, whole,
    and whether the product was placed by hand."""
    from torch.distributed.tensor import distribute_tensor
    dmesh = shd.device_mesh(mesh)
    x0, w0, r0 = _matmul_operands()
    out = {}
    for role, (px, pw) in MATMUL_ROLES.items():
        x = distribute_tensor(x0, dmesh, list(px)).requires_grad_()
        w = distribute_tensor(w0, dmesh, list(pw)).requires_grad_()
        y = shd.placed_matmul(x, w, torch.matmul)
        if y is None:
            out[role] = None
            continue
        r = distribute_tensor(r0, dmesh, [Replicate(), Replicate()])
        (y * r).sum().backward()
        out[role] = tuple(t.full_tensor().detach().numpy()
                          for t in (y, x.grad, w.grad))
    return out


def _real_body(rank, world):
    from repro_torch.checkpoint.ckpt import make_mesh
    mesh = make_mesh(*REAL_MESH, devices=["cpu"] * world)
    got = {}
    for case in {**REAL_CASES, **REAL_EP_B1}:
        seen = dict.fromkeys(REAL_PATHS, 0)
        with _counting_dtensor_paths(seen):
            got[case] = (_real_steps(case, mesh, seen), seen)
    got["matmul_roles"] = _matmul_roles(mesh)
    return got if rank == 0 else None


@pytest.fixture(scope="module")
def real_ranks():
    return dctx.run_local(_real_body, math.prod(REAL_MESH[0]),
                          timeout=300)[0]


@pytest.mark.parametrize("case", list(REAL_CASES))
def test_sharded_steps_on_four_ranks_equal_the_plain_steps(real_ranks,
                                                           case):
    """The loss, every gradient, the prefill's logits and cache and the
    decode's logits and written cache, computed on DTensors over the
    (2, 2) mesh, == the plain steps within REAL_TOL, and the DTensor-only
    paths each taken (OLMoE's through expert parallelism)."""
    got, seen = real_ranks[case]
    want = _real_steps(case)
    assert set(got) == set(want)
    for key, w in want.items():
        tol = REAL_TOL * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[key], w, rtol=0, atol=tol,
                                   err_msg=f"{case}: {key}")
    taken = REAL_CASES[case][2]
    for path in REAL_PATHS:
        assert (seen[path] > 0) == (path in taken), (case, path, seen)

def test_ep_decode_training_at_a_batch_of_one_on_four_ranks(real_ranks):
    """Fault 3.11: Jamba's training step at B = 1, whose MoE layers take
    the expert-parallel decode path, on DTensors over the (2, 2) mesh:
    the loss, the logits, the caches and the gradients of the embedding,
    the router, the experts, attention, the MLPs and the norms == the
    plain step's within REAL_TOL (up to 2.2e-4 off while the aux loss's
    gradient was halved by its mean over "data").  The Mamba layers'
    gradients, which differ by float32 rounding alone (REAL_EP_B1), are
    not held here."""
    case = "jamba-v0.1-52b-b1"
    got, seen = real_ranks[case]
    want = _real_steps(case)
    assert set(got) == set(want)
    held = [key for key in want if "/mamba/" not in key]
    assert len(held) > len(want) // 2
    for key in held:
        tol = REAL_TOL * max(float(np.abs(want[key]).max()), 1e-30)
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol,
                                   err_msg=f"{case}: {key}")
    taken = REAL_EP_B1[case][2]
    for path in REAL_PATHS:
        assert (seen[path] > 0) == (path in taken), (case, path, seen)


@pytest.mark.parametrize("role", list(MATMUL_ROLES))
def test_placed_matmul_roles_on_four_ranks(real_ranks, role):
    """x @ w placed by hand (sharding.placed_matmul) on real DTensors over
    the (2, 2) mesh, each role of a mesh dim: the product and both
    gradients == the plain ones within REAL_TOL."""
    got = real_ranks["matmul_roles"][role]
    assert got is not None, f"{role}: not placed by hand"
    x, w, r = _matmul_operands()
    want = (x @ w, r @ w.t(), x.reshape(-1, 8).t() @ r.reshape(-1, 12))
    for name, g, ww in zip(("y", "dx", "dw"), got, want):
        ww = ww.numpy()
        np.testing.assert_allclose(g, ww, rtol=0,
                                   atol=REAL_TOL * float(np.abs(ww).max()),
                                   err_msg=f"{role}: {name}")


if __name__ == "__main__":
    # repro's own dry run on an Auto mesh, the counts PERF.md sets beside
    # the port's: python tests/test_torch_sharded_cost.py pod \
    #     smollm-360m:train_4k ...  (PYTHONPATH=src, from the repo root)
    done = repro_counts(sys.argv[1], sys.argv[2:])
    out, err = done.communicate()
    sys.stderr.write(err[-3000:] if done.returncode else "")
    print(out.strip().splitlines()[-1] if out.strip() else "")
    raise SystemExit(done.returncode)
