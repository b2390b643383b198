"""One device's share of the sharded step on ``pod`` (16 x 16, 256 chips),
counted on meta under a fake process group (``dryrun.count_sharded``), on
the CPU.

* The dense archs' decode_32k: unsharded / chips <= one device's FLOPs
  <= unsharded.
* ``repro``'s own dry run on an Auto (16, 16) mesh of host devices,
  measured once (``python tests/test_torch_sharded_cost.py pod CELL``)
  and written in ``VS_REPRO_POD``: one device's FLOPs and wire bytes over
  ``repro``'s held within 5% of the ratios measured (``_held``).

A cell takes 2-75 s here, so these run apart from
``tests/test_torch_sharded_cost.py``.
"""

import pytest

from repro_torch.configs import shapes as tshapes
from repro_torch.distributed import context as dctx
from repro_torch.launch import dryrun, op_cost
from test_torch_sharded_cost import _held

DENSE = ("smollm-360m", "rwkv6-3b", "qwen2-vl-2b", "musicgen-medium",
         "gemma2-2b", "qwen3-8b", "qwen1.5-110b")


@pytest.mark.parametrize("arch", DENSE)
def test_dense_arch_device_flops_within_bounds_on_pod(arch):
    """decode_32k at full width on the 256-chip mesh: one device's FLOPs
    at least the unsharded step's over 256 (no device can do less than
    its share) and at most the unsharded step's (none redoes the
    whole)."""
    cfg = dryrun.cell_config(arch)
    shape = tshapes.SHAPES["decode_32k"]
    step_fn, args = dryrun.step_and_args(cfg, shape)
    whole = op_cost.count(step_fn, *args).flops
    mesh = dryrun.production_mesh("pod")
    with dctx.fake_process_group(mesh.size):
        cost, _ = dryrun.count_sharded(cfg, shape, mesh)
    assert whole / mesh.size <= cost.flops <= whole, (cost.flops, whole)
    assert cost.coll_wire_bytes > 0


# repro's counts on pod, one device's (lower_cell on an Auto (16, 16) mesh
# of 256 host devices: ``python tests/test_torch_sharded_cost.py pod
# CELL``; 30-200 s a run, so measured once and written here): "flops" and
# "wire" are port / repro as measured, held within 5% (_held).
# * The prefills whose heads split unevenly: the port splits heads that
#   do not divide the 16 model devices in torch.chunk's blocks; XLA splits
#   them gcd(H, 16) ways and the rest of the axis over the head dim where
#   it divides it, or not at all.  SmolLM (15 heads: XLA the head dim 16
#   ways), Qwen3, Kimi and Qwen1.5 (32 or 64 q heads, 8 KV heads) agree
#   within 2%; MusicGen's 24 and Qwen2-VL's 12 heads XLA splits only 8
#   and 4 ways, computing 3 heads a device where the port computes 2 and
#   1 (0.73x, 0.44x).  Gemma2's 8 heads each take 2 of the 16 model
#   devices by query rows (zig-zag halves of the causal triangle), 1.00x
#   (1.37x while half the devices held no head; ROADMAP 3.8); its post
#   norms take each sublayer's sum reduced once, in the stream's dtype
#   (ROADMAP 3.16): wire 0.21x (0.84x while DTensor reduced it after the
#   norm's float32 cast, twice a norm).
# * The training steps: the linear layers' products placed by hand
#   (sharding.placed_matmul), forward and backward on each device's
#   blocks, so no product runs on a whole weight (ROADMAP 3.10; 1.44-2.25x
#   while DTensor's propagation gathered the row-split weights for the
#   backward), and each pattern repeat recomputed in the backward as
#   repro's jax.checkpoint does (ROADMAP 3.13; 0.57-0.81x before): Qwen3,
#   Kimi and Jamba 1.00-1.04x, Gemma2 and MusicGen 0.92x and 0.89x,
#   Qwen2-VL and Qwen1.5 0.75x and 0.70x, where one device of the port
#   counts within 6.5% of the card's step over 256 and XLA replicates
#   more of it over "model" (its attention: ROADMAP 3.17, held in
#   tests/test_torch_sharded_pod_share.py).  Gemma2's wire bytes 0.34x
#   (1.76x while its post norms reduced in float32, 3.16).  Kimi's
#   adafactor update keeps each factored leaf's update on its parameter's
#   blocks (ROADMAP 3.14): its wire bytes 0.38x (1.71x while the RMS of
#   each expert update was gathered whole).
# * A batch of one (long_500k): the data axis it leaves idle splits the
#   weights' free dims, and RWKV-6's decode reads its whole state's y in
#   column blocks over it (ROADMAP 3.9): RWKV6 0.81x (8.93x; 0.90x while
#   its LoRA products ran whole on every model device and its decode read
#   y at every head, 3.15), where XLA repeats the products over the idle
#   axis, its wire 4.1x (the outputs' gathers); Jamba 1.00x (1.14x while
#   every data device weighed the values of its block of the cache whole,
#   a product XLA splits over the idle axis, 3.12).
VS_REPRO_POD = {
    "smollm-360m:prefill_32k": {"repro_flops": 11294511302659.0,
                                "repro_wire": 281316578880,
                                "flops": 1.0093, "wire": 0.062389},
    "qwen3-8b:prefill_32k": {"repro_flops": 98245597058224.0,
                             "repro_wire": 177912639488,
                             "flops": 0.98336, "wire": 0.43524},
    "gemma2-2b:prefill_32k": {"repro_flops": 26157059079655.0,
                              "repro_wire": 187309608704,
                              "flops": 0.99643, "wire": 0.20923},
    "musicgen-medium:prefill_32k": {"repro_flops": 56676164465284.0,
                                    "repro_wire": 137084570112,
                                    "flops": 0.72864, "wire": 0.30327},
    "kimi-k2-1t-a32b:prefill_32k": {"repro_flops": 446636627210200.0,
                                    "repro_wire": 1399827219456,
                                    "flops": 0.98737, "wire": 0.29164},
    "qwen2-vl-2b:prefill_32k": {"repro_flops": 58952669039403.0,
                                "repro_wire": 47359783680,
                                "flops": 0.44383, "wire": 0.58646},
    "qwen1.5-110b:prefill_32k": {"repro_flops": 1074415696461062.0,
                                 "repro_wire": 976284696576,
                                 "flops": 0.99319, "wire": 0.35191},
    "olmoe-1b-7b:prefill_32k": {"repro_flops": 19653696516195.0,
                                "repro_wire": 440442271744,
                                "flops": 0.98127, "wire": 0.042282},
    "jamba-v0.1-52b:prefill_32k": {"repro_flops": 111268998229405.0,
                                   "repro_wire": 150881304576,
                                   "flops": 0.99712, "wire": 0.82563},
    "qwen3-8b:train_4k": {"repro_flops": 258957770863958.0,
                          "repro_wire": 605808068837.5,
                          "flops": 0.99924, "wire": 0.3194},
    "qwen1.5-110b:train_4k": {"repro_flops": 4912957269652078.0,
                              "repro_wire": 14459087550674.0,
                              "flops": 0.70282, "wire": 0.059595},
    "gemma2-2b:train_4k": {"repro_flops": 103156371656131.0,
                           "repro_wire": 328084205582.5,
                           "flops": 0.92195, "wire": 0.34283},
    "musicgen-medium:train_4k": {"repro_flops": 81856078678499.0,
                                 "repro_wire": 303030668641.5,
                                 "flops": 0.8947, "wire": 0.32104},
    "qwen2-vl-2b:train_4k": {"repro_flops": 76893382564586.0,
                             "repro_wire": 193942523504.5,
                             "flops": 0.74585, "wire": 0.36526},
    "jamba-v0.1-52b:train_4k": {"repro_flops": 438309244593097.0,
                                "repro_wire": 408621240721.5,
                                "flops": 1.0351, "wire": 0.90723},
    "kimi-k2-1t-a32b:train_4k": {"repro_flops": 1341408413019633.0,
                                 "repro_wire": 3095363732077.5,
                                 "flops": 1.0009, "wire": 0.37631},
    "rwkv6-3b:long_500k": {"repro_flops": 53256870.0,
                           "repro_wire": 695047,
                           "flops": 0.80926, "wire": 4.1245},
    "jamba-v0.1-52b:long_500k": {"repro_flops": 6877973113.0,
                                 "repro_wire": 10571409959.5,
                                 "flops": 0.99728, "wire": 0.50353},
}


@pytest.mark.parametrize("cell", list(VS_REPRO_POD))
def test_pod_ratios_to_repro_hold(cell):
    """One device's FLOPs and wire bytes on pod over repro's, within 5%
    of the ratios measured (PERF.md section 5)."""
    arch, shape = cell.split(":")
    mesh = dryrun.production_mesh("pod")
    with dctx.fake_process_group(mesh.size):
        cost, _ = dryrun.count_sharded(dryrun.cell_config(arch),
                                       tshapes.SHAPES[shape], mesh)
    want = VS_REPRO_POD[cell]
    flops = cost.flops / want["repro_flops"]
    wire = cost.coll_wire_bytes / want["repro_wire"]
    print(f"{cell}: FLOPs {flops:.4f}, wire {wire:.4f}")
    assert _held(flops, want["flops"]), (cell, flops)
    assert _held(wire, want["wire"]), (cell, wire)
