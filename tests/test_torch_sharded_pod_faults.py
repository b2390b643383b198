"""ROADMAP faults 3.15 and 3.16 on ``pod`` (16 x 16, 256 chips): one
device's share of the sharded step counted on meta under a fake process
group (``dryrun.count_sharded``), on the CPU, against ``repro``'s counts
on an Auto (16, 16) mesh of host devices as measured (``python
tests/test_torch_sharded_cost.py pod CELL``), each ratio held within 5%
(``_held``).

* 3.16, Gemma2-2B: its post norms take each sublayer's partial sum
  reduced once, in the stream's dtype (``transformer._residual``); left
  to the norm, DTensor reduced it after the norm's float32 cast, twice a
  norm.  The decode's wire bytes 0.706x ``repro``'s (1.555x before), and
  no all-reduce comes from a norm.
* 3.15, RWKV6-3B: its LoRA products (``mix_w1``, ``mix_w2``, decay
  ``w1``, ``w2``) on each model device's columns (``rwkv6.
  _mixes_on_model``: 1.19-1.32x ``repro``'s FLOPs while they ran whole
  on every model device), the decode, whose cache keeps the 40 heads
  whole, reading y at each device's heads of the whole state, and the
  recurrence's inputs scanned as ``lax.scan``'s xs (``op_cost.scan``),
  whose backward no longer makes a gradient of their whole shape a
  token.  FLOPs 0.996-1.036x ``repro``'s, wire bytes 0.28-0.74x.

The RWKV-6 prefill takes about 30 s on an 8-core x86_64 CPU, so these
run in a file of their own (``--dist loadfile``).
"""

import pytest

from repro_torch.configs import shapes as tshapes
from repro_torch.distributed import context as dctx
from repro_torch.launch import dryrun, op_cost
from test_torch_sharded_cost import _held

# repro_flops / repro_wire: repro's FLOPs (its whole-program count over
# 256) and wire bytes a device; flops / wire: the port's over repro's as
# measured (PERF.md section 5)
VS_REPRO_POD_FAULTS = {
    "gemma2-2b:decode_32k": {"repro_flops": 6145591822.0,
                             "repro_wire": 16940416.0,
                             "flops": 0.99990, "wire": 0.70586},
    "rwkv6-3b:decode_32k": {"repro_flops": 2981562825.0,
                            "repro_wire": 25815860.0,
                            "flops": 1.0364, "wire": 0.73932},
    "rwkv6-3b:prefill_32k": {"repro_flops": 23051495671052.0,
                             "repro_wire": 210182327040.0,
                             "flops": 0.99710, "wire": 0.39907},
    "rwkv6-3b:train_4k": {"repro_flops": 97976059020246.0,
                          "repro_wire": 871434560414.5,
                          "flops": 0.99616, "wire": 0.28295},
}
# the faults' targets: FLOPs a device at most this over repro's (3.15),
# and wire bytes at most repro's
FLOPS_OVER_REPRO_MAX = 1.05


def _pod_cost(cell):
    arch, shape = cell.split(":")
    mesh = dryrun.production_mesh("pod")
    with dctx.fake_process_group(mesh.size):
        cost, _ = dryrun.count_sharded(dryrun.cell_config(arch),
                                       tshapes.SHAPES[shape], mesh)
    return cost


@pytest.mark.parametrize("cell", list(VS_REPRO_POD_FAULTS))
def test_fault_cells_hold_their_ratios_to_repro_on_pod(cell):
    """One device's FLOPs and wire bytes on pod over repro's, within 5%
    of the ratios measured, and within the faults' targets."""
    cost = _pod_cost(cell)
    want = VS_REPRO_POD_FAULTS[cell]
    flops = cost.flops / want["repro_flops"]
    wire = cost.coll_wire_bytes / want["repro_wire"]
    print(f"{cell}: FLOPs {flops:.5f}, wire {wire:.5f}")
    assert _held(flops, want["flops"]), (cell, flops)
    assert _held(wire, want["wire"]), (cell, wire)
    assert flops <= FLOPS_OVER_REPRO_MAX and wire <= 1.0, (cell, flops, wire)


def test_gemma2_post_norms_reduce_the_stream_once_in_its_dtype():
    """Fault 3.16: in Gemma2-2B's decode_32k on pod no all-reduce is
    issued by a norm, and every all-reduce of the residual stream
    (8 rows of 2304 a device) is in bfloat16, apart from the embedding
    lookup's partial sums of its float32 table (as repro's)."""
    with op_cost.collective_sites() as sites:
        _pod_cost("gemma2-2b:decode_32k")
    reduced = [(site, dtype) for kind, site, shape, dtype in sites
               if kind == "all-reduce"]
    assert reduced
    assert not [site for site, _ in reduced if "rmsnorm_apply" in site]
    stream = [(site, dtype) for kind, site, shape, dtype in sites
              if kind == "all-reduce" and shape == (8, 1, 2304)]
    assert [site for site, _ in stream if "_stream" in site]
    assert all(dtype == "torch.bfloat16" or "embedding" in site
               for site, dtype in stream), stream
