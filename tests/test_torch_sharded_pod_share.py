"""ROADMAP 3.17 on ``pod`` (16 x 16, 256 chips): the four ``train_4k``
cells whose FLOPs a device count under 0.9x ``repro``'s (SmolLM-360M,
Qwen2-VL-2B, Qwen1.5-110B, MusicGen-medium).

Against ``repro``'s compiled HLO on an Auto (16, 16) mesh, by dot
shape: the linear layers' products (its 2-D dots) equal the port's
matmuls to four digits, and the difference is attention, which XLA
repeats over "model" (SmolLM's 15 heads 5 a device, where the port holds
one): its batched dots are 15.0x, 3.0x, 14.0x and 1.5x the port's.  The
port keeps its share (ROADMAP section 3 item 2), so one device counts
its card step over 256, within SHARE_BAND: no device does less than its
share, and none repeats much of another's.

Each cell counts the card's step and the pod's on meta, 30-70 s a cell on
an 8-core x86_64 CPU, so these run in a file of their own
(``--dist loadfile``).
"""

import pytest

from repro_torch.configs import shapes as tshapes
from repro_torch.distributed import context as dctx
from repro_torch.launch import dryrun, op_cost

SHARE_ARCHS = ("smollm-360m", "qwen2-vl-2b", "qwen1.5-110b",
               "musicgen-medium")
# one device's FLOPs over the card's step over 256, as measured: 1.0286,
# 1.0477, 1.0006, 1.0654 (PERF.md section 5)
SHARE_BAND = 0.07


@pytest.mark.parametrize("arch", SHARE_ARCHS)
def test_train_4k_device_flops_are_the_card_step_over_the_chips(arch):
    cfg = dryrun.cell_config(arch)
    shape = tshapes.SHAPES["train_4k"]
    step_fn, args = dryrun.step_and_args(cfg, shape)
    card = op_cost.count(step_fn, *args).flops
    del args
    mesh = dryrun.production_mesh("pod")
    with dctx.fake_process_group(mesh.size):
        cost, _ = dryrun.count_sharded(cfg, shape, mesh)
    ratio = cost.flops / (card / mesh.size)
    print(f"{arch} train_4k: FLOPs a device / (card / {mesh.size}) "
          f"{ratio:.4f}")
    assert 1.0 <= ratio <= 1.0 + SHARE_BAND, (arch, ratio)
