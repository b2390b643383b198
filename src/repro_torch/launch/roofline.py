"""Roofline analysis of a counted step on the H100.

The counterpart of ``repro.launch.roofline``.  Three terms a (arch x
shape x mesh) cell, all in seconds:

  compute    = FLOPs              / (chips * peak FLOP/s of the compute type)
  memory     = bytes accessed     / (chips * HBM B/s)
  collective = collective bytes a card / link B/s

FLOPs and bytes come from ``launch/op_cost.py`` (:func:`analyze` takes
its ``ModuleCost`` where ``repro``'s takes compiled HLO).  The peaks are
the H100 SXM data sheet's at 700 W, dense: 989 TFLOP/s bf16 and fp16, 495
TF32, 67 float32 outside the tensor cores; HBM3 3.35 TB/s; NVLink 900
GB/s both ways, 450 one way.  The peak follows the compute type: the card
runs float32 matmuls at the float32 rate unless TF32 is allowed
(``torch.backends.cuda.matmul.allow_tf32``), which the port does not do;
``repro`` has one constant for every cell.

``repro``'s ``collective_bytes(hlo_text)`` parses the compiled HLO; here
``op_cost`` charges the collectives a step launches over a
``torch.distributed`` group instead (``c10d`` and functional
collectives, and DTensor's redistributions, by ``hlo_cost``'s ring
rules), one device's wire bytes by kind: ``coll_bytes_per_chip`` and
``coll_breakdown``.  A step on one card launches none (0); one device's
share of a sharded step (``dryrun --mesh pod|multipod``) does.
``compile_ok`` is kept at True, so that a record has ``repro``'s keys
and ``Roofline`` holds to ``repro``'s at its own constants
(``tests/test_torch_cost.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

# --- hardware constants (H100 SXM data sheet, per card) ---------------------
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BW = 3.35e12             # B/s
LINK_BW = 450e9              # B/s, NVLink 4 one way


def compute_type(dtype) -> str:
    """The peak's key for a cell computing in ``dtype`` (a torch dtype or
    its name): float32 is ``"tf32"`` only where TF32 matmuls are allowed."""
    name = str(dtype).removeprefix("torch.")
    if name == "float32" and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return name


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # whole-program (all cards): op_cost's flops
    hlo_bytes: float            # whole-program bytes accessed
    coll_bytes_per_chip: float  # per card
    coll_breakdown: Dict[str, int]
    model_flops: float          # 6 * N_active * D tokens (train) etc.
    bytes_per_chip_peak: float  # op_cost's peak live bytes
    compile_ok: bool = True
    peak_flops: float = PEAK_FLOPS["bfloat16"]
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful FLOPs / (chips * peak * max-term)  — the MFU bound."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * self.peak_flops * t)

    def row(self) -> str:
        return (f"{self.arch:18s} {self.shape:12s} {self.mesh:9s} "
                f"tc={self.t_compute:9.4f}s tm={self.t_memory:9.4f}s "
                f"tx={self.t_collective:9.4f}s  dom={self.bottleneck:10s} "
                f"useful={self.useful_flops_ratio:6.2%} "
                f"roofline={self.roofline_fraction:6.2%}")


def analyze(cost, *, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float, dtype) -> Roofline:
    """Roofline terms of an ``op_cost.ModuleCost`` (per card) for a cell
    computing in ``dtype``."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=cost.flops * chips, hlo_bytes=cost.bytes * chips,
        coll_bytes_per_chip=float(cost.coll_wire_bytes),
        coll_breakdown={k: int(v) for k, v in cost.coll_breakdown.items()},
        model_flops=model_flops, bytes_per_chip_peak=float(cost.peak_bytes),
        peak_flops=PEAK_FLOPS[compute_type(dtype)])


def model_flops_for(cfg, shape, n_active_params: int) -> float:
    """6*N*D for train, 2*N*D for inference steps (per whole step)."""
    tokens = shape.global_batch * (shape.seq_len if shape.step != "decode" else 1)
    mult = 6.0 if shape.step == "train" else 2.0
    return mult * n_active_params * tokens
