"""The paper's benchmark networks as ISA programs.

* ``cifar9(S)`` — the 9-layer always-on benchmark net of Fig. 4/5 (8 CNN
  + 1 FC on a 32x32 7-bit RGB input).  Its published anchors pin the
  topology: layer 1 = 500M binary ops (32x32 -> 31x31 at C=256) and a
  2G-op total at S=1 (Table 1), which our 8-conv layout reproduces to
  within 1% (2.013G).  The conv weight footprint is 8 x 256x256x2x2 b =
  262 kB — the chip's 259 kB weight SRAM to within 1%, a strong hint this
  is the layout the SRAM was sized for.  Used for CIFAR-10 (S=1), owner
  detection (S=1), 7 face angles (S=2) and face detection (S=4).
* ``mnist5(S=4)`` — the "narrow 5-layer network" used for MNIST in
  Table 1 (exact topology unpublished; ours matches the energy scale).
"""

from __future__ import annotations

from repro_torch.core.chip import isa


def cifar9(s: int = 1, classes: int = 10) -> isa.Program:
    f = isa.ARRAY_CHANNELS // s
    instrs = [isa.IOInstr(height=32, width=32, in_channels=3, bits=7, channels=f)]
    # (input size, maxpool): 32->31->30->29->28p14->13->12p6->5->4p2
    plan = [(32, False), (31, False), (30, False), (29, True),
            (14, False), (13, True), (6, False), (5, True)]
    for size, pool in plan:
        instrs.append(isa.ConvInstr(height=size, width=size, features=f,
                                    maxpool=pool))
    instrs.append(isa.FCInstr(in_features=2 * 2 * f, out_features=classes,
                              final=True))
    p = isa.Program(s=s, instrs=tuple(instrs))
    isa.validate(p)
    return p


def mnist5(s: int = 4, classes: int = 10) -> isa.Program:
    """Narrow 5-layer net (IO + 2 CNN + 2 FC) on a 2x-decimated 14x14 input.

    The paper gives only "a narrow 5-layer network" at S=4 with 0.20 uJ
    core / 0.21 uJ I2L.  The LD energy floor pins the topology: each
    LD-CONV phase costs ~79 nJ/image at S=4, so a 0.20 uJ core budget
    affords at most TWO conv layers; the 0.21 uJ I2L total then favors a
    cheap 14x14 input (MNIST decimated 2x at the sensor, standard for
    always-on wake-up pipelines).  This layout lands at 0.192/0.212 uJ —
    4%/1% from the published 0.20/0.21."""
    f = isa.ARRAY_CHANNELS // s
    instrs = [
        isa.IOInstr(height=14, width=14, in_channels=1, bits=8, channels=f),
        isa.ConvInstr(height=14, width=14, features=f, maxpool=True),   # ->6
        isa.ConvInstr(height=6, width=6, features=f, maxpool=True),     # ->2
        isa.FCInstr(in_features=2 * 2 * f, out_features=f, final=False),
        isa.FCInstr(in_features=f, out_features=classes, final=True),
    ]
    p = isa.Program(s=s, instrs=tuple(instrs))
    isa.validate(p)
    return p


def cifar9_truncated(s: int = 4, classes: int = 10) -> isa.Program:
    """Depth-truncated cifar9: the paper's 2nd flexibility level
    (programmable depth) as an operating point below the S=4 width floor.

    Drops the final conv layer (the 6x6->5x5 stage replaces the
    6->5->pool->2 tail), feeding the 5x5 map straight into the classifier
    FC.  Only encodable at S=4: the FC fan-in 5*5*(256/S) must fit the
    11-bit ISA field (1600 at S=4; 3200 at S=2 overflows), exactly the
    kind of depth/width coupling the real program memory imposes.
    """
    f = isa.ARRAY_CHANNELS // s
    instrs = [isa.IOInstr(height=32, width=32, in_channels=3, bits=7,
                          channels=f)]
    plan = [(32, False), (31, False), (30, False), (29, True),
            (14, False), (13, True), (6, False)]
    for size, pool in plan:
        instrs.append(isa.ConvInstr(height=size, width=size, features=f,
                                    maxpool=pool))
    instrs.append(isa.FCInstr(in_features=5 * 5 * f, out_features=classes,
                              final=True))
    p = isa.Program(s=s, instrs=tuple(instrs))
    isa.validate(p)
    return p


def face_detector() -> isa.Program:
    """Face detection runs the 9-layer net at the S=4 minimum-energy point
    (Table 1: 0.89 uJ core / 0.92 uJ I2L, 94.5% precision)."""
    return cifar9(s=4, classes=2)


def face_angles() -> isa.Program:
    """7-angle face tracking at S=2 (Table 1: 3.4/3.47 uJ)."""
    return cifar9(s=2, classes=7)


def owner_detector() -> isa.Program:
    """Owner recognition at S=1 (Table 1: 98.2%, 14.4 uJ I2L)."""
    return cifar9(s=1, classes=2)


REGISTRY = {
    "cifar9_s1": lambda: cifar9(1),
    "cifar9_s2": lambda: cifar9(2),
    "cifar9_s4": lambda: cifar9(4),
    "cifar9_s4t": cifar9_truncated,
    "mnist5": mnist5,
    "face_detector": face_detector,
    "face_angles": face_angles,
    "owner_detector": owner_detector,
}

# ---------------------------------------------------------------------------
# Program families: one task compiled at several operating points
# ---------------------------------------------------------------------------
# The paper's scalability story (Fig. 5): ONE task served anywhere on its
# energy-accuracy curve by re-pointing the resident program — width
# (S=1/2/4) and depth (truncated) are the knobs.  A family groups the
# registry programs that are variants of one task; the serving layer's
# operating-point controller (`serving.policy.OperatingPointPolicy`)
# switches among them per dispatch.  Family members must share input
# geometry and class count (`interpreter.compile_family` validates).
#
# ACCURACY holds the nominal task accuracy of each operating point —
# the paper's published anchors (Fig. 5 / Table 1: 86% CIFAR-10 at S=1,
# 98.2% owner recognition at S=1, 94.5% face-detect precision at S=4),
# with the unpublished points interpolated on Fig. 5's curve.  The repro
# doesn't train to these numbers; they parameterize the Pareto front the
# controller walks (`energy.operating_points`).

ACCURACY = {
    "cifar9_s1": 0.8605,       # Table 1: 86.05% CIFAR-10
    "cifar9_s2": 0.834,        # Fig. 5 mid-curve
    "cifar9_s4": 0.785,        # Fig. 5 minimum-energy width point
    "cifar9_s4t": 0.755,       # depth-truncated, below the width floor
    "owner_detector": 0.982,   # Table 1: 98.2% owner recognition
    "face_angles": 0.925,      # Table 1: 7-angle tracking
    "face_detector": 0.945,    # Table 1: 94.5% face-detect precision
    "mnist5": 0.976,           # Table 1 MNIST point
}

FAMILIES = {
    # CIFAR-10 classification across the full width+depth range
    "cifar10": ("cifar9_s1", "cifar9_s2", "cifar9_s4", "cifar9_s4t"),
    # the always-on face task: expensive owner recognizer, cheap detector
    "face": ("owner_detector", "face_detector"),
}


def family_programs(family: str):
    """``{variant name: Program}`` for a registered family, in the
    family's declared (most-accurate-first) order."""
    if family not in FAMILIES:
        raise KeyError(f"unknown family {family!r} (have {sorted(FAMILIES)})")
    return {name: REGISTRY[name]() for name in FAMILIES[family]}
