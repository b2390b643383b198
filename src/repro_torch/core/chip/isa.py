"""The BinarEye instruction set (2nd level of flexibility: programmable depth).

The chip's controller decodes custom instructions for input-output layers
(IO), CNN layers (CNN) and fully-connected layers (FC) from a 16-slot
program memory.  We reproduce that contract exactly:

  * <= 16 instructions per program
  * CNN layers are F x C x 2x2, stride 1, F = C = 256/S with S in {1,2,4},
    optional *streamed* 2x2/2 max-pool, feature maps up to 32x32
  * FC layers are binary, final layer <= 10 classes, total FC weights
    <= 5 kB SRAM
  * total CNN weights <= 259 kB SRAM; feature maps <= 32 kB per side

``assemble``/``disassemble`` give the packed 32-bit instruction words the
program memory would hold, so program storage is part of the model.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np

# --- hardware constants (from the paper) -----------------------------------
NUM_NEURONS = 64
SUBNEURONS = 4
SUB_CHANNELS = 64                       # channels per sub-neuron dot product
ARRAY_CHANNELS = NUM_NEURONS * SUBNEURONS  # 256: full-array F=C at S=1
MAX_WH = 32
MAX_CLASSES = 10
MAX_INSTRUCTIONS = 16
WEIGHT_SRAM_BITS = 259 * 1024 * 8       # north+south weight SRAM
FC_SRAM_BITS = 5 * 1024 * 8             # FC weight SRAM
FEATURE_SRAM_BITS = 32 * 1024 * 8       # per side (west/east), ping-pong
VALID_S = (1, 2, 4)

_OP_IO, _OP_CNN, _OP_FC = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class IOInstr:
    """Load an image and thermometer-encode it into a binary feature map.

    The chip's first layer consumes a 7-bit RGB 32x32 input and processes
    it through the full 256-channel array (layer-1 cost is counted at
    C=256, matching the paper's 500M-op figure).  We realize the
    integer->binary interface as a thermometer code: ``channels`` binary
    planes per image, split evenly over the ``in_channels`` colors.
    """
    height: int
    width: int
    in_channels: int = 3       # raw image colors
    bits: int = 7              # input precision
    channels: int = ARRAY_CHANNELS  # encoded binary channels (= C of conv 1)


@dataclasses.dataclass(frozen=True)
class ConvInstr:
    """F x C x 2x2 stride-1 VALID conv + BN-threshold sign + optional pool."""
    height: int                # input map height
    width: int                 # input map width
    features: int              # F = C = 256/S
    maxpool: bool = False      # streamed 2x2 stride-2 max-pool after conv


@dataclasses.dataclass(frozen=True)
class FCInstr:
    in_features: int
    out_features: int
    final: bool = False        # final layer -> classification logits


Instr = Union[IOInstr, ConvInstr, FCInstr]


@dataclasses.dataclass(frozen=True)
class Program:
    """A BinarEye program: width mode S + instruction list."""
    s: int
    instrs: tuple

    @property
    def conv_instrs(self):
        return [i for i in self.instrs if isinstance(i, ConvInstr)]

    @property
    def fc_instrs(self):
        return [i for i in self.instrs if isinstance(i, FCInstr)]


class ProgramError(ValueError):
    pass


def validate(p: Program) -> None:
    """Enforce every hardware constraint of the chip."""
    if p.s not in VALID_S:
        raise ProgramError(f"S must be one of {VALID_S}, got {p.s}")
    if len(p.instrs) > MAX_INSTRUCTIONS:
        raise ProgramError(
            f"program memory holds {MAX_INSTRUCTIONS} instructions, got {len(p.instrs)}")
    if not p.instrs or not isinstance(p.instrs[0], IOInstr):
        raise ProgramError("program must start with an IO instruction")

    fcw = ARRAY_CHANNELS // p.s  # F = C = 256/S
    weight_bits = 0
    fc_bits = 0
    cur_h = cur_w = cur_c = None
    seen_fc = False
    for idx, ins in enumerate(p.instrs):
        if isinstance(ins, IOInstr):
            if idx != 0:
                raise ProgramError("IO instruction only allowed in slot 0")
            if ins.height > MAX_WH or ins.width > MAX_WH:
                raise ProgramError(f"input {ins.height}x{ins.width} exceeds {MAX_WH}x{MAX_WH}")
            if ins.channels != fcw:
                raise ProgramError(
                    f"IO encode channels {ins.channels} must equal 256/S = {fcw}")
            cur_h, cur_w, cur_c = ins.height, ins.width, ins.channels
        elif isinstance(ins, ConvInstr):
            if seen_fc:
                raise ProgramError("CNN instruction after FC instruction")
            if ins.features != fcw:
                raise ProgramError(f"conv F={ins.features} must equal 256/S={fcw}")
            if (ins.height, ins.width) != (cur_h, cur_w):
                raise ProgramError(
                    f"instr {idx}: expects {ins.height}x{ins.width}, "
                    f"pipeline provides {cur_h}x{cur_w}")
            if cur_h < 2 or cur_w < 2:
                raise ProgramError(f"instr {idx}: map too small for 2x2 conv")
            map_bits = cur_h * cur_w * cur_c
            if map_bits > FEATURE_SRAM_BITS:
                raise ProgramError(f"feature map {map_bits}b exceeds feature SRAM")
            weight_bits += ins.features * cur_c * 4
            cur_h, cur_w = cur_h - 1, cur_w - 1
            if ins.maxpool:
                cur_h, cur_w = cur_h // 2, cur_w // 2
            cur_c = ins.features
        elif isinstance(ins, FCInstr):
            expected = cur_h * cur_w * cur_c if not seen_fc else cur_c
            if ins.in_features != expected:
                raise ProgramError(
                    f"FC in_features {ins.in_features} != pipeline width {expected}")
            if ins.final and ins.out_features > MAX_CLASSES:
                raise ProgramError(f"final FC limited to {MAX_CLASSES} classes")
            fc_bits += ins.in_features * ins.out_features
            seen_fc = True
            cur_c = ins.out_features
            cur_h = cur_w = 1
        else:
            raise ProgramError(f"unknown instruction {ins!r}")
    if not isinstance(p.instrs[-1], FCInstr) or not p.instrs[-1].final:
        raise ProgramError("program must end with a final FC instruction")
    if weight_bits > WEIGHT_SRAM_BITS:
        raise ProgramError(f"CNN weights {weight_bits}b exceed weight SRAM "
                           f"({WEIGHT_SRAM_BITS}b)")
    if fc_bits > FC_SRAM_BITS:
        raise ProgramError(f"FC weights {fc_bits}b exceed FC SRAM ({FC_SRAM_BITS}b)")


# ---------------------------------------------------------------------------
# Binary encoding of the program memory
# ---------------------------------------------------------------------------
# word layout (LSB first):
#   IO:   op:2 | h:6 (2-7) | w:6 (8-13) | ch:11 (14-24) | in_ch:3 (25-27) |
#         bits:4 (28-31)
#   CNN:  op:2 | h:6 (2-7) | w:6 (8-13) | f:11 (14-24) | pool:1 (25)
#   FC:   op:2 | out:10 (2-11) | in:11 (14-24) | final:1 (25)
# The FC ``out`` field reuses the h/w bit range (spatial fields are
# meaningless for FC) and is 10 bits wide so a full-array hidden layer
# (out_features = 256, and headroom to 1023) round-trips — the original
# 4-bit field silently corrupted anything above 15 (e.g. mnist5's
# 64-wide hidden FC).  The IO word similarly gained an in_channels field
# and a 4-bit precision field (the original 3-bit field truncated
# mnist5's 8-bit input to 0 and dropped in_channels entirely).
_FC_OUT_MAX = 0x3FF
_FC_IN_MAX = 0x7FF
_IO_INCH_MAX = 0x7
_IO_BITS_MAX = 0xF


def _encode_instr(ins: Instr) -> int:
    if isinstance(ins, IOInstr):
        if ins.in_channels > _IO_INCH_MAX:
            raise ProgramError(
                f"IO in_channels {ins.in_channels} exceeds encodable "
                f"range ({_IO_INCH_MAX})")
        if ins.bits > _IO_BITS_MAX:
            raise ProgramError(
                f"IO bits {ins.bits} exceeds encodable range ({_IO_BITS_MAX})")
        return (_OP_IO | ins.height << 2 | ins.width << 8
                | ins.channels << 14 | ins.in_channels << 25
                | ins.bits << 28)
    if isinstance(ins, ConvInstr):
        return (_OP_CNN | ins.height << 2 | ins.width << 8
                | ins.features << 14 | int(ins.maxpool) << 25)
    if ins.in_features > _FC_IN_MAX:
        raise ProgramError(
            f"FC in_features {ins.in_features} exceeds encodable "
            f"range ({_FC_IN_MAX})")
    if ins.out_features > _FC_OUT_MAX:
        raise ProgramError(
            f"FC out_features {ins.out_features} exceeds encodable "
            f"range ({_FC_OUT_MAX})")
    return (_OP_FC | ins.in_features << 14
            | ins.out_features << 2 | int(ins.final) << 25)


def assemble(p: Program) -> np.ndarray:
    validate(p)
    words = [_encode_instr(ins) for ins in p.instrs]
    out = np.zeros(MAX_INSTRUCTIONS, np.uint32)
    out[:len(words)] = np.array(words, np.uint32)
    return out


def disassemble(words: np.ndarray, s: int) -> Program:
    instrs = []
    for w in words:
        w = int(w)
        if w == 0 and instrs:
            break
        op = w & 0x3
        if op == _OP_IO:
            instrs.append(IOInstr(height=(w >> 2) & 0x3F, width=(w >> 8) & 0x3F,
                                  channels=(w >> 14) & 0x7FF,
                                  in_channels=(w >> 25) & _IO_INCH_MAX,
                                  bits=(w >> 28) & _IO_BITS_MAX))
        elif op == _OP_CNN:
            instrs.append(ConvInstr(height=(w >> 2) & 0x3F, width=(w >> 8) & 0x3F,
                                    features=(w >> 14) & 0x7FF,
                                    maxpool=bool((w >> 25) & 1)))
        else:
            instrs.append(FCInstr(in_features=(w >> 14) & _FC_IN_MAX,
                                  out_features=(w >> 2) & _FC_OUT_MAX,
                                  final=bool((w >> 25) & 1)))
    return Program(s=s, instrs=tuple(instrs))


def layer_geometry(p: Program):
    """Yield (instr, in_h, in_w, in_c, out_h, out_w, out_c) per instruction."""
    validate(p)
    cur_h = cur_w = cur_c = None
    out = []
    for ins in p.instrs:
        if isinstance(ins, IOInstr):
            out.append((ins, ins.height, ins.width, ins.in_channels,
                        ins.height, ins.width, ins.channels))
            cur_h, cur_w, cur_c = ins.height, ins.width, ins.channels
        elif isinstance(ins, ConvInstr):
            oh, ow = cur_h - 1, cur_w - 1
            if ins.maxpool:
                oh, ow = oh // 2, ow // 2
            out.append((ins, cur_h, cur_w, cur_c, oh, ow, ins.features))
            cur_h, cur_w, cur_c = oh, ow, ins.features
        else:
            out.append((ins, 1, 1, ins.in_features, 1, 1, ins.out_features))
            cur_h = cur_w = 1
            cur_c = ins.out_features
    return out
