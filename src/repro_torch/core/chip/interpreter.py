"""Program interpreter: a BinarEye ISA program as PyTorch functions.

The counterpart of ``repro.core.chip.interpreter`` for the chip tier's
single-program deployment path:

* ``init_params`` / ``forward_train`` — latent float parameters and the
  BatchNorm forward pass that warms their statistics (forward only, under
  ``torch.no_grad()``; STE training is not ported yet).
* ``fold_params`` — BN folded into integer comparator thresholds, and the
  packed or weight-image deployment artifacts the silicon's SRAMs hold.
* :class:`InferencePlan` from :func:`compile_plan` — the staged packed
  pipeline (``forward``: one fused conv kernel per conv layer, one XNOR
  matmul per FC layer) and the whole-network megakernel
  (``forward_mega``).
* ``forward_infer`` — the float +/-1 reference both are bit-exact against.

Entry points run on the GPU unless the caller passes ``device="cpu"``, in
which case every kernel runs its plain PyTorch version.  Packed words are
int32 tensors holding the bits of ``repro``'s uint32 words.  The TPU
schedule knobs of ``repro`` (frame and f tiles, the autotune cache, jit,
meshes) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import device as _device
from repro_torch.core import binarize
from repro_torch.core.chip import isa, neuron_array as na
from repro_torch.kernels import ops as kops

BN_EPS = 1e-4
BN_MOMENTUM = 0.9


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, program: isa.Program, *,
                device=None) -> Dict[str, Any]:
    """Latent float32 params for every instruction (Glorot-ish latents),
    drawn on the host from ``generator`` and placed on ``device``."""
    isa.validate(program)
    dev = _device.resolve(device)
    convs, fcs = [], []
    for (ins, in_h, in_w, in_c, *_rest) in isa.layer_geometry(program):
        if isinstance(ins, isa.ConvInstr):
            w = torch.randn((ins.features, 2, 2, in_c), generator=generator)
            f = ins.features
            convs.append(dict(
                w=w / math.sqrt(4 * in_c),
                gamma=torch.ones(f), beta=torch.zeros(f),
                mean=torch.zeros(f), var=torch.ones(f)))
        elif isinstance(ins, isa.FCInstr):
            w = torch.randn((ins.out_features, ins.in_features),
                            generator=generator)
            fcs.append(dict(w=w / math.sqrt(ins.in_features)))
    return _device.to_device({"conv": convs, "fc": fcs}, dev)


# ---------------------------------------------------------------------------
# Training-mode forward (BatchNorm statistics)
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward_train(params, program: isa.Program, images: torch.Tensor):
    """Training-mode forward: BN normalises with this batch's statistics.
    Returns (logits, new_params); new_params carries the BN running
    statistics updated from this batch.  Forward only: the sign is the
    hard sign (the STE's forward value)."""
    new_conv = []
    ci = fi = 0
    x = None
    for ins in program.instrs:
        if isinstance(ins, isa.IOInstr):
            x = na.thermometer_encode(images, ins.bits, ins.channels)
        elif isinstance(ins, isa.ConvInstr):
            p = params["conv"][ci]
            s = na.conv2x2(x, binarize.hard_sign(p["w"]))
            mean = torch.mean(s, dim=(0, 1, 2))
            var = torch.var(s, dim=(0, 1, 2), unbiased=False)
            new_p = dict(p)
            new_p["mean"] = BN_MOMENTUM * p["mean"] + (1 - BN_MOMENTUM) * mean
            new_p["var"] = BN_MOMENTUM * p["var"] + (1 - BN_MOMENTUM) * var
            new_conv.append(new_p)
            bn = (p["gamma"] * (s - mean) * torch.rsqrt(var + BN_EPS)
                  + p["beta"])
            x = binarize.hard_sign(bn)
            if ins.maxpool:
                x = na.maxpool2x2(x)
            ci += 1
        elif isinstance(ins, isa.FCInstr):
            if x.ndim == 4:
                x = x.reshape(x.shape[0], -1)
            s = na.fc(x, binarize.hard_sign(params["fc"][fi]["w"]))
            x = s if ins.final else binarize.hard_sign(s)
            fi += 1
    return x, {"conv": new_conv, "fc": params["fc"]}


# ---------------------------------------------------------------------------
# Deployment artifacts
# ---------------------------------------------------------------------------

def fold_params(params, program: isa.Program, *, packed: bool = False,
                image: bool = False):
    """Fold BN into comparator thresholds (what the chip stores).

    ``packed=False`` returns the float-domain folded form (+/-1 weights,
    float ``tau``, bool ``flip``), the reference the packed path is tested
    against; ``packed=True`` the per-layer packed artifact
    (:func:`pack_folded`); ``image=True`` the weight image the megakernel
    reads (:func:`build_weight_image`).  Tensors stay on the params'
    device.
    """
    folded_convs = []
    for p in params["conv"]:
        tau, flip = binarize.fold_bn_to_threshold(
            p["gamma"], p["beta"], p["mean"], p["var"], eps=BN_EPS)
        folded_convs.append(dict(w=binarize.hard_sign(p["w"]), tau=tau,
                                 flip=flip))
    fcs = [dict(w=binarize.hard_sign(p["w"])) for p in params["fc"]]
    folded = {"conv": folded_convs, "fc": fcs}
    if image:
        return build_weight_image(pack_folded(folded), program)
    return pack_folded(folded) if packed else folded


def pack_folded(folded) -> Dict[str, Any]:
    """Bit-pack a float-domain folded artifact into the deployment form.

      conv[i]["w_words"]: (F, 4, ceil(C/32)) int32 words, taps (dy, dx)
          row-major, channels packed LSB-first (bit=1 encodes -1);
      conv[i]["tau"]:     (F,) int32 comparator thresholds (``s >= tau``);
      conv[i]["flip"]:    (F,) int32 comparator direction (gamma < 0);
      fc[i]["w_words"]:   (N, ceil(K/32)) int32 words, K in the row-major
          flatten order of the preceding (H, W, F) map.
    """
    convs = []
    for p in folded["conv"]:
        f, _, _, c = p["w"].shape
        convs.append(dict(
            w_words=binarize.pack_signs(p["w"].reshape(f, 4, c), axis=-1),
            tau=binarize.threshold_to_int(p["tau"]),
            flip=p["flip"].to(torch.int32)))
    fcs = [dict(w_words=binarize.pack_signs(p["w"], axis=-1))
           for p in folded["fc"]]
    return {"conv": convs, "fc": fcs}


def _is_packed_artifact(folded) -> bool:
    stages = list(folded["conv"]) + list(folded["fc"])
    return bool(stages) and "w_words" in stages[0]


def _is_image_artifact(artifact) -> bool:
    return isinstance(artifact, dict) and "cw" in artifact and "fw" in artifact


def ensure_packed(artifact):
    """Admission helper: accept a float-folded or packed artifact, return
    the packed one."""
    if _is_image_artifact(artifact):
        raise TypeError(
            "weight-image artifact cannot be unstacked back to the packed "
            "per-layer form; fold with packed=True (or keep both)")
    return artifact if _is_packed_artifact(artifact) else pack_folded(artifact)


def build_weight_image(packed, program: isa.Program) -> Dict[str, Any]:
    """Stack a packed per-layer artifact into one weight image.

      ``cw``: (n_conv, F, 4, Cw) int32 conv weight words (every conv of a
          valid program has F = C = 256/S, so the stack is rectangular);
      ``ct``/``cf``: (n_conv, F) int32 thresholds / directions;
      ``fw``: (n_fc, N_max, Kw_max) int32 FC weight words, zero-padded to
          the widest layer (each layer's true (N, Kw) is what is read).
    """
    isa.validate(program)
    f = isa.ARRAY_CHANNELS // program.s
    cww = f // binarize.PACK_WIDTH
    convs, fcs = packed["conv"], packed["fc"]
    dev = fcs[0]["w_words"].device
    if convs:
        cw = torch.stack([p["w_words"] for p in convs])
        ct = torch.stack([p["tau"] for p in convs]).to(torch.int32)
        cf = torch.stack([p["flip"] for p in convs]).to(torch.int32)
    else:                       # conv-less program: dummy slot, never read
        cw = torch.zeros((1, f, 4, cww), dtype=torch.int32, device=dev)
        ct = torch.zeros((1, f), dtype=torch.int32, device=dev)
        cf = torch.zeros((1, f), dtype=torch.int32, device=dev)
    n_max = max(p["w_words"].shape[0] for p in fcs)
    kw_max = max(p["w_words"].shape[1] for p in fcs)
    fw = torch.stack([
        torch.nn.functional.pad(p["w_words"],
                                (0, kw_max - p["w_words"].shape[1],
                                 0, n_max - p["w_words"].shape[0]))
        for p in fcs])
    return {"cw": cw, "ct": ct, "cf": cf, "fw": fw}


def ensure_image(artifact, program: isa.Program):
    """Admission helper: accept any artifact form, return the weight image."""
    if _is_image_artifact(artifact):
        return artifact
    return build_weight_image(ensure_packed(artifact), program)


# ---------------------------------------------------------------------------
# Compiled inference plan: the packed-domain pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _IOStage:
    bits: int
    channels: int


@dataclasses.dataclass(frozen=True)
class _ConvStage:
    c: int                 # true input channel count
    features: int
    pool: bool


@dataclasses.dataclass(frozen=True)
class _FCStage:
    in_features: int
    out_features: int
    final: bool
    pack_out: bool         # hidden layer stays packed (out % 32 == 0)


def _frames(images, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(images, device=dev)


@dataclasses.dataclass(frozen=True)
class InferencePlan:
    """A program compiled to a static pipeline of fused packed stages.

    Built once per program by :func:`compile_plan`; all geometry is
    resolved at build time, so a forward is a straight chain of kernel
    launches.
    """
    program: isa.Program
    stages: Tuple[Any, ...]
    mega: Tuple[Any, ...] = ()   # static stage spec for the megakernel

    def forward(self, packed, images, device=None):
        """Staged packed forward: one fused conv kernel per conv layer, one
        XNOR matmul per FC.  Returns (float32 logits, int64 labels)."""
        dev = _device.resolve(device)
        packed = _device.to_device(packed, dev)
        images = _frames(images, dev)
        ci = fi = 0
        x = logits = None
        for st in self.stages:
            if isinstance(st, _IOStage):
                x = na.thermometer_encode_packed(images, st.bits, st.channels)
            elif isinstance(st, _ConvStage):
                p = packed["conv"][ci]
                x = kops.binary_conv2x2_block(x, p["w_words"], p["tau"],
                                              p["flip"], st.c, pool=st.pool)
                ci += 1
            else:
                if x.ndim == 4:
                    # packed (B, H, W, F//32) words flatten directly into
                    # packed FC rows: F % 32 == 0 makes the word order the
                    # row-major channel order.
                    x = x.reshape(x.shape[0], -1)
                p = packed["fc"][fi]
                s = kops.xnor_matmul(x, p["w_words"], st.in_features,
                                     pack_out=st.pack_out)
                if st.final:
                    logits = s
                elif st.pack_out:
                    x = s
                else:   # odd-width hidden FC: threshold at 0, repack
                    x = binarize.pack_signs(
                        binarize.hard_sign(s.to(torch.float32)), axis=-1)
                fi += 1
        logits = logits.to(torch.float32)
        return logits, torch.argmax(logits, dim=-1)

    def forward_mega(self, image, images, device=None):
        """Whole-network megakernel forward: one launch per batch, feature
        maps in shared memory.  ``image`` is the weight-image artifact
        (``fold_params(..., image=True)`` / :func:`ensure_image`).
        Returns (float32 logits, int64 labels)."""
        dev = _device.resolve(device)
        image = _device.to_device(image, dev)
        logits = kops.megakernel_forward(image, _frames(images, dev),
                                         spec=self.mega)
        logits = logits.to(torch.float32)
        return logits, torch.argmax(logits, dim=-1)

    def make_fn(self, megakernel: bool = False, device=None):
        """(artifact, images) -> (logits, labels) on ``device``:
        ``megakernel=True`` runs :meth:`forward_mega` on the weight image,
        else :meth:`forward` on the packed per-layer artifact."""
        dev = _device.resolve(device)
        if megakernel:
            return functools.partial(self.forward_mega, device=dev)
        return functools.partial(self.forward, device=dev)

    # Serving needs nothing beyond make_fn here: meshes and buffer
    # donation are not ported.
    make_serve_fn = make_fn


@functools.lru_cache(maxsize=64)
def compile_plan(program: isa.Program) -> InferencePlan:
    """Resolve a program's geometry into the staged pipeline and the
    megakernel's stage spec (``kernels.megakernel``)."""
    stages = []
    mega = []
    for (ins, in_h, in_w, in_c, _oh, _ow, _oc) in isa.layer_geometry(program):
        if isinstance(ins, isa.IOInstr):
            stages.append(_IOStage(bits=ins.bits, channels=ins.channels))
            mega.append(("io", ins.height, ins.width, ins.in_channels,
                         ins.bits, ins.channels))
        elif isinstance(ins, isa.ConvInstr):
            if ins.features % binarize.PACK_WIDTH:
                raise isa.ProgramError(
                    f"packed plan needs conv F % {binarize.PACK_WIDTH} == 0, "
                    f"got {ins.features}")
            stages.append(_ConvStage(c=in_c, features=ins.features,
                                     pool=ins.maxpool))
            mega.append(("conv", in_h, in_w, in_c, ins.features,
                         ins.maxpool))
        else:
            pack_out = (not ins.final
                        and ins.out_features % binarize.PACK_WIDTH == 0)
            stages.append(_FCStage(in_features=ins.in_features,
                                   out_features=ins.out_features,
                                   final=ins.final, pack_out=pack_out))
            mega.append(("fc", ins.in_features, ins.out_features,
                         ins.final, pack_out))
    return InferencePlan(program=program, stages=tuple(stages),
                         mega=tuple(mega))


def forward_infer(folded, program: isa.Program, images, device=None):
    """The float +/-1 reference forward on a float-folded artifact, which
    :meth:`InferencePlan.forward` and :meth:`InferencePlan.forward_mega`
    are tested bit-exact against.  Returns (logits, labels)."""
    dev = _device.resolve(device)
    folded = _device.to_device(folded, dev)
    images = _frames(images, dev)
    ci = fi = 0
    x = None
    for ins in program.instrs:
        if isinstance(ins, isa.IOInstr):
            x = na.thermometer_encode(images, ins.bits, ins.channels)
        elif isinstance(ins, isa.ConvInstr):
            p = folded["conv"][ci]
            s = na.conv2x2(x, p["w"])
            x = na.comparator(s, p["tau"], p["flip"])
            if ins.maxpool:
                x = na.maxpool2x2(x)
            ci += 1
        elif isinstance(ins, isa.FCInstr):
            if x.ndim == 4:
                x = x.reshape(x.shape[0], -1)
            s = na.fc(x, folded["fc"][fi]["w"])
            x = s if ins.final else binarize.hard_sign(s)
            fi += 1
    return x, torch.argmax(x, dim=-1)
