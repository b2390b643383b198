"""Program interpreter: a BinarEye ISA program as PyTorch functions.

The counterpart of ``repro.core.chip.interpreter`` for the chip tier's
single-program deployment path:

* ``init_params`` / ``forward_train`` — latent float parameters and
  BinaryNet training semantics (the chip's first level of flexibility,
  reprogrammable weights): STE sign, BatchNorm before the sign
  activation, differentiable end to end; ``train=False`` is the eval
  forward on the running statistics.
* ``fold_params`` — BN folded into integer comparator thresholds, and the
  packed or weight-image deployment artifacts the silicon's SRAMs hold.
* :class:`InferencePlan` from :func:`compile_plan` — the staged packed
  pipeline (``forward``: one fused conv kernel per conv layer, one XNOR
  matmul per FC layer) and the whole-network megakernel
  (``forward_mega``).
* :class:`CompositePlan` from :func:`pack_programs` — several programs
  whose S-modes tile the 256-channel array, packed side by side into one
  weight image and run in one launch per batch (``forward``).
* :class:`CascadePlan` from :func:`pack_cascade` — a detector and a
  recognizer in one image, the escalation decided on the device and the
  recognizer run on the escalated frames only (``forward_fused``).
* :class:`DeltaPlan` from :func:`pack_delta` — one program gated per
  stream on the packed Hamming distance to its resident last frame, only
  the changed streams recomputed (``forward_delta``).
* :func:`compile_family` — one task compiled at several operating points,
  for the serving layer's operating-point controller.
* ``forward_infer`` — the float +/-1 reference all of them are bit-exact
  against (``use_kernels=True`` routes through the staged plan), and
  :func:`make_infer_fn` binding it to a program.

Entry points run on the GPU unless the caller passes ``device="cpu"``, in
which case every kernel runs its plain PyTorch version.  Packed words are
int32 tensors holding the bits of ``repro``'s uint32 words.  The launch
geometry of the card's kernels (the cluster size of the megakernel, the
composites, the delta gate and the cascade's detector; the staged conv
layers' feature slices and band rows) is resolved at each call through
the autotune cache (``kernels.autotune``): an explicit argument, else a
tuned entry, else the kernels' own formula.  Every geometry computes the
same integers.  ``repro``'s frame and f tiles, jit and meshes have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch import device as _device
from repro_torch.core import binarize
from repro_torch.core.chip import isa, neuron_array as na
from repro_torch.kernels import autotune
from repro_torch.kernels import binary_conv2x2_block as bcb
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
# Training-mode forward (STE + BatchNorm)
# ---------------------------------------------------------------------------

def forward_train(params, program: isa.Program, images: torch.Tensor,
                  train: bool = True):
    """Returns (logits, new_params); new_params carries updated BN stats.

    Differentiable end to end through ``binarize.ste_sign`` on the latent
    weights and on the BN outputs.  ``train=True`` normalises with this
    batch's mean and biased variance and returns the running statistics
    updated from them, detached (they carry no gradient, so an optimizer
    state built from them holds no graph); ``train=False`` normalises with
    the running ``mean``/``var`` and returns ``params["conv"]`` unchanged.
    Runs on the device of ``params`` (``init_params`` places them).
    """
    images = _frames(images, params["fc"][0]["w"].device)
    new_conv = []
    ci = fi = 0
    x = None
    for ins in program.instrs:
        if isinstance(ins, isa.IOInstr):
            x = na.thermometer_encode(images, ins.bits, ins.channels)
        elif isinstance(ins, isa.ConvInstr):
            p = params["conv"][ci]
            s = na.conv2x2(x, binarize.ste_sign(p["w"]))  # (B,H-1,W-1,F)
            if train:
                mean = torch.mean(s, dim=(0, 1, 2))
                var = torch.var(s, dim=(0, 1, 2), unbiased=False)
                new_p = dict(p)
                new_p["mean"] = (BN_MOMENTUM * p["mean"]
                                 + (1 - BN_MOMENTUM) * mean).detach()
                new_p["var"] = (BN_MOMENTUM * p["var"]
                                + (1 - BN_MOMENTUM) * var).detach()
                new_conv.append(new_p)
            else:
                mean, var = p["mean"], p["var"]
                new_conv.append(p)
            bn = (p["gamma"] * (s - mean) * torch.rsqrt(var + BN_EPS)
                  + p["beta"])
            x = binarize.ste_sign(bn)
            if ins.maxpool:
                x = na.maxpool2x2(x)
            ci += 1
        elif isinstance(ins, isa.FCInstr):
            if x.ndim == 4:
                x = x.reshape(x.shape[0], -1)
            s = na.fc(x, binarize.ste_sign(params["fc"][fi]["w"]))
            x = s if ins.final else binarize.ste_sign(s)
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


def _labels(logits: torch.Tensor):
    """(float32 logits, int64 argmax labels) of int32 logits."""
    logits = logits.to(torch.float32)
    return logits, torch.argmax(logits, dim=-1)


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

    def forward(self, packed, images, device=None,
                conv_tiles: Optional[Tuple[int, int]] = None):
        """Staged packed forward: one fused conv kernel per conv layer, one
        XNOR matmul per FC.  Returns (float32 logits, int64 labels).

        ``conv_tiles`` = (nslices, rows) forces the conv layers' launch
        geometry (:meth:`conv_geometry`; either may be None); by default
        it resolves through the autotune cache for this (program, card,
        batch), the kernel's formula when cold."""
        dev = _device.resolve(device)
        packed = _device.to_device(packed, dev)
        images = _frames(images, dev)
        ns, rows = autotune.conv_tiles(self.program, images.shape[0],
                                       *(conv_tiles or (None, None)),
                                       device=dev)
        tiles = (self.conv_geometry(images.shape[0], ns, rows, dev)
                 if ns or rows else None)
        ci = fi = 0
        x = logits = None
        for st in self.stages:
            if isinstance(st, _IOStage):
                x = na.thermometer_encode_packed(images, st.bits, st.channels)
            elif isinstance(st, _ConvStage):
                p = packed["conv"][ci]
                x = kops.binary_conv2x2_block(
                    x, p["w_words"], p["tau"], p["flip"], st.c,
                    pool=st.pool, tiles=tiles and tiles[ci])
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

    def conv_geometry(self, batch: int, nslices: int = 0, rows: int = 0,
                      device=None):
        """The conv layers' launch geometry at ``nslices`` feature slices
        a block and ``rows`` output rows a band (0 = the formula's; rows
        capped at each layer's own), one ``make_conv_tiles`` a conv
        layer.  Raises where a layer cannot take it."""
        dev = _device.resolve(device)
        sms = bcb.sm_count(dev) if dev.type == "cuda" else bcb.SMS
        out = []
        for st in self.mega:
            if st[0] == "conv":
                _, h, w, c, f, pool = st
                ho = bcb.conv_out(h, w, pool)[0]
                out.append(bcb.make_conv_tiles(
                    batch, h, w, f, -(-c // binarize.PACK_WIDTH), pool,
                    nslices=nslices, rows=min(rows, ho), sms=sms))
        return tuple(out)

    def forward_mega(self, image, images, device=None,
                     cluster: Optional[int] = None):
        """Whole-network megakernel forward: one launch per batch, feature
        maps in shared memory.  ``image`` is the weight-image artifact
        (``fold_params(..., image=True)`` / :func:`ensure_image`).
        ``cluster`` forces the blocks a cluster; by default it resolves
        through the autotune cache, the kernel's formula when cold.
        Returns (float32 logits, int64 labels)."""
        dev = _device.resolve(device)
        image = _device.to_device(image, dev)
        frames = _frames(images, dev)
        cluster = autotune.mega_tiles(self.program, frames.shape[0], cluster,
                                      dev)
        return _labels(kops.megakernel_forward(image, frames, spec=self.mega,
                                               cluster=cluster or None))

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


def compile_family(variants: Mapping[str, isa.Program]
                   ) -> Dict[str, InferencePlan]:
    """Compile a program *family*: one task at several operating points.

    Family members (e.g. cifar9 at S=1/S=2/S=4 and truncated depth, see
    ``networks.FAMILIES``) must be interchangeable per frame: identical IO
    geometry (height, width, raw channels, input precision) so any
    submitted frame can be served by any member, and an identical class
    count so their labels live in one space.  Validates both and returns
    ``{variant name: InferencePlan}``.
    """
    if not variants:
        raise ValueError("compile_family needs at least one variant")
    plans: Dict[str, InferencePlan] = {}
    ref_name = ref_io = ref_classes = None
    for name, prog in variants.items():
        isa.validate(prog)
        io = prog.instrs[0]
        geom = (io.height, io.width, io.in_channels, io.bits)
        classes = prog.instrs[-1].out_features
        if ref_io is None:
            ref_name, ref_io, ref_classes = name, geom, classes
        elif geom != ref_io:
            raise isa.ProgramError(
                f"family variants disagree on IO geometry: {ref_name} takes "
                f"(h, w, c, bits) = {ref_io}, {name} takes {geom} — one "
                "frame stream must be servable by every variant")
        elif classes != ref_classes:
            raise isa.ProgramError(
                f"family variants disagree on class count: {ref_name} has "
                f"{ref_classes}, {name} has {classes}")
        plans[name] = compile_plan(prog)
    return plans


# ---------------------------------------------------------------------------
# Composite plans: sub-array sharing across resident programs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompositePlan:
    """Several programs compiled as ONE shared-array dispatch unit.

    The chip's S-mode recombination runs its sub-arrays concurrently (4xS4,
    2xS2, 1xS2 + 2xS4, ...), each on its own program and frame stream.  The
    members' weight images pack side by side on the F axis into one
    composite image (:func:`pack_programs`), each member's stages carry
    their row offsets into it, and :meth:`forward` runs every member's
    frames in one launch per batch (``kernels.megakernel.composite_forward``),
    bit-exact with dispatching each member alone.
    """
    names: Tuple[str, ...]
    programs: Tuple[isa.Program, ...]
    plans: Tuple[InferencePlan, ...]
    spec: Tuple[Any, ...]          # per-member stage specs with offsets

    @property
    def classes(self) -> Tuple[int, ...]:
        return tuple(sp[-1][2] for sp in self.spec)

    @property
    def n_groups(self) -> int:
        """Member groups of the spec (members with identical IO and conv
        chains; ``repro`` convolves each group as one contraction)."""
        return len(kops.member_groups(self.spec))

    def forward(self, image, frames, device=None,
                cluster: Optional[int] = None):
        """Shared dispatch: per-member frames -> per-member (logits, labels).

        ``frames`` is a mapping keyed by member name or a sequence in
        ``names`` order; member batches may be ragged.  ``cluster``
        forces the launch's blocks a cluster; by default it resolves
        through the autotune cache under the composite's own key.
        Returns (float32 logits, int64 labels) as tuples in ``names``
        order.
        """
        dev = _device.resolve(device)
        image = _device.to_device(image, dev)
        if isinstance(frames, Mapping):
            frames = [frames[n] for n in self.names]
        frames = tuple(_frames(f, dev) for f in frames)
        cluster = autotune.composite_tiles(
            self.programs, max(f.shape[0] for f in frames), cluster, dev)
        outs = kops.composite_forward(image, frames, spec=self.spec,
                                      cluster=cluster or None)
        logits = tuple(o.to(torch.float32) for o in outs)
        return logits, tuple(torch.argmax(lg, dim=-1) for lg in logits)

    def make_serve_fn(self, device=None):
        """(composite image, frames tuple) -> (logits, labels) tuples on
        ``device``."""
        return functools.partial(self.forward, device=_device.resolve(device))


def pack_programs(programs: Mapping[str, isa.Program],
                  artifacts: Mapping[str, Any], *,
                  exact_tiling: bool = True):
    """Compile a shared-array composite: (CompositePlan, composite image).

    ``programs`` maps member names to validated ISA programs whose S-modes
    must tile the 256-channel array exactly (sum of 256/S == 256);
    ``artifacts`` maps the same names to any artifact form.
    ``exact_tiling=False`` lifts the tiling constraint for members that run
    one after another in a dispatch rather than side by side (the fused
    cascade).  The image stays on the artifacts' device:

      ``cw``: (Lc, F_total, 4, Cw_max) int32, member m's conv-layer-i words
          at rows [f_off_m, f_off_m + 256/S_m); rows past a member's depth
          and unused trailing channel words stay zero and are never read;
      ``ct``/``cf``: (Lc, F_total) int32 thresholds / directions;
      ``fw``: (Lf, N_total, Kw_max) int32 FC words, members side by side
          on the N axis per FC ordinal.
    """
    names = tuple(programs)
    if not names:
        raise ValueError("pack_programs needs at least one program")
    progs = tuple(programs[n] for n in names)
    for p in progs:
        isa.validate(p)
    widths = [isa.ARRAY_CHANNELS // p.s for p in progs]
    if exact_tiling and len(progs) > 1 and sum(widths) != isa.ARRAY_CHANNELS:
        raise isa.ProgramError(
            f"S-modes {[p.s for p in progs]} do not tile the array "
            f"exactly: sum(256/S) = {sum(widths)} != {isa.ARRAY_CHANNELS}")
    plans = tuple(compile_plan(p) for p in progs)
    images = [ensure_image(artifacts[n], p) for n, p in zip(names, progs)]
    dev = images[0]["fw"].device
    images = [_device.to_device(img, dev) for img in images]

    f_offs, off = [], 0
    for w in widths:
        f_offs.append(off)
        off += w
    lc = max(img["cw"].shape[0] for img in images)
    kwc = max(img["cw"].shape[3] for img in images)
    cw = torch.zeros((lc, off, 4, kwc), dtype=torch.int32, device=dev)
    ct = torch.zeros((lc, off), dtype=torch.int32, device=dev)
    cf = torch.zeros((lc, off), dtype=torch.int32, device=dev)
    for img, fo in zip(images, f_offs):
        ncm, fm, _, kwm = img["cw"].shape
        cw[:ncm, fo:fo + fm, :, :kwm] = img["cw"]
        ct[:ncm, fo:fo + fm] = img["ct"]
        cf[:ncm, fo:fo + fm] = img["cf"]

    # FC rows: true (N, Kw) per member per FC ordinal, packed side by side
    fc_geoms = [[(st[2], -(-st[1] // binarize.PACK_WIDTH))
                 for st in plan.mega if st[0] == "fc"] for plan in plans]
    lf = max(len(g) for g in fc_geoms)
    n_offs, row = [], [0] * lf
    for g in fc_geoms:
        offs = []
        for li, (n, _kw) in enumerate(g):
            offs.append(row[li])
            row[li] += n
        n_offs.append(tuple(offs))
    kw_tot = max(kw for g in fc_geoms for _n, kw in g)
    fw = torch.zeros((lf, max(row), kw_tot), dtype=torch.int32, device=dev)
    for img, g, offs in zip(images, fc_geoms, n_offs):
        for li, ((n, kw), o) in enumerate(zip(g, offs)):
            fw[li, o:o + n, :kw] = img["fw"][li, :n, :kw]

    mspecs = []
    for plan, fo, offs in zip(plans, f_offs, n_offs):
        fi, st_out = 0, []
        for st in plan.mega:
            if st[0] == "io":
                st_out.append(st)
            elif st[0] == "conv":
                st_out.append(st + (fo,))
            else:
                st_out.append(st + (offs[fi],))
                fi += 1
        mspecs.append(tuple(st_out))

    cplan = CompositePlan(names=names, programs=progs, plans=plans,
                          spec=tuple(mspecs))
    return cplan, {"cw": cw, "ct": ct, "cf": cf, "fw": fw}


# ---------------------------------------------------------------------------
# Cascade plans: detector -> recognizer escalation on the device
# ---------------------------------------------------------------------------

_INT32_MIN = -(2 ** 31)
_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class CascadePlan:
    """A detector + recognizer pair compiled as ONE fused dispatch unit.

    Both stages' weight images share one composite image
    (:func:`pack_cascade`); the detector runs on every frame, the
    escalation (positive-class logit margin >= threshold) is decided on the
    device, and the recognizer runs on the escalated frames only
    (``kernels.megakernel.cascade_forward``), with no host round trip
    between the stages.  The stages run one after the other, so their
    S-modes need not tile the 256 channels.

    The escalation rule is bit-exact with the host cascade's float rule:
    integer margins satisfy ``m >= margin  <=>  m >= ceil(margin)``, and
    :meth:`margin_ctrl` folds the float margin into the int32 threshold the
    kernel compares against (``+/-inf`` map to sentinels beyond any
    reachable margin).
    """
    detector: str
    recognizer: str
    programs: Tuple[isa.Program, ...]          # (det, rec)
    plans: Tuple[InferencePlan, ...]
    spec: Tuple[Any, ...]                      # 2-member composite spec
    positive_class: int = 1

    @property
    def classes(self) -> Tuple[int, int]:
        return tuple(sp[-1][2] for sp in self.spec)

    @property
    def n_groups(self) -> int:
        return len(kops.member_groups(self.spec))

    @staticmethod
    def margin_ctrl(margin: float, n_real: int) -> torch.Tensor:
        """Fold a host float escalation margin into the kernel's ``(1, 2)``
        int32 control word ``[threshold, n_real]`` (on the CPU).

        For integer margins m, ``m >= margin`` holds iff
        ``m >= ceil(margin)``; ``-inf`` (escalate all) and ``+inf``
        (escalate none) clamp to the int32 extremes, both unreachable by
        real margins.  ``n_real`` masks padding lanes out of escalation.
        """
        return _ctrl_word(margin, n_real, "escalation margin")

    def forward_fused(self, image, frames, ctrl, device=None,
                      bb: Optional[int] = None, rb: Optional[int] = None,
                      check_every: int = 1,
                      det_cluster: Optional[int] = None):
        """One fused dispatch: frames -> both stages' answers.

        ``ctrl`` is :meth:`margin_ctrl`'s control word (its n_real at most
        the batch).  Returns ``(det_logits, det_labels, rec_logits,
        rec_labels, queue, counts)``: logits float32, labels int64;
        ``counts[0] = E`` escalated frames, ``queue[:E]`` their ascending
        frame indices, ``rec_*[k]`` answering frame ``queue[k]``;
        ``counts[1]`` the recognizer slots billed.  ``bb`` (default 8, the
        pad granule), ``rb`` (default ``bb``) and ``check_every`` set the
        drain schedule ``counts[1]`` follows; nothing else depends on them.
        ``det_cluster`` forces the detector's blocks a cluster; by default
        it resolves through the autotune cache under the pair's composite
        key (0, cold: ``cascade_geometry``'s pick by the batch).
        """
        dev = _device.resolve(device)
        image = _device.to_device(image, dev)
        frames = _frames(frames, dev)
        ctrl = torch.as_tensor(ctrl, dtype=torch.int32)
        _check_n_real(ctrl, frames.shape[0])
        det_cluster = autotune.cascade_tiles(self.programs, frames.shape[0],
                                             det_cluster, dev)
        det, rec, queue, counts = kops.cascade_forward(
            image, frames, ctrl.to(dev), spec=self.spec,
            bb=8 if bb is None else bb, rb=0 if rb is None else rb,
            check_every=check_every, positive_class=self.positive_class,
            det_cluster=det_cluster)
        det_l, det_y = _labels(det)
        rec_l, rec_y = _labels(rec)
        return det_l, det_y, rec_l, rec_y, queue, counts

    def make_serve_fn(self, device=None):
        """(image, frames, ctrl) -> the fused cascade outputs on
        ``device``."""
        return functools.partial(self.forward_fused,
                                 device=_device.resolve(device))


def pack_cascade(programs: Mapping[str, isa.Program],
                 artifacts: Mapping[str, Any], *,
                 detector: str, recognizer: str,
                 positive_class: int = 1):
    """Compile a fused cascade pair: (CascadePlan, composite image).

    ``programs``/``artifacts`` are keyed like :func:`pack_programs`;
    ``detector``/``recognizer`` name the two members.  The stages must
    agree on frame geometry (one stream feeds both) and the detector must
    have >= 2 classes with ``positive_class`` among them.  The image is
    the side-by-side pack with the detector at offset 0, built with
    ``exact_tiling=False`` because the stages run one after the other.
    """
    if detector == recognizer:
        raise isa.ProgramError(
            "cascade stages must be distinct programs, got "
            f"{detector!r} twice")
    for name in (detector, recognizer):
        if name not in programs:
            raise KeyError(f"cascade stage {name!r} missing from programs "
                           f"(have {sorted(programs)})")
    det_prog, rec_prog = programs[detector], programs[recognizer]
    iod, ior = det_prog.instrs[0], rec_prog.instrs[0]
    gd = (iod.height, iod.width, iod.in_channels, iod.bits)
    gr = (ior.height, ior.width, ior.in_channels, ior.bits)
    if gd != gr:
        raise isa.ProgramError(
            f"cascade stages disagree on frame geometry: detector takes "
            f"(h, w, c, bits) = {gd}, recognizer takes {gr} — one frame "
            "stream must feed both stages")
    ncd = det_prog.instrs[-1].out_features
    if ncd < 2:
        raise isa.ProgramError(
            f"detector needs >= 2 classes for a logit margin, got {ncd}")
    if not 0 <= positive_class < ncd:
        raise isa.ProgramError(
            f"positive_class {positive_class} out of range for the "
            f"detector's {ncd} classes")
    cplan, image = pack_programs(
        {detector: det_prog, recognizer: rec_prog},
        {detector: artifacts[detector], recognizer: artifacts[recognizer]},
        exact_tiling=False)
    plan = CascadePlan(detector=detector, recognizer=recognizer,
                       programs=cplan.programs, plans=cplan.plans,
                       spec=cplan.spec, positive_class=positive_class)
    return plan, image


# ---------------------------------------------------------------------------
# Delta plans: frame-delta gating for always-on video streams
# ---------------------------------------------------------------------------

def _ctrl_word(threshold: float, n_real: int, what: str) -> torch.Tensor:
    """``[ceil(threshold), n_real]`` as a (1, 2) int32 tensor on the CPU,
    ``-inf``/``+inf`` clamped to the int32 extremes."""
    if math.isnan(threshold):
        raise ValueError(f"{what} must not be NaN")
    thr = (_INT32_MIN if threshold == float("-inf") else
           _INT32_MAX if threshold == float("inf") else
           int(min(max(math.ceil(threshold), _INT32_MIN), _INT32_MAX)))
    return torch.tensor([[thr, int(n_real)]], dtype=torch.int32)


def _check_n_real(ctrl: torch.Tensor, batch: int) -> None:
    """A CPU control word's n_real must lie in [0, batch] (a device one is
    not read back)."""
    if ctrl.device.type == "cpu" and not (
            0 <= int(ctrl.reshape(-1)[1]) <= batch):
        raise ValueError(f"ctrl n_real {int(ctrl.reshape(-1)[1])} not in "
                         f"[0, {batch}]")


@dataclasses.dataclass(frozen=True)
class DeltaPlan:
    """One program compiled for delta-gated always-on serving.

    Consecutive frames of a quiet scene are nearly identical, so the plan
    pairs the program's whole-network kernel with resident per-stream state
    — the last packed thermometer frame and the cached logits — and gates
    the recompute on the device (``kernels.megakernel.delta_forward``): the
    packed Hamming distance ``popcount(cur XOR last)`` of each stream is
    compared with an int32 threshold, the changed streams compact into a
    queue and recompute, and the others emit their cached logits.

    The gate is bit-exact with a host reference: distances are integers, so
    ``d >= threshold  <=>  d >= ceil(threshold)``, and :meth:`delta_ctrl`
    folds the float threshold into the int32 control word (``-inf``
    recomputes everything, the cold-state dispatch, and ``+inf`` skips
    everything).  At threshold 0 the merged logits equal the plain
    megakernel's bit for bit.
    """
    name: str
    program: isa.Program
    plan: InferencePlan
    spec: Tuple[Any, ...]                      # 1-member composite spec

    @property
    def classes(self) -> int:
        return self.spec[0][-1][2]

    @property
    def geometry(self) -> Tuple[int, int, int]:
        io = self.spec[0][0]
        return io[1], io[2], io[3]

    @property
    def packed_words(self) -> Tuple[int, int, int]:
        """(H, W, channels//32): one stream's last-frame state shape."""
        io = self.spec[0][0]
        return io[1], io[2], io[5] // binarize.PACK_WIDTH

    @staticmethod
    def delta_ctrl(threshold: float, n_real: int) -> torch.Tensor:
        """Fold a host float change threshold into the kernel's ``(1, 2)``
        int32 control word ``[threshold, n_real]`` (on the CPU).

        For integer distances d, ``d >= threshold`` holds iff
        ``d >= ceil(threshold)``; ``-inf`` (recompute all) and ``+inf``
        (skip all) clamp to the int32 extremes, both unreachable by real
        distances.  ``n_real`` masks padding lanes out of the queue.
        """
        return _ctrl_word(threshold, n_real, "delta threshold")

    def init_state(self, n: int, device=None):
        """Cold state for ``n`` streams on ``device``: zeroed last-frame
        words (int32 views of ``repro``'s uint32) and zeroed cached logits.
        Cold state is no gate reference: pair the first dispatch with a
        ``-inf`` threshold so every lane recomputes."""
        dev = _device.resolve(device)
        h, w, cw = self.packed_words
        return (torch.zeros((n, h, w, cw), dtype=torch.int32, device=dev),
                torch.zeros((n, self.classes), dtype=torch.int32,
                            device=dev))

    def forward_delta(self, image, frames, last, llog, ctrl, device=None,
                      bb: Optional[int] = None, rb: Optional[int] = None,
                      check_every: int = 1, cluster: Optional[int] = None):
        """One gated dispatch: advance every stream by one time step.

        ``ctrl`` is :meth:`delta_ctrl`'s control word (its n_real at most
        the batch).  Returns ``(logits, labels, new_last, new_llog, queue,
        counts, deltas)``: float32 logits and int64 labels merge fresh
        answers for changed lanes with cached ones for skipped lanes;
        ``new_last``/``new_llog`` are the next dispatch's state;
        ``counts[0] = K`` changed lanes, ``queue[:K]`` their ascending
        indices, ``counts[1]`` the frame slots billed; ``deltas`` the
        per-lane packed Hamming distances.  ``bb`` (default 8, the pad
        granule), ``rb`` (default ``bb``) and ``check_every`` set the drain
        schedule ``counts[1]`` follows.  ``cluster`` forces the
        recompute's blocks a cluster; by default it resolves through the
        autotune cache under the program's key, as the megakernel's.
        """
        dev = _device.resolve(device)
        image = _device.to_device(image, dev)
        frames = _frames(frames, dev)
        ctrl = torch.as_tensor(ctrl, dtype=torch.int32)
        _check_n_real(ctrl, frames.shape[0])
        cluster = autotune.mega_tiles(self.program, frames.shape[0], cluster,
                                      dev)
        logits, new_last, queue, counts, deltas = kops.delta_forward(
            image, frames, _frames(last, dev), _frames(llog, dev),
            ctrl.to(dev),
            spec=self.spec, bb=8 if bb is None else bb,
            rb=0 if rb is None else rb, check_every=check_every,
            cluster=cluster or None)
        lf, labels = _labels(logits)
        return lf, labels, new_last, logits, queue, counts, deltas

    def make_serve_fn(self, device=None, rb: Optional[int] = None,
                      check_every: int = 1):
        """(image, frames, last, llog, ctrl) -> the gated outputs on
        ``device``, with the drain schedule fixed."""
        return functools.partial(self.forward_delta,
                                 device=_device.resolve(device), rb=rb,
                                 check_every=check_every)


def pack_delta(program: isa.Program, artifact, *, name: str = "program"):
    """Compile a delta-gated serving unit: (DeltaPlan, weight image).

    The image is the program's own megakernel weight image
    (:func:`ensure_image`) and the spec is the one-member lift of
    ``InferencePlan.mega``, so the recompute runs the megakernel's member
    body and is bit-exact with ``forward_mega``.
    """
    isa.validate(program)
    io = program.instrs[0]
    if io.channels % binarize.PACK_WIDTH:
        raise isa.ProgramError(
            f"delta gating needs IO channels % {binarize.PACK_WIDTH} == 0 "
            f"(packed Hamming distance), got {io.channels}")
    plan = compile_plan(program)
    spec = kops.solo_member_spec(plan.mega)
    image = ensure_image(artifact, program)
    return (DeltaPlan(name=name, program=program, plan=plan, spec=spec),
            image)


def forward_infer(folded, program: isa.Program, images, device=None,
                  use_kernels: bool = False):
    """Deployment forward. Returns (logits, labels).

    ``use_kernels=True`` routes through the compiled packed plan
    (:meth:`InferencePlan.forward`, packing a float-folded artifact on the
    fly); ``use_kernels=False`` is the float +/-1 reference path that
    :meth:`InferencePlan.forward` and :meth:`InferencePlan.forward_mega`
    are tested bit-exact against.
    """
    if use_kernels:
        return compile_plan(program).forward(ensure_packed(folded), images,
                                             device=device)
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


def make_infer_fn(program: isa.Program, use_kernels: bool = False,
                  device=None):
    """Bind the program: (folded, images) -> (logits, labels) on
    ``device``.  A plain closure: PyTorch runs eagerly, so there is no jit
    to wrap it in."""
    dev = _device.resolve(device)

    def fn(folded, images):
        return forward_infer(folded, program, images, device=dev,
                             use_kernels=use_kernels)
    return fn
