"""Whole-network megakernels: solo programs, shared-array composites and
the fused detector -> recognizer cascade; CUDA kernels and plain versions.

The counterpart of ``repro.kernels.megakernel``: raw frames in, int32
logits out, with the thermometer encode, every conv layer and the FC tail
in one dispatch.

* :func:`composite_forward` runs several programs whose S-modes tile the
  256-channel array, each on its own frame batch and its own rows of one
  composite weight image (``interpreter.pack_programs``), in one launch of
  ``csrc/megakernel.cu``.  :func:`megakernel_forward` is its one-member
  case.
* :func:`cascade_forward` runs a detector on every frame, escalates the
  frames whose logit margin reaches a threshold, and runs a recognizer on
  the escalated frames only, with no host round trip between the stages
  (``csrc/cascade.cu``).
* :func:`delta_forward` gates every stream of a batch on the packed
  Hamming distance of its frame to its resident last frame, recomputes
  the changed streams only and merges their fresh logits over the cached
  ones (``csrc/delta.cu``).

Each has its plain PyTorch version (:func:`composite_plain`,
:func:`megakernel_plain`, :func:`cascade_plain`, :func:`delta_plain`),
built from the same plain pieces as the staged path.

Member stage spec entries (hashable; built by the interpreter)::

    ("io",   h, w, cin, bits, channels)
    ("conv", h, w, c, f, pool, f_off)      h/w = input map size; f_off = the
                                           member's row offset on the
                                           image's F axis
    ("fc",   k, n, final, pack_out, n_off) n_off = row offset on the FC
                                           image's N axis

A composite spec is a tuple of member specs.  ``InferencePlan.mega`` is
the offset-less spec of one program; :func:`solo_member_spec` lifts it to a
one-member composite with all offsets 0.  ``repro``'s TPU schedule knobs
have no counterpart: member grouping (``_run_group``) and f-tiling are
schedules of the same arithmetic, and of the frame tile ``bb`` only its
effect on the cascade's bill is kept (the pad granule ``bpad``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.binarize import (PACK_WIDTH, pack_bit_lanes,
                                       popcount32, thermometer_pack,
                                       thermometer_thresholds,
                                       xnor_dot_popcount)
from repro_torch.kernels.binary_conv2x2_block import (MAX_CHANNEL_WORDS, SMS,
                                                      aligned16,
                                                      conv_block_body,
                                                      sm_count)
from repro_torch.kernels import _build

CLUSTER_WARPS = 16           # warps a block of the cluster body and the
                             # delta gate (csrc/member_mma.cuh kWarps)
MAX_CLUSTER = 8              # a portable cluster: 256 features / 32
STEP_WORDS = 8               # 256 K bits a mma.sync m16n8k256 step
GATE_WORDS = 512             # packed words a delta-gate block at most
MAX_LAYERS = 16              # the chip's 16-slot program memory
MAX_MEMBERS = 4              # 4 x S=4 sub-arrays tile the 256 channels
SMEM_LIMIT = 232448          # shared memory one H100 block may use
INT32_MIN = -2 ** 31

# kernel launches since the last reset: one per solo dispatch, per
# composite dispatch, per cascade dispatch and per delta-gated dispatch
LAUNCHES = {"megakernel": 0, "composite": 0, "cascade": 0, "delta": 0}


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def solo_member_spec(spec):
    """Lift ``InferencePlan.mega``'s offset-less stage tuples to a
    one-member composite spec (all offsets 0)."""
    return (tuple(st if st[0] == "io" else st + (0,) for st in spec),)


def _split_stages(stages):
    """(io+conv prefix, fc tail) of a member spec."""
    n = sum(1 for st in stages if st[0] != "fc")
    return stages[:n], stages[n:]


def member_groups(spec):
    """Partition member indices into sub-array groups: members whose
    IO+conv chains are shape-identical (F offsets stripped).  ``repro``
    convolves a group as one stacked contraction; here it only sizes
    ``CompositePlan.n_groups``."""
    classes = {}
    for m, stages in enumerate(spec):
        head, _ = _split_stages(stages)
        key = tuple(st[:6] for st in head)     # strips the conv f_off
        classes.setdefault(key, []).append(m)
    return tuple(tuple(v) for v in classes.values())


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------

def _fc_body(x: torch.Tensor, wfc: torch.Tensor, k: int) -> torch.Tensor:
    """Packed FC: (B, Kw) x (N, Kw) words -> (B, N) int32 sums."""
    return xnor_dot_popcount(x[:, None, :], wfc[None, :, :], k)


def _run_fc_tail(fm: torch.Tensor, fw: torch.Tensor, fc_stages) -> torch.Tensor:
    """The FC chain of one member on a packed map (flattened in
    (H, W, F/32) order, which is the FC's K order) or on packed rows."""
    x = fm.reshape(fm.shape[0], -1) if fm.ndim == 4 else fm
    for fi, st in enumerate(fc_stages):
        _, k, n, final, _pack_out, n_off = st
        kw = -(-k // PACK_WIDTH)
        s = _fc_body(x, fw[fi, n_off:n_off + n, :kw], k)
        if final:
            return s
        bits = s < 0
        if n % PACK_WIDTH:     # odd-width hidden FC: sign, pad, repack
            bits = torch.nn.functional.pad(bits, (0, (-n) % PACK_WIDTH),
                                           value=False)
        x = pack_bit_lanes(bits)
    raise AssertionError("member spec must end with a final FC stage")


def _member_plain(frames, cw, ct, cf, fw, stages) -> torch.Tensor:
    """One member's network on (B, H, W, Cin) int32 pixels -> (B, classes),
    reading its own rows of the (composite) image."""
    if frames.shape[0] == 0:
        return torch.zeros((0, stages[-1][2]), dtype=torch.int32,
                           device=frames.device)
    head, tail = _split_stages(stages)
    _, _h, _w, cin, bits, channels = head[0]
    fm = thermometer_pack(frames, bits, cin, channels)
    for ci, (_, h, w, c, f, pool, f_off) in enumerate(head[1:]):
        rows = slice(f_off, f_off + f)
        fm = conv_block_body(fm, cw[ci, rows, :, :c // PACK_WIDTH],
                             ct[ci, rows], cf[ci, rows], k4=4 * c, h=h,
                             wd=w, pool=pool)
    return _run_fc_tail(fm, fw, tail)


def composite_plain(image: Dict[str, torch.Tensor],
                    frames: Sequence[torch.Tensor], *, spec
                    ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`composite_forward`: each member on
    its own frames and its own rows of the image.  Returns a tuple of
    (B_m, classes_m) int32 logits in member order."""
    return tuple(_member_plain(f.to(torch.int32), image["cw"], image["ct"],
                             image["cf"], image["fw"], stages)
                 for f, stages in zip(frames, spec))


def megakernel_plain(image: Dict[str, torch.Tensor], frames: torch.Tensor, *,
                     spec) -> torch.Tensor:
    """Plain PyTorch version of :func:`megakernel_forward`: (B, H, W, Cin)
    frames -> (B, classes) int32 logits through one program's weight
    image (``interpreter.build_weight_image``)."""
    return composite_plain(image, (frames,), spec=solo_member_spec(spec))[0]


def cascade_schedule(b: int, bb: int, rb: int) -> Tuple[int, int]:
    """``(bpad, rb)`` of a cascade dispatch of ``b`` frames, resolved as
    ``repro`` resolves them: the batch pads to whole tiles of ``bb``, and
    ``rb`` (0 means ``bb``) is clamped to ``[1, bpad]``."""
    bb = max(1, min(bb, b))
    bpad = -(-b // bb) * bb
    return bpad, max(1, min(rb if rb else bb, bpad))


def drain_slots(escalated: int, bpad: int, rb: int, check_every: int) -> int:
    """The recognizer slots ``repro``'s bounded drain loop computes and the
    serving layer bills: every chunk group ``g0`` (every ``check_every``
    chunks of ``rb``) that starts below the escalated count runs whole."""
    n_chunks = -(-bpad // rb)
    return sum(rb * min(check_every, n_chunks - g0)
               for g0 in range(0, n_chunks, check_every)
               if g0 * rb < escalated)


def escalation_mask(det: torch.Tensor, ctrl: torch.Tensor,
                    positive_class: int) -> torch.Tensor:
    """The in-kernel escalation rule on (B, Cd) int32 detector logits: the
    int32 margin (positive logit minus the best other) reaches the
    threshold ``ctrl[0, 0]``, and the lane is below ``ctrl[0, 1]``
    (n_real)."""
    thr, n_real = ctrl.reshape(2)
    cls = torch.arange(det.shape[1], device=det.device)
    rest = torch.where(cls[None, :] == positive_class,
                       torch.tensor(INT32_MIN, dtype=torch.int32,
                                    device=det.device), det).amax(dim=1)
    margin = det[:, positive_class] - rest
    lane = torch.arange(det.shape[0], device=det.device)
    return (margin >= thr) & (lane < n_real)


def cascade_plain(image: Dict[str, torch.Tensor], frames: torch.Tensor,
                  ctrl: torch.Tensor, *, spec, bb: int = 8, rb: int = 0,
                  check_every: int = 1, positive_class: int = 1):
    """Plain PyTorch version of :func:`cascade_forward`, same arguments and
    outputs: ``(det (B, Cd), rec (B, Cr), queue (B,), counts (2,))``, all
    int32, rows of ``rec`` and ``queue`` from E on zero."""
    det_spec, rec_spec = spec
    frames = frames.to(torch.int32)
    b = frames.shape[0]
    cw, ct, cf, fw = (image[k] for k in ("cw", "ct", "cf", "fw"))
    det = _member_plain(frames, cw, ct, cf, fw, det_spec)
    idx = torch.nonzero(escalation_mask(det, ctrl, positive_class))[:, 0]
    e = int(idx.numel())
    queue = torch.zeros(b, dtype=torch.int32, device=frames.device)
    queue[:e] = idx.to(torch.int32)
    rec = torch.zeros((b, rec_spec[-1][2]), dtype=torch.int32,
                      device=frames.device)
    rec[:e] = _member_plain(frames[idx], cw, ct, cf, fw, rec_spec)
    bpad, rb = cascade_schedule(b, bb, rb)
    counts = torch.tensor([e, drain_slots(e, bpad, rb, check_every)],
                          dtype=torch.int32, device=frames.device)
    return det, rec, queue, counts


def delta_plain(image: Dict[str, torch.Tensor], frames: torch.Tensor,
                last: torch.Tensor, llog: torch.Tensor, ctrl: torch.Tensor,
                *, spec, bb: int = 8, rb: int = 0, check_every: int = 1):
    """Plain PyTorch version of :func:`delta_forward`, same arguments and
    outputs: ``(logits (B, C), new_last (B, H, W, C/32), queue (B,),
    counts (2,), deltas (B,))``, all int32.

    Stream b's delta is the popcount of its packed frame XOR ``last[b]``;
    it changes when b < n_real and delta >= threshold.  Changed streams
    take their fresh logits and their current words; every other stream
    keeps ``llog[b]`` and ``last[b]``, except lane 0, whose logits are
    fresh whenever ``repro``'s drain covers a queue row at or past K
    (``min(counts[1], bpad) > K``): those rows hold index 0.
    """
    (member,) = spec
    _, _h, _w, cin, bits, channels = member[0]
    frames = frames.to(torch.int32)
    b = frames.shape[0]
    dev = frames.device
    thr, n_real = ctrl.reshape(2)
    cur = thermometer_pack(frames, bits, cin, channels)
    d = popcount32(cur ^ last).reshape(b, -1).sum(dim=1, dtype=torch.int32)
    live = torch.arange(b, device=dev) < n_real
    mask = (d >= thr) & live
    deltas = torch.where(live, d, torch.zeros_like(d))
    new_last = torch.where(mask[:, None, None, None], cur, last)
    idx = torch.nonzero(mask)[:, 0]
    k = int(idx.numel())
    queue = torch.zeros(b, dtype=torch.int32, device=dev)
    queue[:k] = idx.to(torch.int32)
    bpad, rb = cascade_schedule(b, bb, rb)
    slots = drain_slots(k, bpad, rb, check_every)
    if min(slots, bpad) > k and int(queue[0]) != 0:
        idx = torch.cat([torch.zeros(1, dtype=idx.dtype, device=dev), idx])
    cw, ct, cf, fw = (image[key] for key in ("cw", "ct", "cf", "fw"))
    logits = llog.clone()
    logits[idx] = _member_plain(frames[idx], cw, ct, cf, fw, member)
    counts = torch.tensor([k, slots], dtype=torch.int32, device=dev)
    return logits, new_last, queue, counts, deltas


# ---------------------------------------------------------------------------
# Argument checks (both versions)
# ---------------------------------------------------------------------------

def check_args(image: Dict[str, torch.Tensor],
               frames: Sequence[torch.Tensor], spec) -> None:
    """Raise on operands neither version takes: ``frames`` is one batch
    per member of the composite ``spec``, each member's rows must lie
    inside the image."""
    if len(frames) != len(spec) or not spec:
        raise ValueError(f"{len(frames)} frame batches for a "
                         f"{len(spec)}-member spec")
    dev = frames[0].device
    for key, ndim in (("cw", 4), ("ct", 2), ("cf", 2), ("fw", 3)):
        t = image[key]
        if t.dtype != torch.int32 or t.ndim != ndim:
            raise ValueError(f"image[{key!r}] is {t.dtype} "
                             f"{tuple(t.shape)}, want int32 of {ndim} dims")
        if t.device != dev:
            raise ValueError(f"image[{key!r}] on {t.device}, frames on {dev}")
    lc, ftot, taps, cwmax = image["cw"].shape
    lf, ntot, kwmax = image["fw"].shape
    if taps != 4 or tuple(image["ct"].shape) != (lc, ftot) or (
            tuple(image["cf"].shape) != (lc, ftot)):
        raise ValueError(f"image cw {tuple(image['cw'].shape)}, ct "
                         f"{tuple(image['ct'].shape)} and cf "
                         f"{tuple(image['cf'].shape)} do not agree")
    for f_m, stages in zip(frames, spec):
        io = stages[0]
        if io[0] != "io" or stages[-1][0] != "fc" or not stages[-1][3]:
            raise ValueError("a member spec must run from an io stage to a "
                             "final fc")
        if f_m.ndim != 4 or tuple(f_m.shape[1:]) != tuple(io[1:4]):
            raise ValueError(f"frames {tuple(f_m.shape)} do not match the io "
                             f"stage (B, {io[1]}, {io[2]}, {io[3]})")
        if f_m.device != dev:
            raise ValueError(f"frame batches on {f_m.device} and {dev}")
        head, tail = _split_stages(stages)
        if len(head) - 1 > lc or len(tail) > lf:
            raise ValueError(f"image holds {lc} conv and {lf} fc layers, a "
                             f"member has {len(head) - 1} and {len(tail)}")
        for _, _h, _w, c, f, _pool, f_off in head[1:]:
            if f_off < 0 or f_off + f > ftot or c // PACK_WIDTH > cwmax:
                raise ValueError(f"conv C={c}, F={f} at row {f_off} does not "
                                 f"fit image cw {tuple(image['cw'].shape)}")
        for _, k, n, _final, _pack, n_off in tail:
            if n_off < 0 or n_off + n > ntot or -(-k // PACK_WIDTH) > kwmax:
                raise ValueError(f"fc {k}->{n} at row {n_off} does not fit "
                                 f"image fw {tuple(image['fw'].shape)}")
    if max(f_m.shape[0] for f_m in frames) < 1:
        raise ValueError("empty frame batch")


def _check_drain(frames: torch.Tensor, ctrl: torch.Tensor, bb: int, rb: int,
                 check_every: int) -> None:
    """Raise on a drain schedule or a control word neither version of the
    cascade or the delta gate takes."""
    if bb < 1 or rb < 0 or check_every < 1:
        raise ValueError(f"bad drain schedule bb={bb}, rb={rb}, "
                         f"check_every={check_every}")
    if (ctrl.dtype != torch.int32 or ctrl.numel() != 2
            or ctrl.device != frames.device):
        raise ValueError(f"ctrl must be 2 int32 values on {frames.device}, "
                         f"got {ctrl.dtype} {tuple(ctrl.shape)} on "
                         f"{ctrl.device}")


def check_cascade_args(image, frames: torch.Tensor, ctrl: torch.Tensor,
                       spec, *, bb: int, rb: int, check_every: int,
                       positive_class: int) -> None:
    """Raise on cascade operands neither version takes."""
    if len(spec) != 2:
        raise ValueError(f"cascade spec needs exactly 2 members (detector, "
                         f"recognizer), got {len(spec)}")
    check_args(image, (frames, frames), spec)
    ncd = spec[0][-1][2]
    if ncd < 2:
        raise ValueError(f"detector needs >= 2 classes, got {ncd}")
    if not 0 <= positive_class < ncd:
        raise ValueError(f"positive_class {positive_class} out of range for "
                         f"{ncd} detector classes")
    _check_drain(frames, ctrl, bb, rb, check_every)


def check_delta_args(image, frames: torch.Tensor, last: torch.Tensor,
                     llog: torch.Tensor, ctrl: torch.Tensor, spec, *,
                     bb: int, rb: int, check_every: int) -> None:
    """Raise on delta-gate operands neither version takes."""
    if len(spec) != 1:
        raise ValueError(f"delta spec needs exactly 1 member, got "
                         f"{len(spec)}")
    check_args(image, (frames,), spec)
    (member,) = spec
    _, h, w, _cin, _bits, channels = member[0]
    if channels % PACK_WIDTH:
        raise ValueError(f"delta gating needs io channels % {PACK_WIDTH} "
                         f"== 0, got {channels}")
    b = frames.shape[0]
    for name, t, shape in (("last-frame", last,
                            (b, h, w, channels // PACK_WIDTH)),
                           ("last-logits", llog, (b, member[-1][2]))):
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"{name} state must be int32 of {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != frames.device:
            raise ValueError(f"{name} state on {t.device}, frames on "
                             f"{frames.device}")
    _check_drain(frames, ctrl, bb, rb, check_every)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

def _map_words(stages) -> int:
    """Words in one of a member's ping-pong map buffers: its largest map."""
    head, tail = _split_stages(stages)
    _, h, w, _cin, _bits, channels = head[0]
    words = [h * w * channels // PACK_WIDTH]
    for _, ch, cwd, _c, f, pool, _off in head[1:]:
        ho, wo = ch - 1, cwd - 1
        if pool:
            ho, wo = ho // 2, wo // 2
        words.append(ho * wo * f // PACK_WIDTH)
    words += [-(-st[2] // PACK_WIDTH) for st in tail]
    return max(words)


@functools.lru_cache(maxsize=256)
def composite_table(spec, cw_shape: Tuple[int, ...],
                    fw_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The int32 launch table ``parse_table`` (csrc/megakernel.cuh) reads,
    after checking that the kernels take the spec: at most 4 members and
    16 layers of each kind each, F and C whole words, C <= 256 (the
    cluster body's own limits are :func:`cluster_geometry`'s)."""
    if not 0 < len(spec) <= MAX_MEMBERS:
        raise ValueError(f"the kernels take 1 to {MAX_MEMBERS} members, got "
                         f"{len(spec)}")
    table = [len(spec)]
    for stages in spec:
        head, tail = _split_stages(stages)
        _, h, w, cin, _bits, channels = head[0]
        convs = head[1:]
        if len(convs) > MAX_LAYERS or not 0 < len(tail) <= MAX_LAYERS:
            raise ValueError(f"the kernels take <= {MAX_LAYERS} layers of "
                             f"each kind, got {len(convs)} conv and "
                             f"{len(tail)} fc")
        if channels % PACK_WIDTH:
            raise ValueError(f"io channels {channels} not a multiple of 32")
        table += [h, w, cin, channels // cin, channels // PACK_WIDTH,
                  len(convs)]
        for _, ch, cwd, c, f, pool, f_off in convs:
            if (f % PACK_WIDTH or c % PACK_WIDTH
                    or c // PACK_WIDTH > MAX_CHANNEL_WORDS):
                raise ValueError(f"the kernels cannot take conv C={c}, F={f}")
            table += [ch, cwd, c, f, int(pool), f_off]
        table.append(len(tail))
        for _, k, n, _final, _pack_out, n_off in tail:
            table += [k, n, n_off]
    _, ftot, _, cwmax = cw_shape
    _, ntot, kwmax = fw_shape
    return tuple(table + [ftot, cwmax, ntot, kwmax])


def _round4(n: int) -> int:
    return -(-n // 4) * 4


@dataclasses.dataclass(frozen=True)
class ClusterGeometry:
    """Launch geometry of the cluster member body (csrc/member_mma.cuh
    ``Geometry``); the kernels take it as it is."""
    cluster: int         # blocks a cluster: one frame's ranks
    map_words: int       # words of each ping-pong map buffer (a multiple of 4)
    kstride: int         # words a staged tap row (8 mod 16)
    fmax: int            # feature rows of each tap buffer: the widest F
    pix_words: int       # words of a rank's pixel staging buffer
    smem: int            # dynamic shared memory bytes a block
    ksteps: tuple        # each member's 256-bit K steps a conv layer

    @property
    def args(self) -> tuple:
        """The int array ``parse_geometry`` reads, in its order."""
        return (self.cluster, self.map_words, self.kstride, self.fmax,
                self.pix_words, self.smem) + tuple(
                    k for member in self.ksteps for k in member)


def band_start(ho: int, r: int, n: int) -> int:
    """Rank r's first output row of a layer of ``ho`` rows over ``n`` ranks
    (member_mma.cuh band_start): its band is [band_start(ho, r, n),
    band_start(ho, r + 1, n)), maybe empty."""
    return ho * r // n


def rows_read(first: int, last: int, pool: bool) -> Tuple[int, int]:
    """The input rows output rows [first, last) of a 2x2 conv read
    (member_mma.cuh rows_read): one more below, two with the pool."""
    if first >= last:
        return 0, 0
    return (2 * first, 2 * last + 1) if pool else (first, last + 1)


@functools.lru_cache(maxsize=256)
def cluster_geometry(spec, cluster: int = 0) -> ClusterGeometry:
    """Cluster size, buffers, tap strides and shared memory of one launch
    of the cluster body on the composite ``spec``.

    A cluster has ``cluster`` blocks (1 to 8); 0 means one block for each
    feature word of the launch's widest conv layer (8 at S=1, 4 at S=2, 2
    at S=4, 1 without a conv layer).  Every member splits each layer's
    output rows over all of them.  A block holds two copies of the largest
    map, two tap buffers of the widest layer's F rows of ``kstride`` words
    (K padded to whole 256-bit steps; 8 mod 16 words, so the 8-byte B
    loads of a half warp fall in distinct banks), two (tau, flip) pairs,
    and the pixels of the input rows its first layer reads (the same words
    then hold a layer's row readers, a word an output row).  A layer's
    F/32 feature slices must divide the block's warps.  Raises on a spec
    the kernels cannot take.
    """
    fwords, pix, out_rows = [], [], [1]
    for stages in spec:
        head, _ = _split_stages(stages)
        _, h, w, cin, _bits, channels = head[0]
        if channels % PACK_WIDTH or not 0 < channels // PACK_WIDTH <= (
                MAX_CHANNEL_WORDS):
            raise ValueError(f"the cluster body cannot take io channels "
                             f"{channels}")
        for _, ch, _w, c, f, pool, _off in head[1:]:
            if (f % PACK_WIDTH or c % PACK_WIDTH or not 0 < f <= 256
                    or CLUSTER_WARPS % (f // PACK_WIDTH)
                    or not 0 < c // PACK_WIDTH <= MAX_CHANNEL_WORDS):
                raise ValueError(f"the cluster body cannot take conv C={c}, "
                                 f"F={f}")
            fwords.append(f // PACK_WIDTH)
            out_rows.append((ch - 1) // 2 if pool else ch - 1)
        pix.append((head, h, w, cin))
    if not 0 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"a cluster holds 1 to {MAX_CLUSTER} blocks, got "
                         f"{cluster}")
    cluster = cluster or max(fwords, default=1)
    rows = []
    for head, h, w, cin in pix:
        for r in range(cluster):
            if len(head) > 1:
                _, ch, _cw, _c, _f, pool, _off = head[1]
                ho = (ch - 1) // 2 if pool else ch - 1
                first, last = rows_read(band_start(ho, r, cluster),
                                        band_start(ho, r + 1, cluster), pool)
            else:
                first, last = 0, h
            rows.append((last - first) * w * cin)
    ksteps = tuple(tuple(-(-4 * (st[3] // PACK_WIDTH) // STEP_WORDS)
                         for st in _split_stages(stages)[0][1:])
                   for stages in spec)
    kpad = STEP_WORDS * max((k for m in ksteps for k in m), default=1)
    kstride = kpad + 8 if kpad % 16 == 0 else kpad
    fmax = PACK_WIDTH * max(fwords, default=1)
    map_words = _round4(max(_map_words(stages) for stages in spec))
    pix_words = _round4(max(max(rows) + 3, max(out_rows)))
    smem = 4 * (2 * map_words + 2 * fmax * (kstride + 2) + pix_words)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a cluster block needs {smem} B of shared memory, "
                         f"more than {SMEM_LIMIT}")
    return ClusterGeometry(cluster, map_words, kstride, fmax, pix_words, smem,
                           ksteps)


def cascade_geometry(spec, batch: int, sms: int = SMS, det_cluster: int = 0
                     ) -> Tuple[ClusterGeometry, ClusterGeometry]:
    """The cascade's two stage geometries (csrc/cascade.cu), each sized
    for its member alone, so the narrow detector never carves the
    recognizer's shared memory: the recognizer's own, and the detector's
    at ``det_cluster`` blocks a cluster.  ``det_cluster`` 0 picks the
    recognizer's cluster shape while ``batch`` such clusters, a block an
    SM, take at most half the card's ``sms``, else the detector's own.
    More ranks a frame shorten each layer's tile chain, but only while the
    clusters run in one wave, and a cluster must fit inside one GPC (16 to
    18 SMs on an H100), so whole clusters of 8 leave SMs over and the card
    holds fewer than ``sms / 8`` at once.  On an H100, face -> owner: the
    recognizer's shape is faster at batch 8, the detector's own at 16 and
    256 (PERF.md)."""
    det_spec, rec_spec = spec
    rec = cluster_geometry((rec_spec,))
    if not det_cluster and 2 * batch * rec.cluster <= sms:
        det_cluster = rec.cluster
    return cluster_geometry((det_spec,), det_cluster), rec


@dataclasses.dataclass(frozen=True)
class GateGeometry:
    """Launch geometry of the delta gate (csrc/delta.cu gate_kernel)."""
    blocks: int          # gate blocks a stream
    pix_words: int       # words of a block's pixel staging buffer
    smem: int            # dynamic shared memory bytes a gate block
    cur_stride: int      # words a stream's row of the packed-word scratch


@functools.lru_cache(maxsize=64)
def gate_geometry(stages) -> GateGeometry:
    """Blocks a stream and buffers of the delta gate for one member: the
    frame's positions split over blocks of at most GATE_WORDS packed words,
    each staging its positions' pixels and last words."""
    _, h, w, cin, _bits, channels = stages[0]
    hw, cwio = h * w, channels // PACK_WIDTH
    blocks = min(hw, max(1, -(-hw * cwio // GATE_WORDS)))
    per = -(-hw // blocks)
    pix_words = _round4(per * cin + 3)
    last_words = _round4(per * cwio + 3)
    return GateGeometry(blocks, pix_words, 4 * (pix_words + last_words),
                        _round4(hw * cwio))


@functools.lru_cache(maxsize=64)
def _thresholds(bits: int, per: int, device: torch.device) -> torch.Tensor:
    return thermometer_thresholds(bits, per, device=device)


def _member_thresholds(stages, device) -> torch.Tensor:
    _, _h, _w, cin, bits, channels = stages[0]
    return _thresholds(bits, channels // cin, device)


_INTS = ctypes.POINTER(ctypes.c_int)
# the C entry points' arguments, in order: pointers (and the stream) as
# c_void_p, ints as c_int, arrays as pointers
COMPOSITE_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] * 2
                      + [ctypes.c_void_p] * 4
                      + [ctypes.POINTER(ctypes.c_void_p), _INTS, _INTS,
                         ctypes.c_int, _INTS, ctypes.c_int, ctypes.c_void_p])
CASCADE_ARGTYPES = ([ctypes.c_void_p] * 12 + [_INTS, ctypes.c_int] * 3
                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
DELTA_ARGTYPES = ([ctypes.c_void_p] * 16 + [_INTS, ctypes.c_int, _INTS]
                  + [ctypes.c_int] * 9 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _composite_launcher():
    fn = _build.library("megakernel").composite_launch
    fn.argtypes = COMPOSITE_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _cascade_launcher():
    fn = _build.library("cascade").cascade_launch
    fn.argtypes = CASCADE_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _delta_launcher():
    fn = _build.library("delta").delta_launch
    fn.argtypes = DELTA_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def _ptrs(values) -> ctypes.Array:
    return (ctypes.c_void_p * len(values))(*values)


def _image_words(image):
    """The image's words, 16-byte aligned (the kernels' cp.async)."""
    return tuple(aligned16(image[k]) for k in ("cw", "ct", "cf", "fw"))


def _need_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{t.device}")


def _launch_composite(image, frames, spec, cluster: Optional[int]
                      ) -> Tuple[torch.Tensor, ...]:
    """One launch of csrc/megakernel.cu's composite kernel (uncounted)."""
    check_args(image, frames, spec)
    _need_cuda(frames[0])
    cw, ct, cf, fw = _image_words(image)
    table = composite_table(spec, tuple(cw.shape), tuple(fw.shape))
    geo = cluster_geometry(spec, cluster or 0)
    dev = frames[0].device
    frames = [f.to(torch.int32).contiguous() for f in frames]
    thr = [_member_thresholds(st, dev) for st in spec]
    outs = [torch.empty((f.shape[0], st[-1][2]), dtype=torch.int32,
                        device=dev) for f, st in zip(frames, spec)]
    # an empty member batch launches no block; its pointer is never read
    with torch.cuda.device(dev):
        err = _composite_launcher()(
            _ptrs([f.data_ptr() for f in frames]),
            _ptrs([t.data_ptr() for t in thr]),
            cw.data_ptr(), ct.data_ptr(), cf.data_ptr(), fw.data_ptr(),
            _ptrs([o.data_ptr() for o in outs]),
            _ints([f.shape[0] for f in frames]), _ints(table), len(table),
            _ints(geo.args), len(geo.args),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"composite launch failed: CUDA error {err}")
    return tuple(outs)


def composite_forward(image: Dict[str, torch.Tensor],
                      frames: Sequence[torch.Tensor], *, spec,
                      cluster: Optional[int] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """Launch the composite kernel on CUDA tensors (raises on any other
    device).

    image: the composite weight image (``interpreter.pack_programs``):
    ``cw`` (Lc, F_total, 4, Cw_max), ``ct``/``cf`` (Lc, F_total),
    ``fw`` (Lf, N_total, Kw_max), all int32; frames: one (B_m, H_m, W_m,
    Cin_m) integer batch per member, ragged batches allowed; spec: the
    composite spec; cluster: blocks a cluster (None: the widest conv's
    feature words, :func:`cluster_geometry`).  Returns a tuple of
    (B_m, classes_m) int32 logits.
    """
    outs = _launch_composite(image, tuple(frames), spec, cluster)
    LAUNCHES["composite"] += 1
    return outs


def megakernel_forward(image: Dict[str, torch.Tensor], frames: torch.Tensor,
                       *, spec, cluster: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel for one program on CUDA tensors (raises on any
    other device): the one-member composite.

    image: the weight image (``cw`` (Lc, F, 4, F/32), ``ct``/``cf``
    (Lc, F), ``fw`` (Lf, Nmax, Kwmax), all int32); frames: (B, H, W, Cin)
    integer pixels; spec: ``InferencePlan.mega``; cluster: as
    :func:`composite_forward`.  Returns (B, classes) int32 logits.
    """
    out, = _launch_composite(image, (frames,), solo_member_spec(spec),
                             cluster)
    LAUNCHES["megakernel"] += 1
    return out


def cascade_forward(image: Dict[str, torch.Tensor], frames: torch.Tensor,
                    ctrl: torch.Tensor, *, spec, bb: int = 8, rb: int = 0,
                    check_every: int = 1, positive_class: int = 1,
                    det_cluster: int = 0):
    """Launch the fused cascade on CUDA tensors (raises on any other
    device): one ``cascade_launch``, three kernels on the current stream,
    each stage at its :func:`cascade_geometry` on this card
    (``det_cluster``: the detector's blocks a cluster, 0 to pick by the
    batch).

    image: the detector + recognizer composite image
    (``interpreter.pack_cascade``); frames: (B, H, W, Cin) integer pixels,
    one stream for both stages; ctrl: (1, 2) int32 ``[threshold, n_real]``
    on the device (``CascadePlan.margin_ctrl``; n_real <= B); spec: the
    2-member composite spec, detector first; bb/rb/check_every: the drain
    schedule of ``repro`` that ``counts[1]`` bills (bb is only the pad
    granule here, rb = 0 means bb).

    Returns ``(det (B, Cd), rec (B, Cr), queue (B,), counts (2,))``, all
    int32: ``counts[0]`` = E escalated frames, ``queue[:E]`` their indices
    in ascending order, ``rec[k]`` answering frame ``queue[k]``, rows of
    ``rec`` and ``queue`` from E on zero; ``counts[1]`` the recognizer
    slots billed (:func:`drain_slots`).
    """
    check_cascade_args(image, frames, ctrl, spec, bb=bb, rb=rb,
                       check_every=check_every,
                       positive_class=positive_class)
    _need_cuda(frames)
    cw, ct, cf, fw = _image_words(image)
    table = composite_table(spec, tuple(cw.shape), tuple(fw.shape))
    dev = frames.device
    frames = frames.to(torch.int32).contiguous()
    ctrl = ctrl.reshape(2).contiguous()
    b = frames.shape[0]
    bpad, rb = cascade_schedule(b, bb, rb)
    det_spec, rec_spec = spec
    det = torch.empty((b, det_spec[-1][2]), dtype=torch.int32, device=dev)
    rec = torch.empty((b, rec_spec[-1][2]), dtype=torch.int32, device=dev)
    queue = torch.empty(b, dtype=torch.int32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    det_geo, rec_geo = cascade_geometry(spec, b, sm_count(dev), det_cluster)
    with torch.cuda.device(dev):
        err = _cascade_launcher()(
            frames.data_ptr(), _member_thresholds(det_spec, dev).data_ptr(),
            _member_thresholds(rec_spec, dev).data_ptr(),
            cw.data_ptr(), ct.data_ptr(), cf.data_ptr(), fw.data_ptr(),
            ctrl.data_ptr(), det.data_ptr(), rec.data_ptr(),
            queue.data_ptr(), counts.data_ptr(), _ints(table), len(table),
            _ints(det_geo.args), len(det_geo.args), _ints(rec_geo.args),
            len(rec_geo.args), b, bpad, rb, check_every, positive_class,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cascade launch failed: CUDA error {err}")
    LAUNCHES["cascade"] += 1
    return det, rec, queue, counts


def delta_forward(image: Dict[str, torch.Tensor], frames: torch.Tensor,
                  last: torch.Tensor, llog: torch.Tensor, ctrl: torch.Tensor,
                  *, spec, bb: int = 8, rb: int = 0, check_every: int = 1,
                  cluster: Optional[int] = None):
    """Launch the delta-gated megakernel on CUDA tensors (raises on any
    other device): one ``delta_launch``, three kernels on the current
    stream, the recompute in clusters of ``cluster`` blocks (as
    :func:`composite_forward`).

    image: the program's weight image (``interpreter.pack_delta``);
    frames: (B, H, W, Cin) integer pixels, slot b = stream b; last:
    (B, H, W, C/32) int32 words, each stream's resident last frame; llog:
    (B, classes) int32 cached logits; ctrl: (1, 2) int32 ``[threshold,
    n_real]`` on the device (``DeltaPlan.delta_ctrl``; n_real <= B); spec:
    the one-member composite spec; bb/rb/check_every: the drain schedule
    of ``repro`` that ``counts[1]`` bills (bb is only the pad granule,
    rb = 0 means bb).

    Returns ``(logits (B, C), new_last, queue (B,), counts (2,),
    deltas (B,))``, all int32, as :func:`delta_plain`.
    """
    check_delta_args(image, frames, last, llog, ctrl, spec, bb=bb, rb=rb,
                     check_every=check_every)
    _need_cuda(frames)
    cw, ct, cf, fw = _image_words(image)
    table = composite_table(spec, tuple(cw.shape), tuple(fw.shape))
    dev = frames.device
    frames = frames.to(torch.int32).contiguous()
    last, llog = last.contiguous(), llog.contiguous()
    ctrl = ctrl.reshape(2).contiguous()
    b = frames.shape[0]
    bpad, rb = cascade_schedule(b, bb, rb)
    (member,) = spec
    geo, gate = cluster_geometry(spec, cluster or 0), gate_geometry(member)
    logits = torch.empty_like(llog)
    new_last = torch.empty_like(last)
    queue = torch.empty(b, dtype=torch.int32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    deltas = torch.empty(b, dtype=torch.int32, device=dev)
    # scratch: the gate's packed words and partial deltas
    cur = torch.empty((b, gate.cur_stride), dtype=torch.int32, device=dev)
    partial = torch.empty((b, gate.blocks), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _delta_launcher()(
            frames.data_ptr(), _member_thresholds(member, dev).data_ptr(),
            cw.data_ptr(), ct.data_ptr(), cf.data_ptr(), fw.data_ptr(),
            last.data_ptr(), llog.data_ptr(), ctrl.data_ptr(),
            cur.data_ptr(), partial.data_ptr(), logits.data_ptr(),
            new_last.data_ptr(), queue.data_ptr(), counts.data_ptr(),
            deltas.data_ptr(), _ints(table), len(table), _ints(geo.args),
            len(geo.args), b, bpad, rb, check_every, gate.blocks,
            gate.pix_words, gate.smem, gate.cur_stride,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"delta launch failed: CUDA error {err}")
    LAUNCHES["delta"] += 1
    return logits, new_last, queue, counts, deltas
