"""Whole-network megakernel for one program: CUDA kernel and plain version.

The counterpart of ``repro.kernels.megakernel`` in its solo case
(``megakernel_forward``, the one-member ``_composite_kernel``): raw frames
in, int32 logits out, with the thermometer encode, every conv layer and
the FC tail in one launch.  The kernel is ``csrc/megakernel.cu`` (one
thread block per frame, feature maps in shared memory);
:func:`megakernel_plain` chains the plain pieces below, the same arithmetic
as the staged path's plain versions.

Stage spec entries (hashable; built by ``interpreter.compile_plan``)::

    ("io",   h, w, cin, bits, channels)
    ("conv", h, w, c, f, pool)        h/w = input map size
    ("fc",   k, n, final, pack_out)

Multi-program composites, f-tiling and frame tiles are not ported: the
first are a later slice, the other two were TPU schedule knobs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.core.binarize import (PACK_WIDTH, pack_bit_lanes,
                                       thermometer_pack,
                                       thermometer_thresholds,
                                       xnor_dot_popcount)
from repro_torch.kernels.binary_conv2x2_block import (MAX_CHANNEL_WORDS,
                                                      conv_block_body)
from repro_torch.kernels import _build

WARPS = 16                   # warps per block in csrc/megakernel.cu
MAX_LAYERS = 16              # the chip's 16-slot program memory
SMEM_LIMIT = 232448          # shared memory one H100 block may use

# kernel launches since the last reset
LAUNCHES = {"megakernel": 0}


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _fc_body(x: torch.Tensor, wfc: torch.Tensor, k: int) -> torch.Tensor:
    """Packed FC: (B, Kw) x (N, Kw) words -> (B, N) int32 sums."""
    return xnor_dot_popcount(x[:, None, :], wfc[None, :, :], k)


def _run_fc_tail(fm: torch.Tensor, fw: torch.Tensor, fc_stages) -> torch.Tensor:
    """The FC chain on a packed map (flattened in (H, W, F/32) order, which
    is the FC's K order) or on packed rows."""
    x = fm.reshape(fm.shape[0], -1) if fm.ndim == 4 else fm
    for fi, st in enumerate(fc_stages):
        _, k, n, final, _pack_out = st
        kw = -(-k // PACK_WIDTH)
        s = _fc_body(x, fw[fi, :n, :kw], k)
        if final:
            return s
        bits = s < 0
        if n % PACK_WIDTH:     # odd-width hidden FC: sign, pad, repack
            bits = torch.nn.functional.pad(bits, (0, (-n) % PACK_WIDTH),
                                           value=False)
        x = pack_bit_lanes(bits)
    raise AssertionError("stage spec must end with a final FC stage")


def _split_stages(stages):
    """(io+conv prefix, fc tail) of a stage spec."""
    n = sum(1 for st in stages if st[0] != "fc")
    return stages[:n], stages[n:]


def _run_member(frames, cw, ct, cf, fw, stages) -> torch.Tensor:
    """The whole network on (B, H, W, Cin) int32 pixels -> (B, classes)."""
    head, tail = _split_stages(stages)
    _, _h, _w, cin, bits, channels = head[0]
    fm = thermometer_pack(frames, bits, cin, channels)
    for ci, (_, h, w, c, f, pool) in enumerate(head[1:]):
        fm = conv_block_body(fm, cw[ci, :f, :, :c // PACK_WIDTH],
                             ct[ci, :f], cf[ci, :f], k4=4 * c, h=h, wd=w,
                             pool=pool)
    return _run_fc_tail(fm, fw, tail)


def megakernel_plain(image: Dict[str, torch.Tensor], frames: torch.Tensor, *,
                     spec) -> torch.Tensor:
    """Plain PyTorch version: (B, H, W, Cin) frames -> (B, classes) int32
    logits, through the weight image (``interpreter.build_weight_image``)."""
    return _run_member(frames.to(torch.int32), image["cw"], image["ct"],
                       image["cf"], image["fw"], spec)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def stage_table(spec, fw_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The int32 stage table ``megakernel_launch`` parses, after checking
    that the kernel takes the program: at most 16 layers of each kind,
    F/32 dividing the block's 16 warps, C <= 256 and both ping-pong maps
    inside one block's shared memory."""
    head, tail = _split_stages(spec)
    _, h, w, cin, _bits, channels = head[0]
    cwio = channels // PACK_WIDTH
    convs = head[1:]
    if len(convs) > MAX_LAYERS or not 0 < len(tail) <= MAX_LAYERS:
        raise ValueError(f"megakernel takes <= {MAX_LAYERS} layers of each "
                         f"kind, got {len(convs)} conv and {len(tail)} fc")
    words = [h * w * cwio]
    table = [h, w, cin, channels // cin, cwio, len(convs)]
    for _, ch, cwd, c, f, pool in convs:
        if (f % PACK_WIDTH or WARPS % (f // PACK_WIDTH)
                or c % PACK_WIDTH or c // PACK_WIDTH > MAX_CHANNEL_WORDS):
            raise ValueError(f"megakernel cannot take conv C={c}, F={f}")
        ho, wo = ch - 1, cwd - 1
        if pool:
            ho, wo = ho // 2, wo // 2
        words.append(ho * wo * f // PACK_WIDTH)
        table += [ch, cwd, c, f, int(pool)]
    _, nmax, kwmax = fw_shape
    table.append(len(tail))
    for _, k, n, _final, _pack_out in tail:
        if n > nmax or -(-k // PACK_WIDTH) > kwmax:
            raise ValueError(f"fc {k}->{n} exceeds the image's fw {fw_shape}")
        words.append(-(-n // PACK_WIDTH))
        table += [k, n]
    smem_words = max(words)
    if 2 * smem_words * 4 > SMEM_LIMIT:
        raise ValueError(f"maps of {smem_words} words exceed shared memory")
    return tuple(table + [nmax, kwmax, smem_words])


@functools.lru_cache(maxsize=64)
def _thresholds(bits: int, per: int, device: torch.device) -> torch.Tensor:
    return thermometer_thresholds(bits, per, device=device)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("megakernel").megakernel_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int)]
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_args(image: Dict[str, torch.Tensor], frames: torch.Tensor,
               spec) -> None:
    """Raise on operands neither version takes."""
    io = spec[0]
    if io[0] != "io" or spec[-1][0] != "fc" or not spec[-1][3]:
        raise ValueError("stage spec must run from an io stage to a final fc")
    if frames.ndim != 4 or tuple(frames.shape[1:]) != tuple(io[1:4]):
        raise ValueError(f"frames {tuple(frames.shape)} do not match the io "
                         f"stage (B, {io[1]}, {io[2]}, {io[3]})")
    if frames.shape[0] < 1:
        raise ValueError("empty frame batch")
    convs = [st for st in spec if st[0] == "conv"]
    n_fc = sum(1 for st in spec if st[0] == "fc")
    for key, ndim, layers in (("cw", 4, len(convs)), ("ct", 2, len(convs)),
                              ("cf", 2, len(convs)), ("fw", 3, n_fc)):
        t = image[key]
        if t.dtype != torch.int32 or t.ndim != ndim or t.shape[0] < layers:
            raise ValueError(f"image[{key!r}] is {t.dtype} "
                             f"{tuple(t.shape)}, which does not fit the spec")
        if t.device != frames.device:
            raise ValueError(f"image[{key!r}] on {t.device}, frames on "
                             f"{frames.device}")
    for _, _h, _w, c, f, _pool in convs:
        if tuple(image["cw"].shape[1:]) != (f, 4, c // PACK_WIDTH):
            raise ValueError(f"image cw {tuple(image['cw'].shape)} does not "
                             f"fit a conv with C={c}, F={f}")


def megakernel_forward(image: Dict[str, torch.Tensor], frames: torch.Tensor,
                       *, spec) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (raises on any other device).

    image: the weight image (``cw`` (Lc, F, 4, F/32), ``ct``/``cf``
    (Lc, F), ``fw`` (Lf, Nmax, Kwmax), all int32); frames: (B, H, W, Cin)
    integer pixels; spec: ``InferencePlan.mega``.  Returns (B, classes)
    int32 logits.
    """
    check_args(image, frames, spec)
    if frames.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{frames.device}")
    table = stage_table(spec, tuple(image["fw"].shape))
    frames = frames.to(torch.int32).contiguous()
    cw, ct, cf, fw = (image[k].contiguous() for k in ("cw", "ct", "cf", "fw"))
    _, _h, _w, cin, bits, channels = spec[0]
    thr = _thresholds(bits, channels // cin, frames.device)
    b = frames.shape[0]
    out = torch.empty((b, spec[-1][2]), dtype=torch.int32,
                      device=frames.device)
    c_table = (ctypes.c_int * len(table))(*table)
    with torch.cuda.device(frames.device):
        err = _launcher()(frames.data_ptr(), thr.data_ptr(), cw.data_ptr(),
                          ct.data_ptr(), cf.data_ptr(), fw.data_ptr(),
                          out.data_ptr(), c_table, len(table), b,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    LAUNCHES["megakernel"] += 1
    return out
