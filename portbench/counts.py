"""The yardstick: binary MACs and bytes from a configuration's layer list,
and the H100's peaks they are held against.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W power limit):

* ``HBM_BYTES_S`` = 3.35e12 B/s.
* ``BINARY_MACS_S`` = 7.916e15 binary MAC/s.  The data sheet gives 1,979
  TOP/s int8, which is 989.5e12 MAC/s.  A ``.b1`` ``mma.sync.m16n8k256``
  does 256 / 32 = 8 times the MACs of an ``.s8`` ``m16n8k32`` and issues at
  the same rate (the repository's smoke measured the ratio 7.998 on the
  card), so 8 x 989.5e12 = 7.916e15.

A binary MAC is one +/-1 product of a conv or FC layer.  The first conv
layer counts at the full encoded width (``channels``), as the chip does.
Bytes count each input read once and each output written once: int32
frames (12,288 B for a 32 x 32 x 3 frame), the weight image, the resident
state, and what the plan entry returns.
"""

from __future__ import annotations

from typing import List

BINARY_MACS_S = 8 * 1979e12 / 2
HBM_BYTES_S = 3.35e12
WORD = 4                         # int32 / float32 bytes
LABEL = 8                        # int64 label bytes


def macs_per_frame(layers: List[dict]) -> int:
    """Binary MACs of one frame through the network ``layers``."""
    total = 0
    for ly in layers:
        if ly["kind"] == "conv":
            total += (ly["h"] - 1) * (ly["w"] - 1) * ly["f"] * 4 * ly["c"]
        elif ly["kind"] == "fc":
            total += ly["k"] * ly["n"]
    return total


def image_bytes(layers: List[dict]) -> int:
    """The weight image: packed conv taps, a threshold and a direction a
    feature and layer, and packed FC rows."""
    total = 0
    for ly in layers:
        if ly["kind"] == "conv":
            total += ly["f"] * 4 * (ly["c"] // 32) * WORD + 2 * ly["f"] * WORD
        elif ly["kind"] == "fc":
            total += ly["n"] * -(-ly["k"] // 32) * WORD
    return total


def frame_bytes(layers: List[dict]) -> int:
    io = layers[0]
    return io["h"] * io["w"] * io["cin"] * WORD


def state_bytes(layers: List[dict]) -> int:
    """One stream's resident last-frame words."""
    io = layers[0]
    return io["h"] * io["w"] * io["channels"] // 32 * WORD


def classes(layers: List[dict]) -> int:
    return layers[-1]["n"]


def answer_bytes(layers: List[dict]) -> int:
    """A frame's answer as a plan entry returns it: int32 logits from the
    kernel, float32 logits and an int64 label."""
    return 2 * classes(layers) * WORD + LABEL


def solo_call(layers: List[dict], batch: int):
    """(MACs, bytes) one solo megakernel call needs."""
    return (batch * macs_per_frame(layers),
            batch * (frame_bytes(layers) + answer_bytes(layers))
            + image_bytes(layers))


def cascade_call(det: List[dict], rec: List[dict], batch: int,
                 escalated: int):
    """(MACs, bytes) one fused cascade call needs: the detector on every
    frame, the recogniser on the escalated ones; frames read once, both
    images, both stages' answers, the queue and the counts."""
    macs = batch * macs_per_frame(det) + escalated * macs_per_frame(rec)
    nbytes = (batch * (frame_bytes(det) + answer_bytes(det)
                       + answer_bytes(rec) + WORD)
              + image_bytes(det) + image_bytes(rec) + 2 * WORD)
    return macs, nbytes


def delta_call(layers: List[dict], streams: int, changed: int):
    """(MACs, bytes) one delta-gated tick needs: the changed streams'
    networks; every frame, the last-frame state and cached logits read,
    the new state, the answers and a distance a stream written, the queue
    and the counts."""
    macs = changed * macs_per_frame(layers)
    per_stream = (frame_bytes(layers) + 2 * state_bytes(layers)
                  + classes(layers) * WORD + answer_bytes(layers)
                  + 2 * WORD)
    return macs, streams * per_stream + image_bytes(layers) + 2 * WORD
