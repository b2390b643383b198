"""step_mfu: the whole step's share of the card's binary MAC peak, in %.

The binary MACs the window's inputs needed (a network's MACs on every
frame it must answer: the detector on every frame and the recogniser on
the escalated ones; under the delta gate, the changed streams' networks;
drain padding not counted), over the window's seconds times
``counts.BINARY_MACS_S``.  Moves frames_per_s.
"""

from portbench import counts


def read(w):
    if not w.seconds or not w.macs:
        return None
    return 100.0 * w.macs / (w.seconds * counts.BINARY_MACS_S)
