"""The roofline share of a plan entry's calls, shared by the
``<kernel>_roofline`` readers: the least time the card could take, the
larger of the calls' binary MACs over the peak and their bytes over HBM's
bandwidth, summed over the calls, over the calls' device seconds from
CUDA events around each call (which also hold the call's small
conversions of the answers), in %."""

from portbench import counts


def share(w, kind):
    if w.kind != kind or not w.calls:
        return None
    bound = sum(max(m / counts.BINARY_MACS_S, b / counts.HBM_BYTES_S)
                for m, b, _t in w.calls)
    spent = sum(t for _m, _b, t in w.calls)
    return 100.0 * bound / spent if spent > 0 else None
