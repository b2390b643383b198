"""delta_pad_ratio: slots recomputed over streams changed,
``sum counts[1] / sum counts[0]`` of the delta gate's own counts over the
window."""


def read(w):
    if w.kind != "delta" or not w.counts:
        return None
    changed = sum(c[0] for c in w.counts)
    return sum(c[1] for c in w.counts) / changed if changed else None
