"""cascade_pad_ratio: recogniser slots billed over frames escalated,
``sum counts[1] / sum counts[0]`` of the cascade's own counts over the
window."""


def read(w):
    if w.kind != "cascade" or not w.counts:
        return None
    escalated = sum(c[0] for c in w.counts)
    return sum(c[1] for c in w.counts) / escalated if escalated else None
