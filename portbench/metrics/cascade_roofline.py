"""cascade_roofline: the cascade entry's calls against the roofline, in %
(see ``_roofline``).  Moves frames_per_s."""

from portbench.metrics import _roofline


def read(w):
    return _roofline.share(w, "cascade")
