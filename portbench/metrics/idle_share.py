"""idle_share: the share of the traced window in which no kernel or copy
ran on the card, from the ``torch.profiler`` timeline, in %."""


def read(w):
    if not w.profile or not w.profile["window_s"]:
        return None
    p = w.profile
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
