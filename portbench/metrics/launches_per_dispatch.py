"""launches_per_dispatch: the program's own launch counter
(``kernels.ops.launch_counts``) over the window, a dispatch."""


def read(w):
    if not w.dispatches or not w.launches:
        return None
    return sum(w.launches.values()) / w.dispatches
