"""issue_ms: host milliseconds a plan call takes to return, with no
synchronise (argument checks, geometry lookup, the launch), the mean over
the window's dispatches.  Moves frames_per_s where the host paces the
card."""


def read(w):
    if not w.issue_s:
        return None
    return 1e3 * sum(w.issue_s) / len(w.issue_s)
