"""solves_per_s: the solves of the window that met the tolerance, over the
window's host-clock seconds (from its start to the end of its last solve)."""


def read(run):
    if run.window_s <= 0.0:
        return None
    return sum(s.ok for s in run.solves) / run.window_s
