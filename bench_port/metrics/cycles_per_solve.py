"""cycles_per_solve: the solver's own count (cycles, async steps or PCG
iterations, the result's `iters`) summed over the window's solves, over the
solves."""


def read(run):
    if not run.solves:
        return None
    return sum(s.iters for s in run.solves) / len(run.solves)
