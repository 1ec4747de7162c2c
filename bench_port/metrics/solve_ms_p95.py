"""solve_ms_p95: the 95th percentile (linear between order statistics) of
the host-clock time of every solve in the window, failed ones included."""

import numpy as np


def read(run):
    if not run.solves:
        return None
    return float(np.percentile([s.seconds for s in run.solves], 95)) * 1e3
