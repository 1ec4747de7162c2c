"""The comparison that decides `correct`, in plain NumPy/SciPy.

It reads only the benchmark's own inputs (the matrix from the frozen
generator, the right-hand sides and probe vectors the benchmark drew) and
the program's outputs that it judges: the final iterates x of the sampled
solves of the window, and the program's level-0 operator applied to a probe
vector. Each number is held to its limit from `limits/<cell>.json`.
"""

from __future__ import annotations

import math

import numpy as np

# the numbers compared, in the order they are printed
NUMBERS = ("true_rel_res_max", "a0_rel_err")


def true_rel_residual(A, x: np.ndarray, b: np.ndarray) -> float:
    """||b - A x||_2 / ||b||_2 in float64."""
    x = np.asarray(x, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


def operator_rel_err(A, v: np.ndarray, y: np.ndarray) -> float:
    """||y - A v||_2 / ||A v||_2 in float64: how far the program's y = A0 v
    lies from the matrix's product."""
    want = A @ np.asarray(v, dtype=np.float64)
    return float(np.linalg.norm(np.asarray(y, dtype=np.float64) - want) / np.linalg.norm(want))


def readings(A, solves, probe) -> dict:
    """The numbers of one run: `solves` a list of (b, x) host arrays, `probe`
    (v, y) with y the program's A0 v. A NaN or infinite output reads inf."""
    res = [true_rel_residual(A, x, b) for b, x in solves]
    res = [r if math.isfinite(r) else math.inf for r in res]
    err = operator_rel_err(A, *probe)
    return {"true_rel_res_max": max(res) if res else math.inf,
            "a0_rel_err": err if math.isfinite(err) else math.inf}


def judge(numbers: dict, limits: dict) -> bool:
    """True when every number is at most its limit (a missing one fails)."""
    return all(name in numbers and numbers[name] <= limits[name] for name in NUMBERS)
