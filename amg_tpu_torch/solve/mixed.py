"""Mixed precision on native float64 (counterpart of amg_tpu/solve/mixed.py:
`mixed_solve` with its float64 refinement loop `_loop_f64`, and `mixed_pcg`
as its unfused host loop).

`mixed_solve` is iterative refinement with one cycle of a (float32)
hierarchy per step, against a float64 fine operator:

    x (f64); repeat:  r = b - A x  (f64);  x += V_32(r)  (zero guess)

The reference takes this loop on the CPU and a double-single one on the
TPU; the H100 has native float64, so the float64 loop is the only route.

`mixed_pcg`:

The reference keeps the Krylov state and the operator in double-single
(pairs of float32) because the TPU has no float64. The H100 has native
float64, so here the state x, r, p is float64 and the operator is the
float64 fine operator (a `DiaKernelOperator` on the elasticity path, kernel
K5); only the preconditioner, one cycle on the (float32) hierarchy, runs in
the hierarchy's dtype:

    x (f64); repeat:
        r = b - A x                       (f64 residual, one K5 launch)
        e = pcg(A, M = V-cycle(r), r)     to inner_tol, at most inner_iters
        x += e

with the reference's restart loop, its stagnation break (a restart that
does not cut the residual below 0.9 of the one before) and its stitched
history.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from amg_tpu_torch.dtypes import resolve_device
from amg_tpu_torch.ops.vector import residual
from amg_tpu_torch.solve.cycles import CycleConfig, cycle_step
from amg_tpu_torch.solve.krylov import pcg


class MixedSolveResult(NamedTuple):
    x: torch.Tensor  # float64
    iters: int  # refinement cycles (mixed_solve); inner PCG iterations (mixed_pcg)
    rel_resnorm: float
    history: torch.Tensor  # (max_cycles + 1,), NaN-padded

    def num_iters(self) -> int:
        return int(self.iters)

    def history_list(self):
        h = self.history.numpy()
        return h[~np.isnan(h)].tolist()


def mixed_solve(
    hier,
    A64,
    cfg: CycleConfig,
    b,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-8,
    max_cycles: int = 200,
    device=None,
) -> MixedSolveResult:
    """Solve A x = b to `tol` (relative residual of the float64 fine operator
    A64) with one `cycle_step` on `hier` (its dtype, typically float32) from
    a zero guess per refinement step, on `device` (None: the CUDA device;
    raises without one). One host read per cycle (the stop test)."""
    device = resolve_device(device)
    if hier.device != device:
        raise ValueError(f"hierarchy lives on {hier.device}, solve asked for {device}")
    f64 = torch.float64
    b = torch.as_tensor(b).to(device=device, dtype=f64)
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).to(b)
    r = residual(A64, x, b)
    r0n = float(torch.linalg.norm(r))
    safe_r0 = r0n if r0n > 0.0 else 1.0
    hist = [1.0]
    rel = math.inf
    while len(hist) <= max_cycles and rel > tol:
        # the residual is rounded to float32 whatever the hierarchy's dtype,
        # as the reference rounds it
        r32 = r.to(torch.float32).to(hier.dtype)
        x = x + cycle_step(hier, cfg, torch.zeros_like(r32), r32).to(f64)
        r = residual(A64, x, b)
        rel = float(torch.linalg.norm(r)) / safe_r0
        hist.append(rel)
    h = np.full(max_cycles + 1, np.nan)
    h[: len(hist)] = hist
    return MixedSolveResult(x=x, iters=len(hist) - 1, rel_resnorm=rel,
                            history=torch.from_numpy(h))


def mixed_pcg(
    hier,
    A_acc,
    cfg: CycleConfig,
    b,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-5,
    max_cycles: int = 120,
    inner_tol: float = 2.5e-2,
    inner_iters: Optional[int] = None,
    device=None,
) -> MixedSolveResult:
    """Solve A x = b to `tol` (relative residual of the float64 operator
    A_acc) with PCG preconditioned by one `cycle_step` on `hier`, on
    `device` (None: the CUDA device; raises without one)."""
    device = resolve_device(device)
    if hier.device != device:
        raise ValueError(f"hierarchy lives on {hier.device}, solve asked for {device}")
    f64 = torch.float64
    b = torch.as_tensor(b).to(device=device, dtype=f64)
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).to(b)
    if inner_iters is None:
        inner_iters = max(8, min(40, max_cycles // 3))

    def precond(r):
        rr = r.to(hier.dtype)
        return cycle_step(hier, cfg, torch.zeros_like(rr), rr).to(f64)

    def zero(r):
        return torch.zeros_like(r)

    r = residual(A_acc, x, b)
    r0n = float(torch.linalg.norm(r))
    safe_r0 = r0n if r0n > 0.0 else 1.0
    rel = r0n / safe_r0
    hist = [1.0]
    total = 0
    while rel > tol and total < max_cycles:
        res = pcg(A_acc.matvec, precond, r, zero(r), tol=inner_tol, max_iters=inner_iters)
        x = x + res.x
        total += int(res.iters)
        # inner history relative to its own r0 (the outer residual): rescale
        # by the outer rel and drop its leading 1.0 and its last point, which
        # the measured outer rel replaces
        inner_h = res.history.cpu().numpy()
        inner_h = inner_h[~np.isnan(inner_h)][1:]
        prev_rel = rel
        r = residual(A_acc, x, b)
        rel = float(torch.linalg.norm(r)) / safe_r0
        if inner_h.size:
            hist.extend(float(v) * prev_rel for v in inner_h[:-1])
        hist.append(rel)
        if rel > 0.9 * prev_rel:
            break  # refinement stagnated
    h = np.full(max_cycles + 1, np.nan)
    h[: min(len(hist), max_cycles + 1)] = hist[: max_cycles + 1]
    return MixedSolveResult(x=x, iters=total, rel_resnorm=rel, history=torch.from_numpy(h))
