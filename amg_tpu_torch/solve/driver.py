"""Solve driver: tolerance loop, residual history, outer acceleration
(counterpart of amg_tpu/solve/driver.py).

Cycles run until the relative residual 2-norm meets tol, max_cycles is hit,
or the residual has grown 1e3x (the divergence guard), recording the
NaN-padded per-cycle history. The reference runs the loop as one jitted
lax.while_loop; here it is a host loop that reads one device scalar per
cycle (the stop test), as `struct_solve` does.

With tracing on (`utils/tracing.py`) a solve runs inside `amg.solve`, each
cycle with its acceleration and its residual norm inside `amg.cycle` (PCG
opens its own spans, `solve/krylov.py`), and the stop test's read inside
`amg.host_read`; `cheby_setup` is the set-up phase `amg.setup.cheby`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from amg_tpu_torch.dtypes import resolve_device
from amg_tpu_torch.ops.vector import residual
from amg_tpu_torch.solve.accel import (
    ChebyCoeffs,
    _reducers,
    cheby_init,
    cheby_update,
    estimate_cycle_eigs,
    estimate_eigs_lanczos,
    estimate_eigs_lobpcg,
)
from amg_tpu_torch.solve.cycles import CycleConfig, cycle_step
from amg_tpu_torch.solve.krylov import pcg
from amg_tpu_torch.utils import tracing
from amg_tpu_torch.utils.tracing import span, traced


class SolveResult(NamedTuple):
    x: torch.Tensor
    iters: int
    rel_resnorm: torch.Tensor
    history: torch.Tensor  # relative residual per cycle, NaN-padded

    def num_iters(self) -> int:
        return int(self.iters)

    def history_list(self):
        h = self.history.detach().cpu().numpy()
        return h[~np.isnan(h)].tolist()


def nan_padded(values, length: int, dtype, device) -> torch.Tensor:
    """A (length,) history on `device` holding `values` (host floats, one
    host read each), NaN after them."""
    h = torch.full((length,), float("nan"), dtype=torch.float64)
    h[: len(values)] = torch.tensor(values, dtype=torch.float64)
    return h.to(device=device, dtype=dtype)


def _check_device(hier, device) -> torch.device:
    device = resolve_device(device)
    if hier.device != device:
        raise ValueError(f"hierarchy lives on {hier.device}, solve asked for {device}")
    return device


def _accelerated(hier, cfg, x, b, accel, coeffs, ch):
    """One cycle, and with accel the Chebyshev/Richardson update of the
    cycle's raw correction: (x_new, ch)."""
    x_new = cycle_step(hier, cfg, x, b)
    if accel in ("cheby", "richardson"):
        ch = cheby_update(ch, x_new - x, coeffs, richardson=(accel == "richardson"))
        x_new = x + ch.d
    return x_new, ch


@traced("solve")
def solve(
    hier,
    cfg: CycleConfig,
    b,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-8,
    max_cycles: int = 200,
    accel: Optional[str] = None,  # None | "cheby" | "richardson"
    cheby_coeffs: Optional[ChebyCoeffs] = None,
    outer: Optional[str] = None,  # None | "pcg"
    no_resnorm: bool = False,  # exactly max_cycles cycles, no per-cycle norm
    device=None,
) -> SolveResult:
    """Solve A x = b with the configured cycle, optionally accelerated or
    wrapped in PCG, on `device` (None: the CUDA device; raises without one;
    the hierarchy must live there)."""
    device = _check_device(hier, device)
    b = torch.as_tensor(b).to(device=device, dtype=hier.dtype)
    x0 = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).to(b)
    if accel in ("cheby", "richardson") and cheby_coeffs is None:
        raise ValueError("accelerated solve needs cheby_coeffs (see cheby_setup)")
    A0 = hier.levels[0].A
    # a row-sharded hierarchy's vectors are this process's rows: its mesh
    # reduces over all of them
    dot, norm = _reducers(hier.mesh)
    if outer == "pcg":
        res = pcg(
            lambda v: A0 @ v,
            lambda r: cycle_step(hier, cfg, torch.zeros_like(r), r),
            b, x0, tol=tol, max_iters=max_cycles, dot=dot, norm=norm,
        )
        return SolveResult(x=res.x, iters=res.iters, rel_resnorm=res.rel_resnorm,
                           history=res.history)
    if outer is not None:
        raise ValueError(f"unknown outer solver {outer!r}")
    r0norm = norm(residual(A0, x0, b))
    safe_r0 = torch.where(r0norm == 0.0, torch.ones_like(r0norm), r0norm)
    hist = torch.full((max_cycles + 1,), float("nan"), dtype=b.dtype, device=device)
    hist[0] = 1.0
    ch = cheby_init(b.shape[0], b.dtype, device)
    x = x0
    if no_resnorm:
        for _ in range(max_cycles):
            with span("cycle"):
                x, ch = _accelerated(hier, cfg, x, b, accel, cheby_coeffs, ch)
        relnorm = norm(residual(A0, x, b)) / safe_r0
        hist[max_cycles] = relnorm
        return SolveResult(x=x, iters=max_cycles, rel_resnorm=relnorm, history=hist)
    it = 0
    relnorm = torch.ones((), dtype=b.dtype, device=device)
    rel = 1.0
    while it < max_cycles and rel > tol and rel < 1e3:
        with span("cycle"):
            x, ch = _accelerated(hier, cfg, x, b, accel, cheby_coeffs, ch)
            relnorm = norm(residual(A0, x, b)) / safe_r0
            hist[it + 1] = relnorm
        it += 1
        rel = tracing.host_read(relnorm)
    return SolveResult(x=x, iters=it, rel_resnorm=relnorm, history=hist)


def cheby_setup(
    hier, cfg: CycleConfig, num_iters: int = 20, seed: int = 0,
    method: str = "power", device=None,
) -> ChebyCoeffs:
    """Eigenvalue bounds of the cycle-preconditioned operator, on `device`
    (None: the CUDA device; the hierarchy must live there).

    method: "power" (power + shifted power), "lobpcg" (block LOBPCG
    Rayleigh-Ritz) or "lanczos" (extreme Ritz values). On a row-sharded
    hierarchy the estimators reduce over its mesh."""
    device = _check_device(hier, device)
    A0 = hier.levels[0].A
    n = A0.shape[0]  # the global row count
    dtype = hier.levels[0].sm.inv_wscale.dtype

    def apply_MinvA(u):
        f = A0 @ u
        return cycle_step(hier, cfg, torch.zeros_like(f), f)

    kw = {"seed": seed, "device": device, "mesh": hier.mesh}
    with tracing.setup_span("cheby", sync=device):
        if method == "lobpcg":
            return estimate_eigs_lobpcg(apply_MinvA, n, dtype,
                                        num_iters=max(num_iters // 2, 6), **kw)
        if method == "lanczos":
            return estimate_eigs_lanczos(apply_MinvA, n, dtype, num_iters=num_iters, **kw)
        if method != "power":
            raise ValueError(f"unknown cheby_eig method {method!r}")
        return estimate_cycle_eigs(apply_MinvA, n, dtype, num_iters=num_iters, **kw)
