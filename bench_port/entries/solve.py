"""Entry `solve`: `amg_tpu_torch.solve.driver.solve` on the generic hierarchy.

The traffic's solver block gives the cycle, the acceleration ("cheby" |
"richardson" | none), the outer Krylov solver ("pcg" | none) and
max_cycles. The Chebyshev bounds depend only on the operator, so set-up
computes them once (`cheby_setup`, cheby_power_iters power iterations).
"""

from __future__ import annotations

from typing import Any, NamedTuple

from amg_tpu_torch.solve.driver import cheby_setup, solve as driver_solve
from bench_port import program


class State(NamedTuple):
    hh: Any
    hier: Any
    cfg: Any
    coeffs: Any
    solver: dict
    tol: float
    device: Any


def setup(inputs, config, traffic, device, dtype) -> State:
    s = traffic["solver"]
    g = program.build_generic(inputs, config, device, dtype)
    cfg = program.cycle_config(s)
    coeffs = None
    if s.get("accel") in ("cheby", "richardson"):
        coeffs = cheby_setup(g.hier, cfg, num_iters=s["cheby_power_iters"], device=device)
    return State(g.hh, g.hier, cfg, coeffs, s, traffic["tol"], device)


def solve(state: State, b, draw_seed: int):
    """(x, cycles, the solver's relative residual) of one right-hand side;
    draw_seed is unused: this entry draws nothing."""
    s = state.solver
    res = driver_solve(state.hier, state.cfg, b, tol=state.tol, max_cycles=s["max_cycles"],
                       accel=s.get("accel"), cheby_coeffs=state.coeffs, outer=s.get("outer"),
                       device=state.device)
    return res.x, int(res.iters), float(res.rel_resnorm)
