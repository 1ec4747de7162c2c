"""Entry `async_solve`: `amg_tpu_torch.solve.async_sim.async_solve`, the
asynchronous additive solver, on the generic hierarchy.

The traffic's solver block gives the additive cycle and the async knobs;
the acceleration's AsyncConfig keywords are the runner's
(`utils.runner.async_accel_options`) from `cheby_setup`'s bounds of the
synchronous cycle, computed once in set-up. Each solve draws from the
port's own generators (`GeneratorDraws`) seeded with `draw_seed`.
"""

from __future__ import annotations

from typing import Any, NamedTuple

from amg_tpu_torch.solve.async_sim import AsyncConfig, async_solve
from amg_tpu_torch.solve.driver import cheby_setup
from amg_tpu_torch.utils.runner import async_accel_options
from bench_port import program


class State(NamedTuple):
    hh: Any
    hier: Any
    cfg: Any
    acfg: Any
    solver: dict
    tol: float
    device: Any


def setup(inputs, config, traffic, device, dtype) -> State:
    s = traffic["solver"]
    g = program.build_generic(inputs, config, device, dtype)
    cfg = program.cycle_config(s)
    kw = {"async_type": s["async_type"], "sim_read_delay": s["sim_read_delay"]}
    if s.get("accel") in ("cheby", "richardson"):
        coeffs = cheby_setup(g.hier, cfg, num_iters=s["cheby_power_iters"], device=device)
        kw.update(async_accel_options(coeffs, s["accel"], s["async_type"],
                                      s["sim_read_delay"]))
    return State(g.hh, g.hier, cfg, AsyncConfig(**kw), s, traffic["tol"], device)


def solve(state: State, b, draw_seed: int):
    """(x, steps, the solver's relative residual) of one right-hand side."""
    res = async_solve(state.hier, state.cfg, state.acfg, b, seed=draw_seed, tol=state.tol,
                      max_cycles=state.solver["max_cycles"], device=state.device)
    return res.x, int(res.iters), float(res.rel_resnorm)
