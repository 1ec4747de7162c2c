"""Multiplicative V-cycle (counterpart of amg_tpu/solve/cycles.py).

The port has the MULT cycle: smooth -> residual -> restrict -> ... ->
dense coarse solve -> prolong + correct -> adjoint smooth, and `cycle_step`
for it. The additive family (MULTADD, AFACx, AFACj, BPX, MULT_MULTADD)
comes with `solve/async_sim.py`; `cycle_step` raises NotImplementedError
for it.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from amg_tpu_torch.ops.vector import residual
from amg_tpu_torch.setup.hierarchy import Hierarchy
from amg_tpu_torch.smooth.smoothers import SmootherType, smooth, smooth_transpose


class CycleType(enum.Enum):
    MULT = "mult"
    MULTADD = "multadd"
    AFACX = "afacx"
    AFACJ = "afacj"
    BPX = "bpx"
    MULT_MULTADD = "mult_multadd"


@dataclass(frozen=True)
class CycleConfig:
    """Static cycle knobs (the MULT subset of the reference's CycleConfig;
    the additive cycles' knobs come with those cycles)."""

    cycle: CycleType = CycleType.MULT
    smoother: SmootherType = SmootherType.L1_JACOBI
    num_pre_sweeps: int = 1
    num_post_sweeps: int = 1


def coarse_solve(hier: Hierarchy, r: torch.Tensor) -> torch.Tensor:
    """Dense inverse applied by one matmul."""
    return hier.coarse_Ainv @ r


def mult_vcycle(
    hier: Hierarchy, cfg: CycleConfig, x: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """One multiplicative V(pre, post) cycle; the post-sweeps are the
    adjoint of the pre-sweeps (`smooth_transpose`), which keeps the cycle
    symmetric under the hybrid JGS smoothers."""
    L = hier.num_levels
    fs = [b]
    xs = [x]
    for k in range(L - 1):
        lv = hier.levels[k]
        u = smooth(
            lv.A, lv.sm, cfg.smoother, xs[k], fs[k],
            num_sweeps=cfg.num_pre_sweeps, zero_guess=(k > 0),
        )
        xs[k] = u
        fs.append(lv.R @ residual(lv.A, u, fs[k]))
        # coarse initial guess is zero (the zero-guess sweep never reads it;
        # with no pre-sweeps the residual does)
        xs.append(torch.zeros_like(fs[-1]))
    xs[L - 1] = coarse_solve(hier, fs[L - 1])
    for k in reversed(range(L - 1)):
        lv = hier.levels[k]
        u = xs[k] + lv.P @ xs[k + 1]
        xs[k] = smooth_transpose(lv.A, lv.sm, cfg.smoother, u, fs[k],
                                 num_sweeps=cfg.num_post_sweeps)
    return xs[0]


def cycle_step(hier: Hierarchy, cfg: CycleConfig, x: torch.Tensor, b: torch.Tensor):
    """Dispatch one cycle of the configured type."""
    if cfg.cycle == CycleType.MULT:
        return mult_vcycle(hier, cfg, x, b)
    raise NotImplementedError(
        f"cycle {cfg.cycle.value} comes with the additive half of the generic-AMG slice "
        "(ROADMAP queue 1, with solve/async_sim.py); the port has MULT"
    )
