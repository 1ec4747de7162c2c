"""Cycle algorithms: the multiplicative V-cycle and the additive family
(counterpart of amg_tpu/solve/cycles.py).

  MULT          smooth -> residual -> restrict -> ... -> dense coarse solve
                -> prolong + correct -> adjoint smooth.
  MULTADD       every level k computes, from the same fine residual r,
                  c_k = P_0 ... P_{k-1} S~_k R_{k-1} ... R_0 r
                with S~_k one symmetrized sweep from zero (a plain sweep
                over the smoothed P~/R~ chains) and the coarsest level a
                direct solve; the corrections are summed.
  AFACX         level k smooths at level k+1, prolongs, re-residualises at
                level k and smooths there.
  AFACJ         level k smooths its own chained residual; hops farther than
                afacj_level from level k run through the ideal interpolant.
  BPX           one diagonal scaling per level between the chains.
  MULT_MULTADD  multiplicative above coarsest_mult_level, num_inner_cycles
                synchronous multadd cycles as the coarse solve below.

Every level's additive correction is an independent function of r, which
the asynchronous solvers (`solve/async_sim.py`) evaluate on stale reads.

With tracing on (`utils/tracing.py`) every cycle opens the spans of its
phases, per level k: `amg.smooth:k`, `amg.residual:k`, `amg.restrict:k`,
`amg.prolong:k` and `amg.coarse`; an additive correction runs inside
`amg.correction:k`, and its restriction and prolongation chains belong to
`restrict:k` / `prolong:k`.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass

import torch

from amg_tpu_torch.ops.vector import residual
from amg_tpu_torch.setup.hierarchy import Hierarchy
from amg_tpu_torch.smooth.smoothers import SmootherType, smooth, smooth_transpose
from amg_tpu_torch.utils import tracing
from amg_tpu_torch.utils.tracing import span


class CycleType(enum.Enum):
    MULT = "mult"
    MULTADD = "multadd"
    AFACX = "afacx"
    AFACJ = "afacj"
    BPX = "bpx"
    MULT_MULTADD = "mult_multadd"


@dataclass(frozen=True)
class CycleConfig:
    """Static cycle knobs, the reference's, with its defaults."""

    cycle: CycleType = CycleType.MULT
    smoother: SmootherType = SmootherType.L1_JACOBI
    num_pre_sweeps: int = 1
    num_post_sweeps: int = 1
    num_fine_sweeps: int = 2  # AFACx fine-level sweeps
    num_coarse_sweeps: int = 2  # AFACx / AFACj coarse-level sweeps
    num_add_sweeps: int = 1  # multadd per-level sweeps
    use_smoothed_transfers: bool = False  # multadd chains through P~/R~
    simple_add_smoother: bool = False  # multadd: no symmetrised sweep
    # MULT_MULTADD: multiplicative above this level, additive from it down
    coarsest_mult_level: int = 1
    num_inner_cycles: int = 2  # additive cycles per MULT_MULTADD coarse solve
    # AFACj: a chain hop at level lvl toward level k takes the ideal
    # interpolant when k - lvl > afacj_level
    afacj_level: int = 1


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
        with span("smooth", k):
            u = smooth(
                lv.A, lv.sm, cfg.smoother, xs[k], fs[k],
                num_sweeps=cfg.num_pre_sweeps, zero_guess=(k > 0),
            )
        xs[k] = u
        with span("residual", k):
            r = residual(lv.A, u, fs[k])
        with span("restrict", k):
            fs.append(lv.R @ r)
        del r  # no residual kept alive through the levels below
        # coarse initial guess is zero (the zero-guess sweep never reads it;
        # with no pre-sweeps the residual does)
        xs.append(torch.zeros_like(fs[-1]))
    with span("coarse"):
        xs[L - 1] = coarse_solve(hier, fs[L - 1])
    for k in reversed(range(L - 1)):
        lv = hier.levels[k]
        with span("prolong", k):
            u = xs[k] + lv.P @ xs[k + 1]
        with span("smooth", k):
            xs[k] = smooth_transpose(lv.A, lv.sm, cfg.smoother, u, fs[k],
                                     num_sweeps=cfg.num_post_sweeps)
    return xs[0]


def _chain_R(hier, cfg, lvl):
    lv = hier.levels[lvl]
    if cfg.use_smoothed_transfers and lv.R_s is not None:
        return lv.R_s
    return lv.R


def _chain_P(hier, cfg, lvl):
    lv = hier.levels[lvl]
    if cfg.use_smoothed_transfers and lv.P_s is not None:
        return lv.P_s
    return lv.P


def _restrict_chain(hier, cfg, r, k):
    """r_k = R_{k-1} ... R_0 r."""
    for lvl in range(k):
        r = _chain_R(hier, cfg, lvl) @ r
    return r


def _prolong_chain(hier, cfg, e, k):
    """c = P_0 ... P_{k-1} e."""
    for lvl in reversed(range(k)):
        e = _chain_P(hier, cfg, lvl) @ e
    return e


def _add_level_smooth(hier, cfg, k, rk):
    """The per-level additive smoother: num_add_sweeps sweeps from zero,
    symmetrised unless simple_add_smoother or the smoothed chains are on."""
    lv = hier.levels[k]
    if cfg.simple_add_smoother or cfg.use_smoothed_transfers:
        stype = {
            SmootherType.SYM_JACOBI: SmootherType.JACOBI,
            SmootherType.SYM_L1_JACOBI: SmootherType.L1_JACOBI,
        }.get(cfg.smoother, cfg.smoother)
    else:
        stype = {
            SmootherType.JACOBI: SmootherType.SYM_JACOBI,
            SmootherType.L1_JACOBI: SmootherType.SYM_L1_JACOBI,
        }.get(cfg.smoother, cfg.smoother)
    return smooth(lv.A, lv.sm, stype, torch.zeros_like(rk), rk,
                  num_sweeps=cfg.num_add_sweeps, zero_guess=True)


def _zero_guess_smooth(hier, cfg, k, rk, num_sweeps):
    lv = hier.levels[k]
    return smooth(lv.A, lv.sm, cfg.smoother, torch.zeros_like(rk), rk,
                  num_sweeps=num_sweeps, zero_guess=True)


def additive_correction(
    hier: Hierarchy, cfg: CycleConfig, r: torch.Tensor, k: int
) -> torch.Tensor:
    """Level k's additive correction c_k(r), prolonged to level 0: the work
    of one grid group, which the asynchronous solvers evaluate on stale
    reads."""
    with span("correction", k):
        L = hier.num_levels
        cyc = cfg.cycle
        if cyc == CycleType.AFACJ:
            if k == 0:
                with span("smooth", 0):
                    return _add_level_smooth(hier, cfg, 0, r)

            def hop(lvl, std, ideal):
                lv = hier.levels[lvl]
                ideal_m = getattr(lv, ideal)
                return ideal_m if k - lvl > cfg.afacj_level and ideal_m is not None \
                    else getattr(lv, std)

            rk = r
            with span("restrict", k):
                for lvl in range(k):
                    rk = hop(lvl, "R", "R_id") @ rk
            if k == L - 1:
                with span("coarse"):
                    e = coarse_solve(hier, rk)
            else:
                with span("smooth", k):
                    e = _zero_guess_smooth(hier, cfg, k, rk, cfg.num_coarse_sweeps)
            with span("prolong", k):
                for lvl in reversed(range(k)):
                    e = hop(lvl, "P", "P_id") @ e
            return e
        if cyc in (CycleType.MULTADD, CycleType.BPX) or k == L - 1:
            with span("restrict", k):
                rk = _restrict_chain(hier, cfg, r, k)
            if k == L - 1:
                with span("coarse"):
                    e = coarse_solve(hier, rk)
            elif cyc == CycleType.BPX:
                with span("smooth", k):
                    e = hier.levels[k].sm.inv_wscale * rk
            else:
                with span("smooth", k):
                    e = _add_level_smooth(hier, cfg, k, rk)
            with span("prolong", k):
                return _prolong_chain(hier, cfg, e, k)
        if cyc == CycleType.AFACX:
            # smooth at level k+1, prolong, re-residualise at level k, smooth
            lv = hier.levels[k]
            with span("restrict", k):
                rk = _restrict_chain(hier, cfg, r, k)
                rk1 = lv.R @ rk
            if k + 1 == L - 1:
                with span("coarse"):
                    u_coarse = coarse_solve(hier, rk1)
            else:
                with span("smooth", k + 1):
                    u_coarse = _zero_guess_smooth(hier, cfg, k + 1, rk1, cfg.num_coarse_sweeps)
            with span("prolong", k):
                e = lv.P @ u_coarse
            with span("residual", k):
                r_fine = residual(lv.A, e, rk)
            del e  # not kept alive through the fine smoothing and the chain
            with span("smooth", k):
                u_fine = _zero_guess_smooth(hier, cfg, k, r_fine, cfg.num_fine_sweeps)
            with span("prolong", k):
                return _prolong_chain(hier, cfg, u_fine, k)
        raise ValueError(f"additive_correction does not support cycle {cyc}")


def sync_additive_cycle(
    hier: Hierarchy, cfg: CycleConfig, x: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """One synchronous additive cycle: x += sum_k c_k(b - A x)."""
    with span("residual", 0):
        r = residual(hier.levels[0].A, x, b)
    c = torch.zeros_like(x)
    for k in range(hier.num_levels):
        c = c + additive_correction(hier, cfg, r, k)
    return x + c


def sub_hierarchy(hier: Hierarchy, start: int) -> Hierarchy:
    """The hierarchy rooted at level `start` (shares the levels and the
    coarsest dense inverse)."""
    return hier._replace(levels=hier.levels[start:])


def mult_multadd_vcycle(
    hier: Hierarchy, cfg: CycleConfig, x: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """A multiplicative V-cycle above coarsest_mult_level whose coarse solve
    is num_inner_cycles synchronous multadd cycles on the sub-hierarchy
    rooted there."""
    L = hier.num_levels
    cml = min(max(cfg.coarsest_mult_level, 0), L - 1)
    fs = [b]
    xs = [x]
    for k in range(cml):
        lv = hier.levels[k]
        with span("smooth", k):
            u = smooth(lv.A, lv.sm, cfg.smoother, xs[k], fs[k],
                       num_sweeps=cfg.num_pre_sweeps, zero_guess=(k > 0))
        xs[k] = u
        with span("residual", k):
            r = residual(lv.A, u, fs[k])
        with span("restrict", k):
            fs.append(lv.R @ r)
        del r  # no residual kept alive through the levels below
        xs.append(torch.zeros_like(fs[-1]))  # as in mult_vcycle
    sub = sub_hierarchy(hier, cml)
    inner_cfg = dataclasses.replace(cfg, cycle=CycleType.MULTADD)
    u = xs[cml]  # x at cml == 0, else zeros
    with tracing.levels_from(cml):
        for _ in range(max(cfg.num_inner_cycles, 1)):
            u = sync_additive_cycle(sub, inner_cfg, u, fs[cml])
    xs[cml] = u
    for k in reversed(range(cml)):
        lv = hier.levels[k]
        with span("prolong", k):
            u = xs[k] + lv.P @ xs[k + 1]
        with span("smooth", k):
            xs[k] = smooth_transpose(lv.A, lv.sm, cfg.smoother, u, fs[k],
                                     num_sweeps=cfg.num_post_sweeps)
    return xs[0]


def cycle_step(hier: Hierarchy, cfg: CycleConfig, x: torch.Tensor, b: torch.Tensor):
    """Dispatch one cycle of the configured type."""
    if cfg.cycle == CycleType.MULT:
        return mult_vcycle(hier, cfg, x, b)
    if cfg.cycle == CycleType.MULT_MULTADD:
        return mult_multadd_vcycle(hier, cfg, x, b)
    return sync_additive_cycle(hier, cfg, x, b)
