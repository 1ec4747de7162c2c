"""Per-phase instrumentation: smooth / residual / restrict / prolong / coarse
(counterpart of amg_tpu/utils/phases.py).

The instrumented mode re-executes the cycle segmented: each phase of each
level is its own closure, timed on the host clock with the device
synchronised after it (on the card: `torch.cuda.synchronize()`), after one
warm-up call of every closure (a first call may build a kernel). The
segmented cycle computes the production cycle's arithmetic, operator by
operator (asserted in the tests); only the synchronisation differs. One
device exchanges no messages, so `comm_bytes` / `comm_msgs` stay 0; the
halo accounting of the reference waits for the multi-device modules
(ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from amg_tpu_torch.ops.vector import residual
from amg_tpu_torch.smooth.smoothers import smooth, smooth_transpose
from amg_tpu_torch.solve.cycles import (
    CycleConfig,
    CycleType,
    _add_level_smooth,
    _prolong_chain,
    _restrict_chain,
    coarse_solve,
)


@dataclass
class PhaseReport:
    """Per-phase wall times (s) and counts, per level (the reference's
    smooth/residual/restrict/prolong/coarse times and message counts)."""

    num_levels: int = 0
    cycles: int = 0
    smooth: list = field(default_factory=list)  # (L,) seconds
    residual: list = field(default_factory=list)
    restrict: list = field(default_factory=list)
    prolong: list = field(default_factory=list)
    coarse: float = 0.0
    vecop: float = 0.0
    comm_bytes: list = field(default_factory=list)  # (L,) per cycle
    comm_msgs: list = field(default_factory=list)

    def totals(self) -> dict:
        return {
            "smooth_wtime": float(np.sum(self.smooth)),
            "residual_wtime": float(np.sum(self.residual)),
            "restrict_wtime": float(np.sum(self.restrict)),
            "prolong_wtime": float(np.sum(self.prolong)),
            "coarse_wtime": float(self.coarse),
            "vecop_wtime": float(self.vecop),
            "comm_bytes_per_cycle": int(np.sum(self.comm_bytes)),
            "comm_msgs_per_cycle": int(np.sum(self.comm_msgs)),
        }

    def print_table(self) -> None:
        t = self.totals()
        print(
            f"per-phase wtime over {self.cycles} instrumented cycles "
            f"(s, summed over levels):"
        )
        for k in ("smooth_wtime", "residual_wtime", "restrict_wtime",
                  "prolong_wtime", "coarse_wtime", "vecop_wtime"):
            print(f"  {k:16s}: {t[k]:.6f}")
        print(
            f"  comm/cycle      : {t['comm_msgs_per_cycle']} msgs, "
            f"{t['comm_bytes_per_cycle']} bytes"
        )
        print("  per-level (smooth/residual/restrict/prolong s):")
        for k in range(self.num_levels):
            rs = self.restrict[k] if k < len(self.restrict) else 0.0
            pr = self.prolong[k] if k < len(self.prolong) else 0.0
            print(
                f"    level {k}: {self.smooth[k]:.6f} / "
                f"{self.residual[k]:.6f} / {rs:.6f} / {pr:.6f}"
            )


def _timed(fn, *args):
    """fn(*args), with the device synchronised after it."""
    out = fn(*args)
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
    return out


def _report(L, num_cycles) -> PhaseReport:
    return PhaseReport(
        num_levels=L, cycles=num_cycles,
        smooth=[0.0] * L, residual=[0.0] * L,
        restrict=[0.0] * L, prolong=[0.0] * L,
        comm_bytes=[0] * L, comm_msgs=[0] * L,
    )


def profile_mult_cycle(
    hier, cfg: CycleConfig, b, x0=None, num_cycles: int = 5
) -> PhaseReport:
    """Segmented multiplicative V-cycle with per-phase timers: the iteration
    of solve.cycles.mult_vcycle."""
    L = hier.num_levels
    if x0 is None:
        x0 = torch.zeros_like(b)
    rep = _report(L, num_cycles)

    pre, post = [], []
    resid, restr, prol = [], [], []
    for k in range(L - 1):
        lv = hier.levels[k]
        pre.append(
            lambda u, f, lv=lv, k=k: smooth(
                lv.A, lv.sm, cfg.smoother, u, f,
                num_sweeps=cfg.num_pre_sweeps, zero_guess=(k > 0),
            )
        )
        post.append(
            lambda u, f, lv=lv: smooth_transpose(
                lv.A, lv.sm, cfg.smoother, u, f,
                num_sweeps=cfg.num_post_sweeps,
            )
        )
        resid.append(lambda u, f, lv=lv: residual(lv.A, u, f))
        restr.append(lambda r, lv=lv: lv.R @ r)
        prol.append(lambda u, e, lv=lv: u + lv.P @ e)

    def coarse(r):
        return coarse_solve(hier, r)

    # warm-up: every closure once
    for k in range(L - 1):
        z = torch.zeros(hier.levels[k].A.shape[1], dtype=b.dtype, device=b.device)
        zc = torch.zeros(hier.levels[k + 1].A.shape[0], dtype=b.dtype, device=b.device)
        _timed(pre[k], z, z); _timed(post[k], z, z)
        _timed(resid[k], z, z); _timed(restr[k], z); _timed(prol[k], z, zc)
    _timed(coarse, torch.zeros(hier.levels[L - 1].A.shape[1], dtype=b.dtype,
                               device=b.device))

    x = x0
    for _ in range(num_cycles):
        fs = [b]
        xs = [x]
        for k in range(L - 1):
            t0 = time.perf_counter()
            u = _timed(pre[k], xs[k], fs[k])
            rep.smooth[k] += time.perf_counter() - t0
            xs[k] = u
            t0 = time.perf_counter()
            r = _timed(resid[k], u, fs[k])
            rep.residual[k] += time.perf_counter() - t0
            t0 = time.perf_counter()
            fs.append(_timed(restr[k], r))
            rep.restrict[k] += time.perf_counter() - t0
            # as in mult_vcycle: the coarse guess is zero
            xs.append(torch.zeros_like(fs[-1]))
        t0 = time.perf_counter()
        xs[L - 1] = _timed(coarse, fs[L - 1])
        rep.coarse += time.perf_counter() - t0
        for k in reversed(range(L - 1)):
            t0 = time.perf_counter()
            u = _timed(prol[k], xs[k], xs[k + 1])
            rep.prolong[k] += time.perf_counter() - t0
            t0 = time.perf_counter()
            xs[k] = _timed(post[k], u, fs[k])
            rep.smooth[k] += time.perf_counter() - t0
        x = xs[0]
    rep._x = x  # for equivalence tests
    return rep


def _additive_level_plan(hier, cfg, k):
    """Segmented step plan of level k's additive correction: the per-operator
    decomposition of solve.cycles.additive_correction (the same branches and
    operators). Each step is (phase, attribution_level, fn, in_keys,
    out_key); the last step writes key 'c' (the level-0 correction)."""
    L = hier.num_levels
    cyc = cfg.cycle

    def zero_guess(lvl, sweeps):
        lv = hier.levels[lvl]
        return lambda rk: smooth(lv.A, lv.sm, cfg.smoother, torch.zeros_like(rk), rk,
                                 num_sweeps=sweeps, zero_guess=True)

    if cyc == CycleType.AFACJ and k == 0:
        return [("smooth", 0, lambda r: _add_level_smooth(hier, cfg, 0, r), ("r",), "c")]
    if cyc == CycleType.AFACJ:
        # hop-conditional ideal-interpolant chains (-afacj_level)
        def _ideal_hop(lvl, name):
            return k - lvl > cfg.afacj_level and getattr(hier.levels[lvl], name) is not None

        def _rchain(r):
            rk = r
            for lvl in range(k):
                lv = hier.levels[lvl]
                rk = (lv.R_id if _ideal_hop(lvl, "R_id") else lv.R) @ rk
            return rk

        def _pchain(e):
            c = e
            for lvl in reversed(range(k)):
                lv = hier.levels[lvl]
                c = (lv.P_id if _ideal_hop(lvl, "P_id") else lv.P) @ c
            return c

        steps = [("restrict", k, _rchain, ("r",), "rk")]
        if k == L - 1:
            steps.append(("coarse", k, lambda rk: coarse_solve(hier, rk), ("rk",), "e"))
        else:
            steps.append(("smooth", k, zero_guess(k, cfg.num_coarse_sweeps), ("rk",), "e"))
        steps.append(("prolong", k, _pchain, ("e",), "c"))
        return steps
    if cyc in (CycleType.MULTADD, CycleType.BPX) or k == L - 1:
        steps = [("restrict", k, lambda r: _restrict_chain(hier, cfg, r, k), ("r",), "rk")]
        if k == L - 1:
            steps.append(("coarse", k, lambda rk: coarse_solve(hier, rk), ("rk",), "e"))
        elif cyc == CycleType.BPX:
            steps.append(("smooth", k, lambda rk: hier.levels[k].sm.inv_wscale * rk,
                          ("rk",), "e"))
        else:
            steps.append(("smooth", k, lambda rk: _add_level_smooth(hier, cfg, k, rk),
                          ("rk",), "e"))
        steps.append(("prolong", k, lambda e: _prolong_chain(hier, cfg, e, k), ("e",), "c"))
        return steps
    # AFACX, k < L-1: coarse smooth at k+1, prolong, re-residualise at k,
    # fine smooth, prolong chain
    lv = hier.levels[k]
    steps = [
        ("restrict", k, lambda r: _restrict_chain(hier, cfg, r, k), ("r",), "rk"),
        ("restrict", k, lambda rk: lv.R @ rk, ("rk",), "rk1"),
    ]
    if k + 1 == L - 1:
        steps.append(("coarse", k + 1, lambda rk1: coarse_solve(hier, rk1), ("rk1",), "uc"))
    else:
        steps.append(("smooth", k + 1, zero_guess(k + 1, cfg.num_coarse_sweeps),
                      ("rk1",), "uc"))
    steps += [
        ("prolong", k, lambda uc: lv.P @ uc, ("uc",), "e"),
        ("residual", k, lambda rk, e: residual(lv.A, e, rk), ("rk", "e"), "rf"),
        ("smooth", k, zero_guess(k, cfg.num_fine_sweeps), ("rf",), "uf"),
        ("prolong", k, lambda uf: _prolong_chain(hier, cfg, uf, k), ("uf",), "c"),
    ]
    return steps


def profile_additive_cycle(
    hier, cfg: CycleConfig, b, x0=None, num_cycles: int = 5
) -> PhaseReport:
    """Segmented additive cycle (multadd / afacx / afacj / bpx): every
    operator of additive_correction timed on its own, in the reference's
    phase taxonomy (restrict / smooth / residual / prolong / coarse)."""
    L = hier.num_levels
    if x0 is None:
        x0 = torch.zeros_like(b)
    rep = _report(L, num_cycles)
    A0 = hier.levels[0].A

    def resid0(u, f):
        return residual(A0, u, f)

    plans = [_additive_level_plan(hier, cfg, k) for k in range(L)]

    # warm-up: every step once, on zeros of its input's shape
    _timed(resid0, x0, b)
    for k in range(L):
        env = {"r": torch.zeros_like(b)}
        for _phase, _lvl, fn, in_keys, out_key in plans[k]:
            env[out_key] = _timed(fn, *(torch.zeros_like(env[ik]) for ik in in_keys))

    x = x0
    for _ in range(num_cycles):
        t0 = time.perf_counter()
        r = _timed(resid0, x, b)
        rep.residual[0] += time.perf_counter() - t0
        c = torch.zeros_like(x)
        for k in range(L):
            env = {"r": r}
            for phase, lvl, fn, in_keys, out_key in plans[k]:
                t0 = time.perf_counter()
                env[out_key] = _timed(fn, *(env[ik] for ik in in_keys))
                dt = time.perf_counter() - t0
                if phase == "coarse":
                    rep.coarse += dt
                else:
                    getattr(rep, phase)[lvl] += dt
            c = c + env["c"]
        x = x + c
    rep._x = x
    return rep


def profile_phases(
    hier, cfg: CycleConfig, b, x0=None, num_cycles: int = 5
) -> PhaseReport:
    if cfg.cycle == CycleType.MULT:
        return profile_mult_cycle(hier, cfg, b, x0, num_cycles)
    return profile_additive_cycle(hier, cfg, b, x0, num_cycles)
