"""Fused structured V-cycle on the padded state (counterpart of
amg_tpu/solve/struct_cycle.py).

The fine level's state stays in the padded layout of `ops.stencil`; its
sweeps, residuals and the convergence norm run through K1 (runs of 2-4 sweeps
of the uniform 27-point box through K2 on the CPU), its transfers through the fused
K3/K4 pair, and constant-stencil coarse levels of a V(1,1) cycle run their
whole visit as one zero-guess K3 and one zero-guess K4 launch. Levels below
the constant ones (VarStencil, dense coarsest) run the plain `mult_vcycle`.
Semantics are those of `mult_vcycle` on the same hierarchy.

Routing keeps only the structural conditions of the reference: standard
(s+1)//2 coarsening, reach-1 taps, a constant-stencil level with a
StructuredRestrict, one minimum-side gate for the level-0 fused transfers
(`_FUSE_MIN_SIDE`) and the choice of K2 for runs of box sweeps (`_k2_pays`:
not on the card, where chained K1 launches are faster). At 126^3 V(1,1)
that is: level 0 through non-zero-guess K3/K4, 63^3 and 32^3 through
zero-guess K3/K4, 16^3 and below through mult_vcycle. At 126^3 V(3,3) on the
card: level 0 through the K1 norm sweep and two K1 sweeps, K3, K4 and two K1
sweeps; 63^3 and 32^3 (RAP taps, not the uniform box) through chains of K1
sweeps and the torch transfers.

K2 is taken only where the taps are the uniform box. The reference takes it
on every 27-offset level and its kernel then asserts the uniform box, so its
struct_solve with >= 2 sweeps per side fails on a hierarchy with a constant
RAP coarse level; here such a level chains K1, which is the same arithmetic.

With tracing on (`utils/tracing.py`) the cycle opens the phase spans of
`solve/cycles.py`: a fused kernel belongs to the phase it ends in order
(K3, residual and restriction, to `amg.restrict:k`; K4, prolongation and
the first post-sweep, to `amg.prolong:k`; the first pre-sweep with the
residual norm to `amg.smooth:0`), and `struct_solve` opens `amg.solve`,
`amg.cycle` and `amg.host_read` as `solve.driver.solve` does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from amg_tpu_torch.dtypes import resolve_device
from amg_tpu_torch.ops.stencil import (
    from_padded,
    stencil_kernel_padded,
    taps_of,
    to_padded,
    uniform_box_weights,
)
from amg_tpu_torch.ops.transfer import (
    coarse_shape_of,
    prolong_padded,
    prolong_sweep_padded,
    residual_restrict_padded,
    restrict_padded,
    transfer_fuse_ok,
)
from amg_tpu_torch.setup.hierarchy import Hierarchy
from amg_tpu_torch.setup.structured import StructuredRestrict
from amg_tpu_torch.smooth.smoothers import JACOBI_TYPES
from amg_tpu_torch.solve.cycles import CycleConfig, mult_vcycle
from amg_tpu_torch.sparse.stencil import StencilOperator
from amg_tpu_torch.utils import tracing
from amg_tpu_torch.utils.tracing import span, traced


class StructKernelSpec(NamedTuple):
    """Static kernel data of one constant-stencil level."""

    weights: tuple
    offsets: tuple
    grid_shape: tuple
    alpha: float  # constant smoother scale (0.0 = non-constant, use scale_pad)
    scale_pad: torch.Tensor  # inv_wscale in padded layout
    box: bool = False  # the taps are the uniform 27-point box (K2 applies)


def make_struct_spec(hier: Hierarchy, lvl: int = 0) -> StructKernelSpec:
    A = hier.levels[lvl].A
    if not isinstance(A, StencilOperator):
        raise ValueError(f"level {lvl} is not a constant stencil")
    inv_wscale = hier.levels[lvl].sm.inv_wscale
    iw = inv_wscale.detach().cpu().numpy()
    # a constant scale (weighted Jacobi on a constant-diagonal stencil) is
    # applied as the scalar alpha, which drops the scale stream
    alpha = float(iw[0]) if iw.size and np.all(iw == iw[0]) else 0.0
    weights = tuple(float(w) for w in A.weights.detach().cpu().tolist())
    return StructKernelSpec(
        weights=weights,
        offsets=A.offsets,
        grid_shape=A.grid_shape,
        alpha=alpha,
        scale_pad=to_padded(inv_wscale, A.grid_shape),
        box=uniform_box_weights(taps_of(weights, A.offsets)) is not None,
    )


def make_coarse_specs(hier: Hierarchy) -> dict:
    """{lvl: spec} for every coarse level (not the coarsest) whose operator is
    a constant StencilOperator with a StructuredRestrict below it."""
    specs = {}
    for lvl in range(1, hier.num_levels - 1):
        if not isinstance(hier.levels[lvl].A, StencilOperator):
            continue
        if not isinstance(hier.levels[lvl].R, StructuredRestrict):
            continue
        specs[lvl] = make_struct_spec(hier, lvl)
    return specs


# level-0 fused transfers need the fine side to be at least this long; the
# unfused branch is the same arithmetic, so only the kernel count changes
_FUSE_MIN_SIDE = 96


def _can_fuse(hier: Hierarchy, lvl: int, spec) -> bool:
    """True when level lvl's transfers run through the fused non-zero-guess
    K3/K4 pair."""
    R = hier.levels[lvl].R
    if not isinstance(R, StructuredRestrict):
        return False
    if min(spec.grid_shape) < _FUSE_MIN_SIDE:
        return False
    return transfer_fuse_ok(spec.grid_shape, R.coarse_shape, spec.offsets)


def _can_fuse_zg(hier: Hierarchy, lvl: int, spec, cfg: CycleConfig) -> bool:
    """True when a COARSE level's whole V(1,1) visit runs as two zero-guess
    kernels: rc2 = R(b - A(s b)) and x' = S(s b + P ec, b). Needs the single
    pre-sweep (the zero-guess pre-sweep is exactly x = s b) and at least one
    post sweep."""
    if cfg.num_pre_sweeps != 1 or cfg.num_post_sweeps < 1:
        return False
    R = hier.levels[lvl].R
    if not isinstance(R, StructuredRestrict):
        return False
    return transfer_fuse_ok(spec.grid_shape, R.coarse_shape, spec.offsets)


def _fine(spec, mode, u_pad, b_pad):
    return stencil_kernel_padded(
        u_pad, b_pad, spec.weights, spec.grid_shape, spec.offsets, alpha=0.0,
        scale_pad=(spec.scale_pad if mode == "sweep_vec" else None), mode=mode,
    )


def _k2_pays(u_pad) -> bool:
    """True when runs of box sweeps go through K2 on this state. On the card
    they do not: on the H100 a chain of K1 box-march launches is faster than
    the K2 launch of the same sweeps in the cycle (126^3, float32 and
    float64) and alone (126^3 and 190^3 with three sweeps), because the
    march is bound by its steps, not its bytes, and K2 recomputes its halo
    and warms up at every chunk (PERF.md). On the CPU, where the plain
    versions run either way, K2 is taken as the reference takes it."""
    return u_pad.device.type != "cuda"


def _fine_sweeps(spec, u_pad, b_pad, n: int):
    """n smoother sweeps, chained greedily as the reference does: on the
    uniform 27-point box where K2 pays (`_k2_pays`), K2 launches of the
    deepest k <= 4 sweeps left, a lone last sweep as K1; otherwise n single K1
    launches (K2 equals the K1 chain bit for bit, so the choice moves only
    the launch count and the time)."""
    left = n
    fuse = spec.box and _k2_pays(u_pad)
    while left > 0:
        k = min(left, 4) if fuse else 1
        if k == 1:
            mode = "sweep" if spec.alpha != 0.0 else "sweep_vec"
        else:
            mode = f"sweep{k}" + ("" if spec.alpha != 0.0 else "_vec")
        u_pad = stencil_kernel_padded(
            u_pad, b_pad, spec.weights, spec.grid_shape, spec.offsets,
            alpha=spec.alpha, scale_pad=None if spec.alpha != 0.0 else spec.scale_pad,
            mode=mode,
        )
        left -= k
    return u_pad


def _restrict_padded(spec, r_pad):
    """Full-weighting restriction padded fine -> flat coarse."""
    tracing.count("spmv.transfer")
    return from_padded(restrict_padded(r_pad, spec.grid_shape), coarse_shape_of(spec.grid_shape))


def _prolong_padded(spec, ec):
    """Trilinear prolongation flat coarse -> padded fine (zero shell)."""
    tracing.count("spmv.transfer")
    cs = coarse_shape_of(spec.grid_shape)
    return prolong_padded(to_padded(ec, cs), spec.grid_shape)


def _next_fused(hier, cfg, specs, lvl) -> bool:
    nxt = specs.get(lvl + 1)
    return (
        lvl + 1 < hier.num_levels - 1
        and nxt is not None
        and (_can_fuse(hier, lvl + 1, nxt) or _can_fuse_zg(hier, lvl + 1, nxt, cfg))
    )


def _fused_correct_and_post(hier, cfg, specs, lvl, spec, x_pad, b_pad):
    """From the post-pre-sweep padded iterate at level lvl: fused
    residual+restrict (K3), recursive coarse correction, fused
    prolong+first-post-sweep (K4), remaining post sweeps."""
    cs = coarse_shape_of(spec.grid_shape)
    with span("restrict", lvl):
        rc_pad = residual_restrict_padded(
            x_pad, b_pad, spec.weights, spec.grid_shape, spec.offsets
        )
    ec_flat = ec_pad = None
    if _next_fused(hier, cfg, specs, lvl):
        ec_pad = _deep_correct_fused(hier, cfg, specs, lvl + 1, rc_pad)
    else:
        ec_flat = _deep_correct(hier, cfg, specs, lvl + 1, from_padded(rc_pad, cs))
    if cfg.num_post_sweeps >= 1:
        with span("prolong", lvl):
            if ec_pad is None:
                ec_pad = to_padded(ec_flat, cs)
            x_pad = prolong_sweep_padded(
                x_pad, b_pad, ec_pad, spec.weights, spec.grid_shape, spec.offsets,
                alpha=spec.alpha,
                scale_pad=None if spec.alpha != 0.0 else spec.scale_pad,
            )
        with span("smooth", lvl):
            return _fine_sweeps(spec, x_pad, b_pad, cfg.num_post_sweeps - 1)
    with span("prolong", lvl):
        if ec_flat is None:
            ec_flat = from_padded(ec_pad, cs)
        return x_pad + _prolong_padded(spec, ec_flat)


def _deep_correct_fused(hier, cfg, specs, lvl, rc_pad):
    """Coarse-grid correction with PADDED rhs in, PADDED correction out."""
    spec = specs[lvl]
    if _can_fuse_zg(hier, lvl, spec, cfg):
        # zero-guess level visit in two kernels: the pre-sweep from zero is
        # x = s*b, folded into both transfer kernels
        cs = coarse_shape_of(spec.grid_shape)
        sp = None if spec.alpha != 0.0 else spec.scale_pad
        with span("restrict", lvl):
            rc2_pad = residual_restrict_padded(
                None, rc_pad, spec.weights, spec.grid_shape, spec.offsets,
                zero_guess=True, scale_pad=sp, alpha=spec.alpha,
            )
        if _next_fused(hier, cfg, specs, lvl):
            ec_pad = _deep_correct_fused(hier, cfg, specs, lvl + 1, rc2_pad)
        else:
            ec = _deep_correct(hier, cfg, specs, lvl + 1, from_padded(rc2_pad, cs))
            ec_pad = to_padded(ec, cs)
        with span("prolong", lvl):
            x_pad = prolong_sweep_padded(
                None, rc_pad, ec_pad, spec.weights, spec.grid_shape, spec.offsets,
                alpha=spec.alpha, scale_pad=sp, zero_guess=True,
            )
        with span("smooth", lvl):
            return _fine_sweeps(spec, x_pad, rc_pad, cfg.num_post_sweeps - 1)
    with span("smooth", lvl):
        x_pad = _fine_sweeps(spec, torch.zeros_like(rc_pad), rc_pad, cfg.num_pre_sweeps)
    return _fused_correct_and_post(hier, cfg, specs, lvl, spec, x_pad, rc_pad)


def _deep_correct(hier: Hierarchy, cfg: CycleConfig, specs, lvl, rc):
    """Coarse-grid correction for flat rhs rc at level lvl >= 1: constant
    levels through the padded kernels, the rest through mult_vcycle."""
    if lvl == hier.num_levels - 1:
        with span("coarse"):
            return hier.coarse_Ainv @ rc
    spec = specs.get(lvl)
    if spec is None:
        sub = hier._replace(levels=hier.levels[lvl:])
        with tracing.levels_from(lvl):
            return mult_vcycle(sub, cfg, torch.zeros_like(rc), rc)
    if _can_fuse(hier, lvl, spec) or _can_fuse_zg(hier, lvl, spec, cfg):
        rc_pad = to_padded(rc, spec.grid_shape)
        return from_padded(
            _deep_correct_fused(hier, cfg, specs, lvl, rc_pad), spec.grid_shape
        )
    b_pad = to_padded(rc, spec.grid_shape)
    with span("smooth", lvl):
        x_pad = _fine_sweeps(spec, torch.zeros_like(b_pad), b_pad, cfg.num_pre_sweeps)
    with span("residual", lvl):
        r_pad = _fine(spec, "residual", x_pad, b_pad)
    with span("restrict", lvl):
        rc1 = _restrict_padded(spec, r_pad)
    ec = _deep_correct(hier, cfg, specs, lvl + 1, rc1)
    del rc1
    with span("prolong", lvl):
        x_pad = x_pad + _prolong_padded(spec, ec)
    with span("smooth", lvl):
        x_pad = _fine_sweeps(spec, x_pad, b_pad, cfg.num_post_sweeps)
    return from_padded(x_pad, spec.grid_shape)


def _struct_transfers(hier) -> bool:
    """True when level-0 transfers are the structured separable pair."""
    return isinstance(hier.levels[0].R, StructuredRestrict)


def _finish_cycle(hier, cfg, spec, cspecs, y_pad, b_pad):
    """residual -> restrict -> coarse correction -> prolong -> post sweeps,
    from the post-pre-sweep level-0 iterate."""
    if _struct_transfers(hier) and _can_fuse(hier, 0, spec):
        return _fused_correct_and_post(hier, cfg, cspecs, 0, spec, y_pad, b_pad)
    lv0 = hier.levels[0]
    with span("residual", 0):
        r_pad = _fine(spec, "residual", y_pad, b_pad)
    with span("restrict", 0):
        if _struct_transfers(hier):
            rc = _restrict_padded(spec, r_pad)
        else:
            rc = lv0.R @ from_padded(r_pad, spec.grid_shape)
    ec = _deep_correct(hier, cfg, cspecs, 1, rc)
    with span("prolong", 0):
        if _struct_transfers(hier):
            y_pad = y_pad + _prolong_padded(spec, ec)
        else:
            y_pad = y_pad + to_padded(lv0.P @ ec, spec.grid_shape)
    with span("smooth", 0):
        return _fine_sweeps(spec, y_pad, b_pad, cfg.num_post_sweeps)


def struct_vcycle(hier: Hierarchy, cfg: CycleConfig, spec: StructKernelSpec,
                  x_pad, b_pad, coarse_specs=None):
    """One V-cycle with the level-0 state in padded layout."""
    with span("smooth", 0):
        x_pad = _fine_sweeps(spec, x_pad, b_pad, cfg.num_pre_sweeps)
    return _finish_cycle(hier, cfg, spec, coarse_specs or {}, x_pad, b_pad)


def _presweep_norm(spec, cfg, x_pad, b_pad):
    """Pre-sweeps with the FIRST sweep fused to the incoming iterate's
    residual-norm partials (K1 sweep_vec_norm). With num_pre_sweeps == 0 the
    norm comes from a plain residual pass and the iterate is returned as it
    is."""
    if cfg.num_pre_sweeps == 0:
        with span("residual", 0):
            r = from_padded(_fine(spec, "residual", x_pad, b_pad), spec.grid_shape)
            return x_pad, torch.sqrt(torch.sum(r * r))
    with span("smooth", 0):
        y_pad, parts = stencil_kernel_padded(
            x_pad, b_pad, spec.weights, spec.grid_shape, spec.offsets,
            alpha=0.0, scale_pad=spec.scale_pad, mode="sweep_vec_norm",
        )
        y_pad = _fine_sweeps(spec, y_pad, b_pad, cfg.num_pre_sweeps - 1)
        return y_pad, torch.sqrt(torch.sum(parts))


class StructSolveResult(NamedTuple):
    x: torch.Tensor  # flat interior vector
    iters: int
    rel_resnorm: torch.Tensor
    history: torch.Tensor  # (max_cycles + 1,), NaN past the last cycle

    def num_iters(self) -> int:
        return int(self.iters)

    def history_list(self):
        h = self.history.detach().cpu().numpy()
        return h[~np.isnan(h)].tolist()


def _prepare(hier: Hierarchy, cfg: CycleConfig, b, device):
    device = resolve_device(device)
    if hier.device != device:
        raise ValueError(f"hierarchy lives on {hier.device}, solve asked for {device}")
    if cfg.smoother not in JACOBI_TYPES:
        raise NotImplementedError(
            f"the structured cycle's kernels run Jacobi sweeps, not {cfg.smoother.value}; "
            "solve a hierarchy with block smoothers through solve.driver.solve"
        )
    b = torch.as_tensor(b).to(device=device, dtype=hier.dtype)
    return make_struct_spec(hier), make_coarse_specs(hier), b


@traced("solve")
def struct_solve(
    hier: Hierarchy,
    cfg: CycleConfig,
    b,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-8,
    max_cycles: int = 100,
    device=None,
) -> StructSolveResult:
    """Full solve through the fused structured cycle, on `device` (None: the
    CUDA device; raises without one).

    Pipelined loop: each pass completes cycle k (residual -> coarse correct
    -> post sweeps) and then runs cycle k+1's pre-sweeps, whose fused norm is
    ||r(x_k)||, so no separate residual pass monitors convergence. Stops at
    max_cycles, at rel_res <= tol, or when a cycle (k >= 2) no longer cuts
    the residual by 1% (the float32 floor). The reference evaluates this
    test on the device inside its while_loop; here it reads one device
    scalar per cycle on the host (one sync per cycle; capturing the cycle in
    a CUDA graph is later work)."""
    spec, cspecs, b = _prepare(hier, cfg, b, device)
    gs = spec.grid_shape
    if x0 is None:
        x0 = torch.zeros_like(b)
    b_pad = to_padded(b, gs)
    x_pad = to_padded(x0.to(b), gs)
    y_pad, r0n = _presweep_norm(spec, cfg, x_pad, b_pad)
    safe_r0 = torch.where(r0n == 0.0, torch.ones_like(r0n), r0n)
    hist = torch.full((max_cycles + 1,), math.nan, dtype=b.dtype, device=b.device)
    hist[0] = 1.0
    relnorm = torch.tensor(math.inf, dtype=b.dtype, device=b.device)
    k = 0
    while k < max_cycles:
        go = relnorm > tol
        if k >= 2:
            # stagnation guard: stop when a cycle no longer reduces the
            # residual by > 1%
            go = go & ~(relnorm > 0.99 * hist[k - 1])
        if not tracing.host_read(go, bool):
            break
        with span("cycle"):
            x_pad = _finish_cycle(hier, cfg, spec, cspecs, y_pad, b_pad)  # x_{k+1}
            y_pad, rn = _presweep_norm(spec, cfg, x_pad, b_pad)  # starts cycle k+2
            relnorm = rn / safe_r0
            hist[k + 1] = relnorm
        k += 1
    return StructSolveResult(
        x=from_padded(x_pad, gs), iters=k, rel_resnorm=relnorm, history=hist
    )


def struct_timed_cycles(
    hier: Hierarchy, cfg: CycleConfig, b, num_cycles: int, device=None
) -> torch.Tensor:
    """Exactly num_cycles fused V-cycles from x = 0 with no residual
    monitoring (no host sync inside): the per-cycle cost program. Two runs
    with different num_cycles give the marginal cycle cost by slope."""
    spec, cspecs, b = _prepare(hier, cfg, b, device)
    b_pad = to_padded(b, spec.grid_shape)
    x_pad = torch.zeros_like(b_pad)
    for _ in range(num_cycles):
        x_pad = struct_vcycle(hier, cfg, spec, x_pad, b_pad, cspecs)
    return from_padded(x_pad, spec.grid_shape)
