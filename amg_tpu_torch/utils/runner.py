"""Experiment orchestrator (counterpart of amg_tpu/utils/runner.py):
options -> problem -> setup -> solve -> stats, on one device.

`run_experiment(opts, device=None, draws=None)` runs every single-device
configuration of the reference's runner, branch by branch in its order.
It is `solve_experiment(setup_experiment(opts, device), draws)`: the two
halves let a caller keep the built hierarchy (`Experiment.hier`) beside the
result. Where the port differs:

  * `device=None` is the CUDA device (raises without one); "cpu" runs the
    plain PyTorch path, and takes the branches the reference takes on its
    CPU backend;
  * the fused structured solve (`struct_solve`, kernels K1-K4) runs on the
    CUDA device where the reference's runs on an accelerator, and only where
    level 0 is a constant stencil (`takes_struct_solve`): the reference's
    guard lacks that test and fails on a DIA level 0 (ROADMAP F10);
  * `-mixed_precision` refines in float64 (the H100 has it natively): a
    grid-structured problem's outer operator is the float64 DIA operator
    (K5 on the card), a stencil problem's the float64 stencil; the
    reference's double-single pair is not ported. The reference's warning
    about float32 stagnation below tol 1e-5 is dropped with it: the solve
    dtype here is float64;
  * the async solvers draw from the port's generators seeded from
    `opts.seed` (the reference's `jax.random` key chains are not
    reproduced); `draws=` hands one draw source to whichever async solver
    runs (the tests replay the reference's draws through it);
  * `num_devices > 1` raises: the multi-device modules are ROADMAP queue 1
    item 11; the reference's fixed-tile `-device_format bsr` is not ported
    (ROADMAP, "Not ported") and raises.
"""

from __future__ import annotations

import subprocess
import sys
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from amg_tpu_torch.dtypes import resolve_device
from amg_tpu_torch.utils.config import EXT_SOLVERS, SolverOptions
from amg_tpu_torch.utils.stats import SolveStats, Timer

NOT_PORTED_MULTI_DEVICE = (
    "num_devices > 1 needs the multi-device modules (parallel/), which are not "
    "ported yet (ROADMAP queue 1 item 11)"
)


def build_problem(opts: SolverOptions):
    from amg_tpu_torch.problems import (
        difconv_3d,
        laplacian_2d_5pt,
        laplacian_3d_7pt,
        laplacian_3d_27pt,
        vardifconv_3d,
    )

    nx, ny, nz = opts.grid_dims()
    if opts.problem == "5pt":
        return laplacian_2d_5pt(nx, ny)
    if opts.problem == "7pt":
        return laplacian_3d_7pt(nx, ny, nz)
    if opts.problem == "27pt":
        return laplacian_3d_27pt(nx, ny, nz)
    if opts.problem == "difconv":
        return difconv_3d(
            nx, ny, nz, eps=opts.eps, atype=opts.difconv_atype,
            ax=opts.ax, ay=opts.ay, az=opts.az,
            cx=opts.cx, cy=opts.cy, cz=opts.cz,
        )
    if opts.problem == "vardifconv":
        return vardifconv_3d(nx, ny, nz, eps=opts.eps, seed=opts.seed)
    if opts.problem == "elasticity":
        from amg_tpu_torch.problems.elasticity import elasticity_beam

        return elasticity_beam(
            nx=nx, ny=ny, nz=(nz if opts.nz else 0), bc=opts.elast_bc
        )
    if opts.problem == "maxwell":
        from amg_tpu_torch.problems.maxwell import maxwell_curlcurl

        return maxwell_curlcurl(n=nx, sigma=opts.sigma)
    if opts.problem == "graded":
        from amg_tpu_torch.problems.amr import laplacian_graded

        return laplacian_graded(nx, ny, gamma=opts.grading)
    if opts.problem == "amr":
        from amg_tpu_torch.problems.amr import amr_refine_loop

        rounds = amr_refine_loop(
            n0=nx, rounds=opts.amr_rounds, theta=opts.amr_theta
        )
        return rounds[-1]["problem"]
    if opts.problem == "file":
        from amg_tpu_torch.problems.io import problem_from_file

        return problem_from_file(
            opts.matrix_file,
            remove_disconnected=opts.include_disconnected_points,
        )
    raise ValueError(f"unknown problem {opts.problem}")


def _make_vectors(opts, n, dtype, device):
    """b and x0 from default_rng(opts.seed), as the reference draws them
    (b first), on `device`."""
    rng = np.random.default_rng(opts.seed)

    def make(kind):
        if kind == "rand":
            return torch.from_numpy(rng.random(n)).to(device=device, dtype=dtype)
        if kind == "ones":
            return torch.ones(n, dtype=dtype, device=device)
        return torch.zeros(n, dtype=dtype, device=device)

    return make(opts.rhs), make(opts.init_guess)


def takes_struct_solve(opts: SolverOptions, smoother, device, A0) -> bool:
    """Whether the run goes through the fused structured solve: a plain MULT
    solve of the structured hierarchy with a Jacobi smoother, on the CUDA
    device, whose level 0 is a constant stencil (the kernels' layout; the
    reference's guard, which tests only for an accelerator, fails on a DIA
    level 0, ROADMAP F10). Pure: reads nothing but its arguments."""
    from amg_tpu_torch.smooth.smoothers import SmootherType
    from amg_tpu_torch.sparse.stencil import StencilOperator

    return (
        opts.hierarchy == "structured"
        and opts.solver == "mult"
        and not opts.mixed_precision
        and opts.accel == "none"
        and opts.outer_solver == "none"
        and opts.num_devices <= 1
        # the fused fine-level sweeps are (w/L1-)Jacobi; other smoothers
        # take the generic cycle
        and smoother in (SmootherType.JACOBI, SmootherType.L1_JACOBI)
        and torch.device(device).type == "cuda"
        and isinstance(A0, StencilOperator)
    )


def async_accel_options(coeffs, accel, async_type="full", sim_read_delay=4,
                        comm_every=1, cheby_grid=0, converge_test_type="global") -> dict:
    """The AsyncConfig keywords of the asynchronous acceleration, from the
    eigenvalue bounds `coeffs` of the synchronous additive operator (the
    reference's asymmetric async Chebyshev/Richardson): each level group
    advances its own recurrence, corrections scale by omega_k * delta, the
    cheby_grid group carries the momentum. delta is damped 0.4x under FULL
    (per-row) staleness, 0.6x under SEMI (per-level), not at all without
    staleness (delay 0). Coalesced publishes (comm_every > 1) and local
    convergence keep the scalar omega = 0.5 * 2 / (alpha + beta) instead.
    `coeffs` may come from either package's cheby_setup."""
    if accel not in ("richardson", "cheby"):
        return {}
    if comm_every > 1 or converge_test_type == "local":
        return {"omega": 0.5 * 2.0 / (coeffs.alpha + coeffs.beta)}
    damp = 0.4 if async_type == "full" else 0.6
    if sim_read_delay == 0:
        damp = 1.0  # no staleness: the recurrence is exact
    return {"accel": accel, "cheby_grid": cheby_grid, "cheby_mu": coeffs.mu,
            "cheby_delta": coeffs.delta * damp}


def resolve_delays(opts: SolverOptions, num_levels: int) -> dict:
    """The delay and failure keywords of AsyncConfig, with the reference's
    selection policies resolved against the level count: -delay_one delays
    the last level group, -delay_all every group, -delay_some a random
    delay_frac of them (default_rng(seed)); -fail_one <iter> makes the last
    group miss one firing at that step."""
    L = num_levels
    delay_levels = tuple(opts.delay_levels)
    if opts.delay_type == "one":
        delay_levels = (L - 1,)
    elif opts.delay_type == "all":
        delay_levels = tuple(range(L))
    elif opts.delay_type == "some":
        rng_d = np.random.default_rng(opts.seed)
        k_d = min(max(1, int(round(opts.delay_frac * L))), L)
        delay_levels = tuple(
            sorted(rng_d.choice(L, size=k_d, replace=False).tolist())
        )
    fail_level, fail_start, fail_duration = (
        opts.fail_level, opts.fail_start, opts.fail_duration
    )
    if opts.fail_iter >= 0:
        fail_level, fail_start, fail_duration = L - 1, opts.fail_iter, 1
    return {"delay_levels": delay_levels, "delay_prob": opts.delay_prob,
            "fail_level": fail_level, "fail_start": fail_start,
            "fail_duration": fail_duration}


@dataclass
class Experiment:
    """A set-up run: the options (fixed up), the device, the problem, the
    hierarchy and its parameters, the float64 outer operator of a
    mixed-precision grid-structured run, and the stats so far."""

    opts: SolverOptions
    device: torch.device
    stats: SolveStats
    prob: Any = None
    params: Any = None
    smoother: Any = None
    hh: Any = None
    hier: Any = None
    A_acc: Any = None  # float64 outer operator (mixed_pcg)
    done: bool = False  # only_build_matrix / only_setup: nothing to solve


def setup_experiment(opts: SolverOptions, device=None) -> Experiment:
    """Options -> problem -> hierarchy on `device` (None: the CUDA device;
    raises without one). Fixes up `opts` in place, as the reference does."""
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu_torch.smooth.smoothers import SmootherType

    device = resolve_device(device)
    opts.fixup()
    if opts.num_devices > 1:
        raise NotImplementedError(NOT_PORTED_MULTI_DEVICE)
    if opts.device_format == "bsr":
        raise ValueError(
            "device_format 'bsr' (the reference's fixed-tile BSR) is not ported "
            "(ROADMAP, 'Not ported'); use 'auto', 'ell' or 'dia'"
        )
    stats = SolveStats(
        problem=opts.problem, solver=opts.solver, smoother=opts.smoother
    )
    exp = Experiment(opts=opts, device=device, stats=stats)
    timer = Timer()
    prob = exp.prob = build_problem(opts)
    if opts.print_matrix:
        # the matrix in the reference's binary-triplet record format
        from amg_tpu_torch.problems.io import write_binary_triplets

        write_binary_triplets(opts.print_matrix, prob.A)
    if opts.only_build_matrix:
        stats.n, stats.nnz = prob.n, prob.A.nnz
        stats.setup_wtime = timer.lap()
        exp.done = True
        return exp
    smoother = exp.smoother = SmootherType(opts.smoother)
    if opts.num_functions > 0:
        num_functions = opts.num_functions
    elif opts.problem == "elasticity":
        num_functions = 3 if opts.nz else 2
    else:
        num_functions = 1
    params = exp.params = HierarchyParams(
        strong_threshold=opts.strong_threshold,
        num_functions=num_functions,
        coarsen_type=opts.coarsen_type,
        interp_type=opts.interp_type,
        trunc_factor=opts.trunc_factor,
        p_max_elmts=opts.p_max_elmts,
        max_levels=opts.max_levels,
        max_coarse_size=opts.max_coarse_size,
        agg_num_levels=opts.agg_nl,
        add_trunc_factor=opts.add_tr,
        seed=opts.seed,
        smoother=smoother,
        smooth_weight=opts.smooth_weight,
        block_size=opts.block_size,
        keep_stencil_fine=True,
        setup_type=opts.setup_type,
        # "dia" names the fine operator's form; the other levels take the
        # default format, as in the reference
        device_format="auto" if opts.device_format == "dia" else opts.device_format,
    )
    if opts.hierarchy == "structured":
        dtype_s = torch.float32 if opts.mixed_precision else params.dtype
        if prob.stencil is not None:
            from amg_tpu_torch.setup.structured import build_structured_hierarchy

            exp.hh, exp.hier = build_structured_hierarchy(
                prob.stencil,
                max_levels=opts.max_levels,
                max_coarse_size=max(opts.max_coarse_size, 8),
                dtype=dtype_s,
                smoother=smoother,
                smooth_weight=opts.smooth_weight,
                device=device,
            )
        elif prob.grid_shape is not None:
            # variable-coefficient or interleaved-vector operator on a
            # structured grid (elasticity bc "identity", vardifconv): the
            # geometric hierarchy with DIA operators on every level
            from amg_tpu_torch.setup.structured import (
                DiaKernelOperator,
                VarStencilOperator,
                build_dia_structured_hierarchy,
                csr_to_dia_stencil,
            )

            gs = prob.grid_shape
            nf = num_functions
            node_shape = tuple(gs[:-1]) + (gs[-1] // max(nf, 1),)
            if opts.mixed_precision:
                # the float64 outer operator of mixed_pcg (K5 on the card)
                vs = csr_to_dia_stencil(prob.A, gs)
                exp.A_acc = DiaKernelOperator.from_var_stencil(VarStencilOperator(
                    coeffs=vs.coeffs.to(device), offsets=vs.offsets,
                    grid_shape=vs.grid_shape))
            exp.hh, exp.hier = build_dia_structured_hierarchy(
                prob.A,
                node_shape,
                num_functions=nf,
                max_levels=opts.max_levels,
                max_coarse_size=max(opts.max_coarse_size, 8),
                dtype=dtype_s,
                smoother=smoother,
                smooth_weight=opts.smooth_weight,
                device=device,
            )
        else:
            raise ValueError(
                "structured hierarchy needs a stencil or grid-structured "
                "problem"
            )
    else:
        fine_op = prob.stencil
        if (
            fine_op is None
            and prob.grid_shape is not None
            and opts.device_format in ("auto", "dia")
            and (opts.device_format == "dia" or device.type == "cuda")
        ):
            # translation-structured CSR without a constant stencil
            # (elasticity bc "identity", vardifconv): the DIA form applies
            # the operator as shifted multiply-adds, no gathers
            from amg_tpu_torch.setup.structured import csr_to_dia_stencil

            try:
                fine_op = csr_to_dia_stencil(prob.A, prob.grid_shape, params.dtype)
            except ValueError:
                fine_op = None  # not translation-structured: the formats below
        exp.hh, exp.hier = build_hierarchy(
            prob.A,
            params,
            fine_stencil=fine_op,
            near_nullspace=getattr(prob, "near_nullspace", None),
            device=device,
        )
    hstats = exp.hh.stats()
    stats.n, stats.nnz = prob.n, prob.A.nnz
    stats.num_levels = hstats["num_levels"]
    stats.operator_complexity = hstats["operator_complexity"]
    stats.level_n, stats.level_nnz = hstats["n"], hstats["nnz"]
    _sync(device)
    stats.setup_wtime = timer.lap()
    exp.done = opts.only_setup
    return exp


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def cycle_config(opts: SolverOptions, smoother):
    """The CycleConfig of a run (the additive solvers' base cycle; the
    extended and AMS solvers ignore it)."""
    from amg_tpu_torch.solve.cycles import CycleConfig, CycleType

    base = opts.solver.removeprefix("async_")
    return CycleConfig(
        cycle=CycleType(base if base in (
            "mult", "multadd", "mult_multadd", "afacx", "afacj", "bpx"
        ) else "bpx"),
        smoother=smoother,
        num_pre_sweeps=opts.num_pre_smooth_sweeps,
        num_post_sweeps=opts.num_post_smooth_sweeps,
        num_fine_sweeps=opts.num_fine_smooth_sweeps,
        num_coarse_sweeps=opts.num_coarse_smooth_sweeps,
        num_add_sweeps=opts.num_add_smooth_sweeps,
        use_smoothed_transfers=(
            base in ("multadd", "mult_multadd") and opts.one_interpolant
        ),
        simple_add_smoother=opts.simple_jacobi,
        coarsest_mult_level=opts.coarsest_mult_level,
        num_inner_cycles=opts.num_inner_cycles,
        afacj_level=opts.afacj_level,
    )


def solve_experiment(exp: Experiment, draws=None) -> SolveStats:
    """Solve a set-up run and return its stats (a copy of exp.stats with the
    solve's results, the final iterate in `stats.x` on the run's device);
    exp can be solved again. `draws` replaces the draw source of the async
    solver that runs (None: the port's generators seeded from
    opts.seed)."""
    opts, device, prob, hier = exp.opts, exp.device, exp.prob, exp.hier
    if exp.done:
        return exp.stats
    stats = replace(exp.stats)  # each solve of exp reports its own
    from amg_tpu_torch.solve.driver import cheby_setup, solve

    timer = Timer()
    competitor = None
    if opts.background_program:
        # a host busy-loop competitor for the solve's duration (straggler
        # injection; killed by its exact PID afterwards)
        competitor = subprocess.Popen(
            [sys.executable, "-c", "while True:\n a = sum(range(10000))"]
        )
    params, smoother = exp.params, exp.smoother
    dtype = params.dtype
    b, x0 = _make_vectors(opts, prob.n, dtype, device)
    if prob.rhs is not None and opts.rhs == "rand":
        # generators with a natural load (elasticity beam, maxwell source)
        rhs = np.asarray(prob.rhs)
        b = torch.from_numpy(rhs / np.linalg.norm(rhs)).to(device=device, dtype=dtype)
    cfg = cycle_config(opts, smoother)
    gw = None
    try:
        if opts.solver == "async_smooth":
            from amg_tpu_torch.solve.async_smooth import (
                AsyncSmoothConfig,
                async_smooth_solve,
                block_neighbor_mask,
            )

            ascfg = AsyncSmoothConfig(
                smoother=smoother,
                num_blocks=opts.num_blocks,
                method=opts.sps_method,
                sps_alpha=opts.sps_alpha,
                sps_min_prob=opts.sps_min_prob,
                fire_prob=opts.fire_prob,
            )
            nbr = block_neighbor_mask(prob.A, opts.num_blocks)
            res = async_smooth_solve(
                hier.levels[0].A, hier.levels[0].sm, ascfg, nbr, b, x0,
                draws=draws, seed=opts.seed, tol=opts.tol,
                max_cycles=opts.num_cycles, device=device,
            )
        elif opts.solver in EXT_SOLVERS:
            from amg_tpu_torch.solve.accel import estimate_cycle_eigs
            from amg_tpu_torch.solve.extended import (
                build_extended_system,
                ext_matvec,
                ext_solve,
            )

            ext = build_extended_system(
                exp.hh, params, explicit="explicit" in opts.solver, device=device
            )
            coeffs = estimate_cycle_eigs(
                lambda op, u: op[0].inv_wdiag * ext_matvec(op[0], op[1], u),
                ext.offsets[-1], dtype,
                num_iters=opts.cheby_power_iters, range_start=True,
                operand=(ext, hier.levels[0].A), device=device,
            )
            res = ext_solve(
                hier, ext, b, x0, tol=opts.tol, max_cycles=opts.num_cycles,
                cheby_coeffs=coeffs,
                async_fire_prob=(opts.fire_prob if opts.is_async() else 1.0),
                sim_read_delay=(opts.sim_read_delay if opts.is_async() else 0),
                draws=draws, seed=opts.seed, device=device,
            )
        elif opts.solver == "async_ams":
            # the asynchronous additive engine over the AMS correction
            # groups of the Maxwell edge system
            if not (prob.aux and "G" in prob.aux):
                raise ValueError("async_ams needs a problem with aux['G']")
            from amg_tpu_torch.solve.ams import ams_async_additive_solve, build_ams

            ams_data, _ = build_ams(
                prob.A, prob.aux["G"], params=None, Pi=prob.aux.get("Pi"),
                device=device,
            )
            res = ams_async_additive_solve(
                hier.levels[0].A, ams_data, b, draws=draws, seed=opts.seed,
                fire_prob=opts.fire_prob, sim_read_delay=opts.sim_read_delay,
                tol=opts.tol, max_cycles=opts.num_cycles, device=device,
            )
        elif opts.is_async():
            from amg_tpu_torch.solve.async_sim import AsyncConfig, async_solve

            accel_kw = {}
            if opts.accel in ("richardson", "cheby"):
                coeffs = cheby_setup(hier, cfg, num_iters=opts.cheby_power_iters,
                                     method=opts.cheby_eig, device=device)
                accel_kw = async_accel_options(
                    coeffs, opts.accel, opts.async_type, opts.sim_read_delay,
                    max(opts.async_comm_save_divisor, 1), opts.cheby_grid,
                    opts.converge_test_type)
            acfg = AsyncConfig(
                read_type=opts.read_type,
                res_mode=("update" if opts.res_update_type == "accumulate"
                          else "recompute"),
                async_type=opts.async_type,
                sim_read_delay=opts.sim_read_delay,
                fire_prob=opts.fire_prob,
                sim_grid_wait=opts.sim_grid_wait,
                comm_every=max(opts.async_comm_save_divisor, 1),
                **resolve_delays(opts, stats.num_levels),
                **accel_kw,
            )
            res = async_solve(
                hier, cfg, acfg, b, x0, draws=draws, seed=opts.seed,
                tol=opts.tol, max_cycles=opts.num_cycles, device=device,
            )
            gw = res.grid_wait.summary()
        elif takes_struct_solve(opts, smoother, device, hier.levels[0].A):
            # the fused structured path on the card (K1-K4)
            from amg_tpu_torch.solve.struct_cycle import struct_solve

            res = struct_solve(
                hier, cfg, b, x0, tol=opts.tol, max_cycles=opts.num_cycles,
                device=device,
            )
        elif opts.mixed_precision:
            from amg_tpu_torch.solve.mixed import mixed_pcg, mixed_solve

            if exp.A_acc is not None:
                # ill-conditioned structured FEM (elasticity): PCG refinement
                # against the float64 DIA operator
                res = mixed_pcg(
                    hier, exp.A_acc, cfg, b, x0, tol=opts.tol,
                    max_cycles=opts.num_cycles, device=device,
                )
            else:
                res = mixed_solve(
                    hier, _fine_operator64(prob, hier), cfg, b, x0, tol=opts.tol,
                    max_cycles=opts.num_cycles, device=device,
                )
        elif opts.outer_solver == "ams_pcg":
            # auxiliary-space PCG (curl-curl): needs the discrete gradient
            if not (prob.aux and "G" in prob.aux):
                raise ValueError("ams_pcg needs a problem with aux['G']")
            from amg_tpu_torch.convert import matrix_from_arrays
            from amg_tpu_torch.setup.hierarchy import _format_converter
            from amg_tpu_torch.solve.ams import build_ams, solve_ams_pcg

            ams, node_cfg = build_ams(
                prob.A, prob.aux["G"], params=None, Pi=(prob.aux or {}).get("Pi"),
                device=device,
            )
            A_dev = matrix_from_arrays(_format_converter(params)(prob.A), dtype, device)
            res = solve_ams_pcg(
                A_dev, ams, node_cfg, b, x0, tol=opts.tol,
                max_iters=opts.num_cycles, device=device,
            )
        else:
            coeffs = None
            accel = None if opts.accel == "none" else opts.accel
            if accel:
                coeffs = cheby_setup(hier, cfg, num_iters=opts.cheby_power_iters,
                                     method=opts.cheby_eig, device=device)
            res = solve(
                hier, cfg, b, x0, tol=opts.tol, max_cycles=opts.num_cycles,
                accel=accel, cheby_coeffs=coeffs,
                outer=None if opts.outer_solver == "none" else opts.outer_solver,
                no_resnorm=opts.no_resnorm, device=device,
            )
        _sync(device)
        stats.solve_wtime = timer.lap()
    finally:
        if competitor is not None:
            competitor.kill()
            competitor.wait()
    stats.cycles = int(res.iters)
    stats.rel_resnorm = float(res.rel_resnorm)
    stats.x = res.x
    if opts.rhs == "zeros" and opts.init_guess != "zeros":
        # zero-RHS experiment: the iterate is the error; the relative A-norm
        # error (the reference's e_Anorm / e0_Anorm)
        A_np = prob.A
        x_np = _host(res.x).astype(np.float64)[: prob.n]
        x0_np = _host(x0).astype(np.float64)[: prob.n]
        eA = float(np.sqrt(max(x_np @ (A_np @ x_np), 0.0)))
        e0A = float(np.sqrt(max(x0_np @ (A_np @ x0_np), 1e-300)))
        stats.e_anorm_rel = eA / e0A
    h = _host(res.history).astype(np.float64)
    stats.history = h[~np.isnan(h)].tolist()
    stats.grid_wait = gw
    if (
        opts.print_level_stats
        and opts.hierarchy in ("algebraic", "structured")
        and opts.solver in ("mult", "multadd", "afacx", "afacj", "bpx")
    ):
        # per-phase instrumented re-run (the segmented cycle)
        from amg_tpu_torch.utils.phases import profile_phases

        stats.phase = profile_phases(
            hier, cfg, b, x0, num_cycles=min(max(stats.cycles, 1), 5)
        )
    return stats


def _fine_operator64(prob, hier):
    """mixed_solve's float64 fine operator: the problem's stencil in float64
    on the hierarchy's device where level 0 is a stencil of another dtype,
    else level 0 itself."""
    from amg_tpu_torch.sparse.stencil import StencilOperator

    A0 = hier.levels[0].A
    if isinstance(A0, StencilOperator) and A0.weights.dtype != torch.float64:
        return StencilOperator(
            weights=prob.stencil.weights.to(device=hier.device, dtype=torch.float64),
            offsets=A0.offsets, grid_shape=A0.grid_shape,
        )
    return A0


def run_experiment(opts: SolverOptions, device=None, draws=None) -> SolveStats:
    """One run of the configured experiment on `device` (None: the CUDA
    device; raises without one): the problem, its hierarchy, the solve, the
    stats. `draws` replaces the async solver's draw source."""
    return solve_experiment(setup_experiment(opts, device), draws=draws)
