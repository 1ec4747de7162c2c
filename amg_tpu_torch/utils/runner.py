"""Experiment orchestrator (counterpart of amg_tpu/utils/runner.py):
options -> problem -> setup -> solve -> stats, on one device or over a mesh
of logical shards.

`run_experiment(opts, device=None, draws=None)` runs every configuration of
the reference's runner, branch by branch in its order.
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
  * `num_devices > 1` runs the reference's row-partitioned branches over a
    mesh of num_devices logical shards on `device` (`parallel.dist`; across
    the processes of an initialized process group when there is one): the
    structured hierarchy on the mesh, `build_dist_hierarchy` (comm "halo" or
    "gspmd") for the generic solves, the halo operators of one-level async
    smoothing, the sharded AMS-PCG; and its grid (level) parallel branches
    over the same mesh (`parallel.grid`), where the reference keeps the
    replicated hierarchy: the extended system with its level blocks on the
    work model's shards, the async additive solvers with grid parallelism
    and async AMS over its groups. No kernel runs there, as in the
    reference (the DIA hierarchy takes its plain form, the fused structured
    solve is not taken). The reference's fixed-tile `-device_format bsr` is
    not ported (ROADMAP, "Not ported") and raises.
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


def hierarchy_params(opts: SolverOptions):
    """The HierarchyParams of a (fixed-up) run's options."""
    from amg_tpu_torch.setup.hierarchy import HierarchyParams
    from amg_tpu_torch.smooth.smoothers import SmootherType

    if opts.num_functions > 0:
        num_functions = opts.num_functions
    elif opts.problem == "elasticity":
        num_functions = 3 if opts.nz else 2
    else:
        num_functions = 1
    return HierarchyParams(
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
        smoother=SmootherType(opts.smoother),
        smooth_weight=opts.smooth_weight,
        block_size=opts.block_size,
        keep_stencil_fine=True,
        setup_type=opts.setup_type,
        # "dia" names the fine operator's form; the other levels take the
        # default format, as in the reference
        device_format="auto" if opts.device_format == "dia" else opts.device_format,
    )


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
    mesh: Any = None  # the row mesh of a row-sharded hierarchy (num_devices > 1)
    # the mesh of a grid (level) parallel run, whose hierarchy is replicated
    grid_mesh: Any = None
    pad_info: Any = None  # (n, padded n) of the mesh's vectors


def setup_experiment(opts: SolverOptions, device=None) -> Experiment:
    """Options -> problem -> hierarchy on `device` (None: the CUDA device;
    raises without one). Fixes up `opts` in place, as the reference does."""
    from amg_tpu_torch.setup.hierarchy import build_hierarchy
    from amg_tpu_torch.smooth.smoothers import SmootherType

    device = resolve_device(device)
    opts.fixup()
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
    params = exp.params = hierarchy_params(opts)
    num_functions = params.num_functions
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
                # the float64 outer operator of mixed_pcg (K5 on the card;
                # multi-device: the plain DIA form)
                vs = csr_to_dia_stencil(prob.A, gs)
                exp.A_acc = VarStencilOperator(coeffs=vs.coeffs.to(device), offsets=vs.offsets,
                                               grid_shape=vs.grid_shape)
                if opts.num_devices <= 1:
                    exp.A_acc = DiaKernelOperator.from_var_stencil(exp.A_acc)
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
                # multi-device: the plain DIA form, as the reference keeps
                # its XLA form there
                use_kernel=opts.num_devices <= 1,
            )
        else:
            raise ValueError(
                "structured hierarchy needs a stencil or grid-structured "
                "problem"
            )
        if opts.num_devices > 1:
            from amg_tpu_torch.parallel.dist import (
                make_row_mesh,
                shard_structured_hierarchy,
                shard_structured_operator,
            )

            if prob.n % opts.num_devices == 0:
                exp.mesh = make_row_mesh(opts.num_devices, device)
                exp.hier = shard_structured_hierarchy(exp.hier, exp.mesh)
                exp.pad_info = (prob.n, prob.n)  # no padding on the structured path
                if exp.A_acc is not None and exp.mesh.world_size > 1:
                    exp.A_acc = shard_structured_operator(exp.A_acc, exp.mesh)
            else:
                print(
                    f"warning: n={prob.n} not divisible by {opts.num_devices} "
                    "devices -- structured hierarchy runs replicated (choose grid "
                    "sizes with n % num_devices == 0 to shard)"
                )
    elif opts.num_devices > 1:
        _setup_sharded(exp, params)
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


def _setup_sharded(exp: Experiment, params) -> None:
    """The generic hierarchy of a num_devices > 1 run, as the reference
    builds it: row-sharded over a mesh of num_devices shards
    (`build_dist_hierarchy` with opts.comm), except where a branch replaces
    it. With grid parallelism (the extended system, the async additive
    solvers, async AMS) the hierarchy stays replicated and `exp.grid_mesh`
    carries the mesh the solver lays its levels on; one-level async
    smoothing keeps the replicated hierarchy and puts its own halo operator
    on the mesh (`solve_experiment`); the extended system without grid
    parallelism runs replicated, as the reference runs it (said on
    stdout)."""
    from amg_tpu_torch.parallel.dist import build_dist_hierarchy, make_row_mesh
    from amg_tpu_torch.setup.hierarchy import build_host_hierarchy, device_hierarchy

    opts, prob, device = exp.opts, exp.prob, exp.device
    if params.setup_type == "sa":
        from amg_tpu_torch.setup.aggregation import build_sa_host_hierarchy

        exp.hh = build_sa_host_hierarchy(prob.A, params,
                                         B=getattr(prob, "near_nullspace", None))
    else:
        exp.hh = build_host_hierarchy(prob.A, params)
    if opts.grid_parallel and (opts.solver in EXT_SOLVERS or opts.is_async()):
        exp.hier = device_hierarchy(exp.hh, params, device=device)
        if opts.solver != "async_smooth":
            exp.grid_mesh = make_row_mesh(opts.num_devices, device)
        return
    if opts.solver in EXT_SOLVERS:
        print(f"note: {opts.solver} with -no_grid_parallel runs replicated on "
              f"{device} (the extended system's only distribution is the grid layout)")
        exp.hier = device_hierarchy(exp.hh, params, device=device)
        return
    exp.mesh = make_row_mesh(opts.num_devices, device)
    exp.hier, exp.pad_info = build_dist_hierarchy(exp.hh, params, exp.mesh, comm=opts.comm)


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
    opts, device, prob, hier, grid_mesh = exp.opts, exp.device, exp.prob, exp.hier, exp.grid_mesh
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
    b_global, x0_global = b, x0
    mesh = exp.mesh
    if mesh is not None:
        from amg_tpu_torch.parallel.dist import pad_vector

        b = pad_vector(b, exp.pad_info, mesh)
        x0 = pad_vector(x0, exp.pad_info, mesh)
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
            A_s, sm_s, smooth_mesh = hier.levels[0].A, hier.levels[0].sm, mesh
            if opts.num_devices > 1 and int(sm_s.scale.shape[0]) == prob.n:
                A_s, sm_s, b, x0, smooth_mesh = _halo_smoothing(exp, A_s, sm_s, b, x0)
            res = async_smooth_solve(
                A_s, sm_s, ascfg, nbr, b, x0,
                draws=draws, seed=opts.seed, tol=opts.tol,
                max_cycles=opts.num_cycles, device=device, mesh=smooth_mesh,
            )
            if smooth_mesh is not None and mesh is None:
                res = res._replace(x=smooth_mesh.gather(res.x))
        elif opts.solver in EXT_SOLVERS:
            from amg_tpu_torch.solve.accel import estimate_cycle_eigs
            from amg_tpu_torch.solve.extended import (
                build_extended_system,
                ext_matvec,
                ext_solve,
            )

            if grid_mesh is not None:
                from amg_tpu_torch.solve.extended import build_sharded_extended_system

                # the grid-mapped extended system: explicit AA, its block
                # rows on the work model's shards
                ext = build_sharded_extended_system(
                    exp.hh, params, grid_mesh, imbalance=opts.imbal,
                    assign_policy=opts.assign_procs, assign_scalar=opts.assign_procs_scalar,
                )
            else:
                ext = build_extended_system(
                    exp.hh, params, explicit="explicit" in opts.solver, device=device
                )
            coeffs = estimate_cycle_eigs(
                lambda op, u: op[0].inv_wdiag * ext_matvec(op[0], op[1], u),
                ext.offsets[-1], dtype,
                num_iters=opts.cheby_power_iters, range_start=True,
                operand=(ext, hier.levels[0].A), device=device, mesh=ext.mesh,
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
            from amg_tpu_torch.solve.ams import (
                ams_async_additive_solve,
                ams_grid_parallel_solve,
                build_ams,
            )

            ams_data, _ = build_ams(
                prob.A, prob.aux["G"], params=None, Pi=prob.aux.get("Pi"),
                device=device,
            )
            if grid_mesh is not None:
                # the groups on the work model's shards, owned operator
                # storage, one correction sum a superstep
                res, _ = ams_grid_parallel_solve(
                    hier.levels[0].A, ams_data, grid_mesh, b, draws=draws, seed=opts.seed,
                    fire_prob=opts.fire_prob, sim_read_delay=opts.sim_read_delay,
                    tol=opts.tol, max_cycles=opts.num_cycles,
                )
            else:
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
                converge_test_type=opts.converge_test_type,
                **resolve_delays(opts, stats.num_levels),
                **accel_kw,
            )
            if grid_mesh is not None:
                # level -> shard-group parallelism (the structured
                # multi-device path row-shards and takes async_solve)
                from amg_tpu_torch.parallel.grid import grid_parallel_solve, plan_grid_levels

                _, levels_of, lscale = plan_grid_levels(
                    exp.hh, opts.num_devices, imbalance=opts.imbal,
                    smoothed_transfers=cfg.use_smoothed_transfers,
                    assign_policy=opts.assign_procs, assign_scalar=opts.assign_procs_scalar,
                )
                res = grid_parallel_solve(
                    hier, cfg, acfg, levels_of, lscale, grid_mesh, b, x0, draws=draws,
                    seed=opts.seed, tol=opts.tol, max_cycles=opts.num_cycles,
                )
            else:
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

            if opts.num_devices > 1:
                # the distributed Maxwell path: sharded AMS with halo comm
                from amg_tpu_torch.parallel.dist import make_row_mesh
                from amg_tpu_torch.solve.ams import build_sharded_ams, solve_sharded_ams_pcg

                mesh_a = mesh if mesh is not None else make_row_mesh(opts.num_devices, device)
                A_halo, ams, node_cfg, pad_e, _ = build_sharded_ams(
                    prob.A, prob.aux["G"], mesh_a)
                # the sharded solver pads b to its own layout and returns x
                # unpadded
                res = solve_sharded_ams_pcg(A_halo, ams, node_cfg, b_global, mesh_a, pad_e,
                                            tol=opts.tol, max_iters=opts.num_cycles)
                mesh = None
            else:
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
    if mesh is not None:
        from amg_tpu_torch.parallel.dist import unpad_vector

        # the global unpadded iterate (gathered across processes)
        stats.x = unpad_vector(res.x, exp.pad_info, mesh)
    if opts.rhs == "zeros" and opts.init_guess != "zeros":
        # zero-RHS experiment: the iterate is the error; the relative A-norm
        # error (the reference's e_Anorm / e0_Anorm)
        A_np = prob.A
        x_np = _host(stats.x).astype(np.float64)[: prob.n]
        x0_np = _host(x0_global).astype(np.float64)
        eA = float(np.sqrt(max(x_np @ (A_np @ x_np), 0.0)))
        e0A = float(np.sqrt(max(x0_np @ (A_np @ x0_np), 1e-300)))
        stats.e_anorm_rel = eA / e0A
    h = _host(res.history).astype(np.float64)
    stats.history = h[~np.isnan(h)].tolist()
    stats.grid_wait = gw
    if (
        opts.print_level_stats
        and opts.hierarchy in ("algebraic", "structured")
        # as in the reference, multi-device runs are not profiled (profile
        # a row-sharded hierarchy with utils.phases.profile_phases)
        and opts.num_devices <= 1
        and opts.solver in ("mult", "multadd", "afacx", "afacj", "bpx")
    ):
        # per-phase re-run of the production cycle, read from its spans
        from amg_tpu_torch.utils.phases import profile_phases

        stats.phase = profile_phases(
            hier, cfg, b, x0, num_cycles=min(max(stats.cycles, 1), 5)
        )
    return stats


def _halo_smoothing(exp: Experiment, A_s, sm_s, b, x0):
    """One-level async smoothing on num_devices shards: the reference's
    finest-grid halo channel, a plane exchange for a stencil whose leading
    axis divides into the shards (`parallel.halo`), a boundary-segment
    HaloELL where the row count does; (A, sm, b, x0, mesh) with A, sm, b and
    x0 this process's rows on the mesh, or unchanged with mesh None where
    neither divides (the reference stays on one device there too; said on
    stdout)."""
    from amg_tpu_torch.parallel.dist import make_row_mesh, shard_smoother

    opts, prob, device = exp.opts, exp.prob, exp.device
    D = opts.num_devices
    mesh = make_row_mesh(D, device)
    if prob.stencil is not None and prob.stencil.grid_shape[0] % D == 0:
        from amg_tpu_torch.parallel.halo import make_halo_stencil
        from amg_tpu_torch.sparse.stencil import StencilOperator

        st = prob.stencil
        A_h = make_halo_stencil(StencilOperator(
            weights=st.weights.to(device=device, dtype=exp.params.dtype),
            offsets=st.offsets, grid_shape=st.grid_shape), mesh)
    elif prob.n % D == 0:
        from amg_tpu_torch.parallel.spcomm import build_halo_ell

        A_h = build_halo_ell(prob.A, mesh, dtype=exp.params.dtype)
    else:
        print(f"warning: n={prob.n} not divisible by {D} devices -- one-level async "
              "smoothing runs on one device")
        return A_s, sm_s, b, x0, None
    if mesh.world_size > 1:
        sm_s = shard_smoother(sm_s, mesh)
    return A_h, sm_s, mesh.shard_vector(b), mesh.shard_vector(x0), mesh


def _fine_operator64(prob, hier):
    """mixed_solve's float64 fine operator: the problem's stencil in float64
    on the hierarchy's device where the hierarchy is a stencil one of
    another dtype (across processes in its level 0's sharded form), else
    level 0 itself."""
    from amg_tpu_torch.sparse.stencil import StencilOperator

    if hier.dtype == torch.float64 or prob.stencil is None:
        return hier.levels[0].A
    st = prob.stencil
    op = StencilOperator(weights=st.weights.to(device=hier.device, dtype=torch.float64),
                         offsets=st.offsets, grid_shape=st.grid_shape)
    if hier.mesh is not None and hier.mesh.world_size > 1:
        from amg_tpu_torch.parallel.dist import shard_structured_operator

        op = shard_structured_operator(op, hier.mesh)
    return op


def run_experiment(opts: SolverOptions, device=None, draws=None) -> SolveStats:
    """One run of the configured experiment on `device` (None: the CUDA
    device; raises without one): the problem, its hierarchy, the solve, the
    stats. `draws` replaces the async solver's draw source."""
    return solve_experiment(setup_experiment(opts, device), draws=draws)
