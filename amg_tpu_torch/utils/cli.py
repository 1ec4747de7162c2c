"""Command-line driver (counterpart of amg_tpu/utils/cli.py), with the
reference's flag vocabulary.

Usage:  python -m amg_tpu_torch.utils.cli -problem 27pt -n 32 -solver multadd \
            -smoother l1_jacobi -tol 1e-8 -num_cycles 100 -print_reshist
        python -m amg_tpu_torch.utils.cli -device cpu -problem 5pt -n 32 -oneline_output

Flag names follow the reference drivers (single-dash long names, reference:
src/SMEM_Main.cpp:120-628, src/DMEM_Main.cpp:161-710). One flag is the
port's own: `-device` (default "cuda"; "cpu" runs the plain PyTorch path),
where the reference picks its backend from the environment.
"""

from __future__ import annotations

import argparse

from amg_tpu_torch.utils.config import ALL_SOLVERS, PROBLEMS, SMOOTHERS, SolverOptions
from amg_tpu_torch.utils.runner import run_experiment


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="amg_tpu_torch", prefix_chars="-",
        description="async multigrid solver driver (PyTorch/CUDA)",
    )
    d = SolverOptions()
    a = p.add_argument
    a("-problem", default=d.problem, choices=PROBLEMS)
    a("-n", type=int, default=d.n)
    a("-nx", type=int, default=d.nx)
    a("-ny", type=int, default=d.ny)
    a("-nz", type=int, default=d.nz)
    # -vardifconv_eps is the reference's spelling for the same coefficient
    # on the vardifconv problem (src/DMEM_Main.cpp)
    a("-eps", "-vardifconv_eps", type=float, default=d.eps)
    a("-difconv_atype", type=int, default=d.difconv_atype)
    a("-mat_file", dest="matrix_file", default=d.matrix_file)
    # -num_func/-num_funcs are the reference drivers' spellings
    a("-num_functions", "-num_func", "-num_funcs", type=int,
      default=d.num_functions)
    # reference -include_disconnected_points: despite the name, the flag
    # ENABLES the disconnected-row removal/renumber pass on file matrices
    # (src/DMEM_BuildMatrix.cpp:1284-1310, default off DMEM_Main.cpp:128)
    a("-include_disconnected_points", action="store_true")
    a("-sigma", type=float, default=d.sigma)
    a("-elast_bc", default=d.elast_bc, choices=("reduce", "identity"))
    a("-grading", type=float, default=d.grading)
    a("-amr_rounds", type=int, default=d.amr_rounds)
    a("-amr_theta", type=float, default=d.amr_theta)
    a("-hierarchy", default=d.hierarchy, choices=("algebraic", "structured"))
    a("-mixed_precision", action="store_true")
    a("-th", dest="strong_threshold", type=float, default=d.strong_threshold)
    a("-coarsen", dest="coarsen_type", default=d.coarsen_type,
      choices=("pmis", "hmis", "hmis_exact"))
    a("-interp", dest="interp_type", default=d.interp_type,
      choices=("direct", "ext+i"))
    a("-Pmax", dest="p_max_elmts", type=int, default=d.p_max_elmts)
    a("-trunc", dest="trunc_factor", type=float, default=d.trunc_factor)
    a("-mxl", dest="max_levels", type=int, default=d.max_levels)
    a("-agg_nl", type=int, default=d.agg_nl)
    a("-max_coarse", dest="max_coarse_size", type=int, default=d.max_coarse_size)
    a("-smooth_weight", type=float, default=None)
    a("-block_size", type=int, default=d.block_size)
    a("-seed", type=int, default=d.seed)
    a("-solver", default=d.solver, choices=ALL_SOLVERS)
    a("-smoother", default=d.smoother, choices=SMOOTHERS)
    a("-num_cycles", type=int, default=d.num_cycles)
    a("-tol", type=float, default=d.tol)
    a("-no_resnorm", action="store_true")
    a("-num_pre_smooth_sweeps", type=int, default=d.num_pre_smooth_sweeps)
    a("-num_post_smooth_sweeps", type=int, default=d.num_post_smooth_sweeps)
    a("-num_fine_smooth_sweeps", type=int, default=d.num_fine_smooth_sweeps)
    a("-num_coarse_smooth_sweeps", type=int, default=d.num_coarse_smooth_sweeps)
    a("-num_add_smooth_sweeps", type=int, default=d.num_add_smooth_sweeps)
    # reference -num_smooth_sweeps: one value for pre/post/fine/coarse
    # (src/DMEM_Main.cpp:489-497)
    a("-num_smooth_sweeps", type=int, default=d.num_smooth_sweeps)
    a("-coarsest_mult_level", type=int, default=d.coarsest_mult_level)
    a("-afacj_level", type=int, default=d.afacj_level)
    a("-add_tr", type=float, default=d.add_tr)
    a("-num_inner_cycles", type=int, default=d.num_inner_cycles)
    a("-simple_jacobi", action="store_true")
    a("-multiple_interpolants", dest="one_interpolant", action="store_false")
    a("-accel", default=d.accel, choices=("none", "cheby", "richardson"))
    a("-cheby_grid", type=int, default=d.cheby_grid)
    a("-outer_solver", default=d.outer_solver,
      choices=("none", "pcg", "ams_pcg"))
    a("-setup_type", default=d.setup_type,
      choices=("auto", "classical", "sa"))
    a("-device_format", default=d.device_format,
      choices=("ell", "bsr", "auto", "dia"))
    a("-cheby_power_iters", "-cheby_eig_max_iters", "-eig_power_max_iters",
      type=int, default=d.cheby_power_iters)
    # reference spelling kept: hypre_lobpcg/slepc map onto the native
    # estimators (src/SMEM_Main.cpp:606-618)
    a("-cheby_eig", default=d.cheby_eig,
      choices=("power", "lobpcg", "lanczos", "hypre_lobpcg", "slepc"))
    a("-async_type", default=d.async_type, choices=("full", "semi"))
    a("-read_type", default=d.read_type, choices=("sol", "res"))
    a("-sim_read_delay", type=int, default=d.sim_read_delay)
    a("-fire_prob", type=float, default=d.fire_prob)
    a("-sim_grid_wait", type=int, default=d.sim_grid_wait)
    a("-res_update_type", default=d.res_update_type,
      choices=("recompute", "accumulate"))
    a("-async_comm_save_divisor", type=int,
      default=d.async_comm_save_divisor)
    a("-converge_test_type", default=d.converge_test_type,
      choices=("global", "local"))
    a("-delay_levels", type=int, nargs="*", default=[])
    a("-delay_prob", type=float, default=d.delay_prob)
    # reference delay-selection flags (src/SMEM_Main.cpp:572-596): -delay_one
    # delays the LAST worker (here: the last level group), -delay_all every
    # group, -delay_some a random fraction; the slowdown magnitude is our
    # -delay_prob (the reference's usec sleep has no wall-clock analog in a
    # superstep model)
    a("-delay_one", dest="delay_type", action="store_const", const="one",
      default=d.delay_type)
    a("-delay_all", dest="delay_type", action="store_const", const="all")
    a("-delay_some", dest="delay_frac", type=float, default=d.delay_frac)
    # -fail_one <iter>: the last level group misses exactly one firing at
    # the given cycle (reference FAIL_ONE, src/SMEM_Solve.cpp:129-136)
    a("-fail_one", dest="fail_iter", type=int, default=d.fail_iter)
    a("-fail_level", type=int, default=d.fail_level)
    a("-fail_start", type=int, default=d.fail_start)
    a("-fail_duration", type=int, default=d.fail_duration)
    a("-sps_method", default=d.sps_method,
      choices=("fixed", "southwell_exp", "southwell_inv"))
    a("-sps_alpha", type=float, default=d.sps_alpha)
    a("-sps_min_prob", type=float, default=d.sps_min_prob)
    for f in ("ax", "ay", "az", "cx", "cy", "cz"):
        a(f"-{f}", type=float, default=getattr(d, f))
    a("-num_blocks", type=int, default=d.num_blocks)
    a("-rhs", default=d.rhs, choices=("rand", "ones", "zeros"))
    a("-init_guess", default=d.init_guess, choices=("rand", "ones", "zeros"))
    a("-print_reshist", action="store_true")
    a("-oneline_output", action="store_true")
    a("-print_level_stats", action="store_true")
    a("-print_grid_wait", action="store_true")
    a("-background_program", action="store_true")
    a("-num_devices", type=int, default=d.num_devices)
    a("-no_grid_parallel", dest="grid_parallel", action="store_false")
    a("-comm", default=d.comm, choices=("halo", "gspmd"))
    a("-imbal", type=float, default=d.imbal)
    a("-assign_procs", default=d.assign_procs, choices=("balanced", "scalar"))
    a("-assign_procs_scalar", type=float, default=d.assign_procs_scalar)
    a("-only_setup", action="store_true")
    a("-only_build_matrix", action="store_true")
    a("-print_matrix", default=d.print_matrix)
    a("-num_runs", type=int, default=d.num_runs)
    a("-warmup", action="store_true")
    a("-start_num_iters", type=int, default=d.start_num_iters)
    a("-incr_num_iters", type=int, default=d.incr_num_iters)
    a("-max_num_iters", type=int, default=d.max_num_iters)
    # the port's one flag of its own: the solve device
    a("-device", default="cuda")
    return p


def main(argv=None) -> int:
    import dataclasses

    args = vars(build_parser().parse_args(argv))
    device = args.pop("device")
    opts = SolverOptions(**{k: (tuple(v) if isinstance(v, list) else v)
                            for k, v in args.items()})
    if opts.max_num_iters > 0:
        # iteration-sweep harness: time fixed cycle counts num_cycles =
        # start, start+incr, ..., max (reference: src/SMEM_Main.cpp:694,
        # `for (num_iters = start_num_iters; num_iters <= max_num_iters;
        # num_iters += incr_num_iters)` with num_cycles = num_iters)
        start = opts.start_num_iters if opts.start_num_iters > 0 \
            else opts.max_num_iters
        sweep = range(start, opts.max_num_iters + 1,
                      max(opts.incr_num_iters, 1))
    else:
        sweep = [opts.num_cycles]
    if opts.warmup:
        # one discarded run before the timed ones (reference -warmup,
        # src/SMEM_Main.cpp:691-693: num_runs++ and run 1 is skipped in the
        # stats); it also absorbs the kernels' first-use build
        run_experiment(opts, device=device)
    for num_iters in sweep:
        o = dataclasses.replace(opts, num_cycles=num_iters)
        if opts.max_num_iters > 0:
            print(f"=== num_cycles = {num_iters} ===")
        runs = []
        for i in range(o.num_runs):
            stats = run_experiment(o, device=device)
            stats.print_report(o)
            runs.append(stats)
        if o.num_runs > 1:
            # mean/min/max aggregation over runs (reference: PrintOutput,
            # src/Misc.cpp:6-214 aggregates per-thread and per-run timers)
            import numpy as _np

            def agg(vals):
                v = _np.asarray(vals, dtype=float)
                return f"{v.mean():.6g} / {v.min():.6g} / {v.max():.6g}"

            print(f"=== aggregate over {o.num_runs} runs (mean/min/max) ===")
            print(f"solve wtime    : {agg([s.solve_wtime for s in runs])}")
            print(f"setup wtime    : {agg([s.setup_wtime for s in runs])}")
            print(f"cycles         : {agg([s.cycles for s in runs])}")
            print(f"rel res 2-norm : {agg([s.rel_resnorm for s in runs])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
