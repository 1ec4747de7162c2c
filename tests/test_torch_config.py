"""The port's driver options, CLI parser, report formatting and checkpoints
against the JAX package's, on the CPU.

  * `SolverOptions.fixup()` equals the reference's field for field over a
    grid of solver x problem x accel x outer_solver x num_smooth_sweeps x
    delay_frac (every solver and problem name, and the aliases);
  * `build_parser().parse_args(argv)` gives the reference parser's
    namespace (the port's one flag of its own, `-device`, aside) for argvs
    that use every alias spelling;
  * `SolveStats.oneline()` and `print_report` print the reference's lines
    for the same stats, and `PhaseReport.print_table` its table;
  * the checkpoint round-trip, and a resume from it that continues the
    uninterrupted solve's iterates and history.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from amg_tpu.utils import cli as rcli
from amg_tpu.utils import config as rconfig
from amg_tpu.utils import phases as rphases
from amg_tpu.utils import stats as rstats
from amg_tpu_torch.utils import cli, config, phases, stats
from amg_tpu_torch.utils.checkpoint import load_solve_state, save_solve_state

torch.set_num_threads(1)


def test_the_option_vocabulary_is_the_reference_s():
    assert config.ALL_SOLVERS == rconfig.ALL_SOLVERS
    assert config.SMOOTHERS == rconfig.SMOOTHERS
    assert config.PROBLEMS == rconfig.PROBLEMS
    assert config.EXT_SOLVERS == rconfig.EXT_SOLVERS
    assert dataclasses.asdict(config.SolverOptions()) == \
        dataclasses.asdict(rconfig.SolverOptions())


@pytest.mark.parametrize("solver", config.ALL_SOLVERS)
def test_fixup_equals_the_reference_s(solver):
    grid = itertools.product(config.PROBLEMS, ("none", "cheby", "richardson"),
                             ("none", "pcg", "ams_pcg"), (0, 3), (0.0, 0.5))
    for problem, accel, outer, sweeps, frac in grid:
        kw = dict(solver=solver, problem=problem, accel=accel, outer_solver=outer,
                  num_smooth_sweeps=sweeps, delay_frac=frac, nz=2 * sweeps)
        got = config.SolverOptions(**kw).fixup()
        want = rconfig.SolverOptions(**kw).fixup()
        assert dataclasses.asdict(got) == dataclasses.asdict(want), kw
        assert got.is_async() == want.is_async()
        assert got.grid_dims() == want.grid_dims()


ARGVS = {
    "defaults": [],
    "aliases": ["-vardifconv_eps", "0.3", "-num_func", "3", "-cheby_eig_max_iters", "7",
                "-delay_one", "-fail_one", "4", "-multiple_interpolants", "-problem",
                "vardifconv", "-n", "12"],
    "more aliases": ["-num_funcs", "2", "-eig_power_max_iters", "9", "-delay_all",
                     "-cheby_eig", "hypre_lobpcg", "-solver", "async_iebpx"],
    "setup flags": ["-th", "0.5", "-coarsen", "pmis", "-interp", "direct", "-Pmax", "2",
                    "-trunc", "0.1", "-mxl", "4", "-agg_nl", "1", "-max_coarse", "20",
                    "-smooth_weight", "0.7", "-block_size", "64", "-seed", "3",
                    "-mat_file", "m.bin", "-include_disconnected_points"],
    "async flags": ["-solver", "async_multadd", "-async_type", "semi", "-read_type", "res",
                    "-sim_read_delay", "2", "-fire_prob", "0.7", "-sim_grid_wait", "3",
                    "-res_update_type", "accumulate", "-async_comm_save_divisor", "2",
                    "-converge_test_type", "local", "-delay_levels", "1", "2",
                    "-delay_prob", "0.2", "-delay_some", "0.25", "-fail_level", "1",
                    "-fail_start", "2", "-fail_duration", "3"],
    "solve flags": ["-problem", "27pt", "-nx", "4", "-ny", "5", "-nz", "6", "-hierarchy",
                    "structured", "-mixed_precision", "-smoother", "hybrid_jgs",
                    "-num_cycles", "7", "-tol", "1e-6", "-no_resnorm",
                    "-num_smooth_sweeps", "2", "-accel", "cheby", "-cheby_grid", "1",
                    "-outer_solver", "pcg", "-device_format", "dia", "-setup_type", "sa",
                    "-ax", "2", "-cz", "0.5", "-rhs", "ones", "-init_guess", "rand"],
    "output flags": ["-print_reshist", "-oneline_output", "-print_level_stats",
                     "-print_grid_wait", "-background_program", "-num_devices", "2",
                     "-no_grid_parallel", "-comm", "gspmd", "-imbal", "0.1",
                     "-assign_procs", "scalar", "-assign_procs_scalar", "0.3",
                     "-only_setup", "-only_build_matrix", "-print_matrix", "a.bin",
                     "-num_runs", "3", "-warmup", "-start_num_iters", "2",
                     "-incr_num_iters", "2", "-max_num_iters", "6"],
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_the_parser_equals_the_reference_s(name):
    argv = ARGVS[name]
    got = vars(cli.build_parser().parse_args(argv))
    want = vars(rcli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    assert vars(cli.build_parser().parse_args(argv + ["-device", "cpu"]))["device"] == "cpu"


def _stats(mod, **kw):
    kw = dict(dict(problem="27pt", solver="async_multadd", smoother="l1_jacobi", n=1728,
                   nnz=42875, num_levels=3, operator_complexity=1.3456789,
                   setup_wtime=0.1234567, solve_wtime=2.3456789, cycles=4,
                   rel_resnorm=3.2e-9, history=[1.0, 0.5, 0.04, 3e-6, 3.2e-9],
                   level_n=[1728, 216, 62], level_nnz=[42875, 5000, 900],
                   grid_wait={"mean": [1.5, 2.0, 0.25], "min": [0, 1, 0],
                              "max": [3, 4, 1], "num_correct": [10, 9, 8]}), **kw)
    return mod.SolveStats(**kw)


REPORTS = {
    "oneline": dict(oneline_output=True),
    "report": dict(),
    "report with history and waits": dict(print_reshist=True, print_grid_wait=True),
    "level stats": dict(print_level_stats=True),
    "zero rhs": dict(print_reshist=True),
}


@pytest.mark.parametrize("name", list(REPORTS))
def test_reports_print_the_reference_s_lines(name, capsys):
    kw = REPORTS[name]
    extra = {"e_anorm_rel": 1.25e-7} if name == "zero rhs" else {}
    for mod, cfg in ((stats, config), (rstats, rconfig)):
        _stats(mod, **extra).print_report(cfg.SolverOptions(**kw))
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert len(out) == 2 * half and half > 0
    assert out[:half] == out[half:]
    s = _stats(stats, cycles=0, history=[1.0])
    assert s.oneline() == _stats(rstats, cycles=0, history=[1.0]).oneline()
    assert s.convergence_factor() == 0.0


def test_the_phase_table_prints_the_reference_s(capsys):
    kw = dict(num_levels=3, cycles=5, smooth=[0.5, 0.25, 0.125], residual=[0.1, 0.2, 0.0],
              restrict=[0.01, 0.02, 0.0], prolong=[0.03, 0.04, 0.0], coarse=0.007,
              vecop=0.0, comm_bytes=[0, 0, 0], comm_msgs=[0, 0, 0])
    got, want = phases.PhaseReport(**kw), rphases.PhaseReport(**kw)
    assert got.totals() == want.totals()
    got.print_table()
    want.print_table()
    out = capsys.readouterr().out.splitlines()
    assert out[: len(out) // 2] == out[len(out) // 2:]


def test_checkpoint_round_trip_and_resume(tmp_path):
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu_torch.solve.cycles import CycleConfig
    from amg_tpu_torch.solve.driver import solve

    prob = laplacian_3d_27pt(10)
    _, hier = build_hierarchy(prob.A, HierarchyParams(), fine_stencil=prob.stencil,
                              device="cpu")
    b = torch.from_numpy(np.random.default_rng(0).random(prob.n))
    cfg = CycleConfig()
    whole = solve(hier, cfg, b, tol=0.0, max_cycles=8, device="cpu")
    first = solve(hier, cfg, b, tol=0.0, max_cycles=3, device="cpu")
    path = str(tmp_path / "state.npz")
    save_solve_state(path, first.x, b, iters=first.iters, history=first.history,
                     meta={"problem": "27pt", "n": 10})
    st = load_solve_state(path)
    assert st["iters"] == 3 and st["meta"] == {"problem": "27pt", "n": 10}
    assert np.array_equal(st["x"], first.x.numpy()) and np.array_equal(st["b"], b.numpy())
    np.testing.assert_array_equal(st["history"], first.history.numpy())
    rest = solve(hier, cfg, torch.from_numpy(st["b"]), torch.from_numpy(st["x"]), tol=0.0,
                 max_cycles=5, device="cpu")
    np.testing.assert_allclose(rest.x.numpy(), whole.x.numpy(), rtol=1e-12, atol=1e-14)
    # the resumed history, relative to its own start, continues the whole one
    h_rest = np.asarray(rest.history_list()) * st["history"][3]
    np.testing.assert_allclose(h_rest, whole.history_list()[3:], rtol=1e-10)
