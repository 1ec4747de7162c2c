#!/usr/bin/env python3
"""The JAX package's own `run_experiment` results on the runner branches that
the goldens do not cover, for `tests/test_torch_runner.py`; writes
`tools/torch_runner_reference.json`.

    JAX_PLATFORMS=cpu python3 tools/torch_runner_reference.py [--out PATH]

Runs the reference's runner on the CPU in float64 (its native setup library
must load) for each case of CASES, and records the case's options and the
stats: n, nnz, the level sizes, the cycle count, the residual history,
rel_res, the A-norm error of zero-RHS runs and the grid-wait summary of
the async runs. The async cases run on the reference's own draws for
PRNGKey(seed), which the test replays into the port
(`tests/torch_parity.py`). The "file" cases read a matrix that the
reference's runner writes first with -print_matrix (the 7-point Laplacian
at 10^3); the test writes its own through the port. About a minute.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tools", "torch_runner_reference.json")

# the matrix the "file" cases read: written by -print_matrix
FILE_SOURCE = {"problem": "7pt", "n": 10, "only_build_matrix": True}

# name: SolverOptions keywords (a "file" case's matrix_file is filled in)
CASES = {
    "struct 27pt 16": {"problem": "27pt", "n": 16, "hierarchy": "structured"},
    "struct 27pt 16 jacobi v22": {"problem": "27pt", "n": 16, "hierarchy": "structured",
                                  "smoother": "jacobi", "num_smooth_sweeps": 2},
    "difconv upwind": {"problem": "difconv", "n": 12, "difconv_atype": 2, "cx": 2.0,
                       "cz": 0.5, "ay": -3.0, "eps": 0.5},
    "difconv centered structured": {"problem": "difconv", "n": 15, "difconv_atype": 3,
                                    "hierarchy": "structured"},
    "vardifconv structured": {"problem": "vardifconv", "n": 12, "hierarchy": "structured"},
    "vardifconv algebraic": {"problem": "vardifconv", "n": 12, "seed": 3},
    "vardifconv dia": {"problem": "vardifconv", "n": 12, "device_format": "dia"},
    "graded": {"problem": "graded", "n": 24, "grading": 2.0},
    "amr": {"problem": "amr", "n": 8, "amr_rounds": 2},
    "file": {"problem": "file"},
    "file disconnected": {"problem": "file", "include_disconnected_points": True,
                          "solver": "mult", "smoother": "jacobi", "accel": "cheby"},
    "mixed stencil": {"problem": "27pt", "n": 16, "hierarchy": "structured",
                      "mixed_precision": True},
    "mixed algebraic": {"problem": "7pt", "n": 12, "mixed_precision": True},
    "async_smooth": {"problem": "5pt", "n": 24, "solver": "async_smooth", "seed": 2},
    "implicit_ext_bpx": {"problem": "5pt", "n": 24, "solver": "implicit_ext_bpx",
                         "num_cycles": 60},
    "async_implicit_ext_bpx": {"problem": "5pt", "n": 24, "solver": "async_implicit_ext_bpx",
                               "num_cycles": 60, "seed": 1},
    "async_ams": {"problem": "maxwell", "nx": 4, "solver": "async_ams", "tol": 1e-6},
    "async delay_one": {"problem": "5pt", "n": 16, "solver": "async_multadd",
                        "delay_type": "one", "delay_prob": 0.3},
    "async delay_all semi": {"problem": "5pt", "n": 16, "solver": "async_multadd",
                             "delay_type": "all", "async_type": "semi", "seed": 1},
    "async delay_some": {"problem": "5pt", "n": 16, "solver": "async_multadd",
                         "delay_frac": 0.5, "seed": 4},
    "async fail_one": {"problem": "5pt", "n": 16, "solver": "async_multadd",
                       "fail_iter": 3, "async_type": "semi"},
    "async local cheby": {"problem": "5pt", "n": 16, "solver": "async_multadd",
                          "converge_test_type": "local", "accel": "cheby"},
    "no_resnorm": {"problem": "27pt", "n": 12, "no_resnorm": True, "num_cycles": 5},
    "zero rhs": {"problem": "27pt", "n": 12, "rhs": "zeros", "init_guess": "rand"},
    "only_setup": {"problem": "27pt", "n": 12, "only_setup": True},
    "only_build_matrix": {"problem": "27pt", "n": 12, "only_build_matrix": True},
}


def record(st) -> dict:
    return {
        "n": st.n, "nnz": st.nnz, "num_levels": st.num_levels,
        "operator_complexity": st.operator_complexity,
        "level_n": list(st.level_n), "level_nnz": list(st.level_nnz),
        "cycles": st.cycles, "rel_res": st.rel_resnorm, "history": list(st.history),
        "e_anorm_rel": st.e_anorm_rel, "grid_wait": st.grid_wait,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    from amg_tpu.utils.config import SolverOptions
    from amg_tpu.utils.runner import run_experiment

    out = {"file_source": FILE_SOURCE, "cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.bin")
        run_experiment(SolverOptions(**FILE_SOURCE, print_matrix=path))
        for name, cfg in CASES.items():
            t0 = time.perf_counter()
            kw = dict(cfg, matrix_file=path) if cfg["problem"] == "file" else cfg
            st = run_experiment(SolverOptions(**kw))
            out["cases"][name] = {"config": cfg, **record(st)}
            print(f"{name}: {st.cycles} cycles, rel_res {st.rel_resnorm:.4e}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
