"""The port's `run_experiment` against the JAX package's, on the CPU in
float64, for the runner branches that the goldens do not cover.

The reference's runs are recorded once in `tools/torch_runner_reference.json`
(`JAX_PLATFORMS=cpu python3 tools/torch_runner_reference.py`), so this file
runs no JAX solve: each case's options go through the port's
`run_experiment(opts, device="cpu")`, the async cases under the
reference's own draws for PRNGKey(seed), replayed (tests/torch_parity.py).
Held: n, nnz, the level sizes and count, the operator complexity (1e-12),
the cycle count, the history and rel_res (rtol 1e-10, atol 1e-14: the
goldens' tolerance), the zero-RHS A-norm error (1e-10) and the async
grid-wait summary exactly. The float32 hierarchy of `-mixed_precision`
with a stencil (its cycles in float32, refined in float64) is held by its
count within one and its first five history entries to 1e-5.

The branches: the structured hierarchy on the CPU (the reference's CPU
branch: `driver.solve`, not the fused kernels), difconv (upwind,
anisotropic, signed convection; centered on the structured hierarchy),
vardifconv structured (DIA hierarchy) and algebraic (CSR, and the DIA
fine operator of `-device_format dia`), graded, amr and file (a matrix the
port writes with `-print_matrix`; with the disconnected-row pass),
`-mixed_precision` on a stencil problem and on the algebraic path,
async_smooth, implicit_ext_bpx and async_implicit_ext_bpx, async_ams, the
delay policies (`-delay_one`, `-delay_all`, `-delay_some`), `-fail_one`,
local convergence with Chebyshev, `-no_resnorm`, the zero-RHS A-norm error,
`-only_setup` and `-only_build_matrix`.
"""

import json
import os

import numpy as np
import pytest
import torch

import amg_tpu  # noqa: F401  (turns on jax x64: the replayed draws are the reference's)
from amg_tpu_torch.utils.config import SolverOptions
from amg_tpu_torch.utils.runner import run_experiment
from torch_parity import JaxAMSDraws, JaxAsyncDraws, JaxExtDraws, JaxSmoothDraws

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tools", "torch_runner_reference.json")) as _f:
    REF = json.load(_f)
HIST = dict(rtol=1e-10, atol=1e-14)
# the float32 cycles of -mixed_precision on a stencil problem
FLOAT32_CASES = ("mixed stencil",)


def draws_for(cfg):
    """The reference's draws for PRNGKey(seed), for the async solver of cfg."""
    solver, seed = cfg.get("solver", "mult"), cfg.get("seed", 0)
    if solver == "async_smooth":
        return JaxSmoothDraws(seed)
    if solver.endswith("ext_bpx"):
        return JaxExtDraws(seed)
    if solver == "async_ams":
        return JaxAMSDraws(seed)
    if solver.startswith("async_"):
        return JaxAsyncDraws(seed)
    return None


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    """The file cases' matrix, written by the port's -print_matrix."""
    path = str(tmp_path_factory.mktemp("runner") / "a.bin")
    st = run_experiment(SolverOptions(**REF["file_source"], print_matrix=path), device="cpu")
    assert st.cycles == 0 and st.n == 1000 and os.path.getsize(path) == 16 * (st.nnz + 1)
    return path


@pytest.mark.parametrize("name", list(REF["cases"]))
def test_run_experiment_matches_the_reference(name, matrix_file):
    want = REF["cases"][name]
    cfg = dict(want["config"])
    if cfg["problem"] == "file":
        cfg["matrix_file"] = matrix_file
    got = run_experiment(SolverOptions(**cfg), device="cpu", draws=draws_for(cfg))
    assert (got.n, got.nnz) == (want["n"], want["nnz"])
    assert got.num_levels == want["num_levels"]
    assert got.level_n == want["level_n"] and got.level_nnz == want["level_nnz"]
    np.testing.assert_allclose(got.operator_complexity, want["operator_complexity"],
                               rtol=1e-12)
    if name in FLOAT32_CASES:
        assert abs(got.cycles - want["cycles"]) <= 1
        assert got.rel_resnorm <= cfg.get("tol", 1e-8)
        np.testing.assert_allclose(got.history[:5], want["history"][:5], rtol=1e-5)
        return
    assert got.cycles == want["cycles"]
    np.testing.assert_allclose(np.asarray(got.history), np.asarray(want["history"]), **HIST)
    np.testing.assert_allclose(got.rel_resnorm, want["rel_res"], **HIST)
    if want["e_anorm_rel"] is None:
        assert got.e_anorm_rel is None
    else:
        np.testing.assert_allclose(got.e_anorm_rel, want["e_anorm_rel"], rtol=1e-10)
    assert got.grid_wait == want["grid_wait"]
    if want["cycles"]:
        assert got.x.device.type == "cpu" and got.x.shape == (got.n,)
