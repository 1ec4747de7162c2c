"""The Krylov layer of the PyTorch port's elasticity path
(amg_tpu_torch/solve/krylov.py::pcg, amg_tpu_torch/solve/mixed.py::mixed_pcg)
against the JAX package.

- `pcg` in float64 with the same V-cycle preconditioner on the same DIA
  hierarchy as JAX `krylov.pcg`: the same iteration count, x to 1e-10 in
  norm relative to ||x|| (the components span eight decades), the history to
  rtol 1e-8.
- `mixed_pcg` (float64 state and operator, float32 V(2,2) preconditioner)
  against JAX `mixed_pcg` (double-single state and operator pair on the
  CPU): the two differ in the Krylov arithmetic, so the same total iteration
  count +-1, both at or below tol in the float64 CSR residual, and x to 1e-6
  relative.
- `mixed_solve` (float64 refinement around one float32 cycle per step) on
  the generic 12^3 27-point hierarchy built in float32 by each package,
  against JAX `mixed_solve` (its float64 loop `_loop_f64`, the CPU route):
  the same cycle count, x to 1e-6 relative, the history to rtol 1e-4 (the
  float32 cycles sum in different orders).
"""

import numpy as np
import torch

import jax.numpy as jnp

from amg_tpu.problems.elasticity import elasticity_beam as jax_beam
from amg_tpu.setup import structured as jst
from amg_tpu.smooth import SmootherType as JaxSmoother
from amg_tpu.solve.cycles import CycleConfig as JaxCycleConfig
from amg_tpu.solve.cycles import CycleType as JaxCycleType
from amg_tpu.solve.cycles import cycle_step as jax_cycle_step
from amg_tpu.solve.krylov import pcg as jax_pcg
from amg_tpu.solve.mixed import mixed_pcg as jax_mixed_pcg
from amg_tpu.solve.mixed import mixed_solve as jax_mixed_solve

from amg_tpu_torch.problems.elasticity import elasticity_beam
from amg_tpu_torch.setup import structured as tst
from amg_tpu_torch.solve.cycles import CycleConfig, cycle_step
from amg_tpu_torch.solve.krylov import pcg
from amg_tpu_torch.solve.mixed import mixed_pcg, mixed_solve

from torch_parity import port_hierarchy, port_host_hierarchy

# one intra-op thread: the suite runs several worker processes at once, and
# idle OpenMP threads spinning in each would take cores from the others
torch.set_num_threads(1)


def test_pcg_matches_jax():
    prob = jax_beam(nx=24, ny=6, nz=6, bc="identity")
    _, jh = jst.build_dia_structured_hierarchy(prob.A, (25, 7, 7), num_functions=3)
    th = port_hierarchy(jh, dia=True)
    jcfg = JaxCycleConfig(cycle=JaxCycleType.MULT, smoother=JaxSmoother.L1_JACOBI,
                          num_pre_sweeps=2, num_post_sweeps=2)
    cfg = CycleConfig(num_pre_sweeps=2, num_post_sweeps=2)
    b = prob.rhs / np.linalg.norm(prob.rhs)
    A0j, A0t = jh.levels[0].A, th.levels[0].A
    want = jax_pcg(
        A0j.matvec, lambda r: jax_cycle_step(jh, jcfg, jnp.zeros_like(r), r),
        jnp.asarray(b), jnp.zeros(prob.n), tol=1e-6, max_iters=60,
    )
    got = pcg(
        A0t.matvec, lambda r: cycle_step(th, cfg, torch.zeros_like(r), r),
        torch.from_numpy(b), torch.zeros(prob.n, dtype=torch.float64), tol=1e-6, max_iters=60,
    )
    assert 0 < got.iters == int(want.iters) < 60
    assert float(got.rel_resnorm) <= 1e-6
    x_want = np.asarray(want.x)
    assert np.linalg.norm(got.x.numpy() - x_want) <= 1e-10 * np.linalg.norm(x_want)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(want.history),
                               rtol=1e-8, atol=1e-14)


def test_mixed_pcg_matches_jax():
    nx, ny, nz = 24, 6, 6
    kw = dict(nx=nx, ny=ny, nz=nz, bc="identity")
    nodes = (nx + 1, ny + 1, nz + 1)
    jprob = jax_beam(**kw)
    b = jprob.rhs / np.linalg.norm(jprob.rhs)
    pair = jst.csr_to_dia_stencil(jprob.A, jprob.grid_shape, jnp.float32, return_lo=True)
    _, jh = jst.build_dia_structured_hierarchy(jprob.A, nodes, num_functions=3, dtype=jnp.float32)
    jcfg = JaxCycleConfig(cycle=JaxCycleType.MULT, smoother=JaxSmoother.L1_JACOBI,
                          num_pre_sweeps=2, num_post_sweeps=2)
    want = jax_mixed_pcg(jh, pair, jcfg, jnp.asarray(b, jnp.float32), tol=1e-5, max_cycles=60)
    x_want = np.asarray(want.x, np.float64) + np.asarray(want.x_lo, np.float64)

    prob = elasticity_beam(**kw)
    _, th = tst.build_dia_structured_hierarchy(prob.A, nodes, num_functions=3,
                                               dtype=torch.float32, device="cpu")
    A64 = tst.DiaKernelOperator.from_var_stencil(tst.csr_to_dia_stencil(prob.A, prob.grid_shape))
    got = mixed_pcg(th, A64, CycleConfig(num_pre_sweeps=2, num_post_sweeps=2), b,
                    tol=1e-5, max_cycles=60, device="cpu")
    assert got.x.dtype == torch.float64
    assert abs(got.iters - int(want.iters)) <= 1
    for x in (got.x.numpy(), x_want):
        assert np.linalg.norm(b - prob.A @ x) / np.linalg.norm(b) <= 1e-5
    assert got.rel_resnorm <= 1e-5
    h = got.history_list()
    assert h[0] == 1.0 and h[-1] == got.rel_resnorm and len(h) >= 2
    assert np.linalg.norm(got.x.numpy() - x_want) <= 1e-6 * np.linalg.norm(x_want)


def test_mixed_solve_matches_jax():
    from amg_tpu.problems import laplacian_3d_27pt as jax_27pt
    from amg_tpu.setup.hierarchy import HierarchyParams as JaxParams
    from amg_tpu.setup.hierarchy import build_hierarchy as jax_build

    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, device_hierarchy

    jprob, prob = jax_27pt(12), laplacian_3d_27pt(12)
    b = np.random.default_rng(0).random(prob.n)
    hh, jh = jax_build(jprob.A, JaxParams(dtype=jnp.float32), fine_stencil=jprob.stencil)
    want = jax_mixed_solve(jh, jprob.stencil, JaxCycleConfig(), jnp.asarray(b), tol=1e-8)
    # the reference's host hierarchy carried across (the coarsening is
    # test_torch_amg_setup's), on the port's device in float32
    th = device_hierarchy(port_host_hierarchy(hh), HierarchyParams(dtype=torch.float32),
                          fine_stencil=prob.stencil, device="cpu")
    assert th.dtype == torch.float32
    got = mixed_solve(th, prob.stencil, CycleConfig(), b, tol=1e-8, device="cpu")
    assert got.x.dtype == torch.float64
    assert 0 < got.iters == int(want.iters) < 200
    assert got.rel_resnorm <= 1e-8
    x_want = np.asarray(want.x)
    assert np.linalg.norm(got.x.numpy() - x_want) <= 1e-6 * np.linalg.norm(x_want)
    h = np.asarray(want.history)
    np.testing.assert_allclose(got.history_list(), h[~np.isnan(h)], rtol=1e-4)
