"""The port's smoother family against the JAX package's, on the CPU in
float64: the setup data (scales, weights, block inverses with the "auto"
JGS weight) bit for bit, every smoother and `smooth_transpose` on a stencil
and an ELL operator to 1e-12 relative to the largest entry, GS against the
row-by-row Gauss-Seidel oracle, and the multiplicative V-cycle with every
smoother family, whose post-sweeps are the adjoint sweeps (hybrid JGS goes
back up with the backward block inverses).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amg_tpu.problems import laplacian_2d_5pt, laplacian_3d_27pt
from amg_tpu.problems.elasticity import elasticity_beam
from amg_tpu.setup import hierarchy as rhi
from amg_tpu.smooth import smoothers as rsm
from amg_tpu.solve.cycles import CycleConfig as RCfg
from amg_tpu.solve.cycles import mult_vcycle as r_vcycle
from amg_tpu.sparse.ell import ell_from_csr as r_ell
from amg_tpu_torch.problems import laplacian as plap
from amg_tpu_torch.setup.structured import (
    DiaKernelOperator,
    VarStencilOperator,
    csr_to_dia_stencil,
)
from amg_tpu_torch.smooth import smoothers as psm
from amg_tpu_torch.solve.cycles import CycleConfig as PCfg
from amg_tpu_torch.solve.cycles import mult_vcycle as p_vcycle
from amg_tpu_torch.sparse.csr import CSRMatrix
from amg_tpu_torch.sparse.ell import ell_from_csr as p_ell
from torch_parity import gs_scan_sweep, port_hierarchy

torch.set_num_threads(1)

TOL = 1e-12
SMOOTHERS = [s.value for s in psm.SmootherType]


def port_csr(m) -> CSRMatrix:
    return CSRMatrix(indptr=np.asarray(m.indptr), indices=np.asarray(m.indices),
                     data=np.asarray(m.data), shape=tuple(m.shape))


def close(got, want, tol=TOL):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-300), err


@pytest.mark.parametrize("jgs_weight", [None, "auto", 0.8])
@pytest.mark.parametrize("problem", ["27pt", "beam"])
@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_smoother_data_equals_the_reference(smoother, problem, jgs_weight):
    A = laplacian_3d_27pt(6).A if problem == "27pt" else elasticity_beam(24, 6, 0).A
    want = rsm.make_smoother_data(A, rsm.SmootherType(smoother), w=0.7, block_size=32,
                                  jgs_weight=jgs_weight)
    got = psm.make_smoother_data(port_csr(A), psm.SmootherType(smoother), w=0.7,
                                 block_size=32, jgs_weight=jgs_weight)
    for name in ("scale", "inv_wscale", "w", "block_inv", "block_inv_bwd"):
        if getattr(want, name) is None:
            assert name not in got
        else:
            np.testing.assert_array_equal(got[name], np.asarray(getattr(want, name)))


@pytest.fixture(scope="module")
def operators():
    """(port operator, reference operator, host CSR) pairs: the 27-point
    stencil at 8^3 and the ELL form of its first coarse level."""
    rprob, pprob = laplacian_3d_27pt(8), plap.laplacian_3d_27pt(8)
    A1 = rhi.build_host_hierarchy(rprob.A, rhi.HierarchyParams()).levels[1].A
    return {
        "stencil": (pprob.stencil, rprob.stencil, rprob.A),
        "ell": (p_ell(port_csr(A1)), r_ell(A1), A1),
    }


@pytest.mark.parametrize("op", ["stencil", "ell"])
@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_smooth_and_its_transpose_match(operators, op, smoother):
    A_p, A_r, csr = operators[op]
    kind = psm.SmootherType(smoother)
    sm_r = rsm.make_smoother_data(csr, rsm.SmootherType(smoother), w=0.6, block_size=64)
    sm_p = psm.smoother_data_from_arrays(
        psm.make_smoother_data(port_csr(csr), kind, w=0.6, block_size=64),
        torch.float64, "cpu")
    rng = np.random.default_rng(5)
    u, f = rng.random(csr.n_rows), rng.random(csr.n_rows)
    for fn_p, fn_r in ((psm.smooth, rsm.smooth), (psm.smooth_transpose, rsm.smooth_transpose)):
        for sweeps, zg in ((1, True), (2, False)):
            got = fn_p(A_p, sm_p, kind, torch.from_numpy(u), torch.from_numpy(f),
                       num_sweeps=sweeps, zero_guess=zg)
            want = fn_r(A_r, sm_r, rsm.SmootherType(smoother), jnp.asarray(u), jnp.asarray(f),
                        num_sweeps=sweeps, zero_guess=zg)
            close(got, want)


def test_gs_equals_the_row_by_row_sweep():
    """GS (one block spanning the matrix) is one exact Gauss-Seidel sweep:
    the port's GS, its row-by-row oracle and the reference's lax.scan one."""
    A = laplacian_2d_5pt(12).A
    rng = np.random.default_rng(6)
    u, f = rng.random(A.n_rows), rng.random(A.n_rows)
    kind = psm.SmootherType.GS
    sm = psm.smoother_data_from_arrays(psm.make_smoother_data(port_csr(A), kind),
                                       torch.float64, "cpu")
    ell = p_ell(port_csr(A))
    diag = torch.from_numpy(A.diagonal())
    tu, tf = torch.from_numpy(u), torch.from_numpy(f)
    got = psm.smooth(ell, sm, kind, tu, tf)
    oracle = gs_scan_sweep(ell, diag, tu, tf)
    close(got, oracle.numpy())
    close(oracle, rsm.gs_scan_sweep(r_ell(A), jnp.asarray(A.diagonal()), jnp.asarray(u),
                                    jnp.asarray(f)))


@pytest.mark.parametrize("smoother", ["hybrid_jgs", "gs"])
def test_block_smoothers_take_a_fused_residual(smoother):
    """On an operator with a `residual` method (the DIA operator of K5,
    plain version on the CPU) the block smoothers use it; the result is the
    plain operator's sweep."""
    prob = plap.laplacian_3d_7pt(6)
    vs = csr_to_dia_stencil(prob.A, prob.grid_shape)
    dia = DiaKernelOperator.from_var_stencil(vs)
    assert not hasattr(vs, "residual") and hasattr(dia, "residual")
    kind = psm.SmootherType(smoother)
    sm = psm.smoother_data_from_arrays(psm.make_smoother_data(prob.A, kind, block_size=32),
                                       torch.float64, "cpu")
    rng = np.random.default_rng(7)
    u, f = torch.from_numpy(rng.random(prob.n)), torch.from_numpy(rng.random(prob.n))
    for zg in (True, False):
        want = psm.smooth(vs, sm, kind, u, f, num_sweeps=2, zero_guess=zg)
        close(psm.smooth(dia, sm, kind, u, f, num_sweeps=2, zero_guess=zg), want.numpy())
    assert isinstance(vs, VarStencilOperator)


@pytest.mark.parametrize("sweeps", [(1, 1), (2, 1)])
@pytest.mark.parametrize("smoother", ["hybrid_jgs", "hybrid_jgs_backward", "gs", "sym_l1_jacobi",
                                      "jacobi"])
def test_mult_vcycle_equals_the_reference(smoother, sweeps):
    """One V-cycle on the reference's classical hierarchy (27-point 10^3)
    carried across: the hybrid JGS post-sweeps run the backward block
    inverses (smooth_transpose), as the reference's do."""
    prob = laplacian_3d_27pt(10)
    r_kind = rsm.SmootherType(smoother)
    hh, jh = rhi.build_hierarchy(prob.A, rhi.HierarchyParams(smoother=r_kind, block_size=64),
                                 fine_stencil=prob.stencil)
    th = port_hierarchy(jh, host=hh)
    pre, post = sweeps
    rng = np.random.default_rng(8)
    x, b = rng.random(prob.n), rng.random(prob.n)
    want = r_vcycle(jh, RCfg(smoother=r_kind, num_pre_sweeps=pre, num_post_sweeps=post),
                    jnp.asarray(x), jnp.asarray(b))
    got = p_vcycle(th, PCfg(smoother=psm.SmootherType(smoother), num_pre_sweeps=pre,
                            num_post_sweeps=post), torch.from_numpy(x), torch.from_numpy(b))
    close(got, want)
