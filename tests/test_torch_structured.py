"""Host setup and generic V-cycle of the PyTorch port against the JAX package:
the structured hierarchy builder (amg_tpu_torch/setup/structured.py), the
problem generators, the structured transfers and `mult_vcycle`
(amg_tpu_torch/solve/cycles.py) on a hierarchy carried across by
amg_tpu_torch/convert.py.

Everything runs in float64 on the CPU; tolerances are 1e-12 (relative to the
largest entry where the values are O(10)), the rounding of a few dozen float64
operations in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu.problems import laplacian_3d_27pt as jax_27pt
from amg_tpu.setup.structured import VarStencilOperator as JaxVar
from amg_tpu.setup.structured import build_structured_hierarchy as jax_build
from amg_tpu.smooth import SmootherType as JaxSmoother
from amg_tpu.solve.cycles import CycleConfig as JaxCycleConfig
from amg_tpu.solve.cycles import CycleType as JaxCycleType
from amg_tpu.solve.cycles import mult_vcycle as jax_mult_vcycle
from amg_tpu.sparse.stencil import StencilOperator as JaxStencil

from amg_tpu_torch.problems.laplacian import laplacian_3d_7pt, laplacian_3d_27pt
from amg_tpu_torch.setup.structured import (
    StructuredProlong,
    StructuredRestrict,
    VarStencilOperator,
    build_structured_hierarchy,
)
from amg_tpu_torch.smooth.smoothers import SmootherType
from amg_tpu_torch.solve.cycles import CycleConfig, mult_vcycle
from amg_tpu_torch.sparse.stencil import StencilOperator

from torch_parity import port_hierarchy

# one intra-op thread: the suite runs several worker processes at once, and
# idle OpenMP threads spinning in each would take cores from the others
torch.set_num_threads(1)


def _close(got, want, tol=1e-12):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


BUILDS = [(16, "auto", "L1_JACOBI"), (40, "auto", "L1_JACOBI"),
          (40, "const", "L1_JACOBI"), (16, "auto", "JACOBI")]


@pytest.mark.parametrize("n,coarse_op,smoother", BUILDS, ids=str)
def test_hierarchy_matches_jax(n, coarse_op, smoother):
    _, jh = jax_build(
        jax_27pt(n).stencil, smoother=getattr(JaxSmoother, smoother),
        dtype=jnp.float64, coarse_op=coarse_op,
    )
    hh, th = build_structured_hierarchy(
        laplacian_3d_27pt(n).stencil, smoother=getattr(SmootherType, smoother),
        dtype=torch.float64, coarse_op=coarse_op, device="cpu",
    )
    assert th.num_levels == jh.num_levels == hh.num_levels
    for jl, tl in zip(jh.levels, th.levels):
        assert tl.A.grid_shape == tuple(jl.A.grid_shape)
        assert tuple(tl.A.offsets) == tuple(tuple(o) for o in jl.A.offsets)
        # the const-vs-var decision
        if isinstance(jl.A, JaxStencil):
            assert isinstance(tl.A, StencilOperator)
            _close(tl.A.weights, jl.A.weights)
        else:
            assert isinstance(jl.A, JaxVar) and isinstance(tl.A, VarStencilOperator)
            _close(tl.A.coeffs, jl.A.coeffs)
        _close(tl.sm.scale, jl.sm.scale)
        _close(tl.sm.inv_wscale, jl.sm.inv_wscale)
        _close(tl.sm.w, jl.sm.w)
        assert (tl.R is None) == (jl.R is None)
        if tl.R is not None:
            assert (tl.R.fine_shape, tl.R.coarse_shape) == (
                tuple(jl.R.fine_shape), tuple(jl.R.coarse_shape))
    _close(th.coarse_Ainv, jh.coarse_Ainv)


def test_auto_gates_const_by_coarse_side():
    """coarse_op='auto' stores constant stencils on levels with min side >=
    32 only: at 64^3 the 32^3 level is constant and the 16^3 level exact."""
    _, th = build_structured_hierarchy(laplacian_3d_27pt(64).stencil, device="cpu")
    kinds = [type(lv.A) for lv in th.levels]
    assert kinds[:3] == [StencilOperator, StencilOperator, VarStencilOperator]


@pytest.mark.parametrize(
    "make", [lambda m: m.laplacian_3d_27pt(5, 6, 7),
             lambda m: m.laplacian_3d_7pt(6, 5, 4, cx=1.0, cy=2.0, cz=0.5)],
    ids=["27pt", "7pt"],
)
def test_problems_and_stencil_matvec_match_jax(make):
    import amg_tpu.problems as jp
    import amg_tpu_torch.problems.laplacian as tp

    jprob, tprob = make(jp), make(tp)
    assert tprob.grid_shape == tuple(jprob.grid_shape)
    A_j, A_t = jprob.A.to_scipy(), tprob.A.to_scipy()
    assert (A_j != A_t).nnz == 0
    x = np.random.default_rng(4).random(tprob.n)
    _close(tprob.stencil @ torch.from_numpy(x), A_j @ x)


def test_structured_transfers_and_var_stencil_match_jax():
    from amg_tpu.setup.structured import StructuredProlong as JaxP
    from amg_tpu.setup.structured import StructuredRestrict as JaxR
    from amg_tpu.setup.structured import _csr_to_var_stencil as jax_to_var
    from amg_tpu.setup.structured import _structured_P_csr as jax_P_csr
    from amg_tpu_torch.setup.structured import _csr_to_var_stencil, _structured_P_csr

    fs, cs = (9, 10, 11), (5, 5, 6)
    rng = np.random.default_rng(5)
    xf, xc = rng.random(int(np.prod(fs))), rng.random(int(np.prod(cs)))
    P = StructuredProlong.build(fs, cs, torch.float64, "cpu")
    R = StructuredRestrict.build(fs, cs, torch.float64, "cpu")
    _close(P @ torch.from_numpy(xc), JaxP(fs, cs) @ jnp.asarray(xc))
    _close(R @ torch.from_numpy(xf), JaxR(fs, cs) @ jnp.asarray(xf))
    Pj, Pt = jax_P_csr(fs, cs).to_scipy(), _structured_P_csr(fs, cs).to_scipy()
    assert abs(Pj - Pt).max() == 0.0
    # the RAP of the 27-pt operator, as a variable stencil
    A = laplacian_3d_27pt(*fs).A
    Ac = _structured_P_csr(fs, cs).transpose().matmul(A).matmul(_structured_P_csr(fs, cs))
    vt = _csr_to_var_stencil(Ac, cs)
    vj = jax_to_var(Ac, cs, jnp.float64)
    _close(vt.coeffs, vj.coeffs)
    _close(vt @ torch.from_numpy(xc), vj @ jnp.asarray(xc))
    _close(vt @ torch.from_numpy(xc), Ac.to_scipy() @ xc)


def test_rho_estimate_matches_jax():
    from amg_tpu.setup.rap import estimate_rho_dinv_a as jax_rho
    from amg_tpu_torch.setup.rap import estimate_rho_dinv_a

    A = laplacian_3d_7pt(6, 5, 4).A
    assert estimate_rho_dinv_a(A) == jax_rho(A)
    assert estimate_rho_dinv_a(A, scale=A.l1_row_norms()) == jax_rho(
        A, scale=A.l1_row_norms())


@pytest.mark.parametrize("n,coarse_op,pre,post", [(20, "auto", 1, 1), (24, "const", 2, 1),
                                                  (16, "auto", 0, 2)], ids=str)
def test_mult_vcycle_matches_jax(n, coarse_op, pre, post):
    _, jh = jax_build(jax_27pt(n).stencil, smoother=JaxSmoother.L1_JACOBI,
                      dtype=jnp.float64, coarse_op=coarse_op)
    th = port_hierarchy(jh)
    rng = np.random.default_rng(6)
    x, b = rng.random(th.levels[0].A.n_rows), rng.random(th.levels[0].A.n_rows)
    jcfg = JaxCycleConfig(cycle=JaxCycleType.MULT, smoother=JaxSmoother.L1_JACOBI,
                          num_pre_sweeps=pre, num_post_sweeps=post)
    cfg = CycleConfig(smoother=SmootherType.L1_JACOBI, num_pre_sweeps=pre,
                      num_post_sweeps=post)
    want = np.asarray(jax_mult_vcycle(jh, jcfg, jnp.asarray(x), jnp.asarray(b)))
    got = mult_vcycle(th, cfg, torch.from_numpy(x), torch.from_numpy(b))
    _close(got, want)


def test_unported_smoothers_raise():
    """The structured cycle's kernels run Jacobi sweeps: struct_solve refuses
    the other smoothers, whose data the builder now makes (they run through
    solve.driver.solve, tests/test_torch_smoothers.py)."""
    from amg_tpu_torch.solve.struct_cycle import struct_solve

    prob = laplacian_3d_7pt(8)
    for sm in (SmootherType.HYBRID_JGS, SmootherType.GS, SmootherType.SYM_L1_JACOBI):
        _, hier = build_structured_hierarchy(prob.stencil, smoother=sm, device="cpu")
        assert (hier.levels[0].sm.block_inv is None) == (sm == SmootherType.SYM_L1_JACOBI)
        with pytest.raises(NotImplementedError, match="Jacobi sweeps"):
            struct_solve(hier, CycleConfig(smoother=sm), torch.ones(prob.n), device="cpu")
