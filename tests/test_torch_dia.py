"""The DIA (elasticity) path of the PyTorch port against the JAX package:
the elasticity generator, the DIA form, kernel K5's plain version, the DIA
structured hierarchy and one cycle on it, and the smoother's bfloat16
coefficient stream (`with_sweep_dtype`, `sweep_coef_dtype`).

Tolerances: the generator and the DIA form exactly (the same float64
host arithmetic); K5, the bf16-plane sweeps (the same bf16 planes: both
frameworks round float64 to bfloat16 alike) and the cycles to atol 1e-12
relative to the largest value (99 products per row summed in a different
order); the hierarchy's coefficients, smoother scales and coarse inverse to
1e-12.
"""

import functools

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import amg_tpu.ops.pallas_var_stencil as pvs
from amg_tpu.problems import laplacian_3d_27pt as jax_27pt
from amg_tpu.problems.elasticity import elasticity_beam as jax_beam
from amg_tpu.setup import structured as jst
from amg_tpu.setup.hierarchy import HierarchyParams as JaxParams
from amg_tpu.smooth import SmootherType as JaxSmoother
from amg_tpu.solve.cycles import CycleConfig as JaxCycleConfig
from amg_tpu.solve.cycles import CycleType as JaxCycleType
from amg_tpu.solve.cycles import cycle_step as jax_cycle_step
from amg_tpu.solve.cycles import mult_vcycle as jax_mult_vcycle

from amg_tpu_torch.ops import var_stencil as tvs
from amg_tpu_torch.problems.elasticity import elasticity_beam
from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
from amg_tpu_torch.setup import structured as tst
from amg_tpu_torch.setup.hierarchy import HierarchyParams
from amg_tpu_torch.smooth.smoothers import SmootherType
from amg_tpu_torch.solve.cycles import CycleConfig, CycleType, cycle_step, mult_vcycle
from amg_tpu_torch.utils import tracing

from torch_parity import port_hierarchy

# one intra-op thread: the suite runs several worker processes at once, and
# idle OpenMP threads spinning in each would take cores from the others
torch.set_num_threads(1)

# nodes (17, 8, 8): odd axis 17 -> 9 -> 5, even axes 8 -> 5 (graded end) -> 3
BEAM = dict(nx=16, ny=7, nz=7, bc="identity")
NODES = (17, 8, 8)


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("kw", [
    dict(nx=6, ny=3, nz=3, bc="identity"),
    dict(nx=6, ny=3, nz=2, bc="reduce"),
    dict(nx=8, ny=3, bc="identity"),
], ids=["3d-identity", "3d-reduce", "2d-identity"])
def test_elasticity_beam_equals_reference(kw):
    got, want = elasticity_beam(**kw), jax_beam(**kw)
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(got.A, f), getattr(want.A, f)), f
    assert got.A.shape == want.A.shape
    assert np.array_equal(got.rhs, want.rhs)
    assert np.array_equal(got.near_nullspace, want.near_nullspace)
    assert got.grid_shape == want.grid_shape and got.num_functions == want.num_functions


def test_csr_to_dia_stencil_equals_reference():
    prob = elasticity_beam(**BEAM)
    got = tst.csr_to_dia_stencil(prob.A, prob.grid_shape)
    want = jst.csr_to_dia_stencil(jax_beam(**BEAM).A, prob.grid_shape, jnp.float64)
    assert len(got.offsets) == 99
    assert got.offsets == want.offsets
    assert np.array_equal(got.coeffs.numpy(), np.asarray(want.coeffs))


@pytest.mark.parametrize("sf,sc", [(9, 5), (8, 5), (6, 4), (3, 3), (5, 3)])
def test_axis_transfer_kinds_equal_reference(sf, sc):
    assert np.array_equal(tst._axis_transfer_np(sf, sc), jst._axis_transfer_np(sf, sc))
    fs, cs = (sf, 3, 2), (sc, 2, 2)
    got, want = tst._structured_P_csr(fs, cs), jst._structured_P_csr(fs, cs)
    assert np.array_equal(got.to_dense(), want.to_dense())


def test_dia_hierarchy_matches_reference():
    prob = elasticity_beam(**BEAM)
    hh, th = tst.build_dia_structured_hierarchy(prob.A, NODES, num_functions=3, device="cpu")
    jhh, jh = jst.build_dia_structured_hierarchy(jax_beam(**BEAM).A, NODES, num_functions=3)
    assert [lv.A.grid_shape for lv in th.levels] == [(17, 8, 24), (9, 5, 15), (5, 3, 9)]
    assert th.num_levels == jh.num_levels
    rng = np.random.default_rng(0)
    for k, (tl, jl) in enumerate(zip(th.levels, jh.levels)):
        assert isinstance(tl.A, tst.DiaKernelOperator)
        assert tl.A.offsets == jl.A.offsets and tl.A.grid_shape == jl.A.grid_shape
        assert tl.A.coeffs.shape == (len(tl.A.offsets),) + tl.A.grid_shape
        _close(tl.A.coeffs, jl.A.coeffs)
        _close(tl.A.diagonal(), jl.A.diagonal())
        _close(tl.sm.inv_wscale, jl.sm.inv_wscale)
        x = rng.random(tl.A.n_rows)
        _close(tl.A @ torch.from_numpy(x), hh.levels[k].A.to_scipy() @ x)
        if tl.P is None:
            assert jl.P is None
            continue
        assert isinstance(tl.P, tst.MaskedTransfer) and isinstance(jl.P, jst.MaskedTransfer)
        assert tl.P.inner.fine_shape == jl.P.inner.fine_shape
        assert tl.P.inner.coarse_shape == jl.P.inner.coarse_shape
        assert np.array_equal(tl.P.in_mask.numpy(), np.asarray(jl.P.in_mask))
        assert np.array_equal(tl.P.out_mask.numpy(), np.asarray(jl.P.out_mask))
        xc, xf = rng.random(tl.P.shape[1]), rng.random(tl.P.shape[0])
        _close(tl.P @ torch.from_numpy(xc), np.asarray(jl.P @ jnp.asarray(xc)))
        _close(tl.R @ torch.from_numpy(xf), np.asarray(jl.R @ jnp.asarray(xf)))
        _close(tl.P @ torch.from_numpy(xc), hh.levels[k].P.to_scipy() @ xc)
    # the graded-end axis 8 -> 5 sits between levels 0 and 1
    assert th.levels[0].P.inner.coarse_shape == (9, 5, 5, 3)
    _close(th.coarse_Ainv, jh.coarse_Ainv)


def _k5_inputs(seed):
    prob = elasticity_beam(nx=6, ny=3, nz=3, bc="identity")
    vs = tst.csr_to_dia_stencil(prob.A, prob.grid_shape)
    gs = vs.grid_shape
    rng = np.random.default_rng(seed)
    x, b = rng.random(prob.n), rng.random(prob.n)
    scale = 1.0 / np.abs(prob.A.to_scipy()).sum(axis=1).A1
    return prob, vs, gs, x, b, scale


@pytest.mark.parametrize("mode", tvs.MODES)
def test_k5_plain_matches_pallas(mode):
    prob, vs, gs, x, b, scale = _k5_inputs(seed=len(mode))
    offsets = vs.offsets
    jh = pvs.halos_of(offsets)
    th = tvs.halos_of(offsets)
    assert jh == th == (1, 1, 5)
    slab = 4

    def jpad(v):
        return pvs.var_to_padded(jnp.asarray(v), gs, jh, slab)

    def tpad(v):
        return tvs.var_to_padded(torch.from_numpy(v), gs, th)

    jc = pvs.coeffs_to_padded(jnp.asarray(vs.coeffs.numpy()).reshape(len(offsets), -1), gs, jh, slab)
    tc = vs.coeffs
    with_b = mode != "spmv"
    with pltpu.force_tpu_interpret_mode():
        want = pvs.var_stencil_kernel_padded(
            jpad(x), jc, offsets, gs, b_pad=jpad(b) if with_b else None,
            scale_pad=jpad(scale) if mode == "sweep" else None, mode=mode, slab=slab,
        )
    got = tvs.var_stencil_kernel_padded(
        tpad(x), tc, offsets, gs, b_pad=tpad(b) if with_b else None,
        scale_pad=tpad(scale) if mode == "sweep" else None, mode=mode,
    )
    assert got.shape == tvs.var_padded_shape(gs, th) == (gs[0] + 2, gs[1] + 2, 24)
    _close(tvs.var_from_padded(got, gs, th), pvs.var_from_padded(want, gs, jh))
    shell = got.clone()
    shell[1:1 + gs[0], 1:1 + gs[1], 5:5 + gs[2]] = 0
    assert torch.count_nonzero(shell) == 0


def test_k5_wrapper_rejects_what_the_kernel_does_not_take():
    prob, vs, gs, x, b, scale = _k5_inputs(seed=0)
    h = tvs.halos_of(vs.offsets)
    up, bp = tvs.var_to_padded(torch.from_numpy(x), gs, h), tvs.var_to_padded(torch.from_numpy(b), gs, h)
    c = vs.coeffs
    call = tvs.var_stencil_kernel_padded
    with pytest.raises(ValueError, match="mode"):
        call(up, c, vs.offsets, gs, mode="spmv_comp")
    with pytest.raises(ValueError, match="shape"):
        call(up, c[:-1].contiguous(), vs.offsets, gs)
    with pytest.raises(ValueError, match="dtype"):
        call(up, c.float(), vs.offsets, gs)
    with pytest.raises(TypeError):
        call(up, c, vs.offsets, gs, mode="residual")
    before = tracing.counter("var_stencil_kernel_padded.launches")
    got = call(up, c, vs.offsets, gs, b_pad=bp, mode="residual")
    assert torch.equal(got, tvs.var_stencil_plain(up, c, vs.offsets, gs, b_pad=bp, mode="residual"))
    assert tracing.counter("var_stencil_kernel_padded.launches") == before


@functools.lru_cache(maxsize=None)
def _dia_hierarchies(smoother):
    """The reference's DIA hierarchy of the beam with `smoother` and the
    port's copy of it (built once per smoother: the block smoothers invert
    their blocks at setup)."""
    with threadpool_limits(limits=1, user_api="blas"):  # its block inverses
        _, jh = jst.build_dia_structured_hierarchy(jax_beam(**BEAM).A, NODES, num_functions=3,
                                                   smoother=JaxSmoother(smoother))
    return jh, port_hierarchy(jh, dia=True)


@pytest.mark.parametrize("smoother,pre,post", [
    pytest.param("l1_jacobi", 1, 1, id="1-1"),
    pytest.param("l1_jacobi", 2, 2, id="2-2"),
    # hybrid JGS: K5's residual mode (its plain version here), then the
    # block solve; the post-sweeps take the backward inverses
    pytest.param("hybrid_jgs", 1, 1, id="jgs-1-1"),
    pytest.param("hybrid_jgs", 2, 2, id="jgs-2-2"),
])
def test_dia_cycles_match_jax(smoother, pre, post):
    jh, th = _dia_hierarchies(smoother)
    assert all(isinstance(lv.A, tst.DiaKernelOperator) for lv in th.levels)
    assert all((lv.sm.block_inv is not None) == (smoother == "hybrid_jgs") for lv in th.levels)
    n = th.levels[0].A.n_rows
    rng = np.random.default_rng(pre)
    x, b = rng.random(n), rng.random(n)
    jcfg = JaxCycleConfig(cycle=JaxCycleType.MULT, smoother=JaxSmoother(smoother),
                          num_pre_sweeps=pre, num_post_sweeps=post)
    cfg = CycleConfig(smoother=SmootherType(smoother), num_pre_sweeps=pre, num_post_sweeps=post)
    want = jax_mult_vcycle(jh, jcfg, jnp.asarray(x), jnp.asarray(b))
    _close(mult_vcycle(th, cfg, torch.from_numpy(x), torch.from_numpy(b)), want)
    want0 = jax_cycle_step(jh, jcfg, jnp.zeros(n), jnp.asarray(b))
    _close(cycle_step(th, cfg, torch.zeros(n, dtype=torch.float64), torch.from_numpy(b)), want0)


def _builder_cases():
    """(name, port builder call, reference builder call) for both structured
    builders with a HierarchyParams and with the smooth_weight keyword."""
    beam, jbeam = elasticity_beam(**BEAM), jax_beam(**BEAM)
    lap, jlap = laplacian_3d_27pt(12), jax_27pt(12)
    jgs = dict(smoother=SmootherType.HYBRID_JGS, block_size=64, jgs_weight=None,
               max_coarse_size=3, max_levels=2)
    jjgs = dict(jgs, smoother=JaxSmoother.HYBRID_JGS)
    return {
        "dia-params-jgs": (
            lambda: tst.build_dia_structured_hierarchy(
                beam.A, NODES, num_functions=3, params=HierarchyParams(**jgs), device="cpu"),
            lambda: jst.build_dia_structured_hierarchy(
                jbeam.A, NODES, num_functions=3, params=JaxParams(**jjgs))),
        "dia-smooth-weight": (
            lambda: tst.build_dia_structured_hierarchy(
                beam.A, NODES, num_functions=3, smooth_weight=0.6, device="cpu"),
            lambda: jst.build_dia_structured_hierarchy(
                jbeam.A, NODES, num_functions=3, smooth_weight=0.6)),
        "stencil-params": (
            lambda: tst.build_structured_hierarchy(
                lap.stencil, params=HierarchyParams(smooth_weight=0.7, max_coarse_size=100),
                device="cpu"),
            lambda: jst.build_structured_hierarchy(
                jlap.stencil, params=JaxParams(smooth_weight=0.7, max_coarse_size=100))),
        "stencil-params-jgs": (
            lambda: tst.build_structured_hierarchy(
                lap.stencil, params=HierarchyParams(**jgs), device="cpu"),
            lambda: jst.build_structured_hierarchy(lap.stencil, params=JaxParams(**jjgs))),
    }


@pytest.mark.parametrize("case", list(_builder_cases()))
def test_structured_builders_take_params_and_smooth_weight(case):
    """A HierarchyParams sets the dtype, smoother, smooth_weight, max_levels
    and max(max_coarse_size, 8), and the block smoothers' block_size and
    jgs_weight; a given smooth_weight replaces every level's weight: the
    reference's level sizes, weights and smoother arrays (block inverses
    included) to 1e-12."""
    port, ref = _builder_cases()[case]
    with threadpool_limits(limits=1, user_api="blas"):  # the reference's block inverses
        (hh, th), (jhh, jh) = port(), ref()
    assert [lv.A.n_rows for lv in hh.levels] == [lv.A.n_rows for lv in jhh.levels]
    np.testing.assert_allclose([lv.weight for lv in hh.levels],
                               [lv.weight for lv in jhh.levels], rtol=1e-12)
    if "weight" in case or "stencil-params" == case:
        assert all(lv.weight in (0.6, 0.7) for lv in hh.levels)
    for lv, jlv in zip(th.levels, jh.levels):
        for f in ("scale", "inv_wscale", "block_inv", "block_inv_bwd"):
            got, want = getattr(lv.sm, f), getattr(jlv.sm, f)
            assert (got is None) == (want is None), f
            if got is not None:
                _close(got, want)
    if "jgs" in case:
        assert th.num_levels == 2 and th.levels[0].sm.block_inv.shape[1] == 64


def test_cycle_step_names_the_slice_of_the_other_cycles():
    """The cycles other than MULT raised NotImplementedError, naming the
    generic-AMG slice, until that slice ported them; now cycle_step runs
    them on the DIA hierarchy as the reference does (its levels carry no
    smoothed or ideal transfers, so the chains take P and R)."""
    _, jh = jst.build_dia_structured_hierarchy(jax_beam(**BEAM).A, NODES, num_functions=3)
    th = port_hierarchy(jh, dia=True)
    n = th.levels[0].A.n_rows
    b = np.random.default_rng(7).random(n)
    # mult_multadd's inner multadd cycles return a correction ~5.9e3 times
    # their right-hand side in norm, which the up-sweep then cancels: that
    # cancellation turns the cycles' rounding (equal to 2.7e-16 from the same
    # input) into 2.2e-12 relative, so it is held at the goldens' 1e-10
    for cyc, tol in (("multadd", 1e-12), ("bpx", 1e-12), ("afacx", 1e-12),
                     ("mult_multadd", 1e-10)):
        want = jax_cycle_step(jh, JaxCycleConfig(cycle=JaxCycleType(cyc)), jnp.zeros(n),
                              jnp.asarray(b))
        got = cycle_step(th, CycleConfig(cycle=CycleType(cyc)),
                         torch.zeros(n, dtype=torch.float64), torch.from_numpy(b))
        _close(got, want, tol)


def _sweep_ops():
    """The port's and the reference's float64 DIA operator of the small beam of
    the reference's own bf16-stream test (tests/test_dia.py::
    TestDiaFusedSmoother._ops), inputs drawn with numpy."""
    prob = elasticity_beam(nx=6, ny=3, nz=3, bc="identity")
    op = tst.DiaKernelOperator.from_var_stencil(tst.csr_to_dia_stencil(prob.A, prob.grid_shape))
    jop = jst.DiaKernelOperator.from_var_stencil(
        jst.csr_to_dia_stencil(jax_beam(nx=6, ny=3, nz=3, bc="identity").A, prob.grid_shape,
                               jnp.float64))
    rng = np.random.default_rng(3)
    u, f = rng.random(prob.n), rng.random(prob.n)
    s = 1.0 / np.abs(prob.A.to_scipy()).sum(axis=1).A1
    return op, jop, u, f, s


@pytest.mark.parametrize("zero_guess", [False, True])
def test_bf16_sweep_planes_match_reference(zero_guess):
    """with_sweep_dtype(bfloat16): the fused sweeps stream the bf16 planes,
    widened to the float64 state, as the reference's do."""
    op, jop, u, f, s = _sweep_ops()
    opb, jopb = op.with_sweep_dtype(torch.bfloat16), jop.with_sweep_dtype(jnp.bfloat16)
    assert opb.coeffs_sweep.dtype == torch.bfloat16 and opb.coeffs.dtype == torch.float64
    assert torch.equal(opb.coeffs_sweep, op.coeffs.to(torch.bfloat16))
    with pltpu.force_tpu_interpret_mode():
        want = jopb.fused_jacobi_sweeps(jnp.asarray(u), jnp.asarray(f), jnp.asarray(s), 2,
                                        zero_guess=zero_guess)
    t = (torch.from_numpy(v) for v in (u, f, s))
    got = opb.fused_jacobi_sweeps(*t, 2, zero_guess=zero_guess)
    _close(got, want)
    full = op.fused_jacobi_sweeps(*(torch.from_numpy(v) for v in (u, f, s)), 2,
                                  zero_guess=zero_guess)
    rel = float(torch.linalg.norm(got - full) / torch.linalg.norm(full))
    assert 0.0 < rel < 1e-2  # the planes' bf16 rounding, not garbage


def test_bf16_copy_leaves_matvec_and_residual_and_reverts():
    op, _, u, f, _ = _sweep_ops()
    opb = op.with_sweep_dtype(torch.bfloat16)
    u, f = torch.from_numpy(u), torch.from_numpy(f)
    assert torch.equal(opb.matvec(u), op.matvec(u))
    assert torch.equal(opb.residual(u, f), op.residual(u, f))
    # None or the planes' own dtype drops the narrow copy: a true revert
    for dtype in (None, torch.float64):
        back = opb.with_sweep_dtype(dtype)
        assert back.coeffs_sweep is None and back.coeffs is op.coeffs
    assert op.with_sweep_dtype(None) is op


def test_dia_hierarchy_sweep_coef_dtype_matches_reference():
    """build_dia_structured_hierarchy(sweep_coef_dtype=bfloat16) gives every
    level the narrow copy, and one V(1,1) cycle on it equals the reference's
    hierarchy built the same way (its kernel operators in interpret mode)."""
    prob = elasticity_beam(**BEAM)
    _, th = tst.build_dia_structured_hierarchy(prob.A, NODES, num_functions=3, device="cpu",
                                               sweep_coef_dtype=torch.bfloat16)
    for lv in th.levels:
        assert lv.A.coeffs_sweep.dtype == torch.bfloat16
        assert torch.equal(lv.A.coeffs_sweep, lv.A.coeffs.to(torch.bfloat16))
    _, plain = tst.build_dia_structured_hierarchy(prob.A, NODES, num_functions=3, device="cpu")
    assert all(lv.A.coeffs_sweep is None for lv in plain.levels)
    _, jh = jst.build_dia_structured_hierarchy(jax_beam(**BEAM).A, NODES, num_functions=3,
                                               use_kernel=True, sweep_coef_dtype=jnp.bfloat16)
    assert all(lv.A.c_sweep is not None for lv in jh.levels)
    rng = np.random.default_rng(4)
    x, b = rng.random(prob.n), rng.random(prob.n)
    jcfg = JaxCycleConfig(cycle=JaxCycleType.MULT, smoother=JaxSmoother.L1_JACOBI)
    with pltpu.force_tpu_interpret_mode():
        want = jax_mult_vcycle(jh, jcfg, jnp.asarray(x), jnp.asarray(b))
    got = mult_vcycle(th, CycleConfig(), torch.from_numpy(x), torch.from_numpy(b))
    _close(got, want)
    full = mult_vcycle(plain, CycleConfig(), torch.from_numpy(x), torch.from_numpy(b))
    assert not torch.equal(got, full)


@pytest.mark.parametrize("mode", tvs.MODES)
def test_k5_takes_bf16_planes_in_sweep_only(mode):
    prob, vs, gs, x, b, scale = _k5_inputs(seed=5)
    h = tvs.halos_of(vs.offsets)

    def pad(v):
        return tvs.var_to_padded(torch.from_numpy(v), gs, h)

    cb = vs.coeffs.to(torch.bfloat16)
    call = tvs.var_stencil_kernel_padded
    if mode != "sweep":
        with pytest.raises(ValueError, match="bfloat16 coefficient planes"):
            call(pad(x), cb, vs.offsets, gs, b_pad=pad(b), mode=mode)
        return
    with pytest.raises(ValueError, match="dtype"):
        call(pad(x), vs.coeffs.half(), vs.offsets, gs, b_pad=pad(b), scale_pad=pad(scale),
             mode=mode)
    for dtype in (torch.float32, torch.float64):
        up, bp, sp_ = (pad(v).to(dtype) for v in (x, b, scale))
        got = call(up, cb, vs.offsets, gs, b_pad=bp, scale_pad=sp_, mode=mode)
        assert got.dtype == dtype
        # the plain version widens the planes before the multiply
        want = tvs.var_stencil_plain(up, cb.to(dtype), vs.offsets, gs, bp, sp_, mode)
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["config10_elasticity_dia_mixed",
                                  "config11_elasticity_jgs_mixed"])
def test_golden_dia_mixed_through_the_port_alone(name):
    """Goldens config10/11 (the 49,179-dof beam, float32 DIA hierarchy under
    mixed_pcg, L1-Jacobi and hybrid JGS) through the port alone. Their float32
    preconditioner histories moved on the reference itself across XLA builds
    (ROADMAP F1), so they are held by shape, count and residual: level_n and
    level_nnz exactly, the iterations within one, a true float64 residual
    <= 1e-5 and history[:5] to rtol 0.1 (the port's deviation: 4.5e-4)."""
    import json
    import os

    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import run_experiment

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                           name + ".json")) as f:
        g = json.load(f)
    c = g["config"]
    st = run_experiment(SolverOptions(**c), device="cpu")
    assert st.level_n == g["level_n"] and st.level_nnz == g["level_nnz"]
    assert abs(st.cycles - g["cycles"]) <= 1
    prob = elasticity_beam(nx=c["nx"], ny=c["ny"], nz=c["nz"], bc=c["elast_bc"])
    b = prob.rhs / np.linalg.norm(prob.rhs)
    x = st.x.numpy()
    assert np.linalg.norm(b - prob.A @ x) / np.linalg.norm(b) <= 1e-5
    np.testing.assert_allclose(st.history[:5], g["history"][:5], rtol=0.1)
