"""The fused structured solve of the PyTorch port
(amg_tpu_torch/solve/struct_cycle.py) against the JAX package's struct_solve
(amg_tpu/solve/struct_cycle.py) with its Pallas kernels in interpret mode.

Both packages run on the same hierarchy (built by the JAX package, carried
across by amg_tpu_torch.convert) and the same float64 right-hand side, with
both fusion gates lowered so that level 0 runs through the fused transfer
kernels as it does at 126^3. Tolerances: the same cycle count; x to rtol
1e-10; histories to rtol 1e-10 with an absolute floor of 1e-14. The history
holds ||r_k|| / ||r_0||, and below ~1e-6 each entry carries the rounding of the
residual itself (~eps ||b|| / ||r_0|| per entry, summed in different orders by
the two packages), which a relative tolerance alone would hold to a precision
neither side has.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import amg_tpu.solve.struct_cycle as jsc
from amg_tpu.problems import laplacian_3d_27pt as jax_27pt
from amg_tpu.setup.structured import build_structured_hierarchy as jax_build
from amg_tpu.smooth import SmootherType as JaxSmoother
from amg_tpu.solve.cycles import CycleConfig as JaxCycleConfig
from amg_tpu.solve.cycles import CycleType as JaxCycleType

import amg_tpu_torch.solve.struct_cycle as tsc
from amg_tpu_torch.convert import hierarchy_from_arrays
from amg_tpu_torch.smooth.smoothers import SmootherType
from amg_tpu_torch.solve.cycles import CycleConfig, mult_vcycle

from torch_parity import port_hierarchy

# one intra-op thread: the suite runs several worker processes at once, and
# idle OpenMP threads spinning in each would take cores from the others
torch.set_num_threads(1)


@pytest.fixture
def low_gates(monkeypatch):
    monkeypatch.setattr(jsc, "_FUSE_MIN_SIDE", 16)
    monkeypatch.setattr(tsc, "_FUSE_MIN_SIDE", 16)


# (n, coarse_op, smoother, pre, post, tol): V(1,1) with level 0 fused, to the
# reference tests' 1e-8; then, to 1e-6 (fewer interpret-mode cycles): no
# pre-sweeps (norm from a plain residual pass); V(2,2), where the port's chain
# of single K1 sweeps meets the JAX package's fused two-sweep kernel. The
# zero-guess coarse visit and the scalar-alpha kernels are held against
# mult_vcycle below, and their kernels against the JAX ones in
# test_torch_transfer.py.
CASES = [
    (20, "auto", "L1_JACOBI", 1, 1, 1e-8),
    (16, "auto", "L1_JACOBI", 0, 2, 1e-6),
    (16, "auto", "L1_JACOBI", 2, 2, 1e-6),
]


@pytest.mark.parametrize("n,coarse_op,smoother,pre,post,tol", CASES, ids=str)
def test_struct_solve_matches_jax(low_gates, n, coarse_op, smoother, pre, post, tol):
    _, jh = jax_build(jax_27pt(n).stencil, smoother=getattr(JaxSmoother, smoother),
                      coarse_op=coarse_op)
    th = port_hierarchy(jh)
    assert tsc._can_fuse(th, 0, tsc.make_struct_spec(th))
    b = np.random.default_rng(0).random(n ** 3)
    jcfg = JaxCycleConfig(cycle=JaxCycleType.MULT, smoother=getattr(JaxSmoother, smoother),
                          num_pre_sweeps=pre, num_post_sweeps=post)
    cfg = CycleConfig(smoother=getattr(SmootherType, smoother), num_pre_sweeps=pre,
                      num_post_sweeps=post)
    with pltpu.force_tpu_interpret_mode():
        want = jsc.struct_solve(jh, jcfg, jnp.asarray(b), tol=tol, max_cycles=40)
    got = tsc.struct_solve(th, cfg, torch.from_numpy(b), tol=tol, max_cycles=40,
                           device="cpu")
    assert got.num_iters() == want.num_iters()
    assert got.history.shape == want.history.shape == (41,)
    assert np.isnan(got.history.numpy()[got.iters + 1:]).all()
    np.testing.assert_allclose(got.history_list(), want.history_list(),
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(float(got.rel_resnorm), float(want.rel_resnorm),
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-10)


@pytest.mark.parametrize("smoother", ["L1_JACOBI", "JACOBI"])
def test_timed_cycles_equal_k_mult_vcycles(low_gates, smoother):
    """On constant coarse levels (the zero-guess K3/K4 visits), with the
    streamed L1 scale or Jacobi's constant scale (the scalar-alpha kernels),
    k fused cycles equal k mult_vcycles."""
    _, jh = jax_build(jax_27pt(20).stencil, smoother=getattr(JaxSmoother, smoother),
                      coarse_op="const")
    th = port_hierarchy(jh)
    cfg = CycleConfig(smoother=getattr(SmootherType, smoother))
    spec = tsc.make_struct_spec(th)
    assert (spec.alpha != 0.0) == (smoother == "JACOBI")
    assert tsc._can_fuse_zg(th, 1, tsc.make_coarse_specs(th)[1], cfg)
    b = torch.from_numpy(np.random.default_rng(1).random(20 ** 3))
    x = torch.zeros_like(b)
    for _ in range(4):
        x = mult_vcycle(th, cfg, x, b)
    got = tsc.struct_timed_cycles(th, cfg, b, 4, device="cpu")
    np.testing.assert_allclose(got.numpy(), x.numpy(), rtol=0, atol=1e-12)


def test_stagnation_guard_stops_a_stalled_solve():
    """With tol below the float32 floor the solve stops at the first cycle
    (k >= 2) that cuts the residual by less than 1%, as the JAX loop does."""
    _, jh = jax_build(jax_27pt(16).stencil, smoother=JaxSmoother.L1_JACOBI)
    th32 = port_hierarchy(jh, dtype=torch.float32)
    b = torch.from_numpy(np.random.default_rng(2).random(16 ** 3)).float()
    res = tsc.struct_solve(th32, CycleConfig(), b, tol=1e-12, max_cycles=60,
                           device="cpu")
    h = res.history_list()
    assert 2 <= res.iters < 60 and len(h) == res.iters + 1
    assert h[-1] > 0.99 * h[-2]
    assert all(h[k] <= 0.99 * h[k - 1] for k in range(2, res.iters))


def _synthetic_126_hierarchy():
    """The level shapes and operator kinds of the 126^3 hierarchy (126, 63,
    32 constant stencils; 16 variable; 8 dense) with placeholder values: the
    routing reads only shapes, kinds and whether the smoother scale is
    constant."""
    box = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    shapes = [(126,) * 3, (63,) * 3, (32,) * 3, (16,) * 3, (8,) * 3]
    rng = np.random.default_rng(0)
    levels = []
    for k, gs in enumerate(shapes):
        n = int(np.prod(gs))
        if k < 3:
            A = {"kind": "stencil", "weights": -rng.random(27), "offsets": box,
                 "grid_shape": gs}
        else:
            A = {"kind": "var", "coeffs": np.zeros((27,) + gs), "offsets": box,
                 "grid_shape": gs}
        sm = {"scale": np.ones(n), "inv_wscale": 0.02 + 0.01 * rng.random(n), "w": 1.0}
        transfer = None if k == 4 else {"fine_shape": gs, "coarse_shape": shapes[k + 1]}
        levels.append({"A": A, "sm": sm, "transfer": transfer})
    return hierarchy_from_arrays(levels, np.eye(512), dtype=torch.float32, device="cpu")


def test_routing_at_126_cubed():
    """Level 0 through the non-zero-guess K3/K4 pair, 63^3 and 32^3 through
    the zero-guess pair, 16^3 and below through mult_vcycle."""
    h = _synthetic_126_hierarchy()
    cfg = CycleConfig()
    spec0 = tsc.make_struct_spec(h)
    assert spec0.alpha == 0.0  # L1-Jacobi scale varies: the sweep_vec kernels
    assert tsc._can_fuse(h, 0, spec0)
    specs = tsc.make_coarse_specs(h)
    assert sorted(specs) == [1, 2]
    for lvl in (1, 2):
        assert not tsc._can_fuse(h, lvl, specs[lvl])
        assert tsc._can_fuse_zg(h, lvl, specs[lvl], cfg)
    assert not tsc._next_fused(h, cfg, specs, 2)


def test_launches_per_cycle(low_gates, monkeypatch):
    """Per V(1,1) cycle on a hierarchy with constant coarse levels: one K1
    (the fused sweep + norm), one K3 and one K4 per constant level."""
    _, jh = jax_build(jax_27pt(40).stencil, smoother=JaxSmoother.L1_JACOBI,
                      coarse_op="const")
    th = port_hierarchy(jh)
    calls = {"K1": 0, "K3": 0, "K4": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tsc, "stencil_kernel_padded", counted("K1", tsc.stencil_kernel_padded))
    monkeypatch.setattr(tsc, "residual_restrict_padded",
                        counted("K3", tsc.residual_restrict_padded))
    monkeypatch.setattr(tsc, "prolong_sweep_padded", counted("K4", tsc.prolong_sweep_padded))
    b = torch.from_numpy(np.random.default_rng(3).random(40 ** 3))
    res = tsc.struct_solve(th, CycleConfig(), b, tol=1e-6, max_cycles=40, device="cpu")
    n_const = sum(1 for lv in th.levels[:-1] if type(lv.A).__name__ == "StencilOperator")
    assert n_const == 3  # 40, 20, 10; 5^3 is the dense coarsest
    assert calls == {"K1": res.iters + 1, "K3": n_const * res.iters,
                     "K4": n_const * res.iters}
