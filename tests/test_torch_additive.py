"""The port's additive cycle family against the JAX package's, on the CPU in
float64: `additive_correction` at every level of every additive type,
`sync_additive_cycle`, `mult_multadd_vcycle` at coarsest_mult_level 0, 1 and
2, `cycle_step` for all six types, and `driver.solve` with `cheby_setup`
for each, at rtol 1e-10 / atol 1e-14 (the goldens' tolerance).

Both packages run on one classical hierarchy of the reference carried
across (tests/torch_parity.py, with the smoothed and AFACj ideal transfers):
the 27-point Laplacian at 10^3 with max_coarse_size 8, five levels
(1000, 125, 39, 12, 3), so that the AFACj hops at afacj_level 0 and 1 and
every coarsest_mult_level differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amg_tpu.problems import laplacian_3d_27pt as r_27pt
from amg_tpu.setup import hierarchy as rhi
from amg_tpu.smooth import SmootherType as RSm
from amg_tpu.solve import cycles as rcy
from amg_tpu.solve import driver as rdrv
from amg_tpu_torch.smooth.smoothers import SmootherType
from amg_tpu_torch.solve import cycles as pcy
from amg_tpu_torch.solve import driver as pdrv
from torch_parity import port_hierarchy, reference_native

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def reference_library():
    """The reference's "hmis" hierarchies here are its native library's,
    which these tests compare the port's own setup with (ROADMAP F11)."""
    reference_native()


TOL = dict(rtol=1e-10, atol=1e-14)

# name: CycleConfig keywords (the smoother by its value)
VARIANTS = {
    "multadd": {"cycle": "multadd"},
    "multadd smoothed": {"cycle": "multadd", "use_smoothed_transfers": True},
    "multadd simple jacobi": {"cycle": "multadd", "simple_add_smoother": True,
                              "smoother": "jacobi", "num_add_sweeps": 2},
    "afacx": {"cycle": "afacx"},
    "afacx 1/3 sweeps": {"cycle": "afacx", "num_fine_sweeps": 1, "num_coarse_sweeps": 3},
    "afacj level 1": {"cycle": "afacj"},
    "afacj level 0": {"cycle": "afacj", "afacj_level": 0},
    "bpx": {"cycle": "bpx"},
}


def cfgs(kw):
    kw = dict(kw)
    smoother = kw.pop("smoother", "l1_jacobi")
    cycle = kw.pop("cycle")
    return (rcy.CycleConfig(cycle=rcy.CycleType(cycle), smoother=RSm(smoother), **kw),
            pcy.CycleConfig(cycle=pcy.CycleType(cycle), smoother=SmootherType(smoother), **kw))


@pytest.fixture(scope="module")
def pair():
    """(reference hierarchy, port hierarchy, r, x, b); the hierarchy is built
    with L1-Jacobi data, the Jacobi variants read its w / diag(A) scale."""
    prob = r_27pt(10)
    hh, jh = rhi.build_hierarchy(prob.A, rhi.HierarchyParams(max_coarse_size=8),
                                 fine_stencil=prob.stencil)
    rng = np.random.default_rng(3)
    assert jh.level_sizes() == (1000, 125, 39, 12, 3)
    return jh, port_hierarchy(jh, host=hh), rng.random(prob.n), rng.random(prob.n), \
        rng.random(prob.n)


def check(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_the_additive_transfers_cross_over(pair):
    jh, th = pair[:2]
    for lv_r, lv_p in zip(jh.levels[:-1], th.levels[:-1]):
        for name in ("P_s", "R_s", "P_id", "R_id"):
            want, got = getattr(lv_r, name), getattr(lv_p, name)
            np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))
            np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    last = th.levels[-1]
    assert last.P_s is last.R_s is last.P_id is last.R_id is None


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_additive_correction_at_every_level(pair, variant):
    jh, th, r = pair[:3]
    rcfg, pcfg = cfgs(VARIANTS[variant])
    for k in range(th.num_levels):
        check(pcy.additive_correction(th, pcfg, torch.from_numpy(r), k),
              rcy.additive_correction(jh, rcfg, jnp.asarray(r), k))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sync_additive_cycle(pair, variant):
    jh, th, _, x, b = pair
    rcfg, pcfg = cfgs(VARIANTS[variant])
    check(pcy.sync_additive_cycle(th, pcfg, torch.from_numpy(x), torch.from_numpy(b)),
          rcy.sync_additive_cycle(jh, rcfg, jnp.asarray(x), jnp.asarray(b)))


@pytest.mark.parametrize("cml", [0, 1, 2])
def test_mult_multadd_vcycle(pair, cml):
    jh, th, _, x, b = pair
    rcfg, pcfg = cfgs({"cycle": "mult_multadd", "use_smoothed_transfers": True,
                       "coarsest_mult_level": cml, "num_inner_cycles": 3})
    check(pcy.mult_multadd_vcycle(th, pcfg, torch.from_numpy(x), torch.from_numpy(b)),
          rcy.mult_multadd_vcycle(jh, rcfg, jnp.asarray(x), jnp.asarray(b)))
    sub = pcy.sub_hierarchy(th, cml)
    assert sub.num_levels == th.num_levels - cml and sub.coarse_Ainv is th.coarse_Ainv


def test_additive_correction_refuses_mult(pair):
    _, th, r = pair[:3]
    with pytest.raises(ValueError, match="does not support"):
        pcy.additive_correction(th, pcy.CycleConfig(), torch.from_numpy(r), 0)


@pytest.mark.parametrize("cycle", [t.value for t in pcy.CycleType])
def test_cycle_step_runs_every_type(pair, cycle):
    jh, th, _, x, b = pair
    rcfg, pcfg = cfgs({"cycle": cycle})
    check(pcy.cycle_step(th, pcfg, torch.from_numpy(x), torch.from_numpy(b)),
          rcy.cycle_step(jh, rcfg, jnp.asarray(x), jnp.asarray(b)))


# the CLI defaults of each synchronous additive solver: Chebyshev for the
# additive cycles, none for mult_multadd; smoothed transfers for multadd and
# mult_multadd
SOLVES = {
    "multadd": ({"cycle": "multadd", "use_smoothed_transfers": True}, "cheby"),
    "afacx": ({"cycle": "afacx"}, "cheby"),
    "afacj": ({"cycle": "afacj"}, "cheby"),
    "bpx": ({"cycle": "bpx"}, "cheby"),
    "mult_multadd": ({"cycle": "mult_multadd", "use_smoothed_transfers": True}, None),
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_driver_solves_every_additive_type(pair, name):
    jh, th, _, _, b = pair
    kw, accel = SOLVES[name]
    rcfg, pcfg = cfgs(kw)
    kw_r, kw_p = {}, {}
    if accel:
        want_c = rdrv.cheby_setup(jh, rcfg, num_iters=20)
        got_c = pdrv.cheby_setup(th, pcfg, num_iters=20, device="cpu")
        np.testing.assert_allclose(np.array(got_c), np.array(want_c), rtol=1e-12)
        kw_r, kw_p = dict(accel=accel, cheby_coeffs=want_c), dict(accel=accel, cheby_coeffs=got_c)
    want = rdrv.solve(jh, rcfg, jnp.asarray(b), tol=1e-9, max_cycles=60, **kw_r)
    got = pdrv.solve(th, pcfg, torch.from_numpy(b), tol=1e-9, max_cycles=60, device="cpu",
                     **kw_p)
    assert got.iters == int(want.iters)
    h = np.asarray(want.history)
    np.testing.assert_allclose(np.asarray(got.history_list()), h[~np.isnan(h)], **TOL)
    check(got.x, want.x)
