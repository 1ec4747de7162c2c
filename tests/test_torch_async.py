"""The port's asynchronous solvers against the JAX package's, on the CPU in
float64, with the reference's own random draws replayed into the port
(tests/torch_parity.py: `JaxAsyncDraws`, `JaxSmoothDraws`, `JaxExtDraws`
walk the reference's key chains with jax.random). Under replayed draws a
run must follow the reference step for step: the same iterations, the
history at rtol 1e-10 / atol 1e-14, x and the grid-wait summary.

  * `async_solve` over a grid of modes on the reference's own async fixture
    (the 2-D 5-point Laplacian at 32^2, smoothed-transfer MULTADD): FULL and
    SEMI staleness x solution and residual reads x recomputed and updated
    residuals, wait-counter firing, a delayed level, a fail window,
    comm_every 2 with both reads, Chebyshev and Richardson, delay 0;
  * goldens config3 (27-point 12^3, 108 steps) and config13 (32^3,
    Chebyshev, 139 steps) through the port alone (its `run_experiment`),
    the reference's draws for PRNGKey(0) replayed;
  * `async_smooth_solve` in its fixed, southwell_exp, southwell_inv and
    sps_min_prob modes: history and block_updates;
  * `ext_solve` on the explicit and implicit extended system, sync and
    async;
  * the port's own generators (the production draws): convergence.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amg_tpu.problems import laplacian_2d_5pt as r_5pt
from amg_tpu.setup import hierarchy as rhi
from amg_tpu.smooth import SmootherType as RSm
from amg_tpu.solve import async_sim as ras
from amg_tpu.solve import async_smooth as rsm
from amg_tpu.solve import extended as rext
from amg_tpu.solve.accel import estimate_cycle_eigs as r_eigs
from amg_tpu.solve.cycles import CycleConfig as RCfg
from amg_tpu.solve.cycles import CycleType as RType
from amg_tpu.solve.driver import cheby_setup as r_cheby_setup
from amg_tpu_torch.problems.laplacian import laplacian_2d_5pt
from amg_tpu_torch.setup.hierarchy import HierarchyParams
from amg_tpu_torch.smooth.smoothers import SmootherType
from amg_tpu_torch.solve import async_sim as pas
from amg_tpu_torch.solve import async_smooth as psm
from amg_tpu_torch.solve import extended as pext
from amg_tpu_torch.solve.accel import estimate_cycle_eigs as p_eigs
from amg_tpu_torch.solve.cycles import CycleConfig, CycleType
from amg_tpu_torch.solve.driver import cheby_setup as p_cheby_setup
from amg_tpu_torch.utils.config import SolverOptions
from amg_tpu_torch.utils.runner import run_experiment
from torch_parity import JaxAsyncDraws, JaxExtDraws, JaxSmoothDraws, async_options, \
    port_hierarchy, port_host_hierarchy

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
HIST = dict(rtol=1e-10, atol=1e-14)
RCFG = RCfg(cycle=RType.MULTADD, smoother=RSm.L1_JACOBI, use_smoothed_transfers=True)
PCFG = CycleConfig(cycle=CycleType.MULTADD, use_smoothed_transfers=True)


def _hist(res):
    h = np.asarray(res.history)
    return h[~np.isnan(h)]


def _port_cheby_setup(hier, cfg, num_iters):
    return p_cheby_setup(hier, cfg, num_iters=num_iters, device="cpu")


@pytest.fixture(scope="module")
def p5():
    """The reference's async fixture (tests/test_async.py): 5-point 32^2,
    default HierarchyParams, b = default_rng(0).random(n); both packages'
    Chebyshev bounds of the MULTADD cfg, computed once."""
    prob = r_5pt(32)
    hh, jh = rhi.build_hierarchy(prob.A, rhi.HierarchyParams(), fine_stencil=prob.stencil)
    th = port_hierarchy(jh, host=hh)
    want_c = r_cheby_setup(jh, RCFG, num_iters=20)
    got_c = p_cheby_setup(th, PCFG, num_iters=20, device="cpu")
    np.testing.assert_allclose(np.array(got_c), np.array(want_c), rtol=1e-12)
    b = np.random.default_rng(0).random(prob.n)
    return {"prob": prob, "hh": hh, "jh": jh, "th": th, "b": b,
            "coeffs": (want_c, got_c)}


# name: (async_options keywords, AsyncConfig keywords); async_options gives
# the runner's Richardson (or, with comm_every > 1, the scalar omega)
MODES = {
    "full sol recompute": ({}, {}),
    "full sol update": ({}, {"res_mode": "update"}),
    "full res recompute": ({}, {"read_type": "res"}),
    "full res update": ({}, {"read_type": "res", "res_mode": "update"}),
    "semi sol recompute": ({"async_type": "semi"}, {}),
    "semi sol update": ({"async_type": "semi"}, {"res_mode": "update"}),
    "semi res recompute": ({"async_type": "semi"}, {"read_type": "res"}),
    "semi res update": ({"async_type": "semi"}, {"read_type": "res", "res_mode": "update"}),
    "wait counters": ({}, {"sim_grid_wait": 3}),
    "delay level": ({}, {"delay_levels": (1,), "delay_prob": 0.2}),
    "fail window": ({"async_type": "semi"}, {"fail_level": 2, "fail_start": 3,
                                            "fail_duration": 12}),
    "comm_every 2 sol": ({"comm_every": 2}, {}),
    "comm_every 2 res": ({"comm_every": 2, "async_type": "semi"}, {"read_type": "res"}),
    "cheby": ({"accel": "cheby"}, {}),
    "cheby semi grid 1": ({"accel": "cheby", "async_type": "semi", "cheby_grid": 1}, {}),
    "richardson delay 0": ({"sim_read_delay": 0}, {"fire_prob": 0.7}),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_async_solve_follows_the_reference(p5, mode):
    opt_kw, acfg_kw = MODES[mode]
    want_c, got_c = p5["coeffs"]
    racfg = ras.AsyncConfig(**async_options(p5["jh"], RCFG, lambda *a, **k: want_c,
                                            **opt_kw), **acfg_kw)
    pacfg = pas.AsyncConfig(**async_options(p5["th"], PCFG, lambda *a, **k: got_c,
                                            **opt_kw), **acfg_kw)
    b = p5["b"]
    want = ras.async_solve(p5["jh"], RCFG, racfg, jnp.asarray(b), key=jax.random.PRNGKey(5),
                           tol=1e-8, max_cycles=40)
    got = pas.async_solve(p5["th"], PCFG, pacfg, torch.from_numpy(b),
                          draws=JaxAsyncDraws(5), tol=1e-8, max_cycles=40, device="cpu")
    assert got.iters == int(want.iters)
    np.testing.assert_allclose(_hist(got), _hist(want), **HIST)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), **HIST)
    assert got.grid_wait.summary() == want.grid_wait.summary()


def test_async_solve_on_its_own_generators_converges(p5):
    """The production draws (GeneratorDraws): the reference's own
    convergence test (tests/test_async.py), FULL staleness, Richardson."""
    kw = async_options(p5["th"], PCFG, _port_cheby_setup)
    b = p5["b"]
    res = pas.async_solve(p5["th"], PCFG, pas.AsyncConfig(**kw), torch.from_numpy(b),
                          seed=3, tol=1e-8, max_cycles=500, device="cpu")
    assert float(res.rel_resnorm) <= 1e-8
    r = b - p5["prob"].A @ res.x.numpy()
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1.1e-8
    assert min(res.grid_wait.summary()["num_correct"]) > 0
    again = pas.async_solve(p5["th"], PCFG, pas.AsyncConfig(**kw), torch.from_numpy(b),
                            seed=3, tol=1e-8, max_cycles=500, device="cpu")
    assert again.iters == res.iters and torch.equal(again.x, res.x)


def test_async_accel_needs_bounds(p5):
    with pytest.raises(ValueError, match="cheby_mu"):
        pas.async_solve(p5["th"], PCFG, pas.AsyncConfig(accel="cheby"),
                        torch.from_numpy(p5["b"]), max_cycles=2, device="cpu")
    with pytest.raises(ValueError, match="comm_every"):
        pas.async_solve(p5["th"], PCFG,
                        pas.AsyncConfig(accel="cheby", cheby_mu=2.0, cheby_delta=1.0,
                                        comm_every=2),
                        torch.from_numpy(p5["b"]), max_cycles=2, device="cpu")


@pytest.mark.parametrize("name", ["config3_27pt_async_multadd", "config13_27pt_medium_async"])
def test_async_golden_through_the_port_alone(name):
    """The golden's async_multadd through the port's run_experiment, with the
    reference's draws for PRNGKey(0)."""
    with open(os.path.join(GOLDEN_DIR, name + ".json")) as f:
        g = json.load(f)
    o = g["config"]
    assert o["problem"] == "27pt" and o["solver"] == "async_multadd" and o["seed"] == 0
    st = run_experiment(SolverOptions(**o), device="cpu", draws=JaxAsyncDraws(0))
    assert st.level_n == g["level_n"] and st.level_nnz == g["level_nnz"]
    assert st.cycles == g["cycles"]
    np.testing.assert_allclose(np.asarray(st.history), np.asarray(g["history"]), **HIST)


SMOOTH = {
    "fixed": {"method": "fixed", "fire_prob": 0.6},
    "southwell_exp": {"method": "southwell_exp"},
    "southwell_inv": {"method": "southwell_inv", "sps_alpha": 2.0},
    "sps_min_prob": {"method": "southwell_exp", "sps_min_prob": 0.1},
}


@pytest.mark.parametrize("mode", list(SMOOTH))
def test_async_smooth_follows_the_reference(p5, mode):
    kw = SMOOTH[mode]
    prob, jh, th, b = p5["prob"], p5["jh"], p5["th"], p5["b"]
    want = rsm.async_smooth_solve(
        jh.levels[0].A, jh.levels[0].sm, rsm.AsyncSmoothConfig(**kw),
        rsm.block_neighbor_mask(prob.A, 8), jnp.asarray(b), key=jax.random.PRNGKey(2),
        tol=1e-8, max_cycles=120)
    pA = laplacian_2d_5pt(32, 32).A
    nbr = psm.block_neighbor_mask(pA, 8)
    np.testing.assert_array_equal(nbr, rsm.block_neighbor_mask(prob.A, 8))
    got = psm.async_smooth_solve(
        th.levels[0].A, th.levels[0].sm, psm.AsyncSmoothConfig(**kw), nbr,
        torch.from_numpy(b), draws=JaxSmoothDraws(2), tol=1e-8, max_cycles=120, device="cpu")
    assert got.iters == int(want.iters)
    np.testing.assert_allclose(_hist(got), _hist(want), **HIST)
    assert got.block_updates.tolist() == np.asarray(want.block_updates).tolist()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), **HIST)


@pytest.mark.parametrize("async_", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("explicit", [False, True], ids=["implicit", "explicit"])
def test_ext_solve_follows_the_reference(p5, explicit, async_):
    jh, th, hh, b = p5["jh"], p5["th"], p5["hh"], p5["b"]
    fire, delay = (0.6, 3) if async_ else (1.0, 0)
    want_ext = rext.build_extended_system(hh, rhi.HierarchyParams(), explicit=explicit)
    want_c = r_eigs(lambda op, u: op[0].inv_wdiag * rext.ext_matvec(op[0], op[1], u),
                    want_ext.offsets[-1], jnp.float64, num_iters=20, range_start=True,
                    operand=(want_ext, jh.levels[0].A))
    want = rext.ext_solve(jh, want_ext, jnp.asarray(b), tol=1e-8, max_cycles=50,
                          cheby_coeffs=want_c, async_fire_prob=fire, sim_read_delay=delay,
                          key=jax.random.PRNGKey(1))
    # the reference's host hierarchy carried across: both extended systems
    # come from one hierarchy, whichever coarsening the reference loaded
    got_ext = pext.build_extended_system(port_host_hierarchy(hh), HierarchyParams(),
                                         explicit=explicit, device="cpu")
    assert got_ext.offsets == want_ext.offsets
    np.testing.assert_allclose(got_ext.inv_wdiag.numpy(), np.asarray(want_ext.inv_wdiag),
                               rtol=1e-14)
    got_c = p_eigs(lambda op, u: op[0].inv_wdiag * pext.ext_matvec(op[0], op[1], u),
                   got_ext.offsets[-1], torch.float64, num_iters=20, range_start=True,
                   operand=(got_ext, th.levels[0].A))
    np.testing.assert_allclose(np.array(got_c), np.array(want_c), rtol=1e-12)
    got = pext.ext_solve(th, got_ext, torch.from_numpy(b), tol=1e-8, max_cycles=50,
                         cheby_coeffs=got_c, async_fire_prob=fire, sim_read_delay=delay,
                         draws=JaxExtDraws(1), device="cpu")
    assert got.iters == int(want.iters)
    np.testing.assert_allclose(_hist(got), _hist(want), **HIST)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), **HIST)
