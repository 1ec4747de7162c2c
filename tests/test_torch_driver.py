"""The port's solve driver against the JAX package's, on the CPU in float64,
and three goldens of the JAX package reproduced by the port alone.

On one hierarchy of the reference carried across (tests/torch_parity.py),
`solve` must take the reference's iterations with the same history (rtol
1e-10, atol 1e-14: the goldens' own tolerance, tests/test_golden.py) for
MULT L1-Jacobi, MULT hybrid JGS, Chebyshev after each of the three
eigenvalue estimators (whose bounds agree to 1e-12), Richardson, PCG and the
fixed-count `no_resnorm` mode. The goldens config1 (5-point 32^2, MULT),
config2 (27-point 12^3, Jacobi + Chebyshev) and config9 (27-point 48^3,
MULT) are rebuilt through `amg_tpu_torch` only, with the vectors and
parameters the reference's runner derives from their configuration.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amg_tpu.problems import laplacian_3d_27pt as r_27pt
from amg_tpu.setup import hierarchy as rhi
from amg_tpu.smooth import SmootherType as RSm
from amg_tpu.solve import driver as rdrv
from amg_tpu.solve.cycles import CycleConfig as RCfg
from amg_tpu_torch.problems.laplacian import laplacian_2d_5pt, laplacian_3d_27pt
from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
from amg_tpu_torch.smooth.smoothers import SmootherType
from amg_tpu_torch.solve import driver as pdrv
from amg_tpu_torch.solve.cycles import CycleConfig
from torch_parity import port_hierarchy

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
HIST = dict(rtol=1e-10, atol=1e-14)


def _hist(res):
    h = np.asarray(res.history)
    return h[~np.isnan(h)]


@pytest.fixture(scope="module")
def pairs():
    """smoother -> (reference hierarchy, port hierarchy, b) on the 27-point
    8^3 problem, built on first use."""
    cache = {}

    def get(smoother):
        if smoother not in cache:
            prob = r_27pt(8)
            hh, jh = rhi.build_hierarchy(
                prob.A, rhi.HierarchyParams(smoother=RSm(smoother), block_size=64),
                fine_stencil=prob.stencil)
            b = np.random.default_rng(0).random(prob.n)
            cache[smoother] = (jh, port_hierarchy(jh, host=hh), b)
        return cache[smoother]

    return get


SOLVES = {
    # name: (smoother, solve keywords, cheby_setup method or None)
    "mult l1_jacobi": ("l1_jacobi", {}, None),
    "mult hybrid_jgs": ("hybrid_jgs", {}, None),
    "cheby power": ("jacobi", {"accel": "cheby"}, "power"),
    "cheby lobpcg": ("jacobi", {"accel": "cheby"}, "lobpcg"),
    "cheby lanczos": ("jacobi", {"accel": "cheby"}, "lanczos"),
    "richardson": ("jacobi", {"accel": "richardson"}, "power"),
    "pcg": ("l1_jacobi", {"outer": "pcg"}, None),
    "no_resnorm": ("l1_jacobi", {"no_resnorm": True, "max_cycles": 6}, None),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_solve_matches_the_reference(pairs, case):
    smoother, kw, eig = SOLVES[case]
    jh, th, b = pairs(smoother)
    rcfg, pcfg = RCfg(smoother=RSm(smoother)), CycleConfig(smoother=SmootherType(smoother))
    kw = dict(kw)
    if eig is not None:
        want_c = rdrv.cheby_setup(jh, rcfg, num_iters=20, method=eig)
        got_c = pdrv.cheby_setup(th, pcfg, num_iters=20, method=eig, device="cpu")
        np.testing.assert_allclose(np.array(got_c), np.array(want_c), rtol=1e-12)
        kw_r, kw_p = dict(kw, cheby_coeffs=want_c), dict(kw, cheby_coeffs=got_c)
    else:
        kw_r = kw_p = kw
    want = rdrv.solve(jh, rcfg, jnp.asarray(b), tol=1e-9, **kw_r)
    got = pdrv.solve(th, pcfg, torch.from_numpy(b), tol=1e-9, device="cpu", **kw_p)
    assert got.iters == int(want.iters)
    assert got.history.shape == want.history.shape
    np.testing.assert_allclose(_hist(got), _hist(want), **HIST)
    np.testing.assert_allclose(float(got.rel_resnorm), float(want.rel_resnorm), **HIST)
    if "no_resnorm" not in kw:
        assert float(got.rel_resnorm) <= 1e-9
    assert np.abs(got.x.numpy() - np.asarray(want.x)).max() <= 1e-10 * np.abs(want.x).max()


# the SolverOptions defaults that run_experiment reads for a classical
# single-device solve (amg_tpu/utils/config.py; fixup() changes none of them
# for these configurations)
OPTIONS = {
    "n": 32, "nx": 0, "ny": 0, "nz": 0, "strong_threshold": 0.25, "coarsen_type": "hmis",
    "interp_type": "ext+i", "p_max_elmts": 4, "trunc_factor": 0.0, "max_levels": 25,
    "max_coarse_size": 64, "agg_nl": 0, "add_tr": 0.0, "smooth_weight": None,
    "block_size": 128, "seed": 0, "device_format": "auto", "smoother": "l1_jacobi",
    "num_cycles": 200, "tol": 1e-8, "num_pre_smooth_sweeps": 1, "num_post_smooth_sweeps": 1,
    "accel": "none", "cheby_power_iters": 20, "cheby_eig": "power", "rhs": "rand",
    "init_guess": "zeros",
}
PROBLEMS = {"5pt": lambda o: laplacian_2d_5pt(o["nx"] or o["n"], o["ny"] or o["n"]),
            "27pt": lambda o: laplacian_3d_27pt(o["nx"] or o["n"], o["ny"] or o["n"],
                                                o["nz"] or o["n"])}


@pytest.mark.parametrize("name", ["config1_5pt_mult", "config2_27pt_jacobi_cheby",
                                  "config9_27pt_medium"])
def test_golden_through_the_port_alone(name):
    with open(os.path.join(GOLDEN_DIR, name + ".json")) as f:
        g = json.load(f)
    o = dict(OPTIONS, **g["config"])
    assert o["solver"] == "mult"
    prob = PROBLEMS[o["problem"]](o)
    smoother = SmootherType(o["smoother"])
    params = HierarchyParams(
        strong_threshold=o["strong_threshold"], num_functions=1,
        coarsen_type=o["coarsen_type"], interp_type=o["interp_type"],
        trunc_factor=o["trunc_factor"], p_max_elmts=o["p_max_elmts"],
        max_levels=o["max_levels"], max_coarse_size=o["max_coarse_size"],
        agg_num_levels=o["agg_nl"], add_trunc_factor=o["add_tr"], seed=o["seed"],
        smoother=smoother, smooth_weight=o["smooth_weight"], block_size=o["block_size"],
        keep_stencil_fine=True, setup_type="classical", device_format=o["device_format"],
    )
    hh, hier = build_hierarchy(prob.A, params, fine_stencil=prob.stencil, device="cpu")
    st = hh.stats()
    assert st["n"] == g["level_n"] and st["nnz"] == g["level_nnz"]
    assert st["num_levels"] == g["num_levels"]
    np.testing.assert_allclose(st["operator_complexity"], g["operator_complexity"], rtol=1e-12)
    rng = np.random.default_rng(o["seed"])
    assert o["rhs"] == "rand" and o["init_guess"] == "zeros"
    b = torch.from_numpy(rng.random(prob.n))
    cfg = CycleConfig(smoother=smoother, num_pre_sweeps=o["num_pre_smooth_sweeps"],
                      num_post_sweeps=o["num_post_smooth_sweeps"])
    accel = None if o["accel"] == "none" else o["accel"]
    coeffs = None
    if accel:
        coeffs = pdrv.cheby_setup(hier, cfg, num_iters=o["cheby_power_iters"],
                                  method=o["cheby_eig"], device="cpu")
    res = pdrv.solve(hier, cfg, b, torch.zeros_like(b), tol=o["tol"],
                     max_cycles=o["num_cycles"], accel=accel, cheby_coeffs=coeffs,
                     device="cpu")
    assert res.iters == g["cycles"]
    np.testing.assert_allclose(np.asarray(res.history_list()), np.asarray(g["history"]), **HIST)
