"""The port's smoothed-aggregation setup (amg_tpu_torch/setup/aggregation.py
and `build_hierarchy(setup_type="sa")`) against the JAX package, on the CPU
in float64, on the 2-D 16 x 4 beam (golden config8's) and a 3-D (6, 3, 3)
beam, both with bc "reduce" and the rigid-body modes as candidates.

  * `amalgamate`, `sa_strength`, `aggregate` and `tentative_prolongator`
    step by step on the fine level: integer arrays (sparsity, aggregates)
    exactly, floats (block norms, P_tent, B_coarse) to 1e-12 relative to
    the largest value;
  * `build_hierarchy(setup_type="sa")`: the reference's level sizes, nnz
    and operator complexity (complexity to 1e-12), every level's P to
    1e-12 and its smoother weight to 1e-12;
  * golden config8 (SA + PCG, float64) through the port alone: level_n,
    level_nnz, 33 iterations, history[:5] at the goldens' rtol 1e-10 and the
    whole history within twice the band that the reference's own history
    moves by when one entry of b moves by one ulp (1.8e-8: the beam's PCG
    turns rounding at 1e-16 into 1e-8 by the last iteration, so a history
    summed in any other order than XLA's fused one cannot meet 1e-10 there;
    the port's deviation is 9.9e-9).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amg_tpu.problems.elasticity import elasticity_beam as r_beam
from amg_tpu.setup import aggregation as ragg
from amg_tpu.setup import hierarchy as rhi
from amg_tpu.solve import CycleConfig as RCfg
from amg_tpu.solve import driver as rdrv
from amg_tpu_torch.problems.elasticity import elasticity_beam
from amg_tpu_torch.setup import aggregation as pagg
from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
from amg_tpu_torch.utils.config import SolverOptions
from amg_tpu_torch.utils.runner import run_experiment
from torch_parity import reference_native

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def reference_library():
    """The reference's "hmis" hierarchies here are its native library's,
    which these tests compare the port's own setup with (ROADMAP F11)."""
    reference_native()

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
HIST = dict(rtol=1e-10, atol=1e-14)
BEAMS = {"2d-16x4": dict(nx=16, ny=4), "3d-6x3x3": dict(nx=6, ny=3, nz=3)}


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1.0))


def _same_sparse(got, want, tol=1e-12):
    """Two CSR matrices (scipy or the packages' CSRMatrix): the same sparsity
    exactly, values to tol."""
    for f in ("indptr", "indices"):
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))), f
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.data, want.data, tol)


@pytest.mark.parametrize("beam", list(BEAMS), ids=str)
def test_sa_steps_equal_reference(beam):
    got_p, want_p = elasticity_beam(**BEAMS[beam]), r_beam(**BEAMS[beam])
    nf = got_p.num_functions
    C, Cw = pagg.amalgamate(got_p.A, nf), ragg.amalgamate(want_p.A, nf)
    _same_sparse(C, Cw)
    S, Sw = pagg.sa_strength(C, 0.0), ragg.sa_strength(Cw, 0.0)
    _same_sparse(S, Sw)
    # a threshold that drops couplings
    _same_sparse(pagg.sa_strength(C, 0.3), ragg.sa_strength(Cw, 0.3))
    agg, aggw = pagg.aggregate(S), ragg.aggregate(Sw)
    assert agg.dtype == aggw.dtype and np.array_equal(agg, aggw)
    assert agg.max() > 0
    P, Bc = pagg.tentative_prolongator(agg, got_p.near_nullspace, nf)
    Pw, Bcw = ragg.tentative_prolongator(aggw, np.asarray(want_p.near_nullspace), nf)
    _same_sparse(P, Pw)
    _close(Bc, Bcw)
    # exact candidate reproduction
    _close(P.to_scipy() @ Bc, got_p.near_nullspace)


@pytest.mark.parametrize("beam", list(BEAMS), ids=str)
def test_sa_hierarchy_equals_reference(beam):
    got_p, want_p = elasticity_beam(**BEAMS[beam]), r_beam(**BEAMS[beam])
    nf = got_p.num_functions
    hh, hier = build_hierarchy(got_p.A, HierarchyParams(num_functions=nf, setup_type="sa",
                                                        max_coarse_size=20),
                               near_nullspace=got_p.near_nullspace, device="cpu")
    whh = ragg.build_sa_host_hierarchy(
        want_p.A, rhi.HierarchyParams(num_functions=nf, setup_type="sa", max_coarse_size=20),
        B=want_p.near_nullspace)
    st, wst = hh.stats(), whh.stats()
    assert st["n"] == wst["n"] and st["nnz"] == wst["nnz"] and len(st["n"]) >= 2
    np.testing.assert_allclose(st["operator_complexity"], wst["operator_complexity"],
                               rtol=1e-12)
    for lv, wlv in zip(hh.levels, whh.levels):
        np.testing.assert_allclose(lv.weight, wlv.weight, rtol=1e-12)
        if wlv.P is not None:
            _same_sparse(lv.P, wlv.P)
            _same_sparse(lv.R, wlv.R)
    assert hier.num_levels == len(st["n"])


def test_golden_config8_through_the_port_alone():
    with open(os.path.join(GOLDEN_DIR, "config8_elasticity_sa_pcg.json")) as f:
        g = json.load(f)
    c = g["config"]
    # the runner's fix-up for elasticity: setup "auto" -> "sa", MULT under PCG
    st = run_experiment(SolverOptions(**c), device="cpu")
    assert st.level_n == g["level_n"] and st.level_nnz == g["level_nnz"]
    np.testing.assert_allclose(st.operator_complexity, g["operator_complexity"], rtol=1e-12)
    assert st.cycles == g["cycles"]
    got, want = np.asarray(st.history), np.asarray(g["history"])
    np.testing.assert_allclose(got[:5], want[:5], **HIST)
    # the reference's own history with one entry of b moved by one ulp
    prob = elasticity_beam(nx=c["nx"], ny=c["ny"])
    whh, wh = rhi.build_hierarchy(r_beam(nx=c["nx"], ny=c["ny"]).A,
                                  rhi.HierarchyParams(num_functions=2, setup_type="sa"),
                                  near_nullspace=prob.near_nullspace)
    bp = prob.rhs / np.linalg.norm(prob.rhs)
    i = int(np.argmax(np.abs(bp)))
    bp[i] = np.nextafter(bp[i], np.inf)
    moved = rdrv.solve(wh, RCfg(), jnp.asarray(bp), jnp.zeros(len(bp)), tol=1e-8,
                       max_cycles=200, outer="pcg")
    hm = np.asarray(moved.history)
    band = np.max(np.abs(hm[~np.isnan(hm)] - want) / want)
    assert int(moved.iters) == g["cycles"] and 1e-10 < band < 1e-6
    assert np.max(np.abs(got - want) / want) <= 2 * band
