"""The port's Maxwell problem and AMS preconditioner
(amg_tpu_torch/problems/maxwell.py, amg_tpu_torch/solve/ams.py) against the
JAX package, on the CPU in float64.

  * `maxwell_curlcurl` at n = 4: A, G, Pi and the load equal the
    reference's exactly (the same host arithmetic);
  * `ams_precondition` on the reference's AMS state carried across
    (`convert.ams_from_arrays`): to 1e-12 relative to the largest value;
    `build_ams` of the port itself gives the same nodal hierarchies (level
    sizes) and the same preconditioner to 1e-12;
  * `ams_async_additive_solve` at n = 4 under the reference's key chain
    replayed (`JaxAMSDraws`): the eigenvalue bounds behind omega="auto" to
    1e-12, then the same steps and the history to rtol 1e-8, with and
    without the asynchronous Chebyshev;
  * golden config5 (Maxwell n = 6, AMS-PCG) through the port alone: level_n,
    level_nnz and complexity of the runner's hierarchy on the edge matrix, 20
    iterations and the history at the goldens' rtol 1e-10.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amg_tpu.problems.maxwell import maxwell_curlcurl as r_maxwell
from amg_tpu.setup.hierarchy import HierarchyParams as RParams
from amg_tpu.setup.hierarchy import _format_converter as r_format
from amg_tpu.solve import ams as rams
from amg_tpu_torch.convert import ams_from_arrays, matrix_from_arrays
from amg_tpu_torch.problems.maxwell import maxwell_curlcurl
from amg_tpu_torch.setup.hierarchy import HierarchyParams, _format_converter
from amg_tpu_torch.solve import ams as pams
from amg_tpu_torch.utils.config import SolverOptions
from amg_tpu_torch.utils.runner import run_experiment
from torch_parity import (
    JaxAMSDraws,
    export_jax_ams,
    jax_async_ams_eigs,
    jax_build_ams_with_hosts,
    level_sizes,
    reference_native,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def reference_library():
    """The reference's "hmis" hierarchies here are its native library's,
    which these tests compare the port's own setup with (ROADMAP F11)."""
    reference_native()

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
HIST = dict(rtol=1e-10, atol=1e-14)


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1.0))


def _edge_op(A):
    return matrix_from_arrays(_format_converter(HierarchyParams())(A), torch.float64, "cpu")


@pytest.fixture(scope="module")
def n4():
    return maxwell_curlcurl(4), r_maxwell(4)


def test_maxwell_curlcurl_equals_reference(n4):
    got, want = n4
    for name, g, w in (("A", got.A, want.A), ("G", got.aux["G"], want.aux["G"]),
                       ("Pi", got.aux["Pi"], want.aux["Pi"])):
        for f in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(g, f), getattr(w, f)), (name, f)
        assert g.shape == w.shape, name
    assert np.array_equal(got.rhs, want.rhs)
    assert (got.stencil, got.grid_shape, got.name) == (None, None, "maxwell")


def test_ams_precondition_equals_reference(n4, monkeypatch):
    got_p, want_p = n4
    G, Pi = want_p.aux["G"], want_p.aux["Pi"]
    jams, jcfg, hosts = jax_build_ams_with_hosts(monkeypatch, want_p.A, G, Pi=Pi)
    carried = ams_from_arrays(export_jax_ams(jams, hosts, G, Pi), device="cpu")
    own, cfg = pams.build_ams(got_p.A, got_p.aux["G"], Pi=got_p.aux["Pi"], device="cpu")
    assert level_sizes(own.node_hier) == jams.node_hier.level_sizes()
    assert level_sizes(own.pi_hier) == jams.pi_hier.level_sizes()
    r = np.random.default_rng(5).random(got_p.n)
    want = rams.ams_precondition(jams, jcfg, jnp.asarray(r))
    for ams in (carried, own):
        _close(pams.ams_precondition(ams, cfg, torch.from_numpy(r)), want)


@pytest.mark.parametrize("accel", ["none", "cheby"])
def test_async_ams_replays_the_reference(n4, accel):
    got_p, want_p = n4
    jams, _ = rams.build_ams(want_p.A, want_p.aux["G"], Pi=want_p.aux["Pi"])
    ams, _ = pams.build_ams(got_p.A, got_p.aux["G"], Pi=got_p.aux["Pi"], device="cpu")
    jA = r_format(RParams())(want_p.A, jnp.float64)
    A = _edge_op(got_p.A)
    want_eigs = jax_async_ams_eigs(jA, jams)
    got_eigs = pams.async_ams_eigs(A, ams)
    np.testing.assert_allclose([got_eigs.alpha, got_eigs.beta],
                               [float(want_eigs.alpha), float(want_eigs.beta)], rtol=1e-12)
    b = got_p.rhs / np.linalg.norm(got_p.rhs)
    kw = dict(fire_prob=0.8, sim_read_delay=2, tol=1e-8, max_cycles=400, accel=accel,
              cheby_damp=0.5)
    want = rams.ams_async_additive_solve(jA, jams, jnp.asarray(b), key=jax.random.PRNGKey(0),
                                         **kw)
    got = pams.ams_async_additive_solve(A, ams, b, draws=JaxAMSDraws(0), device="cpu", **kw)
    assert got.iters == int(want.iters)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(want.history),
                               rtol=1e-8, atol=1e-14)


def test_golden_config5_through_the_port_alone():
    with open(os.path.join(GOLDEN_DIR, "config5_maxwell_ams.json")) as f:
        g = json.load(f)
    assert g["config"]["outer_solver"] == "ams_pcg"
    # the runner's hierarchy on the edge matrix, which its stats report (the
    # AMS solve builds its own nodal hierarchies)
    st = run_experiment(SolverOptions(**g["config"]), device="cpu")
    assert st.level_n == g["level_n"] and st.level_nnz == g["level_nnz"]
    np.testing.assert_allclose(st.operator_complexity, g["operator_complexity"], rtol=1e-12)
    assert st.cycles == g["cycles"]
    np.testing.assert_allclose(np.asarray(st.history), np.asarray(g["history"]), **HIST)
