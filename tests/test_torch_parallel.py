"""The port's row-partitioned hierarchy and solves (amg_tpu_torch/parallel/
dist.py, the sharded AMS-PCG, the runner's row-sharded branches, the
multi-device dry run) against the JAX package's on the CPU in float64, over
8 shards (the reference on its 8 virtual devices, the port in one process).
Both packages build from one host hierarchy (the reference's, carried
across) where the test is about the distributed structures, not the
coarsening.

  * padding and unpadding; `build_dist_hierarchy` in both comm modes and
    both pad units: every level's shapes, smoother vectors and the coarse
    inverse equal the reference's; one MULT and one smoothed MULTADD cycle
    on it within 1e-12;
  * goldens config7 (27-point 12^3, halo) and config4 (elasticity beam,
    PCG, halo) through the port's runner alone: cycles, level_n,
    history[:5] at the goldens' rtol 1e-10 and the final residual;
  * the runner's sharded AMS-PCG and the sharded solves of the structured
    and the gspmd branches against the reference's runner; the sharded
    AMS-PCG itself; the halo traffic `profile_phases` reports;
  * `shard_structured_hierarchy` and `dryrun_multichip(8, "cpu")`.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amg_tpu.parallel import make_row_mesh as r_mesh
from amg_tpu.parallel import dist as rdist
from amg_tpu.problems import laplacian_3d_27pt as r27
from amg_tpu.setup import hierarchy as rhi
from amg_tpu.smooth import SmootherType as RSm
from amg_tpu.solve import cycles as rcy
from amg_tpu_torch.parallel import dist as pdist
from amg_tpu_torch.parallel import make_row_mesh
from amg_tpu_torch.parallel.spcomm import HaloBSR, HaloELL
from amg_tpu_torch.setup import hierarchy as phi
from amg_tpu_torch.smooth.smoothers import SmootherType
from amg_tpu_torch.solve import cycles as pcy
from amg_tpu_torch.utils.config import SolverOptions
from amg_tpu_torch.utils.runner import run_experiment
from torch_parity import port_host_hierarchy, reference_native

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
HIST = dict(rtol=1e-10, atol=1e-14)
D = 8


@pytest.fixture(scope="module", autouse=True)
def reference_library():
    """The AMS-PCG and runner comparisons build the reference's "hmis"
    hierarchies beside the port's own: its native library's (ROADMAP F11)."""
    reference_native()


@pytest.fixture(scope="module")
def meshes():
    return r_mesh(D), make_row_mesh(D, "cpu")


@pytest.fixture(scope="module")
def host():
    """The reference's host hierarchy of the 27-point 10^3 problem and the
    same hierarchy in the port's types."""
    hh = rhi.build_host_hierarchy(r27(10).A, rhi.HierarchyParams(max_coarse_size=20))
    return hh, port_host_hierarchy(hh)


def _params(fmt):
    return (rhi.HierarchyParams(smoother=RSm.L1_JACOBI, keep_stencil_fine=False,
                                device_format=fmt),
            phi.HierarchyParams(smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False,
                                device_format=fmt))


def _dist(host, meshes, comm, fmt):
    rp, pp = _params(fmt)
    want, winfo = rdist.build_dist_hierarchy(host[0], rp, meshes[0], comm=comm)
    got, ginfo = pdist.build_dist_hierarchy(host[1], pp, meshes[1], comm=comm)
    return want, winfo, got, ginfo


def test_pad_and_unpad(meshes):
    x = np.random.default_rng(0).random(1000)
    want = np.asarray(rdist.pad_vector(jnp.asarray(x), (1000, 1024), meshes[0]))
    got = pdist.pad_vector(torch.from_numpy(x), (1000, 1024), meshes[1])
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (1024,) and not got[1000:].any()
    np.testing.assert_array_equal(pdist.unpad_vector(got, (1000, 1024), meshes[1]).numpy(), x)
    np.testing.assert_array_equal(pdist.shard_vector(got, meshes[1]).numpy(), want)


MODES = [("halo", "ell"), ("halo", "auto"), ("gspmd", "ell"), ("gspmd", "auto")]


@pytest.mark.parametrize("comm,fmt", MODES)
def test_dist_hierarchy_levels_equal_the_reference(host, meshes, comm, fmt):
    want, winfo, got, ginfo = _dist(host, meshes, comm, fmt)
    assert ginfo == winfo and got.mesh is meshes[1]
    assert got.num_levels == want.num_levels
    for g, w in zip(got.levels, want.levels):
        assert tuple(g.A.shape) == tuple(w.A.shape)
        if comm == "halo":
            # the port's "auto" format is ELL (PERF.md); the reference takes
            # HaloBSR where its 8 x 8 tile fits
            assert isinstance(g.A, HaloELL)
        for name in ("P", "R", "P_s", "R_s", "P_id", "R_id"):
            gm, wm = getattr(g, name), getattr(w, name)
            assert (gm is None) == (wm is None), name
            if gm is not None:
                assert tuple(gm.shape) == tuple(wm.shape), name
        for name in ("scale", "inv_wscale", "w"):
            np.testing.assert_array_equal(getattr(g.sm, name).numpy(),
                                          np.asarray(getattr(w.sm, name)))
    np.testing.assert_allclose(got.coarse_Ainv.numpy(), np.asarray(want.coarse_Ainv),
                               rtol=0, atol=1e-14 * np.abs(np.asarray(want.coarse_Ainv)).max())


@pytest.mark.parametrize("cycle", ["mult", "multadd"])
@pytest.mark.parametrize("comm,fmt", MODES)
def test_one_cycle_equals_the_reference(host, meshes, comm, fmt, cycle):
    want_h, info, got_h, _ = _dist(host, meshes, comm, fmt)
    kw = {"use_smoothed_transfers": True} if cycle == "multadd" else {}
    rcfg = rcy.CycleConfig(cycle=rcy.CycleType(cycle), smoother=RSm.L1_JACOBI, **kw)
    pcfg = pcy.CycleConfig(cycle=pcy.CycleType(cycle), smoother=SmootherType.L1_JACOBI, **kw)
    b = np.random.default_rng(1).random(info[0])
    bw = rdist.pad_vector(jnp.asarray(b), info, meshes[0])
    want = np.asarray(jax.jit(lambda x, f: rcy.cycle_step(want_h, rcfg, x, f))(
        jnp.zeros_like(bw), bw))
    bg = pdist.pad_vector(torch.from_numpy(b), info, meshes[1])
    got = pcy.cycle_step(got_h, pcfg, torch.zeros_like(bg), bg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    assert not got[info[0]:].any()  # the pad rows stay zero


def test_the_port_takes_halo_bsr_under_bsr_auto(meshes):
    """"bsr_auto" is the port's blocked format: HaloBSR where the cost
    model's tile fits D tiles, with the same cycle."""
    hh = port_host_hierarchy(rhi.build_host_hierarchy(r27(16).A, rhi.HierarchyParams()))
    mesh = meshes[1]
    params = phi.HierarchyParams(keep_stencil_fine=False, device_format="bsr_auto")
    got, info = pdist.build_dist_hierarchy(hh, params, mesh, comm="halo")
    ell, _ = pdist.build_dist_hierarchy(hh, phi.HierarchyParams(keep_stencil_fine=False),
                                        mesh, comm="halo")
    assert isinstance(got.levels[0].A, HaloBSR)
    cfg = pcy.CycleConfig()
    b = pdist.pad_vector(torch.from_numpy(np.random.default_rng(2).random(info[0])), info, mesh)
    want = pcy.mult_vcycle(ell, cfg, torch.zeros_like(b), b)
    got_x = pcy.mult_vcycle(got, cfg, torch.zeros_like(b), b)
    np.testing.assert_allclose(got_x.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["config7_halo_dist_mult", "config4_elasticity_dist"])
def test_golden_through_the_port_alone(name):
    with open(os.path.join(GOLDEN_DIR, name + ".json")) as f:
        g = json.load(f)
    assert g["config"]["num_devices"] == 8 and g["config"]["comm"] == "halo"
    st = run_experiment(SolverOptions(**g["config"]), device="cpu")
    assert st.level_n == g["level_n"] and st.level_nnz == g["level_nnz"]
    assert st.num_levels == g["num_levels"]
    np.testing.assert_allclose(st.operator_complexity, g["operator_complexity"], rtol=1e-12)
    assert st.cycles == g["cycles"]
    np.testing.assert_allclose(st.history[:5], g["history"][:5], **HIST)
    assert st.rel_resnorm <= SolverOptions(**g["config"]).tol
    assert st.x.shape == (st.n,)  # unpadded


def _both_runners(draws=None, **kw):
    from amg_tpu.utils.config import SolverOptions as RSolverOptions
    from amg_tpu.utils.runner import run_experiment as r_run

    return r_run(RSolverOptions(**kw)), run_experiment(SolverOptions(**kw), device="cpu",
                                                       draws=draws)


@pytest.mark.parametrize("kw", [
    dict(problem="maxwell", nx=6, outer_solver="ams_pcg", tol=1e-8),
    dict(problem="27pt", n=16, hierarchy="structured"),
    dict(problem="5pt", n=20, comm="gspmd"),
    dict(problem="5pt", n=20, solver="multadd", one_interpolant=True),
    # the data-parallel async solve on the row-sharded hierarchy, under the
    # reference's draws
    dict(problem="5pt", n=20, solver="async_multadd", grid_parallel=False, seed=0),
], ids=["ams_pcg", "structured", "gspmd", "multadd", "async_rows"])
def test_runner_branches_equal_the_reference(kw):
    from torch_parity import JaxAsyncDraws

    draws = JaxAsyncDraws(0) if kw.get("solver") == "async_multadd" else None
    want, got = _both_runners(draws=draws, num_devices=D, **kw)
    assert got.cycles == want.cycles and got.level_n == want.level_n
    np.testing.assert_allclose(got.history, want.history, rtol=1e-8, atol=1e-14)
    assert got.rel_resnorm <= SolverOptions(**kw).tol


@pytest.mark.parametrize("cycle", ["mult", "multadd"])
def test_profile_phases_counts_the_halo_traffic(host, meshes, cycle):
    """The segmented cycle's per-level halo bytes and messages on a halo
    hierarchy (comm_trace; one message per halo matvec): the MULT cycle's
    equal the reference's traced counts; the additive cycle's equal the
    traffic of one cycle, traced whole, less its level-0 residual (the
    reference reports 0 there: its counting pass re-traces nothing,
    ROADMAP F12)."""
    from amg_tpu.utils.phases import profile_phases as r_profile
    from amg_tpu_torch.parallel.spcomm import comm_trace
    from amg_tpu_torch.utils.phases import profile_phases as p_profile

    want_h, info, got_h, _ = _dist(host, meshes, "halo", "ell")
    kw = {"use_smoothed_transfers": True} if cycle == "multadd" else {}
    rcfg = rcy.CycleConfig(cycle=rcy.CycleType(cycle), smoother=RSm.L1_JACOBI, **kw)
    pcfg = pcy.CycleConfig(cycle=pcy.CycleType(cycle), smoother=SmootherType.L1_JACOBI, **kw)
    b = np.random.default_rng(4).random(info[0])
    bp = pdist.pad_vector(torch.from_numpy(b), info, meshes[1])
    got = p_profile(got_h, pcfg, bp, num_cycles=1)
    assert meshes[1].trace is None and got.totals()["comm_bytes_per_cycle"] > 0
    if cycle == "mult":
        want = r_profile(want_h, rcfg, rdist.pad_vector(jnp.asarray(b), info, meshes[0]),
                         num_cycles=1)
        assert got.comm_bytes == [int(v) for v in want.comm_bytes]
        assert got.comm_msgs == [int(v) for v in want.comm_msgs]
        return
    with comm_trace(meshes[1]) as log:
        pcy.cycle_step(got_h, pcfg, torch.zeros_like(bp), bp)
    resid0 = got_h.levels[0].A.comm_bytes_per_matvec()
    assert sum(got.comm_bytes) == sum(log) - resid0
    assert sum(got.comm_msgs) == len(log) - 1


def test_sharded_ams_pcg_equals_the_reference(meshes):
    from amg_tpu.problems.maxwell import maxwell_curlcurl as r_maxwell
    from amg_tpu.solve import ams as rams
    from amg_tpu_torch.problems.maxwell import maxwell_curlcurl
    from amg_tpu_torch.solve import ams as pams

    rp, pp = r_maxwell(4), maxwell_curlcurl(4)
    A_r, ams_r, cfg_r, pad_r, padn_r = rams.build_sharded_ams(rp.A, rp.aux["G"], meshes[0],
                                                              Pi=rp.aux["Pi"])
    A_p, ams_p, cfg_p, pad_p, padn_p = pams.build_sharded_ams(pp.A, pp.aux["G"], meshes[1],
                                                              Pi=pp.aux["Pi"])
    assert (pad_p, padn_p) == (tuple(pad_r), tuple(padn_r))
    want = rams.solve_sharded_ams_pcg(A_r, ams_r, cfg_r, jnp.asarray(rp.rhs), meshes[0], pad_r,
                                      tol=1e-8)
    got = pams.solve_sharded_ams_pcg(A_p, ams_p, cfg_p, torch.from_numpy(pp.rhs), meshes[1],
                                     pad_p, tol=1e-8)
    assert got.iters == int(want.iters) and got.x.shape == (pp.n,)
    h = np.asarray(want.history)
    np.testing.assert_allclose(got.history.numpy(), h, rtol=1e-8, atol=1e-14)
    r = pp.rhs - pp.A.to_scipy() @ got.x.numpy()
    assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(pp.rhs)


def test_structured_hierarchy_on_the_mesh(meshes):
    from amg_tpu_torch.problems import laplacian_3d_27pt
    from amg_tpu_torch.setup.structured import build_structured_hierarchy
    from amg_tpu_torch.solve.driver import solve

    prob = laplacian_3d_27pt(16)
    _, hier = build_structured_hierarchy(prob.stencil, device="cpu")
    sharded = pdist.shard_structured_hierarchy(hier, meshes[1])
    assert sharded.mesh is meshes[1] and sharded.levels is hier.levels
    b = torch.from_numpy(np.random.default_rng(3).random(prob.n))
    want, got = solve(hier, pcy.CycleConfig(), b, device="cpu"), \
        solve(sharded, pcy.CycleConfig(), b, device="cpu")
    assert got.iters == want.iters and torch.equal(got.x, want.x)
    with pytest.raises(ValueError, match="ELL/BSR"):
        pdist.shard_hierarchy(hier, meshes[1])


def test_dryrun_multichip_on_the_cpu(host, meshes):
    """The port's dry run inside the reference's gates, at the reference's
    own numbers: its MULT + MULTADD step on the 5-point 16^2 problem."""
    from amg_tpu.problems import laplacian_2d_5pt
    from amg_tpu_torch.utils.dryrun import dryrun_multichip

    out = dryrun_multichip(D, "cpu")
    prob = laplacian_2d_5pt(16)
    params = rhi.HierarchyParams(smoother=RSm.L1_JACOBI, keep_stencil_fine=False)
    hier, info = rdist.build_dist_hierarchy(rhi.build_host_hierarchy(prob.A, params), params,
                                            meshes[0])
    b = rdist.pad_vector(jnp.asarray(np.random.default_rng(0).random(prob.n)), info, meshes[0])
    x = rcy.mult_vcycle(hier, rcy.CycleConfig(smoother=RSm.L1_JACOBI), jnp.zeros_like(b), b)
    x = rcy.sync_additive_cycle(hier, rcy.CycleConfig(
        cycle=rcy.CycleType.MULTADD, smoother=RSm.L1_JACOBI, use_smoothed_transfers=True), x, b)
    rel = float(jnp.linalg.norm(b - hier.levels[0].A @ x) / jnp.linalg.norm(b))
    for comm in ("halo", "gspmd"):
        assert abs(out[f"mult_add_rel_{comm}"] - rel) <= 1e-12 * rel
    assert out["halo_matvec_err"] <= 1e-13 and out["dia_iters"] <= 50
    assert out["dia_rel"] <= 1e-8
