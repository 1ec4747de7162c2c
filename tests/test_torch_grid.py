"""The port's grid (level) parallelism (amg_tpu_torch/parallel/{partition,
grid}.py, `pad_extended_layout`, `build_sharded_extended_system`, the AMS
groups of solve/ams.py, the runner's grid branches) against the JAX
package's, on the CPU in float64, over a mesh of logical shards in one
process. The reference's grid solves are stored by
`tools/torch_grid_reference.py` (tools/torch_grid_reference.json: its runs
on 8 virtual devices); the port replays their draws (`JaxAsyncDraws`,
`JaxAMSDraws`) on its own hierarchy of the same problem.

  * the work model and the assignment (both policies, fewer devices than
    levels, the imbalance draw) and `pad_extended_layout`, live;
  * `plan_grid_levels` (every level's scales sum to 1) and
    `plan_ams_groups`;
  * the owned storage: every shard's field set and bytes equal the
    reference's, its views share the hierarchy's tensors, compute its
    levels' corrections bit for bit and raise on any other level's;
  * the grid solve against the port's own `async_solve` under the same
    draws (SEMI, FULL, wait counters, updated residuals): the iterations,
    the grid-wait counts, x at rtol 1e-9 / atol 1e-12 and the history at
    rtol 1e-8 / atol 1e-13, the band the reference's own grid solve keeps to
    its async_solve (tests/test_grid_parallel.py);
  * the grid solve against the reference's where async_solve has no
    counterpart (comm_every 2, local convergence) and in the asynchronous
    Chebyshev and a fail window, at the same band;
  * the grid-mapped extended system: its padded offsets, inv_wdiag and AA
    equal the reference's (stored), the embedded rows' matvec equals the
    unpadded system's, the padding rows are the identity, its halo bytes;
  * `ams_grid_parallel_solve` against the reference's and the port's
    single-device async AMS;
  * goldens config6 (132 steps) and config12 (319) through the port's
    run_experiment under the replayed draws: level_n, level_nnz, the step
    count exactly (no step of either history lies within 1e-12 of tol) and
    the history at the band above.
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from amg_tpu.parallel import dist as rdist
from amg_tpu.parallel import grid as rgrid
from amg_tpu.parallel import partition as rpart
from amg_tpu.problems import laplacian_2d_5pt as r_5pt
from amg_tpu.setup import hierarchy as rhi
from amg_tpu.smooth import SmootherType as RSm
from amg_tpu_torch.convert import matrix_from_arrays
from amg_tpu_torch.parallel import dist as pdist
from amg_tpu_torch.parallel import grid as pgrid
from amg_tpu_torch.parallel import make_row_mesh
from amg_tpu_torch.parallel import partition as ppart
from amg_tpu_torch.parallel.spcomm import HaloELL, comm_trace
from amg_tpu_torch.problems.laplacian import laplacian_2d_5pt
from amg_tpu_torch.problems.maxwell import maxwell_curlcurl
from amg_tpu_torch.setup.hierarchy import HierarchyParams, _format_converter, build_hierarchy
from amg_tpu_torch.smooth.smoothers import SmootherType
from amg_tpu_torch.solve import ams as pams
from amg_tpu_torch.solve import extended as pext
from amg_tpu_torch.solve.async_sim import AsyncConfig, async_solve
from amg_tpu_torch.solve.cycles import CycleConfig, CycleType, additive_correction
from amg_tpu_torch.utils.config import SolverOptions
from amg_tpu_torch.utils.runner import run_experiment
from torch_parity import JaxAMSDraws, JaxAsyncDraws, port_host_hierarchy, reference_native

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
X = dict(rtol=1e-9, atol=1e-12)
HIST = dict(rtol=1e-8, atol=1e-13)
CFG = CycleConfig(cycle=CycleType.MULTADD, smoother=SmootherType.L1_JACOBI,
                  use_smoothed_transfers=True)


@pytest.fixture(scope="module")
def ref():
    with open(os.path.join(ROOT, "tools", "torch_grid_reference.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def p32():
    """The reference's grid fixture (tests/test_grid_parallel.py) built by
    the port: 5-point 32^2, L1-Jacobi, no stencil on level 0."""
    prob = laplacian_2d_5pt(32)
    hh, hier = build_hierarchy(
        prob.A, HierarchyParams(smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False),
        device="cpu")
    b = torch.from_numpy(np.random.default_rng(0).random(prob.n))
    return prob, hh, hier, b


class Recorded:
    """A draw source that records another's draws as it hands them on;
    `replay()` gives them again in the same order (one JAX key chain walked
    for two solves)."""

    def __init__(self, src):
        self.src, self.log = src, []

    def _keep(self, v):
        self.log.append(v)
        return v

    def wait_uniforms(self, L):
        return self._keep(self.src.wait_uniforms(L))

    def step(self, L):
        return self._keep(self.src.step(L))

    def read_scalar(self, lvl):
        return self._keep(self.src.read_scalar(lvl))

    def read_rows(self, lvl, n, dtype, device):
        return self._keep(self.src.read_rows(lvl, n, dtype, device))

    def replay(self):
        log = iter(self.log)
        nxt = lambda *a: next(log)  # noqa: E731
        return type("Replay", (), {"wait_uniforms": nxt, "step": nxt, "read_scalar": nxt,
                                   "read_rows": nxt})()


WORKS = [np.array([0.55, 0.25, 0.12, 0.08]), np.array([0.5, 0.25, 0.13, 0.07, 0.05]),
         np.random.default_rng(1).random(7), np.array([0.9, 0.05, 0.03, 0.02])]


@pytest.mark.parametrize("D", [3, 4, 8])
@pytest.mark.parametrize("policy", ["balanced", "scalar"])
def test_assignment_and_layout_equal_the_reference(D, policy):
    for w in WORKS:
        w = w / w.sum()
        for scalar in (0.5, 0.3):
            want = rpart.assign_levels_to_devices(w, D, policy=policy, scalar=scalar)
            got = ppart.assign_levels_to_devices(w, D, policy=policy, scalar=scalar)
            assert got == want
        sizes = [int(1000 * v) + 3 for v in w]
        want = rdist.pad_extended_layout(sizes, want, D)
        got = pdist.pad_extended_layout(sizes, got, D)
        assert got[0] == want[0] and got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("D", [3, 4, 8])
def test_work_model_and_plan_equal_the_reference(D):
    reference_native()
    prob = r_5pt(32)
    hh = rhi.build_host_hierarchy(prob.A, rhi.HierarchyParams(smoother=RSm.L1_JACOBI,
                                                              keep_stencil_fine=False))
    th = port_host_hierarchy(hh)
    for kw in ({}, {"smoothed_transfers": True}, {"imbalance": 0.7},
               {"assign_policy": "scalar", "assign_scalar": 0.4}):
        wk = {k: v for k, v in kw.items() if k in ("smoothed_transfers", "imbalance")}
        np.testing.assert_array_equal(ppart.compute_level_work(th, **wk),
                                      rpart.compute_level_work(hh, **wk))
        np.testing.assert_array_equal(ppart.compute_level_work(th, async_mode=False, **wk),
                                      rpart.compute_level_work(hh, async_mode=False, **wk))
        want = rgrid.plan_grid_levels(hh, D, **kw)
        got = pgrid.plan_grid_levels(th, D, **kw)
        assert got[0] == want[0] and got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        sums = np.zeros(hh.num_levels)
        for ls in got[1]:
            for k in ls:
                sums[k] += got[2][k]
        np.testing.assert_allclose(sums, 1.0, rtol=1e-15)


@pytest.mark.parametrize("name", ["multadd smoothed", "multadd", "afacx", "afacj", "bpx"])
def test_owned_storage_equals_the_reference(p32, ref, name):
    prob, hh, hier, _ = p32
    assert hh.stats()["n"] == ref["level_n"] and hh.stats()["nnz"] == ref["level_nnz"]
    cfg = CycleConfig(cycle=CycleType(name.split()[0]), smoother=SmootherType.L1_JACOBI,
                      use_smoothed_transfers=name.endswith("smoothed"))
    r = torch.from_numpy(np.random.default_rng(3).random(prob.n))
    L = hier.num_levels
    for D in (3, 4, 8):
        want = ref["storage"][f"{name} {D}"]
        _, levels_of, _ = pgrid.plan_grid_levels(hh, D)
        assert [list(ls) for ls in levels_of] == want["levels_of"]
        st = pgrid.build_grid_owned_storage(hier, levels_of, cfg)
        assert [sorted(str(list(k)) for k in keep) for keep in st.keep] == want["keys"]
        assert list(st.owned_bytes) == want["owned_bytes"]
        for d, ls in enumerate(levels_of):
            view = st.views[d]
            for k, lv in enumerate(hier.levels):
                for f in pgrid.LEVEL_FIELDS:
                    full = getattr(lv, f)
                    if (k, f) in st.keep[d] or (k == 0 and f == "A"):
                        # shared with the hierarchy, no copy
                        assert all(a is b for a, b in zip(pgrid._tensors(getattr(
                            view.levels[k], f)), pgrid._tensors(full)))
                    elif full is not None:
                        with pytest.raises(pgrid.FieldNotOwned):
                            getattr(view.levels[k], f)
            raised = 0
            for lvl in range(L):
                try:
                    c = additive_correction(view, cfg, r, lvl)
                except pgrid.FieldNotOwned:
                    assert lvl not in ls
                    raised += 1
                    continue
                # a level it owns, or one its fields happen to cover
                assert torch.equal(c, additive_correction(hier, cfg, r, lvl))
            assert raised >= L - len(ls) - 1


def _grid(hier, hh, acfg, D, draws, max_cycles, b):
    _, levels_of, scale = pgrid.plan_grid_levels(hh, D)
    return pgrid.grid_parallel_solve(hier, CFG, acfg, levels_of, scale, make_row_mesh(D, "cpu"),
                                     b, draws=draws, tol=1e-8, max_cycles=max_cycles)


def _same(got, want_iters, want_x, want_hist):
    assert got.iters == want_iters
    np.testing.assert_allclose(got.x.numpy(), want_x, **X)
    np.testing.assert_allclose(got.history_list(), want_hist, **HIST)


# name: (AsyncConfig keywords, shards, PRNGKey): the reference's own
# grid-vs-async_sim cases, SEMI and FULL, and the other state of the loop
MODES = {
    "semi": ({"omega": 0.7, "fire_prob": 0.6, "sim_read_delay": 2, "async_type": "semi"}, 4, 7),
    "full": ({"omega": 0.7, "fire_prob": 0.6, "sim_read_delay": 2, "async_type": "full"}, 8, 7),
    "wait counters": ({"omega": 0.7, "sim_grid_wait": 3, "sim_read_delay": 2}, 4, 11),
    "semi res update": ({"omega": 0.7, "async_type": "semi", "read_type": "res",
                         "res_mode": "update", "delay_levels": (1,), "delay_prob": 0.3}, 3, 2),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_grid_solve_equals_async_solve(p32, mode):
    prob, hh, hier, b = p32
    kw, D, key = MODES[mode]
    acfg = AsyncConfig(**kw)
    draws = Recorded(JaxAsyncDraws(key))
    want = async_solve(hier, CFG, acfg, b, draws=draws, tol=1e-8, max_cycles=150, device="cpu")
    got = _grid(hier, hh, acfg, D, draws.replay(), 150, b)
    _same(got, want.iters, want.x.numpy(), want.history_list())
    np.testing.assert_array_equal(got.grid_wait.count, want.grid_wait.count)
    assert float(got.rel_resnorm) <= 1e-8


@pytest.mark.parametrize("name", ["comm_every 2 full", "local", "cheby", "fail window"])
def test_grid_solve_equals_the_reference(p32, ref, name):
    prob, hh, hier, b = p32
    want = ref["solves"][name]
    acfg = AsyncConfig(**want["acfg"])
    got = _grid(hier, hh, acfg, want["D"], JaxAsyncDraws(want["key"]), want["max_cycles"], b)
    _same(got, want["iters"], want["x"], want["history"])
    assert got.grid_wait.summary() == want["grid_wait"]


def test_grid_solve_refuses_what_the_reference_refuses(p32):
    prob, hh, hier, b = p32
    for kw, match in (({"comm_every": 2, "read_type": "res"}, "comm_every"),
                      ({"converge_test_type": "local", "res_mode": "update"}, "local"),
                      ({"accel": "cheby", "cheby_mu": 2.0, "cheby_delta": 1.0,
                        "converge_test_type": "local"}, "accel")):
        with pytest.raises(ValueError, match=match):
            _grid(hier, hh, AsyncConfig(**kw), 4, None, 2, b)


def test_device_branch_fn_is_the_shards_corrections(p32):
    prob, hh, hier, b = p32
    acfg = AsyncConfig(async_type="semi", sim_read_delay=2)
    ring = torch.from_numpy(np.random.default_rng(4).random((3, prob.n)))
    cols = [2, 0, 1, 2]
    fn = pgrid.device_branch_fn(hier, CFG, acfg, (1, 3), b)
    want = sum(additive_correction(hier, CFG, b - hier.levels[0].A @ ring[cols[k]], k)
               for k in (1, 3))
    torch.testing.assert_close(fn(ring, cols), want, rtol=0, atol=0)


def test_the_grid_mapped_extended_system(ref):
    prob = laplacian_2d_5pt(24)
    params = HierarchyParams(smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False)
    hh, hier = build_hierarchy(prob.A, params, device="cpu")
    mesh = make_row_mesh(8, "cpu")
    ext_s = pext.build_sharded_extended_system(hh, params, mesh)
    ext_u = pext.build_extended_system(hh, params, explicit=True, device="cpu")
    assert isinstance(ext_s.AA, HaloELL) and ext_s.offsets[-1] % 8 == 0
    sizes = [lv.A.n_rows for lv in hh.levels]
    U_u = np.random.default_rng(3).random(ext_u.offsets[-1])
    U_s = np.zeros(ext_s.offsets[-1])
    owner = np.full(ext_s.offsets[-1], -1)
    for k, n in enumerate(sizes):
        U_s[ext_s.offsets[k]: ext_s.offsets[k] + n] = U_u[ext_u.offsets[k]: ext_u.offsets[k] + n]
        owner[ext_s.offsets[k]: ext_s.offsets[k] + n] = k
    A0 = hier.levels[0].A
    y_u = pext.ext_matvec(ext_u, A0, torch.from_numpy(U_u)).numpy()
    with comm_trace(mesh) as trace:
        y_s = pext.ext_matvec(ext_s, A0, torch.from_numpy(U_s)).numpy()
    assert trace == [ext_s.AA.comm_bytes_per_matvec()] and trace[0] > 0
    for k, n in enumerate(sizes):
        np.testing.assert_allclose(y_s[ext_s.offsets[k]: ext_s.offsets[k] + n],
                                   y_u[ext_u.offsets[k]: ext_u.offsets[k] + n],
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(y_s[owner < 0], U_s[owner < 0])
    assert not ext_s.inv_wdiag[torch.from_numpy(owner < 0)].any()
    # the reference's padded system: AA's slots read back as global CSR
    # (each slot's column is the index vector's entry it gathers)
    want = ref["ext"]
    n_ext = ext_s.offsets[-1]
    assert list(ext_s.offsets) == want["offsets"]
    np.testing.assert_allclose(ext_s.inv_wdiag.numpy(), want["inv_wdiag"], rtol=1e-14, atol=0)
    AA = ext_s.AA
    idx = torch.arange(n_ext, dtype=torch.float64)
    xg = torch.cat([idx.view(mesh.local_devices, AA.n_loc_c), AA.ex.ghosts(idx)], 1).reshape(-1)
    got = sp.csr_matrix((AA.vals.reshape(-1).numpy(),
                         (np.repeat(np.arange(n_ext), AA.vals.shape[-1]),
                          xg[AA.flat_cols.reshape(-1).long()].long().numpy())),
                        shape=(n_ext, n_ext))
    got.eliminate_zeros()
    got.sort_indices()
    np.testing.assert_array_equal(got.indptr, want["indptr"])
    np.testing.assert_array_equal(got.indices, want["indices"])
    np.testing.assert_allclose(got.data, want["data"], rtol=1e-12, atol=1e-14)


def test_ams_grid_solve_equals_the_reference(ref):
    want = ref["ams"]
    pmx = maxwell_curlcurl(n=want["n"])
    ams, _ = pams.build_ams(pmx.A, pmx.aux["G"], Pi=pmx.aux["Pi"], device="cpu")
    groups_of, scale = pams.plan_ams_groups(ams, 8)
    assert [list(g) for g in groups_of] == want["groups_of"]
    np.testing.assert_array_equal(scale, want["scale"])
    sums = np.zeros(len(scale))
    for gs in groups_of:
        for g in gs:
            sums[g] += scale[g]
    np.testing.assert_allclose(sums, 1.0, rtol=1e-15)
    A = matrix_from_arrays(_format_converter(HierarchyParams(keep_stencil_fine=False))(pmx.A),
                           torch.float64, "cpu")
    b = torch.from_numpy(np.asarray(pmx.rhs) / np.linalg.norm(pmx.rhs))
    draws = JaxAMSDraws(want["key"])
    steps = []

    class Keep:
        def step(self, Lg):
            steps.append(draws.step(Lg))
            return steps[-1]

    got, owned = pams.ams_grid_parallel_solve(A, ams, make_row_mesh(8, "cpu"), b, draws=Keep(),
                                              tol=1e-6, max_cycles=600)
    assert owned == want["owned_bytes"] and max(owned) < 0.6 * sum(owned)
    _same(got, want["iters"], want["x"], want["history"])
    replay = iter(steps)
    one = pams.ams_async_additive_solve(A, ams, b, draws=type("R", (), {
        "step": lambda self, Lg: next(replay)})(), tol=1e-6, max_cycles=600, device="cpu")
    _same(got, one.iters, one.x.numpy(), one.history_list())


@pytest.mark.parametrize("name", ["config6_grid_async_multadd",
                                  "config12_maxwell_async_ams_grid"])
def test_grid_golden_through_the_port_alone(name):
    """The golden's 8-device run through the port's run_experiment, the
    reference's draws for PRNGKey(0) replayed."""
    with open(os.path.join(GOLDEN_DIR, name + ".json")) as f:
        g = json.load(f)
    o = g["config"]
    assert o["num_devices"] == 8 and o["seed"] == 0
    draws = JaxAMSDraws(0) if o["solver"] == "async_ams" else JaxAsyncDraws(0)
    st = run_experiment(SolverOptions(**o), device="cpu", draws=draws)
    assert st.level_n == g["level_n"] and st.level_nnz == g["level_nnz"]
    assert st.cycles == g["cycles"]
    np.testing.assert_allclose(st.history, g["history"], **HIST)
    np.testing.assert_allclose(st.operator_complexity, g["operator_complexity"], rtol=1e-12)


def test_the_runners_grid_branches():
    """The extended system with and without grid parallelism, and the
    async solver with local convergence (the runner's scalar omega there,
    its Richardson recurrences under global convergence), through
    run_experiment."""
    base = dict(problem="5pt", n=16, num_devices=8, tol=1e-8)
    st = run_experiment(SolverOptions(solver="explicit_ext_bpx", **base), device="cpu")
    rep = run_experiment(SolverOptions(solver="explicit_ext_bpx", grid_parallel=False, **base),
                         device="cpu")
    assert st.rel_resnorm <= 1e-8 and rep.rel_resnorm <= 1e-8
    assert abs(st.cycles - rep.cycles) <= 1
    loc = run_experiment(SolverOptions(solver="async_multadd", converge_test_type="local",
                                       async_type="semi", num_cycles=400, **base), device="cpu")
    glb = run_experiment(SolverOptions(solver="async_multadd", async_type="semi",
                                       num_cycles=400, **base), device="cpu")
    assert loc.rel_resnorm <= 2e-8 and glb.rel_resnorm <= 1e-8
    A = laplacian_2d_5pt(16).A
    bb = np.random.default_rng(0).random(A.n_rows)
    for st in (loc, glb):
        x = st.x.numpy()
        assert np.linalg.norm(bb - A @ x) / np.linalg.norm(bb) <= 2e-8
