"""Multi-process worker of tests/test_torch_multiprocess.py.

    PYTHONPATH=. python tests/torch_mp_worker.py <pid> <nproc> <port>

Runs in N processes joined by a gloo process group (init_multihost on the
CPU), each owning 8 / N shards of one 8-shard row mesh, and drives across
the process boundary:

  1. golden config7 (27-point 12^3, MULT, comm "halo") through the port's
     run_experiment: halo V-cycles, the replicated coarse inverse on the
     gathered coarse vector, all-reduced norms;
  2. the exchange modes one by one on config7's padded matrix: HaloELL in
     ppermute and all_to_all mode and HaloBSR, and the halo stencil's plane
     exchange on the 7-point 16^3 grid;
  3. the sharded AMS-PCG on the Maxwell n = 6 mesh (all-reduced dots);
  4. the grid-parallel async solve of the 5-point 16^2 problem over the 8
     shards' level groups (the correction sum and the fused norm pairs
     all-gathered): SEMI, and FULL with comm_every 2 and local convergence
     (each shard's own pending corrections and residual view);
  5. every other route of the row mesh and the grid (`route_cases`): comm
     "gspmd", the async additive solver and mixed precision on the row
     mesh, the Chebyshev solver by each bound estimator, one-level async
     smoothing, the grid-mapped extended system, the block smoothers and
     the sharded structured hierarchy (float64 and float32, a stencil and a
     DIA operator, the latter also under -mixed_precision); the
     one-process round also runs each on one device.

Prints one "RESULT <json>" line (global vectors gathered); the parent test
compares it with the one-process run.
"""

import json
import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from amg_tpu_torch.parallel import (
        build_halo_bsr,
        build_halo_ell,
        global_mesh_info,
        init_multihost,
        make_row_mesh,
    )
    from amg_tpu_torch.parallel.dist import _pad_csr
    from amg_tpu_torch.parallel.halo import halo_stencil_matvec
    from amg_tpu_torch.problems import laplacian_3d_7pt, laplacian_3d_27pt
    from amg_tpu_torch.problems.maxwell import maxwell_curlcurl
    from amg_tpu_torch.solve.ams import build_sharded_ams, solve_sharded_ams_pcg
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import run_experiment

    init_multihost(f"localhost:{port}", nproc, pid, device="cpu")
    mesh = make_row_mesh(8, "cpu")
    info = global_mesh_info(mesh)
    assert info["process_count"] == nproc and info["local_devices"] == 8 // nproc, info

    opts = SolverOptions(problem="27pt", n=12, solver="mult", num_devices=8, comm="halo",
                         device_format="ell")
    st = run_experiment(opts, device="cpu")

    prob = laplacian_3d_27pt(12)
    A = _pad_csr(prob.A, prob.n, prob.n, unit_diag_from=prob.n)
    x = torch.from_numpy(np.random.default_rng(0).random(prob.n))
    xl = mesh.shard_vector(x)
    ys = {
        "ppermute": build_halo_ell(A, mesh),
        "all_to_all": build_halo_ell(A, mesh, max_ppermute_offsets=0),
        "bsr": build_halo_bsr(A, mesh, bm=8, bn=8),
    }
    ys = {k: mesh.gather(a @ xl).tolist() for k, a in ys.items()}
    p7 = laplacian_3d_7pt(16)  # two planes a shard
    mv, coeffs = halo_stencil_matvec(p7.stencil, mesh)
    x7 = torch.from_numpy(np.random.default_rng(1).random(p7.n))
    ys["stencil"] = mesh.gather(mv(mesh.shard_vector(x7), coeffs)).tolist()

    pmx = maxwell_curlcurl(n=6)
    A_h, ams, cfg, pad_e, _ = build_sharded_ams(pmx.A, pmx.aux["G"], mesh, Pi=pmx.aux["Pi"])
    mres = solve_sharded_ams_pcg(A_h, ams, cfg, torch.from_numpy(np.asarray(pmx.rhs)), mesh,
                                 pad_e, tol=1e-8)
    from amg_tpu_torch.parallel.grid import (
        build_grid_owned_storage,
        grid_parallel_solve,
        plan_grid_levels,
    )
    from amg_tpu_torch.problems import laplacian_2d_5pt
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu_torch.smooth.smoothers import SmootherType
    from amg_tpu_torch.solve.async_sim import AsyncConfig
    from amg_tpu_torch.solve.cycles import CycleConfig, CycleType

    p5 = laplacian_2d_5pt(16)
    hh, hier = build_hierarchy(p5.A, HierarchyParams(smoother=SmootherType.L1_JACOBI,
                                                     keep_stencil_fine=False), device="cpu")
    cfg = CycleConfig(cycle=CycleType.MULTADD, smoother=SmootherType.L1_JACOBI,
                      use_smoothed_transfers=True)
    _, levels_of, scale = plan_grid_levels(hh, 8)
    b5 = torch.from_numpy(np.random.default_rng(0).random(p5.n))
    grid = {"views": sorted(build_grid_owned_storage(hier, levels_of, cfg, mesh).views)}
    for name, kw in (("semi", {"async_type": "semi"}),
                     ("full coalesced local", {"async_type": "full", "comm_every": 2,
                                               "converge_test_type": "local"})):
        acfg = AsyncConfig(omega=0.7, fire_prob=0.8, sim_read_delay=1, **kw)
        g = grid_parallel_solve(hier, cfg, acfg, levels_of, scale, mesh, b5, seed=0, tol=1e-8,
                                max_cycles=300)
        grid[name] = {"iters": g.iters, "history": g.history_list(), "x": g.x.tolist(),
                      "count": g.grid_wait.count.tolist()}
    routes = {name: run(opts, nproc) for name, run, opts in route_cases()}
    print("RESULT " + json.dumps({
        "pid": pid, "cycles": st.cycles, "history": st.history, "x": st.x.tolist(),
        "level_n": st.level_n, "y": ys,
        "ams_iters": int(mres.iters), "ams_x": mres.x.tolist(), "grid": grid,
        "routes": routes,
    }), flush=True)
    torch.distributed.destroy_process_group()


def _stats(st) -> dict:
    return {"cycles": st.cycles, "history": st.history, "x": st.x.tolist()}


def run_options(opts, nproc) -> dict:
    """A run_experiment case; the one-process round also runs its options on
    one device (num_devices 1), the single-device iteration the mesh's
    route must reproduce."""
    from dataclasses import replace

    from amg_tpu_torch.utils.runner import run_experiment

    out = _stats(run_experiment(replace(opts), device="cpu"))
    if nproc == 1:
        out["single"] = _stats(run_experiment(replace(opts, num_devices=1), device="cpu"))
    return out


def run_float32(opts, nproc) -> dict:
    """run_options with the runner's structured hierarchy in float32: its
    host arrays cast by hierarchy_from_arrays (as chip_smoke.py's phase 20
    builds its structured routes), sharded as the runner shards it, and
    solved by the runner's own solve in float32."""
    from dataclasses import replace

    import torch

    from amg_tpu_torch.convert import hierarchy_from_arrays
    from amg_tpu_torch.parallel import shard_structured_hierarchy
    from amg_tpu_torch.utils.runner import setup_experiment, solve_experiment

    def one(o):
        exp = setup_experiment(replace(o), "cpu")
        exp.params = replace(exp.params, dtype=torch.float32)
        exp.hier = hierarchy_from_arrays(*exp.hh.arrays, dtype=torch.float32, device="cpu")
        if exp.mesh is not None:
            exp.hier = shard_structured_hierarchy(exp.hier, exp.mesh)
        return _stats(solve_experiment(exp))

    out = one(opts)
    if nproc == 1:
        out["single"] = one(replace(opts, num_devices=1))
    return out


def run_cheby(opts, nproc) -> dict:
    """The Chebyshev solve with cheby_setup's bounds on the row mesh (and,
    in the one-process round, on one device)."""
    from dataclasses import replace

    from amg_tpu_torch.solve.driver import cheby_setup
    from amg_tpu_torch.utils.runner import cycle_config, setup_experiment, solve_experiment

    def one(o):
        exp = setup_experiment(replace(o), "cpu")
        c = cheby_setup(exp.hier, cycle_config(exp.opts, exp.smoother),
                        num_iters=o.cheby_power_iters, method=o.cheby_eig, device="cpu")
        return dict(_stats(solve_experiment(exp)), bounds=[c.alpha, c.beta])

    out = one(opts)
    if nproc == 1:
        out["single"] = one(replace(opts, num_devices=1))
    return out


def run_extended(opts, nproc) -> dict:
    """The reference worker's grid-mapped extended system
    (tests/mp_worker.py) at 5pt 16^2: build_sharded_extended_system over the
    8 shards, the power bounds on it and ext_solve; in the one-process round
    also the unsharded explicit system."""
    import numpy as np
    import torch

    from amg_tpu_torch.parallel import make_row_mesh
    from amg_tpu_torch.problems import laplacian_2d_5pt
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu_torch.smooth.smoothers import SmootherType
    from amg_tpu_torch.solve.accel import estimate_cycle_eigs
    from amg_tpu_torch.solve.extended import (
        build_extended_system,
        build_sharded_extended_system,
        ext_matvec,
        ext_solve,
    )

    prob = laplacian_2d_5pt(opts["n"])
    params = HierarchyParams(smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False,
                             device_format="ell")
    hh, hier = build_hierarchy(prob.A, params, device="cpu")
    b = torch.from_numpy(np.random.default_rng(0).random(prob.n))

    def solve(ext):
        coeffs = estimate_cycle_eigs(
            lambda op, u: op[0].inv_wdiag * ext_matvec(op[0], op[1], u), ext.offsets[-1],
            torch.float64, range_start=True, operand=(ext, hier.levels[0].A), mesh=ext.mesh)
        res = ext_solve(hier, ext, b, tol=1e-8, max_cycles=300, cheby_coeffs=coeffs,
                        device="cpu")
        return {"cycles": res.iters, "history": res.history_list(), "x": res.x.tolist(),
                "bounds": [coeffs.alpha, coeffs.beta]}

    out = solve(build_sharded_extended_system(hh, params, make_row_mesh(8, "cpu")))
    if nproc == 1:
        out["single"] = solve(build_extended_system(hh, params, explicit=True, device="cpu"))
    return out


def route_cases():
    """(name, runner, options) of every route across processes: (a) gspmd,
    (b) the async additive solver on the row mesh (FULL, SEMI), (c) mixed
    precision, (d) the Chebyshev solver by each bound estimator, (e) one-level
    async smoothing on a plane-split stencil and on a CSR matrix, (f) the
    grid-mapped extended system, (g) the block smoothers, (h) the sharded
    structured hierarchy (a stencil in float64 and float32, a DIA operator
    in float64 and under -mixed_precision)."""
    from amg_tpu_torch.utils.config import SolverOptions

    c7 = dict(problem="27pt", n=12, num_devices=8, comm="halo", device_format="ell")
    c4 = dict(problem="elasticity", nx=16, ny=4, solver="mult", outer_solver="pcg",
              num_devices=8, comm="halo", device_format="ell", setup_type="classical")
    cases = [("gspmd", run_options, SolverOptions(solver="mult", **dict(c7, comm="gspmd")))]
    for kind in ("full", "semi"):
        cases.append((f"async {kind}", run_options, SolverOptions(
            solver="async_multadd", grid_parallel=False, async_type=kind, num_cycles=400,
            **c7)))
    cases.append(("mixed", run_options, SolverOptions(solver="mult", mixed_precision=True,
                                                      **c7)))
    for method in ("power", "lobpcg", "lanczos"):
        cases.append((f"cheby {method}", run_cheby, SolverOptions(
            solver="mult", smoother="jacobi", accel="cheby", cheby_eig=method, **c7)))
    cases.append(("async_smooth stencil", run_options, SolverOptions(
        problem="7pt", n=16, solver="async_smooth", num_devices=8, num_cycles=200)))
    cases.append(("async_smooth csr", run_options, SolverOptions(
        problem="vardifconv", n=8, solver="async_smooth", num_devices=8, num_cycles=200)))
    cases.append(("extended", run_extended, {"n": 16}))
    # GS's PCG does not converge on this beam (nor the reference's), and
    # amplifies roundoff as it goes: 10 iterations compare the iterates
    for sm, iters in (("hybrid_jgs", 200), ("gs", 10)):
        cases.append((f"block {sm}", run_options,
                      SolverOptions(num_cycles=iters, **dict(c4, smoother=sm))))
    struct = dict(problem="27pt", n=16, solver="mult", hierarchy="structured", num_devices=8)
    cases.append(("structured", run_options, SolverOptions(**struct)))
    # float32 (tol 1e-6, inside float32's reach): the plane-split levels
    # must round as the global operators do
    cases.append(("structured f32", run_float32, SolverOptions(tol=1e-6, **struct)))
    # the DIA form: an interleaved elasticity operator (its taps reach 5
    # along the component axis) on the plane halo, masked transfers (PCG);
    # under -mixed_precision float32 DIA levels and the float64 outer
    # operator, both plane-split
    beam = dict(problem="elasticity", nx=15, ny=4, nz=4, elast_bc="identity",
                hierarchy="structured", num_devices=8)
    cases.append(("structured dia", run_options, SolverOptions(**beam)))
    cases.append(("structured dia mixed", run_options,
                  SolverOptions(mixed_precision=True, **beam)))
    return cases


if __name__ == "__main__":
    main()
