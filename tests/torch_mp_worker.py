"""Multi-process worker of tests/test_torch_multiprocess.py.

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
     (each shard's own pending corrections and residual view).

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
    print("RESULT " + json.dumps({
        "pid": pid, "cycles": st.cycles, "history": st.history, "x": st.x.tolist(),
        "level_n": st.level_n, "y": ys,
        "ams_iters": int(mres.iters), "ams_x": mres.x.tolist(), "grid": grid,
    }), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
